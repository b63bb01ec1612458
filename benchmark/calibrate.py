"""Readings for the limits of ``correct``, many seeds in one process.

``python -m benchmark.calibrate --workload <name> --seeds 1,2,...
--seconds <s> [--control-seeds 7,8,9] [--out <file.jsonl>]`` runs the
cell's driver once a seed with a short window and prints each check's
number (the program's readings, from which the lower end of a limit is
set), then the driver's ``control`` on each control seed: the reference
one precision step below the configuration's, put in the program's place
(the upper end). Each reading is one JSON line, with ``correct``: whether the reading
passes every limit the workload holds, as the harness's check would
judge it. Nothing here runs in a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import torch

from benchmark.harness import Check, prepare


def passes(rec: dict, limits: dict) -> bool:
    """The harness's verdict on one reading: every number at most its
    limit, a missing or NaN number failing."""
    return all(Check(n, rec.get(n), lim).ok for n, lim in limits.items())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m benchmark.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    device = torch.device("cuda", 0)

    def emit(rec):
        print(json.dumps(rec), flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(json.dumps(rec) + "\n")

    for kind, seeds in (("program", a.seeds), ("control", a.control_seeds)):
        for seed in [int(s) for s in seeds.split(",") if s]:
            args = argparse.Namespace(workload=a.workload, seed=seed,
                                      seconds=a.seconds, trace=0)
            cell, driver, _, _ = prepare(args, time.perf_counter(),
                                         Path.cwd(), device, None)
            with tempfile.TemporaryDirectory(prefix="bench-") as tmp:
                cell.tmpdir = tmp
                if kind == "program":
                    out = driver.run(cell)
                    rec = {c.name: c.value for c in out.checks}
                    rec["e2e"] = out.e2e
                else:
                    rec = driver.control(cell)
            rec["correct"] = passes(rec, cell.params["limits"])
            emit({"workload": a.workload, "kind": kind, "seed": seed,
                  **rec})
    return 0


if __name__ == "__main__":
    sys.exit(main())
