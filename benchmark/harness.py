"""Runs one cell once: finds its pieces by name, drives it, prints the
result line.

Everything is found by the names in ``BENCHMARK.json``:

* the configuration: ``configs/<config>.json``;
* the traffic mix: ``traffic/<traffic>.json`` (read by ``generator.py``);
* the workload: ``workloads/<name>.json``, which names its driver and
  holds the driver's parameters;
* the driver: ``drivers/<driver>.py``, whose ``run(cell)`` sets up, times
  the window, and checks what the window produced against the plain
  reference (``reference/``);
* each per-layer metric: ``metrics/<name>.py`` (or its family's
  ``metrics/<family>.py`` for ``<family>.<part>``), whose ``read(obs)``
  takes the metric from the spans, counts and trace summary the driver
  gathered, or returns None when there is nothing to read. Its unit,
  layer, ``moves`` and source are in ``BENCHMARK.json`` alone.

So a configuration, a traffic mix, a workload or a metric is added as new
files and an entry in ``BENCHMARK.json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

BENCH_DIR = Path(__file__).resolve().parent
# module names (compared by the part before the first dot, whole) that no
# process of the benchmark may hold: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "ance_tpu")
HOST_THREADS = 2


def forbidden_modules(names=None) -> list[str]:
    """The FORBIDDEN top-level names among ``names`` (``sys.modules`` by
    default): ``ance_tpu_torch.x`` is ``ance_tpu_torch``, not
    ``ance_tpu``."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path) -> dict:
    return read_json(root / "BENCHMARK.json")


def find(kind: str, name: str, base: Path = BENCH_DIR) -> Path:
    """``<kind>/<name>.json`` (``.py`` for drivers and metrics) under the
    benchmark's folder ``base``; raises when it is not there. A metric
    ``<family>.<part>`` without a file of its own is read by its family's
    ``metrics/<family>.py`` (one reader for ``idle.encode``, ``idle.mine``
    ...): what differs between them is in ``BENCHMARK.json``."""
    suffix = ".py" if kind in ("drivers", "metrics") else ".json"
    path = base / kind / f"{name}{suffix}"
    family = base / kind / f"{name.split('.')[0]}{suffix}"
    if not path.is_file() and kind == "metrics" and family.is_file():
        return family
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return path


def load_module(kind: str, name: str, base: Path = BENCH_DIR):
    """A driver or metric module by name; metric names may hold dots, so
    the file is loaded by path."""
    path = find(kind, name, base)
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, name: str) -> tuple[list[dict], list[dict]]:
    """(end-to-end, per-layer) metric entries this cell reports: those
    whose ``workloads`` list it, or that have none (a per-layer metric
    without one: when it moves an end-to-end metric the cell reports)."""
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    return e2e, per_layer


@dataclasses.dataclass
class Check:
    """One number compared: ``value`` passes when it is at most
    ``limit``; a missing or NaN value fails."""
    name: str
    value: Optional[float]
    limit: float

    @property
    def ok(self) -> bool:
        return self.value is not None and not math.isnan(self.value) \
            and self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: the window's count of items and of items
    that failed the check, its end-to-end values, the checks, the memory
    peak, and ``obs`` (spans, counts, trace summary) for the metrics."""
    attempted: int
    failed: int
    e2e: dict
    checks: list
    memory_peak_bytes: int
    obs: dict


@dataclasses.dataclass
class Cell:
    """One run of one cell, as the driver sees it."""
    name: str
    config: dict
    traffic: dict
    params: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    chips: int
    tmpdir: str
    t0: float
    bench_dir: Path = BENCH_DIR
    setup_s: Optional[float] = None

    def window_opens(self) -> None:
        """The driver calls this as its window starts: set-up ends."""
        self.setup_s = time.perf_counter() - self.t0


def power_limit() -> Optional[str]:
    """The card's power limit as ``nvidia-smi`` prints it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0].strip() if out else None


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and \
            isinstance(out.get(k), dict) else v
    return out


def parse_args(argv):
    p = argparse.ArgumentParser(prog="python -m benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def prepare(args, t0: float, root: Path, device, chips_seen: Optional[int],
            overrides: Optional[dict] = None, bench_dir: Path = BENCH_DIR):
    """(cell, driver module, end-to-end entries, per-layer entries), the
    pieces found under ``bench_dir``."""
    bench = load_benchmark(root)
    entry = cell_entry(bench, args.workload)
    if chips_seen is not None and chips_seen < entry["chips"]:
        raise SystemExit(f"the cell needs {entry['chips']} cards, "
                         f"{chips_seen} visible")
    workload = read_json(find("workloads", args.workload, bench_dir))
    config = read_json(find("configs", entry["config"], bench_dir))
    traffic = read_json(find("traffic", entry["traffic"], bench_dir))
    overrides = overrides or {}
    config = _merge(config, overrides.get("config", {}))
    traffic = _merge(traffic, overrides.get("traffic", {}))
    params = _merge(workload["params"], overrides.get("params", {}))
    driver = load_module("drivers", workload["driver"], bench_dir)
    cell = Cell(name=args.workload, config=config, traffic=traffic,
                params=params, seed=args.seed, seconds=args.seconds,
                trace=bool(args.trace), device=device, chips=entry["chips"],
                tmpdir="", t0=t0, bench_dir=bench_dir)
    e2e, per_layer = cell_metrics(bench, args.workload)
    return cell, driver, e2e, per_layer


def result_line(cell: Cell, outcome: Outcome, e2e: list, per_layer: list,
                device_info: dict) -> dict:
    metrics = {}
    if cell.trace:
        for m in per_layer:
            value = load_module("metrics", m["name"],
                                cell.bench_dir).read(outcome.obs)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(outcome.e2e, setup_s=cell.setup_s)
        for m in e2e:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    line = {"correct": all(c.ok for c in outcome.checks)
            and bool(outcome.checks),
            "attempted": outcome.attempted, "failed": outcome.failed,
            "metrics": metrics, "device": device_info}
    tr = outcome.obs.get("trace")
    if cell.trace and tr:
        line["device"]["busy_s"] = tr["busy_s"]
        line["device"]["window_s"] = tr["window_s"]
        line["breakdown"] = {"device_ops": tr["device_ops"],
                             "idle_gaps": tr["idle_gaps"]}
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in outcome.checks}
    return line


def main(argv, t0: float, *, require_cuda: bool = True,
         overrides: Optional[dict] = None, root: Optional[Path] = None,
         bench_dir: Path = BENCH_DIR) -> int:
    """Run one cell once; print its line. Returns the exit code: 0 when a
    line was printed (``correct`` may still be false), nonzero when no
    result may be printed (no card, too few cards, a forbidden module).
    The tests run it on the CPU (``require_cuda=False``) at small sizes
    (``overrides`` of the configuration, traffic and parameters)."""
    args = parse_args(argv)
    import torch
    root = Path.cwd() if root is None else root
    if require_cuda:
        if not torch.cuda.is_available():
            print("no CUDA device: the benchmark measures the card only",
                  file=sys.stderr)
            return 3
        device, chips_seen = torch.device("cuda", 0), \
            torch.cuda.device_count()
        # the host's work is one thread's Python and small copies: few
        # intra-op threads leave the cores to it and steady its pace
        torch.set_num_threads(HOST_THREADS)
    else:
        device, chips_seen = torch.device("cpu"), None
    cell, driver, e2e, per_layer = prepare(args, t0, root, device,
                                           chips_seen, overrides, bench_dir)
    with tempfile.TemporaryDirectory(prefix="bench-") as tmp:
        cell.tmpdir = tmp
        outcome = driver.run(cell)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 4
    if device.type == "cuda":
        device_info = {"platform": "gpu",
                       "kind": torch.cuda.get_device_name(0),
                       "count": cell.chips,
                       "memory_peak_bytes": outcome.memory_peak_bytes,
                       "power_limit": power_limit()}
    else:
        device_info = {"platform": "cpu", "kind": "cpu", "count": 1,
                       "memory_peak_bytes": 0}
    line = result_line(cell, outcome, e2e, per_layer, device_info)
    for c in outcome.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAIL'}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
