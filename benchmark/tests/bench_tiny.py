"""Runs of the harness at a tiny size on the CPU, each in a fresh
interpreter (the test process may hold modules a run must not), with a
fault optionally planted in the port first."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

TINY = {"num_hidden_layers": 2, "hidden_size": 64, "num_attention_heads": 4,
        "intermediate_size": 128, "vocab_size": 300, "chunk_len": 32,
        "embedding_head": {"out_dim": 64}, "dtype": "float32",
        "benchmark_weights": {"std": 0.3}}
# Weights of std 0.3 make a tiny encoder's embedding depend on each token
# (at 0.02 and width 64 a changed token moves it 0.2%, under any limit)

CELLS = {
    "firstp-encode": (
        {"batch": 16, "slice_records": 64, "index_records": 300,
         "sample": 40, "warmup_batches": 1},
        {"streams": {"passages": {"records": 256, "width": 32,
                                  "length": {"median": 20}}}}),
    "maxp-encode": (
        {"batch": 4, "slice_records": 16, "index_records": 100,
         "sample": 40, "warmup_batches": 1},
        {"streams": {"documents": {"records": 64, "width": 128,
                                   "length": {"median": 60, "min": 8}}}}),
    "firstp-mine": (
        {"chunk": 64, "batch": 16, "k": 20, "negatives": 4, "index_rows": 5000,
         "index_block": 1024, "sample": 40, "keep_per_chunk": 16},
        {"streams": {"queries": {"records": 256, "width": 16,
                                 "length": {"median": 8}}}}),
}

SCRIPT = """
import json, sys, time
T0 = time.perf_counter()
import torch
torch.set_num_threads(2)
{plant}
from benchmark.harness import main
over = json.loads(sys.argv[1])
code = main(["--workload", sys.argv[2], "--seed", sys.argv[3],
             "--seconds", "0.5", "--trace", "0"], T0, require_cuda=False,
            overrides=over{extra})
import sys as _s
mods = sorted({{m.split(".")[0] for m in _s.modules}})
print("MODULES " + json.dumps(mods), file=_s.stderr)
sys.exit(code)
"""


def run(cell: str, seed: int = 2 ** 33 + 5, plant: str = "",
        extra: str = "", timeout: int = 240):
    """(exit code, the result line as a dict or None, stderr, the
    top-level modules the process held at its end)."""
    params, traffic = CELLS[cell]
    over = {"config": TINY, "params": params, "traffic": traffic}
    script = SCRIPT.format(plant=textwrap.dedent(plant), extra=extra)
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", script, json.dumps(over),
                           cell, str(seed)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)
    lines = proc.stdout.strip().splitlines()
    line = json.loads(lines[-1]) if lines and proc.returncode == 0 else None
    mods = []
    for ln in proc.stderr.splitlines():
        if ln.startswith("MODULES "):
            mods = json.loads(ln[len("MODULES "):])
    return proc.returncode, line, proc.stderr, mods
