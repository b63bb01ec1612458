"""The result line, the checks printed last, and no result without a
card."""

import os
import subprocess
import sys

import pytest

import bench_tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("cell", sorted(bench_tiny.CELLS))
def test_a_sound_run_is_correct_and_its_line_has_the_keys(cell):
    code, line, err, mods = bench_tiny.run(cell)
    assert code == 0, err
    assert list(line) == KEYS
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert "setup_s" in line["metrics"]
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert line["checks"] and all(set(c) == {"value", "limit"}
                                  for c in line["checks"].values())
    tail = [ln for ln in err.splitlines() if not ln.startswith("MODULES ")]
    names = [ln.split()[1] for ln in tail[-len(line["checks"]):]]
    assert names == list(line["checks"])
    assert not {"jax", "jaxlib", "flax", "ance_tpu"} & set(mods)


def test_no_card_no_result(tmp_path):
    """Without a CUDA device the run exits nonzero and prints nothing on
    standard output (this machine has none)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = dict(os.environ, PYTHONPATH=bench_tiny.ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "firstp-encode", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=bench_tiny.ROOT, env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
