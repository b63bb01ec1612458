"""No process of the benchmark holds JAX or the JAX package: names are
compared by the part before the first dot, whole, so the port
(``ance_tpu_torch``) passes and ``ance_tpu`` does not."""

import os
import subprocess
import sys

import bench_tiny
from benchmark.harness import FORBIDDEN, forbidden_modules


def test_top_level_names_compared_whole():
    assert forbidden_modules(["ance_tpu_torch", "ance_tpu_torch.ops.topk",
                              "jaxtyping", "flaxen", "jaxlibx"]) == []
    assert forbidden_modules(["ance_tpu.ops", "jax.numpy", "jaxlib",
                              "flax.linen", "numpy"]) == \
        ["ance_tpu", "flax", "jax", "jaxlib"]
    assert set(FORBIDDEN) == {"jax", "jaxlib", "flax", "ance_tpu"}


def test_a_run_and_its_reference_load_none():
    """A whole tiny run (harness, port, reference) in a fresh interpreter,
    then every reference module and the controls' code."""
    _, _, err, mods = bench_tiny.run("firstp-mine")
    assert mods and not set(FORBIDDEN) & set(mods), err
    script = ("import sys, benchmark.reference.encoder, "
              "benchmark.reference.search, benchmark.calibrate, "
              "benchmark.drivers.encode, benchmark.drivers.mine\n"
              "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", script], cwd=bench_tiny.ROOT,
                         env=dict(os.environ, PYTHONPATH=bench_tiny.ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert not set(FORBIDDEN) & set(eval(out.stdout))
