"""The ``dsv2lite-encode`` cell (DeepSeek-V2-Lite's decoder under ANCE's
head) on the CPU: a tiny run reads ``correct``, a run with the timed path
broken underneath reads it false, the float8 control fails the limit at
full width, the recorded limit lies between its readings, the FLOP count
is the one worked out by hand, and nothing the cell loads holds JAX."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

import bench_tiny
from benchmark import flops_moe
from benchmark.harness import FORBIDDEN, prepare
from test_bench_faults import HALF_ENCODE, ROW_ALTERED

ROOT = Path(bench_tiny.ROOT)
CELL = "dsv2lite-encode"
CONFIG = json.loads((ROOT / "benchmark" / "configs" /
                     "ance-firstp-deepseek-v2-lite.json").read_text())

# every width of the decoder cut (the head keeps the registry's 768), one
# dense and two MoE layers, 8 experts top-2; std 0.3 makes a tiny
# decoder's embedding depend on each token
TINY = {"num_hidden_layers": 3, "hidden_size": 64, "num_attention_heads": 4,
        "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
        "kv_lora_rank": 32, "intermediate_size": 96,
        "moe_intermediate_size": 32, "n_routed_experts": 8,
        "n_shared_experts": 1, "num_experts_per_tok": 2, "vocab_size": 300,
        "bos_token_id": 1, "eos_token_id": 2, "pad_token_id": 2,
        "embedding_head": {"out_dim": 768}, "dtype": "float32",
        "benchmark_weights": {"std": 0.3}}
PARAMS = {"batch": 16, "slice_records": 64, "index_records": 300,
          "sample": 40, "warmup_batches": 1, "ref_block": 16}
TRAFFIC = {"streams": {"passages": {"records": 256, "width": 32,
                                    "length": {"median": 20}}}}


def run(seed: int = 2 ** 33 + 5, plant: str = ""):
    """(exit code, result line or None, stderr, modules held at the end)
    of one tiny run in a fresh interpreter, ``plant`` run first."""
    over = {"config": TINY, "params": PARAMS, "traffic": TRAFFIC}
    script = bench_tiny.SCRIPT.format(plant=plant, extra="")
    env = dict(os.environ, PYTHONPATH=bench_tiny.ROOT)
    proc = subprocess.run([sys.executable, "-c", script, json.dumps(over),
                           CELL, str(seed)], cwd=bench_tiny.ROOT, env=env,
                          capture_output=True, text=True, timeout=240)
    lines = proc.stdout.strip().splitlines()
    line = json.loads(lines[-1]) if lines and proc.returncode == 0 else None
    mods = []
    for ln in proc.stderr.splitlines():
        if ln.startswith("MODULES "):
            mods = json.loads(ln[len("MODULES "):])
    return proc.returncode, line, proc.stderr, mods


def test_tiny_run_reads_correct_and_loads_no_jax():
    code, line, err, mods = run()
    assert code == 0, err
    assert line["correct"], line
    assert set(line["metrics"]) == {"encode_docs_per_s", "setup_s"}
    # fp32 on the CPU: the port and the reference differ by rounding only
    assert line["checks"]["emb_rel_err"]["value"] < 1e-4
    assert line["attempted"] > 0 and line["failed"] == 0
    assert mods and not set(FORBIDDEN) & set(mods)


@pytest.mark.parametrize("fault", [HALF_ENCODE, ROW_ALTERED],
                         ids=["half_batch", "row_altered"])
def test_fault_reads_incorrect(fault):
    code, line, err, _ = run(plant=fault)
    assert code == 0, err
    assert not line["correct"], line["checks"]


def test_control_fails_at_full_width():
    """The float8 control at the configuration's widths (two layers: the
    dense one and one MoE layer, every expert) on a few rows."""
    torch.set_num_threads(4)
    over = {"config": {"num_hidden_layers": 2},
            "params": {"sample": 4, "ref_block": 4},
            "traffic": {"streams": {"passages": {"records": 64}}}}
    args = argparse.Namespace(workload=CELL, seed=2 ** 32 + 17, seconds=1,
                              trace=0)
    cell, driver, _, _ = prepare(args, time.perf_counter(), ROOT,
                                 torch.device("cpu"), None, over)
    reading = driver.control(cell)
    assert reading["emb_rel_err"] > cell.params["limits"]["emb_rel_err"]


def test_limit_lies_between_the_recorded_readings():
    rec = json.loads((ROOT / "benchmark" / "limits_moe.json").read_text())
    wl = json.loads((ROOT / "benchmark" / "workloads" /
                     f"{CELL}.json").read_text())
    assert set(rec) == {CELL}
    assert set(wl["params"]["limits"]) == set(rec[CELL])
    for number, lim in wl["params"]["limits"].items():
        r = rec[CELL][number]
        assert r["limit"] == lim
        assert r["lower"] <= lim < r["upper"], number


def test_flops_by_hand_at_the_published_widths():
    """A MoE layer 2·(2048·3072 + 2048·576 + 512·4096 + 2048·2048 +
    2048·64 + 6·3·2048·1408 + 3·2048·2816) a real token; the dense layer
    the MLA's products and 2·3·2048·10944; the causal scores Σ_i (i + 1)
    ·16·(192 + 128)·2 a row a layer; the head 2·2048·768 a row."""
    mla = 2048 * 3072 + 2048 * 576 + 512 * 4096 + 2048 * 2048
    moe = 2 * (mla + 2048 * 64 + 6 * 3 * 2048 * 1408 + 3 * 2048 * 2816)
    dense = 2 * (mla + 3 * 2048 * 10944)
    L = 5
    scores = sum((i + 1) * 16 * (192 + 128) * 2 for i in range(L))
    want = L * (dense + 13 * moe) + 14 * scores + 2 * 2048 * 768
    assert flops_moe.encoder_flops([L], CONFIG) == pytest.approx(want,
                                                                 rel=1e-12)
    ops, nbytes = flops_moe.experts_work([L], 1, CONFIG)
    assert ops == 13 * L * 2 * 3 * 2048 * (6 * 1408 + 2816)
    weights = 3 * 2048 * (64 * 1408 + 2816) * 2
    assert nbytes == 13 * (weights + 2 * L * 7 * 2048 * 2)


def test_new_modules_load_no_jax():
    script = ("import sys, benchmark.reference.deepseek_v2, "
              "benchmark.weights_dsv2, benchmark.flops_moe\n"
              "from benchmark.harness import load_module\n"
              "load_module('drivers', 'encode_moe')\n"
              "load_module('metrics', 'experts_roofline')\n"
              "load_module('metrics', 'route_ms.encode')\n"
              "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", script], cwd=bench_tiny.ROOT,
                         env=dict(os.environ, PYTHONPATH=bench_tiny.ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert not set(FORBIDDEN) & set(eval(out.stdout))
