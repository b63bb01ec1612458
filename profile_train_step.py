#!/usr/bin/env python3
"""Where a train step's time goes, on one CUDA card.

    python3 profile_train_step.py [--steps 3] [--trace-dir DIR]

Runs the port's train step (``ance_tpu_torch.train.trainer``) at full
RoBERTa-base width in bf16 from seeded random weights, on seeded random
token batches, both built by ``chip_smoke.py``'s ``train_setup`` and
``random_batches``: FirstP (batch 32, query seq 64, passage seq 128, dropout
0.1) and MaxP (8 documents of 4 x 512 chunks, attention dropout 0, so the
fused attention kernels and their backward run). For each it prints
  * the host-clock time of a step and of its three parts (forward and
    loss, backward, optimizer), each ended by a synchronize, median of
    ``--steps`` after two warm-up steps;
  * from ``torch.profiler`` over ``--steps`` steps: device time summed
    over kernels, grouped (GEMM, fused attention forward / backward,
    softmax, LayerNorm, dropout RNG, reductions, other elementwise and
    copies), the device's idle share of the profiled wall time, and the
    ten costliest kernels;
and writes one JSON line per configuration (and, with ``--trace-dir``,
a Chrome trace each: tens of MB). Needs CUDA; exits 2 without it.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GROUPS = [  # first match wins
    ("fused attention backward", r"fused_bwd"),
    ("fused attention forward", r"fused_fwd"),
    ("GEMM", r"gemm|xmma|cutlass|cublas|nvjet|sm90_|Kernel2"),
    ("softmax", r"softmax"),
    ("LayerNorm", r"layer_norm|LayerNorm"),
    ("dropout RNG", r"philox|distribution|bernoulli|uniform"),
    ("reductions", r"reduce|norm_kernel"),
    ("elementwise and copies", r""),
]


def profile(name, model_type, overrides, batch, q_len, p_len, steps,
            trace_dir):
    import torch
    from torch.autograd import DeviceType
    from ance_tpu_torch.train import trainer
    from chip_smoke import random_batches, train_setup

    dev = torch.device("cuda")
    model, opt, loss_fn = train_setup(model_type, torch.bfloat16, dev,
                                      overrides, schedule=(1e-4, 2, 100),
                                      weight_decay=0.0)
    model.train()
    gen = torch.Generator().manual_seed(0)
    batches = random_batches(2 + 2 * steps, batch, q_len, p_len, seed=0)

    def step(b, parts=None):
        b = trainer.batch_to_device(b, dev)
        for p in model.parameters():
            p.grad = None
        marks = [time.perf_counter()]
        loss = loss_fn(model, b, gen)
        if parts is not None:
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
        loss.backward()
        if parts is not None:
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
        opt.step()
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        if parts is not None:
            parts.append([(b - a) * 1e3 for a, b in zip(marks, marks[1:])])
        return loss

    torch.cuda.reset_peak_memory_stats()
    for b in batches[:2]:
        step(b)
    parts, walls = [], []
    for b in batches[2:2 + steps]:
        t0 = time.perf_counter()
        step(b, parts)
        walls.append((time.perf_counter() - t0) * 1e3)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[2 + steps:]:
            step(b)
        prof_wall = (time.perf_counter() - t0) * 1e3
    # device-side ranges of annotations (the optimizer's step) span
    # kernels already counted: only kernels and copies are summed
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and not e.name.startswith("Optimizer.")]
    kernels = collections.Counter()
    for e in device:
        kernels[e.name] += e.time_range.elapsed_us() / 1e3
    device_ms = sum(kernels.values())
    groups = collections.Counter()
    for kname, ms in kernels.items():
        group = next(g for g, pat in GROUPS if re.search(pat, kname))
        groups[group] += ms
    trace = None
    if trace_dir:
        trace = Path(trace_dir) / f"train_step_{name}.json"
        trace.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(trace))
    fwd, bwd, upd = (statistics.median(p[i] for p in parts) for i in range(3))
    result = {
        "config": name, "batch": batch, "q_len": q_len, "p_len": p_len,
        "step_ms": statistics.median(walls), "forward_ms": fwd,
        "backward_ms": bwd, "optimizer_ms": upd,
        "profiled_wall_ms_per_step": prof_wall / steps,
        "device_ms_per_step": device_ms / steps,
        "idle_share": max(0.0, 1.0 - device_ms / prof_wall),
        "groups_ms_per_step": {g: ms / steps for g, ms in groups.most_common()},
        "top_kernels_ms_per_step": {k[:90]: ms / steps
                                    for k, ms in kernels.most_common(10)},
        "kernel_launches_per_step": len(device) / steps,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "trace": trace and str(trace)}
    print(f"{name}: step {result['step_ms']:.1f} ms (forward+loss {fwd:.1f}, "
          f"backward {bwd:.1f}, optimizer {upd:.1f}); device "
          f"{result['device_ms_per_step']:.1f} ms of "
          f"{result['profiled_wall_ms_per_step']:.1f} ms profiled, idle "
          f"{result['idle_share']:.1%}")
    for g, ms in groups.most_common():
        print(f"  {g:26s} {ms / steps:8.2f} ms  {ms / device_ms:6.1%}")
    print(json.dumps(result), flush=True)
    return result


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--trace-dir", default=None)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_train_step: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import ance_tpu_torch  # noqa: F401  (TF32 off)
    print(torch.cuda.get_device_name(0), os.popen(
        "nvidia-smi --query-gpu=name,power.limit --format=csv,noheader"
    ).read().strip())
    profile("firstp", "rdot_nll", {}, 32, 64, 128, args.steps,
            args.trace_dir)
    profile("maxp", "rdot_nll_multi_chunk", {"attention_dropout": 0.0}, 8,
            64, 2048, args.steps, args.trace_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
