"""Timing calls on the card, for the measurement scripts (``chip_smoke.py``
and ``ance_tpu_torch.experiments``).

A call is timed with two CUDA events around it. The device is kept busy
(a spin kernel of SPACER_CYCLES) while the host enqueues the call, so the
window holds the call's device work alone. Without the spacer the device
sat idle in the window until the host had run the wrapper's checks and
launched (tens of µs), which weighs on a 0.1 ms kernel and moves with the
host's state, not the card's. A call that synchronises inside still
counts the host's work after its first launch.
"""

from __future__ import annotations

import statistics
import subprocess

import torch

# ~1 ms at the H100's 1,980 MHz: longer than any timed call's enqueue
SPACER_CYCLES = 2_000_000


def event_ms(fn) -> float:
    """CUDA-event time of one ``fn()`` in ms, after a spacer."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPACER_CYCLES)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def cuda_ms(fn, reps: int = 5) -> float:
    """Median ``event_ms(fn)`` over ``reps`` runs, after one warm-up run."""
    fn()
    return statistics.median(event_ms(fn) for _ in range(reps))


def cuda_ms_turns(fns: dict, reps: int = 9, warmup: int = 10) -> dict:
    """Median ``event_ms`` of each ``fns[name]``, timed in turns (one run of
    each per round, after ``warmup`` rounds), so that a kernel and its
    yardstick see the same clocks. Keep a much longer call out of the
    rotation (in one H100 run, before the spacer, the bf16 fused forward at
    B=128 S=512 read 1.25 ms right after its 7.6 ms plain version and 0.89
    ms in a run of its own)."""
    for _ in range(warmup):
        for fn in fns.values():
            fn()
    times = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            times[name].append(event_ms(fn))
    return {name: statistics.median(t) for name, t in times.items()}


def clocks() -> dict:
    """The card's SM clock and power draw now, as ``nvidia-smi
    --query-gpu=clocks.sm,power.draw --format=csv,noheader`` prints them
    (e.g. "1980 MHz", "402.17 W")."""
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    sm, power = (field.strip() for field in line.split(","))
    return {"sm_clock": sm, "power_draw": power}


def timed_in_turns(fns: dict, reps: int = 9) -> tuple[dict, dict]:
    """``cuda_ms_turns(fns)`` and the clocks sampled just before and just
    after it: (times, {"before": clocks(), "after": clocks()})."""
    before = clocks()
    times = cuda_ms_turns(fns, reps)
    return times, {"before": before, "after": clocks()}


def clocks_text(c: dict) -> str:
    """``timed_in_turns``' clock readings on one line."""
    b, a = c["before"], c["after"]
    return (f"clocks {b['sm_clock']} {b['power_draw']} -> {a['sm_clock']} "
            f"{a['power_draw']}")
