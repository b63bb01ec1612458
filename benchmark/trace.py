"""A traced slice of a run, and what the device trace says about it.

:class:`TracedSlice` runs ``torch.profiler`` (CPU and CUDA) over a short
piece of work inside a ``bench.slice`` range that starts and ends with a
synchronize, writes the Chrome trace, and :func:`reduce_trace` reads it:

* ``window_s``: the slice's length on the host clock;
* ``busy_s``: the union of the device's kernel, copy and set intervals in
  it, so that work on two streams at once counts once;
* per named range (``bench.attention``, ``bench.search``, ...): the union
  of the device intervals of the kernels launched while the range was
  open on the launching thread, found through the launch's correlation id;
  whatever the kernels' names are;
* ``device_ops``: device seconds by kernel name, the ten largest;
* ``idle_gaps``: the device's idle seconds, summed by what the host was
  doing at each gap's middle (the innermost CPU op, annotation or runtime
  call open on the slice's thread), the ten largest.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import heapq
import json
import os

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
SLICE = "bench.slice"
NAME_CHARS = 96


def union_length(intervals) -> float:
    """Total length covered by ``(start, end)`` intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def merged(intervals) -> list[tuple[float, float]]:
    """The union of ``(start, end)`` intervals as disjoint, sorted ones."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _clip(iv, lo, hi):
    s, e = max(iv[0], lo), min(iv[1], hi)
    return (s, e) if e > s else None


def reduce_trace(events: list[dict], ranges=()) -> dict:
    """The slice's summary from Chrome-trace events (times in µs)."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    sl = [e for e in xs if e.get("cat") == "user_annotation"
          and e.get("name") == SLICE]
    if not sl:
        raise ValueError(f"no {SLICE} range in the trace")
    sl = max(sl, key=lambda e: e["dur"])
    lo, hi = float(sl["ts"]), float(sl["ts"]) + float(sl["dur"])
    main_tid = sl.get("tid")

    dev = []
    for e in xs:
        if e.get("cat") in DEVICE_CATS:
            iv = _clip((float(e["ts"]), float(e["ts"]) + float(e["dur"])),
                       lo, hi)
            if iv:
                dev.append((iv, e))
    busy = merged(iv for iv, _ in dev)

    # kernels launched inside each named range, by correlation id
    launches = {}
    for e in xs:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = (e.get("tid"), float(e["ts"]))
    opened = collections.defaultdict(list)
    for e in xs:
        if e.get("cat") == "user_annotation" and e.get("name") in ranges:
            opened[(e["name"], e.get("tid"))].append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    starts = {key: ([s for s, _ in sorted(v)], sorted(v))
              for key, v in opened.items()}
    in_range = collections.defaultdict(list)
    for iv, e in dev:
        corr = (e.get("args") or {}).get("correlation")
        if corr not in launches:
            continue
        tid, ts = launches[corr]
        for name in ranges:
            key = (name, tid)
            if key not in starts:
                continue
            firsts, spans = starts[key]
            i = bisect.bisect_right(firsts, ts) - 1
            if i >= 0 and spans[i][0] <= ts <= spans[i][1]:
                in_range[name].append(iv)

    by_op = collections.Counter()
    for iv, e in dev:
        by_op[str(e.get("name"))[:NAME_CHARS]] += (iv[1] - iv[0]) / 1e6

    gaps = []
    prev = lo
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if hi > prev:
        gaps.append((prev, hi))
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   str(e.get("name"))[:NAME_CHARS]) for e in xs
                  if e.get("cat") in HOST_CATS and e.get("tid") == main_tid
                  and e is not sl)
    by_host = collections.Counter()
    active: list = []
    j = 0
    for g0, g1 in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
        mid = (g0 + g1) / 2
        while j < len(host) and host[j][0] <= mid:
            heapq.heappush(active, (host[j][1], host[j][0], host[j][2]))
            j += 1
        while active and active[0][0] < mid:
            heapq.heappop(active)
        name = min(active, key=lambda a: a[0] - a[1])[2] if active \
            else "python (no op open)"
        by_host[name] += (g1 - g0) / 1e6

    return {
        "window_s": (hi - lo) / 1e6,
        "busy_s": sum(e - s for s, e in busy) / 1e6,
        "range_device_s": {name: union_length(in_range[name]) / 1e6
                           for name in ranges},
        "range_calls": {name: sum(len(v) for (n, _), v in opened.items()
                                  if n == name) for name in ranges},
        "device_ops": [[n, s] for n, s in by_op.most_common(10)],
        "idle_gaps": [[n, s] for n, s in by_host.most_common(10)],
    }


class TracedSlice:
    """``with TracedSlice(path, ranges) as t: work()`` profiles ``work``
    inside a synchronized ``bench.slice`` range; ``t.summary`` then holds
    :func:`reduce_trace`'s result. The trace file is deleted after it is
    read."""

    def __init__(self, path: str, ranges=()):
        self.path, self.ranges = path, tuple(ranges)
        self.summary: dict | None = None
        self._stack = contextlib.ExitStack()

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function
        torch.cuda.synchronize()
        self._prof = self._stack.enter_context(profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
        self._stack.enter_context(record_function(SLICE))
        return self

    def __exit__(self, exc_type, exc, tb):
        try:
            torch.cuda.synchronize()
        finally:
            self._stack.close()
        if exc_type is not None:
            return False
        self._prof.export_chrome_trace(self.path)
        try:
            with open(self.path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(self.path)
        self.summary = reduce_trace(events, self.ranges)
        return False
