"""Metrics logging and the program's spans (counterpart of
``ance_tpu/utils/observability.py``).

:class:`MetricsLogger` writes the JSONL metrics log that ``ance-loop``
keeps as ``refresh.jsonl``: one line per event, flushed at once, line for
line the JAX logger's for the same calls (time fields aside).

:func:`span` marks a piece of the program's work by a fixed name
(``<module>.<what>``). It records only while a ``torch.profiler`` is
recording; otherwise it costs one check and returns a shared no-op. While
a profiler records, a span opens a ``record_function`` range, so the work
sits in the profiler's trace on the device kernels' timeline, and adds its
host time, its self time (less its child spans) and its parent to an
in-memory store kept by name; a span given a CUDA device also records a
pair of CUDA events on that device's current stream, read only by
:func:`span_totals` (after a synchronize), so a traced run makes no host
round trip inside the work. The profiler's trace is the export: nothing
is written out.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import logging
import os
import threading
import time
from typing import Optional

import torch


def setup_logging(rank: int = 0, log_dir: Optional[str] = None) -> None:
    """Rank-aware level (INFO on rank 0, WARN elsewhere — reference
    run_ann.py:630-643)."""
    level = logging.INFO if rank in (-1, 0) else logging.WARNING
    logging.basicConfig(
        level=level,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    if log_dir and rank in (-1, 0):
        os.makedirs(log_dir, exist_ok=True)
        handler = logging.FileHandler(os.path.join(log_dir, "train.log"))
        logging.getLogger().addHandler(handler)


class MetricsLogger:
    """Append-only JSONL metrics: one line per event, flushed immediately
    (durable like the reference's ann_ndcg_* sidecars). A value with
    ``__float__`` (a numpy or a 0-d torch scalar) is written as a float."""

    def __init__(self, path: Optional[str], enabled: bool = True):
        self.enabled = enabled and path is not None
        self._f = None
        if self.enabled:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a", buffering=1)

    def log(self, step: int, **metrics) -> None:
        if not self.enabled:
            return
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: (float(v) if hasattr(v, "__float__") else v)
                    for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        if self._f:
            self._f.close()


@dataclasses.dataclass
class _Total:
    calls: int = 0
    host_ns: int = 0
    self_ns: int = 0
    device_ms: Optional[float] = None
    parent: Optional[str] = None


_NO_SPAN = contextlib.nullcontext()
_SPAN_LOCK = threading.Lock()
_totals: dict[str, _Total] = {}
_pending: list = []  # (name, start event, end event), read by span_totals
_open = threading.local()  # each thread's stack of open spans


class _Span:
    """One recorded span; see :func:`span`."""

    __slots__ = ("name", "device", "parent", "child_ns", "_range", "_t0",
                 "_start")

    def __init__(self, name: str, device: Optional[torch.device]):
        self.name, self.device = name, device

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self.child_ns = 0
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self._start = None
        if self.device is not None:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record(torch.cuda.current_stream(self.device))
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter_ns() - self._t0
        end = None
        if self._start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self.device))
        self._range.__exit__(*exc)
        _open.stack.pop()
        if self.parent is not None:
            self.parent.child_ns += dur
        with _SPAN_LOCK:
            total = _totals.get(self.name)
            if total is None:
                total = _totals[self.name] = _Total(
                    parent=self.parent.name if self.parent else None)
            total.calls += 1
            total.host_ns += dur
            total.self_ns += dur - self.child_ns
            if end is not None:
                _pending.append((self.name, self._start, end))
        return False


def span(name: str, device=None):
    """A context manager that times the work inside it under ``name``
    while a profiler records (module docstring), and does nothing
    otherwise. ``device``: where the work runs; on a CUDA device the span
    also times the device stream between its ends."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    if device is not None and torch.device(device).type != "cuda":
        device = None
    return _Span(name, device)


def span_totals() -> dict[str, dict]:
    """By span name: ``calls``, ``host_s``, ``self_s`` (host time less the
    part that its child spans cover), ``device_ms`` (spans given a CUDA
    device: the stream's time between their ends, summed; None for the
    others) and ``parent`` (the span open around the first call on its
    thread, or None). Waits for the device work of pending spans."""
    with _SPAN_LOCK:
        pending = list(_pending)
        _pending.clear()
    device_ms = collections.Counter()
    for name, start, end in pending:
        end.synchronize()
        device_ms[name] += start.elapsed_time(end)
    with _SPAN_LOCK:
        for name, ms in device_ms.items():
            total = _totals[name]
            total.device_ms = (total.device_ms or 0.0) + ms
        return {name: {"calls": t.calls, "host_s": t.host_ns / 1e9,
                       "self_s": t.self_ns / 1e9, "device_ms": t.device_ms,
                       "parent": t.parent}
                for name, t in _totals.items()}


def reset_spans() -> None:
    """Forget every recorded span."""
    with _SPAN_LOCK:
        _totals.clear()
        _pending.clear()
