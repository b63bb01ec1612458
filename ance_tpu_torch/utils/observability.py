"""Metrics logging and profiling hooks (counterpart of
``ance_tpu/utils/observability.py``).

:class:`MetricsLogger` writes the JSONL metrics log that ``ance-loop``
keeps as ``refresh.jsonl``: one line per event, flushed at once, line for
line the JAX logger's for the same calls (time fields aside).
:func:`profile` captures a ``torch.profiler`` trace (CPU and, on the card,
CUDA activity) for TensorBoard.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Iterator, Optional


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


@contextlib.contextmanager
def profile(log_dir: Optional[str]) -> Iterator[None]:
    """``torch.profiler`` trace capture into ``log_dir`` (view with
    TensorBoard's profiler plugin); CUDA activity is traced where a card
    is present. No ``log_dir``: nothing is traced."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, tensorboard_trace_handler
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


class StepTimer:
    """Rolling steps/sec + examples/sec."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times: list[float] = []

    def tick(self) -> None:
        self._times.append(time.perf_counter())
        if len(self._times) > self.window:
            self._times.pop(0)

    def steps_per_sec(self) -> float:
        if len(self._times) < 2:
            return 0.0
        dt = self._times[-1] - self._times[0]
        return (len(self._times) - 1) / dt if dt > 0 else 0.0
