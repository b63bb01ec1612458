"""CUDA-event spans, after ``ance_tpu_torch/utils/timing.py``'s event
timing (copied, so that a change to the program cannot move it).

A span records an event before and after the work on the current stream
and reads the pairs only when asked, after a synchronize: timing adds no
host round trip to the loop it measures.
"""

from __future__ import annotations

import contextlib

import torch


class EventSpans:
    """Device time of each ``with spans.span():`` block, read once the
    stream has been synchronized."""

    def __init__(self):
        self.enabled = torch.cuda.is_available()
        self._pairs: list[tuple] = []

    @contextlib.contextmanager
    def span(self):
        if not self.enabled:
            yield
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            end.record()
            self._pairs.append((start, end))

    def ms(self) -> list[float]:
        """Each span's device ms; synchronizes."""
        if not self._pairs:
            return []
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self._pairs]
