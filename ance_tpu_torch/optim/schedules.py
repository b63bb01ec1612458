"""Learning-rate schedules of the reference drivers (counterpart of
``ance_tpu/optim/schedules.py``).

Each schedule maps the optimizer step count *before* the increment to a
learning rate (the first update sees lr(0)), as ``reference_lamb`` and the
reference's ``LambdaLR`` do. The arithmetic is float32, as in the JAX
package, so both give the same rates.

* :func:`warmup_linear` — ``WarmupLinearSchedule`` (the default);
* :func:`warmup_cosine` — ``WarmupCosineSchedule`` (``--lr_style cosine``);
* :func:`constant`;
* :class:`RewarmupSchedule` — the reference's default without
  ``--single_warmup``: a fresh warmup-linear schedule at every new
  ann-data file, its decay horizon that file's line count
  (run_ann.py:210-215); :func:`reset_rewarmup` re-anchors it at a swap.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

f32 = np.float32


def _warmup_linear_lr(base_lr: float, warmup_steps: int, local, horizon
                      ) -> float:
    """base · clip(min(local/warmup, (horizon − local)/max(1, horizon −
    warmup)), 0, 1) in fp32."""
    w = max(warmup_steps, 1)
    local = f32(local)
    warm = local / f32(w)
    decay = (f32(horizon) - local) / f32(max(1.0, float(f32(horizon)) - w))
    return float(f32(base_lr) * np.clip(min(warm, decay), f32(0), f32(1)))


def warmup_linear(base_lr: float, warmup_steps: int, total_steps: int):
    """lr(step) = base · min(step/warmup, (total−step)/(total−warmup))⁺."""
    def schedule(step: int) -> float:
        return _warmup_linear_lr(base_lr, warmup_steps, step, total_steps)
    return schedule


def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                  cycles: float = 0.5):
    """Linear warmup, then cosine decay over ``cycles`` half-cosines."""
    w = max(warmup_steps, 1)

    def schedule(step: int) -> float:
        step = f32(step)
        warm = np.clip(step / f32(w), f32(0), f32(1))
        progress = np.clip((step - f32(w)) / f32(max(1.0, total_steps - w)),
                           f32(0), f32(1))
        cos = max(f32(0), f32(0.5) * (f32(1) + np.cos(
            f32(math.pi * cycles * 2.0) * progress, dtype=f32)))
        return float(f32(base_lr) * (warm if step < f32(w) else cos))
    return schedule


def constant(base_lr: float):
    def schedule(step: int) -> float:
        return float(f32(base_lr))
    return schedule


@dataclasses.dataclass
class RewarmupSchedule:
    """Warmup-linear at the step count less ``anchor`` (the step of the
    last ann-data swap), decaying to zero at ``horizon``."""

    base_lr: float
    warmup_steps: int
    horizon: float
    anchor: int = 0

    def __call__(self, step: int) -> float:
        return _warmup_linear_lr(self.base_lr, self.warmup_steps,
                                 step - self.anchor, self.horizon)


def reset_rewarmup(schedule: RewarmupSchedule, step: int,
                   horizon: float) -> None:
    """Re-anchor at ``step`` with a new decay horizon (the new file's
    training-line count): the reference's fresh scheduler per file."""
    schedule.anchor = int(step)
    schedule.horizon = float(horizon)
