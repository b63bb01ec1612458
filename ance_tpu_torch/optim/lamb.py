"""LAMB with the reference's exact (nonstandard) rules.

Counterpart of ``ance_tpu/optim/lamb.py::reference_lamb`` (itself the
reference's utils/lamb.py:95-121), as a ``torch.optim.Optimizer``:

  * no bias correction of the moments,
  * the weight norm clamped to [0, 10],
  * trust ratio 1 whenever either norm is zero,
  * weight decay added to the Adam step before the trust-ratio norm,
  * ``adam=True`` forces trust ratio 1 (un-debiased Adam).

The trust ratio is per parameter tensor. Parameters update in place. The
learning rate is the group's ``lr``; a schedule sets it before each step
(``train/trainer.py``), evaluated at the step count before the increment,
as ``reference_lamb`` evaluates ``learning_rate(count - 1)``. Every norm
and ratio stays a device tensor: a step makes no host round trip.
"""

from __future__ import annotations

from typing import Iterable

import torch


class ReferenceLamb(torch.optim.Optimizer):
    """Defaults as reference utils/lamb.py:45 (eps 1e-6; the drivers pass
    ``--adam_epsilon`` 1e-8). Give biases and LayerNorms a group with
    ``weight_decay=0`` for the reference's no-decay grouping
    (:func:`bias_layernorm_no_decay_mask`)."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-6, weight_decay: float = 0.0,
                 adam: bool = False):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay, adam=adam))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("ReferenceLamb takes no closure")
        for group in self.param_groups:
            b1, b2 = group["betas"]
            lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                m, v = state["exp_avg"], state["exp_avg_sq"]
                m.mul_(b1).add_(g * (1.0 - b1))
                v.mul_(b2).add_(g * (1.0 - b2) * g)
                adam_step = m / (v.sqrt() + eps)
                if wd != 0.0:
                    adam_step = adam_step + wd * p
                if group["adam"]:
                    p.add_(adam_step * -lr)
                    continue
                p.add_(adam_step * (-lr * _trust_ratio(p, adam_step)))


def _trust_ratio(p: torch.Tensor, adam_step: torch.Tensor) -> torch.Tensor:
    weight_norm = p.norm().clamp(0.0, 10.0)
    adam_norm = adam_step.norm()
    zero = (weight_norm == 0.0) | (adam_norm == 0.0)
    return torch.where(zero, torch.ones_like(weight_norm),
                       weight_norm / torch.where(adam_norm == 0.0,
                                                 torch.ones_like(adam_norm),
                                                 adam_norm))


def bias_layernorm_no_decay_mask(
        named_params: Iterable[tuple[str, torch.Tensor]]) -> dict[str, bool]:
    """name → whether the parameter takes weight decay: not biases and not
    any LayerNorm parameter (the port's HF names: ``*.bias``,
    ``*LayerNorm*``, the head's ``norm``), the reference's no_decay
    grouping on ["bias", "LayerNorm.weight"]."""
    out = {}
    for name, _ in named_params:
        keys = name.split(".")
        out[name] = keys[-1] != "bias" and not any(
            "norm" in k.lower() for k in keys)
    return out


def lamb_trust_ratios(optimizer: ReferenceLamb,
                      named_params: Iterable[tuple[str, torch.Tensor]],
                      eps: float = 1e-6, weight_decay: float = 0.0
                      ) -> dict[str, torch.Tensor]:
    """Diagnostic: the per-parameter trust ratio the next step would use
    from the current moments (the reference's log_lamb_rs), weight decay
    applied to every parameter, as in the JAX diagnostic. A parameter no
    step has touched yet has zero moments (the JAX state's initial ones),
    so a zero Adam step."""
    out = {}
    with torch.no_grad():
        for name, p in named_params:
            state = optimizer.state[p]
            if state:
                adam_step = state["exp_avg"] / (state["exp_avg_sq"].sqrt()
                                                + eps)
            else:
                adam_step = torch.zeros_like(p)
            if weight_decay != 0.0:
                adam_step = adam_step + weight_decay * p
            out[name] = _trust_ratio(p, adam_step)
    return out


def trust_ratio_summary(optimizer, named_params, eps: float = 1e-6,
                        weight_decay: float = 0.0) -> dict | None:
    """min/mean/max of the per-parameter LAMB trust ratios (the reference
    plots them as TB histograms, utils/lamb.py:11-22 log_lamb_rs), as
    ``ance_tpu/optim/lamb.py::trust_ratio_summary`` gives them: with its
    defaults (eps 1e-6, no weight decay), the mean in fp32. ``optimizer``
    is a :class:`ReferenceLamb` or the train step's ``Optimizer`` around
    one; None for any other optimizer (AdamW)."""
    inner = getattr(optimizer, "inner", optimizer)
    if not isinstance(inner, ReferenceLamb):
        return None
    ratios = torch.stack(list(lamb_trust_ratios(
        inner, named_params, eps, weight_decay).values())).cpu()
    return {"trust_ratio_min": float(ratios.min()),
            "trust_ratio_mean": float(ratios.mean()),
            "trust_ratio_max": float(ratios.max())}
