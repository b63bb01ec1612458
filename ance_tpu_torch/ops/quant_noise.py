"""Quantization noise (Quant-Noise, Fan et al. 2020): block DropConnect on a
weight (counterpart of ``ance_tpu/ops/quant_noise.py``; the reference's
fairseq ``quant_noise``, model/SEED_Encoder/modules.py:1631-1711).

During training each contiguous ``block_size`` span of a weight's input
axis is dropped independently per output feature with probability ``p``,
and the surviving weights are scaled by ``1/(1-p)``; evaluation uses the
raw weights. ``nn.Linear.weight`` is [out, in], as the reference's, so the
blocks tile axis 1 here; the JAX package's flax kernels are [in, out] and
tile axis 0: the same (out-feature, in-block) granularity. Draws come from
the caller's ``torch.Generator``. Dormant (``q_noise=0``) in every shipped
SEED config; ``EncoderConfig(quant_noise_p=..., quant_noise_block=...)``
applies it to the attention projections (``models/transformer.py``).
"""

from __future__ import annotations

import torch


def block_drop_mask(out_features: int, in_features: int, p: float,
                    block_size: int, generator: torch.Generator
                    ) -> torch.Tensor:
    """[out, in // block_size] bool, True where a block is dropped: each
    block independently with probability ``p``."""
    u = torch.rand((out_features, in_features // block_size),
                   generator=generator, device=generator.device)
    return u < p


def apply_block_drop(weight: torch.Tensor, drop: torch.Tensor, p: float,
                     block_size: int) -> torch.Tensor:
    """``weight`` [out, in] with the blocks ``drop`` marks zeroed and every
    other entry scaled by 1/(1-p) (reference modules.py:1707-1708)."""
    mask = drop.to(weight.device).repeat_interleave(block_size, dim=1)
    return torch.where(mask, torch.zeros_like(weight),
                       weight * (1.0 / (1.0 - p)))


def quant_noise(weight: torch.Tensor, p: float, block_size: int,
                generator: torch.Generator) -> torch.Tensor:
    """Training-time block quantization noise on an [out, in] weight.
    ``p = 0`` returns the weight unchanged; the input axis must be a
    multiple of ``block_size`` (reference modules.py:1663)."""
    if p <= 0.0:
        return weight
    if not 0.0 < p < 1.0:
        raise ValueError(f"quant_noise p must be in [0, 1), got {p}")
    out_f, in_f = weight.shape
    if in_f % block_size:
        raise ValueError(
            f"input features {in_f} not a multiple of block size "
            f"{block_size} (reference modules.py:1663)")
    drop = block_drop_mask(out_f, in_f, p, block_size, generator)
    return apply_block_drop(weight, drop, p, block_size)
