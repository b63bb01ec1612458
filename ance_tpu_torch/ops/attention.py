"""Multi-head attention, the plain (non-kernel) path.

Counterpart of ``ance_tpu/ops/attention.py``. Only the einsum path is
ported: at the FirstP lengths (passages 128, queries 64) the JAX package's
``auto`` takes XLA too. The Pallas kernels behind ``fused`` (256 ≤ S ≤ 1024)
and ``flash`` (S > 1024) are ROADMAP Queue 2 items #2-#4; until they exist
here those selections raise rather than run the plain path where the JAX
package ran a kernel.

Layout follows the JAX package: q/k/v are [B, S, H, D].
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e9  # additive mask bias; a fully masked row softmaxes uniform

_KERNEL_TODO = ("is a Pallas kernel in ance_tpu and not yet ported "
                "(ROADMAP Queue 2 #2 fused / #4 flash)")


def mask_to_bias(attention_mask: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B, S] {0,1} mask → [B, 1, 1, S] additive bias (0 keep / NEG_INF drop)."""
    bias = (1.0 - attention_mask.to(torch.float32)) * NEG_INF
    return bias[:, None, None, :].to(dtype)


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: Optional[torch.Tensor] = None,
                  softmax_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Scaled dot-product attention with the softmax in ``softmax_dtype``;
    probabilities are cast to the input dtype before the PV product.
    Returns [B, S, H, D]."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    # bf16 × bf16 products are exact in fp32, so upcasting the operands is
    # the bf16-in / fp32-accumulate product of the JAX einsum
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(softmax_dtype),
                          k.to(softmax_dtype))
    logits = logits * torch.tensor(scale, dtype=softmax_dtype)
    if bias is not None:
        logits = logits + bias.to(softmax_dtype)
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         attention_mask: Optional[torch.Tensor] = None,
                         *, impl: str = "xla") -> torch.Tensor:
    """``xla`` (fp32 softmax), ``xla_bf16`` (bf16 softmax) or ``auto``
    (S < 256 → xla, or xla_bf16 for bf16 inputs)."""
    if impl == "auto":
        if q.shape[1] >= 256:
            raise NotImplementedError(
                f"attention at S={q.shape[1]} (auto → fused/flash) "
                + _KERNEL_TODO)
        impl = "xla_bf16" if q.dtype == torch.bfloat16 else "xla"
    if impl in ("fused", "flash"):
        raise NotImplementedError(f"attention impl {impl!r} " + _KERNEL_TODO)
    if impl not in ("xla", "xla_bf16"):
        raise ValueError(f"unknown attention impl {impl!r}")
    bias = None if attention_mask is None else mask_to_bias(attention_mask)
    softmax_dtype = torch.bfloat16 if impl == "xla_bf16" else torch.float32
    return xla_attention(q, k, v, bias, softmax_dtype=softmax_dtype)
