"""Multi-head attention: the plain path and the dispatch to the kernels.

Counterpart of ``ance_tpu/ops/attention.py``. Implementations:

  * ``xla``      — einsum + fp32 softmax (the reference semantics);
  * ``xla_bf16`` — einsum + bf16 softmax;
  * ``fused``    — whole-sequence attention, :mod:`.fused_attention` (the
                   hand-written kernel on a CUDA tensor, its plain version
                   on a CPU tensor);
  * ``flash``    — blocked online-softmax attention, :mod:`.flash_attention`
                   (likewise);
  * ``auto``     — on a CUDA tensor: the einsum path below S = 256 (bf16
                   softmax for bf16 inputs), ``fused`` for 256 ≤ S ≤ 1024,
                   ``flash`` above; on a CPU tensor always the einsum path,
                   as the JAX package does off the TPU. A causal call, or
                   one whose head size is not ``KERNEL_HEAD_DIM``, takes
                   the einsum path at any S.

A decoder's attention (``models/deepseek_v2.py``'s MLA) passes
``causal=True`` (a key is seen only by queries at or after it, on top of
the key mask), its own softmax ``scale``, and v with another head size
than q and k. Only the einsum path takes these; with ``causal=False`` and
no ``scale`` every call computes what it computed before they existed.

Training-time attention dropout (``dropout_rate`` > 0, inverted dropout on
the softmax weights, drawn from a ``torch.Generator``) exists on the einsum
path only: the kernels never hold the probabilities to drop from, so a
nonzero rate sends ``fused``, ``flash`` and ``auto`` to the einsum path
(``ance_tpu/ops/attention.py:102-103``). At rate 0 ``auto`` keeps its
thresholds, so a MaxP train step at S = 512 runs the fused kernel and its
backward.

The 256 / 1024 thresholds are the JAX package's, measured on a TPU; they
are kept so both packages choose alike, and re-choosing them on the H100
is open (PERF.md). A failed kernel build or launch raises: nothing falls
back to the plain path.

Layout follows the JAX package: q/k/v are [B, S, H, D].
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ance_tpu_torch.utils.observability import span

NEG_INF = -1e9  # additive mask bias; a fully masked row softmaxes uniform
FUSED_MIN_SEQ, FUSED_MAX_SEQ = 256, 1024  # auto: fused in [256, 1024]
KERNEL_HEAD_DIM = 64  # every supported encoder: RoBERTa/BERT base and large
KERNEL_DTYPES = (torch.float32, torch.bfloat16)  # what the kernels take


def pieces_layout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether the fp32 pieces routes' split (``split_pieces``: one 16-byte
    load a thread) reads every row of q, k and v: strides a multiple of 4
    elements and 16-byte-aligned bases. The encoder's contiguous q/k/v and
    its ``qkv.chunk`` views at D = 64 have that layout."""
    return all(s % 4 == 0 for t in (q, k, v) for s in t.stride()[:3]) \
        and all(t.data_ptr() % 16 == 0 for t in (q, k, v))


def mask_to_bias(attention_mask: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B, S] {0,1} mask → [B, 1, 1, S] additive bias (0 keep / NEG_INF drop)."""
    bias = (1.0 - attention_mask.to(torch.float32)) * NEG_INF
    return bias[:, None, None, :].to(dtype)


def causal_bias(S: int, device) -> torch.Tensor:
    """[S, S] fp32 additive bias: 0 where key ≤ query, NEG_INF above."""
    keys = torch.arange(S, device=device)
    return torch.where(keys[None, :] > keys[:, None],
                       torch.tensor(NEG_INF, device=device),
                       torch.tensor(0.0, device=device))


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: Optional[torch.Tensor] = None,
                  softmax_dtype: torch.dtype = torch.float32,
                  dropout_rate: float = 0.0,
                  generator: Optional[torch.Generator] = None,
                  causal: bool = False,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Scaled dot-product attention with the softmax in ``softmax_dtype``;
    probabilities are cast to the input dtype before the PV product.
    ``dropout_rate`` > 0 drops probability entries (kept ones scaled by
    1/(1 − rate)) with uniforms from ``generator``. ``causal`` adds
    :func:`causal_bias`; ``scale`` replaces 1/√D. v may have another head
    size than q and k. Returns [B, S, H, Dv]."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    # bf16 × bf16 products are exact in fp32, so upcasting the operands is
    # the bf16-in / fp32-accumulate product of the JAX einsum
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(softmax_dtype),
                          k.to(softmax_dtype))
    logits = logits * torch.tensor(scale, dtype=softmax_dtype)
    if causal:  # one [B, 1, S, S] bias, added to the logits once
        c = causal_bias(q.shape[1], q.device)
        bias = c if bias is None else bias + c
    if bias is not None:
        logits = logits + bias.to(softmax_dtype)
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    if dropout_rate > 0.0:
        if generator is None:
            raise ValueError("attention dropout needs a generator")
        keep = torch.rand(weights.shape, generator=generator,
                          device=weights.device) < 1.0 - dropout_rate
        weights = torch.where(keep, weights / (1.0 - dropout_rate),
                              torch.zeros_like(weights))
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def kernel_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    attention_mask: Optional[torch.Tensor], *, name: str,
                    max_seq: Optional[int] = None,
                    align16: bool = False) -> tuple[torch.Tensor, tuple]:
    """Check what an attention kernel takes and raise on anything else.
    Returns (the fp32 key bias [B, S], contiguous; the shared (batch, seq,
    head) strides of q, k and v in elements).

    The kernels take q, k, v of one shape [B, S, H, D] and one dtype
    (float32 or bfloat16) on one CUDA device, with D = KERNEL_HEAD_DIM,
    one set of strides and unit stride along D; ``align16`` also asks for
    16-byte-aligned rows and base addresses (the bf16 kernels' TMA
    boxes)."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: need q, k, v of one shape [B, S, H, D], "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"{name}: takes float32 or bfloat16 q, k, v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    B, S, H, D = q.shape
    if D != KERNEL_HEAD_DIM:
        raise ValueError(f"{name}: head dim {D} is not {KERNEL_HEAD_DIM}")
    if S < 1 or (max_seq is not None and S > max_seq):
        raise ValueError(f"{name}: sequence length {S} outside "
                         f"[1, {max_seq}]")
    if k.stride() != q.stride() or v.stride() != q.stride() \
            or q.stride(3) != 1:
        raise ValueError(f"{name}: q, k, v need one set of strides with unit "
                         f"stride along D, got {q.stride()}, {k.stride()}, "
                         f"{v.stride()}")
    strides = (q.stride(0), q.stride(1), q.stride(2))
    if align16:
        vec = 16 // q.element_size()
        if any(s % vec for s in strides) or D % vec or any(
                t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError(f"{name}: {q.dtype} operands need 16-byte-"
                             f"aligned rows (strides {strides})")
    # last, so that a CPU tensor meets every check above
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise ValueError(f"{name}: the kernel runs on one CUDA device, got "
                         f"{q.device}, {k.device}, {v.device}")
    if attention_mask is None:
        bias = torch.zeros((B, S), dtype=torch.float32, device=q.device)
    else:
        if tuple(attention_mask.shape) != (B, S):
            raise ValueError(f"{name}: attention mask {tuple(attention_mask.shape)}"
                             f" is not [B, S] = {(B, S)}")
        bias = ((1.0 - attention_mask.to(q.device, torch.float32))
                * NEG_INF).contiguous()
    return bias, strides


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         attention_mask: Optional[torch.Tensor] = None,
                         *, impl: str = "xla", dropout_rate: float = 0.0,
                         generator: Optional[torch.Generator] = None,
                         causal: bool = False, scale: Optional[float] = None
                         ) -> torch.Tensor:
    """Dispatch over the implementations in the module docstring; the
    call is the span ``encoder.attention``. ``causal``, ``scale`` and a v
    head size unlike q's exist on the einsum path only: ``auto`` sends
    such a call there, and ``fused`` or ``flash`` refuses it."""
    with span("encoder.attention"):
        if dropout_rate > 0.0 and impl in ("fused", "flash", "auto"):
            impl = "xla_bf16" if q.dtype == torch.bfloat16 else "xla"
        einsum_only = causal or scale is not None \
            or q.shape[-1] != KERNEL_HEAD_DIM or v.shape[-1] != q.shape[-1]
        if impl == "auto":
            S = q.shape[1]
            if q.device.type != "cuda" or S < FUSED_MIN_SEQ or einsum_only:
                impl = "xla_bf16" if q.dtype == torch.bfloat16 else "xla"
            else:
                impl = "fused" if S <= FUSED_MAX_SEQ else "flash"
        if impl in ("fused", "flash") and (causal or scale is not None):
            raise ValueError(f"attention impl {impl!r} has no causal mask "
                             f"or softmax scale; use the einsum path")
        if impl == "fused":
            from ance_tpu_torch.ops.fused_attention import fused_attention
            return fused_attention(q, k, v, attention_mask)
        if impl == "flash":
            from ance_tpu_torch.ops.flash_attention import flash_attention
            return flash_attention(q, k, v, attention_mask)
        if impl not in ("xla", "xla_bf16"):
            raise ValueError(f"unknown attention impl {impl!r}")
        bias = None if attention_mask is None else mask_to_bias(attention_mask)
        softmax_dtype = torch.bfloat16 if impl == "xla_bf16" \
            else torch.promote_types(q.dtype, torch.float32)
        return xla_attention(q, k, v, bias, softmax_dtype=softmax_dtype,
                             dropout_rate=dropout_rate, generator=generator,
                             causal=causal, scale=scale)
