"""Blocked flash attention forward.

Counterpart of ``ance_tpu/ops/flash_attention.py`` (``_flash_kernel`` via
``_flash_forward``). On a CUDA tensor :func:`flash_attention` launches the
hand-written Hopper kernel ``csrc/flash_attention.cu``: 64 queries per
block stream the keys in tiles of 64 with a running max, sum and
accumulator, so memory is O(S). On a CPU tensor it runs the plain version
:func:`flash_attention_reference`.

This is another function than the fused kernel's: q is scaled in fp32
before the product, and k, v and the probabilities stay fp32 all the way
(the fused path rounds p to the input dtype before PV). The plain version
is therefore attention wholly in fp32, cast to the input dtype at the end;
the online softmax differs from it by rounding only.

The JAX kernel's ``block_q`` / ``block_k`` (256) and its rule that S be a
multiple of them are TPU tiling and are not carried over.

The gradient (:class:`FlashAttention`) is what the JAX ``custom_vjp``
gives: not a Pallas kernel but the VJP of ``xla_attention`` with an fp32
softmax, recomputed from the saved q, k, v and mask
(``ance_tpu/ops/flash_attention.py:137-149``). So here the backward is
autograd through that plain version — ordinary torch ops, no kernel.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ance_tpu_torch.ops.attention import (KERNEL_DTYPES, kernel_operands,
                                          mask_to_bias, xla_attention)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              attention_mask: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """The plain version: fp32 attention, q scaled first, cast at the end."""
    scale = torch.tensor(1.0 / math.sqrt(q.shape[-1]), dtype=torch.float32)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32) * scale,
                          k.to(torch.float32))
    if attention_mask is not None:
        logits = logits + mask_to_bias(attention_mask)
    weights = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", weights,
                        v.to(torch.float32)).to(q.dtype)


def flash_attention_forward(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor,
                            attention_mask: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """The forward alone (no autograd). A CPU tensor takes the plain
    version. A CUDA tensor launches the kernel (``flash_attention.launches``
    counts the launches) or raises: it takes float32 or bfloat16, D = 64,
    any S ≥ 1, q/k/v sharing one set of strides with unit stride along
    D."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, attention_mask)
    bias, (sb, ss, sh) = kernel_operands(q, k, v, attention_mask,
                                         name="flash_attention")
    B, S, H, D = q.shape
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lib = _kernel_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            KERNEL_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias.data_ptr(), out.data_ptr(), B, S, H, D, sb, ss, sh,
            1.0 / math.sqrt(D), stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA "
                           f"error {err} (B={B} S={S} H={H} D={D})")
    flash_attention.launches += 1
    return out


class FlashAttention(torch.autograd.Function):
    """The flash forward; its backward is the VJP of the fp32-softmax
    einsum attention, as in the JAX package."""

    @staticmethod
    def forward(ctx, q, k, v, attention_mask):
        ctx.save_for_backward(q, k, v, attention_mask)
        return flash_attention_forward(q, k, v, attention_mask)

    @staticmethod
    def backward(ctx, do):
        q, k, v, attention_mask = ctx.saved_tensors
        bias = None if attention_mask is None \
            else mask_to_bias(attention_mask)
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            out = xla_attention(*qkv, bias, softmax_dtype=torch.float32)
            dq, dk, dv = torch.autograd.grad(out, qkv, do)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    attention_mask: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """q/k/v [B, S, H, D], attention_mask [B, S] {0,1} or None →
    [B, S, H, D] in the input dtype, differentiable in q, k and v
    (:class:`FlashAttention`)."""
    return FlashAttention.apply(q, k, v, attention_mask)


flash_attention.launches = 0


def _kernel_library() -> ctypes.CDLL:
    from ance_tpu_torch.ops._build import load_library
    lib = load_library("flash_attention")
    fn = lib.flash_attention_launch
    # every pointer and the stream as c_void_p: an undeclared argument is
    # passed as a 32-bit int and the pointer is cut
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 4 + [ctypes.c_longlong] * 3 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
