"""Blocked flash attention forward.

Counterpart of ``ance_tpu/ops/flash_attention.py`` (``_flash_kernel`` via
``_flash_forward``). On a CUDA tensor :func:`flash_attention` launches the
hand-written Hopper kernel of ``csrc/flash_attention.cu`` that
:func:`flash_kernel_for` names: query rows stream the keys in tiles of 64
with a running max, sum and accumulator, so memory is O(S). For bf16 it
is a wgmma kernel fed by TMA (128 query rows a block): q·k in bf16 (the
scale 1/8 is exact), and the fp32 p split into three bf16 pieces whose
sum is p exactly, so p·v is three bf16 products into one fp32 accumulator
with no loss. fp32 takes the same block on exact bf16 pieces (the
``pieces`` route): one launch splits q, k and v into three bf16 pieces
each, and every product runs as the six piece products with i + j ≤ 2 on
wgmma, a fresh accumulator a 64-key tile, each tile's p·v added to a
running fp32 total; the bias streams with the key tiles, so any S ≥ 1
runs. fp32 operands whose rows are not 16-byte aligned stay on a
CUDA-core kernel (TF32 stays off everywhere). On a CPU tensor it runs the
plain version :func:`flash_attention_reference`.

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

import collections
import ctypes
import math
from typing import Optional

import torch

from ance_tpu_torch.ops.attention import (kernel_operands, mask_to_bias,
                                          pieces_layout, xla_attention)


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


# each kernel's code at csrc/flash_attention.cu's entry point
_KERNEL_CODES = {"flash_fwd_f32": 0, "flash_fwd_bf16": 1,
                 "flash_fwd_pieces": 2}


def flash_kernel_for(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> str:
    """The kernel of ``csrc/flash_attention.cu`` that these operands take
    on the card, chosen by dtype and layout before any launch: bf16 takes
    ``flash_fwd_bf16``; fp32 takes ``flash_fwd_pieces`` where the split's
    16-byte loads read every row (strides a multiple of 4 elements,
    16-byte-aligned bases), else the CUDA-core ``flash_fwd_f32``. The
    encoder's contiguous q/k/v and its ``qkv.chunk`` views at D = 64 take
    the pieces route."""
    if q.dtype == torch.bfloat16:
        return "flash_fwd_bf16"
    return "flash_fwd_pieces" if pieces_layout(q, k, v) else "flash_fwd_f32"


def flash_attention_forward(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor,
                            attention_mask: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """The forward alone (no autograd). A CPU tensor takes the plain
    version. A CUDA tensor launches the kernel :func:`flash_kernel_for`
    names (``flash_attention.launches`` counts the launches,
    ``flash_attention.kernel_launches`` each kernel's) or raises: it takes
    float32 or bfloat16, D = 64, any S ≥ 1, q/k/v sharing one set of
    strides with unit stride along D (bf16: 16-byte-aligned rows, as the
    encoder's ``qkv.chunk`` views have)."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, attention_mask)
    bias, (sb, ss, sh) = kernel_operands(
        q, k, v, attention_mask, name="flash_attention",
        align16=q.dtype == torch.bfloat16)
    kernel = flash_kernel_for(q, k, v)
    out = launch(kernel, q, k, v, bias, (sb, ss, sh))
    flash_attention.launches += 1
    flash_attention.kernel_launches[kernel] += 1
    return out


def launch(kernel: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           bias: torch.Tensor, strides: tuple[int, int, int]) -> torch.Tensor:
    """Launch ``kernel`` of ``csrc/flash_attention.cu`` on CUDA operands
    that ``kernel_operands`` checked (its bias and shared strides) and
    return the output, or raise. It counts nothing: each wrapper counts
    its own launches. ``flash_fwd_pieces`` is also the fused attention's
    fp32 forward, whose function it is for fp32 operands."""
    B, S, H, D = q.shape
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    # the pieces route's bf16 scratch: three pieces of each operand
    pieces = torch.empty((3, 3, *q.shape), dtype=torch.bfloat16,
                         device=q.device) \
        if kernel == "flash_fwd_pieces" else None
    lib = _kernel_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            _KERNEL_CODES[kernel], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias.data_ptr(), out.data_ptr(),
            None if pieces is None else pieces.data_ptr(), B, S, H, D,
            *strides, 1.0 / math.sqrt(D), stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel {kernel} launch failed: "
                           f"CUDA error {err} (B={B} S={S} H={H} D={D})")
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
flash_attention.kernel_launches = collections.Counter()  # by kernel name


def _kernel_library() -> ctypes.CDLL:
    from ance_tpu_torch.ops._build import load_library
    return bind(load_library("flash_attention"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the argument types of a ``flash_attention.cu`` library's
    entry point (also a variant's build of it)."""
    fn = lib.flash_attention_launch
    # every pointer and the stream as c_void_p: an undeclared argument is
    # passed as a 32-bit int and the pointer is cut
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [
        ctypes.c_int] * 4 + [ctypes.c_longlong] * 3 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
