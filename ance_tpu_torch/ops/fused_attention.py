"""Fused whole-sequence attention, forward and backward.

Counterpart of ``ance_tpu/ops/fused_attention.py``: the forward
(``_fused_kernel`` via ``_fused_forward``), the backward
(``_fused_bwd_kernel`` via ``_fused_backward``) and the ``custom_vjp``
that joins them, here the ``torch.autograd.Function``
:class:`FusedAttention`. Like the JAX ``_fwd`` it saves only q, k, v and
the mask; the backward recomputes the scores.

On a CUDA tensor both directions launch the hand-written Hopper kernels of
``csrc/fused_attention.cu`` that :func:`fused_kernel_for` names. For bf16
they are wgmma kernels fed by TMA: the forward owns 128 query rows of a
head and makes two passes over the key tiles (the exact row max and its
sum, then p rounded to bf16 and p·v), with every score tile in registers,
so the [B, H, S, S] scores never reach device memory. The backward is two
kernels: a rows pass (the forward's statistics, rowsum(dp ⊙ p), ds and dq
for 128 query rows) and a keys pass (128 keys of a head against every
query tile, dk and dv accumulated in registers), so no atomics and a
deterministic result. fp32 takes the same kernels' blocks on exact bf16
pieces (the ``pieces`` route): one launch splits q, k, v (and dout) into
three bf16 pieces each, and every product of the function runs as the six
piece products with i + j ≤ 2 on wgmma, a fresh accumulator a 64-deep
tile, each tile's partial sum added to a running fp32 total. In fp32 p is
never rounded and q/8 is exact, so the forward is the flash forward's
function, and it launches that kernel, ``flash_fwd_pieces`` of
``csrc/flash_attention.cu`` (one pass with an online softmax). fp32
operands whose rows are not 16-byte aligned stay on the CUDA-core kernels
(TF32 stays off everywhere).

On a CPU tensor each direction runs its plain version:
:func:`fused_attention_reference` (``xla_attention`` with an fp32 softmax:
scale, then add the bias, in fp32; p rounded to the input dtype before PV)
and :func:`fused_attention_backward_reference` (the same recompute and the
two casts of ``_fused_bwd_kernel``: p to the input dtype for dv, ds·scale
to the input dtype for dq and dk). The JAX ``ANCE_FUSED_XLA_BWD`` switch
is a TPU fallback and has no counterpart.
"""

from __future__ import annotations

import collections
import ctypes
import math
from typing import Optional

import torch

from ance_tpu_torch.ops.attention import (kernel_operands, mask_to_bias,
                                          pieces_layout, xla_attention)
from ance_tpu_torch.ops.flash_attention import launch as flash_launch

# the longest sequence: the wgmma kernels keep the key bias row in shared
# memory (8 KB), and the CUDA-core fp32 forward a 16-row tile's whole
# score rows (about 64·S + 21 KB of the 227 KB); ``auto`` sends S > 1024 to
# flash
MAX_SEQ = 2048
# the CUDA-core fp32 backward's rows pass also holds the fp32 dp rows:
# about 128·S + 21 KB; every route keeps this limit
MAX_SEQ_BACKWARD = 1024


def fused_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              attention_mask: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """The plain forward: einsum attention with an fp32 softmax."""
    bias = None if attention_mask is None else mask_to_bias(attention_mask)
    return xla_attention(q, k, v, bias, softmax_dtype=torch.float32)


def fused_attention_backward_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        attention_mask: Optional[torch.Tensor], do: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain backward, ``_fused_bwd_kernel`` step for step: recompute
    s and p in fp32; dv = pbᵀ·do with pb = p in the input dtype; dp =
    do·vᵀ; ds = p ⊙ (dp − rowsum(dp ⊙ p)); dq = dsb·k, dk = dsbᵀ·q with
    dsb = ds·scale in the input dtype. Products of input-dtype operands
    are taken in fp32 (exact for bf16 × bf16) and the results cast to the
    input dtype. Returns (dq, dk, dv), each [B, S, H, D]."""
    f32 = torch.float32
    scale = torch.tensor(1.0 / math.sqrt(q.shape[-1]), dtype=f32)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(f32), k.to(f32)) * scale
    if attention_mask is not None:
        s = s + mask_to_bias(attention_mask)
    p = torch.softmax(s, dim=-1)
    pb = p.to(v.dtype).to(f32)
    dv = torch.einsum("bhqk,bqhd->bkhd", pb, do.to(f32))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.to(f32), v.to(f32))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dsb = (ds * scale).to(q.dtype).to(f32)
    dq = torch.einsum("bhqk,bkhd->bqhd", dsb, k.to(f32))
    dk = torch.einsum("bhqk,bqhd->bkhd", dsb, q.to(f32))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# each kernel's code at csrc/fused_attention.cu's entry points
_KERNEL_CODES = {"fused_fwd_f32": 0, "fused_bwd_f32": 0, "fused_fwd_bf16": 1,
                 "fused_bwd_bf16": 1, "fused_bwd_pieces": 2}


def fused_kernel_for(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     backward: bool = False) -> str:
    """The kernel (for the backward, the rows and keys pair of
    ``csrc/fused_attention.cu``) that these operands take on the card,
    chosen by dtype and layout before any launch: bf16 takes
    ``fused_fwd_bf16`` / ``fused_bwd_bf16``; fp32 takes
    ``csrc/flash_attention.cu``'s ``flash_fwd_pieces`` /
    ``fused_bwd_pieces`` where the split's 16-byte loads read every row
    (strides a multiple of 4 elements, 16-byte-aligned bases), else the
    CUDA-core ``fused_fwd_f32`` / ``fused_bwd_f32``. The encoder's
    contiguous q/k/v and its ``qkv.chunk`` views at D = 64 take the
    pieces route."""
    kind = "bwd" if backward else "fwd"
    if q.dtype == torch.bfloat16:
        return f"fused_{kind}_bf16"
    if not pieces_layout(q, k, v):
        return f"fused_{kind}_f32"
    return "fused_bwd_pieces" if backward else "flash_fwd_pieces"


def fused_attention_forward(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor,
                            attention_mask: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """The forward alone (no autograd): the plain version on a CPU tensor;
    on a CUDA tensor the kernel :func:`fused_kernel_for` names
    (``fused_attention.launches`` counts the launches,
    ``fused_attention.kernel_launches`` each kernel's) or a raise. It
    takes float32 or bfloat16, D = 64, S ≤ MAX_SEQ, q/k/v sharing one set
    of strides with unit stride along D (bf16: 16-byte-aligned rows)."""
    if q.device.type == "cpu":
        return fused_attention_reference(q, k, v, attention_mask)
    bias, (sb, ss, sh) = kernel_operands(
        q, k, v, attention_mask, name="fused_attention", max_seq=MAX_SEQ,
        align16=q.dtype == torch.bfloat16)
    kernel = fused_kernel_for(q, k, v)
    if kernel == "flash_fwd_pieces":
        out = flash_launch(kernel, q, k, v, bias, (sb, ss, sh))
    else:
        B, S, H, D = q.shape
        out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
        lib = _kernel_library()
        with torch.cuda.device(q.device):
            err = lib.fused_attention_launch(
                _KERNEL_CODES[kernel], q.data_ptr(), k.data_ptr(),
                v.data_ptr(), bias.data_ptr(), out.data_ptr(), B, S, H, D,
                sb, ss, sh, 1.0 / math.sqrt(D), _stream(q.device))
        if err != 0:
            raise RuntimeError(f"fused attention kernel {kernel} launch "
                               f"failed: CUDA error {err} (B={B} S={S} H={H} "
                               f"D={D})")
    fused_attention.launches += 1
    fused_attention.kernel_launches[kernel] += 1
    return out


def fused_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor,
                             attention_mask: Optional[torch.Tensor],
                             do: torch.Tensor
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """(dq, dk, dv) for the output gradient ``do``: the plain version on a
    CPU tensor; on a CUDA tensor the backward kernels
    :func:`fused_kernel_for` names (``fused_attention_backward.launches``
    counts the calls, each one rows pass and one keys pass;
    ``.kernel_launches`` each route's) or a raise. It takes what the
    forward takes with S ≤ MAX_SEQ_BACKWARD, and ``do`` of q's shape and
    dtype."""
    if q.device.type == "cpu":
        return fused_attention_backward_reference(q, k, v, attention_mask,
                                                  do)
    bias, (sb, ss, sh) = kernel_operands(
        q, k, v, attention_mask, name="fused_attention_backward",
        max_seq=MAX_SEQ_BACKWARD, align16=q.dtype == torch.bfloat16)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"fused_attention_backward: do must match q, got "
                         f"{tuple(do.shape)} {do.dtype} {do.device}")
    vec = 16 // do.element_size()
    if do.stride(3) != 1 or do.data_ptr() % 16 or any(
            s % vec for s in do.stride()[:3]):
        do = do.contiguous()  # TMA boxes and 16-byte loads
    kernel = fused_kernel_for(q, k, v, backward=True)
    B, S, H, D = q.shape
    dq, dk, dv = (torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    # each row's softmax max, sum, 1/sum and rowsum(dp ⊙ p), in 64-row tiles
    stats = torch.empty(B * H * -(-S // 64) * 4 * 64, dtype=torch.float32,
                        device=q.device)
    # the pieces route's bf16 scratch: three pieces of q, k, v and dout
    pieces = torch.empty((4, 3, *q.shape), dtype=torch.bfloat16,
                         device=q.device) \
        if kernel == "fused_bwd_pieces" else None
    lib = _kernel_library()
    with torch.cuda.device(q.device):
        err = lib.fused_attention_backward_launch(
            _KERNEL_CODES[kernel], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), stats.data_ptr(),
            None if pieces is None else pieces.data_ptr(), B, S, H, D, sb,
            ss, sh, *do.stride()[:3], 1.0 / math.sqrt(D), _stream(q.device))
    if err != 0:
        raise RuntimeError(f"fused attention backward kernel {kernel} launch "
                           f"failed: CUDA error {err} (B={B} S={S} H={H} "
                           f"D={D})")
    fused_attention_backward.launches += 1
    fused_attention_backward.kernel_launches[kernel] += 1
    return dq, dk, dv


class FusedAttention(torch.autograd.Function):
    """The fused forward with its backward; saves q, k, v and the mask."""

    @staticmethod
    def forward(ctx, q, k, v, attention_mask):
        ctx.save_for_backward(q, k, v, attention_mask)
        return fused_attention_forward(q, k, v, attention_mask)

    @staticmethod
    def backward(ctx, do):
        q, k, v, attention_mask = ctx.saved_tensors
        dq, dk, dv = fused_attention_backward(q, k, v, attention_mask, do)
        return dq, dk, dv, None


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    attention_mask: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """q/k/v [B, S, H, D], attention_mask [B, S] {0,1} or None →
    [B, S, H, D] in the input dtype, differentiable in q, k and v
    (:class:`FusedAttention`). ``fused_attention.launches`` counts the
    forward kernel's launches."""
    return FusedAttention.apply(q, k, v, attention_mask)


fused_attention.launches = 0
fused_attention.kernel_launches = collections.Counter()  # by kernel name
fused_attention_backward.launches = 0
fused_attention_backward.kernel_launches = collections.Counter()


def _kernel_library() -> ctypes.CDLL:
    from ance_tpu_torch.ops._build import load_library
    return bind(load_library("fused_attention"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the argument types of a ``fused_attention.cu`` library's
    entry points (also a variant's build of it)."""
    # every pointer and the stream as c_void_p: an undeclared argument is
    # passed as a 32-bit int and the pointer is cut
    fwd = lib.fused_attention_launch
    fwd.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 4 + [ctypes.c_longlong] * 3 + [
        ctypes.c_float, ctypes.c_void_p]
    fwd.restype = ctypes.c_int
    bwd = lib.fused_attention_backward_launch
    bwd.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 10 + [
        ctypes.c_int] * 4 + [ctypes.c_longlong] * 6 + [
        ctypes.c_float, ctypes.c_void_p]
    bwd.restype = ctypes.c_int
    return lib
