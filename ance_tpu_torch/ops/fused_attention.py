"""Fused whole-sequence attention forward.

Counterpart of ``ance_tpu/ops/fused_attention.py`` (the forward,
``_fused_kernel`` via ``_fused_forward``). On a CUDA tensor
:func:`fused_attention` launches the hand-written Hopper kernel
``csrc/fused_attention.cu``: a block keeps one query tile's whole fp32
score row in shared memory, so the max and the sum are exact and the
[B, H, S, S] scores never reach device memory; bf16 products run on the
tensor cores. On a CPU tensor it runs the plain version
:func:`fused_attention_reference`, which is the same function:
``xla_attention`` with an fp32 softmax — scale, then add the bias, in
fp32; p rounded to the input dtype before the PV product.

The backward (``_fused_bwd_kernel``) belongs to training and is not here
(ROADMAP Queue 2 #3).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ance_tpu_torch.ops.attention import (KERNEL_DTYPES, kernel_operands,
                                          mask_to_bias, xla_attention)

# the longest sequence whose score rows fit shared memory at 16 query rows
# per block (bf16 needs about 96·S + 21 KB of the 227 KB); ``auto`` sends
# S > 1024 to flash
MAX_SEQ = 2048


def fused_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              attention_mask: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """The plain version: einsum attention with an fp32 softmax."""
    bias = None if attention_mask is None else mask_to_bias(attention_mask)
    return xla_attention(q, k, v, bias, softmax_dtype=torch.float32)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    attention_mask: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """q/k/v [B, S, H, D], attention_mask [B, S] {0,1} or None →
    [B, S, H, D] in the input dtype.

    A CPU tensor takes the plain version. A CUDA tensor launches the kernel
    (``fused_attention.launches`` counts the launches) or raises: it takes
    float32 or bfloat16, D = 64, S ≤ MAX_SEQ, q/k/v sharing one set of
    strides with unit stride along D (bf16: 16-byte-aligned rows)."""
    if q.device.type == "cpu":
        return fused_attention_reference(q, k, v, attention_mask)
    bias, (sb, ss, sh) = kernel_operands(
        q, k, v, attention_mask, name="fused_attention", max_seq=MAX_SEQ,
        align16=q.dtype == torch.bfloat16)
    B, S, H, D = q.shape
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lib = _kernel_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.fused_attention_launch(
            KERNEL_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias.data_ptr(), out.data_ptr(), B, S, H, D, sb, ss, sh,
            1.0 / math.sqrt(D), stream)
    if err != 0:
        raise RuntimeError(f"fused attention kernel launch failed: CUDA "
                           f"error {err} (B={B} S={S} H={H} D={D})")
    fused_attention.launches += 1
    return out


fused_attention.launches = 0


def _kernel_library() -> ctypes.CDLL:
    from ance_tpu_torch.ops._build import load_library
    lib = load_library("fused_attention")
    fn = lib.fused_attention_launch
    # every pointer and the stream as c_void_p: an undeclared argument is
    # passed as a 32-bit int and the pointer is cut
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 4 + [ctypes.c_longlong] * 3 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
