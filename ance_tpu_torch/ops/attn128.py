"""Seq-128 attention in the projection layout, and the fused attention
sub-block: the two kernels of the seq-128 experiment
(``docs/perf_attn128_r3.py``, ported as
:mod:`ance_tpu_torch.experiments.perf_attn128`).

  * :func:`fused128` (``_kernel128`` via ``fused128``): q, k, v and the
    output are [B, S, H], H = heads × 64, each head a 64-column slice,
    so the projections' layout is read as it is (no [B, S, heads, 64]
    transposes); fp32 scores, ``s·scale + bias``, an exact softmax, p
    rounded to the input dtype, PV accumulated in fp32.
  * :func:`fused_block` (``_block_kernel`` via ``fused_block``): the whole
    attention sub-block, q/k/v = bf16(x·W) (fp32 accumulation, no
    biases), :func:`fused128`'s attention with each head's context in
    bf16, then bf16(ctx·wo).

On a CUDA tensor each launches its hand-written Hopper kernel of
``csrc/attn128.cu`` (``fused128.launches`` counts one a call,
``fused_block.launches`` two: the block is a projection-and-attention
kernel and an output-projection kernel) or raises; there is no fallback.
:func:`fused128`'s kernel is persistent (one block an SM walking the
(batch row, head) pairs), loads each head's q, k and v as TMA boxes
through a ring, so the next heads' loads overlap this one's products, and
runs both products on wgmma with the whole 128-key score row in
registers. :func:`fused_block`'s two kernels run their projections as
wgmma products fed by a TMA ring, a block owning two batch rows: the
first projects x onto one head's q, k and v (three warpgroups, one a
weight), keeps them in shared memory in bf16 and runs :func:`fused128`'s
attention on them, so only the context reaches device memory; the second
is the output projection (it needs every head of a row, which one block's
head does not have: summing heads across blocks would take atomics and
change the result from run to run).
The kernels take bf16, B ≥ 0, 1 ≤ S ≤ 128 (the TPU kernel was S = 128
only) and H a multiple of 64, shapes read from the tensors. On a CPU
tensor each runs its plain version, :func:`fused128_reference` or
:func:`fused_block_reference`, which round where the kernels round.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ance_tpu_torch.ops.attention import NEG_INF

MAX_SEQ = 128
HEAD_DIM = 64


def _heads(x: torch.Tensor) -> int:
    if x.dim() != 3 or x.shape[-1] % HEAD_DIM:
        raise ValueError(f"need [B, S, heads x {HEAD_DIM}], got "
                         f"{tuple(x.shape)}")
    return x.shape[-1] // HEAD_DIM


def _bias(attention_mask: Optional[torch.Tensor], B: int, S: int,
          device) -> torch.Tensor:
    """[B, S] {0,1} mask (or None: every key) → fp32 [B, S] additive bias,
    0 keep, NEG_INF drop, contiguous."""
    if attention_mask is None:
        return torch.zeros((B, S), dtype=torch.float32, device=device)
    if tuple(attention_mask.shape) != (B, S):
        raise ValueError(f"attention mask {tuple(attention_mask.shape)} is "
                         f"not [B, S] = {(B, S)}")
    return ((1.0 - attention_mask.to(device, torch.float32))
            * NEG_INF).contiguous()


def fused128_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       attention_mask: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """The plain version of :func:`fused128`: products of input-dtype
    operands in fp32 (exact for bf16 × bf16), scale then bias in fp32, the
    softmax in fp32, p and the context rounded to the input dtype."""
    B, S, H = q.shape
    heads, f32 = _heads(q), torch.float32
    split = lambda t: t.to(f32).reshape(B, S, heads, HEAD_DIM)  # noqa: E731
    scale = torch.tensor(1.0 / math.sqrt(HEAD_DIM), dtype=f32)
    s = torch.einsum("bqhd,bkhd->bhqk", split(q), split(k)) * scale
    s = s + _bias(attention_mask, B, S, q.device)[:, None, None, :]
    p = torch.softmax(s, dim=-1).to(q.dtype).to(f32)
    ctx = torch.einsum("bhqk,bkhd->bqhd", p, split(v))
    return ctx.to(q.dtype).reshape(B, S, H)


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., H] · w [H, H'] with fp32 products and sums, rounded to x's
    dtype."""
    return (x.to(torch.float32) @ w.to(torch.float32)).to(x.dtype)


def fused_block_reference(x: torch.Tensor, wq: torch.Tensor,
                          wk: torch.Tensor, wv: torch.Tensor,
                          wo: torch.Tensor,
                          attention_mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """The plain version of :func:`fused_block`: q, k, v and the output
    projection each rounded to x's dtype from fp32 sums, the attention as
    :func:`fused128_reference`."""
    q, k, v = (_project(x, w) for w in (wq, wk, wv))
    return _project(fused128_reference(q, k, v, attention_mask), wo)


def _check(name: str, operands: dict) -> None:
    """What the kernels take, or a raise before any launch: ``operands``
    maps each name to (tensor, the shape it must have); the first is
    [B, S, H]. The device is checked last, so that a CPU tensor meets every
    other check."""
    for key, (t, shape) in operands.items():
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the kernel takes bfloat16 only, got "
                            f"{key} {t.dtype} (the experiment runs bf16; "
                            "the plain version takes fp32 on the CPU)")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} is {tuple(t.shape)}, not "
                             f"{shape}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be contiguous with a "
                             "16-byte-aligned base (the kernels' TMA "
                             "boxes)")
    S = next(iter(operands.values()))[1][1]
    if not 1 <= S <= MAX_SEQ:
        raise ValueError(f"{name}: sequence length {S} outside [1, "
                         f"{MAX_SEQ}]")
    device = next(iter(operands.values()))[0].device
    for key, (t, _) in operands.items():
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(f"{name}: the kernel runs on one CUDA device, "
                             f"got {key} on {t.device}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def fused128(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q, k, v [B, S, H] (projection layout), attention_mask [B, S] {0,1}
    or None → the attention context [B, S, H] in the input dtype."""
    if q.device.type == "cpu":
        return fused128_reference(q, k, v, attention_mask)
    _heads(q)
    B, S, H = q.shape
    _check("fused128", {"q": (q, (B, S, H)), "k": (k, (B, S, H)),
                        "v": (v, (B, S, H))})
    bias = _bias(attention_mask, B, S, q.device)
    out = torch.empty_like(q)
    lib = _kernel_library()
    with torch.cuda.device(q.device):
        err = lib.attn128_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 bias.data_ptr(), out.data_ptr(), B, S, H,
                                 1.0 / math.sqrt(HEAD_DIM), _stream(q.device))
    if err != 0:
        raise RuntimeError(f"attn128 kernel launch failed: CUDA error {err} "
                           f"(B={B} S={S} H={H})")
    fused128.launches += 1
    return out


def fused_block(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                wv: torch.Tensor, wo: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """x [B, S, H], four [H, H] weights (x·W), attention_mask [B, S] or
    None → the attention sub-block's output [B, S, H] in x's dtype."""
    if x.device.type == "cpu":
        return fused_block_reference(x, wq, wk, wv, wo, attention_mask)
    _heads(x)
    B, S, H = x.shape
    _check("fused_block", {"x": (x, (B, S, H)), "wq": (wq, (H, H)),
                           "wk": (wk, (H, H)), "wv": (wv, (H, H)),
                           "wo": (wo, (H, H))})
    bias = _bias(attention_mask, B, S, x.device)
    ctx, out = torch.empty_like(x), torch.empty_like(x)
    lib = _kernel_library()
    with torch.cuda.device(x.device):
        err = lib.attn_block_launch(
            x.data_ptr(), wq.data_ptr(), wk.data_ptr(), wv.data_ptr(),
            wo.data_ptr(), bias.data_ptr(), ctx.data_ptr(), out.data_ptr(),
            B, S, H, 1.0 / math.sqrt(HEAD_DIM), _stream(x.device))
    if err != 0:
        raise RuntimeError(f"attn_block kernels' launch failed: CUDA error "
                           f"{err} (B={B} S={S} H={H})")
    fused_block.launches += LAUNCHES_PER_CALL["fused_block"]
    return out


# kernel launches a call makes (what each ``.launches`` counts)
LAUNCHES_PER_CALL = {"fused128": 1, "fused_block": 2}
fused128.launches = 0
fused_block.launches = 0


def _kernel_library() -> ctypes.CDLL:
    from ance_tpu_torch.ops._build import load_library
    return bind(load_library("attn128"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the argument types of an ``attn128.cu`` library's entry
    points (also a variant's build of it)."""
    # every pointer and the stream as c_void_p: an undeclared argument is
    # passed as a 32-bit int and the pointer is cut
    fn = lib.attn128_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.attn_block_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
