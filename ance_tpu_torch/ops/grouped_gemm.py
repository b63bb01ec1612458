"""The routed experts' products, grouped by expert, and their combine.

Replaces no TPU kernel: the JAX package has no mixture of experts. Added
for DeepSeek-V2's MoE layers (``ops/moe.py``), where one batch of the
corpus encode sends ~1,800 real tokens to each of 64 experts a layer: a
loop of per-expert cuBLAS calls would make 3 × 64 launches a layer, each
on a small, uneven group. Here each projection is one launch over every
expert's rows, which are the (token, expert) pairs sorted by expert:

* :func:`grouped_swiglu`: ``h = silu(x W_gate[e]ᵀ) ⊙ (x W_up[e]ᵀ)`` for
  each pair, its rows of x gathered through the pair's token index, the
  gate and up products in one launch and the SwiGLU formed from their fp32
  sums before the one rounding to bf16;
* :func:`grouped_down`: ``y = p · (h W_down[e]ᵀ)``, scaled by the pair's
  gate weight ``p`` in fp32 before the rounding;
* :func:`combine`: ``out = base + shared + Σ_j y[pos[t, j]]`` in fp32 for
  each token (the residual, the shared experts' output and its routed
  pairs); a pad token takes ``base + shared`` and nothing routed.

The two grouped products are kernel #7 of ``csrc/grouped_gemm.cu``
(wgmma + TMA, its file comment has the design): persistent blocks walk
(row-tile slot, column tile) pairs whose slots cover the largest number of
128-row tiles any routing can need (every pair real, each expert's last
tile partial), so the launch does not depend on the routing and nothing is
read back to the host: a tile finds its expert and rows from the
per-expert offsets on the device (:func:`schedule`), and a block stops at
the first slot past the last tile. An expert with no rows has no tiles.
They take bf16 operands on the card (fp32 accumulation); a CUDA tensor of
another dtype is refused.

The combine is a gather-sum, memory-bound, in Triton: imported and built
at its first launch, its compile cache in ``ance_tpu_torch/build/triton``
(git-ignored) unless ``TRITON_CACHE_DIR`` says otherwise.

Each wrapper runs its plain PyTorch version for CPU tensors (bf16 or fp32:
the CPU tests, ``generate`` on the host) and the kernel for CUDA tensors,
and counts its launches (``.launches``).
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch
import torch.nn.functional as F

BLOCK_M = 128  # rows a tile: csrc/grouped_gemm.cu's kRows
COMBINE_BN = 1024
CPU_DTYPES = (torch.bfloat16, torch.float32)


def schedule(counts: torch.Tensor, pairs: int, block_m: int = BLOCK_M
             ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """(pair offsets [E+1] int32, tile offsets [E+1] int32, row-tile slots)
    for ``counts`` [E] rows an expert out of ``pairs`` in all: expert e's
    rows are [pair_off[e], pair_off[e+1]) of the sorted pairs, its tiles
    [tile_off[e], tile_off[e+1]). The slots, ceil(pairs / block_m) + E,
    bound Σ ceil(count_e / block_m) for any counts summing to ≤ pairs."""
    E = counts.numel()
    zero = counts.new_zeros(1)
    pair_off = torch.cat([zero, counts.cumsum(0)]).to(torch.int32)
    tiles = (counts + block_m - 1) // block_m
    tile_off = torch.cat([zero, tiles.cumsum(0)]).to(torch.int32)
    return pair_off, tile_off, -(-pairs // block_m) + E


# row-tile slots a launch takes (8.4 M pairs, far past a batch's): the
# kernel's tile index, slot × column tiles, stays an int
MAX_SLOTS = 65535


def _check(name: str, *tensors: torch.Tensor, slots: int = 0) -> None:
    if slots > MAX_SLOTS:
        raise ValueError(f"{name}: {slots} row tiles exceed the kernel's "
                         f"{MAX_SLOTS}; encode fewer tokens a call")
    dev, dt = tensors[0].device, tensors[0].dtype
    if dev.type == "cuda" and dt != torch.bfloat16:
        raise TypeError(f"{name}: the kernel takes bfloat16 only, got {dt}")
    if dt not in CPU_DTYPES:
        raise TypeError(f"{name}: takes bfloat16 or float32, got {dt}")
    for t in tensors:
        if t.device != dev or t.dtype != dt:
            raise ValueError(f"{name}: operands on one device in one dtype, "
                             f"got {t.device} {t.dtype} and {dev} {dt}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


@functools.lru_cache(maxsize=None)
def _combine_kernel():
    from ance_tpu_torch.ops._build import BUILD_DIR
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def combine_kernel(base_ptr, shared_ptr, y_ptr, pos_ptr, real_ptr,
                       out_ptr, N, TOPK: tl.constexpr, BN: tl.constexpr):
        t = tl.program_id(0).to(tl.int64)
        offs = tl.program_id(1) * BN + tl.arange(0, BN)
        ok = offs < N
        acc = tl.load(base_ptr + t * N + offs, mask=ok, other=0.0) \
            .to(tl.float32)
        acc += tl.load(shared_ptr + t * N + offs, mask=ok, other=0.0) \
            .to(tl.float32)
        if tl.load(real_ptr + t) != 0:
            for j in tl.static_range(TOPK):
                p = tl.load(pos_ptr + t * TOPK + j).to(tl.int64)
                acc += tl.load(y_ptr + p * N + offs, mask=ok, other=0.0) \
                    .to(tl.float32)
        tl.store(out_ptr + t * N + offs, acc, mask=ok)

    return triton, combine_kernel


def _library() -> ctypes.CDLL:
    from ance_tpu_torch.ops._build import load_library
    return bind(load_library("grouped_gemm"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the argument types of a ``grouped_gemm.cu`` library's entry
    points: every pointer and the stream as c_void_p (an undeclared
    argument is passed as a 32-bit int and the pointer is cut)."""
    fn = lib.grouped_swiglu_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.grouped_down_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _card(name: str, operands: tuple, N: int, K: int) -> None:
    """What kernel #7 takes beyond :func:`_check`: N and K multiples of 8
    (TMA's 16-byte row strides), 16-byte-aligned bases."""
    if N % 8 or K % 8:
        raise ValueError(f"{name}: the kernel takes widths that are "
                         f"multiples of 8, got N={N} K={K}")
    if any(t.data_ptr() % 16 for t in operands):
        raise ValueError(f"{name}: operands need 16-byte-aligned bases "
                         "(the kernel's TMA boxes and 16-byte copies)")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launched(name: str, err: int, shape: tuple) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"(P, E, N, K = {shape})")


def swiglu_reference(x: torch.Tensor, rows: torch.Tensor,
                     w_gate: torch.Tensor, w_up: torch.Tensor,
                     pair_off: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`grouped_swiglu` on x's device: a loop
    over the experts, each a gather and two fp32 ``F.linear`` of the
    operands as given (exact products of bf16 ones; TF32 is off), the
    SwiGLU formed in fp32 and rounded once, where the kernel rounds; rows
    past pair_off[E] are zeros. Reads the offsets back to the host."""
    h = x.new_zeros(rows.numel(), w_gate.shape[1])
    off = pair_off.tolist()
    for e in range(w_gate.shape[0]):
        if off[e] == off[e + 1]:
            continue
        xe = x[rows[off[e]:off[e + 1]].long()].float()
        g = F.linear(xe, w_gate[e].float())
        u = F.linear(xe, w_up[e].float())
        h[off[e]:off[e + 1]] = (F.silu(g) * u).to(x.dtype)
    return h


def down_reference(h: torch.Tensor, w_down: torch.Tensor, p: torch.Tensor,
                   pair_off: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`grouped_down` on h's device, as
    :func:`swiglu_reference`."""
    y = h.new_zeros(h.shape[0], w_down.shape[1])
    off = pair_off.tolist()
    for e in range(w_down.shape[0]):
        a, b = off[e], off[e + 1]
        if a == b:
            continue
        out = F.linear(h[a:b].float(), w_down[e].float())
        y[a:b] = (out * p[a:b, None]).to(h.dtype)
    return y


def combine_reference(base: torch.Tensor, shared: torch.Tensor,
                      y: torch.Tensor, pos: torch.Tensor,
                      real: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`combine` on base's device."""
    routed = y[pos.long()].float().sum(1) * real[:, None]
    return base + shared.float() + routed


def grouped_swiglu(x: torch.Tensor, rows: torch.Tensor, w_gate: torch.Tensor,
                   w_up: torch.Tensor, pair_off: torch.Tensor,
                   tile_off: torch.Tensor, slots: int) -> torch.Tensor:
    """[P, I] in x's dtype: row r (a sorted pair of expert e, r in
    [pair_off[e], pair_off[e+1])) is ``silu(x[rows[r]] W_gate[e]ᵀ) ⊙
    (x[rows[r]] W_up[e]ᵀ)``. x [T, H]; rows [P] int32; W [E, I, H]. Rows
    past pair_off[E] are left unwritten (zeros on the CPU)."""
    _check("grouped_swiglu", x, w_gate, w_up, slots=slots)
    P, (E, I, H) = rows.numel(), w_gate.shape
    grouped_swiglu.launches += 1
    if x.device.type == "cpu":
        return swiglu_reference(x, rows, w_gate, w_up, pair_off)
    _card("grouped_swiglu", (x, rows, w_gate, w_up), I, H)
    h = torch.empty(P, I, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _library().grouped_swiglu_launch(
            x.data_ptr(), rows.data_ptr(), w_gate.data_ptr(),
            w_up.data_ptr(), h.data_ptr(), pair_off.data_ptr(),
            tile_off.data_ptr(), P, E, I, H, slots, _stream(x.device))
    _launched("grouped_swiglu", err, (P, E, I, H))
    return h


def grouped_down(h: torch.Tensor, w_down: torch.Tensor, p: torch.Tensor,
                 pair_off: torch.Tensor, tile_off: torch.Tensor,
                 slots: int) -> torch.Tensor:
    """[P, H] in h's dtype: row r of expert e is ``p[r] · (h[r]
    W_down[e]ᵀ)``, the fp32 sums scaled before the rounding. h [P, I];
    W_down [E, H, I]; p [P] fp32. Rows past pair_off[E] are left
    unwritten (zeros on the CPU)."""
    _check("grouped_down", h, w_down, slots=slots)
    P, (E, H, I) = h.shape[0], w_down.shape
    grouped_down.launches += 1
    if h.device.type == "cpu":
        return down_reference(h, w_down, p, pair_off)
    _card("grouped_down", (h, w_down), H, I)
    y = torch.empty(P, H, dtype=h.dtype, device=h.device)
    with torch.cuda.device(h.device):
        err = _library().grouped_down_launch(
            h.data_ptr(), w_down.data_ptr(), p.data_ptr(), y.data_ptr(),
            pair_off.data_ptr(), tile_off.data_ptr(), P, E, H, I, slots,
            _stream(h.device))
    _launched("grouped_down", err, (P, E, H, I))
    return y


def combine(base: torch.Tensor, shared: torch.Tensor, y: torch.Tensor,
            pos: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    """[T, H] fp32: ``base + shared + Σ_j y[pos[t, j]]`` for a real token
    t, ``base + shared`` for a pad. base [T, H] fp32; shared [T, H] and y
    [P, H] in the compute dtype; pos [T, k] int32; real [T] bool."""
    T, H = base.shape
    combine.launches += 1
    if base.device.type == "cpu":
        return combine_reference(base, shared, y, pos, real)
    triton, kernel = _combine_kernel()
    out = torch.empty_like(base)
    grid = (T, triton.cdiv(H, COMBINE_BN))
    kernel[grid](base.contiguous(), shared.contiguous(), y, pos.contiguous(),
                 real.to(torch.int32), out, H, TOPK=pos.shape[1],
                 BN=COMBINE_BN, num_warps=4)
    return out


grouped_swiglu.launches = 0
grouped_down.launches = 0
combine.launches = 0
