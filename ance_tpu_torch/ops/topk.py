"""Exact top-k inner product through block maxima.

Counterpart of ``ance_tpu/ops/topk.py``, in three phases:

  phase 1 (kernel) — :func:`blockmax_scores`: [Q, D] × [N, D] → the maximum
      score of every ``block_size`` consecutive corpus rows, [Q, N/BS]. On
      a CUDA tensor this launches the hand-written Hopper kernel
      (``csrc/blockmax.cu``); on a CPU tensor it is the plain version
      :func:`blockmax_scores_reference`.
  phase 2 — :func:`top_blocks_lower_id_first` picks the k candidate blocks
      with the largest maxima, equal maxima lower block first.
  phase 3 — gather the candidate rows per query, rescore them exactly,
      final top-k (in query tiles, to bound memory).

Exact, not approximate: if an entry of the true top-k sat in a block
outside the top-k blocks by max, k blocks would each hold an entry scoring
above it — a contradiction.

That argument holds for exact block maxima. Phase 1 sums in fp32 in the
kernel's own order, so two blocks whose maxima lie within that rounding of
each other can trade places. Two choices keep the result equal, id for id,
to the scan (``index.flat.topk_inner_product``) on the card, where the
kernel, cuBLAS and the CPU each sum in their own order:

* both rescore in fp64 (fp32 products are exact there) and round to fp32,
  so the same row gets the same fp32 score on either path, and both break
  equal scores towards the lower row id, as ``lax.top_k`` does. This
  gathers twice the bytes of an fp32 rescore (PERF.md);
* phase 2 keeps one block beyond k, which absorbs one such swap at the
  k-th block. Two or more blocks within rounding of the k-th block maximum
  could still drop a true hit: equality with the scan is observed (every
  check in ``chip_smoke.py``), not guaranteed. Selecting every block within
  the phase-1 error bound of the k-th maximum would guarantee it (ROADMAP).

``block_size=16``, ``chunk_rows=1024`` and ``q_tile=64`` are the JAX
package's defaults, tuned on a TPU; re-choosing them on the H100 is open
(PERF.md).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

NEG_INF = torch.finfo(torch.float32).min

_TYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# (query dtype, corpus dtype) pairs phase 1 computes; an int8 corpus under a
# float query is widened to the query dtype
_PAIRS = {(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
          (torch.float32, torch.int8), (torch.bfloat16, torch.int8),
          (torch.int8, torch.int8)}
_KERNEL_TILE_ROWS = 128  # corpus rows per kernel block (csrc/blockmax.cu)


def _out_dtype(queries: torch.Tensor, corpus: torch.Tensor) -> torch.dtype:
    both_int8 = queries.dtype == torch.int8 and corpus.dtype == torch.int8
    return torch.int32 if both_int8 else torch.float32


def blockmax_scores_reference(queries: torch.Tensor, corpus: torch.Tensor,
                              *, block_size: int = 16) -> torch.Tensor:
    """The plain version: ``(q @ c.T).reshape(Q, N/BS, BS).amax(-1)`` with
    the kernel's dtype rules (fp32 accumulation for float operands, exact
    int32 for int8 × int8)."""
    Q, D = queries.shape
    N = corpus.shape[0]
    if _out_dtype(queries, corpus) == torch.int32:
        # |sum| ≤ 127²·D: below 2^24 every partial sum is exact in fp32
        # (CUDA has no int32 matmul); beyond it fall back to fp64
        acc = torch.float32 if 127 * 127 * D < 2 ** 24 else torch.float64
        s = (queries.to(acc) @ corpus.to(acc).T).to(torch.int32)
    else:
        c = corpus.to(queries.dtype) if corpus.dtype == torch.int8 \
            else corpus
        s = queries.to(torch.float32) @ c.to(torch.float32).T
    return s.reshape(Q, N // block_size, block_size).amax(-1)


def blockmax_scores(queries: torch.Tensor, corpus: torch.Tensor, *,
                    block_size: int = 16,
                    chunk_rows: int = 1024) -> torch.Tensor:
    """[Q, D] × [N, D] → per-block score maxima [Q, N/block_size]: int32
    when both operands are int8, fp32 otherwise.

    N must be a multiple of ``chunk_rows`` and ``chunk_rows`` of
    ``block_size`` (pad upstream; the caller masks padded blocks). A CUDA
    tensor always launches the kernel (``blockmax_scores.launches`` counts
    the launches) or raises; a CPU tensor takes the plain version. On the
    card, bf16 and int8 queries (the tensor-core kernel) also need
    D % 8 == 0 and 16-byte-aligned operands."""
    if queries.dim() != 2 or corpus.dim() != 2 or \
            queries.shape[1] != corpus.shape[1]:
        raise ValueError(f"need queries [Q, D] and corpus [N, D], got "
                         f"{tuple(queries.shape)} and {tuple(corpus.shape)}")
    if (queries.dtype, corpus.dtype) not in _PAIRS:
        raise TypeError(f"unsupported dtype pair ({queries.dtype}, "
                        f"{corpus.dtype}); phase 1 takes "
                        f"{sorted(map(str, _PAIRS))}")
    if queries.device != corpus.device:
        raise ValueError(f"queries on {queries.device}, corpus on "
                         f"{corpus.device}")
    N = corpus.shape[0]
    if N % chunk_rows or chunk_rows % block_size:
        raise ValueError(f"N={N} must be a multiple of chunk_rows="
                         f"{chunk_rows}, and chunk_rows of block_size="
                         f"{block_size}")
    if queries.device.type == "cpu":
        return blockmax_scores_reference(queries, corpus,
                                         block_size=block_size)
    if queries.device.type != "cuda":
        raise ValueError(f"blockmax_scores runs on cuda or cpu, not "
                         f"{queries.device}")
    if _KERNEL_TILE_ROWS % block_size:
        raise ValueError(f"block_size={block_size} must divide the kernel's "
                         f"{_KERNEL_TILE_ROWS}-row tile")
    if not (queries.is_contiguous() and corpus.is_contiguous()):
        raise ValueError("blockmax_scores needs contiguous operands")
    if queries.dtype != torch.float32 and (
            queries.shape[1] % 8 or queries.data_ptr() % 16
            or corpus.data_ptr() % 16):
        # the tensor-core kernel loads 8-element chunks
        raise ValueError(f"{queries.dtype} queries need D % 8 == 0 (got "
                         f"D={queries.shape[1]}) and 16-byte-aligned operands")
    lib = _kernel_library()
    Q, D = queries.shape
    out = torch.empty((Q, N // block_size),
                      dtype=_out_dtype(queries, corpus), device=queries.device)
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream(queries.device).cuda_stream
        err = lib.blockmax_scores_launch(
            _TYPE_CODES[queries.dtype], _TYPE_CODES[corpus.dtype],
            queries.data_ptr(), corpus.data_ptr(), out.data_ptr(),
            Q, N, D, block_size, stream)
    if err != 0:
        raise RuntimeError(f"blockmax kernel launch failed: CUDA error {err}")
    blockmax_scores.launches += 1
    return out


blockmax_scores.launches = 0


def _kernel_library() -> ctypes.CDLL:
    from ance_tpu_torch.ops._build import load_library
    lib = load_library("blockmax")
    fn = lib.blockmax_scores_launch
    # every pointer and the stream as c_void_p: an undeclared argument is
    # passed as a 32-bit int and the pointer is cut
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _pad_rows(x: torch.Tensor, multiple: int) -> torch.Tensor:
    pad = -x.shape[0] % multiple
    if not pad:
        return x
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])


def topk_lower_id_first(scores: torch.Tensor, k: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along dim 1, equal scores ordered by column (lower first) —
    ``lax.top_k``'s order; ``torch.topk`` leaves ties unordered on CUDA.
    Callers keep columns in ascending row-id order."""
    pos = torch.sort(scores, dim=1, descending=True, stable=True).indices
    pos = pos[:, :k]
    return torch.gather(scores, 1, pos), pos


def top_blocks_lower_id_first(bm: torch.Tensor, k: int) -> torch.Tensor:
    """Phase 2: the k largest block maxima per row, equal maxima taken
    lower block index first (``lax.top_k``'s order), returned as block ids
    in ascending order [Q, k].

    Without sorting the [Q, N/BS] row: ``torch.topk`` gives the k-th value
    t (its tie order is irrelevant), every block above t is kept, and the
    lowest-index blocks equal to t fill the remaining places. Under MaxP
    every all-padding chunk encodes to the same row, so blocks tie at the
    k-th maximum by the thousand."""
    kth = torch.topk(bm, k, dim=1).values[:, -1:]                 # [Q, 1]
    above = bm > kth
    tied = bm == kth
    room = k - above.sum(1, keepdim=True, dtype=torch.int32)
    take = above | (tied & (torch.cumsum(tied, 1, dtype=torch.int32)
                            <= room))
    # exactly k per row; nonzero lists them row by row, columns ascending
    return take.nonzero()[:, 1].reshape(bm.shape[0], k)


def rescore(queries: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Exact inner products in fp64, rounded once to fp32: queries [..., D]
    × rows [..., C, D] → [..., C] (or [Q, D] × [N, D] → [Q, N])."""
    q = queries.to(torch.float64)
    if rows.dim() == 2:
        return (q @ rows.to(torch.float64).T).to(torch.float32)
    return torch.matmul(rows.to(torch.float64), q[..., None])[..., 0].to(
        torch.float32)


def topk_blockmax(queries: torch.Tensor, corpus: torch.Tensor, *, k: int,
                  block_size: int = 16, chunk_rows: int = 1024,
                  q_tile: int = 64, phase1_dtype: Optional[torch.dtype] = None,
                  valid_rows: Optional[int] = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k inner product via the block-max bound. Returns (scores
    [Q, k] fp32, ids [Q, k] int64); corpus rows ≥ ``valid_rows`` are
    padding and never surface, and ids are −1 where the score is NEG_INF.

    ``phase1_dtype`` (int8 corpora only) sets the query dtype of phase 1:
    None keeps the queries' own dtype, ``torch.bfloat16`` casts them, and
    ``torch.int8`` quantizes each query row symmetrically (a positive
    per-row scale never reorders that query's blocks). Phase 3 always
    rescores from the queries as given, exactly (fp64, rounded to fp32)."""
    Q, D = queries.shape
    N = corpus.shape[0]
    if valid_rows is None:
        valid_rows = N
    # the corpus is padded to whole chunks; the queries need no padding
    # (phase 1 masks the ragged query tile, phase 3 takes a short last tile)
    corpus_p = _pad_rows(corpus, chunk_rows)
    padded_n = corpus_p.shape[0]

    if corpus.dtype == torch.int8:
        if phase1_dtype == torch.int8:
            qmax = queries.abs().amax(1, keepdim=True).clamp_min(1e-12)
            qf = torch.round(queries * (127.0 / qmax)).clamp(
                -127, 127).to(torch.int8)
        elif phase1_dtype is not None:
            qf = queries.to(phase1_dtype)
        else:
            qf = queries
    else:
        qf = queries.to(corpus.dtype)
    bm = blockmax_scores(qf.contiguous(), corpus_p.contiguous(),
                         block_size=block_size, chunk_rows=chunk_rows)
    n_blocks = padded_n // block_size
    block_ids = torch.arange(n_blocks, device=bm.device)
    neg = torch.iinfo(torch.int32).min if bm.dtype == torch.int32 \
        else NEG_INF
    bm.masked_fill_((block_ids * block_size >= valid_rows)[None, :], neg)

    k_blocks = min(k + 1, n_blocks)  # one spare block (module docstring)
    top_blocks = top_blocks_lower_id_first(bm, k_blocks)  # rows ascending
    del bm

    offsets = torch.arange(block_size, device=corpus.device)
    k_out = min(k, k_blocks * block_size)
    scores = torch.full((Q, k), NEG_INF, dtype=torch.float32,
                        device=corpus.device)
    ids = torch.full((Q, k), -1, dtype=torch.int64, device=corpus.device)
    for t in range(0, Q, q_tile):
        rows = (top_blocks[t:t + q_tile, :, None] * block_size
                + offsets).reshape(-1, k_blocks * block_size)  # [T, kb·BS]
        s = rescore(queries[t:t + q_tile], corpus_p[rows])    # [T, kb·BS]
        s.masked_fill_(rows >= valid_rows, NEG_INF)
        top_s, pos = topk_lower_id_first(s, k_out)
        scores[t:t + q_tile, :k_out] = top_s
        ids[t:t + q_tile, :k_out] = torch.gather(rows, 1, pos)
    ids = ids.masked_fill(scores <= NEG_INF, -1)
    return scores, ids
