"""Exact (brute-force) inner-product top-k index on one device.

Counterpart of ``ance_tpu/index/flat.py``. Corpus embeddings live in device
memory, [N, D]. Search goes through the block-max top-k
(:mod:`ance_tpu_torch.ops.topk`, the hand-written kernel on the card) or
the streaming scan :func:`topk_inner_product`, which is also the oracle the
kernel path is held against. Saved indexes use the JAX package's ``.npz``
layout, so either package loads the other's files.

Sharding the corpus over several devices waits for ROADMAP Queue 1 #11.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ance_tpu_torch.ops.topk import (NEG_INF, rescore, topk_blockmax,
                                     topk_lower_id_first)


def topk_inner_product(queries: torch.Tensor, corpus: torch.Tensor, *,
                       k: int, chunk_rows: int = 16384,
                       valid_rows: Optional[int] = None,
                       row_scales: Optional[torch.Tensor] = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k by inner product, scanning the corpus in row chunks with
    a running top-k merge (the [Q, N] score matrix never materializes).
    Scores are exact (fp64, rounded to fp32) and ties go to the lower id,
    as in the block-max path, so the two agree id for id.
    Returns (scores [Q, k] fp32, ids [Q, k] int64; −1 where fewer than k
    rows are valid). With ``row_scales`` [N] the corpus holds per-row
    quantized values and each score is multiplied by its row's scale."""
    Q, N = queries.shape[0], corpus.shape[0]
    if valid_rows is None:
        valid_rows = N
    chunk_rows = max(1, min(chunk_rows, N))
    best_s = torch.full((Q, k), NEG_INF, dtype=torch.float32,
                        device=corpus.device)
    best_i = torch.full((Q, k), -1, dtype=torch.int64, device=corpus.device)
    for start in range(0, N, chunk_rows):
        chunk = corpus[start:start + chunk_rows]
        s = rescore(queries, chunk)
        if row_scales is not None:
            s = s * row_scales[start:start + chunk_rows][None, :]
        ids = torch.arange(start, start + chunk.shape[0],
                           device=corpus.device)
        s.masked_fill_((ids >= valid_rows)[None, :], NEG_INF)
        # columns stay in ascending id order (the running best holds only
        # earlier rows), so ties resolve to the lower id as in lax.top_k
        cat_s = torch.cat([best_s, s], dim=1)
        cat_i = torch.cat([best_i, ids[None, :].expand(Q, -1)], dim=1)
        best_s, pos = topk_lower_id_first(cat_s, k)
        best_i = torch.gather(cat_i, 1, pos)
    # a NEG_INF entry is a masked row or an empty slot; JAX reports both −1
    return best_s, best_i.masked_fill(best_s <= NEG_INF, -1)


def _quantize_int8(x: torch.Tensor, scales_bcast: torch.Tensor
                   ) -> torch.Tensor:
    """The one int8 convention (symmetric, round half to even, clamp ±127)
    that every way of filling an index shares."""
    return torch.round(x / scales_bcast).clamp(-127, 127).to(torch.int8)


def quantize_rows_int8(emb: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8: (values int8 [N, D], scales fp32 [N])."""
    emb = emb.to(torch.float32)
    scales = emb.abs().amax(1).clamp_min(1e-12) / 127.0
    return _quantize_int8(emb, scales[:, None]), scales


def quantize_dims_int8(emb: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-dimension symmetric int8: (values int8 [N, D], scales fp32 [D]).
    The scales fold into the query, so every search path applies."""
    emb = emb.to(torch.float32)
    scales = emb.abs().amax(0).clamp_min(1e-12) / 127.0
    return _quantize_int8(emb, scales[None, :]), scales


def merge_topk(scores: torch.Tensor, ids: torch.Tensor, k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge candidate sets: [..., S, Q, k] → final [Q, k]; equal scores
    keep the earlier candidate (lower shard, then lower rank), as
    ``lax.top_k`` does."""
    s = scores.movedim(-3, -2).reshape(scores.shape[-2], -1)
    i = ids.movedim(-3, -2).reshape(ids.shape[-2], -1)
    top_s, pos = topk_lower_id_first(s, k)
    return top_s, torch.gather(i, 1, pos)


class FlatIPIndex:
    """Exact inner-product index over embeddings resident on ``device``.

    ``method``: ``blockmax`` (block-max top-k; the CUDA kernel on the
    card, its plain version on the CPU), ``scan`` (streaming merge) or
    ``auto`` (blockmax, except scan for ``quantize="rows"``, whose
    per-row scales cannot fold into the query).
    ``quantize``: int8 storage — ``"rows"``/True per-row scales (scan
    only), ``"dims"`` per-dimension scales folded into the query."""

    def __init__(self, dim: int, *, device, dtype: torch.dtype = torch.float32,
                 chunk_rows: int = 16384, method: str = "auto",
                 quantize=False):
        self.dim = dim
        self.device = torch.device(device)
        self.dtype = dtype
        self.chunk_rows = chunk_rows
        self.method = method
        self.quantize = "rows" if quantize is True else (quantize or None)
        if self.quantize not in (None, "rows", "dims"):
            raise ValueError(f"quantize must be False/'rows'/'dims', got "
                             f"{quantize!r}")
        if method not in ("auto", "blockmax", "scan"):
            raise ValueError(f"method must be auto/blockmax/scan, got "
                             f"{method!r}")
        self._emb: Optional[torch.Tensor] = None
        self._scales: Optional[torch.Tensor] = None
        self._ntotal = 0
        self._slice_rows: Optional[int] = None

    def _use_blockmax(self) -> bool:
        if self.quantize == "rows":
            return False
        return self.method in ("auto", "blockmax")

    @property
    def ntotal(self) -> int:
        return self._ntotal

    def _to_device_f32(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device, torch.float32)
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def add(self, embeddings) -> None:
        """(Re)build the index contents from [N, D] embeddings."""
        emb = self._to_device_f32(embeddings)
        if self.quantize == "rows":
            emb, scales = quantize_rows_int8(emb)
        elif self.quantize == "dims":
            emb, scales = quantize_dims_int8(emb)
        else:
            emb, scales = emb.to(self.dtype), None
        self._emb, self._scales = emb, scales
        self._ntotal = emb.shape[0]
        self._slice_rows = None  # add() layouts are not slice-aligned

    def add_chunked(self, emb, slice_rows: int = 65_536) -> None:
        """Build from a host array (or a device tensor) slice by slice,
        without staging the whole fp32 corpus on the device: allocate() and
        streamed update_slice() writes. Identical to add(); for
        ``quantize="dims"`` the scales come from an exact per-dim max pass."""
        if self.quantize == "rows":
            raise ValueError("add_chunked supports unquantized or "
                             "quantize='dims' indexes")
        n, dim = emb.shape
        slice_rows = min(slice_rows, n)
        scales = None
        if self.quantize == "dims":
            amax = torch.zeros(dim, dtype=torch.float32, device=self.device)
            for s in range(0, n, slice_rows):
                amax = torch.maximum(
                    amax, self._to_device_f32(emb[s:s + slice_rows]).abs()
                    .amax(0))
            scales = amax.clamp_min(1e-12) / 127.0
        self.allocate(n, dim, slice_rows=slice_rows, scales=scales)
        for s in range(0, n, slice_rows):
            self.update_slice(s, emb[s:s + slice_rows])

    def save(self, path: str) -> None:
        """Write the JAX package's ``.npz`` layout: values at their storage
        dtype (bf16 as a uint16 view), scales, quantize mode and row count;
        padding rows are stripped."""
        if self._emb is None:
            raise ValueError("index is empty; nothing to save")
        emb_t = self._emb[:self._ntotal].cpu()
        if emb_t.dtype == torch.bfloat16:
            dtype_name = "bfloat16"
            emb = emb_t.view(torch.int16).numpy().view(np.uint16)
        else:
            emb = emb_t.numpy()
            dtype_name = emb.dtype.name
        scales = (self._scales.cpu().numpy() if self._scales is not None
                  else np.zeros(0))
        if self.quantize == "rows":
            scales = scales[:self._ntotal]
        np.savez(path, emb=emb, dtype_name=np.asarray(dtype_name),
                 scales=scales, quantize=np.asarray(self.quantize or ""),
                 ntotal=np.asarray(self._ntotal))

    @classmethod
    def load(cls, path: str, *, device, method: str = "auto"
             ) -> "FlatIPIndex":
        """Rebuild a saved index (either package's) on ``device``."""
        with np.load(path if str(path).endswith(".npz") else f"{path}.npz",
                     allow_pickle=False) as z:
            emb, scales = z["emb"], z["scales"]
            quantize = str(z["quantize"]) or False
            ntotal = int(z["ntotal"])
            bf16 = str(z["dtype_name"]) == "bfloat16"
        if bf16:
            emb_t = torch.from_numpy(emb.view(np.int16)).view(torch.bfloat16)
        else:
            emb_t = torch.from_numpy(emb)
        dtype = emb_t.dtype if emb_t.dtype != torch.int8 else torch.float32
        idx = cls(dim=emb.shape[1], device=device, dtype=dtype,
                  method=method, quantize=quantize)
        idx._emb = emb_t.to(idx.device)
        idx._ntotal = ntotal
        if quantize:
            idx._scales = torch.as_tensor(np.asarray(scales, np.float32),
                                          device=idx.device)
        return idx

    def reset(self) -> None:
        self._emb, self._scales, self._ntotal = None, None, 0
        self._slice_rows = None

    # -- in-place slice refresh ------------------------------------------
    def allocate(self, ntotal: int, dim: int, slice_rows: int,
                 scales=None) -> None:
        """Allocate a zeroed device buffer of ``ntotal`` rows, padded to a
        whole number of ``slice_rows`` slices, for update_slice() writes;
        padding rows never surface. ``quantize="dims"`` buffers are int8
        and need the corpus-global per-dim ``scales`` [dim] up front."""
        if self.quantize == "rows":
            raise ValueError("update_slice supports quantize='dims' only "
                             "(per-row scales can't fold into the query, and "
                             "the scan path reads them corpus-global)")
        if self.quantize == "dims":
            if scales is None:
                raise ValueError("quantize='dims' allocate() needs per-dim "
                                 "scales [dim] (corpus-global)")
            scales = self._to_device_f32(scales).reshape(dim)
        elif scales is not None:
            raise ValueError("scales only apply to a quantize='dims' index")
        padded = -(-ntotal // slice_rows) * slice_rows
        self.dim = dim
        self._slice_rows = slice_rows
        self._emb = torch.zeros(
            (padded, dim), device=self.device,
            dtype=torch.int8 if self.quantize == "dims" else self.dtype)
        self._scales = scales
        self._ntotal = ntotal

    def set_scales(self, scales) -> None:
        """Replace the per-dim scales of a quantize='dims' index."""
        if self.quantize != "dims":
            raise ValueError("set_scales applies to quantize='dims' only")
        self._scales = self._to_device_f32(scales).reshape(self.dim)

    def update_slice(self, start: int, emb) -> None:
        """Overwrite rows [start, start + slice_rows) in place (``copy_``
        into the buffer); a short slice's remaining rows are zeroed.
        ``start`` must be ``slice_rows``-aligned."""
        if self._slice_rows is None:
            raise ValueError("call allocate() before update_slice()")
        sr = self._slice_rows
        if start % sr:
            raise ValueError(f"start {start} not aligned to slice_rows {sr}")
        if not 0 <= start < self._emb.shape[0]:
            raise ValueError(f"start {start} outside buffer rows "
                             f"[0, {self._emb.shape[0]})")
        sl = self._to_device_f32(emb)
        n = sl.shape[0]
        if n > sr:
            raise ValueError(f"slice has {n} rows > {sr}")
        if self.quantize == "dims":
            sl = _quantize_int8(sl, self._scales[None, :])
        self._emb[start:start + n].copy_(sl)
        self._emb[start + n:start + sr].zero_()

    def search(self, queries, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Top-k inner-product search. Returns (scores [Q, k] fp32, ids
        [Q, k] int64) on the index's device; ids are −1 only when k exceeds
        ntotal.

        Queries are cast to the index dtype first (fp32 for int8 indexes)
        and the rescore reads those cast queries, as in the JAX package;
        per-dim scales fold into the query."""
        if self._emb is None:
            raise ValueError("index is empty; call add() first")
        q = torch.as_tensor(queries).to(
            self.device, torch.float32 if self.quantize else self.dtype)
        row_scales = None
        if self.quantize == "dims":
            q = q * self._scales
        elif self.quantize == "rows":
            row_scales = self._scales
        if self._use_blockmax():
            return topk_blockmax(q, self._emb, k=k, valid_rows=self._ntotal)
        return topk_inner_product(
            q, self._emb, k=k,
            chunk_rows=min(self.chunk_rows, self._emb.shape[0]),
            valid_rows=self._ntotal, row_scales=row_scales)
