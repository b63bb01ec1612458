"""Exact (brute-force) inner-product top-k index, on one device or sharded
by rows over the ranks of a mesh.

Counterpart of ``ance_tpu/index/flat.py``. Corpus embeddings live in device
memory, [N, D] (a rank's block of them on a mesh). Search goes through the
block-max top-k (:mod:`ance_tpu_torch.ops.topk`, the hand-written kernel on
the card) or
the streaming scan :func:`topk_inner_product`, which is also the oracle the
kernel path is held against. Saved indexes use the JAX package's ``.npz``
layout, so either package loads the other's files.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ance_tpu_torch.ops.topk import (NEG_INF, rescore, topk_blockmax,
                                     topk_lower_id_first)
from ance_tpu_torch.utils.observability import span


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
    only), ``"dims"`` per-dimension scales folded into the query.

    ``mesh`` (a :class:`ance_tpu_torch.core.mesh.DataMesh`; its device is
    the default ``device``) shards the rows over the ranks, as the JAX
    package shards them over its mesh: every rank passes the same global
    rows to ``add`` / ``allocate`` / ``update_slice`` and keeps its own
    contiguous block of ``rows_per_shard`` rows (the rows padded to a
    multiple of the ranks; padding never surfaces). ``search`` runs the
    one-device top-k on each shard, gathers the [Q, k] candidates and
    merges them, so every rank returns the same answer. Every method that
    reads or writes rows is then collective: all ranks call it."""

    def __init__(self, dim: int, *, device=None, mesh=None,
                 dtype: torch.dtype = torch.float32, chunk_rows: int = 16384,
                 method: str = "auto", quantize=False):
        if device is None:
            if mesh is None:
                raise ValueError("FlatIPIndex needs a device or a mesh")
            device = mesh.device
        self.dim = dim
        self.device = torch.device(device)
        self.mesh = mesh
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
        self._emb: Optional[torch.Tensor] = None  # this rank's rows
        self._scales: Optional[torch.Tensor] = None
        self._ntotal = 0
        self._rows_per_shard = 0
        self._slice_rows: Optional[int] = None

    def _use_blockmax(self) -> bool:
        if self.quantize == "rows":
            return False
        return self.method in ("auto", "blockmax")

    @property
    def ntotal(self) -> int:
        return self._ntotal

    @property
    def rows_per_shard(self) -> int:
        return self._rows_per_shard

    def _n_shards(self) -> int:
        return self.mesh.world if self.mesh is not None else 1

    def _base(self) -> int:
        """Global id of this rank's first row."""
        return self.mesh.rank * self._rows_per_shard if self.mesh else 0

    def _to_device_f32(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device, torch.float32)
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def _keep_shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the global rows ``x``, padded with zero
        rows to a multiple of the shard count (all of ``x`` on one
        device); sets ``rows_per_shard``."""
        if self.mesh is None:
            self._rows_per_shard = x.shape[0]
            return x
        per = -(-x.shape[0] // self.mesh.world)
        self._rows_per_shard = per
        own = x[self.mesh.rank * per:(self.mesh.rank + 1) * per]
        pad = x.new_zeros((per - own.shape[0],) + tuple(x.shape[1:]))
        return torch.cat([own, pad])  # its own memory: x can go

    def add(self, embeddings) -> None:
        """(Re)build the index contents from [N, D] embeddings (the global
        rows, on every rank of a mesh)."""
        emb = self._to_device_f32(embeddings)
        if self.quantize == "rows":
            emb, scales = quantize_rows_int8(emb)
        elif self.quantize == "dims":
            emb, scales = quantize_dims_int8(emb)
        else:
            emb, scales = emb.to(self.dtype), None
        self._ntotal = emb.shape[0]
        if self.quantize == "rows":
            scales = self._keep_shard(scales)
        self._emb, self._scales = self._keep_shard(emb), scales
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

    def _global_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The first ``ntotal`` global rows of a sharded ``x`` (gathered
        over the ranks of a mesh)."""
        if self.mesh is not None:
            x = self.mesh.gather_rows(x)
        return x[:self._ntotal]

    def save(self, path: str) -> None:
        """Write the JAX package's ``.npz`` layout: values at their storage
        dtype (bf16 as a uint16 view), scales, quantize mode and row count;
        padding rows are stripped, so any shard count loads it. On a mesh
        the rows are gathered and global rank 0 writes."""
        if self._emb is None:
            raise ValueError("index is empty; nothing to save")
        emb_t = self._global_rows(self._emb).cpu()
        scales = np.zeros(0)
        if self.quantize == "rows":
            scales = self._global_rows(self._scales).cpu().numpy()
        elif self._scales is not None:
            scales = self._scales.cpu().numpy()
        if self.mesh is None or self.mesh.writer:
            if emb_t.dtype == torch.bfloat16:
                dtype_name = "bfloat16"
                emb = emb_t.view(torch.int16).numpy().view(np.uint16)
            else:
                emb = emb_t.numpy()
                dtype_name = emb.dtype.name
            np.savez(path, emb=emb, dtype_name=np.asarray(dtype_name),
                     scales=scales, quantize=np.asarray(self.quantize or ""),
                     ntotal=np.asarray(self._ntotal))
        if self.mesh is not None:
            self.mesh.barrier()  # the file is whole before any rank goes on

    @classmethod
    def load(cls, path: str, *, device=None, mesh=None,
             method: str = "auto") -> "FlatIPIndex":
        """Rebuild a saved index (either package's) on ``device``, sharded
        over ``mesh`` (any shard count: padding is recut)."""
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
        idx = cls(dim=emb.shape[1], device=device, mesh=mesh, dtype=dtype,
                  method=method, quantize=quantize)
        idx._emb = idx._keep_shard(emb_t).to(idx.device)
        idx._ntotal = ntotal
        if quantize:
            s = torch.as_tensor(np.asarray(scales, np.float32))
            if quantize == "rows":
                s = idx._keep_shard(s)
            idx._scales = s.to(idx.device)
        return idx

    def reset(self) -> None:
        self._emb, self._scales, self._ntotal = None, None, 0
        self._rows_per_shard = 0
        self._slice_rows = None

    # -- in-place slice refresh ------------------------------------------
    def allocate(self, ntotal: int, dim: int, slice_rows: int,
                 scales=None) -> None:
        """Allocate a zeroed device buffer for ``ntotal`` rows, for
        update_slice() writes; padding rows never surface. On a mesh each
        shard holds a whole number of ``slice_rows`` slices, so every
        aligned slice lies inside one shard. ``quantize="dims"`` buffers
        are int8 and need the corpus-global per-dim ``scales`` [dim] up
        front."""
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
        shards = self._n_shards()
        per = -(-ntotal // (shards * slice_rows)) * slice_rows
        self.dim = dim
        self._slice_rows = slice_rows
        self._rows_per_shard = per
        self._emb = torch.zeros(
            (per, dim), device=self.device,
            dtype=torch.int8 if self.quantize == "dims" else self.dtype)
        self._scales = scales
        self._ntotal = ntotal

    def set_scales(self, scales) -> None:
        """Replace the per-dim scales of a quantize='dims' index (the same
        on every rank)."""
        if self.quantize != "dims":
            raise ValueError("set_scales applies to quantize='dims' only")
        self._scales = self._to_device_f32(scales).reshape(self.dim)

    def update_slice(self, start: int, emb) -> None:
        """Overwrite global rows [start, start + slice_rows) in place
        (``copy_`` into the buffer); a short slice's remaining rows are
        zeroed. ``start`` must be ``slice_rows``-aligned; on a mesh only
        the rank that owns the slice writes."""
        if self._slice_rows is None:
            raise ValueError("call allocate() before update_slice()")
        sr = self._slice_rows
        if start % sr:
            raise ValueError(f"start {start} not aligned to slice_rows {sr}")
        padded = self._rows_per_shard * self._n_shards()
        if not 0 <= start < padded:
            # no shard owns it: fail loudly rather than drop the write
            raise ValueError(f"start {start} outside buffer rows "
                             f"[0, {padded})")
        n = emb.shape[0]
        if n > sr:
            raise ValueError(f"slice has {n} rows > {sr}")
        owner = start // self._rows_per_shard
        if self.mesh is not None and owner != self.mesh.rank:
            return
        start -= owner * self._rows_per_shard
        sl = self._to_device_f32(emb)
        if self.quantize == "dims":
            sl = _quantize_int8(sl, self._scales[None, :])
        self._emb[start:start + n].copy_(sl)
        self._emb[start + n:start + sr].zero_()

    def _search_shard(self, queries, k: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """The one-device top-k over this rank's rows (all rows without a
        mesh); ids global. Rows past the shard's own share of ``ntotal``
        are masked, or the padding inside a shard that is not the last
        would surface as hits."""
        q = torch.as_tensor(queries).to(
            self.device, torch.float32 if self.quantize else self.dtype)
        row_scales = None
        if self.quantize == "dims":
            q = q * self._scales
        elif self.quantize == "rows":
            row_scales = self._scales
        base = self._base()
        valid = min(max(self._ntotal - base, 0), self._rows_per_shard)
        if self._use_blockmax():
            s, i = topk_blockmax(q, self._emb, k=k, valid_rows=valid)
        else:
            s, i = topk_inner_product(
                q, self._emb, k=k,
                chunk_rows=min(self.chunk_rows, self._emb.shape[0]),
                valid_rows=valid, row_scales=row_scales)
        if base:
            i = torch.where(i >= 0, i + base, i)
        return s, i

    def search(self, queries, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Top-k inner-product search. Returns (scores [Q, k] fp32, ids
        [Q, k] int64) on the index's device; ids are −1 only when k exceeds
        ntotal.

        Queries are cast to the index dtype first (fp32 for int8 indexes)
        and the rescore reads those cast queries, as in the JAX package;
        per-dim scales fold into the query. On a mesh each rank's [Q, k]
        are gathered and merged, equal scores lower id first. The whole
        call is the span ``index.search``."""
        if self._emb is None:
            raise ValueError("index is empty; call add() first")
        with span("index.search", self.device):
            s, i = self._search_shard(queries, k)
            if self.mesh is None:
                return s, i
            return merge_topk(self.mesh.all_gather(s),
                              self.mesh.all_gather(i), k)
