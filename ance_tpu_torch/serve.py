"""Online retrieval: query encoder + device-resident index behind one call.

Counterpart of ``ance_tpu/serve.py``: :class:`Retriever` over a built
index, and :class:`LoopRetriever` over the live index of a running
:class:`ance_tpu_torch.train.pipelined.PipelinedAnce`.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ance_tpu_torch.data.process_fn import encode_padded
from ance_tpu_torch.index.flat import FlatIPIndex


def dedup_first_hit(scores: np.ndarray, rows: np.ndarray,
                    embedding2id: np.ndarray, k: int
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Multi-vector rows → unique passage ids, first (highest-scoring) hit
    per passage, padded with −1 / −inf. ``rows`` is [B, depth] in
    descending score order; −1 rows are empty slots."""
    B, depth = rows.shape
    pids = np.where(rows >= 0, embedding2id[np.maximum(rows, 0)], -1)
    # stable sort by pid: the first of each equal-pid run is the best hit
    order = np.argsort(pids, axis=1, kind="stable")
    sorted_pids = np.take_along_axis(pids, order, axis=1)
    first = np.ones_like(sorted_pids, dtype=bool)
    first[:, 1:] = sorted_pids[:, 1:] != sorted_pids[:, :-1]
    keep_sorted = first & (sorted_pids >= 0)
    keep = np.zeros_like(keep_sorted)
    np.put_along_axis(keep, order, keep_sorted, axis=1)  # back in col order
    rank = np.cumsum(keep, axis=1) - 1
    sel = keep & (rank < k)
    b_idx, _ = np.nonzero(sel)
    out_ids = np.full((B, k), -1, np.int64)
    out_scores = np.full((B, k), -np.inf, np.float32)
    out_ids[b_idx, rank[sel]] = pids[sel]
    out_scores[b_idx, rank[sel]] = scores[sel]
    return out_scores, out_ids


def bucket_pow2(n: int, cap: int) -> int:
    """Next power of two ≥ n, capped: bounds the set of distinct batch
    widths and search depths a client can make the server run."""
    b = 1 << (max(int(n), 1) - 1).bit_length()
    return min(b, cap)


class Retriever:
    """Query texts or tokens → (scores, passage ids).

    ``encode_fn(ids, mask) → [B, D]`` is the query tower
    (:func:`ance_tpu_torch.train.encode.make_encode_fn`); ``embedding2id``
    maps index rows to passage ids (None: the row is the id)."""

    def __init__(self, encode_fn: Callable, index: FlatIPIndex,
                 embedding2id: Optional[np.ndarray] = None,
                 tokenizer=None, max_query_length: int = 64):
        self.encode_fn = encode_fn
        self.index = index
        self.embedding2id = embedding2id
        self.tokenizer = tokenizer
        self.max_query_length = max_query_length

    def tokenize_queries(self, texts: Sequence[str]
                         ) -> tuple[np.ndarray, np.ndarray]:
        """Host-side tokenization (callers run it outside device locks)."""
        if self.tokenizer is None:
            raise ValueError("no tokenizer configured; pass token arrays")
        ids, masks = zip(*(encode_padded(self.tokenizer, t,
                                         self.max_query_length)
                           for t in texts))
        return np.stack(ids), np.stack(masks)

    def embed_queries(self, ids, mask) -> torch.Tensor:
        return self.encode_fn(ids, mask)

    def search_tokens(self, ids, mask, k: int
                      ) -> tuple[np.ndarray, np.ndarray]:
        """Token batch → (scores [B, k], passage ids [B, k]) as numpy.
        The depth is bucketed to a power of two (a deeper exact top-k cut
        to k is the top-k); multi-vector rows dedup to unique pids."""
        return self._to_pids(*self._search_rows(ids, mask, k), k)

    def _search_rows(self, ids, mask, k: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """The device part: encode, then search at the bucketed depth."""
        q = self.embed_queries(ids, mask)
        depth = k if self.embedding2id is None else min(
            self.index.ntotal, 4 * k)  # overfetch for multi-vector dedup
        depth = bucket_pow2(depth, self.index.ntotal)
        return self.index.search(q, depth)

    def _to_pids(self, scores: torch.Tensor, rows: torch.Tensor, k: int
                 ) -> tuple[np.ndarray, np.ndarray]:
        scores, rows = scores.cpu().numpy(), rows.cpu().numpy()
        if self.embedding2id is None:
            return scores[:, :k], rows[:, :k]
        return dedup_first_hit(scores, rows, self.embedding2id, k)

    def search(self, queries: Sequence[str], k: int = 10
               ) -> tuple[np.ndarray, np.ndarray]:
        ids, mask = self.tokenize_queries(queries)
        return self.search_tokens(ids, mask, k)


class LoopRetriever(Retriever):
    """Retriever over a running :class:`~ance_tpu_torch.train.pipelined.
    PipelinedAnce`: train and serve in one program, the index as fresh as
    the loop's last slice write.

    Queries encode with the loop's current snapshot (the frozen weights
    the index's slices are encoded with, the encoder/corpus consistency
    dev eval and mining rely on) and search the live index in place.
    Mid-cycle the index mixes slices of two consecutive snapshots: the
    staleness ANCE training itself accepts (reference README.md:21-24).

    Concurrency: the encode and the search run under ``loop.index_lock``,
    which the loop holds to rebind the index's buffer and scales and to
    swap the snapshot; both run on the device's default stream, so each
    slice write lands wholly before or after each search. The search's
    phase 2 waits for the device, and with it for whatever the loop queued
    before; the results are copied to the host after the lock is released.
    ``index`` and ``params`` follow the loop and cannot be set; searching
    before the loop's first refresh (``bootstrap()``) raises.

    When the loop runs on a mesh, client batches are padded to a multiple
    of its ranks (the first row repeated) and the padding stripped from the
    results, as the JAX retriever pads for its sharded encode. One rank
    only: a search from one rank's server thread would start collectives
    the other ranks never join (the CLI refuses ``--http`` there)."""

    def __init__(self, loop, **kw):
        self._loop = loop
        super().__init__(encode_fn=None, index=None, **kw)

    def search_tokens(self, ids, mask, k: int
                      ) -> tuple[np.ndarray, np.ndarray]:
        mesh = getattr(self._loop, "mesh", None)
        B = ids.shape[0]
        pad = (-B) % mesh.size if mesh is not None else 0
        if pad:
            ids = np.concatenate([ids, np.repeat(ids[:1], pad, 0)])
            mask = np.concatenate([mask, np.repeat(mask[:1], pad, 0)])
        with self._loop.index_lock:
            scores, rows = self._search_rows(ids, mask, k)
        scores, pids = self._to_pids(scores, rows, k)
        return scores[:B], pids[:B]

    @property
    def encode_fn(self) -> Callable:
        return self._loop.qfn

    @encode_fn.setter
    def encode_fn(self, value):
        if value is not None:
            raise AttributeError("LoopRetriever encodes with the loop's "
                                 "snapshot; its encoder cannot be set")

    @property
    def params(self):
        return self._loop.snapshot

    @params.setter
    def params(self, value):
        if value is not None:
            raise AttributeError("LoopRetriever params follow the loop "
                                 "snapshot; they cannot be set")

    @property
    def index(self) -> FlatIPIndex:
        if self._loop.index is None:
            raise RuntimeError("loop index not built yet — bootstrap() "
                               "(or resume past it) before serving")
        return self._loop.index

    @index.setter
    def index(self, value):
        if value is not None:
            raise AttributeError("LoopRetriever serves the loop's live "
                                 "index; it cannot be swapped")
