"""IVF (inverted-file) approximate inner-product index, on one device or
with its clusters sharded over the ranks of a mesh.

Counterpart of ``ance_tpu/index/ivf.py``: cluster the corpus once, then
answer a query by scoring it against the centroids and searching only the
``nprobe`` nearest clusters exhaustively. Every stage is a batched matmul
or a bounded gather, so it runs on the device with ordinary torch ops (the
JAX package computes it in XLA, outside any Pallas kernel):

  * **train**: spherical k-means (Lloyd) on the device. Assignment is one
    [N, nlist] matmul an iteration; the update sums each cluster's rows as
    a one-hot [nlist, rows] × [rows, D] fp32 product, whose order is fixed
    (``index_add_`` on the card sums with atomics in no fixed order, and
    two builds from one seed would then differ).
  * **layout**: clusters packed into a ``[nlist, capacity, D]`` tensor (ids
    ``[nlist, capacity]``, −1-padded). The capacity-constrained assignment
    (a row that overflows a full cluster spills to its next-nearest) runs
    on the host, line for line the JAX package's, so both packages pack the
    same bins; the values are gathered on the device chunk by chunk, so the
    host never holds the packed fp32 bins.
  * **search**: union probe. [Q, nlist] centroid scores → the union of all
    queries' top-``nprobe`` clusters (one set for the batch) → those bins
    stream through [Q, chunk·capacity] fp32 products with a running top-k.

Saved indexes use the JAX package's ``.npz`` layout, so either package
loads the other's files.

On a mesh (:class:`ance_tpu_torch.core.mesh.DataMesh`) every rank builds the
same bins (the build is deterministic, and ranks that disagree raise) and
keeps its contiguous share of the clusters, padded with empty clusters to a
multiple of the ranks; a search probes the top ``ceil(nprobe / ranks)`` of
each rank's own clusters and merges the gathered [Q, k] candidates, as the
JAX package's cluster-sharded search does (``ance_tpu/index/ivf.py:455-493``).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ance_tpu_torch.index.flat import _quantize_int8, merge_topk
from ance_tpu_torch.ops.topk import NEG_INF, topk_lower_id_first

_ASSIGN_CHUNK = 65_536  # rows a dispatch: [chunk, nlist] score material


def _normalize(c: torch.Tensor) -> torch.Tensor:
    return c / c.norm(dim=1, keepdim=True).clamp_min(1e-12)


def _cluster_sums(x: torch.Tensor, assign: torch.Tensor, nlist: int
                  ) -> torch.Tensor:
    """[nlist, D] sums of each cluster's rows: a one-hot product per row
    chunk, added in chunk order, so the result is the same on every run."""
    clusters = torch.arange(nlist, device=x.device)[:, None]
    sums = x.new_zeros((nlist, x.shape[1]))
    for s in range(0, x.shape[0], _ASSIGN_CHUNK):
        one_hot = (assign[None, s:s + _ASSIGN_CHUNK] == clusters).float()
        sums += one_hot @ x[s:s + _ASSIGN_CHUNK]
    return sums


def _kmeans(sample: torch.Tensor, init: torch.Tensor, *, nlist: int,
            iters: int) -> torch.Tensor:
    """Spherical k-means: unit centroids, assignment by inner product.
    Returns centroids [nlist, D] fp32 (unit rows); an empty cluster keeps
    its previous centroid instead of collapsing."""
    x = sample.float()
    c = _normalize(init.float())
    for _ in range(iters):
        assign = torch.cat([torch.argmax(x[s:s + _ASSIGN_CHUNK] @ c.T, dim=1)
                            for s in range(0, x.shape[0], _ASSIGN_CHUNK)])
        sums = _cluster_sums(x, assign, nlist)
        counts = torch.bincount(assign, minlength=nlist).float()[:, None]
        c = _normalize(torch.where(counts > 0,
                                   sums / counts.clamp_min(1.0), c))
    return c


def _pack_bins_from(best: np.ndarray, best_score: np.ndarray,
                    capacity: int, nlist: int, spill_order_fn
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Capacity-constrained assignment: every row goes to its best-scoring
    centroid with space; rows that overflow a full cluster spill to their
    next-nearest.  Returns (bin_ids [nlist, capacity] row indices, −1-padded;
    counts [nlist]).  No row is dropped (total capacity ≥ N is the caller's
    ``slack`` guarantee).

    Only ``best``/``best_score`` [N] are needed up front — O(N·nlist) score
    material is computed lazily by ``spill_order_fn(rows) → [S, nlist]
    preference order`` for the (usually few) overflow rows."""
    # rows grouped by cluster, strongest first within each cluster
    by_cluster = np.lexsort((-best_score, best))
    counts = np.bincount(best, minlength=nlist)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    bins = np.full((nlist, capacity), -1, np.int64)
    spilled = []
    for c in np.nonzero(counts)[0]:
        members = by_cluster[starts[c]:starts[c] + counts[c]]
        keep = members[:capacity]
        bins[c, :len(keep)] = keep
        spilled.extend(members[capacity:])
    counts = np.minimum(counts, capacity)
    if spilled:
        spilled = np.asarray(spilled)
        order = spill_order_fn(spilled)
        for i in np.argsort(-best_score[spilled]):
            for c in order[i]:
                if counts[c] < capacity:
                    bins[c, counts[c]] = spilled[i]
                    counts[c] += 1
                    break
            else:  # pragma: no cover - caller guarantees capacity ≥ N
                raise RuntimeError("total bin capacity exhausted")
    return bins, counts


def _assign_reduce(emb: torch.Tensor, centroids: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    s = emb @ centroids.T
    return torch.argmax(s, dim=1), torch.amax(s, dim=1)


def _argsort_desc(emb: torch.Tensor, centroids: torch.Tensor
                  ) -> torch.Tensor:
    # stable, as jnp.argsort: the spill order decides the bins
    return torch.argsort(-(emb @ centroids.T), dim=1, stable=True)


def _pack_bins(assign_scores: np.ndarray, capacity: int
               ) -> tuple[np.ndarray, np.ndarray]:
    """Small-N convenience wrapper over ``_pack_bins_from`` taking the full
    [N, nlist] score matrix (tests / tiny corpora)."""
    best = np.argmax(assign_scores, axis=1)
    best_score = assign_scores[np.arange(len(best)), best]
    return _pack_bins_from(
        best, best_score, capacity, assign_scores.shape[1],
        lambda rows: np.argsort(assign_scores[rows], axis=1)[:, ::-1])


def _ivf_core(queries: torch.Tensor, centroids: torch.Tensor,
              bins_emb: torch.Tensor, bins_ids: torch.Tensor, *, k: int,
              nprobe: int, union: int, cluster_chunk: int,
              valid_clusters: Optional[int] = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """queries [Q, D] fp32 → (scores [Q, k] fp32, ids [Q, k] int64, −1 pad).
    Clusters from ``valid_clusters`` on (a shard's padding) are never
    selected.

    The whole batch shares one probe set: the union of every query's
    top-``nprobe`` clusters (filled up with the strongest unprobed ones to
    ``union``), streamed ``cluster_chunk`` clusters at a time through a
    [Q, cluster_chunk·capacity] product and a running top-k. Probing saves
    work only while ``union`` (≤ Q·nprobe) < nlist.

    Every selection orders equal scores by the lower index, as
    ``lax.top_k`` does, and scores are fp32 whatever the bins hold: bf16
    and int8 bins are widened before the product, whose operands are then
    exact (a bf16 × bf16 product into a bf16 output would round the scores
    to bf16 and reorder close ones)."""
    Q, nlist = queries.shape[0], bins_ids.shape[0]
    dev = queries.device
    qf = queries.float()
    # bf16 bins see the query at their precision; int8 bins (dim scales
    # folded into the query by the caller) see it in fp32
    qe = qf if bins_emb.dtype == torch.int8 else qf.to(bins_emb.dtype).float()

    cscores = qf @ centroids.float().T                       # [Q, nlist]
    masked = valid_clusters is not None and valid_clusters < nlist
    if masked:
        cscores[:, valid_clusters:] = NEG_INF
    _, probe = topk_lower_id_first(cscores, min(nprobe, nlist))
    # scalars, not tensors made on the host: a host-to-device copy would
    # wait for the device and put the host's enqueue in every search
    probed = torch.zeros(nlist, dtype=torch.float32, device=dev).scatter_(
        0, probe.reshape(-1), 1.0)
    # fp32, as in the JAX package: 1e9 + s rounds to 1e9 for |s| < 32, so
    # every probed cluster ties and the lower index wins a smaller union
    priority = torch.where(probed > 0, 1e9, 0.0) + cscores.amax(dim=0)
    if masked:
        priority[valid_clusters:] = NEG_INF
    _, sel = topk_lower_id_first(priority[None], union)
    sel = sel[0]                                             # [union]

    best_s = torch.full((Q, k), NEG_INF, dtype=torch.float32, device=dev)
    best_i = torch.full((Q, k), -1, dtype=torch.int64, device=dev)
    for s in range(0, union, cluster_chunk):
        sel_c = sel[s:s + cluster_chunk]
        emb = bins_emb[sel_c].reshape(-1, bins_emb.shape[2]).float()
        ids = bins_ids[sel_c].reshape(-1)
        scores = (qe @ emb.T).masked_fill_(ids[None, :] < 0, NEG_INF)
        # [best, chunk]: earlier candidates win ties
        cat_s = torch.cat([best_s, scores], dim=1)
        cat_i = torch.cat([best_i, ids[None, :].expand(Q, -1)], dim=1)
        best_s, pos = topk_lower_id_first(cat_s, k)
        best_i = torch.gather(cat_i, 1, pos)
    return best_s, best_i.masked_fill(best_s <= NEG_INF / 2, -1)


class IVFIPIndex:
    """Approximate inner-product index: k-means clusters + probed search.

    Drop-in for ``FlatIPIndex`` where approximation is acceptable (serving);
    same ``search(queries, k) → (scores, ids)`` contract, −1-padded ids,
    on ``device`` (by default ``mesh``'s, whose ranks then hold a share of
    the clusters each; module docstring).

    ``nlist``: number of clusters (√N when None, set by ``add``).
    ``nprobe``: clusters searched per query — the recall/speed knob.
    ``slack``: total bin capacity as a multiple of N; rows that overflow a
    full cluster spill to their next-nearest centroid, so higher slack
    means fewer displaced rows (better recall at equal nprobe), more
    memory. ``quantize="dims"`` stores bins int8 with per-dimension scales,
    which fold into the query (q′ = q·s) and out of the search centroids
    (c′ = c/s), so scoring is unchanged while the bin gather moves a
    quarter of fp32's bytes.

    After ``add``, ``build_seconds`` splits the build into ``kmeans``,
    ``assign`` (the corpus against the centroids), ``pack`` (the host's
    bin layout and the spilled rows' preference order) and ``upload``
    (the bins' values gathered into place on the device)."""

    _ASSIGN_CHUNK = _ASSIGN_CHUNK

    def __init__(self, dim: int, nlist: Optional[int] = None,
                 nprobe: int = 8, dtype: torch.dtype = torch.bfloat16, *,
                 device=None, mesh=None, quantize=False, slack: float = 1.3,
                 kmeans_iters: int = 10, train_sample: int = 262_144,
                 seed: int = 0):
        self.dim = dim
        self.nlist = nlist
        self.nprobe = nprobe
        self.dtype = dtype
        if device is None:
            if mesh is None:
                raise ValueError("IVFIPIndex needs a device or a mesh")
            device = mesh.device
        self.device = torch.device(device)
        self.mesh = mesh
        self.quantize = "dims" if quantize is True else (quantize or None)
        if self.quantize not in (None, "dims"):
            raise ValueError(f"quantize must be False/'dims' (per-row scales "
                             f"cannot fold into the query), got {quantize!r}")
        self.slack = slack
        self.kmeans_iters = kmeans_iters
        self.train_sample = train_sample
        self.seed = seed
        self.centroids: Optional[torch.Tensor] = None
        self._dim_scales: Optional[torch.Tensor] = None
        self._bins_emb: Optional[torch.Tensor] = None
        self._bins_ids: Optional[torch.Tensor] = None
        self._search_centroids: Optional[torch.Tensor] = None
        self._ntotal = 0
        self._pinned = False  # True after an explicit train() call
        self.build_seconds: dict = {}

    @property
    def ntotal(self) -> int:
        return self._ntotal

    @property
    def capacity(self) -> Optional[int]:
        return None if self._bins_ids is None else self._bins_ids.shape[1]

    def _shard_clusters(self) -> tuple[int, int, int]:
        """(first, end, per_shard): the real clusters [first, end) this
        rank holds, of ``per_shard`` slots a rank."""
        if self.mesh is None:
            return 0, self.nlist, self.nlist
        per = -(-self.nlist // self.mesh.world)
        first = min(self.mesh.rank * per, self.nlist)
        return first, min(first + per, self.nlist), per

    def _rows(self, emb, rows) -> torch.Tensor:
        """fp32 rows of ``emb`` (a host array or a tensor) on the device;
        ``rows`` a slice or an index array."""
        if isinstance(emb, torch.Tensor):
            if not isinstance(rows, slice):
                rows = torch.as_tensor(rows, device=emb.device)
            return emb[rows].to(self.device, torch.float32)
        return torch.as_tensor(np.asarray(emb[rows], np.float32)).to(
            self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train(self, sample) -> None:
        """Fit centroids with spherical k-means on (a subsample of) the
        corpus, and PIN them: subsequent ``add`` calls reuse these centroids
        (for an explicitly shared clustering across rebuilds).  Without an
        explicit ``train``, every ``add`` refits on the data it is given, so
        refreshed embeddings are never clustered by a stale distribution."""
        self._fit(_host_or_tensor(sample))
        self._pinned = True

    def _fit(self, sample) -> None:
        n = len(sample)
        if self.nlist is None:
            self.nlist = max(1, int(round(np.sqrt(n))))
        rows = slice(None)
        if n > self.train_sample:
            rows = np.random.RandomState(self.seed).choice(
                n, self.train_sample, replace=False)
            n = self.train_sample
        if n < self.nlist:
            raise ValueError(f"training sample ({n} rows) smaller "
                             f"than nlist={self.nlist}")
        x = self._rows(sample, rows)
        init = np.random.RandomState(self.seed + 1).choice(
            n, self.nlist, replace=False)
        self.centroids = _kmeans(
            x, x[torch.as_tensor(init, device=self.device)],
            nlist=self.nlist, iters=self.kmeans_iters)

    def add(self, embeddings) -> None:
        """(Re)build the packed bins from the full corpus [N, D] (a host
        array or a tensor on any device).  Refits centroids unless they were
        pinned by an explicit ``train``.  Assignment and packing stream the
        corpus in ``_ASSIGN_CHUNK``-row chunks, so the [N, nlist] scores
        never materialize; the device holds the bins and one chunk."""
        emb = _host_or_tensor(embeddings)
        t0 = time.perf_counter()
        if self.centroids is None or not self._pinned:
            self._fit(emb)
        self._sync()
        t1 = time.perf_counter()
        n, chunk = len(emb), self._ASSIGN_CHUNK
        cap = max(1, int(np.ceil(self.slack * n / self.nlist)))
        best = np.empty(n, np.int64)
        best_score = np.empty(n, np.float32)
        for s in range(0, n, chunk):
            b, sc = _assign_reduce(self._rows(emb, slice(s, s + chunk)),
                                   self.centroids)
            best[s:s + len(b)] = b.cpu().numpy()
            best_score[s:s + len(b)] = sc.cpu().numpy()
        t2 = time.perf_counter()

        def spill_order(rows):
            return np.concatenate([
                _argsort_desc(self._rows(emb, rows[s:s + chunk]),
                              self.centroids).cpu().numpy()
                for s in range(0, len(rows), chunk)], axis=0)

        bins, _ = _pack_bins_from(best, best_score, cap, self.nlist,
                                  spill_order)
        if self.mesh is not None:
            self.mesh.check_replicated(
                {"centroids": self.centroids,
                 "bins": torch.as_tensor(bins, device=self.device)},
                "IVF builds")
        t3 = time.perf_counter()
        if self.quantize == "dims":
            amax = torch.zeros(self.dim, dtype=torch.float32,
                               device=self.device)
            for s in range(0, n, chunk):
                amax = torch.maximum(
                    amax, self._rows(emb, slice(s, s + chunk)).abs().amax(0))
            self._dim_scales = amax.clamp_min(1e-12) / 127.0
            # centroid scoring sees the folded query space: c′·(q·s) = c·q
            centroids = self.centroids / self._dim_scales
            store = torch.int8
        else:
            self._dim_scales = None
            centroids = self.centroids
            store = self.dtype
        # row r goes to slot slot_of[r] of the flattened [nlist·cap] bins;
        # this rank packs the slots of its own clusters only
        first, end, _ = self._shard_clusters()
        slot_of = np.empty(n, np.int64)
        valid = bins >= 0
        slot_of[bins[valid]] = np.flatnonzero(valid)
        slot_of = torch.as_tensor(slot_of - first * cap, device=self.device)
        packed = torch.zeros(((end - first) * cap, self.dim), dtype=store,
                             device=self.device)
        for s in range(0, n, chunk):
            rows = self._rows(emb, slice(s, s + chunk))
            slots = slot_of[s:s + chunk]
            if self.mesh is not None:
                mine = (slots >= 0) & (slots < packed.shape[0])
                rows, slots = rows[mine], slots[mine]
            packed[slots] = (
                _quantize_int8(rows, self._dim_scales[None, :])
                if self.quantize else rows.to(store))
        self._publish(packed.view(end - first, cap, self.dim),
                      torch.as_tensor(bins[first:end], device=self.device),
                      centroids, n)
        self._sync()
        self.build_seconds = {"kmeans": t1 - t0, "assign": t2 - t1,
                              "pack": t3 - t2,
                              "upload": time.perf_counter() - t3}

    def _publish(self, bins_emb: torch.Tensor, bins_ids: torch.Tensor,
                 centroids: torch.Tensor, n: int) -> None:
        """Make this rank's clusters searchable (shared by add() and
        load()): its bins and ids (clusters [first, end) of
        :meth:`_shard_clusters`) padded with empty clusters to the shard
        size, and its rows of the (global) search centroids."""
        first, end, per = self._shard_clusters()
        pad = per - (end - first)
        cap = bins_emb.shape[1]
        self._bins_emb = torch.cat([bins_emb, bins_emb.new_zeros(
            (pad, cap, self.dim))]) if pad else bins_emb
        bins_ids = bins_ids.to(torch.int64)
        self._bins_ids = torch.cat([bins_ids, bins_ids.new_full(
            (pad, cap), -1)]) if pad else bins_ids
        cents = centroids[first:end]
        self._search_centroids = torch.cat([cents, cents.new_zeros(
            (pad, cents.shape[1]))]) if pad else cents
        self._ntotal = n

    def _global_clusters(self, x: torch.Tensor) -> torch.Tensor:
        """The ``nlist`` real clusters of a per-rank tensor (gathered over
        the ranks of a mesh)."""
        if self.mesh is not None:
            x = self.mesh.gather_rows(x)
        return x[:self.nlist]

    def save(self, path: str) -> None:
        """Persist bins + centroids + scales in the JAX package's layout
        (bf16 as a uint16 view with ``dtype_name``; ids int32; unfolded
        centroids; empty ``dim_scales`` when unquantized): a reload skips
        the k-means fit and the packing pass."""
        if self._bins_emb is None:
            raise ValueError("index is empty; nothing to save")
        emb_t = self._global_clusters(self._bins_emb).cpu()
        ids = self._global_clusters(self._bins_ids).cpu().numpy()
        if self.mesh is None or self.mesh.writer:
            if emb_t.dtype == torch.bfloat16:
                dtype_name = "bfloat16"
                bins_emb = emb_t.view(torch.int16).numpy().view(np.uint16)
            else:
                bins_emb = emb_t.numpy()
                dtype_name = bins_emb.dtype.name
            np.savez(path, bins_emb=bins_emb,
                     dtype_name=np.asarray(dtype_name),
                     bins_ids=ids.astype(np.int32),
                     centroids=self.centroids.cpu().numpy(),
                     dim_scales=(self._dim_scales.cpu().numpy()
                                 if self._dim_scales is not None
                                 else np.zeros(0)),
                     ntotal=np.asarray(self._ntotal),
                     nprobe=np.asarray(self.nprobe))
        if self.mesh is not None:
            self.mesh.barrier()  # the file is whole before any rank goes on

    @classmethod
    def load(cls, path: str, *, device=None, mesh=None,
             nprobe: Optional[int] = None) -> "IVFIPIndex":
        """Rebuild a saved IVF index (either package's) on ``device``,
        its clusters sharded over ``mesh`` (any shard count). Centroids
        load pinned (add() after load reuses the clustering)."""
        with np.load(path if str(path).endswith(".npz") else f"{path}.npz",
                     allow_pickle=False) as z:
            bins_emb, bins_ids = z["bins_emb"], z["bins_ids"]
            centroids, scales = z["centroids"], z["dim_scales"]
            ntotal, saved_nprobe = int(z["ntotal"]), int(z["nprobe"])
            bf16 = str(z["dtype_name"]) == "bfloat16"
        if bf16:
            emb_t = torch.from_numpy(bins_emb.view(np.int16)).view(
                torch.bfloat16)
        else:
            emb_t = torch.from_numpy(bins_emb)
        quantize = "dims" if emb_t.dtype == torch.int8 else False
        idx = cls(dim=emb_t.shape[2], nlist=emb_t.shape[0],
                  nprobe=nprobe if nprobe is not None else saved_nprobe,
                  dtype=torch.float32 if quantize else emb_t.dtype,
                  device=device, mesh=mesh, quantize=quantize)
        idx.centroids = torch.as_tensor(centroids, dtype=torch.float32,
                                        device=idx.device)
        idx._pinned = True
        folded = idx.centroids
        if quantize:
            idx._dim_scales = torch.as_tensor(
                np.asarray(scales, np.float32), device=idx.device)
            folded = idx.centroids / idx._dim_scales
        first, end, _ = idx._shard_clusters()
        idx._publish(emb_t[first:end].to(idx.device),
                     torch.as_tensor(bins_ids[first:end].astype(np.int64),
                                     device=idx.device), folded, ntotal)
        return idx

    def reset(self) -> None:
        self._bins_emb = self._bins_ids = None
        self._ntotal = 0

    def _cluster_chunk_for(self, union: int) -> int:
        """Stream width: ~16k score columns a step (the flat index's
        chunk_rows target)."""
        return min(max(1, 16384 // self._bins_ids.shape[1]), union)

    def search(self, queries, k: int, nprobe: Optional[int] = None,
               union: Optional[int] = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """Top-k by inner product over the probed clusters: (scores [Q, k]
        fp32, ids [Q, k] int64) on the index's device. ``union`` (default
        ``min(nlist, Q·nprobe)``, a rank's clusters on a mesh) caps the
        shared probe set. Result slots beyond the probed candidates come
        back as (−inf, −1), the FAISS convention. On a mesh each rank
        probes the top ``ceil(nprobe / ranks)`` of its own clusters, and
        the ranks' [Q, k] candidates merge."""
        if self._bins_emb is None:
            raise ValueError("index is empty; call add() first")
        nprobe = min(nprobe or self.nprobe, self.nlist)
        q = torch.as_tensor(queries).to(self.device, torch.float32)
        if self._dim_scales is not None:  # fold int8 dim scales in
            q = q * self._dim_scales
        if self.mesh is not None:
            first, end, per = self._shard_clusters()
            nprobe = min(-(-nprobe // self.mesh.world), per)
            union = min(per, union or q.shape[0] * nprobe)
            s, i = _ivf_core(q, self._search_centroids, self._bins_emb,
                             self._bins_ids, k=k, nprobe=nprobe, union=union,
                             cluster_chunk=self._cluster_chunk_for(union),
                             valid_clusters=end - first)
            return merge_topk(self.mesh.all_gather(s),
                              self.mesh.all_gather(i), k)
        union = min(union or q.shape[0] * nprobe, self.nlist)
        return _ivf_core(q, self._search_centroids, self._bins_emb,
                         self._bins_ids, k=k, nprobe=nprobe, union=union,
                         cluster_chunk=self._cluster_chunk_for(union))

    def recall_against_exact(self, queries, k: int,
                             exact_ids: np.ndarray) -> float:
        """Fraction of the exact top-k retrieved (diagnostic). −1 padding
        rows (present in both IVF results and short exact rows) are excluded
        from both sets and from the denominator."""
        _, ids = self.search(queries, k)
        ids = ids.cpu().numpy()
        hits = denom = 0
        for i in range(len(ids)):
            exact = set(x for x in exact_ids[i].tolist() if x >= 0)
            got = set(x for x in ids[i].tolist() if x >= 0)
            hits += len(got & exact)
            denom += len(exact)
        return hits / float(denom) if denom else 0.0


def _host_or_tensor(x):
    """A tensor as it is (on any device); anything else as fp32 numpy."""
    return x if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)
