"""Approximate inner-product index on the host: HNSW + the IP→L2 transform.

Counterpart of ``ance_tpu/index/hnsw.py``. Parity target: the reference's
``DenseHNSWFlatIndexer`` (utils/dpr_utils.py:164-228), a FAISS
IndexHNSWFlat wrapped with the max-norm auxiliary-dimension trick that
turns maximum-inner-product search into L2 nearest-neighbour search:

    doc'   = [doc,  sqrt(phi − ‖doc‖²)]   with phi = max ‖doc‖²
    query' = [query, 0]
    ‖query' − doc'‖² = ‖query‖² + phi − 2·(query·doc)   (monotone in −IP)

The graph is the port's own copy of the from-scratch C++ HNSW
(``ance_tpu_torch/native/hnsw.cpp``), built by g++ at first use
(:mod:`ance_tpu_torch.utils.native_build`; a failed build raises). Its
distance sums in another order than the JAX package's, so close distances
can pick other neighbours: the two packages agree on the wrapper's
arithmetic exactly and on the graph by recall. HNSW is a library here, as
in the reference: no CLI path reaches it; the exact ``FlatIPIndex`` and
the device-side ``IVFIPIndex`` serve.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np

from ance_tpu_torch.utils.native_build import load_native


class HnswIndex:
    """L2 HNSW over float32 vectors (thin ctypes wrapper)."""

    def __init__(self, dim: int, m: int = 32, ef_construction: int = 200,
                 seed: int = 0, lib: Optional[ctypes.CDLL] = None):
        """``lib``: a build of another version of ``native/hnsw.cpp`` to
        run (the experiment's distance A/B); default the package's."""
        self._lib = lib or load_native("hnsw")
        self._lib.hnsw_create.restype = ctypes.c_void_p
        self._lib.hnsw_create.argtypes = [ctypes.c_int, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_uint]
        self._lib.hnsw_free.argtypes = [ctypes.c_void_p]
        self._lib.hnsw_set_ef.argtypes = [ctypes.c_void_p, ctypes.c_int]
        self._lib.hnsw_size.argtypes = [ctypes.c_void_p]
        self._lib.hnsw_size.restype = ctypes.c_int
        self._lib.hnsw_add_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int]
        self._lib.hnsw_search.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_float)]
        self.dim = dim
        self._h = self._lib.hnsw_create(dim, m, ef_construction, seed)

    def __del__(self):
        try:
            self._lib.hnsw_free(self._h)
        except Exception:
            pass

    @property
    def ntotal(self) -> int:
        return self._lib.hnsw_size(self._h)

    def set_ef(self, ef: int) -> None:
        self._lib.hnsw_set_ef(self._h, ef)

    def _rows(self, x) -> np.ndarray:
        """C-contiguous fp32 [n, dim], checked before C reads it."""
        x = np.ascontiguousarray(x, np.float32)
        if x.ndim != 2 or x.shape[1] != self.dim:
            raise ValueError(f"expected [n, {self.dim}] vectors, got "
                             f"{x.shape}")
        return x

    def add(self, vecs: np.ndarray) -> None:
        vecs = self._rows(vecs)
        self._lib.hnsw_add_batch(
            self._h, vecs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            vecs.shape[0])

    def search(self, queries: np.ndarray, k: int
               ) -> tuple[np.ndarray, np.ndarray]:
        """Returns (l2_distances [Q,k], ids [Q,k]); −1 id = unfilled."""
        queries = self._rows(queries)
        nq = queries.shape[0]
        ids = np.empty((nq, k), np.int64)
        dists = np.empty((nq, k), np.float32)
        self._lib.hnsw_search(
            self._h, queries.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            nq, k, ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            dists.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return dists, ids


class DenseHnswIndexer:
    """IP-search HNSW with the reference's aux-dim conversion and external-id
    mapping (reference dpr_utils.py:164-228 semantics: one-shot indexing,
    efSearch knob, (db_ids, scores) result pairs)."""

    def __init__(self, vector_sz: int, store_n: int = 512,
                 ef_search: int = 128, ef_construction: int = 200,
                 seed: int = 0):
        # store_n mirrors the reference's IndexHNSWFlat second arg (links/node)
        self.index = HnswIndex(vector_sz + 1, m=max(4, store_n // 16),
                               ef_construction=ef_construction, seed=seed)
        self.index.set_ef(ef_search)
        self.index_id_to_db_id: list = []
        self.phi: float = 0.0

    def index_data(self, ids: Sequence, vectors: np.ndarray) -> None:
        if self.phi > 0:
            raise RuntimeError(
                "DPR HNSWF index needs to index all data at once, "
                "results will be unpredictable otherwise.")
        vectors = np.asarray(vectors, np.float32)
        norms = (vectors ** 2).sum(axis=1)
        self.phi = float(norms.max())
        aux = np.sqrt(np.maximum(self.phi - norms, 0.0))[:, None]
        hnsw_vectors = np.hstack([vectors, aux]).astype(np.float32)
        self.index_id_to_db_id.extend(ids)
        self.index.add(hnsw_vectors)

    def search_knn(self, query_vectors: np.ndarray, top_docs: int
                   ) -> list[tuple[list, list]]:
        q = np.asarray(query_vectors, np.float32)
        aux = np.zeros((q.shape[0], 1), np.float32)
        dists, idxs = self.index.search(np.hstack([q, aux]), top_docs)
        out = []
        for row_ids, row_d in zip(idxs, dists):
            db_ids = [self.index_id_to_db_id[i] for i in row_ids if i >= 0]
            out.append((db_ids, list(row_d[:len(db_ids)])))
        return out
