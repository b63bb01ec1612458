"""Torch port of the HNSW indexer (``ance_tpu_torch/index/hnsw.py`` on the
port's own ``native/hnsw.cpp``): tests/test_hnsw.py's three cases on the
port's copy; the wrapper's arithmetic (phi, the aux column, the id
mapping) equal to ``ance_tpu.index.hnsw.DenseHnswIndexer``'s; recall on the
same data no lower than the JAX build's less 0.02 (the two cores sum
distances in other orders, so their graphs may differ); and a core whose
semantics carry no reassociation licence."""

import re
from pathlib import Path

import numpy as np
import pytest

from ance_tpu.index import hnsw as jax_hnsw
from ance_tpu_torch.index import hnsw
from ance_tpu_torch.index.hnsw import DenseHnswIndexer, HnswIndex

PORT_SOURCE = Path(hnsw.__file__).resolve().parent.parent / "native" / \
    "hnsw.cpp"


def test_hnsw_l2_recall():
    rs = np.random.RandomState(0)
    base = rs.randn(3000, 24).astype(np.float32)
    queries = rs.randn(40, 24).astype(np.float32)
    index = HnswIndex(dim=24, m=16, ef_construction=100, seed=1)
    index.add(base)
    assert index.ntotal == 3000
    index.set_ef(128)
    k = 10
    _, ids = index.search(queries, k)
    d2 = ((queries[:, None, :] - base[None, :, :]) ** 2).sum(-1)
    exact = np.argsort(d2, axis=1)[:, :k]
    recall = np.mean([len(set(ids[i]) & set(exact[i])) / k
                      for i in range(len(queries))])
    assert recall >= 0.9, recall


def test_hnsw_returns_sorted_distances():
    rs = np.random.RandomState(1)
    base = rs.randn(500, 8).astype(np.float32)
    index = HnswIndex(dim=8, m=8, ef_construction=64)
    index.add(base)
    dists, ids = index.search(base[:5], 7)
    assert (np.diff(dists, axis=1) >= 0).all()
    for bad in (base[:, :7], base[0]):  # checked before the C core reads
        with pytest.raises(ValueError, match="expected"):
            index.search(bad, 7)
        with pytest.raises(ValueError, match="expected"):
            index.add(bad)
    np.testing.assert_array_equal(ids[:, 0], np.arange(5))
    # the distance is the squared L2 of fp32 inputs within fp32 rounding
    want = ((base[ids] - base[:5, None, :]) ** 2).sum(-1)
    np.testing.assert_allclose(dists, want, rtol=1e-5, atol=1e-5)


def test_dense_hnsw_indexer_ip_search():
    """IP→L2 conversion: top result by inner product, not by L2."""
    rs = np.random.RandomState(2)
    vecs = rs.randn(2000, 16).astype(np.float32)
    vecs[:50] *= 3.0
    db_ids = [f"doc{i}" for i in range(len(vecs))]
    indexer = DenseHnswIndexer(vector_sz=16, ef_search=256,
                               ef_construction=200)
    indexer.index_data(db_ids, vecs)
    queries = rs.randn(20, 16).astype(np.float32)
    results = indexer.search_knn(queries, top_docs=10)
    exact = np.argsort(-(queries @ vecs.T), axis=1)[:, :10]
    hits = 0
    for qi, (got_ids, _) in enumerate(results):
        want = {f"doc{j}" for j in exact[qi]}
        hits += len(set(got_ids) & want)
    assert hits / (20 * 10) >= 0.85

    with pytest.raises(RuntimeError):
        indexer.index_data(db_ids, vecs)  # one-shot indexing enforced


class _Recorder:
    """Stand-in graph: records what the wrapper adds and answers searches
    with fixed rows (−1 for an unfilled slot)."""

    def __init__(self, dim, **kw):
        self.dim, self.added, self.searched = dim, [], []

    def set_ef(self, ef):
        self.ef = ef

    def add(self, vecs):
        self.added.append(np.array(vecs))

    def search(self, queries, k):
        self.searched.append(np.array(queries))
        ids = np.tile(np.arange(k, dtype=np.int64)[::-1], (len(queries), 1))
        ids[:, -2:] = -1
        dists = np.tile(np.linspace(0.5, 2.0, k, dtype=np.float32),
                        (len(queries), 1))
        return dists, ids


def test_wrapper_arithmetic_equals_jax(monkeypatch):
    """phi, the aux column, the query's zero column, the links per node
    and the id mapping: bit for bit the JAX wrapper's."""
    made = {}

    def recorder(pkg):
        def make(dim, m, ef_construction, seed):
            made[pkg] = (dim, m, ef_construction, seed)
            return _Recorder(dim)
        return make

    monkeypatch.setattr(hnsw, "HnswIndex", recorder("port"))
    monkeypatch.setattr(jax_hnsw, "HnswIndex", recorder("jax"))
    rs = np.random.RandomState(3)
    vecs = rs.randn(300, 12).astype(np.float32) * rs.rand(300, 1) * 4
    db_ids = [f"p{i}" for i in range(300)]
    queries = rs.randn(7, 12).astype(np.float32)
    out = {}
    for name, mod in (("port", hnsw), ("jax", jax_hnsw)):
        ix = mod.DenseHnswIndexer(vector_sz=12, store_n=256, ef_search=64,
                                  ef_construction=80, seed=5)
        ix.index_data(db_ids, vecs)
        out[name] = (ix, ix.search_knn(queries, top_docs=6))
    (p, p_res), (j, j_res) = out["port"], out["jax"]
    assert made["port"] == made["jax"] == (13, 16, 80, 5)
    assert p.phi == j.phi
    np.testing.assert_array_equal(p.index.added[0], j.index.added[0])
    assert p.index.added[0].dtype == np.float32
    np.testing.assert_array_equal(p.index.searched[0], j.index.searched[0])
    assert (p.index.searched[0][:, -1] == 0).all()
    assert p.index_id_to_db_id == j.index_id_to_db_id
    assert p_res == j_res and all(len(ids) == 4 for ids, _ in p_res)


def test_recall_no_lower_than_jax_build():
    """The same data through both packages' builds (one seed): the port's
    recall@10 by inner product is at least the JAX build's less 0.02."""
    rs = np.random.RandomState(4)
    vecs = rs.randn(3000, 32).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    queries = rs.randn(60, 32).astype(np.float32)
    exact = np.argsort(-(queries @ vecs.T), axis=1)[:, :10]
    recall = {}
    for name, mod in (("port", hnsw), ("jax", jax_hnsw)):
        ix = mod.DenseHnswIndexer(vector_sz=32, ef_search=64,
                                  ef_construction=100, seed=0)
        ix.index_data(np.arange(len(vecs)), vecs)
        res = ix.search_knn(queries, top_docs=10)
        recall[name] = np.mean([len(set(ids) & set(exact[i].tolist())) / 10
                                for i, (ids, _) in enumerate(res)])
    assert recall["port"] >= recall["jax"] - 0.02, recall
    assert recall["port"] >= 0.85, recall


def test_port_core_takes_no_reassociation_licence():
    """The port's C++ core asks for no fast-math (no optimize attribute or
    pragma) and is built without it (the package's g++ flags); its
    distance sums in a written-out order."""
    from ance_tpu_torch.utils import native_build
    src = PORT_SOURCE.read_text()
    code = re.sub(r"//[^\n]*", "", src)
    for banned in ("fast-math", "optimize(", "#pragma", "associative-math"):
        assert banned not in code, banned
    assert not any("fast" in flag or flag.startswith("-march")
                   for flag in native_build.CXX_FLAGS)
    assert "static constexpr int LANES" in code
    HnswIndex(dim=4)  # builds through native_build
    assert native_build.library_path("hnsw").exists()
