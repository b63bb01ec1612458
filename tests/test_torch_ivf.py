"""Torch port of the IVF index (``ance_tpu_torch/index/ivf.py``): the cases
of tests/test_ivf.py but the two mesh ones, and parity with
``ance_tpu.index.ivf`` on the same seeded numpy inputs: bins, k-means,
``add``, ``search`` (ids equal; scores within 1e-5, both packages summing
the same fp32 products of exact operands in their own order), the union
tie order, recall and the ``.npz`` layout both ways."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ance_tpu.index.ivf import IVFIPIndex as JaxIVF
from ance_tpu.index.ivf import _kmeans as jax_kmeans
from ance_tpu.index.ivf import _pack_bins as jax_pack_bins
from ance_tpu_torch.index.flat import FlatIPIndex
from ance_tpu_torch.index.ivf import IVFIPIndex, _kmeans, _pack_bins
from ance_tpu_torch.ops.topk import rescore

torch.set_num_threads(1)

# (quantize, JAX dtype, port dtype) of the three storage kinds
KINDS = {"fp32": (False, jnp.float32, torch.float32),
         "bf16": (False, jnp.bfloat16, torch.bfloat16),
         "dims": ("dims", jnp.float32, torch.float32)}
SCORE_ATOL = 1e-5


def _clustered_corpus(rs, n_clusters=32, per_cluster=64, dim=32, spread=0.15):
    centers = rs.randn(n_clusters, dim).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    rows = np.repeat(centers, per_cluster, axis=0)
    rows += spread * rs.randn(*rows.shape).astype(np.float32)
    return rows


def _pair(kind, **kw):
    quantize, jdt, tdt = KINDS[kind]
    return (JaxIVF(dtype=jdt, quantize=quantize, **kw),
            IVFIPIndex(dtype=tdt, quantize=quantize, device="cpu", **kw))


# -- tests/test_ivf.py's cases on the port ----------------------------------

def test_pack_bins_keeps_every_row():
    rs = np.random.RandomState(0)
    scores = rs.randn(200, 8).astype(np.float32)
    bins, counts = _pack_bins(scores, capacity=40)  # 8*40=320 ≥ 200
    flat = bins[bins >= 0]
    assert len(flat) == 200 and len(set(flat.tolist())) == 200
    assert counts.sum() == 200 and counts.max() <= 40


def test_pack_bins_spills_strongest_stay():
    scores = np.zeros((6, 2), np.float32)
    scores[:, 0] = [5, 4, 3, 2, 1, 0]
    scores[:, 1] = -1
    bins, counts = _pack_bins(scores, capacity=3)
    assert sorted(bins[0].tolist()) == [0, 1, 2]
    assert sorted(b for b in bins[1].tolist() if b >= 0) == [3, 4, 5]


def test_ivf_recall_on_clustered_corpus():
    rs = np.random.RandomState(1)
    corpus = _clustered_corpus(rs)
    queries = corpus[rs.choice(len(corpus), 64, replace=False)] \
        + 0.05 * rs.randn(64, corpus.shape[1]).astype(np.float32)

    exact = FlatIPIndex(dim=corpus.shape[1], device="cpu")
    exact.add(corpus)
    _, exact_ids = exact.search(queries, k=10)
    exact_ids = exact_ids.numpy()

    ivf = IVFIPIndex(dim=corpus.shape[1], nlist=32, nprobe=8,
                     kmeans_iters=15, seed=0, dtype=torch.float32,
                     device="cpu")
    ivf.add(corpus)
    recall = ivf.recall_against_exact(queries, 10, exact_ids)
    assert recall >= 0.9, f"recall@10 {recall}"
    # widest probe = exact search
    _, ids_full = ivf.search(queries, k=10, nprobe=32)
    assert np.mean([len(set(ids_full[i].tolist()) & set(exact_ids[i]))
                    for i in range(64)]) == 10.0


def test_ivf_search_contract():
    rs = np.random.RandomState(2)
    corpus = _clustered_corpus(rs, n_clusters=4, per_cluster=8, dim=16)
    ivf = IVFIPIndex(dim=16, nlist=4, nprobe=1, slack=2.0, seed=3,
                     device="cpu")
    ivf.add(corpus)
    assert ivf.ntotal == 32

    q = corpus[:5]
    scores, ids = ivf.search(q, k=50)  # k exceeds probed rows → −1 pad
    assert scores.shape == (5, 50) and ids.shape == (5, 50)
    assert scores.dtype == torch.float32 and ids.dtype == torch.int64
    ids, s = ids.numpy(), scores.numpy()
    valid = ids >= 0
    assert valid.sum(1).min() >= 1
    for i in range(5):
        for j in np.nonzero(valid[i])[0]:
            true = float(q[i] @ corpus[ids[i, j]])
            assert abs(s[i, j] - true) < 0.05  # bf16 storage tolerance
    for i in range(5):
        vs = s[i][valid[i]]
        assert np.all(np.diff(vs) <= 1e-5)


def test_ivf_empty_and_retrain():
    ivf = IVFIPIndex(dim=8, nlist=2, nprobe=2, device="cpu")
    with pytest.raises(ValueError, match="empty"):
        ivf.search(np.zeros((1, 8), np.float32), k=1)
    rs = np.random.RandomState(4)
    ivf.add(rs.randn(16, 8).astype(np.float32))
    assert ivf.capacity >= 8
    ivf.reset()
    assert ivf.ntotal == 0


def test_ivf_add_refits_unless_pinned():
    rs = np.random.RandomState(7)
    a = _clustered_corpus(rs, n_clusters=4, per_cluster=16, dim=16)
    b = _clustered_corpus(rs, n_clusters=4, per_cluster=16, dim=16) + 3.0

    ivf = IVFIPIndex(dim=16, nlist=4, nprobe=2, seed=8, device="cpu")
    ivf.add(a)
    c_after_a = ivf.centroids.clone()
    ivf.add(b)  # no explicit train → refit on the refreshed corpus
    assert not torch.allclose(ivf.centroids, c_after_a)

    pinned = IVFIPIndex(dim=16, nlist=4, nprobe=2, seed=8, device="cpu")
    pinned.train(a)
    c_pinned = pinned.centroids.clone()
    pinned.add(b)  # explicit train pins the clustering
    assert torch.equal(pinned.centroids, c_pinned)


@pytest.mark.parametrize("kind", list(KINDS))
def test_ivf_save_load_roundtrip(tmp_path, kind):
    """save/load skips the k-means fit and the packing pass: identical
    search results for fp32 / bf16 / int8-dims bins."""
    rs = np.random.RandomState(15)
    corpus = _clustered_corpus(rs, n_clusters=24, per_cluster=32, dim=32)
    queries = corpus[rs.choice(len(corpus), 16, replace=False)]
    quantize, _, dtype = KINDS[kind]
    a = IVFIPIndex(dim=32, nlist=26, nprobe=8, seed=12, dtype=dtype,
                   quantize=quantize, device="cpu")
    a.add(corpus)
    s1, i1 = a.search(queries, k=10)
    path = str(tmp_path / f"ivf_{kind}")
    a.save(path)
    b = IVFIPIndex.load(path, device="cpu")
    assert b.ntotal == len(corpus) and b.nprobe == 8 and b._pinned
    assert b._bins_emb.dtype == a._bins_emb.dtype
    s2, i2 = b.search(queries, k=10)
    assert torch.equal(i1, i2) and torch.equal(s1, s2)
    assert IVFIPIndex.load(path + ".npz", device="cpu", nprobe=3).nprobe == 3
    with pytest.raises(ValueError, match="empty"):
        IVFIPIndex(dim=32, device="cpu").save(str(tmp_path / "never"))


def test_ivf_int8_dims_quantization():
    rs = np.random.RandomState(13)
    corpus = _clustered_corpus(rs, n_clusters=16, per_cluster=32, dim=32)
    queries = corpus[rs.choice(len(corpus), 32, replace=False)]
    exact = np.argsort(-(queries @ corpus.T), axis=1)[:, :10]

    q8 = IVFIPIndex(dim=32, nlist=16, nprobe=16, seed=14, quantize="dims",
                    dtype=torch.float32, device="cpu")
    q8.add(corpus)
    assert q8._bins_emb.dtype == torch.int8
    _, ids = q8.search(queries, k=10, nprobe=16)  # exhaustive probe
    recall = np.mean([len(set(ids[i].tolist()) & set(exact[i])) / 10
                      for i in range(len(queries))])
    assert recall >= 0.97, recall
    scores, ids = q8.search(queries[:4], k=3, nprobe=16)
    for i in range(4):
        for j in range(3):
            true = float(queries[i] @ corpus[int(ids[i, j])])
            assert abs(float(scores[i, j]) - true) < 0.05

    with pytest.raises(ValueError, match="per-row"):
        IVFIPIndex(dim=8, quantize="rows", device="cpu")


def test_ivf_chunked_assignment_matches_small_chunk():
    rs = np.random.RandomState(9)
    corpus = _clustered_corpus(rs, n_clusters=8, per_cluster=32, dim=16)
    big = IVFIPIndex(dim=16, nlist=8, nprobe=8, seed=10, device="cpu")
    big.add(corpus)
    small = IVFIPIndex(dim=16, nlist=8, nprobe=8, seed=10, device="cpu")
    small._ASSIGN_CHUNK = 17  # non-divisor chunk
    small.add(corpus)
    assert torch.equal(big._bins_ids, small._bins_ids)
    assert torch.equal(big._bins_emb, small._bins_emb)


def test_ivf_serves_through_retriever():
    """Drop-in behind the serving Retriever (same contract as FlatIPIndex)."""
    from ance_tpu_torch.serve import Retriever

    rs = np.random.RandomState(5)
    corpus = _clustered_corpus(rs, n_clusters=8, per_cluster=16, dim=16)
    ivf = IVFIPIndex(dim=16, nlist=8, nprobe=8, seed=6, device="cpu")
    ivf.add(corpus)

    def encode_fn(ids, mask):
        del mask
        return torch.as_tensor(corpus[np.asarray(ids)[:, 0]])

    r = Retriever(encode_fn, ivf,
                  embedding2id=np.arange(len(corpus), dtype=np.int64))
    tok = np.arange(4, dtype=np.int32)[:, None]
    scores, pids = r.search_tokens(tok, np.ones_like(tok), k=3)
    assert pids.shape == (4, 3) and scores.dtype == np.float32
    exact = np.argsort(-(corpus[:4] @ corpus.T), axis=1)[:, :3]
    assert np.array_equal(pids, exact)


# -- parity with ance_tpu.index.ivf -----------------------------------------

def test_pack_bins_matches_jax_with_spills():
    """The host packer is the JAX package's: the same bins and counts,
    spilled rows included, on scores where most clusters overflow."""
    rs = np.random.RandomState(21)
    scores = rs.randn(500, 12).astype(np.float32)
    scores[:, 3] += 1.5  # one crowded cluster: many rows spill
    bins, counts = _pack_bins(scores, capacity=50)
    jbins, jcounts = jax_pack_bins(scores, capacity=50)
    assert (np.bincount(scores.argmax(1), minlength=12) > 50).any()
    np.testing.assert_array_equal(bins, jbins)
    np.testing.assert_array_equal(counts, jcounts)


def test_kmeans_matches_jax():
    """One init through both packages' k-means: centroids within 1e-5,
    the corpus assigned alike (clustered data, clear margins)."""
    rs = np.random.RandomState(22)
    x = _clustered_corpus(rs, n_clusters=16, per_cluster=40, dim=24)
    init = x[rs.choice(len(x), 16, replace=False)]
    c = _kmeans(torch.as_tensor(x), torch.as_tensor(init), nlist=16,
                iters=10).numpy()
    jc = np.asarray(jax_kmeans(jnp.asarray(x), jnp.asarray(init), nlist=16,
                               iters=10))
    np.testing.assert_allclose(c, jc, atol=1e-5, rtol=0)
    np.testing.assert_array_equal((x @ c.T).argmax(1), (x @ jc.T).argmax(1))


def _built_pair(kind, slack=1.3):
    rs = np.random.RandomState(23)
    # uneven clusters, so the capacity spills rows at slack 1.3
    corpus = np.concatenate([
        _clustered_corpus(rs, n_clusters=6, per_cluster=60, dim=32),
        _clustered_corpus(rs, n_clusters=10, per_cluster=12, dim=32)])
    queries = corpus[rs.choice(len(corpus), 24, replace=False)] \
        + 0.05 * rs.randn(24, 32).astype(np.float32)
    j, p = _pair(kind, dim=32, nlist=16, nprobe=4, seed=5, slack=slack)
    j.add(corpus)
    p.add(corpus)
    return corpus, queries, j, p


@pytest.mark.parametrize("kind", list(KINDS))
def test_add_matches_jax(kind):
    """add(): the same bins (spills included), centroids within 1e-5; for
    dims the same int8 codes and scales; bf16 values the same roundings."""
    corpus, _, j, p = _built_pair(kind)
    assert p.capacity == j.capacity
    filled = (np.asarray(j._bins_ids) >= 0).sum(1)
    assert filled.max() == p.capacity  # some cluster is full: rows spilled
    np.testing.assert_array_equal(p._bins_ids.numpy(),
                                  np.asarray(j._bins_ids))
    np.testing.assert_allclose(p.centroids.numpy(), np.asarray(j.centroids),
                               atol=1e-5, rtol=0)
    got = p._bins_emb.float().numpy()
    want = np.asarray(j._bins_emb).astype(np.float32)
    np.testing.assert_array_equal(got, want)
    if kind == "dims":
        assert p._bins_emb.dtype == torch.int8
        np.testing.assert_array_equal(p._dim_scales.numpy(), j._dim_scales)


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("nprobe,union", [(1, None), (4, None), (16, None),
                                          (4, 6)])
def test_search_matches_jax(kind, nprobe, union):
    """search(): equal ids at nprobe 1 / 4 / nlist and at a union below
    Q·nprobe; scores within SCORE_ATOL (one fp32 sum of exact products,
    added in another order)."""
    _, queries, j, p = _built_pair(kind)
    for k in (10, 200):  # 200 > the probed rows at nprobe 1: −1 slots
        js, ji = j.search(queries, k, nprobe=nprobe, union=union)
        ps, pi = p.search(queries, k, nprobe=nprobe, union=union)
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
        finite = np.asarray(ji) >= 0
        np.testing.assert_allclose(ps.numpy()[finite],
                                   np.asarray(js)[finite],
                                   atol=SCORE_ATOL, rtol=0)
        assert (ps.numpy()[~finite] == np.asarray(js)[~finite]).all()
    assert p.recall_against_exact(queries, 10, pi.numpy()[:, :10]) == \
        j.recall_against_exact(queries, 10, np.asarray(ji)[:, :10])


def test_union_keeps_lowest_index_probed_clusters():
    """The JAX package's quirk, kept: a probed cluster's priority is
    1e9 + score in fp32, where one step is 64, so every probed cluster
    ties and a union smaller than the probed count keeps the lowest-INDEX
    probed clusters, not the strongest."""
    dim = 4
    rs = np.random.RandomState(24)
    eye = np.eye(dim, dtype=np.float32)
    corpus = np.repeat(eye, 20, axis=0) \
        + 0.01 * rs.randn(20 * dim, dim).astype(np.float32)
    j, p = _pair("fp32", dim=dim, nlist=dim, nprobe=2, seed=1, slack=2.0)
    j.add(corpus)
    p.add(corpus)
    cluster_of = p.centroids.numpy().argmax(1)  # cluster → direction
    low, high = sorted(rs.choice(dim, 2, replace=False))
    # the query leans to the HIGHER-index cluster's direction
    q = (0.4 * eye[cluster_of[low]] + 0.9 * eye[cluster_of[high]])[None]
    _, ids = p.search(q, 5, nprobe=2, union=1)
    members = set(p._bins_ids[low].tolist())
    assert set(ids[0].tolist()) <= members  # the weaker, lower-index one
    _, strong = p.search(q, 5, nprobe=1)
    assert not set(strong[0].tolist()) & members
    _, jids = j.search(q, 5, nprobe=2, union=1)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))


@pytest.mark.parametrize("kind", list(KINDS))
def test_npz_crosses_packages(tmp_path, kind):
    """A port-saved IVF loads in ``ance_tpu`` and a JAX-saved one in the
    port; each answers as the index that saved it."""
    _, queries, j, p = _built_pair(kind)
    p.save(str(tmp_path / "port"))
    j.save(str(tmp_path / "jax"))
    with np.load(str(tmp_path / "port.npz")) as zp, \
            np.load(str(tmp_path / "jax.npz")) as zj:
        assert sorted(zp.files) == sorted(zj.files)
        for key in ("bins_emb", "bins_ids", "dim_scales"):
            assert zp[key].dtype == zj[key].dtype, key
            np.testing.assert_array_equal(zp[key], zj[key])
        assert str(zp["dtype_name"]) == str(zj["dtype_name"])
    from_port = JaxIVF.load(str(tmp_path / "port"))
    from_jax = IVFIPIndex.load(str(tmp_path / "jax"), device="cpu")
    ps, pi = p.search(queries, 10)
    js, ji = j.search(queries, 10)
    np.testing.assert_array_equal(np.asarray(from_port.search(queries,
                                                              10)[1]),
                                  pi.numpy())
    np.testing.assert_array_equal(from_jax.search(queries, 10)[1].numpy(),
                                  np.asarray(ji))
    assert from_jax.nprobe == j.nprobe and from_jax.ntotal == j.ntotal


# -- on the card ------------------------------------------------------------

def _card_corpus():
    rs = np.random.RandomState(31)
    return (_clustered_corpus(rs, n_clusters=64, per_cluster=64, dim=96),
            rs)


@pytest.mark.cuda
def test_ivf_builds_bit_equal_on_cuda():
    """Two builds from one seed: bit-equal centroids, bins and values
    (the cluster sums take a fixed order on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    corpus, _ = _card_corpus()
    built = []
    for _ in range(2):
        idx = IVFIPIndex(dim=96, nlist=64, seed=3, dtype=torch.float32,
                         device="cuda")
        idx.add(torch.as_tensor(corpus, device="cuda"))
        built.append(idx)
    a, b = built
    assert torch.equal(a.centroids, b.centroids)
    assert torch.equal(a._bins_ids, b._bins_ids)
    assert torch.equal(a._bins_emb, b._bins_emb)


@pytest.mark.cuda
def test_ivf_bf16_bins_score_fp32_on_cuda():
    """bf16 bins give fp32 scores: within 1e-5 relative of the fp64 product
    of the bf16 operands (a bf16 output would be off by up to 2^-9)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    corpus, rs = _card_corpus()
    idx = IVFIPIndex(dim=96, nlist=64, nprobe=64, seed=3,
                     dtype=torch.bfloat16, device="cuda")
    idx.add(corpus)
    q = torch.as_tensor(corpus[rs.choice(len(corpus), 16)], device="cuda")
    scores, ids = idx.search(q, 10)
    assert scores.dtype == torch.float32
    rows = torch.as_tensor(corpus, device="cuda")[ids].to(torch.bfloat16)
    want = rescore(q.to(torch.bfloat16), rows)
    assert ((scores - want).abs() <= 1e-5 * want.abs().amax()).all()


@pytest.mark.cuda
def test_ivf_cuda_search_equals_cpu_search():
    """The same bins searched on the card and on the CPU: equal ids."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    corpus, rs = _card_corpus()
    cpu = IVFIPIndex(dim=96, nlist=64, nprobe=8, seed=3,
                     dtype=torch.float32, device="cpu")
    cpu.add(corpus)
    card = IVFIPIndex(dim=96, nlist=64, nprobe=8, dtype=torch.float32,
                      device="cuda")
    card.centroids = cpu.centroids.cuda()
    card._publish(cpu._bins_emb.cuda(), cpu._bins_ids.cuda(),
                  cpu._search_centroids.cuda(), cpu.ntotal)
    q = corpus[rs.choice(len(corpus), 32)] \
        + 0.05 * rs.randn(32, 96).astype(np.float32)
    for nprobe in (1, 8, 64):
        _, ci = cpu.search(q, 10, nprobe=nprobe)
        _, gi = card.search(q, 10, nprobe=nprobe)
        assert torch.equal(ci, gi.cpu())
