"""The row-sharded ``FlatIPIndex`` and the cluster-sharded ``IVFIPIndex`` of
the port at 2 and 4 gloo ranks (one spawn of ``mesh_worker`` per world
size) against the JAX package's indexes on a ``Mesh`` of as many of
conftest's virtual CPU devices, on the same numpy inputs.

Flat (none / bf16 / dims / rows): ids equal, scores within 1e-5 relative
(the port rescores in fp64, JAX sums fp32 products); ``rows_per_shard``
JAX's padded row count over the shards; an odd ``ntotal`` of rows whose
every score is negative, so padding that surfaced would win with 0;
``allocate`` + ``update_slice`` equal to ``add``, and a slice past the last
shard refused; a save at world 2 loading at worlds 1 and 4 to the same
answer. IVF (fp32 and dims, nlist 15, a multiple of neither 2 nor 4):
every rank's centroids JAX's (within k-means' 1e-5), each rank's bins
JAX's shard of them, ids equal at nprobe 1 / 4 / nlist, and the save at
world 2 loading at world 4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from ance_tpu.index.flat import FlatIPIndex as JaxFlat
from ance_tpu.index.ivf import IVFIPIndex as JaxIVF
from ance_tpu_torch.index.flat import FlatIPIndex
from test_torch_ivf import _clustered_corpus
from test_torch_mesh import spawn_ranks

N, DIM, Q = 203, 16, 7          # 203 rows: odd, a multiple of no world
KS = (5, 60)                    # 60 > the 51 rows of a shard at world 4
MODES = ("none", "bf16", "dims", "rows")
JAX_MODE = {"none": dict(dtype=jnp.float32), "bf16": dict(dtype=jnp.bfloat16),
            "dims": dict(quantize="dims"), "rows": dict(quantize="rows")}
NLIST, NPROBES, IVF_K = 15, (1, 4, 15), 10


def _mesh(world):
    return Mesh(np.array(jax.devices()[:world]), ("data",))


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Both world sizes' results: world 2 saves every index, world 4 loads
    them."""
    root = tmp_path_factory.mktemp("mesh_index")
    rs = np.random.RandomState(0)
    np.savez(root / "flat.npz", corpus=rs.randn(N, DIM).astype(np.float32),
             queries=rs.randn(Q, DIM).astype(np.float32))
    # every score negative: a padding row's 0 would beat every real row
    np.savez(root / "negative.npz",
             corpus=np.abs(rs.randn(N, DIM)).astype(np.float32),
             queries=-np.abs(rs.randn(Q, DIM)).astype(np.float32))
    corpus = np.concatenate([
        _clustered_corpus(rs, n_clusters=6, per_cluster=60, dim=32),
        _clustered_corpus(rs, n_clusters=10, per_cluster=12, dim=32)])
    queries = corpus[rs.choice(len(corpus), 24, replace=False)] \
        + 0.05 * rs.randn(24, 32).astype(np.float32)
    np.savez(root / "ivf.npz", corpus=corpus, queries=queries)
    saved = root / "saved"
    saved.mkdir()
    results = {}
    for world in (2, 4):
        io = {"save_dir": str(saved)} if world == 2 else \
            {"load_dir": str(saved)}
        cases = [
            {"case": "flat", "data": str(root / "flat.npz"),
             "modes": list(MODES), "ks": list(KS), "slice_rows": 16, **io},
            {"case": "flat", "name": "negative",
             "data": str(root / "negative.npz"), "modes": ["none"],
             "ks": [4], "slice_rows": 16},
            {"case": "ivf", "data": str(root / "ivf.npz"), "nlist": NLIST,
             "nprobes": list(NPROBES), "k": IVF_K, "seed": 5,
             "quantize": [False, "dims"], **io}]
        (root / f"w{world}").mkdir()
        results[world] = spawn_ranks(root / f"w{world}", world, cases)
    return root, results


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def _same_on_every_rank(per_rank, key):
    s0, i0 = per_rank[0][key]
    for r in per_rank[1:]:
        assert torch.equal(r[key][1], i0) and torch.equal(r[key][0], s0)
    return s0, i0


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("mode", MODES)
def test_sharded_flat_matches_jax_mesh(spawned, world, mode):
    root, results = spawned
    got = results[world]["flat"]
    with np.load(root / "flat.npz") as z:
        corpus, queries = z["corpus"], z["queries"]
    ref = JaxFlat(dim=DIM, mesh=_mesh(world), **JAX_MODE[mode])
    ref.add(corpus)
    assert got[0][f"{mode}/rows_per_shard"] == \
        ref._emb.shape[0] // world == -(-N // world)
    for k in KS:
        s, i = _same_on_every_rank(got, f"{mode}/k{k}")
        js, ji = ref.search(queries, k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_allclose(s.numpy(), _np(js), rtol=1e-5, atol=1e-5)
        if mode in ("none", "dims"):
            cs, ci = _same_on_every_rank(got, f"{mode}/chunked/k{k}")
            assert torch.equal(ci, i) and torch.equal(cs, s)
    if mode in ("none", "dims"):
        assert all(r[f"{mode}/out_of_range_raises"] for r in got)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_padding_never_surfaces(spawned, world):
    root, results = spawned
    with np.load(root / "negative.npz") as z:
        corpus, queries = z["corpus"], z["queries"]
    s, i = _same_on_every_rank(results[world]["negative"], "none/k4")
    assert (s.numpy() < 0).all(), "a padding row surfaced"
    want = np.argsort(-(queries.astype(np.float64) @ corpus.T.astype(
        np.float64)), axis=1, kind="stable")[:, :4]
    np.testing.assert_array_equal(i.numpy(), want)


@pytest.mark.parametrize("mode", MODES)
def test_save_at_world_2_loads_at_worlds_1_and_4(spawned, mode):
    root, results = spawned
    with np.load(root / "flat.npz") as z:
        queries = z["queries"]
    one = FlatIPIndex.load(str(root / "saved" / f"{mode}.npz"), device="cpu")
    assert one.ntotal == N and one._emb.shape[0] == N
    for k in KS:
        s2, i2 = _same_on_every_rank(results[2]["flat"], f"{mode}/k{k}")
        s4, i4 = _same_on_every_rank(results[4]["flat"],
                                     f"{mode}/loaded/k{k}")
        s1, i1 = one.search(queries, k)
        assert torch.equal(i1, i2) and torch.equal(i4, i2)
        assert torch.equal(s1, s2) and torch.equal(s4, s2)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("quantize", [False, "dims"])
def test_cluster_sharded_ivf_matches_jax_mesh(spawned, world, quantize):
    root, results = spawned
    got, tag = results[world]["ivf"], quantize or "none"
    with np.load(root / "ivf.npz") as z:
        corpus, queries = z["corpus"], z["queries"]
    ref = JaxIVF(dim=32, nlist=NLIST, nprobe=NPROBES[0], seed=5,
                 dtype=jnp.float32, quantize=quantize, mesh=_mesh(world))
    ref.add(corpus)
    per = -(-NLIST // world)
    ref_ids = np.asarray(ref._bins_ids)
    ref_emb = np.asarray(ref._bins_emb).astype(np.float32)
    assert ref_ids.shape[0] == per * world
    for r, res in enumerate(got):
        np.testing.assert_allclose(res[f"{tag}/centroids"].numpy(),
                                   np.asarray(ref.centroids), atol=1e-5)
        assert torch.equal(res[f"{tag}/centroids"],
                           got[0][f"{tag}/centroids"])
        np.testing.assert_array_equal(res[f"{tag}/bins_ids"].numpy(),
                                      ref_ids[r * per:(r + 1) * per])
        np.testing.assert_array_equal(res[f"{tag}/bins_emb"].float().numpy(),
                                      ref_emb[r * per:(r + 1) * per])
    for nprobe in NPROBES:
        s, i = _same_on_every_rank(got, f"{tag}/nprobe{nprobe}")
        js, ji = ref.search(queries, IVF_K, nprobe=nprobe)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        ok = np.asarray(ji) >= 0
        np.testing.assert_allclose(s.numpy()[ok], np.asarray(js)[ok],
                                   atol=1e-5, rtol=0)
    if world == 4:  # world 2's save, reloaded over 4 ranks
        _, i = _same_on_every_rank(got, f"{tag}/loaded")
        _, ji = JaxIVF.load(str(root / "saved" / f"ivf_{tag}.npz"),
                            mesh=_mesh(4)).search(queries, IVF_K,
                                                  nprobe=NPROBES[0])
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
