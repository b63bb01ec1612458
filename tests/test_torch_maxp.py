"""The MaxP document path of the port against the JAX package: chunked body
encoding, multi-chunk cache encode, the ``serve`` CLI (MaxP and FirstP at
seq 512), ``/reload`` of a MaxP index, and the tie order of the block-max
and merge top-k."""

import faulthandler
import json
import urllib.request
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ance_tpu.models.dot_models import RobertaDot as JaxRobertaDot
from ance_tpu.models.registry import get_model_spec as jax_spec
from ance_tpu.models.transformer import EncoderConfig as JaxConfig
from ance_tpu_torch.data.cache import TokenCache, TokenCacheWriter
from ance_tpu_torch.index.flat import FlatIPIndex
from ance_tpu_torch.models.dot_models import RobertaDot
from ance_tpu_torch.models.registry import get_model_spec
from ance_tpu_torch.models.transformer import EncoderConfig
from ance_tpu_torch.models.weights import state_dict_from_flax
from ance_tpu_torch.serve import Retriever
from ance_tpu_torch.serve_http import RetrieverHTTPServer
from ance_tpu_torch.train.encode import (encode_cache, encode_cache_to_device,
                                         make_encode_fn)

torch.set_num_threads(1)

TINY = {"num_layers": 2, "hidden_size": 32, "num_heads": 4,
        "intermediate_size": 64, "vocab_size": 100,
        "max_position_embeddings": 40}
# 512-token chunks need RoBERTa's 514 positions
TINY_514 = dict(TINY, max_position_embeddings=514)


def _docs(n, seq, rs, min_len=1):
    """RoBERTa-style token rows: <s> then random tokens, pad id 1 past each
    length; returns (lengths, ids, mask)."""
    lengths = rs.randint(min_len, seq + 1, n)
    ids = rs.randint(3, TINY["vocab_size"], (n, seq)).astype(np.int32)
    ids[:, 0] = 0
    mask = (np.arange(seq)[None, :] < lengths[:, None]).astype(np.int32)
    return lengths, np.where(mask == 1, ids, 1).astype(np.int32), mask


@pytest.fixture(autouse=True)
def _time_limit():
    """Pallas interpret mode re-enters JAX from its callbacks: should a
    test hang, print every thread's stack and end this worker after 300 s,
    so one test fails instead of the whole suite being cut."""
    faulthandler.dump_traceback_later(300, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()


def _tiny_pair(base_len, impl, seed=0, overrides=TINY):
    """A JAX RobertaDot with ``base_len`` and the port's, same weights.
    The parameter tree does not depend on ``attention_impl``, so ``init``
    runs on the einsum path, outside Pallas interpret mode."""
    jm = JaxRobertaDot(JaxConfig(attention_impl=impl, **overrides),
                       base_len=base_len)
    init_model = JaxRobertaDot(JaxConfig(attention_impl="xla", **overrides),
                               base_len=base_len)
    ids = jnp.ones((2, 8), jnp.int32)
    params = jax.jit(init_model.init)(jax.random.PRNGKey(seed), ids,
                                      ids)["params"]
    params = jax.tree.map(np.asarray, params)
    pm = RobertaDot(EncoderConfig(attention_impl=impl, **overrides),
                    base_len=base_len)
    pm.load_state_dict(state_dict_from_flax(params), strict=True)
    return jm, params, pm.eval()


@pytest.mark.parametrize("impl", ["xla", "fused", "flash"])
def test_body_emb_multichunk_matches_jax(impl):
    """[B, C·16] documents with all-padding chunks → [B, C, 768]; the JAX
    fused/flash kernels run in Pallas interpret mode, the port's as their
    plain versions. atol 1e-4: fp32 on LayerNorm'd embeddings, summed in
    other orders."""
    from jax.experimental.pallas import tpu as pltpu
    jm, params, pm = _tiny_pair(16, impl)
    rs = np.random.RandomState(1)
    _, ids, mask = _docs(5, 64, rs)
    mask[0, 20:], ids[0, 20:] = 0, 1  # chunks 2 and 3 are all padding
    apply = jax.jit(partial(jm.apply, method=JaxRobertaDot.body_emb_multichunk))
    with pltpu.force_tpu_interpret_mode():  # one jitted call, no eager JAX
        want = np.asarray(apply({"params": params}, jnp.asarray(ids),
                                jnp.asarray(mask)))
    with torch.inference_mode():
        got = pm.body_emb_multichunk(torch.as_tensor(ids).long(),
                                     torch.as_tensor(mask).long()).numpy()
    assert got.shape == want.shape == (5, 4, 768)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    # every all-padding chunk encodes to one embedding, bit for bit
    np.testing.assert_array_equal(got[0, 2], got[0, 3])


def test_body_emb_multichunk_rejects_a_ragged_length():
    _, _, pm = _tiny_pair(16, "xla")
    x = torch.ones(2, 40, dtype=torch.int64)
    with pytest.raises(ValueError, match="multiple of the chunk length"):
        pm.body_emb_multichunk(x, x)


def test_registry_maxp_weights_carry_over_from_jax():
    """A JAX ``rdot_nll_multi_chunk`` model's params load strictly into the
    port's registry model (the tree is rdot_nll's), and both give the same
    chunk embeddings of two 512-token chunks."""
    jm = jax_spec("rdot_nll_multi_chunk").build(config_overrides=TINY_514)
    ids0 = jnp.ones((2, 8), jnp.int32)
    params = jax.tree.map(np.asarray,
                          jm.init(jax.random.PRNGKey(3), ids0, ids0)["params"])
    spec = get_model_spec("rdot_nll_multi_chunk")
    assert spec.multichunk
    pm = spec.build(config_overrides=TINY_514, seed=9)
    pm.load_state_dict(state_dict_from_flax(params), strict=True)
    assert pm.base_len == jm.base_len == 512
    _, ids, mask = _docs(2, 1024, np.random.RandomState(4), min_len=300)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(ids),
                               jnp.asarray(mask),
                               method=type(jm).body_emb_multichunk))
    with torch.inference_mode():
        got = pm.body_emb_multichunk(torch.as_tensor(ids).long(),
                                     torch.as_tensor(mask).long()).numpy()
    assert got.shape == (2, 2, 768)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def _write_docs(path, n, seq, rs, min_len=1):
    lengths, ids, _ = _docs(n, seq, rs, min_len)
    with TokenCacheWriter(str(path), seq) as w:
        for length, row in zip(lengths, ids):
            w.write(int(length), row)


def test_encode_cache_multichunk_matches_jax(tmp_path):
    """10 documents of 4 chunks in batches of 4 (the last one padded): the
    rows flatten to [40, 768] with each id repeated per chunk, as in the
    JAX package; the device variant gives the same rows."""
    from ance_tpu.data.cache import TokenCache as JaxCache
    from ance_tpu.train.encode import encode_cache as jax_encode_cache
    from ance_tpu.train.encode import make_encode_fn as jax_make_encode_fn

    jm, params, pm = _tiny_pair(16, "xla", seed=2)
    _write_docs(tmp_path / "docs", 10, 64, np.random.RandomState(5))
    with JaxCache(str(tmp_path / "docs")) as jc:
        want, want_ids = jax_encode_cache(
            jax_make_encode_fn(jm, JaxRobertaDot.body_emb_multichunk),
            params, jc, 4, multichunk=True)
    fn = make_encode_fn(pm, RobertaDot.body_emb_multichunk, "cpu")
    with TokenCache(str(tmp_path / "docs")) as pc:
        got, got_ids = encode_cache(fn, pc, 4, multichunk=True)
        dev, dev_ids = encode_cache_to_device(fn, pc, 4, multichunk=True)
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_array_equal(got_ids, np.repeat(np.arange(10), 4))
    np.testing.assert_array_equal(dev_ids, got_ids)
    assert got.shape == (40, 768)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(dev.numpy(), got)


@pytest.fixture(scope="module")
def maxp_inputs(tmp_path_factory):
    """JAX-initialised tiny encoder (514 positions, wide init against
    collapse) saved as an HF checkpoint; 16 documents at seq 1024 (two
    512-token chunks each, none all padding, so no scores tie), 24
    passages at seq 512, 8 queries at seq 16."""
    from ance_tpu.models.hf_export import save_hf_checkpoint

    root = tmp_path_factory.mktemp("maxp")
    rs = np.random.RandomState(0)
    for sub, name, n, seq, min_len in (("doc", "passages", 16, 1024, 520),
                                       ("doc", "dev-query", 8, 16, 3),
                                       ("psg", "passages", 24, 512, 8),
                                       ("psg", "dev-query", 8, 16, 3)):
        (root / sub).mkdir(exist_ok=True)
        _write_docs(root / sub / name, n, seq, rs, min_len)
    model = jax_spec("rdot_nll").build(
        config_overrides=dict(TINY_514, initializer_range=0.5))
    ids = jnp.ones((2, 8), jnp.int32)
    params = model.init(jax.random.PRNGKey(7), ids, ids)["params"]
    ckpt = save_hf_checkpoint(root / "ckpt", jax.tree.map(np.asarray, params),
                              JaxConfig(**TINY_514))
    return root, ckpt


def _read_ranking(path):
    rows = [line.split("\t") for line in open(path).read().splitlines()]
    return [(int(q), int(p), int(r)) for q, p, r, _ in rows], \
        np.array([float(s) for *_, s in rows])


@pytest.mark.parametrize("model_type,sub,n_rows", [
    ("rdot_nll_multi_chunk", "doc", 32), ("rdot_nll", "psg", 24)])
def test_serve_cli_matches_jax_cli(maxp_inputs, tmp_path, model_type, sub,
                                   n_rows):
    """``serve`` on the same weights and caches in both packages: MaxP over
    seq-1024 documents (chunk rows deduplicated to documents) and FirstP
    at seq 512; the rankings agree pid for pid, the scores within 1e-4 +
    2e-6 relative (|score| ≈ 700-770, where an fp32 ulp is 6e-5). The
    saved MaxP index holds one row per chunk, ids repeated."""
    from ance_tpu.cli import main as jax_main
    from ance_tpu_torch.cli import main as port_main

    root, ckpt = maxp_inputs
    data = str(root / sub)
    common = ["serve", "--model_type", model_type,
              "--model_name_or_path", ckpt,
              "--encoder_overrides", json.dumps(TINY_514),
              "--data_dir", data, "--query_cache", data + "/dev-query",
              "--max_query_length", "16", "--per_device_eval_batch_size", "8",
              "--topk", "10", "--with_scores"]
    jax_out, port_out = str(tmp_path / "jax.tsv"), str(tmp_path / "port.tsv")
    jax_main(common + ["--output", jax_out])
    port_main(common + ["--output", port_out, "--device", "cpu",
                        "--save_index", str(tmp_path / "index")])
    jax_rank, jax_scores = _read_ranking(jax_out)
    port_rank, port_scores = _read_ranking(port_out)
    assert -np.diff(jax_scores.reshape(8, 10), axis=1).min() > 1e-3
    assert len(port_rank) == 8 * 10 and port_rank == jax_rank
    for q in range(8):  # unique documents per query
        assert len({p for _, p, _ in port_rank[q * 10:(q + 1) * 10]}) == 10
    np.testing.assert_allclose(port_scores, jax_scores, atol=1e-4, rtol=2e-6)
    e2id = np.load(str(tmp_path / "index") + ".ids.npy")
    assert len(e2id) == n_rows
    if model_type == "rdot_nll_multi_chunk":
        np.testing.assert_array_equal(e2id, np.repeat(np.arange(16), 2))


def test_reload_of_a_maxp_index(tmp_path):
    """/reload swaps in a saved index whose rows repeat document ids (one
    row per chunk); answers then dedup to unique documents, best chunk
    first, and equal a Retriever's on the same index."""
    def one_hot_encoder(ids, mask):
        return torch.nn.functional.one_hot(
            torch.as_tensor(ids)[:, 1].long(), 8).float()

    idx = FlatIPIndex(dim=8, device="cpu")
    idx.add(np.eye(8, dtype=np.float32))
    idx.save(str(tmp_path / "maxp"))
    e2id = np.repeat(np.arange(100, 104, dtype=np.int64), 2)  # 2 chunks each
    np.save(str(tmp_path / "maxp") + ".ids.npy", e2id)
    first = FlatIPIndex(dim=8, device="cpu")
    first.add(np.eye(8, dtype=np.float32)[:4])
    srv = RetrieverHTTPServer(Retriever(one_hot_encoder, first), port=0,
                              pid_space="offset", allow_reload=True).start()
    try:
        host, port = srv.address

        def post(path, payload):
            req = urllib.request.Request(
                f"http://{host}:{port}{path}",
                data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=10) as resp:
                return json.loads(resp.read())

        rep = post("/reload", {"index": str(tmp_path / "maxp")})
        assert rep["ntotal"] == 8
        ids = np.zeros((2, 4), np.int32)
        ids[0, 1], ids[1, 1] = 3, 6
        body = post("/search", {"ids": ids.tolist(), "k": 3})
    finally:
        srv.shutdown()
    pids = [[e["pid"] for e in r] for r in body["results"]]
    # row 3 (document 101) scores 1; the rest tie at 0 and dedup to the
    # lowest-row chunk of each other document
    assert pids == [[101, 100, 102], [103, 100, 101]]
    want_s, want_p = Retriever(one_hot_encoder, FlatIPIndex.load(
        str(tmp_path / "maxp"), device="cpu"), embedding2id=e2id
    ).search_tokens(ids, np.ones_like(ids), 3)
    assert pids == want_p.tolist()
    assert [[e["score"] for e in r] for r in body["results"]] == \
        want_s.tolist()


# -- tie order ---------------------------------------------------------------

def test_top_blocks_lower_id_first_keeps_the_lowest_tied_blocks():
    """Phase 2's contract, with heavy ties: the k largest block maxima,
    equal maxima lower block first, returned ascending (numpy's stable
    argsort is the oracle); int32 maxima (int8 × int8) too."""
    from ance_tpu_torch.ops.topk import top_blocks_lower_id_first
    rs = np.random.RandomState(6)
    for dtype in (np.float32, np.int32):
        bm = rs.randint(0, 3, (7, 500)).astype(dtype)
        for k in (1, 11, 101):
            want = np.sort(np.argsort(-bm, axis=1, kind="stable")[:, :k], 1)
            got = top_blocks_lower_id_first(torch.as_tensor(bm), k)
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k", [5, 40])
def test_topk_blockmax_with_duplicated_rows_matches_jax(k):
    """Every 7th row is one vector that the queries are near, so every
    block ties at the k-th block maximum: ids equal the JAX kernel's
    (interpret mode) and the scan's, id for id — the lowest-id copies."""
    from ance_tpu.ops.topk import topk_blockmax as jax_topk_blockmax
    from ance_tpu_torch.index.flat import topk_inner_product
    from ance_tpu_torch.ops.topk import topk_blockmax
    rs = np.random.RandomState(7)
    c = rs.randn(1024, 32).astype(np.float32)
    dup = rs.randn(32).astype(np.float32)
    c[::7] = dup
    q = (dup + 0.1 * rs.randn(9, 32)).astype(np.float32)
    js, ji = jax_topk_blockmax(jnp.asarray(q), jnp.asarray(c), k=k,
                               chunk_rows=128, q_tile=8, interpret=True)
    ps, pi = topk_blockmax(torch.as_tensor(q), torch.as_tensor(c), k=k,
                           chunk_rows=128)
    ss, si = topk_inner_product(torch.as_tensor(q), torch.as_tensor(c), k=k)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pi.numpy(), si.numpy())
    np.testing.assert_array_equal(pi.numpy()[:, :5], [[0, 7, 14, 21, 28]] * 9)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), atol=1e-5, rtol=0)


def test_merge_topk_ties_match_jax():
    """Tied scores across shards: the earlier candidate (lower shard, then
    lower rank) wins, as ``lax.top_k`` orders them."""
    from ance_tpu.index.flat import merge_topk as jax_merge
    from ance_tpu_torch.index.flat import merge_topk
    rs = np.random.RandomState(8)
    scores = -np.sort(-rs.randint(0, 4, (3, 5, 6)).astype(np.float32), -1)
    ids = rs.randint(0, 1000, (3, 5, 6)).astype(np.int64)
    for k in (1, 7, 18):
        js, ji = jax_merge(jnp.asarray(scores), jnp.asarray(ids), k)
        ps, pi = merge_topk(torch.as_tensor(scores), torch.as_tensor(ids), k)
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))


@pytest.mark.cuda
def test_maxp_encode_on_cuda_launches_the_fused_kernel():
    """``auto`` at S = 512 on a CUDA tensor goes through the fused kernel,
    once per layer, and agrees with the forced plain path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from ance_tpu_torch.ops.fused_attention import fused_attention
    spec = get_model_spec("rdot_nll_multi_chunk")
    cfg = dict(TINY_514, hidden_size=128, num_heads=2)
    model = spec.build(dtype=torch.bfloat16, config_overrides=cfg).cuda()
    plain = spec.build(dtype=torch.bfloat16, attention_impl="xla",
                       config_overrides=cfg).cuda()
    _, ids, mask = _docs(3, 1024, np.random.RandomState(9))
    ids, mask = (torch.as_tensor(a).long().cuda() for a in (ids, mask))
    before = fused_attention.launches
    with torch.inference_mode():
        got = model.body_emb_multichunk(ids, mask)
        want = plain.body_emb_multichunk(ids, mask)
    assert fused_attention.launches == before + cfg["num_layers"]
    cos = torch.nn.functional.cosine_similarity(got.flatten(0, 1),
                                                want.flatten(0, 1), dim=1)
    assert bool((cos > 0.999).all())
