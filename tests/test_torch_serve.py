"""Torch port serving: Retriever, the HTTP server, and the whole ``serve``
slice against ``ance_tpu.cli serve`` on the same weights and caches."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from ance_tpu_torch.index.flat import FlatIPIndex
from ance_tpu_torch.index.ivf import IVFIPIndex
from ance_tpu_torch.serve import Retriever, bucket_pow2, dedup_first_hit
from ance_tpu_torch.serve_http import RetrieverHTTPServer

torch.set_num_threads(1)

TINY = {"num_layers": 2, "hidden_size": 32, "num_heads": 4,
        "intermediate_size": 64, "vocab_size": 100,
        "max_position_embeddings": 40}


def identity_encoder(ids, mask):
    """Test double: 'embedding' = one-hot of the first real token id."""
    return torch.nn.functional.one_hot(
        torch.as_tensor(ids)[:, 1].long(), 8).float()


class Tok:
    pad_token_id = 0

    def encode(self, text, add_special_tokens=True, max_length=None):
        return [2, 3 if "cat" in text else 5][:max_length]


def _eye_index(n=8, method="scan"):
    index = FlatIPIndex(dim=8, device="cpu", method=method)
    index.add(np.eye(8, dtype=np.float32)[:n])
    return index


# -- Retriever (tests/test_serve.py) --------------------------------------

@pytest.mark.parametrize("method", ["scan", "blockmax"])
def test_search_tokens_single_vector(method):
    r = Retriever(identity_encoder, _eye_index(method=method))
    ids = np.zeros((2, 4), np.int32)
    ids[0, 1], ids[1, 1] = 3, 5
    scores, pids = r.search_tokens(ids, np.ones_like(ids), k=2)
    assert pids[0, 0] == 3 and pids[1, 0] == 5
    assert scores[0, 0] == pytest.approx(1.0)


def test_search_tokens_multivector_dedup():
    emb2id = np.array([100, 100, 200, 201, 202, 203, 204, 205])
    r = Retriever(identity_encoder, _eye_index(), embedding2id=emb2id)
    ids = np.zeros((1, 4), np.int32)
    scores, pids = r.search_tokens(ids, np.ones_like(ids), k=3)
    assert pids[0, 0] == 100
    assert len(set(pids[0].tolist())) == 3


def test_search_with_tokenizer():
    r = Retriever(identity_encoder, _eye_index(), tokenizer=Tok(),
                  max_query_length=4)
    _, pids = r.search(["a cat", "a dog"], k=1)
    assert pids[0, 0] == 3 and pids[1, 0] == 5


def test_dedup_first_hit_matches_jax():
    """Same adversarial input (duplicates, −1 rows, short rows) through
    both packages' dedup: identical arrays."""
    from ance_tpu.serve import dedup_first_hit as jax_dedup
    rs = np.random.RandomState(11)
    e2id = rs.randint(0, 8, 30).astype(np.int64)
    rows = rs.randint(-1, 30, (17, 40)).astype(np.int32)
    rows[3] = -1
    scores = -np.sort(-rs.randn(17, 40).astype(np.float32), axis=1)
    for got, want in zip(dedup_first_hit(scores, rows, e2id, 10),
                         jax_dedup(scores, rows, e2id, 10)):
        np.testing.assert_array_equal(got, want)


def test_bucket_pow2():
    assert [bucket_pow2(n, 64) for n in (0, 1, 3, 64, 65)] == \
        [1, 1, 4, 64, 64]


# -- HTTP (tests/test_serve_http.py) -------------------------------------

@pytest.fixture(scope="module")
def server():
    r = Retriever(identity_encoder, _eye_index(), tokenizer=Tok(),
                  max_query_length=4)
    srv = RetrieverHTTPServer(r, host="127.0.0.1", port=0,
                              pid_space="offset", max_batch=16).start()
    yield srv
    srv.shutdown()


def _post(srv, path, payload, as_bytes=None):
    host, port = srv.address
    req = urllib.request.Request(
        f"http://{host}:{port}{path}",
        data=as_bytes if as_bytes is not None
        else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=10) as resp:
        return resp.status, json.loads(resp.read())


def _get(srv, path):
    host, port = srv.address
    with urllib.request.urlopen(f"http://{host}:{port}{path}",
                                timeout=10) as resp:
        return resp.status, json.loads(resp.read())


def test_healthz(server):
    status, body = _get(server, "/healthz")
    assert status == 200 and body["ntotal"] == 8
    assert body["pid_space"] == "offset"


def test_search_tokens_and_text(server):
    ids = np.zeros((3, 4), np.int32)  # width 3 buckets to 4 internally
    ids[0, 1], ids[1, 1], ids[2, 1] = 1, 5, 7
    status, body = _post(server, "/search", {"ids": ids.tolist(),
                                             "mask": np.ones_like(ids).tolist(),
                                             "k": 3})
    assert status == 200 and len(body["results"]) == 3
    assert [r[0]["pid"] for r in body["results"]] == [1, 5, 7]
    assert all(len(r) <= 3 for r in body["results"])
    status, body = _post(server, "/search",
                         {"queries": ["a cat", "a dog"], "k": 1})
    assert [r[0]["pid"] for r in body["results"]] == [3, 5]


def test_bad_requests(server):
    for payload, match in [
            ({"k": 0, "queries": ["x"]}, "k must be"),
            ({"k": True, "queries": ["x"]}, "k must be"),
            ({"queries": []}, "non-empty"),
            ({"k": 3}, "need 'queries'"),
            ({"ids": [[1, 2]], "mask": [[1]]}, "equal-shape"),
            ({"queries": ["x"] * 17}, "max_batch")]:
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(server, "/search", payload)
        assert exc.value.code == 400
        assert match in json.loads(exc.value.read())["error"]
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(server, "/search", None, as_bytes=b"{not json")
    assert exc.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as exc:
        _get(server, "/nope")
    assert exc.value.code == 404


def test_mask_default_is_the_model_pad_id():
    """Tokenizer-less mode: the model's pad id (1 for RoBERTa) drives the
    defaulted mask, never 0."""
    seen = {}

    def spy(ids, mask):
        seen["mask"] = np.asarray(mask).copy()
        return identity_encoder(ids, mask)

    srv = RetrieverHTTPServer(Retriever(spy, _eye_index()), port=0,
                              pad_token_id=1).start()
    try:
        ids = np.ones((1, 4), np.int32)
        ids[0, 1] = 7
        _post(srv, "/search", {"ids": ids.tolist(), "k": 1})
        np.testing.assert_array_equal(seen["mask"], [[0, 1, 0, 0]])
    finally:
        srv.shutdown()


def test_metrics_and_lock_wait():
    class SlowRetriever:
        tokenizer = None
        index = _eye_index()
        embedding2id = None

        def search_tokens(self, ids, mask, k):
            time.sleep(0.03)
            return (np.zeros((len(ids), k), np.float32),
                    np.zeros((len(ids), k), np.int64))

    srv = RetrieverHTTPServer(SlowRetriever(), port=0).start()
    try:
        ids = np.zeros((1, 4), np.int32)
        threads = [threading.Thread(target=_post, args=(
            srv, "/search", {"ids": ids.tolist(), "k": 1}))
            for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        with pytest.raises(urllib.error.HTTPError):
            _post(srv, "/search", {"k": 1})
        _, m = _get(srv, "/metrics")
        assert m["requests"] == 5 and m["queries"] == 4 and m["errors"] == 1
        assert m["latency_ms_ewma"] > 0 and m["lock_wait_ms_total"] > 30.0
    finally:
        srv.shutdown()


def test_reload_flat_gap_and_guards(tmp_path):
    """/reload: hot swap, the .npz path, gap mode, a dim guard, a 400 for
    a malformed IVF artifact, and a real IVF artifact reloaded as IVF."""
    def saved(name, n, dim=8, first=100):
        idx = FlatIPIndex(dim=dim, device="cpu", method="scan")
        idx.add(np.eye(8, dtype=np.float32)[:n, :dim].copy())
        idx.save(str(tmp_path / name))
        np.save(str(tmp_path / name) + ".ids.npy",
                np.arange(first, first + n, dtype=np.int64))
        return str(tmp_path / name)

    p_small, p_full = saved("small", 4), saved("full", 8)
    p_wrong = saved("wrong", 6, dim=4)
    np.savez(str(tmp_path / "ivf.npz"), bins_emb=np.zeros(1), ntotal=1)
    np.save(str(tmp_path / "ivf") + ".ids.npy", np.zeros(1, np.int64))
    r = Retriever(identity_encoder, FlatIPIndex.load(p_small, device="cpu"),
                  embedding2id=np.arange(100, 104, dtype=np.int64))
    srv = RetrieverHTTPServer(r, port=0, pid_space="offset",
                              allow_reload=True).start()
    try:
        ids = np.zeros((1, 4), np.int32)
        ids[0, 1] = 7
        _, body = _post(srv, "/search", {"ids": ids.tolist(), "k": 1})
        assert body["results"][0][0]["pid"] != 107
        status, rep = _post(srv, "/reload", {"index": p_full + ".npz"})
        assert status == 200 and rep["ntotal"] == 8 and rep["kind"] == "flat"
        _, h = _get(srv, "/healthz")
        assert h["ntotal"] == 8 and h["pid_space"] == "real"
        _, body = _post(srv, "/search", {"ids": ids.tolist(), "k": 1})
        assert body["results"][0][0]["pid"] == 107
        for path, match in ((p_wrong, "dim"), (str(tmp_path / "ivf"),
                                               "cannot load"),
                            (str(tmp_path / "missing"), "cannot load")):
            with pytest.raises(urllib.error.HTTPError) as exc:
                _post(srv, "/reload", {"index": path})
            assert exc.value.code == 400
            assert match in json.loads(exc.value.read())["error"]
        ivf = IVFIPIndex(dim=8, nlist=2, nprobe=2, device="cpu")
        ivf.add(np.eye(8, dtype=np.float32))
        ivf.save(str(tmp_path / "real_ivf"))
        np.save(str(tmp_path / "real_ivf") + ".ids.npy",
                np.arange(200, 208, dtype=np.int64))
        status, rep = _post(srv, "/reload",
                            {"index": str(tmp_path / "real_ivf")})
        assert status == 200 and rep["kind"] == "ivf" and rep["ntotal"] == 8
        assert isinstance(r.index, IVFIPIndex)
        _, body = _post(srv, "/search", {"ids": ids.tolist(), "k": 1})
        assert body["results"][0][0]["pid"] == 207
        # a gap reload that fails after releasing the index degrades the
        # server (healthz 500) until a later reload succeeds
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(srv, "/reload", {"index": p_wrong, "gap": True})
        assert exc.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as exc:
            _get(srv, "/healthz")
        assert exc.value.code == 500
        status, rep = _post(srv, "/reload", {"index": p_small, "gap": True})
        assert status == 200 and rep["ntotal"] == 4
        _, m = _get(srv, "/metrics")
        assert m["reloads"] == 3 and m["errors"] == 4
    finally:
        srv.shutdown()
    srv2 = RetrieverHTTPServer(r, port=0).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(srv2, "/reload", {"index": p_full})
        assert "disabled" in json.loads(exc.value.read())["error"]
    finally:
        srv2.shutdown()


# -- the slice: ance_tpu.cli serve vs ance_tpu_torch.cli serve -------------

def _write_cache(path, n, seq, rs):
    from ance_tpu.data.cache import TokenCacheWriter
    with TokenCacheWriter(path, seq) as w:
        for _ in range(n):
            length = int(rs.randint(3, seq + 1))
            toks = np.ones(seq, np.int32)  # RoBERTa pad id 1
            toks[0] = 0
            toks[1:length] = rs.randint(3, TINY["vocab_size"], length - 1)
            w.write(length, toks)


@pytest.fixture(scope="module")
def slice_inputs(tmp_path_factory):
    """Tiny caches (64 passages at seq 16, 16 queries at seq 8) and JAX-
    initialised RobertaDot weights saved as an HF checkpoint directory."""
    import jax
    import jax.numpy as jnp
    from ance_tpu.models.hf_export import save_hf_checkpoint
    from ance_tpu.models.registry import get_model_spec as jax_spec
    from ance_tpu.models.transformer import EncoderConfig as JaxConfig

    root = tmp_path_factory.mktemp("slice")
    rs = np.random.RandomState(0)
    data = root / "data"
    data.mkdir()
    _write_cache(str(data / "passages"), 64, 16, rs)
    _write_cache(str(data / "dev-query"), 16, 8, rs)
    # a wide init (std 0.5, not 0.02) keeps the random tiny encoder from
    # collapsing every text onto one embedding: the rankings then have no
    # near-ties for summation order to flip
    model = jax_spec("rdot_nll").build(
        config_overrides=dict(TINY, initializer_range=0.5))
    ids = jnp.ones((2, 8), jnp.int32)
    params = model.init(jax.random.PRNGKey(7), ids, ids)["params"]
    ckpt = save_hf_checkpoint(root / "ckpt", jax.tree.map(np.asarray, params),
                              JaxConfig(**TINY))
    return root, str(data), ckpt


def _read_ranking(path):
    rows = [line.split("\t") for line in open(path).read().splitlines()]
    return [(int(q), int(p), int(r)) for q, p, r, _ in rows], \
        np.array([float(s) for *_, s in rows])


@pytest.mark.parametrize("quantize", ["none", "dims"])
def test_serve_slice_matches_jax_cli(slice_inputs, quantize):
    """Same weights, same caches, same flags: the rankings agree pid for
    pid and rank for rank. Scores agree within 1e-4 plus 2e-6 relative:
    they are inner products of two LayerNorm'd 768-d embeddings, so
    |score| ≈ 700-770, where one fp32 ulp is 6.1e-5 — 1e-4 alone would be
    under two ulps after two encoders summing in different orders."""
    from ance_tpu.cli import main as jax_main
    from ance_tpu_torch.cli import main as port_main

    root, data, ckpt = slice_inputs
    common = ["serve", "--model_type", "rdot_nll",
              "--model_name_or_path", ckpt,
              "--encoder_overrides", json.dumps(TINY),
              "--data_dir", data, "--query_cache", data + "/dev-query",
              "--max_seq_length", "16", "--max_query_length", "8",
              "--per_device_eval_batch_size", "16", "--topk", "10",
              "--quantize", quantize, "--with_scores"]
    jax_out, port_out = (str(root / f"{who}_{quantize}.tsv")
                         for who in ("jax", "port"))
    jax_main(common + ["--output", jax_out])
    port_main(common + ["--output", port_out, "--device", "cpu",
                        "--save_index", str(root / f"port_{quantize}")])
    jax_rank, jax_scores = _read_ranking(jax_out)
    port_rank, port_scores = _read_ranking(port_out)
    gaps = -np.diff(jax_scores.reshape(16, 10), axis=1)
    assert gaps.min() > 1e-3  # the data has no ties to reorder
    assert len(port_rank) == 16 * 10
    assert port_rank == jax_rank
    close = np.isclose(port_scores, jax_scores, atol=1e-4, rtol=2e-6)
    if quantize == "none":
        assert close.all()
    else:
        # each package quantizes its own embeddings, which differ by ~1e-5:
        # a value that close to a rounding midpoint takes the neighbouring
        # int8 code, moving a score by |q_d|·scale_d (~0.02 here). Allow
        # that on a few scores only.
        assert close.mean() >= 0.95
        np.testing.assert_allclose(port_scores, jax_scores, atol=5e-2,
                                   rtol=0)
    # the saved index serves the same ranking through --load_index
    reload_out = str(root / f"reload_{quantize}.tsv")
    port_main(common[:common.index("--data_dir")] + [
        "--query_cache", data + "/dev-query", "--max_query_length", "8",
        "--topk", "10", "--with_scores", "--device", "cpu",
        "--load_index", str(root / f"port_{quantize}"),
        "--output", reload_out])
    assert _read_ranking(reload_out)[0] == port_rank


def test_serve_cli_refuses_missing_cuda_and_unported_paths(slice_inputs):
    from ance_tpu_torch.cli import main as port_main
    root, data, ckpt = slice_inputs
    base = ["serve", "--model_name_or_path", ckpt, "--data_dir", data,
            "--query_cache", data + "/dev-query",
            "--encoder_overrides", json.dumps(TINY)]
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA is not available"):
            port_main(base)
    with pytest.raises(SystemExit, match="apply to --index ivf only"):
        port_main(base + ["--device", "cpu", "--nprobe", "4"])
    # --training_dir reads the port's checkpoints and the JAX package's
    # msgpack ones (tests/test_torch_native_checkpoint.py); an empty
    # params.msgpack is refused, naming the file
    native = root / "native" / "checkpoint-3"
    native.mkdir(parents=True, exist_ok=True)
    (native / "params.msgpack").write_bytes(b"")
    (native / "DONE").write_text("3")
    with pytest.raises(SystemExit, match=r"checkpoint-3/params\.msgpack: "
                       r"not a flax msgpack checkpoint \(empty\)"):
        port_main(base + ["--device", "cpu", "--training_dir",
                          str(root / "native")])
    # seeddot_nll, refused before its slice: served from a fairseq SEED
    # pytorch_model.bin (the import), the rankings are ``ance serve``'s.
    # The SEED position table keeps its 516 rows: the JAX import pads to
    # 516 whatever the config says
    import jax
    import jax.numpy as jnp
    from ance_tpu.cli import main as jax_main
    from ance_tpu.models.hf_export import torch_seeddot_state_dict
    from ance_tpu.models.seed import seed_dot_model
    seed_geom = dict(TINY, max_position_embeddings=516)
    model = seed_dot_model(out_dim=768,
                           **dict(seed_geom, initializer_range=0.5))
    ids = jnp.ones((2, 8), jnp.int32)
    params = jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(9), ids, ids)["params"])
    seed_dir = root / "seed_fairseq"
    seed_dir.mkdir(exist_ok=True)
    torch.save(torch_seeddot_state_dict(params),
               seed_dir / "pytorch_model.bin")
    common = ["serve", "--model_type", "seeddot_nll", "--model_name_or_path",
              str(seed_dir), "--encoder_overrides", json.dumps(seed_geom),
              "--data_dir", data, "--query_cache", data + "/dev-query",
              "--max_seq_length", "16", "--max_query_length", "8",
              "--topk", "10", "--with_scores"]
    jax_main(common + ["--output", str(root / "seed_jax.tsv")])
    port_main(common + ["--device", "cpu", "--output",
                        str(root / "seed_port.tsv")])
    jax_rank, jax_scores = _read_ranking(str(root / "seed_jax.tsv"))
    port_rank, port_scores = _read_ranking(str(root / "seed_port.tsv"))
    assert -np.diff(jax_scores.reshape(16, 10), axis=1).min() > 1e-3
    assert port_rank == jax_rank and len(port_rank) == 160
    np.testing.assert_allclose(port_scores, jax_scores, atol=1e-4, rtol=2e-6)


def test_serve_from_embedding_shards_matches_jax_cli(slice_inputs):
    """--emb_prefix/--emb_id_prefix: the corpus comes from `infer`-style
    shards (two ranks) instead of an encode; both CLIs rank the same."""
    from ance_tpu.cli import main as jax_main
    from ance_tpu_torch.cli import main as port_main

    root, data, ckpt = slice_inputs
    rs = np.random.RandomState(3)
    emb = rs.randn(40, 768).astype(np.float32)
    ids = np.arange(40, dtype=np.int64)
    for rank, sl in enumerate((slice(0, 25), slice(25, 40))):
        np.save(str(root / f"emb_data_obj_{rank}.npy"), emb[sl])
        np.save(str(root / f"embid_data_obj_{rank}.npy"), ids[sl])
    common = ["serve", "--model_name_or_path", ckpt,
              "--encoder_overrides", json.dumps(TINY),
              "--emb_prefix", str(root / "emb"),
              "--emb_id_prefix", str(root / "embid"),
              "--query_cache", data + "/dev-query", "--max_query_length", "8",
              "--topk", "5", "--with_scores"]
    jax_out, port_out = str(root / "jax_emb.tsv"), str(root / "port_emb.tsv")
    jax_main(common + ["--output", jax_out])
    port_main(common + ["--output", port_out, "--device", "cpu"])
    jax_rank, jax_scores = _read_ranking(jax_out)
    port_rank, port_scores = _read_ranking(port_out)
    assert len(port_rank) == 16 * 5 and port_rank == jax_rank
    np.testing.assert_allclose(port_scores, jax_scores, atol=1e-4, rtol=2e-6)
