"""The learning demos (``ance_tpu_torch/experiments/demo.py``,
``demo_maxp.py``, ``demo_dpr.py``) against the JAX scripts they port
(``docs/tpu_demo.py``, ``tpu_demo_maxp.py``, ``tpu_demo_dpr.py``, loaded
by path with their environment variables set; nothing under ``docs/`` is
written):

  * each task builder's caches byte-identical to the script's at small
    sizes, with equal qrels, signature chunks, passage texts, answers and
    positives; the DPR triples reader drawing the script's negatives;
  * each loop's ``PipelineConfig`` the script's (read from its source);
  * each demo's bootstrap refresh against the JAX ``PipelinedAnce.
    bootstrap`` on the same task and weights (carried by
    ``state_dict_from_flax``; no training, so no dropout): dev NDCG,
    recall and mining MRR within 1e-12, the dev rankings, mining
    candidates and mined triples equal but where two rows of a ranking
    swap places whose scores are closer than the packages' scores of one
    row are (a near-tie ordered by rounding; SEED's encoder at init 0.5
    parts from JAX's by ~3e-5 relative), and at most an eighth of the
    dev queries, and of the triples' queries, so; for DPR, the first ``generate_new_ann_dpr`` with a passed index
    and ``seed=3``: its training file byte-identical to the JAX
    function's, and the run with a bf16 index carrying that index;
  * each demo end to end at a tiny size on the CPU: its log's events and
    keys are the script's.

The encoder is cut to 2 layers of width 64 (the demos' ``SHAPE`` patched)
at init std 0.5, so the rankings hold few near-ties."""

import ast
import dataclasses
import faulthandler
import importlib.util
import itertools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ance_tpu_torch.data.cache import TokenCache
from ance_tpu_torch.experiments import demo, demo_dpr, demo_maxp
from ance_tpu_torch.models.weights import state_dict_from_flax
from ance_tpu_torch.train import pipelined
from ance_tpu_torch.train.trainer import init_train_state

torch.set_num_threads(1)

DOCS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "docs")
TINY_SHAPE = dict(hidden_size=64, num_layers=2, num_heads=4,
                  intermediate_size=128)
E2E_SHAPE = dict(hidden_size=32, num_layers=1, num_heads=2,
                 intermediate_size=64)  # the end-to-end runs' encoder
# small tasks: FirstP keeps the script's 1,024 classes, so > 1,024 passages
FIRSTP = dict(passages=1100, train_q=64, dev_q=32)
MAXP = dict(docs=64, classes=8, train_q=32, dev_q=16)
DPR = dict(passages=128, classes=16, train_q=32, test_q=16, trivia_q=16)
_loaded = itertools.count()


@pytest.fixture(autouse=True)
def _watchdog():
    faulthandler.dump_traceback_later(300, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()


def _script(name, monkeypatch, **env):
    """The JAX script ``docs/<name>.py`` as a fresh module, its environment
    variables set first (its module globals read them)."""
    for k, v in env.items():
        monkeypatch.setenv(k, str(v))
    spec = importlib.util.spec_from_file_location(
        f"_demo_script_{next(_loaded)}", os.path.join(DOCS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for n in names:
        with open(os.path.join(a, n), "rb") as fa, \
                open(os.path.join(b, n), "rb") as fb:
            assert fa.read() == fb.read(), n


def _firstp_script(monkeypatch):
    mod = _script("tpu_demo", monkeypatch, DEMO_PASSAGES=FIRSTP["passages"])
    monkeypatch.setattr(mod, "N_TRAIN_Q", FIRSTP["train_q"])
    monkeypatch.setattr(mod, "N_DEV_Q", FIRSTP["dev_q"])
    return mod


def _maxp_script(monkeypatch):
    return _script("tpu_demo_maxp", monkeypatch, DEMO_DOCS=MAXP["docs"],
                   DEMO_CLASSES=MAXP["classes"], DEMO_TRAIN_Q=MAXP["train_q"],
                   DEMO_DEV_Q=MAXP["dev_q"])


def _dpr_script(monkeypatch):
    return _script("tpu_demo_dpr", monkeypatch,
                   DEMO_PASSAGES=DPR["passages"], DEMO_CLASSES=DPR["classes"],
                   DEMO_TRAIN_Q=DPR["train_q"], DEMO_TEST_Q=DPR["test_q"],
                   DEMO_TRIVIA_Q=DPR["trivia_q"])


def _firstp_task(root):
    return demo.build_corpus(str(root), FIRSTP["passages"],
                             FIRSTP["train_q"], FIRSTP["dev_q"])


def _maxp_task(root):
    return demo_maxp.build_task(str(root), MAXP["docs"], MAXP["classes"],
                                MAXP["train_q"], MAXP["dev_q"])


def _dpr_task(root):
    return demo_dpr.build_task(str(root), DPR["passages"], DPR["classes"],
                               DPR["train_q"], DPR["test_q"],
                               DPR["trivia_q"])


@pytest.mark.parametrize("which", ["firstp", "maxp", "dpr"])
def test_task_data_is_the_scripts(which, monkeypatch, tmp_path):
    """Caches byte for byte, and every other piece of the task equal."""
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    pdir.mkdir()
    if which == "firstp":
        want = _firstp_script(monkeypatch).build_corpus(str(jdir))
        got = _firstp_task(pdir)
        assert got[1:] == want[1:]  # the qrels
    elif which == "maxp":
        want = _maxp_script(monkeypatch).build_task(str(jdir))
        got = _maxp_task(pdir)
        assert got[1:3] == want[1:3]
        np.testing.assert_array_equal(got[3], want[3])  # signature chunks
    else:
        mod = _dpr_script(monkeypatch)
        want = mod.build_task(str(jdir))
        got = _dpr_task(pdir)
        assert got[1] == want[1]  # passage texts by offset
        for n in (DPR["train_q"], DPR["test_q"], 5):
            assert got[2](n) == want[2](n)
        assert got[3] == want[3]
        lines = "".join(f"{q}\t{q % 16}\t{q + 20},{q + 40},{q + 60}\n"
                        for q in range(12))
        (tmp_path / "triples").write_text(lines)
        np.testing.assert_array_equal(
            demo_dpr.parse_triples(str(tmp_path / "triples"),
                                   np.random.RandomState(3)),
            mod.parse_triples(str(tmp_path / "triples"),
                              np.random.RandomState(3)))
    _same_files(jdir, pdir)
    assert [os.path.basename(p) for p in got[0].values()] == \
        [os.path.basename(p) for p in want[0].values()]


def _script_pipeline_config(mod) -> dict:
    """The keyword arguments of the script's ``PipelineConfig(...)`` call,
    names resolved from its module globals."""
    tree = ast.parse(open(mod.__file__).read())
    call = next(n for n in ast.walk(tree) if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == "PipelineConfig")
    return {k.arg: (getattr(mod, k.value.id) if isinstance(k.value, ast.Name)
                    else ast.literal_eval(k.value)) for k in call.keywords}


@pytest.mark.parametrize("which", ["firstp", "maxp"])
def test_pipeline_config_is_the_scripts(which, monkeypatch):
    if which == "firstp":
        mod, cfg = _firstp_script(monkeypatch), demo.pipeline_config()
    else:
        mod, cfg = _maxp_script(monkeypatch), demo_maxp.pipeline_config()
    want = _script_pipeline_config(mod)
    got = dataclasses.asdict(cfg)
    assert {k: got[k] for k in want} == want
    defaults = dataclasses.asdict(pipelined.PipelineConfig())
    assert {k: v for k, v in got.items() if k not in want} == \
        {k: v for k, v in defaults.items() if k not in want}


def _jax_model(kind, base_len=512, init=0.5):
    """The script's encoder in JAX at TINY_SHAPE, fp32, init std 0.5, and
    its flax params."""
    from ance_tpu.models.dot_models import RobertaDot as JaxDot
    from ance_tpu.models.dot_models import BiEncoder as JaxBiEncoder
    from ance_tpu.models.transformer import EncoderConfig as JaxConfig
    shape = dict(TINY_SHAPE, initializer_range=init)
    if kind == "seeddot":
        from ance_tpu.models.seed import seed_dot_model
        jm = seed_dot_model(vocab_size=demo.VOCAB, out_dim=demo.OUT_DIM,
                            config_overrides=shape)
    elif kind == "dpr":
        jm = JaxBiEncoder(JaxConfig(vocab_size=demo.VOCAB, **shape))
    else:
        jm = JaxDot(JaxConfig(vocab_size=demo.VOCAB, **shape),
                    out_dim=demo.OUT_DIM, base_len=base_len)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.zeros((2, demo.QLEN), jnp.int32),
                              jnp.ones((2, demo.QLEN), jnp.int32))["params"]
    return jm, jax.tree.map(np.asarray, params)


def _recorder(monkeypatch):
    """Every dev ranking, mining candidate list ([Q, k] index rows) and
    feed's triples of either package's loop."""
    seen = {w: {"dev": [], "mine": [], "triples": []}
            for w in ("jax", "port")}
    from ance_tpu.train import pipelined as jax_pipelined
    for who, mod in (("jax", jax_pipelined), ("port", pipelined)):
        real = {n: getattr(mod, n) for n in
                ("eval_dev_ndcg", "mine_negatives", "TripletBatches")}

        def eval_dev(nb, *a, _r=real, _s=seen[who], **kw):
            _s["dev"].append(np.asarray(nb))
            return _r["eval_dev_ndcg"](nb, *a, **kw)

        def mine(tq, pids, pos, nb, *a, _r=real, _s=seen[who], **kw):
            _s["mine"].append((np.asarray(tq), np.asarray(nb)))
            return _r["mine_negatives"](tq, pids, pos, nb, *a, **kw)

        def feed(q, p, triples, *a, _r=real, _s=seen[who], **kw):
            _s["triples"].append(np.asarray(triples))
            return _r["TripletBatches"](q, p, triples, *a, **kw)
        monkeypatch.setattr(mod, "eval_dev_ndcg", eval_dev)
        monkeypatch.setattr(mod, "mine_negatives", mine)
        monkeypatch.setattr(mod, "TripletBatches", feed)
    return seen


def _index_rows(index) -> np.ndarray:
    """Either package's fp32 ``FlatIPIndex`` rows."""
    emb = index._emb
    emb = emb.cpu().numpy() if isinstance(emb, torch.Tensor) \
        else np.asarray(jax.device_get(emb))
    return emb[:index.ntotal].astype(np.float64)


def _same_up_to_ties(got, want, s_got, s_want, what):
    """[Q, k] rankings equal but where two rows swap places whose scores
    differ by no more than the packages' scores of one row do (twice the
    largest difference of any score of the query, plus 1e-6 of its top
    score): a near-tie, ordered by rounding. → the rows that differ."""
    assert got.shape == want.shape, what
    moved = []
    for i in np.nonzero((got != want).any(1))[0]:
        tol = 2 * np.abs(s_got[i] - s_want[i]).max() \
            + 1e-6 * np.abs(s_want[i]).max()
        for j in np.nonzero(got[i] != want[i])[0]:
            gap = abs(s_want[i, got[i, j]] - s_want[i, want[i, j]])
            assert gap <= tol, (what, i, j, gap, tol)
        moved.append(i)
    return moved


@pytest.mark.parametrize("kind", ["rdot", "seeddot", "maxp"])
def test_bootstrap_is_the_jax_loops(kind, monkeypatch, tmp_path):
    """The demo's ``PipelinedAnce`` (its config, optimizer and in-batch
    step) against the JAX script's, both bootstrapped on the same task and
    weights: the first refresh's metrics, dev rankings and triples."""
    from ance_tpu.data.cache import TokenCache as JaxCache
    from ance_tpu.models.dot_models import RobertaDot as JaxDot
    from ance_tpu.optim.schedules import warmup_linear as jax_warmup
    from ance_tpu.train import pipelined as jax_pipelined
    from ance_tpu.train.dpr_trainer import (biencoder_loss_fn,
                                            make_dpr_train_step)
    from ance_tpu.train.encode import make_encode_fn
    from ance_tpu.train.trainer import init_train_state as jax_state
    from ance_tpu.train.trainer import make_optimizer
    from ance_tpu_torch.models.dot_models import RobertaDot
    from ance_tpu_torch.train.dpr_trainer import make_dpr_train_step as step
    monkeypatch.setattr(demo, "SHAPE", TINY_SHAPE)
    maxp = kind == "maxp"
    if maxp:
        paths, train_qrels, dev_qrels, _ = _maxp_task(tmp_path)
        corpus, cfg = "docs", demo_maxp.pipeline_config()
        jm, params = _jax_model("rdot", base_len=demo_maxp.CHUNK_LEN)
        pm = demo.build_model("rdot", torch.float32,
                              base_len=demo_maxp.CHUNK_LEN)
        jbody, pbody = JaxDot.body_emb_multichunk, \
            RobertaDot.body_emb_multichunk
    else:
        paths, train_qrels, dev_qrels = _firstp_task(tmp_path)
        corpus, cfg = "passages", demo.pipeline_config()
        jm, params = _jax_model(kind)
        pm = demo.build_model(kind, torch.float32)
        jbody, pbody = JaxDot.body_emb, RobertaDot.body_emb
    pm.load_state_dict(state_dict_from_flax(params), strict=True)
    seen = _recorder(monkeypatch)

    opt = make_optimizer("lamb", jax_warmup(demo.LR, demo.LR_WARMUP,
                                            demo.LR_TOTAL))
    jcaches = {n: JaxCache(p).open() for n, p in paths.items()}
    jloop = jax_pipelined.PipelinedAnce(
        jax_pipelined.PipelineConfig(**dataclasses.asdict(cfg)),
        state=jax_state(jax.tree.map(jnp.asarray, params), opt),
        train_step=make_dpr_train_step(biencoder_loss_fn(jm), opt),
        rng=jax.random.PRNGKey(1), params_of=lambda s: s.params,
        query_encode_fn=make_encode_fn(jm, JaxDot.query_emb),
        body_encode_fn=make_encode_fn(jm, jbody),
        passage_cache=jcaches[corpus],
        train_query_cache=jcaches["train-query"],
        dev_query_cache=jcaches["dev-query"], train_qrels=train_qrels,
        dev_qrels=dev_qrels)
    caches = {n: TokenCache(p).open() for n, p in paths.items()}
    ploop = demo.make_loop(cfg, init_train_state(pm, demo.demo_optimizer(pm)),
                           step(multichunk=maxp), caches, corpus,
                           train_qrels, dev_qrels, "cpu", body_method=pbody)
    want, got = jloop.bootstrap(), ploop.bootstrap()
    assert ploop.schedule_trace == jloop.schedule_trace
    assert set(got) == set(want)
    for key in ("refresh", "num_triples", "step"):
        assert got[key] == want[key], key
    for key in ("dev_ndcg", "dev_recall", "ann_mrr"):
        assert got[key] == pytest.approx(want[key], abs=1e-12), key
    assert got["num_triples"] > 0

    # rankings and triples: equal but where rounding orders a near-tie
    from ance_tpu.train.encode import encode_cache as jax_encode
    from ance_tpu_torch.train.encode import encode_cache
    qfn = make_encode_fn(jm, JaxDot.query_emb)
    emb = {}
    for name in ("dev-query", "train-query"):
        jq, _ = jax_encode(qfn, params, jcaches[name], 256)
        pq, _ = encode_cache(ploop.qfn, caches[name], 256)
        emb[name] = (pq.astype(np.float64), jq.astype(np.float64))
    rows = (_index_rows(ploop.index), _index_rows(jloop.index))
    (pdev,), (jdev,) = seen["port"]["dev"], seen["jax"]["dev"]
    moved = _same_up_to_ties(pdev, jdev, emb["dev-query"][0] @ rows[0].T,
                             emb["dev-query"][1] @ rows[1].T, "dev")
    assert len(moved) <= len(pdev) // 8
    (ptq, pnb), (jtq, jnb) = seen["port"]["mine"][0], seen["jax"]["mine"][0]
    np.testing.assert_array_equal(ptq, jtq)
    sp, sj = (emb["train-query"][w][ptq] @ rows[w].T for w in (0, 1))
    moved = {int(ptq[i]) for i in _same_up_to_ties(pnb, jnb, sp, sj,
                                                   "mining")}
    # a query's sampled negatives differ only where its candidates swapped
    (pt,), (jt,) = seen["port"]["triples"], seen["jax"]["triples"]
    np.testing.assert_array_equal(pt[:, 0], jt[:, 0])
    differ = set(pt[(pt != jt).any(1), 0].tolist())
    assert differ <= moved and len(differ) <= len(ptq) // 8


def test_dpr_generate_with_a_passed_index_and_seed(monkeypatch, tmp_path):
    """The DPR demo's generate pass on its task: with a passed fp32 index
    and ``seed=3`` the training file and sidecar are byte for byte the JAX
    function's (and ``seed`` reorders the lines: seed 0 writes the same
    lines in another order); with a passed bf16 index the run goes
    through and the result carries that index."""
    from ance_tpu.index.flat import FlatIPIndex as JaxIndex
    from ance_tpu.models.dot_models import BiEncoder as JaxBiEncoder
    from ance_tpu.train.dpr_gen import generate_new_ann_dpr as jax_generate
    from ance_tpu.train.encode import make_encode_fn as jax_encode_fn
    from ance_tpu_torch.index.flat import FlatIPIndex
    from ance_tpu_torch.models.dot_models import BiEncoder
    from ance_tpu_torch.train.dpr_gen import generate_new_ann_dpr
    from ance_tpu_torch.train.encode import make_encode_fn
    paths, texts, answers, positives = _dpr_task(tmp_path)
    jm, params = _jax_model("dpr")
    monkeypatch.setattr(demo, "SHAPE", TINY_SHAPE)
    pm = demo_dpr.build_model(torch.float32).eval()
    pm.load_state_dict(state_dict_from_flax(params), strict=True)
    dim = TINY_SHAPE["hidden_size"]
    kw = dict(checkpoint_path="cycle0", passage_texts=texts,
              train_answers=answers(DPR["train_q"]),
              test_answers=answers(DPR["test_q"]),
              trivia_test_answers=answers(DPR["trivia_q"]),
              training_query_positive_id=positives, topk_training=200,
              negative_sample=8, dev_search_depth=100,
              encode_batch_size=512)

    def caches(cls):
        return dict(zip(("passage_cache", "train_query_cache",
                         "test_query_cache", "trivia_test_query_cache"),
                        (cls(paths[n]).open() for n in
                         ("passages",) + demo_dpr.QUERY_CACHES)))
    from ance_tpu.data.cache import TokenCache as JaxCache
    want = jax_generate(
        output_num=0, params=params, output_dir=str(tmp_path / "jax"),
        query_encode_fn=jax_encode_fn(jm, JaxBiEncoder.query_emb),
        body_encode_fn=jax_encode_fn(jm, JaxBiEncoder.body_emb),
        index=JaxIndex(dim=dim, dtype=jnp.float32), seed=3,
        **caches(JaxCache), **kw)
    qfn = make_encode_fn(pm, BiEncoder.query_emb, "cpu")
    bfn = make_encode_fn(pm, BiEncoder.body_emb, "cpu")
    results = {}
    for name, index, seed in (
            ("port", FlatIPIndex(dim=dim, device="cpu"), 3),
            ("seed0", FlatIPIndex(dim=dim, device="cpu"), 0),
            ("bf16", FlatIPIndex(dim=dim, device="cpu",
                                 dtype=torch.bfloat16), 3)):
        results[name] = generate_new_ann_dpr(
            output_num=0, query_encode_fn=qfn, body_encode_fn=bfn,
            output_dir=str(tmp_path / name), device="cpu", index=index,
            seed=seed, **caches(TokenCache), **kw)
        assert results[name]["index"] is index
    _same_files(tmp_path / "jax", tmp_path / "port")
    for key in ("top20", "top100", "top20_trivia", "top100_trivia"):
        assert results["port"][key] == want[key]
    port = open(results["port"]["data_path"]).read().splitlines()
    seed0 = open(results["seed0"]["data_path"]).read().splitlines()
    assert sorted(port) == sorted(seed0) and port != seed0
    bf16 = results["bf16"]
    assert bf16["index"].dtype == torch.bfloat16 and bf16["index"].ntotal \
        == DPR["passages"]
    assert 0.0 <= bf16["top20"] <= bf16["top100"] <= 1.0
    assert open(bf16["data_path"]).read().count("\n") > 0


def _script_events(mod) -> dict:
    """event → (its literal keys in order, whether a loop history entry is
    spread into it), from the script's ``{"event": ...}`` dict literals."""
    out = {}
    for node in ast.walk(ast.parse(open(mod.__file__).read())):
        if not isinstance(node, ast.Dict):
            continue
        keys = [k.value if isinstance(k, ast.Constant) else None
                for k in node.keys]
        if "event" not in keys:
            continue
        event = node.values[keys.index("event")].value
        out[event] = ([k for k in keys if k is not None], None in keys)
    return out


@pytest.mark.parametrize("which", ["firstp", "seeddot", "maxp", "dpr"])
def test_demo_log_has_the_scripts_events(which, monkeypatch, tmp_path):
    """Each demo at a tiny size on the CPU (``--device cpu --dtype fp32``,
    the encoder cut to one layer of width 32, batches of 2 to 4, enough
    warmup steps for a warmup line and loop steps for a refresh): every
    event of the script's log, each
    with the script's keys in its order (a history entry's keys where the
    script spreads one; the start line adds the card's name and power
    limit), and no other."""
    monkeypatch.setattr(demo, "SHAPE", E2E_SHAPE)
    log = tmp_path / "run.jsonl"
    common = ["--device", "cpu", "--dtype", "fp32", "--log", str(log)]
    if which in ("firstp", "seeddot"):
        mod = _firstp_script(monkeypatch)
        out = demo.main([
            "--model", "seeddot" if which == "seeddot" else "rdot",
            "--passages", str(FIRSTP["passages"]), "--train_q", "16",
            "--dev_q", "8", "--warm", "100", "--steps", "64", "--batch",
            "2"] + common)
    elif which == "maxp":
        mod = _maxp_script(monkeypatch)
        out = demo_maxp.main([
            "--docs", str(MAXP["docs"]), "--classes", str(MAXP["classes"]),
            "--train_q", "8", "--dev_q", "8", "--warm", "200", "--steps",
            "64", "--batch", "2"] + common)
    else:
        mod = _dpr_script(monkeypatch)
        out = demo_dpr.main([
            "--passages", str(DPR["passages"]), "--classes",
            str(DPR["classes"]), "--train_q", str(DPR["train_q"]),
            "--test_q", str(DPR["test_q"]), "--trivia_q",
            str(DPR["trivia_q"]), "--cycles", "2", "--steps", "4",
            "--batch", "4"] + common)
    records = [json.loads(line) for line in open(log)]
    want = _script_events(mod)
    assert {r["event"] for r in records} == set(want)
    assert records[0]["event"] == "start" and records[-1]["event"] == "done"
    entries = [set(h) for h in out["history"]] if which != "dpr" else []
    for r in records:
        keys, spread = want[r["event"]]
        got = list(r)
        if r["event"] == "start":
            assert got[len(keys):] == ["device", "power_limit"]
            assert r["device"] == "cpu"
            got = got[:len(keys)]
        assert got[:len(keys)] == keys, r["event"]
        extra = set(got[len(keys):])
        assert extra in entries if spread else not extra, r["event"]
