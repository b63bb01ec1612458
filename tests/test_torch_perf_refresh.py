"""``ance_tpu_torch/experiments/perf_refresh8m8.py`` against the JAX script
it ports (``docs/perf_refresh8m8_r5.py``, loaded by path; nothing under
``docs/`` is written):

  * ``build_cache`` byte for byte, data and ``_meta``, at 70,000 records
    (two of its 65,536-row chunks), and ``perf_feed_r5.py``'s writer too;
  * ``gap_pcts`` on the same gaps;
  * the ``PipelineConfig`` (read from the script's source);
  * the bootstrap under that config at a tiny width (2 layers, width 64,
    2,048 passages, slice 256, batch 8, init std 0.5, fp32, the ``dims``
    index) against the JAX ``PipelinedAnce`` on the same weights: the same
    schedule and ``num_triples``, and the mined triples equal but where
    rounding orders a near-tie;
  * the whole script at that size on the CPU, every stage's keys.
"""

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

from ance_tpu_torch.data.feed import live_feed_threads
from ance_tpu_torch.experiments import perf_refresh8m8 as pr
from ance_tpu_torch.models.weights import state_dict_from_flax
from ance_tpu_torch.train import pipelined

torch.set_num_threads(1)

DOCS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "docs")
TINY = dict(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
            initializer_range=0.5)
SIZE = dict(passages=2048, train_q=512, dev_q=64, slice=256, batch=8)
_loaded = itertools.count()


@pytest.fixture(autouse=True)
def _watchdog():
    faulthandler.dump_traceback_later(300, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()


def script(name):
    """``docs/<name>.py`` as a fresh module."""
    spec = importlib.util.spec_from_file_location(
        f"_perf_script_{next(_loaded)}", os.path.join(DOCS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def script_pipeline_config(mod) -> dict:
    """The keyword arguments of the script's ``PipelineConfig(...)`` call,
    names resolved from its module globals."""
    tree = ast.parse(open(mod.__file__).read())
    call = next(n for n in ast.walk(tree) if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == "PipelineConfig")
    return {k.arg: (getattr(mod, k.value.id) if isinstance(k.value, ast.Name)
                    else ast.literal_eval(k.value)) for k in call.keywords}


@pytest.mark.parametrize("name,seq", [("perf_refresh8m8_r5", 128),
                                      ("perf_feed_r5", 64)])
def test_build_cache_is_the_scripts(name, seq, tmp_path):
    n = 70_000
    script(name).build_cache(str(tmp_path / "jax"), n, seq)
    built = pr.build_cache(str(tmp_path / "port"), n, seq)
    assert built["gb"] == pytest.approx(n * (4 + 4 * seq) / 1e9)
    for suffix in ("", "_meta"):
        assert (tmp_path / f"port{suffix}").read_bytes() == \
            (tmp_path / f"jax{suffix}").read_bytes(), suffix
    # kept as it is when asked again; rebuilt at another size
    assert pr.build_cache(str(tmp_path / "port"), n, seq) is None
    assert pr.build_cache(str(tmp_path / "port"), 10, seq) is not None
    assert os.path.getsize(tmp_path / "port") == 10 * (4 + 4 * seq)


def test_gap_pcts_is_the_scripts():
    gaps = list(np.random.RandomState(4).gamma(2.0, 0.3, 1107)) + [5.25]
    assert pr.gap_pcts(gaps) == script("perf_refresh8m8_r5").gap_pcts(gaps)


def test_pipeline_config_is_the_scripts():
    want = script_pipeline_config(script("perf_refresh8m8_r5"))
    got = dataclasses.asdict(pr.pipeline_config())
    assert {k: got[k] for k in want} == want
    defaults = dataclasses.asdict(pipelined.PipelineConfig())
    assert {k: v for k, v in got.items() if k not in want} == \
        {k: v for k, v in defaults.items() if k not in want}
    assert pr.capacity_rows(pr.MSMARCO_PASSAGES) == 8_847_360 == 270 * 32_768


def _index_scores(index, queries) -> np.ndarray:
    """[Q, N] fp64 scores of either package's ``dims`` index: the queries
    with the per-dim scales folded in, against the int8 codes."""
    emb, scales = index._emb, index._scales
    if isinstance(emb, torch.Tensor):
        emb, scales = emb.numpy(), scales.numpy()
    emb = np.asarray(emb)[:index.ntotal].astype(np.float64)
    return (queries.astype(np.float64) * np.asarray(scales, np.float64)) \
        @ emb.T


def test_bootstrap_is_the_jax_scripts(monkeypatch, tmp_path):
    """The port's loop and the JAX script's on the same weights, caches
    and config (slice and batch cut), the ``dims`` index: the same
    schedule and ``num_triples``, the dev metrics within 1e-12, and the
    mining candidates and mined triples equal but where two candidates
    swap places whose scores lie closer than the two packages' scores of
    one row do (``test_torch_demo._same_up_to_ties``). The encoders part
    by fp32 rounding, which flips a few int8 codes by one step and moves
    the per-dim scales slightly: at these random tokens most queries
    hold such a swap among their 200 candidates, and a few mined triples
    differ, at most an eighth of the queries'."""
    from ance_tpu.data.cache import TokenCache as JaxCache
    from ance_tpu.models.dot_models import RobertaDot as JaxDot
    from ance_tpu.models.transformer import EncoderConfig as JaxConfig
    from ance_tpu.optim.schedules import warmup_linear as jax_warmup
    from ance_tpu.train import pipelined as jax_pipelined
    from ance_tpu.train.encode import encode_cache as jax_encode
    from ance_tpu.train.encode import make_encode_fn
    from ance_tpu.train.trainer import (init_train_state, make_optimizer,
                                        make_train_step, triplet_loss_fn)
    from ance_tpu_torch.train.encode import encode_cache
    from test_torch_demo import _same_up_to_ties
    mod = script("perf_refresh8m8_r5")
    paths, _ = pr.build_caches(str(tmp_path), SIZE["passages"],
                               SIZE["train_q"], SIZE["dev_q"])
    jm = JaxDot(JaxConfig(**TINY), out_dim=768)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.zeros((2, mod.QLEN), jnp.int32),
                              jnp.ones((2, mod.QLEN), jnp.int32))["params"]
    params = jax.tree.map(np.asarray, params)

    seen = {w: {"mine": [], "triples": []} for w in ("jax", "port")}
    for who, m in (("jax", jax_pipelined), ("port", pipelined)):
        real = {n: getattr(m, n) for n in ("TripletBatches",
                                           "mine_negatives")}

        def feed(q, p, t, *a, _r=real, _s=seen[who], **kw):
            _s["triples"].append(np.asarray(t))
            return _r["TripletBatches"](q, p, t, *a, **kw)

        def mine(tq, pids, pos, nb, *a, _r=real, _s=seen[who], **kw):
            _s["mine"].append((np.asarray(tq), np.asarray(nb)))
            return _r["mine_negatives"](tq, pids, pos, nb, *a, **kw)
        monkeypatch.setattr(m, "TripletBatches", feed)
        monkeypatch.setattr(m, "mine_negatives", mine)

    cfg = dict(script_pipeline_config(mod),
               encode_slice_size=SIZE["slice"], batch_size=SIZE["batch"])
    opt = make_optimizer("lamb", jax_warmup(pr.LR, pr.LR_WARMUP, pr.LR_TOTAL))
    jc = {n: JaxCache(p).open() for n, p in paths.items()}
    n_p = SIZE["passages"]
    qfn = make_encode_fn(jm, JaxDot.query_emb)
    jloop = jax_pipelined.PipelinedAnce(
        jax_pipelined.PipelineConfig(**cfg),
        state=init_train_state(jax.tree.map(jnp.asarray, params), opt),
        train_step=make_train_step(triplet_loss_fn(jm), opt),
        rng=jax.random.PRNGKey(1), params_of=lambda s: s.params,
        query_encode_fn=qfn,
        body_encode_fn=make_encode_fn(jm, JaxDot.body_emb),
        passage_cache=jc["passages"], train_query_cache=jc["train-query"],
        dev_query_cache=jc["dev-query"],
        train_qrels={q: {q % n_p: 1} for q in range(SIZE["train_q"])},
        dev_qrels={q: {q % n_p: 1} for q in range(SIZE["dev_q"])})

    pm = pr.build_model(torch.float32, "cpu", TINY)
    pm.load_state_dict(state_dict_from_flax(params), strict=True)
    ploop, caches = pr.make_loop(
        pr.pipeline_config(SIZE["batch"], "dims", SIZE["slice"]), pm, paths,
        "cpu")
    want, got = jloop.bootstrap(), ploop.bootstrap()
    assert "".join(ploop.schedule_trace) == "".join(jloop.schedule_trace) \
        == "E" * 8 + "DSVQMF"
    assert got["num_triples"] == want["num_triples"] > 0
    for key in ("dev_ndcg", "dev_recall", "ann_mrr"):
        assert got[key] == pytest.approx(want[key], abs=1e-12), key
    assert ploop.index.quantize == "dims" and ploop.index.ntotal == n_p

    (ptq, pnb), = seen["port"]["mine"]
    (jtq, jnb), = seen["jax"]["mine"]
    np.testing.assert_array_equal(ptq, jtq)
    pq, _ = encode_cache(ploop.qfn, caches["train-query"], 128)
    jq, _ = jax_encode(qfn, params, jc["train-query"], 128)
    moved = {int(ptq[i]) for i in _same_up_to_ties(
        pnb, jnb, _index_scores(ploop.index, pq[ptq]),
        _index_scores(jloop.index, jq[ptq]), "mining")}
    (pt,), (jt,) = seen["port"]["triples"], seen["jax"]["triples"]
    np.testing.assert_array_equal(pt[:, :2], jt[:, :2])
    differ = set(pt[(pt != jt).any(1), 0].tolist())
    assert differ <= moved and len(differ) <= len(ptq) // 8
    ploop.close()
    for c in caches.values():
        c.close()


def test_script_runs_on_the_cpu(tmp_path, capsys):
    """The whole script at the tiny size: every stage in order with its
    keys, the mining sample equal to the scan, no feed thread left."""
    argv = ["--device", "cpu", "--dtype", "fp32", "--root",
            str(tmp_path / "caches"), "--log", str(tmp_path / "log.jsonl"),
            "--passages", str(SIZE["passages"]), "--train_q",
            str(SIZE["train_q"]), "--dev_q", str(SIZE["dev_q"]), "--batch",
            str(SIZE["batch"]), "--slice", str(SIZE["slice"]),
            "--no_refresh_steps", "3", "--preflight_passages", "300",
            "--encoder_overrides", json.dumps(TINY)]
    out = pr.main(argv)
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    logged = [json.loads(x) for x in
              (tmp_path / "log.jsonl").read_text().splitlines()]
    assert printed == logged
    assert [x["stage"] for x in logged] == [
        "device", "preflight", "build_cache", "bootstrap", "warm_step",
        "cycle", "train_no_refresh", "mining_vs_scan", "kernels", "done"]
    stages = {x["stage"]: x for x in logged}
    assert [c["index"] for c in stages["preflight"]["cases"]] == \
        ["dims", "fp32"]
    assert stages["preflight"]["cases"][0]["capacity_rows"] == 32_768
    boot = stages["bootstrap"]
    assert {"wall_min", "ntotal", "steps_per_cycle", "num_triples",
            "work_items"} <= set(boot)
    assert boot["ntotal"] == SIZE["passages"]
    assert boot["steps_per_cycle"] == boot["work_items"] * 4 == 14 * 4
    cyc = stages["cycle"]
    assert cyc["steps"] == boot["steps_per_cycle"] and cyc["refreshes"] == 1
    assert set(cyc["step_gap"]) == {"n", "p50_s", "p90_s", "p99_s", "max_s"}
    assert cyc["step_gap"]["n"] == cyc["steps"] - 1
    assert cyc["gap_source"] == "host_clock"
    assert set(cyc["item_times"]) == set("EDSVQMF")
    assert cyc["item_times"]["E"]["n"] == 8
    assert {"int8_clip_frac", "int8_scale_widenings"} <= set(cyc)
    assert "refresh_throughput_cost_pct" in stages["train_no_refresh"]
    assert stages["mining_vs_scan"]["equal"] is True
    assert stages["mining_vs_scan"]["queries"] == pr.SAMPLE_QUERIES
    k = stages["kernels"]
    assert k["searches"] == 4 and k["Q"] == 128 and k["max_abs_err"] == 0.0
    assert k["ms"] is None and k["bound_by"] == "operations"
    assert stages["done"]["feed_threads_after_close"] == 0
    assert live_feed_threads() == 0
    assert out["cycle"][0] == cyc
