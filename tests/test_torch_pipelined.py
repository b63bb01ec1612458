"""The port's pipelined refresh (``ance_tpu_torch/train/pipelined.py``,
``serve.LoopRetriever``, ``cli ance-loop``) against the JAX package's on the
same weights, caches and qrels (``tests/test_ann_loop.py``'s task, 2 layers
of width 32, dropout off): the bootstrap refresh in both index modes, a
run through one full cycle, and the two CLIs. Then the port's own
counterparts of ``tests/test_pipelined.py``'s cases: interleaving, the
edge cases, the int8 clip guard, rewarmup, asynchronous checkpoints and
resume, MaxP, and live serving across a refresh and under load."""

import json
import os
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ance_tpu.train import pipelined as jax_pipelined
from ance_tpu_torch.data.cache import TokenCache
from ance_tpu_torch.models.dot_models import RobertaDot
from ance_tpu_torch.optim.schedules import warmup_linear
from ance_tpu_torch.train import checkpoint as ckpt
from ance_tpu_torch.train import pipelined, trainer
from ance_tpu_torch.train.pipelined import PipelineConfig, PipelinedAnce
from test_ann_loop import N_PASSAGES, QLEN, VOCAB
from test_torch_ann_gen import _vocab_task
from test_torch_train import _assert_params_close

torch.set_num_threads(1)

CACHES = ("passages", "train-query", "dev-query")
# 64 passages in 4 slices, then D S V Q M F: 10 items a cycle
SMALL = dict(train_steps_per_slice=4, encode_slice_size=16,
             encode_batch_size=16, batch_size=16, topk_training=32,
             negative_sample=8, ann_chunk_factor=1, dev_search_depth=32,
             feed_workers=0)
LR = dict(base=5e-3, warmup=10, total=20000)


@pytest.fixture(scope="module")
def jax_parts():
    """One JAX encoder geometry (its jitted encode functions and train step
    shared by every test, so each compiles once) and its LAMB."""
    from ance_tpu.models.dot_models import RobertaDot as JaxDot
    from ance_tpu.models.transformer import EncoderConfig as JaxConfig
    from ance_tpu.optim.schedules import warmup_linear as jax_warmup
    from ance_tpu.train.encode import make_encode_fn
    from ance_tpu.train.trainer import (make_optimizer, make_train_step,
                                        triplet_loss_fn)
    jmodel = JaxDot(JaxConfig(vocab_size=VOCAB, hidden_size=32, num_layers=2,
                              num_heads=4, intermediate_size=64,
                              max_position_embeddings=32, pad_token_id=1,
                              hidden_dropout=0.0, attention_dropout=0.0),
                    out_dim=16)
    opt = make_optimizer("lamb", jax_warmup(LR["base"], LR["warmup"],
                                            LR["total"]))
    return {"qfn": make_encode_fn(jmodel, JaxDot.query_emb),
            "bfn": make_encode_fn(jmodel, JaxDot.body_emb),
            "opt": opt,
            "step": make_train_step(triplet_loss_fn(jmodel), opt)}


def _caches(paths, cls=TokenCache):
    return {n: cls(paths[n]).open() for n in CACHES}


def _port_loop(cfg, model, paths, train_qrels, dev_qrels, body=None,
               optimizer=None):
    state = trainer.init_train_state(model, optimizer or trainer.make_optimizer(
        model, "lamb", warmup_linear(LR["base"], LR["warmup"], LR["total"])))
    caches = _caches(paths)
    return PipelinedAnce(
        cfg, state=state,
        train_step=trainer.make_train_step(trainer.triplet_loss_fn()),
        generator=torch.Generator().manual_seed(3),
        query_method=RobertaDot.query_emb,
        body_method=body or RobertaDot.body_emb,
        passage_cache=caches["passages"],
        train_query_cache=caches["train-query"],
        dev_query_cache=caches["dev-query"], train_qrels=train_qrels,
        dev_qrels=dev_qrels, device="cpu")


def _pair(tmp_path, jax_parts, init_range, **cfg):
    """(JAX loop, port loop) from the same JAX-initialised weights."""
    from ance_tpu.data.cache import TokenCache as JaxCache
    from ance_tpu.train.trainer import init_train_state
    paths, train_qrels, dev_qrels, model, _, params = _vocab_task(
        tmp_path, init_range)
    caches = _caches(paths, JaxCache)
    jloop = jax_pipelined.PipelinedAnce(
        jax_pipelined.PipelineConfig(**cfg),
        state=init_train_state(jax.tree.map(jnp.asarray, params),
                               jax_parts["opt"]),
        train_step=jax_parts["step"], rng=jax.random.PRNGKey(3),
        params_of=lambda s: s.params, query_encode_fn=jax_parts["qfn"],
        body_encode_fn=jax_parts["bfn"], passage_cache=caches["passages"],
        train_query_cache=caches["train-query"],
        dev_query_cache=caches["dev-query"], train_qrels=train_qrels,
        dev_qrels=dev_qrels)
    return jloop, _port_loop(PipelineConfig(**cfg), model.train(), paths,
                             train_qrels, dev_qrels)


def _record(monkeypatch):
    """Every dev ranking (the neighbours eval_dev_ndcg gets) and every feed's
    triples, of either package's loop."""
    seen = {"jax": {"dev": [], "triples": []},
            "port": {"dev": [], "triples": []}}
    for who, mod in (("jax", jax_pipelined), ("port", pipelined)):
        real_eval, real_feed = mod.eval_dev_ndcg, mod.TripletBatches

        def eval_dev(nb, *args, _real=real_eval, _seen=seen[who], **kw):
            _seen["dev"].append(np.asarray(nb))
            return _real(nb, *args, **kw)

        def feed(q, p, triples, *args, _real=real_feed, _seen=seen[who],
                 **kw):
            _seen["triples"].append(np.asarray(triples))
            return _real(q, p, triples, *args, **kw)

        monkeypatch.setattr(mod, "eval_dev_ndcg", eval_dev)
        monkeypatch.setattr(mod, "TripletBatches", feed)
    return seen


def _assert_same_refreshes(jloop, ploop, seen):
    assert ploop.schedule_trace == jloop.schedule_trace
    assert len(ploop.history) == len(jloop.history)
    for got, want in zip(ploop.history, jloop.history):
        assert set(got) == set(want)
        for key in ("refresh", "num_triples", "step",
                    "int8_scale_widenings"):
            assert got.get(key) == want.get(key), key
        for key in ("dev_ndcg", "dev_recall", "ann_mrr", "int8_clip_frac"):
            if key in want:
                assert got[key] == pytest.approx(want[key], abs=1e-12,
                                                 rel=0), key
    for kind in ("dev", "triples"):
        assert len(seen["port"][kind]) == len(seen["jax"][kind]) > 0
        for got, want in zip(seen["port"][kind], seen["jax"][kind]):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("quantize", [None, "dims"])
def test_bootstrap_matches_jax(tmp_path, jax_parts, monkeypatch, quantize):
    """The bootstrap refresh of both loops on the same weights (init std
    0.5, so no near-ties): the same schedule, dev rankings and mined
    triples id for id, and dev NDCG, recall and MRR within 1e-12; the index
    buffers within 1e-5 (fp32), or for ``dims`` the scales within that
    bound carried through (1.5/127)·max|emb| and every code within one step
    (rounding half to even of values a few ulps apart)."""
    seen = _record(monkeypatch)
    jloop, ploop = _pair(tmp_path, jax_parts, 0.5, index_quantize=quantize,
                         **SMALL)
    jloop.bootstrap()
    ploop.bootstrap()
    assert "".join(ploop.schedule_trace) == "EEEEDSVQMF"
    _assert_same_refreshes(jloop, ploop, seen)
    assert ploop.history[0]["num_triples"] > 0
    got = ploop.index._emb.numpy()
    want = np.asarray(jloop.index._emb)
    assert got.shape == want.shape == (N_PASSAGES, 16)
    if quantize is None:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        return
    assert got.dtype == want.dtype == np.int8
    np.testing.assert_allclose(ploop.index._scales.numpy(),
                               np.asarray(jloop.index._scales),
                               atol=1e-5 * 1.5 / 127.0, rtol=0)
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    assert ploop.history[0]["int8_clip_frac"] == \
        jloop.history[0]["int8_clip_frac"]


def test_one_full_cycle_matches_jax(tmp_path, jax_parts, monkeypatch):
    """Bootstrap and one full cycle (2 slices: 8 items of 2 steps) at init
    std 0.2, the step-parity tests' (at 0.05 this tiny encoder's
    embeddings nearly collapse, and 2% of the bootstrap's dev ranking
    positions are near-ties that the two fp32 encoders order apart; at
    0.1 and above none): the same schedule and triples, every
    step's loss within 1e-4 + 1e-5 relative and the final parameters within
    ``_assert_params_close`` (tests/test_torch_train.py's step parity)."""
    seen = _record(monkeypatch)
    cfg = dict(SMALL, train_steps_per_slice=2, encode_slice_size=32)
    jloop, ploop = _pair(tmp_path, jax_parts, 0.2, **cfg)
    losses = {"jax": [], "port": []}
    for who, loop in (("jax", jloop), ("port", ploop)):
        step = loop.train_step

        def recording(state, batch, rng, _step=step, _out=losses[who]):
            state, metrics = _step(state, batch, rng)
            _out.append(float(metrics["loss"]))
            return state, metrics
        loop.train_step = recording
        loop.run(16)
    assert "".join(ploop.schedule_trace) == "EEDSVQMF" + "".join(
        "TT" + tag for tag in "EEDSVQMF")
    assert ploop.refresh_no == jloop.refresh_no == 2
    _assert_same_refreshes(jloop, ploop, seen)
    np.testing.assert_allclose(losses["port"], losses["jax"], atol=1e-4,
                               rtol=1e-5)
    assert ploop.history[1]["mean_loss"] == pytest.approx(
        jloop.history[1]["mean_loss"], abs=1e-4, rel=1e-5)
    from ance_tpu_torch.models.weights import state_dict_from_flax
    want = state_dict_from_flax(jax.tree.map(np.asarray, jloop.state.params))
    lr_sum = sum(warmup_linear(LR["base"], LR["warmup"], LR["total"])(i)
                 for i in range(16))
    _assert_params_close(ploop.state.model.state_dict(), want, lr_sum)
    # the snapshot F took is the trained model, frozen apart from it
    snap = ploop.snapshot
    assert not snap.training and not any(p.requires_grad
                                         for p in snap.parameters())
    for key, value in ploop.state.model.state_dict().items():
        assert torch.equal(snap.state_dict()[key], value), key
    assert snap.state_dict()["norm.weight"].data_ptr() != \
        ploop.state.model.state_dict()["norm.weight"].data_ptr()


GEOMETRY = {"num_layers": 2, "hidden_size": 32, "num_heads": 4,
            "intermediate_size": 64, "vocab_size": VOCAB,
            "max_position_embeddings": 32, "hidden_dropout": 0.0,
            "attention_dropout": 0.0}


@pytest.fixture(scope="module")
def loop_data(tmp_path_factory):
    """The task's caches and offset-space qrels files in one data
    directory, and JAX-initialised registry weights (``rdot_nll``, init std
    0.2) as an HF checkpoint."""
    from ance_tpu.models.hf_export import save_hf_checkpoint
    from ance_tpu.models.registry import get_model_spec as jax_spec
    from ance_tpu.models.transformer import EncoderConfig as JaxConfig
    from test_ann_loop import _build_corpus
    root = tmp_path_factory.mktemp("loop")
    data = root / "data"
    data.mkdir()
    _, train_qrels, dev_qrels = _build_corpus(data)
    for name, qrels in (("train", train_qrels), ("dev", dev_qrels)):
        with open(data / f"{name}-qrel.tsv", "w") as f:
            for q, rels in qrels.items():
                for p, rel in rels.items():
                    f.write(f"{q}\t{p}\t{rel}\n")
    model = jax_spec("rdot_nll").build(
        config_overrides=dict(GEOMETRY, initializer_range=0.2))
    ids = jnp.ones((2, QLEN), jnp.int32)
    params = jax.jit(model.init)(jax.random.PRNGKey(1), ids, ids)["params"]
    weights = save_hf_checkpoint(root / "weights",
                                 jax.tree.map(np.asarray, params),
                                 JaxConfig(**GEOMETRY))
    return data, weights


def _loop_flags(data, weights, out, *extra):
    return ["ance-loop", "--model_name_or_path", str(weights),
            "--encoder_overrides", json.dumps(GEOMETRY),
            "--data_dir", str(data), "--output_dir", str(out),
            "--max_query_length", str(QLEN), "--learning_rate", "5e-3",
            "--warmup_steps", "4", "--per_device_train_batch_size", "16",
            "--per_device_eval_batch_size", "16",
            "--train_steps_per_slice", "2", "--encode_slice_size", "32",
            "--topk_training", "32", "--negative_sample", "8",
            "--ann_chunk_factor", "2", "--feed_workers", "0", "--seed", "5",
            *extra]


def _close_numbers(got: dict, want: dict) -> None:
    """Equal keys; ranking metrics within 1e-12, losses within the step
    parity's 1e-4 + 1e-5 relative, the least and largest trust ratio within
    1e-4 relative, counters equal; the clock fields apart. The mean of the
    41 ratios may move by two ratios' worth: the attention key biases'
    ratios divide norms of rounding noise (their gradient is 0 in exact
    arithmetic, ``_assert_params_close``), 0.042 and 0.022 in the port
    where the JAX package has 0.062 and 0.045 after this run."""
    assert set(got) == set(want)
    for key, w in want.items():
        if key in ("time", "refresh_sec"):
            continue
        if key in ("dev_ndcg", "dev_recall", "ann_mrr"):
            assert got[key] == pytest.approx(w, abs=1e-12, rel=0), key
        elif key == "mean_loss":
            assert got[key] == pytest.approx(w, abs=1e-4, rel=1e-5), key
        elif key == "trust_ratio_mean":
            assert got[key] == pytest.approx(
                w, abs=2 * want["trust_ratio_max"] / 41), key
        elif key.startswith("trust_ratio"):
            assert got[key] == pytest.approx(w, rel=1e-4), key
        else:
            assert got[key] == w, key


def test_cli_ance_loop_matches_ance_ance_loop(loop_data, tmp_path, capsys):
    """``cli ance-loop --device cpu`` and ``ance ance-loop`` on the same HF
    weights and data, bootstrap and 16 steps (two refreshes, the second
    mining the other half of the train queries), with trust ratios: the
    same refresh.jsonl lines and printed history (numbers as
    ``_close_numbers``), and the same final checkpoint-16 parameters: all
    but 0.1% of entries within 2e-6, every one within Adam's noise bound,
    as ``cli train``'s parity test holds them; the port's checkpoint loads
    strictly and is complete."""
    from ance_tpu.cli import main as jax_main
    from ance_tpu.train import checkpoint as jax_ckpt
    from ance_tpu_torch.cli import main as port_main
    from ance_tpu_torch.models.registry import get_model_spec
    from ance_tpu_torch.models.weights import (load_pretrained,
                                               state_dict_from_flax)
    data, weights = loop_data
    printed = {}
    for who, main, extra in (("jax", jax_main, ["--no_data_parallel"]),
                             ("port", port_main, ["--device", "cpu"])):
        main(_loop_flags(data, weights, tmp_path / who, "--max_steps", "16",
                         "--log_trust_ratios", *extra))
        printed[who] = json.loads(
            capsys.readouterr().out.strip().splitlines()[-1])
    assert len(printed["port"]) == len(printed["jax"]) == 2
    for got, want in zip(printed["port"], printed["jax"]):
        _close_numbers(got, want)
    assert printed["port"][1]["step"] == 16
    lines = {who: [json.loads(line) for line in
                   (tmp_path / who / "refresh.jsonl").read_text()
                   .splitlines()] for who in printed}
    assert len(lines["port"]) == len(lines["jax"]) == 2
    for got, want in zip(lines["port"], lines["jax"]):
        _close_numbers(got, want)
    path, step = ckpt.get_latest_checkpoint(str(tmp_path / "port"))
    assert step == 16 and ckpt.is_complete(path)
    jax_path, _ = jax_ckpt.get_latest_checkpoint(str(tmp_path / "jax"))
    want = state_dict_from_flax(jax_ckpt.load_raw_params(jax_path))
    got = torch.load(os.path.join(path, ckpt.MODEL_FILE), weights_only=True)
    lr_sum = sum(warmup_linear(5e-3, 4, 16)(i) for i in range(16))
    _assert_params_close(got, want, lr_sum, share=1e-3)
    fresh = get_model_spec("rdot_nll").build(config_overrides=GEOMETRY)
    load_pretrained(fresh, path)  # strict


def test_cli_ance_loop_guards(loop_data, tmp_path, capsys):
    """``--device`` defaults to cuda and exits where there is none;
    ``--http`` with nothing left to train exits (it would bootstrap a full
    refresh and stop); a pid2offset that does not cover the passages
    exits; a finished run resumes to a no-op that keeps its checkpoint."""
    import pickle
    from ance_tpu_torch.cli import main as port_main
    data, weights = loop_data
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA is not available"):
            port_main(_loop_flags(data, weights, tmp_path / "a",
                                  "--max_steps", "2"))
    out = tmp_path / "done"
    port_main(_loop_flags(data, weights, out, "--max_steps", "0",
                          "--device", "cpu"))
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == []
    assert ckpt.get_latest_checkpoint(str(out))[1] == 0  # step 0 saved
    with pytest.raises(SystemExit, match="already complete"):
        port_main(_loop_flags(data, weights, out, "--max_steps", "0",
                              "--device", "cpu", "--http", "127.0.0.1:0"))
    short = tmp_path / "short"
    short.mkdir()
    for name in os.listdir(data):
        os.symlink(data / name, short / name)
    with open(short / "pid2offset.pickle", "wb") as f:
        pickle.dump({1000 + p: p for p in range(N_PASSAGES - 1)}, f)
    with pytest.raises(SystemExit, match="does not cover"):
        port_main(_loop_flags(short, weights, tmp_path / "b", "--max_steps",
                              "2", "--device", "cpu", "--http",
                              "127.0.0.1:0"))


# -- the port's own cases -----------------------------------------------------

def _port_task(tmp_path, init=0.02, base_len=512, jax_weights=False,
               **cfg):
    """tests/test_ann_loop.py's task with a seeded port encoder (out_dim
    16), or with ``jax_weights`` tests/test_pipelined.py's own initial
    weights, and the port loop over it."""
    from unittest import mock

    import test_ann_loop
    from ance_tpu_torch.data.cache import TokenCacheWriter
    from ance_tpu_torch.models.transformer import EncoderConfig, init_weights
    os.makedirs(tmp_path, exist_ok=True)
    if jax_weights:
        paths, train_qrels, dev_qrels, model, _, _ = _vocab_task(tmp_path,
                                                                 init)
    else:
        # the port's writer (the same file format): the cuda test runs
        # where the JAX package is not installed
        with mock.patch.object(test_ann_loop, "TokenCacheWriter",
                               TokenCacheWriter):
            paths, train_qrels, dev_qrels = test_ann_loop._build_corpus(
                tmp_path)
        config = EncoderConfig(**dict(GEOMETRY, pad_token_id=1,
                                      initializer_range=init))
        model = RobertaDot(config, out_dim=16, base_len=base_len)
        init_weights(model, config, torch.Generator().manual_seed(0))
    body = cfg.pop("body", None)
    return _port_loop(PipelineConfig(**cfg), model, paths, train_qrels,
                      dev_qrels, body=body)


def test_schedule_interleaves_all_generator_work(tmp_path):
    """Every piece of generator work runs as one item between train steps,
    never two back to back mid-training; every item type is timed."""
    loop = _port_task(tmp_path, **SMALL)
    loop.bootstrap()
    assert loop.refresh_no == 1
    cycle = "EEEEDSVQMF"
    assert "".join(loop.schedule_trace) == cycle
    loop.run(40)
    trace = "".join(loop.schedule_trace[len(cycle):])
    assert trace == "".join("TTTT" + tag for tag in cycle)
    assert loop.refresh_no == 2
    assert loop.state.step == 40 and loop.history[-1]["step"] == 40
    assert set(loop.item_times) == set("EDSVQMF")
    assert all(t >= 0 for ts in loop.item_times.values() for t in ts)
    # the losses stayed device tensors until F, which averaged 40 of them
    assert loop._losses_since_refresh == []
    assert np.isfinite(loop.history[-1]["mean_loss"])


def test_zero_steps_zero_triples_and_one_device(tmp_path):
    """``run(0)`` is a no-op (no bootstrap); a cycle that mines no triple
    raises instead of re-encoding forever; more than one host without a
    mesh raises."""
    cfg = dict(SMALL, encode_slice_size=64, search_chunk_queries=64)
    loop = _port_task(tmp_path, **cfg)
    loop.run(0)
    assert loop._batches is None and loop.schedule_trace == []
    loop.train_positive = {}  # no train qrels: no triple can be built
    with pytest.raises(RuntimeError, match="zero training triples"):
        loop.bootstrap()
    with pytest.raises(ValueError, match="requires a mesh"):
        _port_task(tmp_path / "b", **dict(cfg, num_hosts=2))


def test_dev_metrics_tolerate_an_empty_dev_set(tmp_path, caplog):
    """No dev search ran: zeros, and one warning over two refreshes."""
    import logging
    loop = _port_task(tmp_path, **SMALL)
    loop._cyc = {}  # what an empty dev cache leaves behind
    with caplog.at_level(logging.WARNING,
                         logger="ance_tpu_torch.train.pipelined"):
        loop._dev_metrics()
        loop._cyc = {}
        loop._dev_metrics()
    assert loop._cyc["dev_ndcg"] == 0.0 and loop._cyc["dev_recall"] == 0.0
    assert sum("ZERO dev queries" in r.message for r in caplog.records) == 1


def test_int8_mid_cycle_clip_guard_and_learning(tmp_path):
    """A 40x jump in the encoder's outputs after the cycle's scale snapshot
    (slice 0) trips the mid-cycle guard: the scales widen at once, the
    codes do not saturate, later cycles re-snapshot (no widening, low clip
    share), and the int8 loop still learns the task (dev NDCG@10 up by more
    than 0.08 over 460 steps), from the JAX test's initial weights, as
    tests/test_pipelined.py holds the JAX loop."""
    calls = {"n": 0}

    def spiky(model, ids, mask):
        out = RobertaDot.body_emb(model, ids, mask)
        calls["n"] += 1
        return out if calls["n"] == 1 else out * 40.0

    loop = _port_task(tmp_path, jax_weights=True, **dict(
        SMALL, train_steps_per_slice=14, batch_size=32,
        index_quantize="dims", body=spiky))
    loop.run(460)
    assert loop.index._emb.dtype == torch.int8
    assert loop.history[0]["int8_scale_widenings"] >= 1, loop.history[0]
    sat = float((loop.index._emb.abs() >= 127).float().mean())
    assert sat < 0.05, f"index saturated: {sat:.1%} of entries at ±127"
    assert loop.history[-1]["int8_scale_widenings"] == 0, loop.history[-1]
    assert loop.history[-1]["int8_clip_frac"] < 0.05, loop.history[-1]
    first, last = loop.history[0], loop.history[-1]
    assert last["dev_ndcg"] > first["dev_ndcg"] + 0.08, loop.history


def test_rewarmup_per_dataset(tmp_path):
    """Each F re-anchors the LR schedule at the step count, with the new
    triple count as horizon."""
    from ance_tpu_torch.optim.schedules import RewarmupSchedule
    cfg = dict(SMALL, train_steps_per_slice=2, rewarmup_per_dataset=True)
    loop = _port_task(tmp_path, **cfg)
    loop.state.optimizer = trainer.make_optimizer(
        loop.state.model, "lamb", 5e-3, rewarmup=(10, 20000))
    loop.bootstrap()
    schedule = loop.state.optimizer.schedule
    assert isinstance(schedule, RewarmupSchedule)
    assert schedule.anchor == 0
    assert schedule.horizon == loop.history[0]["num_triples"]
    loop.run(22)  # 10 items of 2 steps: the second F at step 20
    assert loop.refresh_no == 2 and loop.state.optimizer.count == 22
    assert schedule.anchor == 20
    assert schedule.horizon == loop.history[1]["num_triples"]


def test_async_checkpoint_fence_and_resume(tmp_path):
    """F's save copies to the host and writes on a thread; the directory
    exists at once but is complete (meta.json, DONE) only after the fence.
    It holds the live weights and LAMB moments exactly. A new loop over
    the same directory resumes step, weights and refresh counter, and runs
    on."""
    ckpt_dir = str(tmp_path / "ckpts")
    cfg = dict(SMALL, checkpoint_dir=ckpt_dir)
    loop = _port_task(tmp_path, **cfg)
    loop.bootstrap()
    path = os.path.join(ckpt_dir, "checkpoint-0")
    assert os.path.isdir(path) and not ckpt.is_complete(path)
    assert ckpt.get_latest_checkpoint(ckpt_dir) == (None, 0)
    loop.flush_checkpoints()
    assert ckpt.get_latest_checkpoint(ckpt_dir) == (path, 0)
    assert json.load(open(os.path.join(path, "meta.json"))) == {
        "step": 0, "refresh_no": 0}
    loop.run(45)  # a second F at step 40, fenced at the end of run()
    path, step = ckpt.get_latest_checkpoint(ckpt_dir)
    assert step == 40 and ckpt.is_complete(path)
    saved = torch.load(os.path.join(path, ckpt.MODEL_FILE),
                       weights_only=True)
    assert sorted(os.listdir(path)) == ["DONE", "meta.json", "optimizer.pt",
                                        "pytorch_model.bin"]

    fresh = _port_task(tmp_path / "b", **cfg)
    before = fresh.state.model.state_dict()["norm.weight"].clone()
    assert fresh.resume() == 40
    assert fresh.state.step == 40 and fresh.refresh_no == 1
    for key, value in fresh.state.model.state_dict().items():
        assert torch.equal(value, saved[key]), key
    assert not torch.equal(before, saved["norm.weight"])
    assert fresh.state.optimizer.count == 40
    for key, value in fresh.snapshot.state_dict().items():
        assert torch.equal(value, saved[key]), key
    fresh.run(20)
    assert fresh.state.step == 60
    assert all(np.isfinite(h["dev_ndcg"]) and "refresh_sec" in h
               for h in fresh.history)


def test_async_checkpointer_holds_a_copy(tmp_path, monkeypatch):
    """The host copy is taken at save(): steps after it do not reach the
    file, and a failed write raises at the fence."""
    from ance_tpu_torch.models.registry import get_model_spec
    model = get_model_spec("rdot_nll").build(config_overrides=GEOMETRY)
    writer = ckpt.AsyncCheckpointer(str(tmp_path))
    want = {k: v.clone() for k, v in model.state_dict().items()}
    final = writer.save(3, model, {"count": 3}, extra={"refresh_no": 1})
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    writer.wait()
    got = torch.load(os.path.join(final, ckpt.MODEL_FILE), weights_only=True)
    for key, value in want.items():
        assert torch.equal(got[key], value), key
    assert ckpt.is_complete(final)

    def full_disk(*args, **kwargs):
        raise OSError("no space left on device")

    monkeypatch.setattr(torch, "save", full_disk)
    bad = writer.save(4, model)
    with pytest.raises(OSError, match="no space"):
        writer.wait()
    assert not ckpt.is_complete(bad)
    writer.wait()  # the error is reported once


def test_multichunk_mode(tmp_path):
    """MaxP through the loop: three chunk rows a passage in the index,
    id-level dedup in mining, the chunked body encode in slices."""
    loop = _port_task(tmp_path, base_len=4, body=RobertaDot.body_emb_multichunk,
                      **dict(SMALL, train_steps_per_slice=8,
                             encode_slice_size=32, negative_sample=4,
                             multichunk=True))
    loop.run(16)
    assert loop.refresh_no >= 1 and loop.state.step == 16
    assert loop.index.ntotal == N_PASSAGES * 3
    assert loop._rows_per_record == 3
    h = loop.history[-1]
    assert np.isfinite(h["dev_ndcg"]) and h["num_triples"] > 0


def _post(addr, payload):
    req = urllib.request.Request(
        f"http://{addr[0]}:{addr[1]}/search",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    return json.loads(urllib.request.urlopen(req, timeout=30).read())


def test_live_serving_follows_the_loop(tmp_path):
    """LoopRetriever + the HTTP server: refused before bootstrap, then
    answers equal ``search_tokens`` against the live index with the loop's
    snapshot, across a refresh boundary (a new snapshot object) without a
    restart; index, params and encoder cannot be swapped."""
    from ance_tpu_torch.serve import LoopRetriever
    from ance_tpu_torch.serve_http import RetrieverHTTPServer
    loop = _port_task(tmp_path, **SMALL)
    r = LoopRetriever(loop)
    with pytest.raises(RuntimeError, match="bootstrap"):
        r.index
    loop.bootstrap()
    srv = RetrieverHTTPServer(r, port=0).start()
    try:
        rs = np.random.RandomState(0)
        ids = rs.randint(4, VOCAB, (2, QLEN)).astype(np.int32)
        mask = np.ones_like(ids)

        def answered():
            body = _post(srv.address, {"ids": ids.tolist(),
                                       "mask": mask.tolist(), "k": 5})
            return [[e["pid"] for e in row] for row in body["results"]]

        _, want = r.search_tokens(ids, mask, 5)
        assert answered() == want.tolist()
        assert r.params is loop.snapshot and r.encode_fn is loop.qfn
        snap0 = loop.snapshot
        loop.run(44)
        assert loop.refresh_no == 2 and loop.snapshot is not snap0
        _, want2 = r.search_tokens(ids, mask, 5)
        assert answered() == want2.tolist()
        for attr, value in (("index", object()), ("params", {}),
                            ("encode_fn", len)):
            with pytest.raises(AttributeError):
                setattr(r, attr, value)
    finally:
        srv.shutdown()


def test_live_serving_concurrent_with_training(tmp_path):
    """Searches hammered from more client threads than cores, the
    interpreter switching threads every 10 µs, while the loop trains and
    writes index slices across a refresh: every request answers with k
    valid passage ids, and the server counts them all without an error."""
    import sys
    from ance_tpu_torch.serve import LoopRetriever
    from ance_tpu_torch.serve_http import RetrieverHTTPServer
    loop = _port_task(tmp_path, **dict(SMALL, train_steps_per_slice=2))
    loop.bootstrap()
    srv = RetrieverHTTPServer(LoopRetriever(loop), port=0).start()
    clients, per_client = (os.cpu_count() or 1) + 1, 5
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        errors = []

        def hammer(seed):
            rs = np.random.RandomState(seed)
            for _ in range(per_client):
                ids = rs.randint(4, VOCAB, (1, QLEN)).astype(np.int32)
                try:
                    body = _post(srv.address, {"ids": ids.tolist(), "k": 3})
                    pids = [e["pid"] for e in body["results"][0]]
                    assert len(pids) == 3 and all(
                        0 <= p < N_PASSAGES for p in pids), pids
                except Exception as e:  # collected, not raised mid-thread
                    errors.append(repr(e))

        threads = [threading.Thread(target=hammer, args=(seed,))
                   for seed in range(clients)]
        for t in threads:
            t.start()
        loop.run(60)  # slice writes and a refresh boundary
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads), "a client hung"
        assert not errors, errors
        stats = json.loads(urllib.request.urlopen(
            f"http://{srv.address[0]}:{srv.address[1]}/metrics",
            timeout=10).read())
        assert stats["errors"] == 0
        assert stats["requests"] == clients * per_client
        assert loop.refresh_no >= 2
    finally:
        sys.setswitchinterval(interval)
        srv.shutdown()


@pytest.mark.cuda
def test_loop_searches_launch_the_blockmax_kernel_on_cuda(tmp_path):
    """On the card every dev-search and mining item of the loop, and every
    live search, launches kernel #1's fp32-query route once
    (``blockmax_pieces_f32`` over the fp32 index; ``blockmax_pieces_int8``
    under ``dims``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel #1 has no CPU mode)")
    from ance_tpu_torch.ops.topk import blockmax_scores
    from ance_tpu_torch.serve import LoopRetriever
    for quantize, kernel in ((None, "blockmax_pieces_f32"),
                             ("dims", "blockmax_pieces_int8")):
        loop = _port_task(tmp_path / str(quantize),
                          **dict(SMALL, index_quantize=quantize))
        loop.device = torch.device("cuda")
        loop.state.model.to("cuda")
        loop._now = pipelined.synced_clock(loop.device)
        loop._take_snapshot()
        blockmax_scores.launches = 0
        blockmax_scores.kernel_launches.clear()
        loop.run(40)
        items = sum(tag in "SM" for tag in loop.schedule_trace)
        ids = np.random.RandomState(0).randint(4, VOCAB, (1, QLEN))
        LoopRetriever(loop).search_tokens(ids, np.ones_like(ids), 5)
        assert dict(blockmax_scores.kernel_launches) == {kernel: items + 1}
