"""The port's BM25 warmup (``train/warmup.py``, ``cli warmup``) against
``ance_tpu.train.warmup.run_warmup`` on the same triples, tokenizer and
flax weights, dropout off: per-step losses, final parameters, checkpoint
steps, eval and trust-ratio entries. Port-only: with dropout on, a run
resumed at step s is the uninterrupted run bit for bit; a resume at
``max_steps`` trains nothing; the CLI trains, evaluates and resumes."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ance_tpu_torch.models.weights import state_dict_from_flax
from ance_tpu_torch.optim.schedules import warmup_linear
from ance_tpu_torch.train import checkpoint as ckpt
from ance_tpu_torch.train import trainer
from ance_tpu_torch.train.warmup import WarmupConfig, run_warmup
from test_torch_preprocess import WordTokenizer, _words
from test_torch_train import NO_DROPOUT, TINY, _assert_params_close

torch.set_num_threads(1)

SEQ = 16
LR, WARMUP, TOTAL = 2e-3, 2, 8


def _triples(path, n=13, seed=0):
    """n ``query\\tpos\\tneg`` lines (3 batches of 4 an epoch, the 13th
    line dropped with the partial batch); a positive shares its query's
    words."""
    rs = np.random.RandomState(seed)
    with open(path, "w") as f:
        for _ in range(n):
            q = _words(rs, 3)
            f.write(f"{q}\t{q} {_words(rs, 4)}\t{_words(rs, 6)}\n")
    return str(path)


def _flax_params(seed=0):
    from ance_tpu.models.dot_models import RobertaDot as JaxRobertaDot
    from ance_tpu.models.transformer import EncoderConfig as JaxConfig
    jm = JaxRobertaDot(JaxConfig(attention_impl="xla", initializer_range=0.2,
                                 **TINY, **NO_DROPOUT), base_len=SEQ)
    ids = jnp.ones((2, 8), jnp.int32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed), ids, ids)["params"]
    return jm, jax.tree.map(np.asarray, params)


def _port_state(params=None, overrides=NO_DROPOUT, seed=0):
    from ance_tpu_torch.models.dot_models import RobertaDot
    from ance_tpu_torch.models.transformer import EncoderConfig
    model = RobertaDot(EncoderConfig(attention_impl="xla",
                                     initializer_range=0.2, **TINY,
                                     **overrides), base_len=SEQ)
    if params is not None:
        model.load_state_dict(state_dict_from_flax(params), strict=True)
    else:
        from ance_tpu_torch.models.transformer import init_weights
        init_weights(model, model.config, torch.Generator().manual_seed(seed))
    opt = trainer.make_optimizer(model, "lamb", warmup_linear(LR, WARMUP,
                                                              TOTAL),
                                 eps=1e-8, weight_decay=0.01)
    return (trainer.init_train_state(model, opt),
            trainer.make_train_step(trainer.triplet_loss_fn()))


@pytest.mark.parametrize("max_steps", [5, -1])
def test_run_warmup_matches_jax(tmp_path, max_steps):
    """2 epochs of 3 batches, capped at 5 steps or run out: the same loss
    at every step (atol 1e-4, rtol 1e-5, tests/test_torch_train.py), the
    same final parameters (``_assert_params_close``), checkpoints at the
    same steps (every 2, and the final one when the epochs run out), and
    eval and trust-ratio entries at the same steps with the same keys; the
    eval sees the parameters of its step."""
    from ance_tpu.optim.schedules import warmup_linear as jax_warmup
    from ance_tpu.train import checkpoint as jax_ckpt
    from ance_tpu.train import trainer as jax_trainer
    from ance_tpu.train.warmup import WarmupConfig as JaxConfig
    from ance_tpu.train.warmup import run_warmup as jax_run_warmup

    triples = _triples(tmp_path / "triples.tsv")
    jm, params = _flax_params()
    tok = WordTokenizer()
    kw = dict(num_epochs=2, batch_size=4, max_seq_length=SEQ,
              max_steps=max_steps, save_steps=2, eval_every=2,
              log_trust_ratios=True)

    jopt = jax_trainer.make_optimizer("lamb", jax_warmup(LR, WARMUP, TOTAL),
                                      eps=1e-8, weight_decay=0.01)
    jstate = jax_trainer.init_train_state(jax.tree.map(jnp.asarray, params),
                                          jopt)
    jstep = jax_trainer.make_train_step(jax_trainer.triplet_loss_fn(jm), jopt)
    jstate, jhist = jax_run_warmup(
        JaxConfig(checkpoint_dir=str(tmp_path / "jax"), **kw), state=jstate,
        train_step=jstep, tokenizer=tok, triples_path=triples,
        rng=jax.random.PRNGKey(0),
        eval_fn=lambda p: (float(np.sum(p["norm"]["scale"])),
                           float(np.sum(p["embedding_head"]["bias"]))))

    state, step = _port_state(params)
    state, hist = run_warmup(
        WarmupConfig(checkpoint_dir=str(tmp_path / "port"), **kw),
        state=state, train_step=step, tokenizer=tok, triples_path=triples,
        seed=0, eval_fn=lambda m: (float(m.norm.weight.detach().sum()),
                                   float(m.embeddingHead.bias.detach().sum())))

    n = 5 if max_steps > 0 else 6
    assert state.step == int(jstate.step) == n
    assert [(h["step"], sorted(h)) for h in hist] == \
        [(h["step"], sorted(h)) for h in jhist]
    losses = [h["loss"] for h in hist if "loss" in h]
    jlosses = [h["loss"] for h in jhist if "loss" in h]
    assert len(losses) == n
    np.testing.assert_allclose(losses, jlosses, atol=1e-4, rtol=1e-5)
    evals = [(h["reranking_mrr"], h["full_ranking_mrr"]) for h in hist
             if "reranking_mrr" in h]
    jevals = [(h["reranking_mrr"], h["full_ranking_mrr"]) for h in jhist
              if "reranking_mrr" in h]
    assert len(evals) == n // 2
    np.testing.assert_allclose(evals, jevals, atol=1e-4)
    for h in hist:
        if "trust_ratio_mean" in h:
            assert np.isfinite([h["trust_ratio_min"], h["trust_ratio_mean"],
                                h["trust_ratio_max"]]).all()
    want = state_dict_from_flax(jax.tree.map(np.asarray, jstate.params))
    lr_sum = sum(_lr(i) for i in range(n))
    _assert_params_close(state.model.state_dict(), want, lr_sum=lr_sum)

    steps = sorted(ckpt.checkpoint_no(d) for d in os.listdir(tmp_path / "port"))
    jsteps = sorted(ckpt.checkpoint_no(d) for d in os.listdir(tmp_path / "jax"))
    assert steps == jsteps == ([2, 4] if max_steps > 0 else [2, 4, 6])
    for s in steps:
        path = tmp_path / "port" / f"checkpoint-{s}"
        meta = json.loads((path / "meta.json").read_text())
        jmeta = json.loads((tmp_path / "jax" / f"checkpoint-{s}" /
                            "meta.json").read_text())
        assert meta == jmeta and ckpt.is_complete(str(path))
        assert (path / "optimizer.pt").exists()
    final = ckpt.get_latest_checkpoint(str(tmp_path / "port"))[0]
    got = torch.load(os.path.join(final, "pytorch_model.bin"),
                     weights_only=True)
    jfinal = jax_ckpt.get_latest_checkpoint(str(tmp_path / "jax"))[0]
    _assert_params_close(got, state_dict_from_flax(
        jax_ckpt.load_raw_params(jfinal)), lr_sum=lr_sum)


def _lr(step):
    return warmup_linear(LR, WARMUP, TOTAL)(step)


def _run(tmp_path, triples, directory, max_steps, resume=False, seed=5):
    """The port's warmup with dropout on (TINY's 0.1): fresh weights from
    ``seed``, resumed from ``directory`` when asked."""
    state, step = _port_state(overrides={}, seed=seed)
    start = 0
    if resume:
        state, start = ckpt.resume_train_state(str(directory), state)
    cfg = WarmupConfig(num_epochs=3, batch_size=4, max_seq_length=SEQ,
                       max_steps=max_steps, save_steps=2,
                       checkpoint_dir=str(directory))
    return run_warmup(cfg, state=state, train_step=step,
                      tokenizer=WordTokenizer(), triples_path=triples,
                      seed=11, start_step=start)


@pytest.mark.parametrize("stop", [2, 4])
def test_resume_with_dropout_on_is_the_uninterrupted_run(tmp_path, stop):
    """Dropout on: 7 steps in one run, against ``stop`` steps, then a new
    process's worth of state (other initial weights) resumed from the
    checkpoint at ``stop`` (4 lies past the first epoch's 3 batches):
    every later loss and every final parameter and optimizer moment
    bit-equal."""
    triples = _triples(tmp_path / "triples.tsv")
    whole, whole_hist = _run(tmp_path, triples, tmp_path / "whole", 7)
    _run(tmp_path, triples, tmp_path / "cut", stop)
    assert ckpt.get_latest_checkpoint(str(tmp_path / "cut"))[1] == stop
    resumed, hist = _run(tmp_path, triples, tmp_path / "cut", 7, resume=True,
                         seed=99)
    assert resumed.step == whole.step == 7
    assert [h["step"] for h in hist] == list(range(stop + 1, 8))
    assert [h["loss"] for h in hist] == \
        [h["loss"] for h in whole_hist[stop:]]
    for key, value in whole.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[key], value), key
    a, b = whole.optimizer.state_dict(), resumed.optimizer.state_dict()
    assert a["count"] == b["count"] == 7
    for pa, pb in zip(a["inner"]["state"].values(),
                      b["inner"]["state"].values()):
        assert torch.equal(pa["exp_avg"], pb["exp_avg"])
        assert torch.equal(pa["exp_avg_sq"], pb["exp_avg_sq"])
    # and dropout was live: another seed trains another first step
    other = run_warmup(WarmupConfig(batch_size=4, max_seq_length=SEQ,
                                    max_steps=1),
                       state=_port_state(overrides={}, seed=5)[0],
                       train_step=_port_state()[1], tokenizer=WordTokenizer(),
                       triples_path=triples, seed=12)[1]
    assert other[0]["loss"] != whole_hist[0]["loss"]


def test_resume_at_max_steps_is_a_no_op(tmp_path):
    """A checkpoint written at ``max_steps``: the resumed run trains
    nothing, writes nothing and leaves the parameters as they were."""
    triples = _triples(tmp_path / "triples.tsv")
    _run(tmp_path, triples, tmp_path / "run", 4)
    before = sorted(os.listdir(tmp_path / "run"))
    resumed, hist = _run(tmp_path, triples, tmp_path / "run", 4, resume=True)
    assert hist == [] and resumed.step == 4
    assert sorted(os.listdir(tmp_path / "run")) == before
    saved = torch.load(tmp_path / "run" / "checkpoint-4" /
                       "pytorch_model.bin", weights_only=True)
    for key, value in resumed.model.state_dict().items():
        assert torch.equal(saved[key], value), key


def _eval_files(root):
    """collection.tsv (12 passages), queries.dev.small.tsv (4 queries),
    top1000.dev (each query's positive and 5 others) and
    qrels.dev.small.tsv."""
    rs = np.random.RandomState(2)
    root.mkdir()
    texts = [_words(rs, 5) for _ in range(12)]
    with open(root / "collection.tsv", "w") as f:
        f.writelines(f"{200 + i}\t{t}\n" for i, t in enumerate(texts))
    with open(root / "queries.dev.small.tsv", "w") as f, \
            open(root / "qrels.dev.small.tsv", "w") as qrels, \
            open(root / "top1000.dev", "w") as top:
        for q in range(4):
            pos = 200 + 3 * q
            f.write(f"{q}\t{texts[3 * q][:9]}\n")
            qrels.write(f"{q}\t0\t{pos}\t1\n")
            for p in [pos] + list(rs.choice(np.arange(200, 212), 5,
                                            replace=False)):
                top.write(f"{q}\t{p}\tq\tp\n")
    return str(root)


def test_cli_warmup_end_to_end(tmp_path, capsys, monkeypatch):
    """``cli warmup --device cpu`` with the tokenizer factory's loader
    replaced: 4 steps with evals at 2 and 4, checkpoints at 2 and 4, the
    printed tail of the history; a rerun to 6 resumes at 4 (says so) and
    trains steps 5-6 only; ``--evaluate_during_training`` without
    ``--data_dir`` exits."""
    from ance_tpu_torch import cli
    monkeypatch.setattr(cli, "_load_tokenizer",
                        lambda name, model_dir: WordTokenizer())
    triples = _triples(tmp_path / "triples.tsv", n=24)
    data = _eval_files(tmp_path / "raw")
    out = str(tmp_path / "out")
    base = ["warmup", "--device", "cpu", "--encoder_overrides",
            json.dumps(TINY), "--train_file", triples, "--output_dir", out,
            "--save_steps", "2", "--evaluate_during_training",
            "--eval_steps", "2", "--data_dir", data,
            "--per_device_train_batch_size", "4", "--max_seq_length",
            str(SEQ), "--max_query_length", "8", "--warmup_steps", "1"]
    cli.main(base + ["--max_steps", "4"])
    tail = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert [h["step"] for h in tail] == [3, 4, 4]
    assert all(np.isfinite(h["loss"]) for h in tail[:2])
    assert 0.0 <= tail[2]["reranking_mrr"] <= 1.0
    assert 0.0 <= tail[2]["full_ranking_mrr"] <= 1.0
    assert ckpt.get_latest_checkpoint(out)[1] == 4
    cli.main(base + ["--max_steps", "6"])
    captured = capsys.readouterr()
    assert "resuming from step 4" in captured.err
    tail = json.loads(captured.out.splitlines()[-1])
    assert [h["step"] for h in tail] == [5, 6, 6]
    assert sorted(os.listdir(out)) == ["checkpoint-2", "checkpoint-4",
                                       "checkpoint-6"]
    with pytest.raises(SystemExit, match="needs --data_dir"):
        cli.main([a for a in base if a not in ("--data_dir", data)]
                 + ["--max_steps", "1"])


def test_cli_warmup_log_trust_ratios(tmp_path, capsys, monkeypatch):
    """``cli warmup --log_trust_ratios`` puts LAMB's trust-ratio summary
    into the history every ``--eval_steps``, after that step's loss."""
    from ance_tpu_torch import cli
    monkeypatch.setattr(cli, "_load_tokenizer",
                        lambda name, model_dir: WordTokenizer())
    triples = _triples(tmp_path / "triples.tsv", n=8)
    cli.main(["warmup", "--device", "cpu", "--encoder_overrides",
              json.dumps(TINY), "--train_file", triples, "--output_dir",
              str(tmp_path / "out"), "--save_steps", "0", "--eval_steps",
              "2", "--log_trust_ratios", "--optimizer", "lamb",
              "--per_device_train_batch_size", "4", "--max_seq_length",
              str(SEQ), "--max_query_length", "8", "--max_steps", "2"])
    tail = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert [h["step"] for h in tail] == [1, 2, 2]
    ratios = tail[2]
    assert sorted(ratios) == ["step", "trust_ratio_max", "trust_ratio_mean",
                              "trust_ratio_min"]
    assert 0 < ratios["trust_ratio_min"] <= ratios["trust_ratio_mean"] \
        <= ratios["trust_ratio_max"]
