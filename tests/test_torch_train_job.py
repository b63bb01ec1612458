"""The port's trainer job against the JAX package's on the same files: the
triple feed (batches byte for byte), checkpoints (written by the port, read
back by the port, by ``ance_tpu``'s torch-checkpoint reader and by
``serve --training_dir``), and ``cli train`` against ``ance train`` on the
same caches, ann file and weights, dropout off."""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ance_tpu.data import feed as jax_feed
from ance_tpu.data.cache import TokenCache as JaxCache
from ance_tpu_torch.data import feed
from ance_tpu_torch.data.cache import TokenCache, TokenCacheWriter
from ance_tpu_torch.models.weights import state_dict_from_flax
from ance_tpu_torch.train import checkpoint as ckpt
from test_torch_train import _assert_params_close

torch.set_num_threads(1)

TINY_514 = {"num_layers": 2, "hidden_size": 32, "num_heads": 2,
            "intermediate_size": 64, "vocab_size": 100,
            "max_position_embeddings": 514, "hidden_dropout": 0.0,
            "attention_dropout": 0.0}


def _write(path, n, seq, rs, min_len=2):
    lengths = rs.randint(min_len, seq + 1, n)
    with TokenCacheWriter(str(path), seq) as w:
        for length in lengths:
            row = np.ones(seq, np.int32)
            row[0] = 0
            row[1:length] = rs.randint(3, TINY_514["vocab_size"], length - 1)
            w.write(int(length), row)


@pytest.fixture(scope="module")
def job_inputs(tmp_path_factory):
    """FirstP caches (12 queries at seq 8, 40 passages at seq 16), MaxP
    caches (the same queries, 24 documents of two 512-token chunks), an
    ``ann_training_data_0`` / ``ann_ndcg_0`` pair of 12 lines with 3
    negatives each, and JAX-initialised weights (init 0.2, so embeddings
    do not collapse) as an HF checkpoint."""
    from ance_tpu.models.hf_export import save_hf_checkpoint
    from ance_tpu.models.registry import get_model_spec as jax_spec
    from ance_tpu.models.transformer import EncoderConfig as JaxConfig

    root = tmp_path_factory.mktemp("job")
    rs = np.random.RandomState(0)
    for sub in ("psg", "doc"):
        (root / sub).mkdir()
    _write(root / "psg" / "train-query", 12, 8, rs)
    _write(root / "psg" / "passages", 40, 16, rs)
    _write(root / "doc" / "passages", 24, 1024, rs, min_len=300)
    for suffix in ("", "_meta"):
        shutil.copy(root / "psg" / f"train-query{suffix}",
                    root / "doc" / f"train-query{suffix}")
    ann = root / "ann"
    ann.mkdir()
    with open(ann / "ann_training_data_0", "w") as f:
        for q in range(12):
            negs = rs.choice(np.arange(12, 24), 3, replace=False)
            f.write(f"{q}\t{q}\t{','.join(map(str, negs))}\n")
    with open(ann / "ann_ndcg_0", "w") as f:
        json.dump({"ndcg": 0.5, "checkpoint": "init"}, f)
    model = jax_spec("rdot_nll").build(
        config_overrides=dict(TINY_514, initializer_range=0.2))
    ids = jnp.ones((2, 8), jnp.int32)
    params = jax.jit(model.init)(jax.random.PRNGKey(1), ids, ids)["params"]
    weights = save_hf_checkpoint(root / "weights",
                                 jax.tree.map(np.asarray, params),
                                 JaxConfig(**TINY_514))
    return root, str(ann), weights


def _lines(ann):
    with open(os.path.join(ann, "ann_training_data_0")) as f:
        return f.read().splitlines()


def test_feed_batches_are_the_jax_feeds(job_inputs):
    """Same lines, caches and seed: the same triples and, epoch after epoch,
    serial or on threads, the same batches byte for byte."""
    root, ann, _ = job_inputs
    lines = _lines(ann)
    assert feed.parse_triple_line(lines[0]) == \
        jax_feed.parse_triple_line(lines[0])
    triples = feed.expand_triples(lines)
    np.testing.assert_array_equal(triples, jax_feed.expand_triples(lines))
    assert triples.dtype == np.int64 and triples.shape == (36, 3)
    data = root / "psg"
    with TokenCache(str(data / "train-query")) as qc, \
            TokenCache(str(data / "passages")) as pc, \
            JaxCache(str(data / "train-query")) as jqc, \
            JaxCache(str(data / "passages")) as jpc:
        ids, mask = feed.gather_padded(pc, np.array([3, 0, 3]))
        jids, jmask = jax_feed.gather_padded(jpc, np.array([3, 0, 3]))
        assert ids.dtype == jids.dtype and mask.dtype == jmask.dtype
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_array_equal(mask, jmask)
        port = feed.TripletBatches(qc, pc, triples, batch_size=5, seed=7)
        jax_b = jax_feed.TripletBatches(jqc, jpc, triples, batch_size=5,
                                        seed=7)
        assert len(port) == len(jax_b) == 7
        runs = [(port.epoch(1), jax_b.epoch(1)),
                (port.epoch_prefetched(0, workers=3),
                 jax_b.epoch_prefetched(0, workers=3)),
                (feed.infinite_batches(port, workers=2),
                 jax_feed.infinite_batches(jax_b, workers=0))]
        for got_it, want_it in runs:
            for _, got, want in zip(range(16), got_it, want_it):
                assert sorted(got) == sorted(want)
                for key in want:
                    assert got[key].dtype == want[key].dtype
                    assert got[key].tobytes() == want[key].tobytes(), key


def test_checkpoint_round_trip_and_the_jax_reader(tmp_path):
    """A port checkpoint: complete (DONE after the rename), found newest by
    both packages' ``get_latest_checkpoint`` (an unfinished one without
    DONE is skipped), loaded strictly by the port and resumed with its
    optimizer; ``ance_tpu``'s torch reader maps it onto the flax tree and
    back to the same tensors."""
    from ance_tpu.models import hf_loader
    from ance_tpu.train import checkpoint as jax_ckpt
    from ance_tpu_torch.models.registry import get_model_spec
    from ance_tpu_torch.models.weights import load_pretrained
    from ance_tpu_torch.train import trainer

    spec = get_model_spec("rdot_nll")
    model = spec.build(config_overrides=TINY_514, seed=3)
    state = trainer.init_train_state(model, trainer.make_optimizer(
        model, "lamb", 1e-3, rewarmup=None))
    step = trainer.make_train_step(trainer.triplet_loss_fn())
    rs = np.random.RandomState(4)
    batch = {}
    for side, seq in (("query", 8), ("pos", 16), ("neg", 16)):
        batch[f"{side}_ids"] = rs.randint(3, 100, (4, seq)).astype(np.int32)
        batch[f"{side}_mask"] = np.ones((4, seq), np.int32)
    state, _ = step(state, batch, torch.Generator().manual_seed(0))
    path = ckpt.save_checkpoint(str(tmp_path), 7, model,
                                state.optimizer.state_dict(), {"note": 1})
    os.makedirs(tmp_path / "checkpoint-9")  # unfinished: no DONE
    assert ckpt.is_complete(path) and ckpt.checkpoint_no(path) == 7
    assert ckpt.get_latest_checkpoint(str(tmp_path)) == (path, 7)
    assert jax_ckpt.get_latest_checkpoint(str(tmp_path)) == (path, 7)
    assert ckpt.get_latest_checkpoint(str(tmp_path / "none"), "init") == \
        ("init", 0)
    assert sorted(os.listdir(path)) == ["DONE", "meta.json", "optimizer.pt",
                                        "pytorch_model.bin"]

    fresh = spec.build(config_overrides=TINY_514, seed=5)
    load_pretrained(fresh, path)  # strict
    for key, value in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[key], value), key
    sd = hf_loader.load_torch_state_dict(path)
    back = state_dict_from_flax(hf_loader.robertadot_params_from_torch(sd))
    assert sorted(back) == sorted(model.state_dict())
    for key, value in model.state_dict().items():
        assert torch.equal(back[key], value), key

    resumed = trainer.init_train_state(fresh, trainer.make_optimizer(
        fresh, "lamb", 1e-3))
    resumed, at = ckpt.resume_train_state(str(tmp_path), resumed)
    assert at == resumed.step == 7 and resumed.optimizer.count == 1
    for p_new, p_old in zip(fresh.parameters(), model.parameters()):
        a = resumed.optimizer.inner.state[p_new]
        b = state.optimizer.inner.state[p_old]
        assert torch.equal(a["exp_avg"], b["exp_avg"])
        assert torch.equal(a["exp_avg_sq"], b["exp_avg_sq"])


CLI_CASES = {
    "firstp": ("psg", "rdot_nll", []),
    "maxp_fused_body_accum": ("doc", "rdot_nll_multi_chunk",
                              ["--fused_body",
                               "--gradient_accumulation_steps", "2"]),
    "firstp_adamw_rewarmup": ("psg", "rdot_nll",
                              ["--optimizer", "adamw",
                               "--rewarmup_per_dataset"]),
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_train_matches_ance_train(job_inputs, tmp_path, monkeypatch,
                                      capsys, case):
    """``python -m ance_tpu_torch.cli train --device cpu`` and ``ance
    train`` on the same caches, ann file and HF weights, 3 steps of batch
    4, dropout off: the same loss at every step (within 1e-4 + 1e-5
    relative: scores of |s| ~ 10²-10³ in fp32) and the same checkpoint-3 parameters: all but
    0.1% of entries within 2e-6, every one within Adam's noise bound
    (``_assert_params_close``, test_torch_train.py)."""
    from ance_tpu.cli import main as jax_main
    from ance_tpu.train import checkpoint as jax_ckpt
    from ance_tpu.train import trainer as jax_trainer
    from ance_tpu_torch.cli import main as port_main

    root, ann, weights = job_inputs
    sub, model_type, extra = CLI_CASES[case]
    common = ["train", "--model_type", model_type,
              "--model_name_or_path", weights,
              "--encoder_overrides", json.dumps(TINY_514),
              "--data_dir", str(root / sub), "--ann_dir", ann,
              "--max_steps", "3", "--save_steps", "3", "--warmup_steps", "1",
              "--learning_rate", "2e-3", "--weight_decay", "0.01",
              "--per_device_train_batch_size", "4",
              "--max_query_length", "8", "--feed_workers", "2"] + extra

    jax_losses = []
    make_step = jax_trainer.make_train_step

    def recording_step(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def run(state, batch, rng):
            state, metrics = step(state, batch, rng)
            jax_losses.append(float(metrics["loss"]))
            return state, metrics
        return run

    monkeypatch.setattr(jax_trainer, "make_train_step", recording_step)
    jax_main(common + ["--output_dir", str(tmp_path / "jax"),
                       "--no_data_parallel"])
    capsys.readouterr()
    port_main(common + ["--output_dir", str(tmp_path / "port"),
                        "--device", "cpu"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["steps"] == 3 and len(summary["loss"]) == 3
    assert np.isfinite(summary["loss"]).all()
    np.testing.assert_allclose(summary["loss"], jax_losses, atol=1e-4,
                               rtol=1e-5)
    port_ckpt, step = ckpt.get_latest_checkpoint(str(tmp_path / "port"))
    assert step == 3 and summary["checkpoint"] == port_ckpt
    jax_path, _ = jax_ckpt.get_latest_checkpoint(str(tmp_path / "jax"))
    want = state_dict_from_flax(jax_ckpt.load_raw_params(jax_path))
    got = torch.load(os.path.join(port_ckpt, "pytorch_model.bin"),
                     weights_only=True)
    lr_sum = 2e-3 * 3  # rates at or under the base rate, three steps
    _assert_params_close(got, want, lr_sum=lr_sum, share=1e-3)
    if "rewarmup" in case:
        opt_state = torch.load(os.path.join(port_ckpt, "optimizer.pt"),
                               weights_only=True)
        assert opt_state["rewarmup"] == {"anchor": 0,
                                         "horizon": float(len(_lines(ann)))}


def test_serve_training_dir_reads_a_port_checkpoint(job_inputs, tmp_path,
                                                    capsys):
    """``serve --training_dir`` serves the newest complete port checkpoint:
    the same rankings as pointing ``--model_name_or_path`` at it or at the
    training directory."""
    from ance_tpu_torch.cli import main as port_main
    root, ann, weights = job_inputs
    data = str(root / "psg")
    port_main(["train", "--device", "cpu", "--model_name_or_path", weights,
               "--encoder_overrides", json.dumps(TINY_514),
               "--data_dir", data, "--ann_dir", ann, "--max_steps", "2",
               "--save_steps", "1", "--per_device_train_batch_size", "4",
               "--output_dir", str(tmp_path / "train")])
    capsys.readouterr()
    serve = ["serve", "--device", "cpu",
             "--encoder_overrides", json.dumps(TINY_514), "--data_dir", data,
             "--query_cache", data + "/train-query", "--topk", "5",
             "--max_query_length", "8", "--with_scores"]
    port_main(serve + ["--training_dir", str(tmp_path / "train"),
                       "--output", str(tmp_path / "a.tsv")])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["params"].endswith(os.path.join("checkpoint-2",
                                               "pytorch_model.bin"))
    port_main(serve + ["--model_name_or_path",
                       str(tmp_path / "train" / "checkpoint-2"),
                       "--output", str(tmp_path / "b.tsv")])
    # a training directory as --model_name_or_path: its newest checkpoint
    port_main(serve + ["--model_name_or_path", str(tmp_path / "train"),
                       "--output", str(tmp_path / "c.tsv")])
    a = (tmp_path / "a.tsv").read_text()
    assert len(a.splitlines()) == 60
    assert a == (tmp_path / "b.tsv").read_text() == \
        (tmp_path / "c.tsv").read_text()


def test_cli_train_refuses_what_is_not_ported(job_inputs, tmp_path):
    from ance_tpu_torch.cli import main as port_main
    root, ann, weights = job_inputs
    base = ["train", "--device", "cpu", "--data_dir", str(root / "psg"),
            "--output_dir", str(tmp_path), "--encoder_overrides",
            json.dumps(TINY_514)]
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA is not available"):
            port_main([a for a in base if a not in ("--device", "cpu")]
                      + ["--ann_dir", ann])
    with pytest.raises(SystemExit, match="use --model_type dpr"):
        port_main(base + ["--num_epoch", "1"])
    with pytest.raises(SystemExit, match="--ann_dir is required"):
        port_main(base)
    with pytest.raises(SystemExit, match="mutually exclusive"):
        port_main(base + ["--ann_dir", ann, "--rewarmup_per_dataset",
                          "--single_warmup"])
    # seeddot_nll, refused before its slice: warm-started from a fairseq
    # SEED checkpoint with its head (both CLIs load every tensor), 3 steps
    # give ``ance train``'s losses and parameters (the bounds of
    # test_cli_train_matches_ance_train). The position table keeps 516
    # rows: the JAX import pads to 516 whatever the config says
    from ance_tpu.cli import main as jax_main
    from ance_tpu.models.hf_export import torch_seeddot_state_dict
    from ance_tpu.models.seed import seed_dot_model
    from ance_tpu.train import checkpoint as jax_ckpt
    geom = dict(TINY_514, max_position_embeddings=516)
    model = seed_dot_model(out_dim=768, **dict(geom, initializer_range=0.2))
    ids = jnp.ones((2, 8), jnp.int32)
    params = jax.tree.map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(2), ids, ids)["params"])
    (tmp_path / "seed").mkdir()
    torch.save(torch_seeddot_state_dict(params),
               tmp_path / "seed" / "pytorch_model.bin")
    common = ["train", "--model_type", "seeddot_nll", "--model_name_or_path",
              str(tmp_path / "seed"), "--encoder_overrides",
              json.dumps(geom), "--data_dir", str(root / "psg"),
              "--ann_dir", ann, "--max_steps", "3", "--save_steps", "3",
              "--warmup_steps", "1", "--learning_rate", "2e-3",
              "--per_device_train_batch_size", "4",
              "--max_query_length", "8", "--feed_workers", "2"]
    jax_main(common + ["--output_dir", str(tmp_path / "jax"),
                       "--no_data_parallel"])
    port_main(common + ["--output_dir", str(tmp_path / "port"),
                        "--device", "cpu"])
    jax_path, _ = jax_ckpt.get_latest_checkpoint(str(tmp_path / "jax"))
    port_path, step = ckpt.get_latest_checkpoint(str(tmp_path / "port"))
    assert step == 3
    _assert_params_close(
        torch.load(os.path.join(port_path, "pytorch_model.bin"),
                   weights_only=True),
        state_dict_from_flax(jax_ckpt.load_raw_params(jax_path)),
        lr_sum=2e-3 * 3, share=1e-3)


def test_ann_dir_and_qrels_helpers_match_jax(tmp_path):
    """The port's copies of ``get_latest_ann_data`` (the newest ready file,
    ready meaning its ann_ndcg file exists), ``load_offset_qrels`` and
    ``positives_from_qrels`` give the JAX package's answers."""
    from ance_tpu.train import ance_loop as jax_loop
    from ance_tpu.train.ann_gen import get_latest_ann_data as jax_latest
    from ance_tpu_torch.train import ance_loop
    ann = tmp_path / "ann"
    assert ance_loop.get_latest_ann_data(str(ann)) == jax_latest(str(ann)) \
        == (-1, None, None)
    ann.mkdir()
    for n in (0, 2, 3):
        (ann / f"ann_training_data_{n}").write_text("0\t1\t2\n")
    for n in (0, 2):  # data 3 is not ready yet
        (ann / f"ann_ndcg_{n}").write_text(json.dumps({"ndcg": n / 10}))
    (ann / "ann_ndcg_x").write_text("{}")
    assert ance_loop.get_latest_ann_data(str(ann)) == jax_latest(str(ann)) \
        == (2, str(ann / "ann_training_data_2"), {"ndcg": 0.2})
    qrels = tmp_path / "qrels.tsv"
    qrels.write_text("3\t10\t1\n3\t11\t1\n\n5\t7\t2\n")
    got = ance_loop.load_offset_qrels(str(qrels))
    assert got == jax_loop.load_offset_qrels(str(qrels)) == {
        3: {10: 1, 11: 1}, 5: {7: 2}}
    assert ance_loop.positives_from_qrels(got) == \
        jax_loop.positives_from_qrels(got) == {3: 10, 5: 7}
