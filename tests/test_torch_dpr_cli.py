"""The port's DPR command line on the CPU against ``ance``'s:
``preprocess-dpr`` → ``train --num_epoch 2 --dev_data`` (GradCache
accumulation) → ``generate-dpr`` → polling ``train`` → ``export-hf
--model_type dpr``. Both CLIs start from one JAX msgpack checkpoint, so
the port reads the JAX package's checkpoints along the way: the same
caches byte for byte, the per-epoch history within 1e-4, the same
training file and sidecar from one checkpoint, and an exported
``model_dict`` equal to ``ance export-hf``'s key for key and bit for
bit."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dpr_data import FakeBertFactory, _tree_bytes, _write_raw

torch.set_num_threads(1)

SEQ = 24
TINY = {"vocab_size": 520, "hidden_size": 64, "num_layers": 2,
        "num_heads": 4, "intermediate_size": 128,
        "max_position_embeddings": 32, "hidden_dropout": 0.0,
        "attention_dropout": 0.0}
OVERRIDES = json.dumps(dict(TINY, initializer_range=0.5))


@pytest.fixture()
def fake_tokenizers(monkeypatch):
    from ance_tpu import cli as jax_cli
    from ance_tpu_torch import cli as port_cli
    monkeypatch.setattr(jax_cli, "_tokenizer_factory",
                        lambda name, model_dir: FakeBertFactory())
    monkeypatch.setattr(port_cli, "TokenizerFactory",
                        lambda name, model_dir: FakeBertFactory())


def _json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_dpr_cli_flow_matches_ance(tmp_path, capsys, fake_tokenizers):
    from ance_tpu import cli as jax_cli
    from ance_tpu.models.dot_models import BiEncoder as JaxBiEncoder
    from ance_tpu.models.transformer import EncoderConfig as JaxConfig
    from ance_tpu.train import checkpoint as jax_ckpt
    from ance_tpu_torch import cli as port_cli
    from ance_tpu_torch.models.registry import get_model_spec
    from ance_tpu_torch.train import checkpoint as ckpt

    wiki, qd, ad = _write_raw(tmp_path, np.random.RandomState(11))
    # 1. preprocess-dpr: the same caches and files byte for byte
    printed = {}
    for name, main in (("port", port_cli.main), ("jax", jax_cli.main)):
        main(["preprocess-dpr", "--model_type", "dpr", "--wiki_dir",
              str(wiki), "--question_dir", str(qd), "--answer_dir", str(ad),
              "--out_data_dir", str(tmp_path / f"data_{name}"),
              "--max_seq_length", str(SEQ), "--num_processes", "1"])
        printed[name] = _json(capsys)
    assert printed["port"] == printed["jax"]
    assert printed["port"]["train"] == 7
    assert _tree_bytes(tmp_path / "data_port") == \
        _tree_bytes(tmp_path / "data_jax")
    data = str(tmp_path / "data_port")

    # one JAX checkpoint both trainers start from
    jm = JaxBiEncoder(JaxConfig.bert_base(attention_impl="xla",
                                          initializer_range=0.5, **TINY))
    ids = jnp.ones((2, 8), jnp.int32)
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(0), ids, ids)["params"])
    jax_ckpt.save_checkpoint(str(tmp_path / "init"), 0, params)
    init = str(tmp_path / "init" / "checkpoint-0")

    # 2. train --num_epoch 2 --dev_data, accumulation 2 (GradCache)
    common = ["--model_type", "dpr", "--encoder_overrides", OVERRIDES,
              "--max_seq_length", str(SEQ), "--max_query_length", str(SEQ)]
    train = ["train", *common, "--model_name_or_path", init, "--data_dir",
             data, "--num_epoch", "2", "--dev_data", data + "/dev-data",
             "--per_device_train_batch_size", "2",
             "--gradient_accumulation_steps", "2", "--optimizer", "lamb",
             "--learning_rate", "1e-3", "--warmup_steps", "0"]
    port_cli.main(train + ["--device", "cpu", "--output_dir",
                           str(tmp_path / "port_ckpt")])
    got = _json(capsys)
    jax_cli.main(train + ["--no_data_parallel", "--output_dir",
                          str(tmp_path / "jax_ckpt")])
    want = _json(capsys)
    history = got["history"]
    assert [(h["epoch"], h["step"]) for h in history] == \
        [(h["epoch"], h["step"]) for h in want] == [(0, 3), (1, 6)]
    # the dev evaluation reads the dev questions: each epoch's numbers
    # against JAX evaluate_dev on the dev-query cache at the JAX trainer's
    # checkpoint of that epoch (``ance train`` itself passes train-query,
    # which the last assert shows gives other numbers)
    from ance_tpu.data.cache import TokenCache
    from ance_tpu.train import dpr_trainer as jdpr
    with TokenCache(data + "/dev-query") as dc, \
            TokenCache(data + "/passages") as pc:
        for g, w in zip(history, want):
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)
            params = jax_ckpt.load_raw_params(
                str(tmp_path / "jax_ckpt" / f"checkpoint-{g['step']}"))
            nll, ratio = jdpr.evaluate_dev(jm, params, dc, pc,
                                           data + "/dev-data", batch_size=2)
            np.testing.assert_allclose(g["dev_nll"], nll, rtol=1e-4)
            assert g["dev_correct_ratio"] == ratio
            assert not np.isclose(g["dev_nll"], w["dev_nll"], rtol=1e-4)
    assert got["steps"] == 6 and len(got["loss"]) == 6
    assert got["params"].endswith("params.msgpack")

    # 3. generate-dpr from the JAX trainer's msgpack checkpoint: the port
    #    and ance write the same files
    gen = ["generate-dpr", *common, "--data_dir", data, "--wiki_path",
           str(wiki / "psgs_w100.tsv"), "--test_qas", str(ad / "nq-test.csv"),
           "--trivia_qas", str(ad / "trivia-test.csv"), "--training_dir",
           str(tmp_path / "jax_ckpt"), "--topk_training", "8",
           "--negative_sample", "3", "--per_device_eval_batch_size", "8"]
    port_cli.main(gen + ["--device", "cpu", "--output_dir",
                         str(tmp_path / "ann_port")])
    summary = _json(capsys)
    jax_cli.main(gen + ["--output_dir", str(tmp_path / "ann_jax")])
    capsys.readouterr()
    assert summary["checkpoint"] == str(tmp_path / "jax_ckpt" /
                                        "checkpoint-6")
    for name in ("ann_training_data_0", "ann_ndcg_0"):
        assert (tmp_path / "ann_port" / name).read_bytes() == \
            (tmp_path / "ann_jax" / name).read_bytes(), name
    assert set(summary) >= {"top20", "top100", "top20_trivia",
                            "top100_trivia", "seconds"}

    # 4. the polling trainer on that file, from the port's checkpoint
    port_cli.main(["train", *common, "--device", "cpu", "--data_dir", data,
                   "--model_name_or_path", str(tmp_path / "port_ckpt"),
                   "--ann_dir", str(tmp_path / "ann_port"), "--output_dir",
                   str(tmp_path / "poll"), "--max_steps", "2",
                   "--save_steps", "2", "--per_device_train_batch_size", "2",
                   "--warmup_steps", "0"])
    polled = _json(capsys)
    assert polled["steps"] == 2 and all(np.isfinite(polled["loss"]))
    assert polled["params"].endswith("checkpoint-6/pytorch_model.bin")
    assert ckpt.is_complete(str(tmp_path / "poll" / "checkpoint-2"))

    # 5. export-hf --model_type dpr: from the JAX checkpoint, the same
    #    model_dict as ance's; from the port's, loads strictly and encodes
    #    as the checkpoint does
    for name, main in (("port", port_cli.main), ("jax", jax_cli.main)):
        main(["export-hf", *common, "--training_dir",
              str(tmp_path / "jax_ckpt"), "--out_dir",
              str(tmp_path / f"export_{name}")])
        out = _json(capsys)
        assert out["step"] == 6 and out["exported"] == str(
            tmp_path / f"export_{name}" / "checkpoint-6")
    a = torch.load(tmp_path / "export_port" / "checkpoint-6",
                   weights_only=True)
    b = torch.load(tmp_path / "export_jax" / "checkpoint-6",
                   weights_only=True)
    assert sorted(a) == sorted(b)
    assert (a["offset"], a["epoch"], a["optimizer_dict"]) == \
        (b["offset"], b["epoch"], b["optimizer_dict"]) == (6, 0, {})
    assert sorted(a["model_dict"]) == sorted(b["model_dict"])
    for key, value in b["model_dict"].items():
        assert a["model_dict"][key].dtype == value.dtype == torch.float32
        assert torch.equal(a["model_dict"][key], value), key
    port_cli.main(["export-hf", *common, "--training_dir",
                   str(tmp_path / "poll"), "--out_dir",
                   str(tmp_path / "export_poll")])
    assert _json(capsys)["step"] == 2
    exported = torch.load(tmp_path / "export_poll" / "checkpoint-2",
                          weights_only=True)["model_dict"]
    embs = []
    for source in ("export", "checkpoint"):
        model = get_model_spec("dpr").build(
            config_overrides=json.loads(OVERRIDES), seed=3)
        if source == "export":
            from ance_tpu_torch.models.weights import load_weights
            load_weights(model, exported)  # strict, poolers dropped
        else:
            ckpt.load_params(str(tmp_path / "poll" / "checkpoint-2"), model)
        ids = torch.as_tensor(np.random.RandomState(2).randint(4, 500,
                                                               (3, SEQ)))
        mask = torch.ones_like(ids)
        with torch.inference_mode():
            embs.append(model(ids, mask, ids, mask))
    for x, y in zip(*embs):
        assert torch.equal(x, y)
    assert os.listdir(tmp_path / "export_poll") == ["checkpoint-2"]


def test_dpr_cli_refusals(tmp_path, fake_tokenizers):
    """--num_epoch needs the DPR model; a DPR export of a RobertaDot
    checkpoint and a DPR train from a plain BERT directory are refused."""
    from ance_tpu_torch.cli import main
    from ance_tpu_torch.models.registry import get_model_spec
    from ance_tpu_torch.train import checkpoint as ckpt
    with pytest.raises(SystemExit, match="use --model_type dpr"):
        main(["train", "--device", "cpu", "--data_dir", str(tmp_path),
              "--output_dir", str(tmp_path), "--num_epoch", "1"])
    rdot = get_model_spec("rdot_nll").build(config_overrides={
        "num_layers": 1, "hidden_size": 16, "num_heads": 2,
        "intermediate_size": 32, "vocab_size": 50})
    ckpt.save_checkpoint(str(tmp_path / "rdot"), 3, rdot)
    with pytest.raises(SystemExit, match="not a BiEncoder checkpoint"):
        main(["export-hf", "--model_type", "dpr", "--training_dir",
              str(tmp_path / "rdot"), "--out_dir", str(tmp_path / "out")])
    bert = {k.split(".", 1)[1]: v for k, v in get_model_spec("dpr").build(
        config_overrides=json.loads(OVERRIDES)).state_dict().items()
        if k.startswith("ctx_model.")}
    os.makedirs(tmp_path / "bert")
    torch.save(bert, tmp_path / "bert" / "pytorch_model.bin")
    with pytest.raises(RuntimeError, match="Missing key"):
        main(["train", "--device", "cpu", "--model_type", "dpr",
              "--encoder_overrides", OVERRIDES, "--model_name_or_path",
              str(tmp_path / "bert"), "--data_dir", str(tmp_path),
              "--output_dir", str(tmp_path), "--num_epoch", "1"])
