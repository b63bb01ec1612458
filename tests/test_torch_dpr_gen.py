"""The port's DPR generator (``train/dpr_gen.py``) and fixed-epoch trainer
(``train/dpr_trainer.py::run_dpr_epochs`` / ``evaluate_dev``, the DPR feed
of ``run_trainer_job``) against the JAX package's on the same preprocessed
caches and weights: the training file and the sidecar byte for byte, the
hit curves and the mined negatives on the same ranked ids, the per-epoch
history within the stated tolerances and checkpoints that load."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dpr_data import FakeBertFactory, _write_raw

torch.set_num_threads(1)

SEQ = 24
# the fake tokenizer's ids run to 503 (pad 0, CLS 2, SEP 3)
TINY = {"vocab_size": 520, "hidden_size": 64, "num_layers": 2,
        "num_heads": 4, "intermediate_size": 128,
        "max_position_embeddings": 32, "hidden_dropout": 0.0,
        "attention_dropout": 0.0}


@pytest.fixture(scope="module")
def dpr_data(tmp_path_factory):
    """preprocess-dpr output (NQ mode) of ``_write_raw``'s files, the
    loaders' views of it, and JAX BiEncoder weights at init std 0.5 (a
    tiny encoder at 0.05 ranks near-ties) with the port's twin."""
    from ance_tpu.models.dot_models import BiEncoder as JaxBiEncoder
    from ance_tpu.models.transformer import EncoderConfig as JaxConfig
    from ance_tpu_torch.data import dpr
    from ance_tpu_torch.models.dot_models import BiEncoder
    from ance_tpu_torch.models.transformer import EncoderConfig
    from ance_tpu_torch.models.weights import state_dict_from_flax
    root = tmp_path_factory.mktemp("dpr")
    wiki, qd, ad = _write_raw(root, np.random.RandomState(7))
    out = str(root / "data")
    dpr.preprocess_dpr(dpr.DprPreprocessConfig(
        wiki_dir=str(wiki), question_dir=str(qd), answer_dir=str(ad),
        out_data_dir=out, max_seq_length=SEQ, num_processes=1),
        FakeBertFactory())
    pid2offset, _ = dpr.load_mapping(out, "pid2offset")
    texts = {pid2offset[p]: t for p, t in dpr.load_passage_texts(
        str(wiki / "psgs_w100.tsv")).items()}
    jm = JaxBiEncoder(JaxConfig.bert_base(attention_impl="xla",
                                          initializer_range=0.5, **TINY))
    ids = jnp.ones((2, 8), jnp.int32)
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(0), ids, ids)["params"])
    pm = BiEncoder(EncoderConfig.bert_base(attention_impl="xla", **TINY))
    pm.load_state_dict(state_dict_from_flax(params), strict=True)
    return {"root": root, "out": out, "wiki": str(wiki), "answers": str(ad),
            "texts": texts, "jm": jm, "params": params, "pm": pm.eval(),
            "train_answers": dpr.load_answers(out + "/train-ann"),
            "positives": dpr.load_positive_ids(out + "/train-data"),
            "test_answers": dpr.load_qas_answers(str(ad / "nq-test.csv")),
            "trivia_answers": dpr.load_qas_answers(
                str(ad / "trivia-test.csv"))}


def _generate(d, package, out_dir, **kw):
    from ance_tpu_torch.data.cache import TokenCache
    caches = {name: TokenCache(f"{d['out']}/{path}") for name, path in (
        ("train_query_cache", "train-query"),
        ("test_query_cache", "test-query"),
        ("trivia_test_query_cache", "trivia-test-query"),
        ("passage_cache", "passages"))}
    common = dict(output_num=2, checkpoint_path="ckpt-9",
                  passage_texts=d["texts"], train_answers=d["train_answers"],
                  test_answers=d["test_answers"],
                  trivia_test_answers=d["trivia_answers"],
                  training_query_positive_id=d["positives"],
                  output_dir=str(out_dir), topk_training=8,
                  negative_sample=3, dev_search_depth=12,
                  encode_batch_size=8, **caches, **kw)
    try:
        if package == "jax":
            from ance_tpu.models.dot_models import BiEncoder as JaxBiEncoder
            from ance_tpu.train.dpr_gen import generate_new_ann_dpr
            from ance_tpu.train.encode import make_encode_fn
            return generate_new_ann_dpr(
                params=d["params"],
                query_encode_fn=make_encode_fn(d["jm"], JaxBiEncoder.query_emb),
                body_encode_fn=make_encode_fn(d["jm"], JaxBiEncoder.body_emb),
                **common)
        from ance_tpu_torch.models.dot_models import BiEncoder
        from ance_tpu_torch.train.dpr_gen import generate_new_ann_dpr
        from ance_tpu_torch.train.encode import make_encode_fn
        return generate_new_ann_dpr(
            query_encode_fn=make_encode_fn(d["pm"], BiEncoder.query_emb, "cpu"),
            body_encode_fn=make_encode_fn(d["pm"], BiEncoder.body_emb, "cpu"),
            device="cpu", **common)
    finally:
        for c in caches.values():
            c.close()


@pytest.mark.parametrize("quantize", [None, "dims"])
def test_generate_new_ann_dpr_matches_jax(dpr_data, tmp_path, quantize):
    """The same weights and caches through both generators, an fp32 and a
    ``dims`` index: ann_training_data_2 and ann_ndcg_2 byte for byte (so
    the hit curves and the mined negatives agree), the sidecar written
    last and holding top20 / top100 / *_trivia; no mined negative holds an
    answer."""
    want = _generate(dpr_data, "jax", tmp_path / "jax",
                     index_quantize=quantize)
    got = _generate(dpr_data, "port", tmp_path / "port",
                    index_quantize=quantize)
    for name in ("ann_training_data_2", "ann_ndcg_2"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    side = json.loads((tmp_path / "port" / "ann_ndcg_2").read_text())
    assert set(side) == {"top20", "top100", "top20_trivia", "top100_trivia",
                         "checkpoint"} and side["checkpoint"] == "ckpt-9"
    for key in ("top20", "top100", "top20_trivia", "top100_trivia"):
        assert got[key] == want[key]
    assert got["index"].quantize == (quantize or None)
    data = tmp_path / "port" / "ann_training_data_2"
    assert (tmp_path / "port" / "ann_ndcg_2").stat().st_mtime_ns >= \
        data.stat().st_mtime_ns
    lines = data.read_text().splitlines()
    assert lines
    from ance_tpu_torch.evaluation.qa_validation import has_answer
    for line in lines:
        qid, pos, negs = line.split("\t")
        for neg in negs.split(","):
            assert not has_answer(dpr_data["train_answers"][int(qid)],
                                  dpr_data["texts"][int(neg)][0])
    assert got["train_neighbor_ids"].shape[1] == 8
    assert len(got["top_k_hits"]) == 12


def test_validate_and_mining_match_jax_on_the_same_ids():
    """``validate`` and ``mine_negatives_dpr`` on seeded ranked ids
    (repeats, the positive, answer-bearing candidates, which use up budget
    as in the reference) and ``write_dpr_ann_data``'s bytes."""
    from ance_tpu.train import dpr_gen as jax_gen
    from ance_tpu_torch.train import dpr_gen
    rs = np.random.RandomState(0)
    words = ["paris", "rome", "the", "moon", "x", "y", "z"]
    texts = {i: (" ".join(rs.choice(words, 5)), "t") for i in range(30)}
    answers = {q: [str(rs.choice(words[:4]))] for q in range(12)}
    closest = rs.randint(0, 30, (12, 10))
    q_ids, p_ids = np.arange(12) + 100, rs.permutation(30)
    answers = {q + 100: a for q, a in answers.items()}
    positives = {q: int(rs.randint(30)) for q in q_ids}
    assert dpr_gen.validate(texts, answers, closest, q_ids, p_ids) == \
        jax_gen.validate(texts, answers, closest, q_ids, p_ids)
    for n in (1, 3, 10):
        got = dpr_gen.mine_negatives_dpr(texts, answers, q_ids, p_ids,
                                         closest, positives, n)
        assert got == jax_gen.mine_negatives_dpr(texts, answers, q_ids, p_ids,
                                                 closest, positives, n)
    # the reference quirk: an answer-bearing candidate uses up a place
    texts = {0: ("paris is the capital", "t"), 1: ("berlin", "t"),
             2: ("rome", "t"), 3: ("madrid", "t")}
    assert dpr_gen.mine_negatives_dpr(
        texts, {7: ["paris"]}, np.array([7]), np.arange(4),
        np.array([[3, 0, 1, 2]]), {7: 3}, 2) == {7: [1]}


def test_write_dpr_ann_data_matches_jax(tmp_path):
    from ance_tpu.train import dpr_gen as jax_gen
    from ance_tpu_torch.train import dpr_gen
    args = (np.array([0, 1, 5, 3]), {0: 5, 1: 6, 5: 2, 3: 1},
            {0: [9, 8], 1: [], 5: [4], 3: [7]},
            {"top20": 0.5, "top100": 0.75, "top20_trivia": 0.25,
             "top100_trivia": 1.0}, "ckpt-1")
    dpr_gen.write_dpr_ann_data(str(tmp_path / "port"), 3, *args)
    jax_gen.write_dpr_ann_data(str(tmp_path / "jax"), 3, *args, seed=0)
    for f in ("ann_training_data_3", "ann_ndcg_3"):
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes()


def test_run_dpr_epochs_and_evaluate_dev_match_jax(dpr_data, tmp_path):
    """2 epochs of batch 2 over train-data (a fresh negative a line each
    epoch, the same shuffles), LAMB 1e-3, dropout off, a dev evaluation a
    epoch on dev-data: the same history keys and steps, each epoch's last
    loss and dev NLL within 1e-4 relative (the steps compound fp32
    rounding), the same correct ratios; the port's checkpoints and the
    JAX ones load strictly into a BiEncoder."""
    from ance_tpu.train import checkpoint as jax_ckpt
    from ance_tpu.train import dpr_trainer as jdpr
    from ance_tpu.train import trainer as jax_trainer
    from ance_tpu_torch.data.cache import TokenCache
    from ance_tpu_torch.models.dot_models import BiEncoder
    from ance_tpu_torch.models.transformer import EncoderConfig
    from ance_tpu_torch.models.weights import state_dict_from_flax
    from ance_tpu_torch.train import checkpoint as ckpt
    from ance_tpu_torch.train import dpr_trainer, trainer
    out = dpr_data["out"]
    jm, params = dpr_data["jm"], dpr_data["params"]
    pm = BiEncoder(EncoderConfig.bert_base(attention_impl="xla", **TINY))
    pm.load_state_dict(state_dict_from_flax(params))
    with TokenCache(out + "/train-query") as qc, \
            TokenCache(out + "/passages") as pc, \
            TokenCache(out + "/dev-query") as dc:
        kw = dict(query_cache=qc, passage_cache=pc,
                  train_data_path=out + "/train-data", num_epochs=2,
                  batch_size=2, shuffle_seed=5)
        jopt = jax_trainer.make_optimizer("lamb", 1e-3)
        _, want = jdpr.run_dpr_epochs(
            state=jax_trainer.init_train_state(
                jax.tree.map(jnp.asarray, params), jopt),
            train_step=jdpr.make_dpr_train_step(
                jdpr.biencoder_loss_fn(jm, deterministic=True), jopt),
            rng=jax.random.PRNGKey(0), params_of=lambda s: s.params,
            dev_eval_fn=lambda p: jdpr.evaluate_dev(
                jm, p, dc, pc, out + "/dev-data", batch_size=2),
            checkpoint_dir=str(tmp_path / "jax"), **kw)
        state = trainer.init_train_state(pm, trainer.make_optimizer(
            pm, "lamb", 1e-3))
        state, got = dpr_trainer.run_dpr_epochs(
            state=state, train_step=dpr_trainer.make_dpr_train_step(),
            generator=torch.Generator().manual_seed(0),
            dev_eval_fn=lambda m: dpr_trainer.evaluate_dev(
                m, dc, pc, out + "/dev-data", batch_size=2),
            checkpoint_dir=str(tmp_path / "port"), **kw)
    assert [sorted(h) for h in got] == [sorted(h) for h in want]
    for g, w in zip(got, want):
        assert (g["epoch"], g["step"]) == (w["epoch"], w["step"])
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)
        np.testing.assert_allclose(g["dev_nll"], w["dev_nll"], rtol=1e-4)
        assert g["dev_correct_ratio"] == w["dev_correct_ratio"]
    assert got[-1]["step"] == state.step > 0
    for name in ("port", "jax"):
        path, step = ckpt.get_latest_checkpoint(str(tmp_path / name))
        assert step == got[-1]["step"]
        fresh = BiEncoder(EncoderConfig.bert_base(**TINY))
        ckpt.load_params(path, fresh)  # strict
    assert jax_ckpt.get_latest_checkpoint(str(tmp_path / "jax"))[1] == \
        got[-1]["step"]


def test_evaluate_dev_is_deterministic_with_dropout(dpr_data):
    """Dropout in the config (0.3): two dev evaluations agree exactly (the
    towers run in eval mode), and the training loss path draws other
    masks with other generators."""
    from ance_tpu_torch.data.cache import TokenCache
    from ance_tpu_torch.models.dot_models import BiEncoder
    from ance_tpu_torch.models.transformer import EncoderConfig
    from ance_tpu_torch.train import dpr_trainer
    from ance_tpu_torch.train.trainer import batch_to_device
    out = dpr_data["out"]
    pm = BiEncoder(EncoderConfig.bert_base(
        attention_impl="xla", **dict(TINY, hidden_dropout=0.3,
                                     attention_dropout=0.3)))
    pm.load_state_dict(dpr_data["pm"].state_dict())
    with TokenCache(out + "/dev-query") as dc, \
            TokenCache(out + "/passages") as pc:
        a = dpr_trainer.evaluate_dev(pm, dc, pc, out + "/dev-data", 2)
        b = dpr_trainer.evaluate_dev(pm, dc, pc, out + "/dev-data", 2)
        batch = batch_to_device(next(dpr_trainer.dpr_dev_batches(
            dc, pc, out + "/dev-data", 2)), "cpu")
    assert a == b and a[0] > 0
    pm.train()
    with torch.no_grad():
        l1, l2 = (dpr_trainer.inbatch_loss_from_embs(
            *dpr_trainer.encode_towers(pm, batch,
                                       torch.Generator().manual_seed(s)))[0]
            for s in (1, 2))
    assert l1.item() != l2.item()
