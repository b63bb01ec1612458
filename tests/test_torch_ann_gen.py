"""The port's generator half of the ANCE loop against the JAX package's on
the same inputs: the ann-data helpers (chunk rotation, mining, the handoff
files), the copied metrics and scorers, the offline evaluators,
``generate_new_ann`` end to end through a tiny encoder with identical
weights, the ``generate`` / ``infer`` / ``eval`` / ``eval-full`` CLIs, and
the loops (``run_generator_job`` with the trainer job, ``run_ance_cycles``
learning a learnable task)."""

import json
import os
import pickle
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ance_tpu.evaluation import metrics as jax_metrics
from ance_tpu.train import ann_gen as jax_gen
from ance_tpu_torch.data.cache import TokenCache, TokenCacheWriter
from ance_tpu_torch.evaluation import metrics
from ance_tpu_torch.models.weights import state_dict_from_flax
from ance_tpu_torch.train import ann_gen
from ance_tpu_torch.train import checkpoint as ckpt

torch.set_num_threads(1)

TINY = {"num_layers": 2, "hidden_size": 32, "num_heads": 4,
        "intermediate_size": 64, "vocab_size": 100,
        "max_position_embeddings": 40}
N_PASSAGES, N_TRAIN_Q, N_DEV_Q = 128, 24, 8


# -- helpers, rotation, mining, handoff files ------------------------------

def test_query_chunk_range_matches_jax():
    for n in range(1, 13):
        for factor in range(-1, 8):
            for out in range(10):
                got = ann_gen.query_chunk_range(n, factor, out)
                assert got == jax_gen.query_chunk_range(n, factor, out)
                assert got[0] < got[1] <= n  # never an empty range
    assert ann_gen.query_chunk_range(10, 3, 2) == (6, 10)
    assert ann_gen.query_chunk_range(3, 5, 3) == (0, 1)  # clamped, wraps


@pytest.mark.parametrize("select_topk", [False, True])
def test_mine_negatives_matches_jax(select_topk):
    """Random neighbor rows over a corpus whose rows repeat ids (MaxP),
    some queries without a positive: the same negatives, in order, and the
    same MRR probe, from the same ``random.Random`` shuffles."""
    rs = np.random.RandomState(3)
    q2id = np.arange(100, 140)
    p2id = np.repeat(np.arange(30), 2)
    positives = {int(q): int(rs.randint(30)) for q in q2id[:35]}
    neighbors = np.stack([rs.permutation(60)[:20] for _ in q2id])
    got = ann_gen.mine_negatives(q2id, p2id, positives, neighbors, 4,
                                 select_topk=select_topk,
                                 rng=random.Random(9))
    want = jax_gen.mine_negatives(q2id, p2id, positives, neighbors, 4,
                                  select_topk=select_topk,
                                  rng=random.Random(9))
    assert got == want
    negs, mrr = got
    assert len(negs) == 35 and 0 < mrr <= 1
    for qid, pids in negs.items():
        assert positives[qid] not in pids and len(set(pids)) == len(pids)


def test_write_ann_data_is_byte_identical(tmp_path):
    q2id = np.array([5, 6, 7, 8, 9])
    positives = {5: 50, 7: 70, 8: 80, 9: 90}
    negs = {5: [1, 2], 7: [3], 8: [], 9: [4, 5, 6]}
    paths = [mod.write_ann_data(str(tmp_path / name), 3, q2id, positives,
                                negs, 0.25, "ckpt-x", seed=4)
             for name, mod in (("port", ann_gen), ("jax", jax_gen))]
    for got, want in zip(*paths):
        assert open(got, "rb").read() == open(want, "rb").read()
    assert ann_gen.get_latest_ann_data(str(tmp_path / "port")) == (
        3, paths[0][0], {"ndcg": 0.25, "checkpoint": "ckpt-x"})
    # the names moved from ance_loop stay importable from there
    from ance_tpu_torch.train import ance_loop
    assert ance_loop.get_latest_ann_data is ann_gen.get_latest_ann_data
    assert ance_loop.ANN_NDCG_PREFIX == jax_gen.ANN_NDCG_PREFIX


def _rankings(rs, n_q=12, n_p=40, depth=15):
    ranked = {q: [int(p) for p in rs.permutation(n_p)[:depth]]
              for q in range(n_q)}
    qrels = {q: {int(p): int(rs.randint(1, 3))
                 for p in rs.choice(n_p, rs.randint(1, 4), replace=False)}
             for q in range(n_q) if q % 5}
    return ranked, qrels


def test_copied_metrics_match_jax():
    rs = np.random.RandomState(0)
    ranked, qrels = _rankings(rs)
    binary = {q: list(r) for q, r in qrels.items()}
    assert metrics.ndcg_at_k(qrels, ranked) == jax_metrics.ndcg_at_k(
        qrels, ranked)
    assert metrics.map_at_k(qrels, ranked, 10) == jax_metrics.map_at_k(
        qrels, ranked, 10)
    assert metrics.recall_at_k(qrels, ranked, 5) == \
        jax_metrics.recall_at_k(qrels, ranked, 5)
    assert metrics.mrr_at_k(binary, ranked) == jax_metrics.mrr_at_k(
        binary, ranked)
    dup = {1: [3, 3, 0, 0], 2: [4, 5]}
    assert metrics.quality_checks(dup) == jax_metrics.quality_checks(dup)
    assert not metrics.quality_checks(dup)[0]
    neighbors = rs.randint(0, 30, (6, 20))
    q2id, p2id = np.arange(6) * 2, np.repeat(np.arange(15), 2)
    assert metrics.dedup_ranking(neighbors, q2id, p2id, 12) == \
        jax_metrics.dedup_ranking(neighbors, q2id, p2id, 12)
    dev_qrels = {int(q): {int(rs.randint(15)): 1} for q in q2id}
    assert metrics.eval_dev_ndcg(neighbors, q2id, p2id, dev_qrels) == \
        jax_metrics.eval_dev_ndcg(neighbors, q2id, p2id, dev_qrels)


def test_msmarco_scorer_matches_jax(tmp_path, capsys):
    from ance_tpu.evaluation import msmarco_eval as jax_scorer
    from ance_tpu_torch.evaluation import msmarco_eval
    ref, cand = tmp_path / "qrels.tsv", tmp_path / "cand.tsv"
    ref.write_text("1\t0\t10\t1\n2\t0\t20\t1\n3\t0\t30\t1\n")
    cand.write_text("1\t10\t1\n1\t11\t2\n2\t21\t1\n2\t20\t2\n2\t21\t3\n")
    got = msmarco_eval.compute_metrics_from_files(str(ref), str(cand))
    printed = capsys.readouterr().out
    assert got == jax_scorer.compute_metrics_from_files(str(ref), str(cand))
    assert got["MRR @10"] == pytest.approx((1 + 0.5) / 3)
    assert "multiple times" in printed  # the duplicate 21 of query 2


# -- device-touching evaluation --------------------------------------------

def _embeddings(seed, n_q=10, n_p=60, dim=16):
    rs = np.random.RandomState(seed)
    q = rs.randn(n_q, dim).astype(np.float32)
    p = rs.randn(n_p, dim).astype(np.float32)
    q_ids = np.arange(n_q, dtype=np.int64) + 500
    p_ids = np.repeat(np.arange(n_p // 2, dtype=np.int64), 2)  # MaxP rows
    qrels = {int(qid): {int(rs.randint(n_p // 2)): int(rs.randint(1, 3))}
             for qid in q_ids[:-2]}
    cands = {int(qid): [int(x) for x in rs.choice(n_p // 2, 7,
                                                  replace=False)]
             for qid in q_ids[1:]}
    return q, q_ids, p, p_ids, qrels, cands


def test_mrr_eval_matches_jax(tmp_path):
    from ance_tpu.evaluation import mrr_eval as jax_mrr
    from ance_tpu_torch.evaluation import mrr_eval
    q, q_ids, p, p_ids, qrels, cands = _embeddings(1)
    top = tmp_path / "top1000.dev"
    top.write_text("".join(f"{qid}\t{pid}\tq\tp\n" for qid, pids in
                           cands.items() for pid in pids) + "bad line\n")
    assert mrr_eval.parse_top_dev(str(top)) == \
        jax_mrr.parse_top_dev(str(top)) == cands
    pid_dict = {int(x): i for i, x in enumerate(p_ids)}
    for subset, k in (([3, 5, 9, -1, 999], 10), (list(range(30)), 4), ([], 3)):
        got = mrr_eval.get_topk_restricted(q[:1], p, pid_dict, p_ids, subset,
                                           k, device="cpu")
        want = jax_mrr.get_topk_restricted(q[:1], p, pid_dict, p_ids, subset,
                                           k)
        np.testing.assert_array_equal(got[1], want[1])
        # exact (fp64-rounded) scores against XLA's fp32 sums of 16 terms
        np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=1e-6)
    ref = {int(qid): list(r) for qid, r in qrels.items()}
    got = mrr_eval.combined_eval(q, q_ids, p, p_ids, cands, ref,
                                 device="cpu")
    assert got == pytest.approx(jax_mrr.combined_eval(q, q_ids, p, p_ids,
                                                      cands, ref), abs=0)


def test_offline_eval_matches_jax(tmp_path):
    from ance_tpu.evaluation import offline as jax_off
    from ance_tpu_torch.evaluation import offline
    q, q_ids, p, p_ids, qrels, cands = _embeddings(2)
    ranked = {int(qid): [int(x) for x in p_ids[i::7][:10]]
              for i, qid in enumerate(q_ids)}
    assert offline.hole_rate(qrels, ranked) == jax_off.hole_rate(qrels,
                                                                 ranked)
    for topn in (1000, 9):
        assert offline.full_ranking_eval(q, q_ids, p, p_ids, qrels, topn,
                                         device="cpu") == \
            jax_off.full_ranking_eval(q, q_ids, p, p_ids, qrels, topn)
    got = offline.rerank_eval(q, q_ids, p, p_ids, cands, qrels, k=5,
                              device="cpu")
    assert got == jax_off.rerank_eval(q, q_ids, p, p_ids, cands, qrels, k=5)
    assert list(got) == ["ndcg_10", "hole_rate_10", "mrr_10"]
    for rank, part in enumerate((p[:25], p[25:])):
        path = offline.save_embedding_shard(str(tmp_path / "p"), part, rank)
        assert path == jax_off.save_embedding_shard(
            str(tmp_path / "jp"), part, rank).replace("jp", "p")
    np.testing.assert_array_equal(
        offline.load_embedding_shards(str(tmp_path / "p")), p)


class _Tok:
    pad_token_id = 1

    def encode(self, text, add_special_tokens=True, max_length=None):
        return [0] + [3 + len(w) for w in text.split()] + [2]


def test_dual_batches_and_embed_text_file_match_jax(tmp_path):
    from ance_tpu.data.process_fn import dual_batches as jax_dual
    from ance_tpu.evaluation import mrr_eval as jax_mrr
    from ance_tpu_torch.evaluation import mrr_eval
    lines = [f"{100 + i}\t{' '.join('w' * (j % 5 + 1) for j in range(i))}\n"
             for i in range(11)]
    for got, want in zip(mrr_eval.dual_batches(_Tok(), lines, 4, 6),
                         jax_dual(_Tok(), lines, 4, 6), strict=True):
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])
    path = tmp_path / "texts.tsv"
    path.write_text("".join(lines))
    got = mrr_eval.embed_text_file(
        lambda ids, mask: torch.as_tensor(ids * mask).float()[:, :4],
        _Tok(), str(path), 6, batch_size=4)
    want = jax_mrr.embed_text_file(
        lambda params, ids, mask: (ids * mask).astype(jnp.float32)[:, :4],
        None, _Tok(), str(path), 6, batch_size=4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# -- generate_new_ann and the CLIs, identical weights -----------------------

def _write_cache(path, n, seq, rs):
    lengths = rs.randint(3, seq + 1, n)
    with TokenCacheWriter(str(path), seq) as w:
        for length in lengths:
            row = np.ones(seq, np.int32)
            row[0] = 0
            row[1:length] = rs.randint(3, TINY["vocab_size"], length - 1)
            w.write(int(length), row)


@pytest.fixture(scope="module")
def gen_inputs(tmp_path_factory):
    """Caches (128 passages at seq 16, 24 train and 8 dev queries at seq
    8), offset-space qrels (dev graded), and JAX-initialised tiny
    RobertaDot weights at init std 0.5 (a random tiny encoder at 0.02 maps
    every text to nearly one embedding): a JAX-native checkpoint-4 and the
    same weights as a port checkpoint-4."""
    from ance_tpu.models.registry import get_model_spec as jax_spec
    from ance_tpu.train import checkpoint as jax_ckpt
    from ance_tpu_torch.models.registry import get_model_spec

    root = tmp_path_factory.mktemp("gen")
    data = root / "data"
    data.mkdir()
    rs = np.random.RandomState(0)
    _write_cache(data / "passages", N_PASSAGES, 16, rs)
    _write_cache(data / "train-query", N_TRAIN_Q, 8, rs)
    _write_cache(data / "dev-query", N_DEV_Q, 8, rs)
    with open(data / "train-qrel.tsv", "w") as f:
        for q in range(N_TRAIN_Q - 3):  # the last 3 have no positive
            f.write(f"{q}\t{rs.randint(N_PASSAGES)}\t1\n")
    with open(data / "dev-qrel.tsv", "w") as f:
        for q in range(N_DEV_Q):
            for p in rs.choice(N_PASSAGES, 3, replace=False):
                f.write(f"{q}\t{p}\t{rs.randint(1, 3)}\n")
    model = jax_spec("rdot_nll").build(
        config_overrides=dict(TINY, initializer_range=0.5))
    ids = jnp.ones((2, 8), jnp.int32)
    params = jax.jit(model.init)(jax.random.PRNGKey(7), ids, ids)["params"]
    params = jax.tree.map(np.asarray, params)
    jax_ckpt.save_checkpoint(str(root / "jax_train"), 4, params)
    port_model = get_model_spec("rdot_nll").build(config_overrides=TINY)
    port_model.load_state_dict(state_dict_from_flax(params))
    ckpt.save_checkpoint(str(root / "port_train"), 4, port_model)
    return root, data, params, port_model


def _assert_ids_equal_at_clear_gaps(got_ids, want_scores, want_ids):
    """Neighbor ids equal wherever the reference score is more than 1e-4
    + 2e-6·|score| from both neighbours (scores of |s| ~ 10²-10³: a few
    fp32 ulps of two encoders summing in other orders could swap closer
    pairs)."""
    tol = 1e-4 + 2e-6 * np.abs(want_scores[:, :-1])
    gaps = want_scores[:, :-1] - want_scores[:, 1:]
    clear = np.ones_like(want_scores, bool)
    clear[:, :-1] &= gaps > tol
    clear[:, 1:] &= gaps > tol
    np.testing.assert_array_equal(got_ids[clear], want_ids[clear])
    return clear.mean()


@pytest.mark.parametrize("quantize", [None, "dims"])
def test_generate_new_ann_matches_jax(gen_inputs, tmp_path, quantize):
    """The same weights, caches and qrels through both packages'
    generate_new_ann: the same passage ids, dev NDCG, MRR probe and
    handoff files byte for byte; the mining search's ids equal the JAX
    encoder's exact neighbours at every well-separated score."""
    from ance_tpu.data.cache import TokenCache as JaxCache
    from ance_tpu.index.flat import knn_inner_product
    from ance_tpu.models.dot_models import RobertaDot as JaxDot
    from ance_tpu.models.registry import get_model_spec as jax_spec
    from ance_tpu.train.ance_loop import load_offset_qrels
    from ance_tpu.train.encode import encode_cache as jax_encode
    from ance_tpu.train.encode import make_encode_fn as jax_encode_fn
    from ance_tpu_torch.models.dot_models import RobertaDot
    from ance_tpu_torch.ops.topk import blockmax_scores
    from ance_tpu_torch.train.ance_loop import positives_from_qrels
    from ance_tpu_torch.train.encode import make_encode_fn

    root, data, params, model = gen_inputs
    train_qrels = load_offset_qrels(str(data / "train-qrel.tsv"))
    dev_qrels = load_offset_qrels(str(data / "dev-qrel.tsv"))
    cfg = dict(topk_training=20, negative_sample=4, ann_chunk_factor=2,
               ann_measure_topk_mrr=True, dev_search_depth=30,
               encode_batch_size=8, index_quantize=quantize)
    names = ("dev-query", "passages", "train-query")
    jmodel = jax_spec("rdot_nll").build(config_overrides=TINY)
    jq, jb = (jax_encode_fn(jmodel, m) for m in
              (JaxDot.query_emb, JaxDot.body_emb))
    jcaches = [JaxCache(str(data / n)).open() for n in names]
    want = jax_gen.generate_new_ann(
        jax_gen.AnnGenConfig(**cfg), output_num=1, checkpoint_path="ck",
        params=params, query_encode_fn=jq, body_encode_fn=jb,
        dev_query_cache=jcaches[0], passage_cache=jcaches[1],
        train_query_cache=jcaches[2],
        training_query_positive_id=positives_from_qrels(train_qrels),
        dev_query_positive_id=dev_qrels, output_dir=str(tmp_path / "jax"))
    caches = [TokenCache(str(data / n)).open() for n in names]
    before = blockmax_scores.launches
    got = ann_gen.generate_new_ann(
        ann_gen.AnnGenConfig(**cfg), output_num=1, checkpoint_path="ck",
        query_encode_fn=make_encode_fn(model, RobertaDot.query_emb, "cpu"),
        body_encode_fn=make_encode_fn(model, RobertaDot.body_emb, "cpu"),
        dev_query_cache=caches[0], passage_cache=caches[1],
        train_query_cache=caches[2],
        training_query_positive_id=positives_from_qrels(train_qrels),
        dev_query_positive_id=dev_qrels, output_dir=str(tmp_path / "port"),
        device="cpu")
    assert blockmax_scores.launches == before  # CPU: the plain version
    np.testing.assert_array_equal(got["passage_embedding2id"],
                                  want["passage_embedding2id"])
    assert got["num_queries_dev"] == want["num_queries_dev"] == N_DEV_Q
    assert got["dev_ndcg"] == want["dev_ndcg"]
    assert got["ann_mrr"] == want["ann_mrr"]
    for key in ("data_path", "ndcg_path"):
        assert open(got[key], "rb").read() == open(want[key], "rb").read()
    # rotation: output 1 of 2 chunks mines the second half of the queries
    q_start, q_end = ann_gen.query_chunk_range(N_TRAIN_Q, 2, 1)
    assert got["train_neighbor_ids"].shape == (q_end - q_start, 20)
    p_emb, _ = jax_encode(jb, params, jcaches[1], 8)
    t_emb, _ = jax_encode(jq, params, jcaches[2], 8, start=q_start,
                          stop=q_end)
    if quantize == "dims":  # what the index holds: the JAX index's codes
        scales = np.asarray(want["index"]._scales)
        p_emb = np.asarray(want["index"]._emb)[:N_PASSAGES].astype(
            np.float32)
        t_emb = t_emb * scales
    s, i = knn_inner_product(t_emb, p_emb, 20)
    share = _assert_ids_equal_at_clear_gaps(
        got["train_neighbor_ids"], np.asarray(s), np.asarray(i))
    assert share >= 0.95
    for c in jcaches + caches:
        c.close()


def _cli_flags(data, extra=()):
    return ["--model_type", "rdot_nll", "--encoder_overrides",
            json.dumps(TINY), "--data_dir", str(data),
            "--max_seq_length", "16", "--max_query_length", "8",
            "--per_device_eval_batch_size", "8", "--topk_training", "16",
            "--negative_sample", "3", "--ann_chunk_factor", "1", *extra]


def test_cli_generate_infer_eval_full_match_jax(gen_inputs, tmp_path,
                                                capsys):
    """``cli generate`` / ``infer`` / ``eval-full`` (full ranking and the
    --candidates rerank with id maps) against ``ance`` on the same caches
    and checkpoint: byte-identical handoff files, equal embedding shards,
    equal metrics; eval-full's ndcg_10 on the infer dump equals
    generate's dev_ndcg within 1e-12 (the verify skill's cross-check)."""
    from ance_tpu.cli import main as jax_main
    from ance_tpu_torch.cli import main as port_main

    root, data, _, _ = gen_inputs
    outs = {}
    for who, main, extra in (("jax", jax_main, []),
                             ("port", port_main, ["--device", "cpu"])):
        train = ["--training_dir", str(root / f"{who}_train")]
        main(["generate", *_cli_flags(data, train + extra),
              "--output_dir", str(tmp_path / who / "ann")])
        gen = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        main(["infer", *_cli_flags(data, train + extra),
              "--output_dir", str(tmp_path / who / "emb")])
        capsys.readouterr()
        outs[who] = gen
    ann = {w: tmp_path / w / "ann" for w in outs}
    assert (ann["port"] / "ann_training_data_0").read_bytes() == \
        (ann["jax"] / "ann_training_data_0").read_bytes()
    metas = {w: json.loads((ann[w] / "ann_ndcg_0").read_text()) for w in ann}
    assert metas["port"]["ndcg"] == metas["jax"]["ndcg"] == \
        outs["port"]["dev_ndcg"]
    assert all(m["checkpoint"].endswith("checkpoint-4")
               for m in metas.values())
    assert outs["port"]["checkpoint"].endswith("checkpoint-4")

    def shards(who, name):
        return np.load(tmp_path / who / "emb" / f"step0_{name}_data_obj_0.npy")

    for name in ("passage_embid_p_", "dev_query_embid_p_"):
        np.testing.assert_array_equal(shards("port", name),
                                      shards("jax", name))
    for name in ("passage_emb_p_", "dev_query_emb_p_"):
        got, want = shards("port", name), shards("jax", name)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)

    # eval-full: full ranking, then the rerank over real-id candidates
    rs = np.random.RandomState(5)
    with open(data / "pid2offset.pickle", "wb") as f:
        pickle.dump({1000 + p: p for p in range(N_PASSAGES)}, f)
    with open(data / "dev-query_qid2offset.pickle", "wb") as f:
        pickle.dump({2000 + q: q for q in range(N_DEV_Q)}, f)
    cand = tmp_path / "top1000.dev"
    cand.write_text("".join(
        f"{2000 + q}\t{1000 + p}\tq\tp\n" for q in range(N_DEV_Q)
        for p in rs.choice(N_PASSAGES, 12, replace=False)))
    results = {}
    for who, main, extra in (("jax", jax_main, []),
                             ("port", port_main, ["--device", "cpu"])):
        pre = str(tmp_path / who / "emb" / "step0")
        common = ["eval-full", "--query_prefix", pre + "_dev_query_emb_p_",
                  "--query_id_prefix", pre + "_dev_query_embid_p_",
                  "--passage_prefix", pre + "_passage_emb_p_",
                  "--passage_id_prefix", pre + "_passage_embid_p_",
                  "--qrels", str(data / "dev-qrel.tsv"), *extra]
        main(common)
        full = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        main(common + ["--candidates", str(cand), "--data_dir", str(data)])
        rerank = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        results[who] = (full, rerank)
    assert results["port"] == results["jax"]
    # the same per-query values, averaged by sum()/n in generate and by
    # np.mean in eval-full: equal up to the last bit or two
    assert results["port"][0]["ndcg_10"] == pytest.approx(
        outs["port"]["dev_ndcg"], abs=1e-12, rel=0)
    assert set(results["port"][1]) == {"ndcg_10", "hole_rate_10", "mrr_10"}


def test_cli_eval_matches_jax(tmp_path, capsys):
    from ance_tpu.cli import main as jax_main
    from ance_tpu_torch.cli import main as port_main
    ref, cand = tmp_path / "qrels.tsv", tmp_path / "run.tsv"
    ref.write_text("7\t0\t70\t1\n8\t0\t80\t1\n")
    cand.write_text("7\t71\t1\n7\t70\t2\n8\t80\t1\n")
    jax_main(["eval", str(ref), str(cand)])
    want = capsys.readouterr().out
    port_main(["eval", str(ref), str(cand)])
    assert capsys.readouterr().out == want
    assert "MRR @10: 0.75" in want


def test_cli_generate_refuses_missing_cuda(gen_inputs, tmp_path):
    from ance_tpu_torch.cli import main as port_main
    root, data, _, _ = gen_inputs
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA is not available"):
            port_main(["generate", *_cli_flags(data), "--training_dir",
                       str(root / "port_train"), "--output_dir",
                       str(tmp_path)])
    with pytest.raises(SystemExit, match="not ported"):
        port_main(["infer", *_cli_flags(data), "--model_type", "dpr",
                   "--device", "cpu", "--training_dir", str(tmp_path),
                   "--output_dir", str(tmp_path)])


def test_cli_generate_cites_the_checkpoint_it_loaded(gen_inputs, tmp_path,
                                                     capsys):
    """A training directory given as ``--model_name_or_path`` (beside an
    empty ``--training_dir``) warm-starts from its newest checkpoint; the
    handoff file and the printed JSON name that checkpoint, and equal
    those of the same directory given as ``--training_dir``."""
    from ance_tpu_torch.cli import main as port_main
    root, data, _, _ = gen_inputs
    train = str(root / "port_train")
    (tmp_path / "empty").mkdir()
    metas = {}
    for flags in (["--model_name_or_path", train, "--training_dir",
                   str(tmp_path / "empty")], ["--training_dir", train]):
        out = tmp_path / flags[0].strip("-")
        port_main(["generate", *_cli_flags(data, flags), "--device", "cpu",
                   "--output_dir", str(out)])
        printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        metas[flags[0]] = json.loads((out / "ann_ndcg_0").read_text())
        assert printed["checkpoint"] == metas[flags[0]]["checkpoint"] == \
            os.path.join(train, "checkpoint-4")
    assert metas["--model_name_or_path"] == metas["--training_dir"]


# -- the loops --------------------------------------------------------------

def _vocab_task(tmp_path, init_range):
    """tests/test_ann_loop.py's learnable task (query class c ↔ its
    passage, disjoint query and passage vocabularies), its encoder and
    JAX-initialised weights; → (caches, train qrels, dev qrels, port
    model, flax params)."""
    from ance_tpu.models.dot_models import RobertaDot as JaxDot
    from ance_tpu.models.transformer import EncoderConfig as JaxConfig
    from ance_tpu_torch.models.dot_models import RobertaDot
    from ance_tpu_torch.models.transformer import EncoderConfig
    from test_ann_loop import QLEN, VOCAB, _build_corpus

    paths, train_qrels, dev_qrels = _build_corpus(tmp_path)
    geometry = dict(vocab_size=VOCAB, hidden_size=32, num_layers=2,
                    num_heads=4, intermediate_size=64,
                    max_position_embeddings=32, pad_token_id=1,
                    hidden_dropout=0.0, attention_dropout=0.0,
                    initializer_range=init_range)
    jmodel = JaxDot(JaxConfig(**geometry), out_dim=16)
    params = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((2, QLEN), jnp.int32),
        jnp.ones((2, QLEN), jnp.int32))["params"]
    params = jax.tree.map(np.asarray, params)
    model = RobertaDot(EncoderConfig(**geometry), out_dim=16)
    model.load_state_dict(state_dict_from_flax(params))
    return paths, train_qrels, dev_qrels, model.eval(), jmodel, params


def test_generator_job_and_trainer_job_hand_off(tmp_path):
    """tests/test_two_job_compat.py's set-up through the port: the
    generator's first pass (no checkpoint: the initial weights) writes
    ann data 0, byte for byte the JAX generator job's on the same weights;
    the trainer job picks it up and checkpoints at 3 and 6; the
    generator's next pass loads checkpoint-6 and writes ann data 1 citing
    it. Init std 0.5, so the tiny encoder has no near-tied scores."""
    from ance_tpu.train.ance_loop import run_generator_job as jax_job
    from ance_tpu.train.encode import make_encode_fn as jax_encode_fn
    from ance_tpu_torch.models.dot_models import RobertaDot
    from ance_tpu_torch.optim.schedules import warmup_linear
    from ance_tpu_torch.train import trainer
    from ance_tpu_torch.train.ance_loop import (AnceCycleConfig,
                                                run_generator_job,
                                                run_trainer_job)
    from ance_tpu_torch.train.encode import make_encode_fn

    paths, train_qrels, dev_qrels, model, jmodel, params = _vocab_task(
        tmp_path, 0.5)
    gen_cfg = dict(topk_training=16, negative_sample=4, ann_chunk_factor=1,
                   dev_search_depth=16, encode_batch_size=32)
    caches = {n: TokenCache(paths[n]).open()
              for n in ("passages", "train-query", "dev-query")}
    jax_ann = str(tmp_path / "jax_ann")
    from ance_tpu.data.cache import TokenCache as JaxCache
    jcaches = {n: JaxCache(paths[n]).open() for n in caches}
    jax_job(jax_gen.AnnGenConfig(**gen_cfg),
            training_dir=str(tmp_path / "none"), init_params=params,
            load_params=None,
            query_encode_fn=jax_encode_fn(jmodel, type(jmodel).query_emb),
            body_encode_fn=jax_encode_fn(jmodel, type(jmodel).body_emb),
            dev_query_cache=jcaches["dev-query"],
            passage_cache=jcaches["passages"],
            train_query_cache=jcaches["train-query"],
            train_qrels=train_qrels, dev_qrels=dev_qrels,
            output_dir=jax_ann, max_iterations=1, poll_interval=0.0)

    ann_dir, training_dir = str(tmp_path / "ann"), str(tmp_path / "train")
    loaded = []

    def load_params(path):
        loaded.append(path)
        ckpt.load_checkpoint(path, model)

    def generate():
        return run_generator_job(
            ann_gen.AnnGenConfig(**gen_cfg), training_dir=training_dir,
            load_params=load_params,
            query_encode_fn=make_encode_fn(model, RobertaDot.query_emb,
                                           "cpu"),
            body_encode_fn=make_encode_fn(model, RobertaDot.body_emb, "cpu"),
            dev_query_cache=caches["dev-query"],
            passage_cache=caches["passages"],
            train_query_cache=caches["train-query"],
            train_qrels=train_qrels, dev_qrels=dev_qrels,
            output_dir=ann_dir, device="cpu", max_iterations=1,
            poll_interval=0.0)

    history = generate()
    assert len(history) == 1 and history[0]["checkpoint"] is None
    assert "index" not in history[0] and not loaded
    data_no, data_path, meta = ann_gen.get_latest_ann_data(ann_dir)
    assert data_no == 0 and meta["checkpoint"] == "<init>"
    assert open(data_path, "rb").read() == open(
        os.path.join(jax_ann, "ann_training_data_0"), "rb").read()
    assert meta["ndcg"] == json.load(open(os.path.join(jax_ann,
                                                       "ann_ndcg_0")))["ndcg"]

    state = trainer.init_train_state(model, trainer.make_optimizer(
        model, "lamb", warmup_linear(5e-3, 5, 2000)))
    state = run_trainer_job(
        AnceCycleConfig(batch_size=16, shuffle_seed=1, feed_workers=0),
        state=state, train_step=trainer.make_train_step(
            trainer.triplet_loss_fn()),
        generator=torch.Generator().manual_seed(2),
        query_cache=caches["train-query"], passage_cache=caches["passages"],
        ann_dir=ann_dir, training_dir=training_dir, max_steps=6,
        poll_every=2, save_every=3, poll_interval=0.0)
    assert state.step == 6
    assert ckpt.get_latest_checkpoint(training_dir)[1] == 6

    model.eval()
    history = generate()
    assert history[0]["checkpoint"].endswith("checkpoint-6")
    assert loaded == [history[0]["checkpoint"]]
    data_no, _, meta = ann_gen.get_latest_ann_data(ann_dir)
    assert data_no == 1 and meta["checkpoint"].endswith("checkpoint-6")
    for c in list(caches.values()) + list(jcaches.values()):
        c.close()


def test_ance_cycles_learn_the_vocab_task(tmp_path):
    """tests/test_ann_loop.py:155's run through the port's
    ``run_ance_cycles`` (same task, encoder, JAX initial weights, LAMB
    schedule and configs): three cycles of 150 steps; every handoff file
    well formed with no negative equal to its positive; dev NDCG@10 up by
    more than 0.08 and the MRR probe up; a checkpoint after each cycle."""
    from ance_tpu_torch.data.feed import parse_triple_line
    from ance_tpu_torch.models.dot_models import RobertaDot
    from ance_tpu_torch.optim.schedules import warmup_linear
    from ance_tpu_torch.train import trainer
    from ance_tpu_torch.train.ance_loop import (AnceCycleConfig,
                                                run_ance_cycles)
    from ance_tpu_torch.train.encode import make_encode_fn
    from test_ann_loop import N_PASSAGES as N_P, N_TRAIN_Q as N_Q

    paths, train_qrels, dev_qrels, model, _, _ = _vocab_task(tmp_path, 0.02)
    state = trainer.init_train_state(model, trainer.make_optimizer(
        model, "lamb", warmup_linear(5e-3, 10, 20000)))
    gen_cfg = ann_gen.AnnGenConfig(topk_training=32, negative_sample=8,
                                   ann_chunk_factor=1,
                                   ann_measure_topk_mrr=True,
                                   dev_search_depth=32, encode_batch_size=32)
    cycle_cfg = AnceCycleConfig(steps_per_cycle=150, batch_size=32,
                                num_cycles=3, feed_workers=0,
                                checkpoint_dir=str(tmp_path / "ckpt"))
    with TokenCache(paths["dev-query"]) as dev_c, \
            TokenCache(paths["passages"]) as pass_c, \
            TokenCache(paths["train-query"]) as train_c:
        state, history = run_ance_cycles(
            cycle_cfg, gen_cfg, state=state,
            train_step=trainer.make_train_step(trainer.triplet_loss_fn()),
            generator=torch.Generator().manual_seed(3),
            query_encode_fn=make_encode_fn(model, RobertaDot.query_emb,
                                           "cpu"),
            body_encode_fn=make_encode_fn(model, RobertaDot.body_emb, "cpu"),
            dev_query_cache=dev_c, passage_cache=pass_c,
            train_query_cache=train_c, train_qrels=train_qrels,
            dev_qrels=dev_qrels, output_dir=str(tmp_path / "ann_data"),
            device="cpu")
    assert len(history) == 3
    for h in history:
        for line in open(h["data_path"]).read().splitlines():
            qid, pos, negs = parse_triple_line(line)
            assert 0 <= qid < N_Q and 0 <= pos < N_P
            assert pos not in negs and len(negs) <= 8
    assert history[-1]["dev_ndcg"] > history[0]["dev_ndcg"] + 0.08, history
    assert history[-1]["ann_mrr"] > history[0]["ann_mrr"], history
    latest, step = ckpt.get_latest_checkpoint(str(tmp_path / "ckpt"))
    assert step == 450 and json.load(open(os.path.join(
        latest, "meta.json"))) == {"step": 450, "cycle": 2}
