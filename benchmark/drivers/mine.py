"""Negative mining over the full index: a refresh's M items.

Set-up writes the train queries' token cache, makes the weights on the
device, builds the port's ``RobertaDot`` (eval), and fills an fp32
``FlatIPIndex`` of ``index_rows`` rows block by block from
``(seed, block)`` (``generator.corpus_block``), so the reference can make
any block again; positives are drawn from the seed. The window then takes
chunks of ``chunk`` queries in turn from the cache: each is encoded at the
cell's batch (``encode_cache_to_device``), searched at ``k`` by
``FlatIPIndex.search``, its ids brought to the host, and mined by
``train/ann_gen.py::mine_negatives`` (shuffled selection, ``negatives`` a
query), until ``seconds`` have passed. ``mine_queries_per_s`` is the
queries of every chunk over the window.

The check draws ``sample`` queries of the window from the seed (among
``keep_per_chunk`` drawn in each chunk as it is mined) and holds
each stage to the plain reference: the query embeddings to the fp32
encoder (``query_rel_err``); the search of the port's own query
embeddings to an exact fp64 scan over the index made again
(``search_id_mismatch``, ``search_score_err``: the program's state feeds
this stage, whose input the first check covers); and the negatives to
the reference's mining of the reference's ids under the same shuffles
(``negative_mismatch``).
"""

from __future__ import annotations

import os
import random
import time

import numpy as np
import torch

from benchmark import common, flops
from benchmark.generator import corpus_block, load_streams
from benchmark.harness import Check, Outcome
from benchmark.reference import encoder as ref
from benchmark.reference import search as ref_search
from benchmark.timing import EventSpans
from benchmark.trace import TracedSlice
from benchmark.weights import derived_seed, make_weights


def block_rows(p: dict, b: int) -> int:
    return min(p["index_block"], p["index_rows"] - b * p["index_block"])


def n_blocks(p: dict) -> int:
    return -(-p["index_rows"] // p["index_block"])


def positives(seed: int, n_queries: int, n_rows: int) -> np.ndarray:
    """Each query's positive row, drawn from the seed."""
    rng = np.random.default_rng(derived_seed(seed, 6))
    return rng.integers(0, n_rows, n_queries)


def chunk_rng(seed: int, j: int) -> random.Random:
    """The shuffles of the window's ``j``-th chunk."""
    return random.Random(derived_seed(seed, 5, j))


def run(cell):
    from ance_tpu_torch.data.cache import TokenCache
    from ance_tpu_torch.index.flat import FlatIPIndex
    from ance_tpu_torch.models.dot_models import RobertaDot
    from ance_tpu_torch.train.ann_gen import mine_negatives
    from ance_tpu_torch.train.encode import (encode_cache_to_device,
                                             make_encode_fn)
    from torch.profiler import record_function
    cfg, p, dev = cell.config, cell.params, cell.device
    stream = load_streams(cell.traffic, cell.seed, cfg)[p["stream"]]
    path = stream.write_cache(cell.tmpdir)
    weights = make_weights(cfg, cell.seed, dev)
    model = common.port_model(cfg, weights, dev)
    del weights
    qfn = make_encode_fn(model, RobertaDot.query_emb, dev)
    N, D = p["index_rows"], cfg["embedding_head"]["out_dim"]
    index = FlatIPIndex(dim=D, device=dev)
    index.allocate(N, D, slice_rows=p["index_block"])
    for b in range(n_blocks(p)):
        index.update_slice(b * p["index_block"],
                           corpus_block(cell.seed, b, block_rows(p, b), D,
                                        dev))
    pos = positives(cell.seed, len(stream), N)
    pos_map = {q: int(r) for q, r in enumerate(pos)}
    passage_ids = np.arange(N, dtype=np.int64)
    probe = common.CacheProbe(TokenCache(path).open())
    C, k = p["chunk"], p["k"]
    cache_chunks = len(stream) // C
    spans = EventSpans()
    mine_ms: list[float] = []

    def mine_chunk(j, rng, search_range=False):
        """Mine the window's ``j``-th chunk; keep for the check the
        outputs of ``keep_per_chunk`` of its queries, drawn from the seed
        (so the memory a run holds does not grow with its chunks)."""
        start = (j % cache_chunks) * C
        q, qids = encode_cache_to_device(qfn, probe, p["batch"], start=start,
                                         stop=start + C)
        with spans.span():
            if search_range:
                with record_function("bench.search"):
                    s, nb = index.search(q, k)
            else:
                s, nb = index.search(q, k)
        nb = nb.cpu().numpy()
        t = time.perf_counter()
        negs, _ = mine_negatives(qids, passage_ids, pos_map, nb,
                                 p["negatives"], rng=rng)
        mine_ms.append((time.perf_counter() - t) * 1e3)
        rows = common.sample(cell.seed, 100 + j, C, p["keep_per_chunk"])
        at = torch.as_tensor(rows, device=dev)
        return (rows, q[at], s[at], nb[rows],
                [negs.get(int(qids[r]), []) for r in rows], start)

    mine_chunk(0, random.Random(derived_seed(cell.seed, 7)))
    common.sync(dev)
    probe.ms.clear()
    mine_ms.clear()
    spans = EventSpans()

    cell.window_opens()
    t0 = time.perf_counter()
    done = []
    while True:
        done.append(mine_chunk(len(done), chunk_rng(cell.seed, len(done))))
        if time.perf_counter() - t0 >= cell.seconds:
            break
    common.sync(dev)
    window_s = time.perf_counter() - t0
    queries = len(done) * C
    model_flops = sum(flops.encoder_flops(stream.lengths[st:st + C], cfg)
                      + flops.search_work(C, N, D, k)[0]
                      for *_, st in done)
    obs = {"spans": {"search": spans.ms(), "mine_host": list(mine_ms)},
           "window_s": window_s, "model_flops": model_flops}

    if cell.trace and dev.type == "cuda":
        with TracedSlice(os.path.join(cell.tmpdir, "trace.json"),
                         ranges=("bench.search",)) as traced:
            for t in range(p["trace_chunks"]):
                mine_chunk(len(done) + t, random.Random(0),
                           search_range=True)
        obs["trace"] = traced.summary
        ops, nbytes = flops.search_work(C, N, D, k)
        obs["range_work"] = {"bench.search": (ops * p["trace_chunks"],
                                              nbytes * p["trace_chunks"])}
    peak = common.peak_bytes(dev)

    kept = [(j, i) for j, d in enumerate(done) for i in range(len(d[0]))]
    pick = [kept[i] for i in common.sample(cell.seed, 2, len(kept),
                                           p["sample"])]
    js = np.array([j for j, _ in pick])
    rows = np.array([done[j][0][i] for j, i in pick])
    got_q = torch.stack([done[j][1][i] for j, i in pick]).float().cpu()
    got_s = torch.stack([done[j][2][i] for j, i in pick]).cpu()
    got_i = torch.as_tensor(np.stack([done[j][3][i] for j, i in pick]))
    got_negs = [done[j][4][i] for j, i in pick]
    qids = np.array([done[j][5] for j, _ in pick]) + rows
    del model, qfn, index, done
    common.release(dev)
    checks, failed = compare(cell, stream, pos, qids, js, rows, got_q, got_s,
                             got_i, got_negs)
    return Outcome(attempted=queries, failed=failed,
                   e2e={"mine_queries_per_s": queries / window_s},
                   checks=checks, memory_peak_bytes=peak, obs=obs)


def reference_queries(cell, stream, qids, precision="fp32"):
    weights = make_weights(cell.config, cell.seed, cell.device)
    ids = stream.tokens(qids)
    mask = ref.mask_from_lengths(stream.lengths[qids], stream.width)
    return ref.encode_rows(weights, ids, mask, cell.config, cell.device,
                           precision=precision).cpu()


def reference_search(cell, queries, precision="fp64"):
    p, dev = cell.params, cell.device
    D = queries.shape[1]
    with torch.no_grad():
        s, i = ref_search.topk_scan(
            queries.to(dev), lambda b: corpus_block(cell.seed, b,
                                                    block_rows(p, b), D, dev),
            n_blocks(p), p["index_block"], p["k"], precision=precision)
    return s.cpu(), i.cpu()


def reference_negatives(cell, pos, qids, js, rows, ids):
    """Each sampled query's negatives mined from ``ids`` [n, k] under its
    chunk's shuffles (replayed over the chunk's queries in order)."""
    p = cell.params
    orders = {}
    out = []
    for j, r, q, row in zip(js, rows, qids, ids):
        if j not in orders:
            orders[j] = ref_search.shuffle_orders(p["chunk"], p["k"],
                                                  chunk_rng(cell.seed, int(j)))
        out.append(ref_search.mine_one(row.tolist(), orders[j][r],
                                       int(pos[q]), p["negatives"]))
    return out


def numbers(cell, q, q_ref, s, i, s_ref, i_ref, negs, negs_ref) -> dict:
    q_err = common.rel_err_rows(q, q_ref)
    id_bad = (i != i_ref).any(dim=1)
    neg_bad = torch.tensor([a != b for a, b in zip(negs, negs_ref)])
    score = ((s.double() - s_ref.double()).abs().max()
             / s_ref.double().abs().max())
    return {"query_rel_err": float(q_err.max()),
            "search_id_mismatch": int((i != i_ref).sum()),
            "search_score_err": float(score),
            "negative_mismatch": int(neg_bad.sum()),
            "_bad": (q_err > cell.params["limits"]["query_rel_err"])
            | id_bad | neg_bad}


def compare(cell, stream, pos, qids, js, rows, got_q, got_s, got_i,
            got_negs):
    q_ref = reference_queries(cell, stream, qids)
    s_ref, i_ref = reference_search(cell, got_q)
    negs_ref = reference_negatives(cell, pos, qids, js, rows, i_ref)
    got = numbers(cell, got_q, q_ref, got_s, got_i, s_ref, i_ref, got_negs,
                  negs_ref)
    limits = cell.params["limits"]
    checks = [Check(name, got[name], limits[name])
              for name in ("query_rel_err", "search_id_mismatch",
                           "search_score_err", "negative_mismatch")]
    return checks, int(got["_bad"].sum())


def control(cell) -> dict:
    """The control's readings: the reference one step down in the
    program's place: the query encoder at float8, the search in TF32
    products, the mining on the TF32 search's ids."""
    cfg, p = cell.config, cell.params
    stream = load_streams(cell.traffic, cell.seed, cfg)[p["stream"]]
    pick = common.sample(cell.seed, 2, len(stream), p["sample"])
    js, rows = pick // p["chunk"], pick % p["chunk"]
    pos = positives(cell.seed, len(stream), p["index_rows"])
    q_ref = reference_queries(cell, stream, pick)
    q8 = reference_queries(cell, stream, pick, precision="fp8")
    s_ref, i_ref = reference_search(cell, q_ref)
    s32, i32 = reference_search(cell, q_ref, precision="tf32")
    negs_ref = reference_negatives(cell, pos, pick, js, rows, i_ref)
    negs32 = reference_negatives(cell, pos, pick, js, rows, i32)
    got = numbers(cell, q8, q_ref, s32, i32, s_ref, i_ref, negs32, negs_ref)
    got.pop("_bad")
    return got
