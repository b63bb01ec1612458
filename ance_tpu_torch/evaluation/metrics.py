"""Retrieval metrics with reference-script parity: the port's own copy of
``ance_tpu/evaluation/metrics.py`` (jax-free, copied because the port
imports nothing of the JAX package; ``tests/test_torch_ann_gen.py`` holds
the two to the same answers).

  * :func:`mrr_at_k` / :func:`quality_checks` — official MS MARCO scorer
    semantics (reference utils/msmarco_eval.py:80-139): MRR summed over
    ranked queries that have qrels, divided by the number of REFERENCE
    queries; duplicate-PID submissions rejected.
  * :func:`ndcg_at_k` / :func:`map_at_k` — trec_eval ``ndcg_cut``/``map_cut``
    semantics (replacing pytrec_eval, reference run_ann_data_gen.py:426-435):
    linear gain rel/log2(rank+1), ideal DCG over all judged docs; AP
    normalized by total relevant.
  * :func:`recall_at_k` — fraction of judged-relevant docs retrieved.
  * :func:`dedup_ranking` — multi-vector (MaxP) id-dedup of a neighbor
    matrix (reference run_ann_data_gen.py:409-423).
"""

from __future__ import annotations

import math
from typing import Mapping, Sequence

import numpy as np


# --------------------------------------------------------------------------
# Official MS MARCO MRR (utils/msmarco_eval.py)

def quality_checks(ranked: Mapping[int, Sequence[int]]) -> tuple[bool, str]:
    """Reject rankings that list the same passage twice for one query
    (reference msmarco_eval.py:80-107; 0 is the 'unfilled slot' sentinel)."""
    for qid, pids in ranked.items():
        seen: dict[int, int] = {}
        for pid in pids:
            seen[pid] = seen.get(pid, 0) + 1
        dups = {pid for pid, c in seen.items() if c > 1} - {0}
        if dups:
            return False, (
                "Cannot rank a passage multiple times for a single query. "
                f"QID={qid}, PID={next(iter(dups))}")
    return True, ""


def mrr_at_k(qrels: Mapping[int, Sequence[int]],
             ranked: Mapping[int, Sequence[int]],
             k: int = 10) -> dict:
    """MRR@k, official semantics (reference msmarco_eval.py:109-139)."""
    mrr = 0.0
    matched = 0
    for qid, candidates in ranked.items():
        if qid not in qrels:
            continue
        matched += 1
        targets = set(qrels[qid])
        for i, pid in enumerate(candidates[:k]):
            if pid in targets:
                mrr += 1.0 / (i + 1)
                break
    if matched == 0:
        raise ValueError("No matching QIDs found between qrels and ranking")
    return {f"MRR @{k}": mrr / len(qrels), "QueriesRanked": len(ranked)}


# --------------------------------------------------------------------------
# trec_eval-style graded metrics (replacing pytrec_eval)

def _dcg(rels: Sequence[float]) -> float:
    return sum(r / math.log2(i + 2) for i, r in enumerate(rels))


def ndcg_at_k(qrels: Mapping[int, Mapping[int, int]],
              ranked: Mapping[int, Sequence[int]],
              k: int = 10) -> dict[int, float]:
    """Per-query NDCG@k with trec_eval ``ndcg_cut`` semantics (linear gain)."""
    out = {}
    for qid, candidates in ranked.items():
        rels = qrels.get(qid, {})
        gains = [max(0, rels.get(pid, 0)) for pid in candidates[:k]]
        ideal = sorted((r for r in rels.values() if r > 0), reverse=True)[:k]
        idcg = _dcg(ideal)
        out[qid] = _dcg(gains) / idcg if idcg > 0 else 0.0
    return out


def map_at_k(qrels: Mapping[int, Mapping[int, int]],
             ranked: Mapping[int, Sequence[int]],
             k: int = 1000) -> dict[int, float]:
    """Per-query AP@k with trec_eval ``map_cut`` semantics."""
    out = {}
    for qid, candidates in ranked.items():
        rels = qrels.get(qid, {})
        total_rel = sum(1 for r in rels.values() if r > 0)
        if total_rel == 0:
            out[qid] = 0.0
            continue
        hits, ap = 0, 0.0
        for i, pid in enumerate(candidates[:k]):
            if rels.get(pid, 0) > 0:
                hits += 1
                ap += hits / (i + 1)
        out[qid] = ap / total_rel
    return out


def recall_at_k(qrels: Mapping[int, Mapping[int, int] | Sequence[int]],
                ranked: Mapping[int, Sequence[int]],
                k: int = 1000) -> float:
    """Mean fraction of relevant docs retrieved in the top k."""
    total = 0.0
    n = 0
    for qid, rels in qrels.items():
        relevant = {pid for pid in rels} if not isinstance(rels, Mapping) \
            else {pid for pid, r in rels.items() if r > 0}
        if not relevant:
            continue
        n += 1
        got = set(ranked.get(qid, [])[:k])
        total += len(relevant & got) / len(relevant)
    return total / max(n, 1)


# --------------------------------------------------------------------------
# Ranking construction from a neighbor matrix

def dedup_ranking(neighbor_ids: np.ndarray,
                  query_embedding2id: np.ndarray,
                  passage_embedding2id: np.ndarray,
                  depth: int | None = None) -> dict[int, list[int]]:
    """Embedding-row neighbors → per-query ranked unique passage ids.

    Handles multi-vector documents (MaxP): several embedding rows share one
    passage id; the first (best-ranked) occurrence wins (reference
    run_ann_data_gen.py:409-423).
    """
    out: dict[int, list[int]] = {}
    depth = depth if depth is not None else neighbor_ids.shape[1]
    for qi in range(neighbor_ids.shape[0]):
        qid = int(query_embedding2id[qi])
        seen: set[int] = set()
        ranking: list[int] = []
        for idx in neighbor_ids[qi, :depth]:
            pid = int(passage_embedding2id[idx])
            if pid not in seen:
                seen.add(pid)
                ranking.append(pid)
        out[qid] = ranking
    return out


def eval_dev_ndcg(neighbor_ids: np.ndarray,
                  query_embedding2id: np.ndarray,
                  passage_embedding2id: np.ndarray,
                  dev_query_positive_id: Mapping[int, Mapping[int, int]],
                  depth: int = 50, k: int = 10) -> tuple[float, int]:
    """Dev NDCG@10 as the generator computes it (reference
    run_ann_data_gen.py:399-440: dedup top-50, ndcg_cut_10, mean over
    evaluated queries). Returns (mean ndcg, #queries)."""
    ranked = dedup_ranking(neighbor_ids, query_embedding2id,
                           passage_embedding2id, depth=depth)
    per_q = ndcg_at_k(dev_query_positive_id, ranked, k=k)
    n = len(per_q)
    return (sum(per_q.values()) / n if n else 0.0), n
