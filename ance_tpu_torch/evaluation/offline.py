"""Offline evaluation over dumped embeddings (counterpart of
``ance_tpu/evaluation/offline.py``; the reference's evaluation notebook):
full ranking by exact inner product and BM25-candidate reranking, scored
with NDCG@10, MRR@10, MAP, recall@k and the hole rate (the share of
retrieved documents without a judgment). Searches run on ``device``
through :func:`ance_tpu_torch.evaluation.mrr_eval.knn_inner_product`.
Embedding shards use the reference's ``<prefix>_data_obj_<rank>.npy``
layout, which ``ance infer`` and ``ance_tpu_torch.cli infer`` both write.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np

from ance_tpu_torch.evaluation.metrics import (dedup_ranking, map_at_k,
                                               mrr_at_k, ndcg_at_k,
                                               recall_at_k)
from ance_tpu_torch.evaluation.mrr_eval import (get_topk_restricted,
                                                knn_inner_product)


def hole_rate(qrels: Mapping[int, Mapping[int, int]],
              ranked: Mapping[int, Sequence[int]], k: int = 10) -> float:
    """Mean fraction of top-k results with NO judgment in qrels."""
    rates = []
    for qid, pids in ranked.items():
        judged = qrels.get(qid, {})
        top = list(pids)[:k]
        if not top:
            continue
        rates.append(sum(1 for p in top if p not in judged) / len(top))
    return float(np.mean(rates)) if rates else 0.0


def _scores(qrels, ranked, extra: dict) -> dict:
    """NDCG@10, the hole rate and MRR@10 (0 when no query is judged)."""
    binary_qrels = {q: [p for p, r in rels.items() if r > 0]
                    for q, rels in qrels.items()}
    per_q_ndcg = ndcg_at_k(qrels, ranked, k=10)
    out = {"ndcg_10": float(np.mean(list(per_q_ndcg.values())))
           if per_q_ndcg else 0.0, **extra,
           "hole_rate_10": hole_rate(qrels, ranked, k=10)}
    try:
        out["mrr_10"] = mrr_at_k(binary_qrels, ranked, k=10)["MRR @10"]
    except ValueError:
        out["mrr_10"] = 0.0
    return out


def full_ranking_eval(query_embs: np.ndarray, query_ids: np.ndarray,
                      psg_embs: np.ndarray, psg_ids: np.ndarray,
                      qrels: Mapping[int, Mapping[int, int]],
                      topn: int = 1000, device="cuda") -> dict:
    """Exact full-corpus ranking → metric dict (notebook cell 13)."""
    k = min(topn, psg_embs.shape[0])
    _, rows = knn_inner_product(query_embs, psg_embs, k=k, device=device)
    ranked = dedup_ranking(rows, query_ids, psg_ids)
    per_q_map = map_at_k(qrels, ranked, k=k)
    return _scores(qrels, ranked, {
        "map": float(np.mean(list(per_q_map.values()))) if per_q_map
        else 0.0,
        "recall": recall_at_k(qrels, ranked, k=k)})


def rerank_eval(query_embs: np.ndarray, query_ids: np.ndarray,
                psg_embs: np.ndarray, psg_ids: np.ndarray,
                candidates: Mapping[int, Sequence[int]],
                qrels: Mapping[int, Mapping[int, int]],
                k: int = 10, device="cuda") -> dict:
    """Per-query candidate-restricted reranking (notebook cell 11 /
    eval_mrr.py:94-105 get_topk_restricted)."""
    pid_dict = {int(p): i for i, p in enumerate(psg_ids)}
    ranked: dict[int, list[int]] = {}
    for i, qid in enumerate(np.asarray(query_ids)):
        qid = int(qid)
        _, pids = get_topk_restricted(query_embs[i:i + 1], psg_embs, pid_dict,
                                      psg_ids, candidates.get(qid, []), k,
                                      device=device)
        ranked[qid] = [int(p) for p in pids if p >= 0]
    return _scores(qrels, ranked, {})


def save_embedding_shard(prefix: str, array: np.ndarray, rank: int = 0
                         ) -> str:
    """Write one shard in the reference's barrier_array_merge layout
    (reference util.py:108-113)."""
    path = f"{prefix}_data_obj_{rank}.npy"
    np.save(path, np.asarray(array), allow_pickle=False)
    return path


def load_embedding_shards(prefix: str, max_shards: int = 8
                          ) -> Optional[np.ndarray]:
    """Concatenate the ``<prefix>_data_obj_<rank>.npy`` shards (the
    reference's barrier_array_merge layout); None when there are none."""
    parts = []
    for rank in range(max_shards):
        try:
            parts.append(np.load(f"{prefix}_data_obj_{rank}.npy",
                                 allow_pickle=False))
        except FileNotFoundError:
            continue
    if not parts:
        return None
    return np.concatenate(parts, axis=0)
