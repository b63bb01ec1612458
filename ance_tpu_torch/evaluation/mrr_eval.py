"""In-train MRR evaluation: full ranking and BM25-candidate reranking.

Counterpart of ``ance_tpu/evaluation/mrr_eval.py`` (reference
utils/eval_mrr.py): per-query dedup, unfilled slots = pid 0, the official
MRR@10 scorer. Where the JAX module searches with ``knn_inner_product``,
this one searches with the port's exact scan
(:func:`ance_tpu_torch.index.flat.topk_inner_product`: fp64-exact scores,
ties to the lower row) on ``device``. The texts are tokenized by
:func:`ance_tpu_torch.data.process_fn.dual_batches`.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from ance_tpu_torch.data.process_fn import dual_batches
from ance_tpu_torch.evaluation.metrics import mrr_at_k, quality_checks
from ance_tpu_torch.index.flat import topk_inner_product


def knn_inner_product(queries, corpus, k: int, device="cuda",
                      chunk_rows: int = 16384
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Index-free exact KNN over host arrays (reference eval_mrr.py:62-91
    ``search_knn``) → (scores [Q, k] fp32, rows [Q, k] int64) as numpy."""
    q = torch.as_tensor(np.asarray(queries, np.float32), device=device)
    c = torch.as_tensor(np.asarray(corpus, np.float32), device=device)
    scores, rows = topk_inner_product(q, c, k=k,
                                      chunk_rows=min(chunk_rows, c.shape[0]))
    return scores.cpu().numpy(), rows.cpu().numpy()


def parse_top_dev(path: str, qid_col: int = 0, pid_col: int = 1
                  ) -> dict[int, list[int]]:
    """BM25 top-1000 candidate file (reference eval_mrr.py:49-59)."""
    ret: dict[int, list[int]] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            cells = line.strip().split("\t")
            if len(cells) <= max(qid_col, pid_col):
                continue
            ret.setdefault(int(cells[qid_col]), []).append(int(cells[pid_col]))
    return ret


def psg_ids_safe(psg_ids: np.ndarray, rows: np.ndarray) -> np.ndarray:
    out = np.full(rows.shape, -1, dtype=np.int64)
    valid = rows >= 0
    out[valid] = psg_ids[rows[valid]]
    return out


def get_topk_restricted(q_emb: np.ndarray, psg_embs: np.ndarray,
                        pid_dict: Mapping[int, int], psg_ids: np.ndarray,
                        pid_subset: Sequence[int], top_k: int,
                        device="cuda") -> tuple[np.ndarray, np.ndarray]:
    """Exact top-k restricted to a candidate pid subset
    (reference eval_mrr.py:94-105; −128 / −1 sentinels past the subset)."""
    subset_ix = np.asarray([pid_dict[p] for p in pid_subset
                            if p != -1 and p in pid_dict], dtype=np.int64)
    if len(subset_ix) == 0:
        return np.full((top_k,), -128.0), np.full((top_k,), -1, dtype=int)
    k = min(top_k, len(subset_ix))
    D, I = knn_inner_product(q_emb, psg_embs[subset_ix], k=k, device=device)
    D, I = D[0], I[0]
    if k < top_k:  # pad to fixed width with sentinels
        D = np.concatenate([D, np.full(top_k - k, -128.0)])
        I = np.concatenate([subset_ix[I], np.full(top_k - k, -1)])
        return D, psg_ids_safe(psg_ids, I)
    return D, psg_ids[subset_ix[I]]


def ranking_to_candidates(D: np.ndarray, I: np.ndarray,
                          qids: np.ndarray) -> dict[int, list[int]]:
    """Score-sorted, deduped, 1000-slot candidate lists
    (reference eval_mrr.py:182-194; empty slots stay pid 0)."""
    idx = np.argsort(D, axis=1)[:, ::-1][:, :10]
    sorted_I = np.take_along_axis(I, idx, axis=1)
    candidates: dict[int, list[int]] = {}
    for i, qid in enumerate(np.asarray(qids)):
        qid = int(qid)
        if qid not in candidates:
            candidates[qid] = [0] * 1000
        j = 0
        seen: set[int] = set()
        for pid in sorted_I[i]:
            pid = int(pid)
            if pid >= 0 and pid not in seen:
                candidates[qid][j] = pid
                j += 1
                seen.add(pid)
    return candidates


def compute_mrr(D: np.ndarray, I: np.ndarray, qids: np.ndarray,
                ref_dict: Mapping[int, Sequence[int]]) -> float:
    """Official MRR@10 over a (scores, pids) ranking
    (reference eval_mrr.py:173-203)."""
    candidates = ranking_to_candidates(D, I, qids)
    ok, message = quality_checks(candidates)
    if message:
        print(message)
    return mrr_at_k(ref_dict, candidates, k=10)["MRR @10"]


def combined_eval(query_embs: np.ndarray, query_ids: np.ndarray,
                  psg_embs: np.ndarray, psg_ids: np.ndarray,
                  topk_dev_qid_pid: Mapping[int, Sequence[int]],
                  ref_dict: Mapping[int, Sequence[int]],
                  full_depth: int = 100, device="cuda"
                  ) -> tuple[float, float]:
    """(reranking_mrr, full_ranking_mrr) — reference eval_mrr.py:127-170."""
    D, I_rows = knn_inner_product(query_embs, psg_embs,
                                  k=min(full_depth, psg_embs.shape[0]),
                                  device=device)
    I = psg_ids[I_rows]
    pid_dict = {int(p): i for i, p in enumerate(psg_ids)}
    d_data, i_data = [], []
    for i, qid in enumerate(np.asarray(query_ids)):
        ds, pids = get_topk_restricted(
            query_embs[i:i + 1], psg_embs, pid_dict, psg_ids,
            topk_dev_qid_pid.get(int(qid), []), 10, device=device)
        d_data.append(ds)
        i_data.append(pids)
    reranking_mrr = compute_mrr(np.asarray(d_data), np.asarray(i_data),
                                query_ids, ref_dict)
    full_ranking_mrr = compute_mrr(D, I, query_ids, ref_dict)
    return reranking_mrr, full_ranking_mrr


def embed_text_file(encode_fn, tokenizer, path: str, max_len: int,
                    batch_size: int = 64) -> tuple[np.ndarray, np.ndarray]:
    """Embed an ``id\\ttext`` TSV with on-the-fly tokenization (reference
    eval_mrr.py:16-46); ``encode_fn(ids, mask)`` is
    :func:`ance_tpu_torch.train.encode.make_encode_fn`'s."""
    embs, ids = [], []
    with open(path, encoding="utf-8") as f:
        for batch in dual_batches(tokenizer, f, batch_size, max_len):
            out = encode_fn(batch["ids"], batch["mask"])
            embs.append(out.to(torch.float32).cpu().numpy())
            ids.append(batch["rec_ids"])
    return np.concatenate(embs), np.concatenate(ids)


def load_msmarco_reference(path: str) -> dict[int, list[int]]:
    """qrels.dev.small.tsv → qid → [pids]
    (reference msmarco_eval.py:19-45)."""
    out: dict[int, list[int]] = {}
    with open(path) as f:
        for line in f:
            cells = line.strip().split("\t")
            if len(cells) < 3:
                continue
            out.setdefault(int(cells[0]), []).append(int(cells[2]))
    return out


def passage_dist_eval(*, query_encode_fn, body_encode_fn, tokenizer,
                      queries_path: str, collection_path: str,
                      top1000_path: str, qrels_path: str,
                      max_query_length: int = 64, max_seq_length: int = 128,
                      batch_size: int = 64, device="cuda"
                      ) -> tuple[float, float]:
    """In-train dev MRR: (reranking_mrr, full_ranking_mrr)
    (reference utils/eval_mrr.py:108-124)."""
    q_embs, q_ids = embed_text_file(query_encode_fn, tokenizer, queries_path,
                                    max_query_length, batch_size)
    p_embs, p_ids = embed_text_file(body_encode_fn, tokenizer,
                                    collection_path, max_seq_length,
                                    batch_size)
    top1k = parse_top_dev(top1000_path, qid_col=0, pid_col=1)
    ref = load_msmarco_reference(qrels_path)
    return combined_eval(q_embs, q_ids, p_embs, p_ids, top1k, ref,
                         device=device)
