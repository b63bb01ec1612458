"""Exact top-k inner-product search and ANCE's negative mining, plainly.

The search scans the corpus block by block: each score is the fp64 inner
product rounded once to fp32 (fp32 × fp32 products are exact in fp64), and
equal scores go to the lower row id, as ``lax.top_k`` and FAISS's
``IndexFlatIP`` order them. ``precision="tf32"`` scores in fp32 products
with TF32 on instead: the control one step below.

The mining follows the reference's ``run_ann_data_gen.py:339-396`` with
shuffled selection: per query, the k neighbor positions shuffled by the
caller's ``random.Random``, the positive skipped, duplicate passages
dropped, the first ``n`` kept.
"""

from __future__ import annotations

import random
from typing import Callable

import torch

from benchmark.reference.encoder import matmul_precision


def topk_scan(queries: torch.Tensor, block: Callable[[int], torch.Tensor],
              n_blocks: int, block_rows: int, k: int,
              precision: str = "fp64") -> tuple[torch.Tensor, torch.Tensor]:
    """(scores [Q, k] fp32, ids [Q, k] int64) of ``queries`` [Q, D] fp32
    over the corpus whose rows ``block(b)`` gives, block ``b`` holding
    rows ``[b·block_rows, ...)``."""
    Q = queries.shape[0]
    dev = queries.device
    best_s = torch.full((Q, 0), 0.0, device=dev)
    best_i = torch.full((Q, 0), 0, dtype=torch.int64, device=dev)
    q64 = queries.to(torch.float64)
    for b in range(n_blocks):
        rows = block(b)
        if precision == "fp64":
            s = (q64 @ rows.to(torch.float64).T).to(torch.float32)
        else:
            with matmul_precision(precision):
                s = queries @ rows.T
        ids = torch.arange(b * block_rows, b * block_rows + rows.shape[0],
                           device=dev)
        top = torch.sort(s, dim=1, descending=True, stable=True)
        s_k, pos = top.values[:, :k], top.indices[:, :k]
        cat_s = torch.cat([best_s, s_k], 1)
        cat_i = torch.cat([best_i, ids[pos]], 1)
        order = torch.sort(cat_s, dim=1, descending=True, stable=True)
        best_s = order.values[:, :k]
        best_i = torch.gather(cat_i, 1, order.indices[:, :k])
    return best_s, best_i


def shuffle_orders(n_queries: int, k: int, rng: random.Random) -> list:
    """The order each query's k neighbor positions are read in: the
    caller's ``rng`` shuffles ``range(k)`` once a query, in query order."""
    out = []
    for _ in range(n_queries):
        idx = list(range(k))
        rng.shuffle(idx)
        out.append(idx)
    return out


def mine_one(neighbors, order, positive: int, n: int) -> list[int]:
    """One query's negatives: ``neighbors`` (passage ids, rank order) read
    in ``order``, the positive and repeats skipped, the first ``n``."""
    negs: list[int] = []
    for j in order:
        pid = int(neighbors[j])
        if pid == positive or pid in negs:
            continue
        if len(negs) >= n:
            break
        negs.append(pid)
    return negs
