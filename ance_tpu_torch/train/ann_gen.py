"""ANN data generation: encode → index → evaluate → mine → hand off.

The generator half of the ANCE loop (counterpart of
``ance_tpu/train/ann_gen.py``; the reference's run_ann_data_gen.py), on one
device or over the ranks of a mesh (each encodes its block of every batch
and holds a shard of the index's rows):

  * the corpus, the dev queries and this round's chunk of train queries
    are encoded on ``device`` (:mod:`ance_tpu_torch.train.encode`);
  * the exact :class:`ance_tpu_torch.index.flat.FlatIPIndex` is built from
    the corpus embeddings where they lie, and searched through the
    block-max top-k (the CUDA kernel of ``csrc/blockmax.cu`` on the card)
    for dev NDCG@10 and for mining;
  * the file protocol is the JAX package's (and the reference's):
    ``ann_training_data_<n>`` (shuffled ``qid\\tpos\\tneg,...`` lines),
    then ``ann_ndcg_<n>`` written LAST as the ready signal, so either
    package's trainer reads what either package's generator writes.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from ance_tpu_torch.data.cache import TokenCache
from ance_tpu_torch.evaluation.metrics import eval_dev_ndcg
from ance_tpu_torch.index.flat import FlatIPIndex
from ance_tpu_torch.train.encode import encode_cache_to_device, synced_clock

ANN_DATA_PREFIX = "ann_training_data_"
ANN_NDCG_PREFIX = "ann_ndcg_"


# --------------------------------------------------------------------------
# Discovery (trainer side)

def get_latest_ann_data(ann_dir: str
                        ) -> tuple[int, Optional[str], Optional[dict]]:
    """Newest (data_no, training_data_path, ndcg_json), or (−1, None, None)
    (reference utils/util.py:229-243: the ndcg file is the ready signal)."""
    if not os.path.isdir(ann_dir):
        return -1, None, None
    nums = []
    for name in next(os.walk(ann_dir))[2]:
        if name.startswith(ANN_NDCG_PREFIX):
            try:
                nums.append(int(name[len(ANN_NDCG_PREFIX):]))
            except ValueError:
                continue
    if not nums:
        return -1, None, None
    n = max(nums)
    with open(os.path.join(ann_dir, ANN_NDCG_PREFIX + str(n))) as f:
        ndcg_json = json.load(f)
    return n, os.path.join(ann_dir, ANN_DATA_PREFIX + str(n)), ndcg_json


# --------------------------------------------------------------------------
# Query chunk rotation

def query_chunk_range(num_queries: int, chunk_factor: int,
                      output_num: int) -> tuple[int, int]:
    """1/chunk_factor of the train queries per generation, rotating by
    output_num (reference run_ann_data_gen.py:281-296). chunk_factor is
    clamped to num_queries, so no rotation is ever an empty range."""
    if chunk_factor <= 0:
        chunk_factor = 1
    chunk_factor = max(1, min(chunk_factor, num_queries))
    effective_idx = output_num % chunk_factor
    per_chunk = num_queries // chunk_factor
    start = per_chunk * effective_idx
    end = num_queries if effective_idx == chunk_factor - 1 \
        else start + per_chunk
    return start, end


# --------------------------------------------------------------------------
# Negative mining

def mine_negatives(query_embedding2id: np.ndarray,
                   passage_embedding2id: np.ndarray,
                   training_query_positive_id: Mapping[int, int],
                   neighbor_ids: np.ndarray,
                   negative_sample: int,
                   select_topk: bool = False,
                   rng: Optional[random.Random] = None
                   ) -> tuple[dict[int, list[int]], float]:
    """Top-k (or shuffled) negatives with the positive skipped, duplicates
    dropped and an inline MRR probe (reference run_ann_data_gen.py:339-396).
    The shuffles draw from ``rng`` as the JAX function's do, so identical
    neighbor matrices give identical negatives. Returns (qid → negative
    pids, mrr); mrr means something only with ``select_topk``."""
    rng = rng or random.Random(0)
    query_negative_passage: dict[int, list[int]] = {}
    mrr = 0.0
    num_queries = 0
    for qi in range(neighbor_ids.shape[0]):
        qid = int(query_embedding2id[qi])
        if qid not in training_query_positive_id:
            continue
        num_queries += 1
        pos_pid = training_query_positive_id[qid]
        row = neighbor_ids[qi]
        if select_topk:
            selected = row[:negative_sample + 1]
        else:
            idx = list(range(neighbor_ids.shape[1]))
            rng.shuffle(idx)
            selected = row[idx]
        negs: list[int] = []
        rank = 0
        for emb_idx in selected:
            neg_pid = int(passage_embedding2id[emb_idx])
            rank += 1
            if neg_pid == pos_pid:
                if rank <= 10:
                    mrr += 1.0 / rank
                continue
            if neg_pid in negs:
                continue
            if len(negs) >= negative_sample:
                break
            negs.append(neg_pid)
        query_negative_passage[qid] = negs
    return query_negative_passage, (mrr / num_queries if num_queries else 0.0)


# --------------------------------------------------------------------------
# File handoff

def write_ann_data(output_dir: str, output_num: int,
                   query_embedding2id: np.ndarray,
                   training_query_positive_id: Mapping[int, int],
                   query_negative_passage: Mapping[int, Sequence[int]],
                   dev_ndcg: float, checkpoint_path: str,
                   seed: int = 0) -> tuple[str, str]:
    """Write the shuffled triple lines, then the ndcg JSON (the ready
    signal, LAST — reference run_ann_data_gen.py:314-334). Byte for byte
    the JAX package's files."""
    os.makedirs(output_dir, exist_ok=True)
    data_path = os.path.join(output_dir, ANN_DATA_PREFIX + str(output_num))
    order = list(range(len(query_embedding2id)))
    random.Random(seed).shuffle(order)
    with open(data_path, "w") as f:
        for qi in order:
            qid = int(query_embedding2id[qi])
            if qid not in training_query_positive_id or \
                    qid not in query_negative_passage:
                continue
            negs = query_negative_passage[qid]
            if not negs:
                continue
            f.write("{}\t{}\t{}\n".format(
                qid, training_query_positive_id[qid],
                ",".join(str(p) for p in negs)))
    ndcg_path = os.path.join(output_dir, ANN_NDCG_PREFIX + str(output_num))
    with open(ndcg_path, "w") as f:
        json.dump({"ndcg": dev_ndcg, "checkpoint": checkpoint_path}, f)
    return data_path, ndcg_path


# --------------------------------------------------------------------------
# Full generation pass

@dataclasses.dataclass
class AnnGenConfig:
    topk_training: int = 500
    negative_sample: int = 5
    ann_chunk_factor: int = 5        # reference default (run_ann_data_gen.py:542)
    ann_measure_topk_mrr: bool = False
    dev_search_depth: int = 100      # dev_I search width (run_ann_data_gen.py:276)
    encode_batch_size: int = 128
    multichunk: bool = False         # MaxP document mode
    index_quantize: str | None = None  # 'dims': an int8 index
    seed: int = 0


def generate_new_ann(cfg: AnnGenConfig, *,
                     output_num: int,
                     checkpoint_path: str,
                     query_encode_fn,
                     body_encode_fn,
                     dev_query_cache: TokenCache,
                     passage_cache: TokenCache,
                     train_query_cache: TokenCache,
                     training_query_positive_id: Mapping[int, int],
                     dev_query_positive_id: Mapping[int, Mapping[int, int]],
                     output_dir: str,
                     device,
                     index: Optional[FlatIPIndex] = None,
                     inference_only: bool = False, mesh=None) -> dict:
    """One encode → index → eval → mine → write pass
    (reference run_ann_data_gen.py:231-336). ``query_encode_fn`` /
    ``body_encode_fn`` are :func:`ance_tpu_torch.train.encode.make_encode_fn`
    closures over the model whose weights this pass encodes with (the JAX
    function's ``params``).

    Returns the JAX function's keys (``dev_ndcg``, ``num_queries_dev``,
    ``ann_mrr``, ``data_path``, ``ndcg_path``, ``index``,
    ``passage_embedding2id``; with ``inference_only`` the index, the
    passage ids and the dev query embeddings and ids) plus
    ``train_query_embedding`` (on the device), ``train_neighbor_ids`` (the
    mining search's rows, [Q, topk_training]) and ``seconds`` (host clock
    after a device synchronize: passage encode, mining search, total).
    ``mesh`` shards the encode and the index's rows over its ranks, every
    one of which returns the same result (``ance_tpu/train/ann_gen.py``'s
    ``mesh``); global rank 0 alone writes the hand-off files."""
    device = torch.device(device)
    now = synced_clock(device)
    t_start = now()
    bs = cfg.encode_batch_size
    dev_q_emb, dev_q_ids = encode_cache_to_device(query_encode_fn,
                                                  dev_query_cache, bs,
                                                  mesh=mesh)
    t0 = now()
    passage_emb, passage_ids = encode_cache_to_device(
        body_encode_fn, passage_cache, bs, multichunk=cfg.multichunk,
        mesh=mesh)
    seconds = {"encode_passages": now() - t0}

    if index is None:
        index = FlatIPIndex(dim=passage_emb.shape[1], device=device,
                            mesh=mesh, quantize=cfg.index_quantize or False)
    if index.quantize == "dims":
        index.add_chunked(passage_emb)  # never stages an fp32 copy
    else:
        index.add(passage_emb)
    del passage_emb

    if inference_only:
        return {"index": index, "passage_embedding2id": passage_ids,
                "dev_query_embedding":
                    dev_q_emb.to(torch.float32).cpu().numpy(),
                "dev_query_embedding2id": dev_q_ids}

    _, dev_neighbors = index.search(dev_q_emb, cfg.dev_search_depth)
    dev_ndcg, num_dev = eval_dev_ndcg(dev_neighbors.cpu().numpy(), dev_q_ids,
                                      passage_ids, dev_query_positive_id)

    q_start, q_end = query_chunk_range(len(train_query_cache),
                                       cfg.ann_chunk_factor, output_num)
    train_q_emb, train_q_ids = encode_cache_to_device(
        query_encode_fn, train_query_cache, bs, start=q_start, stop=q_end,
        mesh=mesh)
    t0 = now()
    _, train_neighbors = index.search(train_q_emb, cfg.topk_training)
    train_neighbors = train_neighbors.cpu().numpy()
    seconds["mining_search"] = now() - t0
    negatives, ann_mrr = mine_negatives(
        train_q_ids, passage_ids, training_query_positive_id,
        train_neighbors, cfg.negative_sample,
        select_topk=cfg.ann_measure_topk_mrr,
        rng=random.Random(cfg.seed + output_num))

    data_path = os.path.join(output_dir, ANN_DATA_PREFIX + str(output_num))
    ndcg_path = os.path.join(output_dir, ANN_NDCG_PREFIX + str(output_num))
    if mesh is None or mesh.writer:
        write_ann_data(output_dir, output_num, train_q_ids,
                       training_query_positive_id, negatives, dev_ndcg,
                       checkpoint_path, seed=cfg.seed + output_num)
    if mesh is not None:
        mesh.barrier()  # the files are whole before any rank goes on
    seconds["total"] = now() - t_start
    return {"dev_ndcg": dev_ndcg, "num_queries_dev": num_dev,
            "ann_mrr": ann_mrr, "data_path": data_path,
            "ndcg_path": ndcg_path, "index": index,
            "passage_embedding2id": passage_ids,
            "train_query_embedding": train_q_emb,
            "train_neighbor_ids": train_neighbors, "seconds": seconds}
