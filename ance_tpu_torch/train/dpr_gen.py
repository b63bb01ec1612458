"""DPR ANN data generation: answer-validated retrieval and answer-filtered
negative mining, on one device.

Counterpart of ``ance_tpu/train/dpr_gen.py`` (the reference's
drivers/run_ann_data_gen_dpr.py:230-345). Against the MS MARCO generator
(:mod:`ance_tpu_torch.train.ann_gen`): the test questions are scored by
whether a retrieved passage's raw text holds an answer (the top-k hit
curve), mining drops candidates that hold one, and the sidecar carries
``top20`` / ``top100`` (and ``*_trivia``) instead of NDCG. The searches go
through :class:`ance_tpu_torch.index.flat.FlatIPIndex` (block-max top-k,
the kernel of ``csrc/blockmax.cu`` on the card); the files are the JAX
package's, byte for byte.
"""

from __future__ import annotations

import json
import os
import random
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from ance_tpu_torch.evaluation.qa_validation import has_answer
from ance_tpu_torch.index.flat import FlatIPIndex
from ance_tpu_torch.train.ann_gen import ANN_DATA_PREFIX, ANN_NDCG_PREFIX
from ance_tpu_torch.train.encode import encode_cache_to_device, synced_clock


def generate_new_ann_dpr(*, output_num: int, checkpoint_path: str,
                         query_encode_fn, body_encode_fn,
                         train_query_cache, test_query_cache,
                         trivia_test_query_cache, passage_cache,
                         passage_texts: Mapping[int, tuple[str, str]],
                         train_answers: Mapping[int, Sequence[str]],
                         test_answers: Mapping[int, Sequence[str]],
                         trivia_test_answers: Mapping[int, Sequence[str]],
                         training_query_positive_id: Mapping[int, int],
                         output_dir: str, device, topk_training: int = 100,
                         negative_sample: int = 20,
                         dev_search_depth: int = 100,
                         encode_batch_size: int = 128,
                         index_quantize: Optional[str] = None) -> dict:
    """One encode → index → validate → mine → write pass (reference
    run_ann_data_gen_dpr.py:204-278). ``query_encode_fn`` /
    ``body_encode_fn`` are ``train/encode.py::make_encode_fn`` closures
    over the BiEncoder's towers (the JAX function's ``params``);
    ``passage_texts`` is keyed by cache offset.

    Returns the JAX function's keys (``top20``, ``top100``,
    ``top20_trivia``, ``top100_trivia``, ``data_path``, ``ndcg_path``,
    ``index``) plus ``passage_embedding2id``, the test and train
    questions' embeddings (on the device) and ranked ids (``*_neighbor_ids``,
    numpy), the two hit curves (``top_k_hits``, ``top_k_hits_trivia``) and
    ``seconds`` (host clock after a device synchronize: encode, each
    search, total)."""
    device = torch.device(device)
    now = synced_clock(device)
    t_start = now()
    bs = encode_batch_size
    q_emb, q_ids = encode_cache_to_device(query_encode_fn, train_query_cache,
                                          bs)
    test_emb, test_ids = encode_cache_to_device(query_encode_fn,
                                                test_query_cache, bs)
    trivia_emb, trivia_ids = encode_cache_to_device(
        query_encode_fn, trivia_test_query_cache, bs)
    t0 = now()
    passage_emb, passage_ids = encode_cache_to_device(body_encode_fn,
                                                      passage_cache, bs)
    seconds = {"encode_passages": now() - t0}

    index = FlatIPIndex(dim=passage_emb.shape[1], device=device,
                        quantize=index_quantize or False)
    if index.quantize == "dims":
        index.add_chunked(passage_emb)  # never stages an fp32 copy
    else:
        index.add(passage_emb)
    del passage_emb

    def search(what: str, queries: torch.Tensor, k: int) -> np.ndarray:
        t0 = now()
        ids = index.search(queries, k)[1].cpu().numpy()
        seconds[f"search_{what}"] = now() - t0
        return ids

    k_dev = min(dev_search_depth, index.ntotal)
    test_I = search("test", test_emb, k_dev)
    top_k_hits = validate(passage_texts, test_answers, test_I, test_ids,
                          passage_ids)
    trivia_I = search("trivia", trivia_emb, k_dev)
    top_k_hits_trivia = validate(passage_texts, trivia_test_answers,
                                 trivia_I, trivia_ids, passage_ids)
    train_I = search("mining", q_emb, min(topk_training, index.ntotal))
    negatives = mine_negatives_dpr(passage_texts, train_answers, q_ids,
                                   passage_ids, train_I,
                                   training_query_positive_id,
                                   negative_sample)

    def at(hits: list, k: int) -> float:
        return hits[min(k - 1, len(hits) - 1)]

    metrics = {"top20": at(top_k_hits, 20), "top100": at(top_k_hits, 100),
               "top20_trivia": at(top_k_hits_trivia, 20),
               "top100_trivia": at(top_k_hits_trivia, 100)}
    data_path, ndcg_path = write_dpr_ann_data(
        output_dir, output_num, q_ids, training_query_positive_id, negatives,
        metrics, checkpoint_path)
    seconds["total"] = now() - t_start
    out = dict(metrics)
    out.update({"data_path": data_path, "ndcg_path": ndcg_path,
                "index": index, "passage_embedding2id": passage_ids,
                "test_query_embedding": test_emb,
                "test_neighbor_ids": test_I,
                "train_query_embedding": q_emb, "train_neighbor_ids": train_I,
                "top_k_hits": top_k_hits,
                "top_k_hits_trivia": top_k_hits_trivia, "seconds": seconds})
    return out


def validate(passage_texts: Mapping[int, tuple[str, str]],
             answers: Mapping[int, Sequence[str]],
             closest_docs: np.ndarray,
             query_embedding2id: np.ndarray,
             passage_embedding2id: np.ndarray) -> list[float]:
    """The top-k answer-hit curve (reference run_ann_data_gen_dpr.py:
    312-340): entry k is the share of questions with an answer-bearing
    passage in their top k + 1."""
    scores = []
    for qi in range(closest_docs.shape[0]):
        qid = int(query_embedding2id[qi])
        scores.append([
            has_answer(answers[qid],
                       passage_texts[int(passage_embedding2id[p])][0])
            for p in closest_docs[qi]])
    top_k_hits = [0] * closest_docs.shape[1]
    for question_hits in scores:
        best = next((i for i, x in enumerate(question_hits) if x), None)
        if best is not None:
            top_k_hits[best:] = [v + 1 for v in top_k_hits[best:]]
    return [v / len(scores) for v in top_k_hits]


def mine_negatives_dpr(passage_texts: Mapping[int, tuple[str, str]],
                       answers: Mapping[int, Sequence[str]],
                       query_embedding2id: np.ndarray,
                       passage_embedding2id: np.ndarray,
                       closest_docs: np.ndarray,
                       training_query_positive_id: Mapping[int, int],
                       negative_sample: int) -> dict[int, list[int]]:
    """Answer-filtered negatives (reference run_ann_data_gen_dpr.py:
    281-309), with the reference's quirk kept: a candidate that holds an
    answer is dropped but still uses up one of the ``negative_sample``
    places."""
    out: dict[int, list[int]] = {}
    for qi in range(closest_docs.shape[0]):
        qid = int(query_embedding2id[qi])
        pos_pid = training_query_positive_id[qid]
        out[qid] = []
        neg_cnt = 0
        for pidx in closest_docs[qi]:
            doc_id = int(passage_embedding2id[pidx])
            if doc_id == pos_pid or doc_id in out[qid]:
                continue
            if neg_cnt >= negative_sample:
                break
            if not has_answer(answers[qid], passage_texts[doc_id][0]):
                out[qid].append(doc_id)
            neg_cnt += 1
    return out


def write_dpr_ann_data(output_dir: str, output_num: int,
                       query_embedding2id: np.ndarray,
                       training_query_positive_id: Mapping[int, int],
                       query_negative_passage: Mapping[int, Sequence[int]],
                       metrics: dict, checkpoint_path: str
                       ) -> tuple[str, str]:
    """The triple lines shuffled by ``random.Random(0)`` (the JAX
    function's default seed), then the top-k-hit JSON sidecar, LAST: the
    ready signal (reference run_ann_data_gen_dpr.py:265-278)."""
    os.makedirs(output_dir, exist_ok=True)
    data_path = os.path.join(output_dir, ANN_DATA_PREFIX + str(output_num))
    order = list(range(len(query_embedding2id)))
    random.Random(0).shuffle(order)
    with open(data_path, "w") as f:
        for qi in order:
            qid = int(query_embedding2id[qi])
            negs = query_negative_passage.get(qid, [])
            if not negs:
                continue
            f.write("{}\t{}\t{}\n".format(
                qid, training_query_positive_id[qid],
                ",".join(str(p) for p in negs)))
    sidecar = dict(metrics)
    sidecar["checkpoint"] = checkpoint_path
    ndcg_path = os.path.join(output_dir, ANN_NDCG_PREFIX + str(output_num))
    with open(ndcg_path, "w") as f:
        json.dump(sidecar, f)
    return data_path, ndcg_path
