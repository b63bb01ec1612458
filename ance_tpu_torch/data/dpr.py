"""DPR (NQ / TriviaQA open-QA) preprocessing (numpy and the standard
library only).

The port's copy of ``ance_tpu/data/dpr.py``; both write the same bytes on
the same input and tokenizer (reference data/DPR_data.py):

  * Wikipedia ``psgs_w100.tsv`` (``id\\ttext\\ttitle``) → the ``passages``
    cache over spawned workers (:mod:`ance_tpu_torch.data.preprocess`),
    title and text encoded as a BERT pair, the SEP restored on truncation
    (DPR_data.py:250-256), and the text ``pid2offset`` map;
  * DPR train / dev JSON → per split a query cache (``<split>-query``, qid
    = row order), ``<split>-ann`` (``qid\\tpos_offset\\t<answers repr>``)
    and ``<split>-data`` (``qid\\tpos_offset\\tneg_offsets``); questions
    without a positive or a hard negative are dropped (DPR_data.py:54-118);
  * the test qas CSVs → query caches (DPR_data.py:23-52);
  * NQ, TriviaQA or both merged (``data_type`` 0 / 1 / 2,
    DPR_data.py:189-221).

A tokenizer has HF's ``encode(text, text_pair=, add_special_tokens=,
max_length=)``, ``pad_token_id`` and ``sep_token_id``.
"""

from __future__ import annotations

import ast
import csv
import dataclasses
import json
import os
from typing import Callable, Optional

import numpy as np

from ance_tpu_torch.data.cache import TokenCacheWriter, merge_split_files
from ance_tpu_torch.data.preprocess import (_cleanup_splits,
                                            multi_process_tokenize)


@dataclasses.dataclass
class DprPreprocessConfig:
    wiki_dir: str
    question_dir: str
    answer_dir: str
    out_data_dir: str
    data_type: int = 0            # 0 = NQ, 1 = TriviaQA, 2 = both
    max_seq_length: int = 256
    num_processes: int = 16


def normalize_question(question: str) -> str:
    return question[:-1] if question.endswith("?") else question


def _encode_fixed(tokenizer, max_len: int, text: str,
                  text_pair: Optional[str] = None) -> tuple[int, list[int]]:
    """(untruncated length, ids padded or cut to ``max_len``), the last id
    of a cut sequence set back to SEP (DPR_data.py:256-267)."""
    if text_pair is not None:
        ids = tokenizer.encode(text, text_pair=text_pair,
                               add_special_tokens=True, max_length=None)
    else:
        ids = tokenizer.encode(text, add_special_tokens=True, max_length=None)
    if hasattr(ids, "ids"):  # an HF fast-tokenizer Encoding
        ids = ids.ids
    ids = list(ids)
    length = len(ids)
    if length < max_len:
        ids = ids + [tokenizer.pad_token_id] * (max_len - length)
    elif length > max_len:
        ids = ids[:max_len]
        ids[-1] = tokenizer.sep_token_id
    return length, ids


def dpr_passage_record(cfg: DprPreprocessConfig, line: str, tokenizer
                       ) -> bytes:
    """A ``psgs_w100.tsv`` row → an id-prefixed split record; the header
    row → nothing (DPR_data.py:250-254)."""
    row = next(csv.reader([line], delimiter="\t"))
    if row[0] == "id":
        return b""
    text, title = row[1], row[2]
    length, ids = _encode_fixed(tokenizer, cfg.max_seq_length, title, text)
    return int(row[0]).to_bytes(8, "big") + min(
        length, cfg.max_seq_length).to_bytes(4, "big") + \
        np.asarray(ids, np.int32).tobytes()


def write_mapping(out_data_dir: str, id2offset: dict, name: str) -> None:
    with open(os.path.join(out_data_dir, name), "w") as f:
        for k, v in id2offset.items():
            f.write(f"{k}\t{v}\n")


def load_mapping(data_dir: str, name: str) -> tuple[dict, dict]:
    """(id → offset, offset → id) from a text mapping."""
    pid2offset, offset2pid = {}, {}
    with open(os.path.join(data_dir, name)) as f:
        for line in f:
            a, b = line.split("\t")
            pid2offset[int(a)] = int(b)
            offset2pid[int(b)] = int(a)
    return pid2offset, offset2pid


def write_query_rel(cfg: DprPreprocessConfig, pid2offset: dict,
                    query_file: str, out_query_file: str, out_ann_file: str,
                    out_train_file: str, tokenizer,
                    passage_id_name: str = "passage_id") -> int:
    """DPR JSON → query cache, ``-ann`` and ``-data`` files
    (DPR_data.py:54-118). Returns the number of queries written."""
    with open(os.path.join(cfg.question_dir, query_file),
              encoding="utf-8") as f:
        data = json.load(f)
    data = [r for r in data if len(r["positive_ctxs"]) > 0]
    data = [r for r in data if len(r["hard_negative_ctxs"]) > 0]
    out = cfg.out_data_dir
    with TokenCacheWriter(os.path.join(out, out_query_file),
                          cfg.max_seq_length) as w, \
            open(os.path.join(out, out_ann_file), "w",
                 encoding="utf-8") as out_ann, \
            open(os.path.join(out, out_train_file), "w",
                 encoding="utf-8") as out_training:
        for qid, sample in enumerate(data):
            pos = pid2offset[int(sample["positive_ctxs"][0][passage_id_name])]
            negs = [str(pid2offset[int(n[passage_id_name])])
                    for n in sample["hard_negative_ctxs"]]
            out_ann.write(f"{qid}\t{pos}\t{sample['answers']}\n")
            out_training.write(f"{qid}\t{pos}\t{','.join(negs)}\n")
            length, ids = _encode_fixed(
                tokenizer, cfg.max_seq_length,
                normalize_question(sample["question"]))
            w.write(min(length, cfg.max_seq_length), ids)
    return len(data)


def write_qas_query(cfg: DprPreprocessConfig, qas_file: str,
                    out_query_file: str, tokenizer) -> int:
    """A test qas CSV (``question\\tanswers``) → a query cache
    (DPR_data.py:23-52). Returns the number of queries written."""
    n = 0
    with open(os.path.join(cfg.answer_dir, qas_file), encoding="utf-8") as f, \
            TokenCacheWriter(os.path.join(cfg.out_data_dir, out_query_file),
                             cfg.max_seq_length) as w:
        for row in csv.reader(f, delimiter="\t"):
            length, ids = _encode_fixed(tokenizer, cfg.max_seq_length,
                                        normalize_question(row[0]))
            w.write(min(length, cfg.max_seq_length), ids)
            n += 1
    return n


def load_answers(path: str) -> dict[int, list[str]]:
    """``<split>-ann`` lines → qid → answers (written as a Python list repr,
    DPR_data.py:104)."""
    out: dict[int, list[str]] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            qid, _, answers = line.rstrip("\n").split("\t", 2)
            out[int(qid)] = list(ast.literal_eval(answers))
    return out


def load_qas_answers(path: Optional[str]) -> dict[int, list[str]]:
    """A qas CSV (``question\\tanswers repr``) → row number → answers; {}
    without a file (``ance_tpu/cli.py::_qas_answers``)."""
    out: dict[int, list[str]] = {}
    if not path or not os.path.exists(path):
        return out
    with open(path, encoding="utf-8") as f:
        for qid, row in enumerate(csv.reader(f, delimiter="\t")):
            out[qid] = list(ast.literal_eval(row[1]))
    return out


def load_positive_ids(path: str) -> dict[int, int]:
    """qid → positive offset from an ``-ann`` or ``-data`` file."""
    out: dict[int, int] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            qid, pos, _ = line.rstrip("\n").split("\t", 2)
            out[int(qid)] = int(pos)
    return out


def load_passage_texts(wiki_path: str) -> dict[int, tuple[str, str]]:
    """Raw pid → (text, title) from ``psgs_w100.tsv``; key it by offset
    through ``pid2offset`` (reference run_ann_data_gen_dpr.py:63-109)."""
    out = {}
    with open(wiki_path, encoding="utf-8") as f:
        for row in csv.reader(f, delimiter="\t"):
            if row[0] == "id":
                continue
            out[int(row[0])] = (row[1], row[2])
    return out


def preprocess_dpr(cfg: DprPreprocessConfig, tokenizer_factory: Callable
                   ) -> dict:
    """The corpus, then the train, dev and test questions
    (DPR_data.py:145-247). Returns the count of each split and the
    ``pid2offset`` map, or ``{"skipped": True}`` when the passages cache
    exists already."""
    os.makedirs(cfg.out_data_dir, exist_ok=True)
    out_passage_path = os.path.join(cfg.out_data_dir, "passages")
    if os.path.exists(out_passage_path):
        return {"skipped": True}

    multi_process_tokenize(cfg, os.path.join(cfg.wiki_dir, "psgs_w100.tsv"),
                           out_passage_path, dpr_passage_record,
                           tokenizer_factory)
    pid2offset = merge_split_files(out_passage_path, cfg.num_processes,
                                   cfg.max_seq_length)
    _cleanup_splits(out_passage_path, cfg.num_processes)
    write_mapping(cfg.out_data_dir, pid2offset, "pid2offset")

    tokenizer = tokenizer_factory()
    counts = {"pid2offset": pid2offset}
    if cfg.data_type == 0:
        counts["train"] = write_query_rel(
            cfg, pid2offset, "nq-train.json", "train-query", "train-ann",
            "train-data", tokenizer)
    elif cfg.data_type == 1:
        counts["train"] = write_query_rel(
            cfg, pid2offset, "trivia-train.json", "train-query", "train-ann",
            "train-data", tokenizer, "psg_id")
    else:
        n_nq = write_query_rel(cfg, pid2offset, "nq-train.json",
                               "train-query-nq", "train-ann-nq",
                               "train-data-nq", tokenizer)
        n_tr = write_query_rel(cfg, pid2offset, "trivia-train.json",
                               "train-query-trivia", "train-ann-trivia",
                               "train-data-trivia", tokenizer, "psg_id")
        _merge_query_caches(cfg, ["train-query-nq", "train-query-trivia"],
                            "train-query")
        with open(os.path.join(cfg.out_data_dir, "train-ann"), "w") as out:
            for name in ("train-ann-nq", "train-ann-trivia"):
                with open(os.path.join(cfg.out_data_dir, name)) as f:
                    out.write(f.read())
        counts["train"] = n_nq + n_tr

    counts["dev"] = write_query_rel(cfg, pid2offset, "nq-dev.json",
                                    "dev-query", "dev-ann", "dev-data",
                                    tokenizer)
    counts["dev_trivia"] = write_query_rel(
        cfg, pid2offset, "trivia-dev.json", "dev-query-trivia",
        "dev-ann-trivia", "dev-data-trivia", tokenizer, "psg_id")
    counts["test"] = write_qas_query(cfg, "nq-test.csv", "test-query",
                                     tokenizer)
    counts["test_trivia"] = write_qas_query(cfg, "trivia-test.csv",
                                            "trivia-test-query", tokenizer)
    return counts


def _merge_query_caches(cfg: DprPreprocessConfig, names: list[str],
                        out_name: str) -> None:
    """Concatenate fixed-record caches and their counts
    (DPR_data.py:200-215)."""
    out = os.path.join(cfg.out_data_dir, out_name)
    total = 0
    with open(out, "wb") as f:
        for name in names:
            path = os.path.join(cfg.out_data_dir, name)
            with open(path, "rb") as src:
                f.write(src.read())
            with open(path + "_meta") as meta:
                total += json.load(meta)["total_number"]
    with open(out + "_meta", "w") as f:
        json.dump({"type": "int32", "total_number": total,
                   "embedding_size": cfg.max_seq_length}, f)
