"""Offline preprocessing: raw MS MARCO TSVs → binary token caches (numpy
and the standard library only).

The port's copy of ``ance_tpu/data/preprocess.py``; both write the same
bytes on the same input and tokenizer (reference data/msmarco_data.py:
18-272, utils/util.py:332-365):

  * N-process tokenization: worker i keeps lines ``idx % N == i`` and
    writes id-prefixed records to ``<out>_split<i>``;
  * the splits merge in order into the final cache (id prefix dropped),
    with ``pid2offset`` / ``qid2offset`` id → row maps;
  * qrels are rewritten in offset space as ``qoffset\\tpoffset\\trel``;
  * passage mode (``data_type=1``): ``collection.tsv`` (pid\\ttext);
  * document mode (``data_type=0``): ``msmarco-docs.tsv`` with ``url <sep>
    title <sep> body``, a 10k-character clamp and ``D123`` ids.

A tokenizer has HF's ``encode(text, add_special_tokens=, max_length=)``,
``pad_token_id`` and ``sep_token``. Workers are spawned, not forked (a
forked child of a process that holds a CUDA context is unsafe), so the
``tokenizer_factory`` they call must be picklable.
"""

from __future__ import annotations

import dataclasses
import gzip
import multiprocessing
import os
import pickle
from typing import Callable

import numpy as np

from ance_tpu_torch.data.cache import merge_split_files


@dataclasses.dataclass
class PreprocessConfig:
    data_dir: str
    out_data_dir: str
    data_type: int = 1            # 0 = MS MARCO doc, 1 = MS MARCO passage
    max_seq_length: int = 128
    max_query_length: int = 64
    max_doc_character: int = 10000
    num_processes: int = 32


def _open_text(path: str):
    if path.endswith("gz"):
        return gzip.open(path, "rt", encoding="utf8")
    return open(path, "r", encoding="utf-8")


def _encode_record(rid: int, text: str, tokenizer, max_len: int) -> bytes:
    """8-byte big-endian id + 4-byte length + int32 token ids padded to
    ``max_len`` (reference msmarco_data.py:222-272)."""
    ids = tokenizer.encode(text, add_special_tokens=True, max_length=max_len)
    if hasattr(ids, "ids"):  # an HF fast-tokenizer Encoding
        ids = ids.ids
    ids = list(ids)[:max_len]
    length = len(ids)
    ids = ids + [tokenizer.pad_token_id] * (max_len - length)
    return rid.to_bytes(8, "big") + length.to_bytes(4, "big") + \
        np.asarray(ids, np.int32).tobytes()


def passage_record(cfg: PreprocessConfig, line: str, tokenizer) -> bytes:
    """PassagePreprocessingFn parity (reference msmarco_data.py:222-258)."""
    if cfg.data_type == 0:
        arr = line.split("\t")
        p_id = int(arr[0][1:])  # strip "D"
        url, title, body = arr[1].rstrip(), arr[2].rstrip(), arr[3].rstrip()
        sep = f" {tokenizer.sep_token} "
        full_text = (url + sep + title + sep + body)[:cfg.max_doc_character]
    else:
        arr = line.strip().split("\t")
        p_id = int(arr[0])
        full_text = arr[1].rstrip()[:cfg.max_doc_character]
    return _encode_record(p_id, full_text, tokenizer, cfg.max_seq_length)


def query_record(cfg: PreprocessConfig, line: str, tokenizer) -> bytes:
    arr = line.split("\t")
    return _encode_record(int(arr[0]), arr[1].rstrip(), tokenizer,
                          cfg.max_query_length)


def _tokenize_split(cfg, i, n, in_path, out_path, line_fn, tokenizer_factory):
    tokenizer = tokenizer_factory()
    with _open_text(in_path) as in_f, \
            open(f"{out_path}_split{i}", "wb") as out_f:
        for idx, line in enumerate(in_f):
            if idx % n != i:
                continue
            out_f.write(line_fn(cfg, line, tokenizer))


def multi_process_tokenize(cfg: PreprocessConfig, in_path: str, out_path: str,
                           line_fn: Callable, tokenizer_factory: Callable
                           ) -> None:
    """Tokenize ``in_path`` over ``cfg.num_processes`` spawned processes
    (reference utils/util.py:349-365); one process runs in this one."""
    n = cfg.num_processes
    if n <= 1:
        _tokenize_split(cfg, 0, 1, in_path, out_path, line_fn,
                        tokenizer_factory)
        return
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_tokenize_split,
                         args=(cfg, i, n, in_path, out_path, line_fn,
                               tokenizer_factory))
             for i in range(n)]
    for p in procs:
        p.start()
    for p in procs:
        p.join()
        if p.exitcode != 0:
            raise RuntimeError(f"tokenizer worker failed: {p.exitcode}")


def _cleanup_splits(out_path: str, n: int) -> None:
    for i in range(n):
        try:
            os.remove(f"{out_path}_split{i}")
        except FileNotFoundError:
            pass


def _save_id_map(path: str, mapping: dict) -> None:
    with open(path, "wb") as f:
        pickle.dump(mapping, f, protocol=4)


def load_id_map(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)


def _read_qrels(cfg: PreprocessConfig, path: str):
    """(topicid, docid, rel) of each qrel line; document mode reads
    space-delimited lines and strips the ``D`` (reference
    msmarco_data.py:33-38, 110-115)."""
    delim = " " if cfg.data_type == 0 else "\t"
    with _open_text(path) as f:
        for line in f:
            if not line.strip():
                continue
            topicid, _, docid, rel = line.rstrip("\n").split(delim)
            docid = int(docid[1:]) if cfg.data_type == 0 else int(docid)
            yield int(topicid), docid, rel


def write_query_rel(cfg: PreprocessConfig, pid2offset: dict,
                    query_file: str, positive_id_file: str,
                    out_query_file: str, out_id_file: str,
                    tokenizer_factory: Callable) -> dict:
    """Tokenize the queries that have a qrel and write the offset-space
    qrels (reference msmarco_data.py:18-123). Returns qid2offset."""
    qrels_path = os.path.join(cfg.data_dir, positive_id_file)
    query_positive_id = {t for t, _, _ in _read_qrels(cfg, qrels_path)}

    out_query_path = os.path.join(cfg.out_data_dir, out_query_file)
    multi_process_tokenize(cfg, os.path.join(cfg.data_dir, query_file),
                           out_query_path, query_record, tokenizer_factory)
    qid2offset = merge_split_files(
        out_query_path, cfg.num_processes, cfg.max_query_length,
        keep_id=lambda q: q in query_positive_id)
    _cleanup_splits(out_query_path, cfg.num_processes)
    _save_id_map(os.path.join(cfg.out_data_dir, "qid2offset.pickle"),
                 qid2offset)
    # each split overwrites qid2offset.pickle (reference quirk,
    # msmarco_data.py:87-89), so serving reads this split's own copy
    _save_id_map(os.path.join(cfg.out_data_dir,
                              f"{out_query_file}_qid2offset.pickle"),
                 qid2offset)

    with open(os.path.join(cfg.out_data_dir, out_id_file), "w") as out:
        for topicid, docid, rel in _read_qrels(cfg, qrels_path):
            out.write(f"{qid2offset[topicid]}\t{pid2offset[docid]}\t{rel}\n")
    return qid2offset


def preprocess(cfg: PreprocessConfig, tokenizer_factory: Callable) -> dict:
    """The corpus, then the train and dev queries (reference
    msmarco_data.py:126-219). Returns the id maps by name, or
    ``{"skipped": True}`` when the passages cache exists already (an
    idempotent restart, reference msmarco_data.py:145-147)."""
    os.makedirs(cfg.out_data_dir, exist_ok=True)
    corpus_file = "msmarco-docs.tsv" if cfg.data_type == 0 \
        else "collection.tsv"
    out_passage_path = os.path.join(cfg.out_data_dir, "passages")
    if os.path.exists(out_passage_path):
        return {"skipped": True}

    multi_process_tokenize(cfg, os.path.join(cfg.data_dir, corpus_file),
                           out_passage_path, passage_record,
                           tokenizer_factory)
    pid2offset = merge_split_files(out_passage_path, cfg.num_processes,
                                   cfg.max_seq_length)
    _cleanup_splits(out_passage_path, cfg.num_processes)
    _save_id_map(os.path.join(cfg.out_data_dir, "pid2offset.pickle"),
                 pid2offset)

    if cfg.data_type == 0:
        query_files = {
            "train": ("msmarco-doctrain-queries.tsv",
                      "msmarco-doctrain-qrels.tsv"),
            "dev": ("msmarco-test2019-queries.tsv", "2019qrels-docs.txt"),
        }
    else:
        query_files = {
            "train": ("queries.train.tsv", "qrels.train.tsv"),
            "dev": ("queries.dev.small.tsv", "qrels.dev.small.tsv"),
        }
    maps = {"pid2offset": pid2offset}
    for split, (qfile, relfile) in query_files.items():
        maps[f"{split}_qid2offset"] = write_query_rel(
            cfg, pid2offset, qfile, relfile,
            f"{split}-query", f"{split}-qrel.tsv", tokenizer_factory)
    return maps
