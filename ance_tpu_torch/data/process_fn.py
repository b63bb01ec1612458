"""On-the-fly tokenization of raw-text streams (numpy only).

The port's copy of ``ance_tpu/data/process_fn.py``: the warmup trains
straight off ``triples.train.small.tsv`` with no binary cache (reference
data/process_fn.py:48-71, triple_process_fn, used by
drivers/run_warmup.py:171-174), the in-training eval streams ``id\\ttext``
pairs (dual_process_fn, reference process_fn.py:20-45), and serving pads
one query text at a time. A tokenizer is anything with HF's
``encode(text, add_special_tokens=, max_length=)`` and ``pad_token_id``.
"""

from __future__ import annotations

from typing import Iterable, Iterator

import numpy as np


def encode_padded(tokenizer, text: str, max_len: int
                  ) -> tuple[np.ndarray, np.ndarray]:
    """One text → (ids [max_len] int32, mask [max_len] int32), truncated
    and padded with the tokenizer's pad id (reference process_fn.pad_ids,
    process_fn.py:4-17)."""
    ids = tokenizer.encode(text.strip(), add_special_tokens=True,
                           max_length=max_len)
    if hasattr(ids, "ids"):  # an HF fast-tokenizer Encoding
        ids = ids.ids
    ids = list(ids)[:max_len]
    out = np.full(max_len, tokenizer.pad_token_id, np.int32)
    out[:len(ids)] = ids
    mask = np.zeros(max_len, np.int32)
    mask[:len(ids)] = 1
    return out, mask


def triple_batches(tokenizer, lines: Iterable[str], batch_size: int,
                   max_len: int, host_id: int = 0, num_hosts: int = 1
                   ) -> Iterator[dict]:
    """``query\\tpos\\tneg`` lines → train batches of ``{query,pos,neg}_ids``
    and ``_mask`` (triple_process_fn parity, reference process_fn.py:48-71),
    line i to host ``i % num_hosts`` as StreamingDataset stripes ranks
    (utils/util.py:318-329). A final partial batch is dropped."""
    keys = ("query_ids", "query_mask", "pos_ids", "pos_mask", "neg_ids",
            "neg_mask")
    buf = {k: [] for k in keys}
    for i, line in enumerate(lines):
        if i % num_hosts != host_id:
            continue
        cells = line.rstrip("\n").split("\t")
        if len(cells) != 3:
            raise ValueError(
                f"Line doesn't have correct length: {len(cells)}. Expected 3.")
        for text, prefix in zip(cells, ("query", "pos", "neg")):
            ids, mask = encode_padded(tokenizer, text, max_len)
            buf[f"{prefix}_ids"].append(ids)
            buf[f"{prefix}_mask"].append(mask)
        if len(buf["query_ids"]) == batch_size:
            yield {k: np.stack(v) for k, v in buf.items()}
            buf = {k: [] for k in keys}


def dual_batches(tokenizer, lines: Iterable[str], batch_size: int,
                 max_len: int, host_id: int = 0, num_hosts: int = 1
                 ) -> Iterator[dict]:
    """``id\\ttext`` lines → inference batches of ``ids``, ``mask`` and
    ``rec_ids`` (dual_process_fn parity, reference process_fn.py:20-45),
    striped across hosts as :func:`triple_batches`. The final partial batch
    is emitted unpadded."""
    ids_buf, mask_buf, rid_buf = [], [], []
    for i, line in enumerate(lines):
        if i % num_hosts != host_id:
            continue
        cells = line.rstrip("\n").split("\t")
        if len(cells) != 2:
            raise ValueError(
                f"Line doesn't have correct length: {len(cells)}. Expected 2.")
        ids, mask = encode_padded(tokenizer, cells[1], max_len)
        ids_buf.append(ids)
        mask_buf.append(mask)
        rid_buf.append(int(cells[0]))
        if len(ids_buf) == batch_size:
            yield {"ids": np.stack(ids_buf), "mask": np.stack(mask_buf),
                   "rec_ids": np.asarray(rid_buf, np.int64)}
            ids_buf, mask_buf, rid_buf = [], [], []
    if ids_buf:
        yield {"ids": np.stack(ids_buf), "mask": np.stack(mask_buf),
               "rec_ids": np.asarray(rid_buf, np.int64)}
