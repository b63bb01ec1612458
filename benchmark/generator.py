"""The one traffic generator: token records of seeded lengths.

A traffic file (``traffic/<name>.json``) names record streams, each with
its record count, its width (the cache's padded length) and a log-normal
length distribution (``median``, ``sigma``, ``min``; the width caps it,
so a long tail is cut at the width as the preprocessing truncates).

Every seed gets the same multiset of lengths: the lengths are the
distribution's quantiles at ``(i + 0.5) / n``, and the seed only orders
them and draws the token ids. So the work of a whole stream does not move
with the seed. A record is ``<s> t1 ... </s>`` (RoBERTa's ids 0 and 2) over
ids drawn uniformly from the rest of the vocabulary, padded with the pad id.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from benchmark.weights import derived_seed


def stream_lengths(spec: dict, seed: int, tag: int) -> np.ndarray:
    """[n] int64 lengths of one stream: quantiles, then a seeded order."""
    n, width = int(spec["records"]), int(spec["width"])
    dist = spec["length"]
    p = (torch.arange(n, dtype=torch.float64) + 0.5) / n
    z = torch.special.ndtri(p).numpy()
    lengths = np.rint(np.exp(np.log(dist["median"]) + dist["sigma"] * z))
    lengths = np.clip(lengths, dist["min"], width).astype(np.int64)
    rng = np.random.default_rng(derived_seed(seed, 2, tag))
    return lengths[rng.permutation(n)]


def stream_tokens(spec: dict, lengths: np.ndarray, seed: int, tag: int,
                  cfg: dict, rows=None) -> np.ndarray:
    """[n, width] int32 token ids of the records ``rows`` (all by default),
    ``lengths`` being the whole stream's. The ids of records
    ``[4096·b, 4096·(b + 1))`` come from a generator of ``(seed, tag, b)``,
    so any record can be made again alone."""
    width = int(spec["width"])
    rows = np.arange(len(lengths)) if rows is None else np.asarray(rows)
    out = np.empty((len(rows), width), np.int32)
    for b in np.unique(rows // 4096):
        rng = np.random.default_rng(derived_seed(seed, 3, tag, int(b)))
        block = rng.integers(3, cfg["vocab_size"], (4096, width),
                             dtype=np.int32)
        here = rows // 4096 == b
        out[here] = block[rows[here] % 4096]
    lens = lengths[rows]
    out[np.arange(width)[None, :] >= lens[:, None]] = cfg["pad_token_id"]
    out[:, 0] = cfg["bos_token_id"]
    out[np.arange(len(rows)), lens - 1] = cfg["eos_token_id"]
    return out


def write_token_cache(path: str, lengths: np.ndarray,
                      tokens: np.ndarray) -> None:
    """The port's ``TokenCache`` layout: per record a 4-byte big-endian
    length and ``width`` int32 ids; ``<path>_meta`` JSON beside it."""
    n, width = tokens.shape
    rec = np.empty(n, np.dtype([("len", ">u4"), ("tok", "<i4", (width,))]))
    rec["len"] = lengths
    rec["tok"] = tokens
    rec.tofile(path)
    with open(path + "_meta", "w") as f:
        json.dump({"type": "int32", "total_number": int(n),
                   "embedding_size": int(width)}, f)


class Stream:
    """One named record stream of a traffic file: its lengths, and its
    cache written under ``directory``."""

    def __init__(self, name: str, spec: dict, seed: int, tag: int, cfg: dict):
        self.name, self.spec, self.seed, self.tag = name, spec, seed, tag
        self.cfg = cfg
        self.width = int(spec["width"])
        self.lengths = stream_lengths(spec, seed, tag)

    def __len__(self) -> int:
        return len(self.lengths)

    def tokens(self, rows=None) -> np.ndarray:
        return stream_tokens(self.spec, self.lengths, self.seed, self.tag,
                             self.cfg, rows)

    def write_cache(self, directory: str) -> str:
        path = os.path.join(directory, self.name)
        write_token_cache(path, self.lengths, self.tokens())
        return path


def load_streams(traffic: dict, seed: int, cfg: dict) -> dict[str, Stream]:
    """Every stream of a traffic file, each with its own seed tag (its
    place in the file)."""
    return {name: Stream(name, spec, seed, i, cfg)
            for i, (name, spec) in enumerate(sorted(traffic["streams"]
                                                    .items()))}


def corpus_block(seed: int, block: int, rows: int, dim: int,
                 device) -> torch.Tensor:
    """Rows of an index made on the device from ``(seed, block)``:
    [rows, dim] fp32 N(0, 1), so any block can be made again alone."""
    g = torch.Generator(device=device).manual_seed(derived_seed(seed, 4,
                                                                block))
    return torch.randn(rows, dim, generator=g, device=device)
