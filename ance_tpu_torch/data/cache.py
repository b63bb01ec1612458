"""Fixed-record binary token caches (numpy only).

The port's own reader and writer for the format of ``ance_tpu/data/cache.py``
(itself the reference's ``EmbeddingCache`` layout), so either package reads
the other's caches:

  * ``<base>``        concatenated records, each a 4-byte big-endian length
                      followed by ``embedding_size`` items of ``dtype``
  * ``<base>_meta``   JSON ``{"type": "int32", "total_number": N,
                      "embedding_size": L}``

:func:`merge_split_files` turns the id-prefixed split files that
preprocessing's workers write into one such cache and an id → offset map.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Iterator, Optional, Sequence

import numpy as np


class TokenCache:
    """Reader over a token cache through a read-only ``np.memmap``: a
    context manager with ``len()``, ``cache[i] → (length, tokens)``,
    batched ``batch(keys)``, and iteration in ``ix_array`` order — a
    ``RandomState(seed)`` permutation for ``seed >= 0``, else the file's
    (the reference's ``EmbeddingCache``)."""

    def __init__(self, base_path: str | os.PathLike, seed: int = -1):
        self.base_path = str(base_path)
        with open(self.base_path + "_meta", "r") as f:
            meta = json.load(f)
        self.dtype = np.dtype(meta["type"])
        self.total_number = int(meta["total_number"])
        self.embedding_size = int(meta["embedding_size"])
        self.record_size = self.embedding_size * self.dtype.itemsize + 4
        if seed >= 0:
            self.ix_array = np.random.RandomState(seed).permutation(
                self.total_number)
        else:
            self.ix_array = np.arange(self.total_number)
        self._raw: np.memmap | None = None

    def open(self) -> "TokenCache":
        self._raw = np.memmap(self.base_path, dtype=np.uint8, mode="r",
                              shape=(self.total_number * self.record_size,))
        return self

    def close(self) -> None:
        self._raw = None

    def __enter__(self) -> "TokenCache":
        return self.open()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    def __len__(self) -> int:
        return self.total_number

    def _records(self) -> np.ndarray:
        if self._raw is None:
            self.open()
        return self._raw.reshape(self.total_number, self.record_size)

    def __getitem__(self, key: int) -> tuple[int, np.ndarray]:
        """Record ``key`` → (length, tokens [L])."""
        if key < 0 or key >= self.total_number:
            raise IndexError(
                f"Index {key} is out of bound for cached embeddings of size "
                f"{self.total_number}")
        rec = self._records()[key]
        length = int.from_bytes(bytes(rec[:4]), "big")
        return length, np.frombuffer(rec[4:].tobytes(), dtype=self.dtype)

    def __iter__(self) -> Iterator[tuple[int, np.ndarray]]:
        for i in self.ix_array:
            yield self[int(i)]

    def batch(self, keys: Sequence[int] | np.ndarray
              ) -> tuple[np.ndarray, np.ndarray]:
        """Gather records → (lengths [B] int64, tokens [B, L])."""
        keys = np.asarray(keys, dtype=np.int64)
        recs = self._records()[keys]
        lengths = recs[:, :4].copy().view(">u4")[:, 0].astype(np.int64)
        tokens = np.frombuffer(recs[:, 4:].tobytes(), dtype=self.dtype)
        return lengths, tokens.reshape(len(keys), self.embedding_size)


class TokenCacheWriter:
    """Streams records into a cache file and writes its meta JSON on
    close; a context manager."""

    def __init__(self, base_path: str | os.PathLike, embedding_size: int,
                 dtype: str = "int32"):
        self.base_path = str(base_path)
        self.embedding_size = int(embedding_size)
        self.dtype = np.dtype(dtype)
        self._f = open(self.base_path, "wb")
        self._count = 0

    def write(self, length: int, tokens: np.ndarray | Sequence[int]) -> int:
        """Append one record; returns its offset."""
        tokens = np.asarray(tokens, dtype=self.dtype)
        if tokens.shape != (self.embedding_size,):
            raise ValueError(f"record must have shape ({self.embedding_size},)"
                             f", got {tokens.shape}")
        self._f.write(int(length).to_bytes(4, "big"))
        self._f.write(tokens.tobytes())
        self._count += 1
        return self._count - 1

    def close(self) -> None:
        self._f.close()
        with open(self.base_path + "_meta", "w") as f:
            json.dump({"type": self.dtype.name, "total_number": self._count,
                       "embedding_size": self.embedding_size}, f)

    def __enter__(self) -> "TokenCacheWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


def iter_split_records(base_path: str, num_splits: int,
                       record_size: int) -> Iterator[bytes]:
    """Raw records of ``<base>_split{i}``, split after split
    (reference utils/util.py:246-254, numbered_byte_file_generator)."""
    for i in range(num_splits):
        with open(f"{base_path}_split{i}", "rb") as f:
            while True:
                b = f.read(record_size)
                if not b:
                    break
                yield b


def merge_split_files(base_path: str, num_splits: int, max_len: int,
                      dtype: str = "int32",
                      keep_id: Optional[Callable[[int], bool]] = None
                      ) -> dict[int, int]:
    """Merge the split files into the cache ``base_path``; returns the
    id → offset map.

    A split record is an 8-byte big-endian id, a 4-byte big-endian length
    and ``max_len`` tokens (reference data/msmarco_data.py:64-89); the
    cache drops the id. ``keep_id`` drops the records whose id it rejects
    (queries without a qrel, reference data/msmarco_data.py:68-71)."""
    record_size = 8 + 4 + max_len * np.dtype(dtype).itemsize
    id2offset: dict[int, int] = {}
    with TokenCacheWriter(base_path, max_len, dtype) as w:
        for record in iter_split_records(base_path, num_splits, record_size):
            rid = int.from_bytes(record[:8], "big")
            if keep_id is not None and not keep_id(rid):
                continue
            length = int.from_bytes(record[8:12], "big")
            id2offset[rid] = w.write(length,
                                     np.frombuffer(record[12:], dtype=dtype))
    return id2offset
