"""Negative mining's two host passes on the port's own C++ core.

``ance_tpu_torch/native/mining.cpp`` draws ``random.Random.shuffle``'s
orders from a generator's MT19937 state and walks each query's neighbor
ids as ``train/ann_gen.py::mine_negatives`` selects them;
:mod:`ance_tpu_torch.utils.native_build` builds it with g++ at first use
and the calls go through ctypes, as :mod:`ance_tpu_torch.utils.zstd`
binds its decoder.
"""

from __future__ import annotations

import ctypes
import random

import numpy as np

from ance_tpu_torch.utils.native_build import load_native

_lib = None


def _native() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load_native("mining")
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.shuffle_orders.argtypes = [ptr, ptr, ptr, i64, i64]
        lib.shuffle_orders.restype = None
        lib.select_negatives.argtypes = [ptr, i64, ptr, i64, ptr, i64, ptr,
                                         i64, ptr, i64, ptr, ptr, ptr]
        lib.select_negatives.restype = i64
        _lib = lib
    return _lib


def shuffle_orders(rng: random.Random, rows: int, width: int) -> np.ndarray:
    """[rows, width] int32: ``rng.shuffle(list(range(width)))`` once a row,
    drawn natively from ``rng``'s state, which then stands where Python's
    shuffles leave it. ``rng`` must be exactly ``random.Random``: a
    subclass may draw otherwise."""
    version, internal, gauss_next = rng.getstate()
    mt = np.array(internal[:-1], dtype=np.uint32)
    pos = ctypes.c_int64(internal[-1])
    out = np.empty((rows, width), np.int32)
    _native().shuffle_orders(mt.ctypes.data, ctypes.addressof(pos),
                             out.ctypes.data, rows, width)
    rng.setstate((version, tuple(mt.tolist()) + (pos.value,), gauss_next))
    return out


def select(neighbor_ids: np.ndarray, passage_embedding2id: np.ndarray,
           rows: list[int], positives: list[int], orders: np.ndarray | None,
           negative_sample: int, mrr: float) -> tuple[list[list[int]], float]:
    """Each row's negatives: ``neighbor_ids[rows[r]]`` walked in
    ``orders[r]`` (or its first ``negative_sample + 1`` ids), each id looked
    up in ``passage_embedding2id``, ``positives[r]`` skipped and scored for
    the MRR probe, repeats dropped. Both id arrays are contiguous int64.
    Returns (negatives a row, ``mrr`` plus the rows' probe terms); an id
    walked that lies outside ``passage_embedding2id`` raises
    ``IndexError``, as numpy's lookup does."""
    at = np.array(rows, dtype=np.int64)
    pos = np.array(positives, dtype=np.int64)
    width = neighbor_ids.shape[1]
    walk = len(range(width)[:negative_sample + 1])
    n = max(negative_sample, 0)
    out = np.empty((len(rows), n), np.int64)
    counts = np.empty(len(rows), np.int32)
    total = ctypes.c_double(mrr)
    bad = _native().select_negatives(
        neighbor_ids.ctypes.data, width, at.ctypes.data, len(rows),
        None if orders is None else orders.ctypes.data, walk,
        passage_embedding2id.ctypes.data, len(passage_embedding2id),
        pos.ctypes.data, n, out.ctypes.data, counts.ctypes.data,
        ctypes.addressof(total))
    if bad >= 0:
        r, col = divmod(bad, width)
        raise IndexError(
            f"index {int(neighbor_ids[rows[r], col])} is out of bounds for "
            f"axis 0 with size {len(passage_embedding2id)} (neighbor row "
            f"{rows[r]}, column {col})")
    negs = out.tolist()
    if (counts < n).any():
        negs = [row[:c] for row, c in zip(negs, counts.tolist())]
    return negs, total.value
