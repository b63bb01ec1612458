"""Batched embedding inference over token caches, on one device or
data-parallel over the ranks of a mesh.

Counterpart of ``ance_tpu/train/encode.py``: iterate a token cache in
fixed-size batches, run the frozen encoder, collect the embeddings on the
host (:func:`encode_cache`) or keep them on the device for the index
(:func:`encode_cache_to_device`). Multi-vector (MaxP) documents flatten
their chunk embeddings to one row each, the document id repeated per
chunk. On a mesh every rank walks the same global batches, encodes its
contiguous ``1/world`` block of each and gathers the batch's embeddings
in rank order, so every rank ends with all of them.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from ance_tpu_torch.data.cache import TokenCache
from ance_tpu_torch.utils.observability import span


def synced_clock(device: torch.device) -> Callable[[], float]:
    """perf_counter after the device's queued work has finished."""
    def now() -> float:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()
    return now


def mask_from_lengths(lengths: np.ndarray, max_len: int) -> np.ndarray:
    """[B] lengths → [B, max_len] int32 attention mask (1 on real tokens),
    as ``ance_tpu.data.feed`` builds it."""
    return (np.arange(max_len)[None, :] < lengths[:, None]).astype(np.int32)


def iter_cache_batches(cache: TokenCache, batch_size: int, start: int = 0,
                       stop: Optional[int] = None, host_id: int = 0,
                       num_hosts: int = 1
                       ) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Yield (offsets [≤B], ids, mask int32); the final batch is padded by
    repeating the last record (the caller drops the padded rows), so every
    batch has one shape. With ``num_hosts`` ranks the offsets stay the
    global batch's and ids / mask are rank ``host_id``'s contiguous block
    of it, [B / num_hosts, L].

    Forming a batch (the cache read and the mask) is the span
    ``encode.feed``, closed before the batch is yielded. Two counters, kept
    for the process's life from the host arrays: ``.real_tokens``, the
    lengths of the real records in the rows this rank encodes, capped at
    the width, and ``.token_slots``, every row it encodes (the padding
    rows too) times the width."""
    if batch_size % num_hosts:
        raise ValueError(f"batch_size {batch_size} not divisible by "
                         f"{num_hosts} ranks")
    per_host = batch_size // num_hosts
    width = cache.embedding_size
    stop = cache.total_number if stop is None else stop
    for s in range(start, stop, batch_size):
        with span("encode.feed"):
            keys = np.arange(s, min(s + batch_size, stop))
            real = len(keys)
            if real < batch_size:
                keys = np.concatenate(
                    [keys, np.full(batch_size - real, keys[-1])])
            lo = host_id * per_host
            lengths, tokens = cache.batch(keys[lo:lo + per_host])
            ids = tokens.astype(np.int32)
            mask = mask_from_lengths(lengths, width)
            real_tokens = int(np.minimum(lengths[:max(0, real - lo)],
                                         width).sum())
            with _COUNT_LOCK:
                iter_cache_batches.real_tokens += real_tokens
                iter_cache_batches.token_slots += per_host * width
        yield keys[:real], ids, mask


iter_cache_batches.real_tokens = 0
iter_cache_batches.token_slots = 0
_COUNT_LOCK = threading.Lock()


def make_encode_fn(model: torch.nn.Module, method: Callable,
                   device: torch.device) -> Callable:
    """(ids, mask) → embeddings [B, D] fp32 on ``device``; ``method`` is an
    unbound model method (``RobertaDot.query_emb`` / ``body_emb``). Token
    arrays may be numpy or tensors; inference runs without autograd."""
    device = torch.device(device)

    def encode(ids, mask) -> torch.Tensor:
        ids = torch.as_tensor(ids).to(device, torch.int64)
        mask = torch.as_tensor(mask).to(device, torch.int64)
        with torch.inference_mode():
            return method(model, ids, mask)
    return encode


def _rows(out: torch.Tensor, keys: np.ndarray, multichunk: bool
          ) -> tuple[torch.Tensor, np.ndarray]:
    """One batch's real rows: [B, D] as they are, or MaxP [B, C, D]
    flattened to [B·C, D] with each id repeated C times."""
    out = out[:len(keys)]
    if not multichunk:
        return out, keys
    C = out.shape[1]
    return out.reshape(len(keys) * C, -1), np.repeat(keys, C)


def _batches(encode_fn: Callable, cache: TokenCache, batch_size: int,
             start: int, stop: Optional[int], mesh
             ) -> Iterator[tuple[torch.Tensor, np.ndarray]]:
    """(embeddings of one global batch, its offsets): this rank's block
    encoded and, on a mesh, every rank's gathered in rank order."""
    host_id, num_hosts = (mesh.rank, mesh.world) if mesh else (0, 1)
    for keys, ids, mask in iter_cache_batches(cache, batch_size, start, stop,
                                              host_id, num_hosts):
        out = encode_fn(ids, mask)
        yield (mesh.gather_rows(out) if mesh else out), keys


def encode_cache_to_device(encode_fn: Callable, cache: TokenCache,
                           batch_size: int = 128, multichunk: bool = False,
                           start: int = 0, stop: Optional[int] = None,
                           mesh=None) -> tuple[torch.Tensor, np.ndarray]:
    """Encode records [start, stop) keeping the embeddings on the device.
    Returns (embeddings [M, D], embedding2id [M] int64); with
    ``multichunk`` the encoder gives [B, C, D] and M counts chunks. On a
    ``mesh`` ``batch_size`` is the global batch (module docstring)."""
    parts, id_parts = [], []
    for out, keys in _batches(encode_fn, cache, batch_size, start, stop,
                              mesh):
        rows, row_ids = _rows(out, keys, multichunk)
        parts.append(rows)
        id_parts.append(row_ids)
    return torch.cat(parts), np.concatenate(id_parts).astype(np.int64)


def encode_cache(encode_fn: Callable, cache: TokenCache,
                 batch_size: int = 128, multichunk: bool = False,
                 start: int = 0, stop: Optional[int] = None,
                 flush_every: int = 16, mesh=None
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Encode records [start, stop) → (embeddings [M, D] fp32 numpy,
    embedding2id [M] int64); ``multichunk`` as in
    :func:`encode_cache_to_device`. Up to ``flush_every`` batches stay in
    flight on the device before they are copied to the host, so host-side
    cache reads overlap device compute. ``mesh`` as in
    :func:`encode_cache_to_device`."""
    emb_parts, id_parts = [], []
    pending: list[tuple[torch.Tensor, np.ndarray]] = []

    def flush():
        for out, keys in pending:
            rows, row_ids = _rows(out, keys, multichunk)
            emb_parts.append(rows.to(torch.float32).cpu().numpy())
            id_parts.append(row_ids)
        pending.clear()

    for out, keys in _batches(encode_fn, cache, batch_size, start, stop,
                              mesh):
        pending.append((out, keys))
        if len(pending) >= flush_every:
            flush()
    flush()
    return (np.concatenate(emb_parts, axis=0),
            np.concatenate(id_parts, axis=0).astype(np.int64))
