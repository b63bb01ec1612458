"""Batched embedding inference over token caches, on one device.

Counterpart of ``ance_tpu/train/encode.py``: iterate a token cache in
fixed-size batches, run the frozen encoder, collect the embeddings on the
host (:func:`encode_cache`) or keep them on the device for the index
(:func:`encode_cache_to_device`). Multi-vector (MaxP) documents flatten
their chunk embeddings to one row each, the document id repeated per
chunk. The mesh waits for a later PR (ROADMAP Queue 1 #11).
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional

import numpy as np
import torch

from ance_tpu_torch.data.cache import TokenCache


def mask_from_lengths(lengths: np.ndarray, max_len: int) -> np.ndarray:
    """[B] lengths → [B, max_len] int32 attention mask (1 on real tokens),
    as ``ance_tpu.data.feed`` builds it."""
    return (np.arange(max_len)[None, :] < lengths[:, None]).astype(np.int32)


def iter_cache_batches(cache: TokenCache, batch_size: int, start: int = 0,
                       stop: Optional[int] = None
                       ) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Yield (offsets [≤B], ids [B, L] int32, mask [B, L] int32); the final
    batch is padded by repeating the last record (the caller drops the
    padded rows), so every batch has one shape."""
    stop = cache.total_number if stop is None else stop
    for s in range(start, stop, batch_size):
        keys = np.arange(s, min(s + batch_size, stop))
        real = len(keys)
        if real < batch_size:
            keys = np.concatenate(
                [keys, np.full(batch_size - real, keys[-1])])
        lengths, tokens = cache.batch(keys)
        mask = mask_from_lengths(lengths, cache.embedding_size)
        yield keys[:real], tokens.astype(np.int32), mask


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


def encode_cache_to_device(encode_fn: Callable, cache: TokenCache,
                           batch_size: int = 128, multichunk: bool = False,
                           start: int = 0, stop: Optional[int] = None
                           ) -> tuple[torch.Tensor, np.ndarray]:
    """Encode records [start, stop) keeping the embeddings on the device.
    Returns (embeddings [M, D], embedding2id [M] int64); with
    ``multichunk`` the encoder gives [B, C, D] and M counts chunks."""
    parts, id_parts = [], []
    for keys, ids, mask in iter_cache_batches(cache, batch_size, start, stop):
        rows, row_ids = _rows(encode_fn(ids, mask), keys, multichunk)
        parts.append(rows)
        id_parts.append(row_ids)
    return torch.cat(parts), np.concatenate(id_parts).astype(np.int64)


def encode_cache(encode_fn: Callable, cache: TokenCache,
                 batch_size: int = 128, multichunk: bool = False,
                 start: int = 0, stop: Optional[int] = None,
                 flush_every: int = 16) -> tuple[np.ndarray, np.ndarray]:
    """Encode records [start, stop) → (embeddings [M, D] fp32 numpy,
    embedding2id [M] int64); ``multichunk`` as in
    :func:`encode_cache_to_device`. Up to ``flush_every`` batches stay in
    flight on the device before they are copied to the host, so host-side
    cache reads overlap device compute."""
    emb_parts, id_parts = [], []
    pending: list[tuple[torch.Tensor, np.ndarray]] = []

    def flush():
        for out, keys in pending:
            rows, row_ids = _rows(out, keys, multichunk)
            emb_parts.append(rows.to(torch.float32).cpu().numpy())
            id_parts.append(row_ids)
        pending.clear()

    for keys, ids, mask in iter_cache_batches(cache, batch_size, start, stop):
        pending.append((encode_fn(ids, mask), keys))
        if len(pending) >= flush_every:
            flush()
    flush()
    return (np.concatenate(emb_parts, axis=0),
            np.concatenate(id_parts, axis=0).astype(np.int64))
