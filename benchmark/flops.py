"""Operations and bytes from shapes and lengths, the chip's peaks, and the
roofline and utilization shares built on them.

Every count is of the work that the inputs need: real tokens attending
over real keys, real corpus rows. Padding the program computes anyway is
not counted, so no implementation reads above 100% without leaving work
out. The encoder's count is the one ``bench.py``'s docstring gives for the
JAX package: 24·H² FLOPs per token per layer in the matrix products (with
the FFN at 4·H), written here for any FFN width, and the attention scores
apart.
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet, dense: bf16 tensor-core FLOP/s and HBM3
# bytes/s, at the 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def encoder_flops(lengths, cfg: dict, head_rows: int | None = None) -> float:
    """Forward FLOPs of the encoder and the embedding head over sequences
    of real ``lengths``: per layer 2·(4·H² + 2·H·I) a token in the
    products and 4·L·H a token for the scores and the weighted sum over L
    real keys; 2·H·out a pooled row in the head (one row a sequence unless
    ``head_rows`` says otherwise)."""
    L = np.asarray(lengths, dtype=np.float64)
    H, I = cfg["hidden_size"], cfg["intermediate_size"]
    layers = cfg["num_hidden_layers"]
    out_dim = cfg["embedding_head"]["out_dim"]
    per_layer = 2.0 * (4 * H * H + 2 * H * I) * L.sum() + 4.0 * H * (L * L).sum()
    rows = len(L) if head_rows is None else head_rows
    return float(layers * per_layer + 2.0 * H * out_dim * rows)


def chunk_lengths(lengths, chunk: int, chunks: int) -> np.ndarray:
    """MaxP: the real length of each chunk of each document,
    [n·chunks], a document's chunks in order."""
    L = np.asarray(lengths, dtype=np.int64)[:, None]
    starts = np.arange(chunks, dtype=np.int64)[None, :] * chunk
    return np.clip(L - starts, 0, chunk).reshape(-1)


def attention_work(lengths, cfg: dict, elem_bytes: int = 2
                   ) -> tuple[float, float]:
    """(FLOPs, bytes) of the attention of every layer over sequences of
    real ``lengths``: 4·L²·H FLOPs a sequence a layer; q, k, v read and the
    context written once, for the real tokens, at ``elem_bytes``."""
    L = np.asarray(lengths, dtype=np.float64)
    H, layers = cfg["hidden_size"], cfg["num_hidden_layers"]
    flops = layers * 4.0 * H * (L * L).sum()
    nbytes = layers * 4.0 * H * elem_bytes * L.sum()
    return float(flops), float(nbytes)


def search_work(n_queries: int, n_rows: int, dim: int, k: int,
                row_bytes: int = 4) -> tuple[float, float]:
    """(operations, bytes) of an exact top-k inner-product search:
    2·Q·N·D; the corpus read once, the fp32 queries read, and the [Q, k]
    fp32 scores and int64 ids written."""
    ops = 2.0 * n_queries * n_rows * dim
    nbytes = n_rows * dim * row_bytes + n_queries * dim * 4 \
        + n_queries * k * (4 + 8)
    return float(ops), float(nbytes)


def bound_seconds(ops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of operations over
    the bf16 peak and bytes over the HBM bandwidth."""
    return max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def roofline_pct(ops: float, nbytes: float, seconds: float) -> float | None:
    """The bound's share of the measured ``seconds``, in %; None when
    nothing was measured."""
    if seconds <= 0 or (ops <= 0 and nbytes <= 0):
        return None
    return 100.0 * bound_seconds(ops, nbytes) / seconds


def mfu_pct(flops: float, seconds: float) -> float | None:
    """Model FLOPs over ``seconds`` at the bf16 peak, in %."""
    if seconds <= 0 or flops <= 0:
        return None
    return 100.0 * flops / (seconds * PEAK_BF16_FLOPS)
