"""Embedding-shard reader (from ``ance_tpu/evaluation/offline.py``, whose
module imports jax). The offline evaluators port with ROADMAP Queue 1 #2."""

from __future__ import annotations

from typing import Optional

import numpy as np


def load_embedding_shards(prefix: str, max_shards: int = 8
                          ) -> Optional[np.ndarray]:
    """Concatenate the ``<prefix>_data_obj_<rank>.npy`` shards that
    ``ance infer`` writes (the reference's barrier_array_merge layout);
    None when there are none."""
    parts = []
    for rank in range(max_shards):
        try:
            parts.append(np.load(f"{prefix}_data_obj_{rank}.npy",
                                 allow_pickle=False))
        except FileNotFoundError:
            continue
    if not parts:
        return None
    return np.concatenate(parts, axis=0)
