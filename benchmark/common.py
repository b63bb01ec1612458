"""What the drivers share: building the port's model from the benchmark's
weights, the cache probe that times the host feed, the attention range,
sampling, and the comparison arithmetic."""

from __future__ import annotations

import contextlib
import gc
import time

import numpy as np
import torch

from benchmark.weights import derived_seed

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def encoder_config(cfg: dict):
    """The port's ``EncoderConfig`` for a configuration file, for
    inference: no dropout."""
    from ance_tpu_torch.models.transformer import EncoderConfig
    return EncoderConfig(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        intermediate_size=cfg["intermediate_size"],
        max_position_embeddings=cfg["max_position_embeddings"],
        type_vocab_size=cfg["type_vocab_size"],
        pad_token_id=cfg["pad_token_id"],
        layer_norm_eps=cfg["layer_norm_eps"],
        hidden_dropout=0.0, attention_dropout=0.0,
        initializer_range=cfg["initializer_range"],
        dtype=DTYPES[cfg["dtype"]])


def port_model(cfg: dict, weights: dict, device):
    """The port's ``RobertaDot`` on ``device`` holding a copy of
    ``weights`` (built empty, then loaded strictly: every name must
    match), in eval mode."""
    from ance_tpu_torch.models.dot_models import RobertaDot
    with torch.device("meta"):
        model = RobertaDot(encoder_config(cfg),
                           out_dim=cfg["embedding_head"]["out_dim"],
                           base_len=cfg.get("chunk_len", 512))
    model = model.to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    return model.eval()


class CacheProbe:
    """A ``TokenCache`` seen through ``iter_cache_batches``' eyes
    (``total_number``, ``embedding_size``, ``batch``), timing each
    ``batch`` call on the host clock (ms)."""

    def __init__(self, cache):
        self.cache = cache
        self.total_number = cache.total_number
        self.embedding_size = cache.embedding_size
        self.ms: list[float] = []

    def batch(self, keys):
        t = time.perf_counter()
        out = self.cache.batch(keys)
        self.ms.append((time.perf_counter() - t) * 1e3)
        return out


@contextlib.contextmanager
def attention_range():
    """Every call of the attention the encoder layers make
    (``models/transformer.py``'s ``multi_head_attention``) inside a
    ``bench.attention`` profiler range, for the duration."""
    from torch.profiler import record_function
    from ance_tpu_torch.models import transformer
    inner = transformer.multi_head_attention

    def wrapped(*args, **kwargs):
        with record_function("bench.attention"):
            return inner(*args, **kwargs)
    transformer.multi_head_attention = wrapped
    try:
        yield
    finally:
        transformer.multi_head_attention = inner


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def release(device) -> None:
    """Return the freed program state's memory before the reference
    runs."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def sample(seed: int, tag: int, population: int, n: int) -> np.ndarray:
    """``n`` distinct indices of ``range(population)`` (all when fewer),
    sorted, drawn from the seed."""
    rng = np.random.default_rng(derived_seed(seed, 9, tag))
    n = min(n, population)
    return np.sort(rng.choice(population, size=n, replace=False))


def rel_err_rows(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Per row ‖got − want‖ / ‖want‖, in fp64."""
    got, want = got.to(torch.float64).cpu(), want.to(torch.float64).cpu()
    return (got - want).norm(dim=1) / want.norm(dim=1)
