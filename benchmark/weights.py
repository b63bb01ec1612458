"""Seeded RoBERTa-dot weights, made on the device in one call.

Both the port and the plain reference get the state dict this module makes
from ``(seed, config)``: HF ``RobertaDot_NLL_LN`` key names (``roberta.*``,
``embeddingHead``, ``norm``), fp32. One ``torch.randn`` over every entry,
drawn by a ``torch.Generator`` on the device, is cut into the leaves:
matrices, embedding tables and biases scaled by the configuration's
``benchmark_weights.std``, LayerNorm weights ``1 + std * n``. Random
biases and LayerNorm gains make the comparison see a bias or a gain that
is dropped.
"""

from __future__ import annotations

import numpy as np
import torch


def derived_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for ``torch.Generator`` from the run's seed (any
    non-negative integer) and integer tags, through numpy's SeedSequence."""
    words = np.random.SeedSequence([int(seed), *map(int, tags)]) \
        .generate_state(2, dtype=np.uint32)
    return int((int(words[0]) << 31) ^ int(words[1]))


def leaf_shapes(cfg: dict) -> list[tuple[str, tuple[int, ...]]]:
    """(name, shape) of every parameter, in a fixed order."""
    H, I = cfg["hidden_size"], cfg["intermediate_size"]
    out_dim = cfg["embedding_head"]["out_dim"]
    e = "roberta.embeddings."
    leaves = [(e + "word_embeddings.weight", (cfg["vocab_size"], H)),
              (e + "position_embeddings.weight",
               (cfg["max_position_embeddings"], H)),
              (e + "token_type_embeddings.weight",
               (cfg["type_vocab_size"], H)),
              (e + "LayerNorm.weight", (H,)), (e + "LayerNorm.bias", (H,))]
    for i in range(cfg["num_hidden_layers"]):
        p = f"roberta.encoder.layer.{i}."
        for lin in ("attention.self.query", "attention.self.key",
                    "attention.self.value", "attention.output.dense"):
            leaves += [(p + lin + ".weight", (H, H)), (p + lin + ".bias", (H,))]
        leaves += [(p + "attention.output.LayerNorm.weight", (H,)),
                   (p + "attention.output.LayerNorm.bias", (H,)),
                   (p + "intermediate.dense.weight", (I, H)),
                   (p + "intermediate.dense.bias", (I,)),
                   (p + "output.dense.weight", (H, I)),
                   (p + "output.dense.bias", (H,)),
                   (p + "output.LayerNorm.weight", (H,)),
                   (p + "output.LayerNorm.bias", (H,))]
    leaves += [("embeddingHead.weight", (out_dim, H)),
               ("embeddingHead.bias", (out_dim,)),
               ("norm.weight", (out_dim,)), ("norm.bias", (out_dim,))]
    return leaves


def make_weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The state dict for ``(cfg, seed)`` on ``device``: views into one
    fp32 buffer drawn in a single call."""
    leaves = leaf_shapes(cfg)
    total = sum(int(np.prod(s)) for _, s in leaves)
    g = torch.Generator(device=device).manual_seed(derived_seed(seed, 1))
    flat = torch.randn(total, generator=g, device=device)
    flat.mul_(cfg["benchmark_weights"]["std"])
    out, at = {}, 0
    for name, shape in leaves:
        n = int(np.prod(shape))
        t = flat[at:at + n].view(shape)
        if "LayerNorm.weight" in name or name == "norm.weight":
            t.add_(1.0)
        out[name] = t
        at += n
    return out
