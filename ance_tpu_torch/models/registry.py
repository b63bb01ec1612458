"""Model registry (counterpart of ``ance_tpu/models/registry.py``).

Only ``rdot_nll`` is ported. The other JAX keys name a later ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ance_tpu_torch.models.dot_models import RobertaDot
from ance_tpu_torch.models.transformer import EncoderConfig, init_weights


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    build: Callable[..., RobertaDot]   # (dtype, attention_impl, ...) → module
    tokenizer_name: str


def _rdot(dtype=torch.float32, attention_impl="auto", config_overrides=None,
          seed: int = 0) -> RobertaDot:
    """RobertaDot at the given compute dtype, seeded-initialised on the
    host (``torch.Generator``); load weights over it, then move it."""
    cfg = EncoderConfig(dtype=dtype, attention_impl=attention_impl,
                        **(config_overrides or {}))
    model = RobertaDot(cfg, use_mean=False, out_dim=768)
    init_weights(model, cfg, torch.Generator().manual_seed(seed))
    return model.eval()


REGISTRY: dict[str, ModelSpec] = {
    "rdot_nll": ModelSpec(name="rdot_nll", build=_rdot,
                          tokenizer_name="roberta-base"),
}

_NOT_YET = {
    "rdot_nll_multi_chunk": "MaxP (ROADMAP Queue 1 #7, with Queue 2 "
                            "kernels #2 and #3)",
    "dpr": "DPR (ROADMAP Queue 1 #8)",
    "seeddot_nll": "SEED (ROADMAP Queue 1 #9)",
}


def get_model_spec(name: str) -> ModelSpec:
    if name in REGISTRY:
        return REGISTRY[name]
    if name in _NOT_YET:
        raise KeyError(f"model type {name!r} is not ported to torch yet: "
                       f"{_NOT_YET[name]}")
    raise KeyError(f"unknown model type {name!r}; available: "
                   f"{sorted(REGISTRY)}")
