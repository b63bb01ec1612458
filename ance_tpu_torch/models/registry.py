"""Model registry (counterpart of ``ance_tpu/models/registry.py``).

``rdot_nll`` (FirstP), ``rdot_nll_multi_chunk`` (MaxP: the same
RobertaDot, bodies encoded as 512-token chunks) and ``dpr`` (BiEncoder,
trained with the in-batch loss) are ported; ``seeddot_nll`` names a later
ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from torch import nn

from ance_tpu_torch.models.dot_models import BiEncoder, RobertaDot
from ance_tpu_torch.models.transformer import EncoderConfig, init_weights


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    build: Callable[..., nn.Module]    # (dtype, attention_impl, ...) → module
    tokenizer_name: str
    multichunk: bool = False           # MaxP body encoding
    loss: str = "nll"                  # nll | dpr_inbatch: the train step


def _rdot(dtype=torch.float32, attention_impl="auto", config_overrides=None,
          seed: int = 0) -> RobertaDot:
    """RobertaDot at the given compute dtype, seeded-initialised on the
    host (``torch.Generator``); load weights over it, then move it."""
    cfg = EncoderConfig(dtype=dtype, attention_impl=attention_impl,
                        **(config_overrides or {}))
    model = RobertaDot(cfg, use_mean=False, out_dim=768)
    init_weights(model, cfg, torch.Generator().manual_seed(seed))
    return model.eval()


def _dpr(dtype=torch.float32, attention_impl="auto", config_overrides=None,
         seed: int = 0) -> BiEncoder:
    """BiEncoder of two BERT-base towers, seeded as :func:`_rdot`."""
    cfg = EncoderConfig.bert_base(dtype=dtype, attention_impl=attention_impl,
                                  **(config_overrides or {}))
    model = BiEncoder(cfg)
    init_weights(model, cfg, torch.Generator().manual_seed(seed))
    return model.eval()


REGISTRY: dict[str, ModelSpec] = {
    # reference models.py:300-303
    "rdot_nll": ModelSpec(name="rdot_nll", build=_rdot,
                          tokenizer_name="roberta-base"),
    # reference models.py:304-307 (MaxP, seq 2048 = 4 × 512 chunks); the
    # same parameters as rdot_nll
    "rdot_nll_multi_chunk": ModelSpec(
        name="rdot_nll_multi_chunk", build=_rdot,
        tokenizer_name="roberta-base", multichunk=True),
    # reference models.py:308-313
    "dpr": ModelSpec(name="dpr", build=_dpr,
                     tokenizer_name="bert-base-uncased", loss="dpr_inbatch"),
}

_NOT_YET = {
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
