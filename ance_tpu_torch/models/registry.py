"""Model registry (counterpart of ``ance_tpu/models/registry.py``).

``rdot_nll`` (FirstP), ``rdot_nll_multi_chunk`` (MaxP: the same
RobertaDot, bodies encoded as 512-token chunks), ``dpr`` (BiEncoder,
trained with the in-batch loss) and ``seeddot_nll`` (RobertaDot over the
SEED encoder, CLS pooling, the ``seed-wordpiece`` tokenizer): every entry
of the JAX registry. Beyond it, ``dsv2dot_nll``: DeepseekV2Dot, ANCE's head
over DeepSeek-V2-Lite's MoE + MLA decoder pooled at the last real token,
for encoding, search and mining; it does not train (``trainable``).

``seeddot_nll`` keeps ``seed_encoder_config``'s pad id 1, as the JAX
registry does, while a ``vocab.txt`` that starts with ``[PAD]`` pads with
id 0 (ROADMAP Queue 3).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import torch

from torch import nn

from ance_tpu_torch.models import deepseek_v2
from ance_tpu_torch.models.dot_models import (BiEncoder, DeepseekV2Dot,
                                              RobertaDot)
from ance_tpu_torch.models.hf_export import (save_dpr_checkpoint,
                                             save_hf_checkpoint,
                                             save_seed_checkpoint)
from ance_tpu_torch.models.seed import seed_dot_model
from ance_tpu_torch.models.transformer import EncoderConfig, init_weights
from ance_tpu_torch.models.weights import seeddot_warm_start


def _export_hf(out_dir, state_dict, step, config_overrides) -> str:
    """An HF ``from_pretrained`` directory (RobertaDot)."""
    return save_hf_checkpoint(out_dir, state_dict,
                              EncoderConfig(**config_overrides))


def _export_dpr(out_dir, state_dict, step, config_overrides) -> str:
    """The DPR ``CheckpointState`` file ``<out_dir>/checkpoint-<step>``,
    whose ``offset`` is the step."""
    return save_dpr_checkpoint(os.path.join(out_dir, f"checkpoint-{step}"),
                               state_dict, offset=step)


def _export_seed(out_dir, state_dict, step, config_overrides) -> str:
    """``<out_dir>/pytorch_model.bin`` in fairseq names: a ``seeddot_nll``
    or a ``seed-pretrain`` checkpoint."""
    return save_seed_checkpoint(out_dir, state_dict)


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    build: Callable[..., nn.Module]    # (dtype, attention_impl, ...) → module
    tokenizer_name: str
    multichunk: bool = False           # MaxP body encoding
    loss: str = "nll"                  # nll | dpr_inbatch: the train step
    # (state dict, model) → the state dict the model loads strictly from a
    # checkpoint of its family in another layout; None: as it is
    adapt_weights: Optional[Callable[[dict, nn.Module], dict]] = None
    # (out_dir, state dict, step, encoder overrides) → the path that
    # export-hf wrote, in the reference's checkpoint format for the family
    export: Callable[[str, dict, int, dict], str] = _export_hf
    # False: encode, search and mine only (train, warmup and ance-loop
    # refuse the model type)
    trainable: bool = True


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


def _seeddot(dtype=torch.float32, attention_impl="auto",
             config_overrides=None, seed: int = 0) -> RobertaDot:
    """``seeddot_nll``: RobertaDot over ``seed_encoder_config`` (vocabulary
    32,769 unless the overrides say otherwise), seeded as :func:`_rdot`."""
    model = seed_dot_model(config_overrides=config_overrides, dtype=dtype,
                           attention_impl=attention_impl)
    init_weights(model, model.config, torch.Generator().manual_seed(seed))
    return model.eval()


def _dsv2dot(dtype=torch.float32, attention_impl="auto",
            config_overrides=None, seed: int = 0) -> DeepseekV2Dot:
    """``dsv2dot_nll``: DeepseekV2Dot at DeepSeek-V2-Lite's published
    widths unless the overrides (``DeepseekV2Config`` fields) say
    otherwise, seeded on the host as :func:`_rdot`."""
    cfg = deepseek_v2.DeepseekV2Config(dtype=dtype,
                                       attention_impl=attention_impl,
                                       **(config_overrides or {}))
    model = DeepseekV2Dot(cfg, out_dim=768)
    deepseek_v2.init_weights(model, cfg, torch.Generator().manual_seed(seed))
    return model.eval()


def _dsv2_weights(sd: dict, model: nn.Module) -> dict:
    """HF ``DeepseekV2ForCausalLM`` keys onto ``dsv2dot_nll``'s: the
    per-expert matrices stacked, the LM head dropped."""
    sd = {k: v for k, v in sd.items() if not k.startswith("lm_head.")}
    return deepseek_v2.stack_experts(sd)


def _no_export(out_dir, state_dict, step, config_overrides) -> str:
    raise SystemExit("export-hf: dsv2dot_nll has no reference checkpoint "
                     "format to export to")


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
                     tokenizer_name="bert-base-uncased", loss="dpr_inbatch",
                     export=_export_dpr),
    # reference models.py:314-319
    # (a fairseq SEED checkpoint imported; a seed-pretrain one's encoder)
    "seeddot_nll": ModelSpec(name="seeddot_nll", build=_seeddot,
                             tokenizer_name="seed-wordpiece",
                             adapt_weights=seeddot_warm_start,
                             export=_export_seed),
    # DeepSeek-V2-Lite (arXiv:2405.04434) under ANCE's head; inference
    # only, its tokenizer's files not in the repository
    "dsv2dot_nll": ModelSpec(name="dsv2dot_nll", build=_dsv2dot,
                             tokenizer_name="deepseek-ai/DeepSeek-V2-Lite",
                             adapt_weights=_dsv2_weights, export=_no_export,
                             trainable=False),
}


def get_model_spec(name: str) -> ModelSpec:
    if name in REGISTRY:
        return REGISTRY[name]
    raise KeyError(f"unknown model type {name!r}; available: "
                   f"{sorted(REGISTRY)}")
