"""Export a RobertaDot checkpoint as an HF ``from_pretrained`` directory
(counterpart of the ``rdot_nll*`` half of ``ance_tpu/models/hf_export.py``).

The port's parameters already carry the reference ``RobertaDot_NLL_LN``
key names (``roberta.*``, ``embeddingHead``, ``norm``), so the export
writes its state dict as it is, fp32, beside a ``config.json`` that
describes it. The DPR ``CheckpointState`` and SEED fairseq exports come
with their models (ROADMAP Queue 1 #8, #9).
"""

from __future__ import annotations

import json
import os
from typing import Mapping

import torch


def roberta_config_json(config) -> dict:
    """Minimal HF RobertaConfig payload for ``config.json``, so the
    directory loads through ``from_pretrained`` without network access."""
    return {
        "model_type": "roberta",
        "architectures": ["RobertaForSequenceClassification"],
        "vocab_size": config.vocab_size,
        "hidden_size": config.hidden_size,
        "num_hidden_layers": config.num_layers,
        "num_attention_heads": config.num_heads,
        "intermediate_size": config.intermediate_size,
        "max_position_embeddings": config.max_position_embeddings,
        "type_vocab_size": config.type_vocab_size,
        "hidden_act": "gelu",
        "layer_norm_eps": config.layer_norm_eps,
        "pad_token_id": config.pad_token_id,
        "hidden_dropout_prob": config.hidden_dropout,
        "attention_probs_dropout_prob": config.attention_dropout,
    }


def save_hf_checkpoint(out_dir: str | os.PathLike,
                       state_dict: Mapping[str, torch.Tensor], config) -> str:
    """Write ``pytorch_model.bin`` (the state dict, fp32 host tensors) and
    ``config.json`` into ``out_dir``. Refuses a state dict whose word
    embeddings or layer count disagree with ``config`` (config.json would
    describe other weights). Returns ``out_dir``."""
    out_dir = str(out_dir)
    emb = tuple(state_dict["roberta.embeddings.word_embeddings.weight"].shape)
    n_layers = len({k.split(".")[3] for k in state_dict
                    if k.startswith("roberta.encoder.layer.")})
    if emb != (config.vocab_size, config.hidden_size) \
            or n_layers != config.num_layers:
        raise ValueError(
            f"checkpoint geometry {emb} x {n_layers} layers does not match "
            f"the config ({config.vocab_size}, {config.hidden_size}) x "
            f"{config.num_layers} — config.json would lie about the weights")
    os.makedirs(out_dir, exist_ok=True)
    torch.save({k: v.detach().to("cpu", torch.float32).contiguous()
                for k, v in state_dict.items()},
               os.path.join(out_dir, "pytorch_model.bin"))
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(roberta_config_json(config), f, indent=2)
    return out_dir
