"""Exports into the reference's checkpoint formats (counterpart of the
``rdot_nll*`` and ``dpr`` halves of ``ance_tpu/models/hf_export.py``).

* RobertaDot → an HF ``from_pretrained`` directory: the port's parameters
  already carry the reference ``RobertaDot_NLL_LN`` key names
  (``roberta.*``, ``embeddingHead``, ``norm``), so the export writes its
  state dict as it is, fp32, beside a ``config.json`` that describes it.
* BiEncoder → the reference's single-file DPR ``CheckpointState``, whose
  ``model_dict`` holds the towers' ``BertModel`` keys as the port names
  them, plus each tower's pooler.

The SEED fairseq export comes with its model (ROADMAP Queue 1 #9).
"""

from __future__ import annotations

import json
import os
from typing import Mapping

import numpy as np
import torch


def _host_f32(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", torch.float32).contiguous()


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
    torch.save({k: _host_f32(v) for k, v in state_dict.items()},
               os.path.join(out_dir, "pytorch_model.bin"))
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(roberta_config_json(config), f, indent=2)
    return out_dir


def torch_biencoder_model_dict(state_dict: Mapping[str, torch.Tensor]
                               ) -> dict[str, torch.Tensor]:
    """A BiEncoder state dict → the DPR ``model_dict``: each tower's keys as
    they are, fp32, and its ``pooler.dense.*``. The reference loads a
    CheckpointState strictly into ``BertModel`` towers, which always hold
    a pooler, but discards the pooled output (models.py:252-260), so the
    pooler is inert: N(0, 0.02) weights from ``np.random.default_rng(0)``
    and zero biases, the JAX export's draws, so the two exports are equal
    bit for bit. Raises KeyError for a state dict without both towers."""
    sd: dict[str, torch.Tensor] = {}
    for tower in ("question_model", "ctx_model"):
        word = f"{tower}.embeddings.word_embeddings.weight"
        if word not in state_dict:
            raise KeyError(f"no {word}: not a BiEncoder checkpoint")
        for k, v in state_dict.items():
            if k.startswith(tower + "."):
                sd[k] = _host_f32(v)
        hidden = state_dict[word].shape[1]
        rng = np.random.default_rng(0)
        sd[f"{tower}.pooler.dense.weight"] = torch.from_numpy(
            rng.normal(0.0, 0.02, (hidden, hidden)).astype(np.float32))
        sd[f"{tower}.pooler.dense.bias"] = torch.zeros(hidden)
    return sd


def save_dpr_checkpoint(path: str | os.PathLike,
                        state_dict: Mapping[str, torch.Tensor],
                        offset: int = 0) -> str:
    """Write the reference's single-file DPR ``CheckpointState`` (the
    ``torch.save`` of its fields, run_ann_dpr.py:376-392) with empty
    optimizer and scheduler dicts, which its loader reads only when it
    resumes optimisation, epoch 0 and no encoder parameters; creates ``path``'s directory. Returns
    ``path``."""
    path = str(path)
    model_dict = torch_biencoder_model_dict(state_dict)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({"model_dict": model_dict,
                "optimizer_dict": {}, "scheduler_dict": {},
                "offset": offset, "epoch": 0, "encoder_params": {}}, path)
    return path
