"""Exports into the reference's checkpoint formats (counterpart of the
``rdot_nll*`` and ``dpr`` halves of ``ance_tpu/models/hf_export.py``).

* RobertaDot → an HF ``from_pretrained`` directory: the port's parameters
  already carry the reference ``RobertaDot_NLL_LN`` key names
  (``roberta.*``, ``embeddingHead``, ``norm``), so the export writes its
  state dict as it is, fp32, beside a ``config.json`` that describes it.
* BiEncoder → the reference's single-file DPR ``CheckpointState``, whose
  ``model_dict`` holds the towers' ``BertModel`` keys as the port names
  them, plus each tower's pooler.

* SEED (``seeddot_nll`` and ``seed-pretrain``'s SeedForMaskedLM) → the
  reference's fairseq names: the encoder under
  ``seed_encoder.encoder.sentence_encoder.``, the position table cut back
  to fairseq's 514 rows, ``embeddingHead`` / ``norm``, or the decoder
  (``decoder.*``) and LM head (``lm_head.*``), whose names the port keeps
  (``torch_seed*_state_dict``, the inverse of ``models/weights.py``'s
  import).
"""

from __future__ import annotations

import json
import os
from typing import Mapping

import numpy as np
import torch

from ance_tpu_torch.models.weights import (SEED_ATTENTION,
                                           SEED_ENCODER_LAYER,
                                           SEED_LAYER_NORMS, SEED_MLM_MODULES,
                                           SEED_PROJECTIONS)


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


SEED_PREFIX = "seed_encoder.encoder.sentence_encoder."
# fairseq allocates max_positions + pad + 1 position rows
FAIRSEQ_POSITION_ROWS = 514


def torch_seed_encoder_state_dict(state_dict: Mapping[str, torch.Tensor]
                                  ) -> dict[str, torch.Tensor]:
    """The port's SEED encoder (``roberta.*``) → fairseq
    TransformerSentenceEncoder keys under :data:`SEED_PREFIX` (the
    HF-saved SEED layout, modeling_seed_encoder.py:115-135), fp32; the
    inverse of
    ``models/weights.py::seed_encoder_state_dict_from_fairseq``
    (``ance_tpu/models/hf_export.py:95-173``).

    fairseq allocates :data:`FAIRSEQ_POSITION_ROWS` (514) position rows;
    the SEED config keeps 516, which the import zero-pads, so the export
    cuts the table back to 514 (rows ≥ 514 are never indexed at seq ≤
    512). More than 2 rows past it look trained, not headroom, and raise
    ValueError."""
    sd = {k[len("roberta."):]: v for k, v in state_dict.items()
          if k.startswith("roberta.")}
    if "embeddings.word_embeddings.weight" not in sd:
        raise KeyError("no roberta.embeddings.word_embeddings.weight: not a "
                       "SEED checkpoint")
    p = SEED_PREFIX
    out = {p + "embed_tokens.weight":
           _host_f32(sd["embeddings.word_embeddings.weight"])}
    pos = _host_f32(sd["embeddings.position_embeddings.weight"])
    if pos.shape[0] > FAIRSEQ_POSITION_ROWS + 2:
        raise ValueError(
            f"position table has {pos.shape[0]} rows — more than the "
            f"import headroom over fairseq's {FAIRSEQ_POSITION_ROWS}; rows "
            "past them look trained, not padding")
    pos = pos[:FAIRSEQ_POSITION_ROWS].contiguous()
    out[p + "embed_positions.weight"] = pos
    for part in ("weight", "bias"):
        out[f"{p}emb_layer_norm.{part}"] = _host_f32(
            sd[f"embeddings.LayerNorm.{part}"])
    i = 0
    while f"encoder.layer.{i}.attention.self.query.weight" in sd:
        for src, dst in SEED_ENCODER_LAYER:
            for part in ("weight", "bias"):
                out[f"{p}layers.{i}.{src}.{part}"] = _host_f32(
                    sd[f"encoder.layer.{i}.{dst}.{part}"])
        i += 1
    if i == 0:
        raise KeyError("no roberta.encoder.layer.0: not a SEED checkpoint")
    return out


def _copy_f32(out: dict, state_dict: Mapping, prefix: str) -> None:
    for part in ("weight", "bias"):
        out[f"{prefix}.{part}"] = _host_f32(state_dict[f"{prefix}.{part}"])


def torch_seeddot_state_dict(state_dict: Mapping[str, torch.Tensor]
                             ) -> dict[str, torch.Tensor]:
    """A ``seeddot_nll`` state dict → the reference SEEDEncoderDot_NLL_LN
    state dict: the fairseq encoder and ``embeddingHead`` / ``norm``
    (reference models.py:201-221)."""
    out = torch_seed_encoder_state_dict(state_dict)
    if "embeddingHead.weight" in state_dict:
        _copy_f32(out, state_dict, "embeddingHead")
        _copy_f32(out, state_dict, "norm")
    return out


def torch_seed_mlm_state_dict(state_dict: Mapping[str, torch.Tensor]
                              ) -> dict[str, torch.Tensor]:
    """A SeedForMaskedLM state dict (``seed-pretrain``'s) → an HF-saved SEED
    checkpoint: the fairseq encoder, the decoder under ``decoder.`` and
    the LM head at ``lm_head.*`` (reference modeling_seed_encoder.py:
    136-183), so a model pretrained here can go on in the reference's
    stack."""
    out = torch_seed_encoder_state_dict(state_dict)
    i = 0
    while f"decoder.layers.{i}.fc1.weight" in state_dict:
        lp = f"decoder.layers.{i}."
        for attn in SEED_ATTENTION:
            for _, proj in SEED_PROJECTIONS:
                _copy_f32(out, state_dict, f"{lp}{attn}.{proj}")
        for name in (*SEED_LAYER_NORMS, "fc1", "fc2"):
            _copy_f32(out, state_dict, lp + name)
        i += 1
    out["decoder.embed_positions.weight"] = _host_f32(
        state_dict["decoder.embed_positions.weight"])
    for _, prefix in SEED_MLM_MODULES:
        _copy_f32(out, state_dict, prefix)
    out["lm_head.bias"] = _host_f32(state_dict["lm_head.bias"])
    return out


def save_seed_checkpoint(out_dir: str,
                         state_dict: Mapping[str, torch.Tensor]) -> str:
    """``<out_dir>/pytorch_model.bin`` in the reference's fairseq names: a
    ``seed-pretrain`` state dict (it holds ``lm_head.bias``) with its
    decoder and LM head, else a ``seeddot_nll`` one. Returns the path."""
    to_fairseq = torch_seed_mlm_state_dict if "lm_head.bias" in state_dict \
        else torch_seeddot_state_dict
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "pytorch_model.bin")
    torch.save(to_fairseq(state_dict), path)
    return path
