"""Weights in and out of the torch port.

* :func:`state_dict_from_flax` maps a (numpy) flax ``RobertaDot`` or
  ``BiEncoder`` parameter tree onto this package's state dict — the
  reference ``RobertaDot_NLL_LN`` / DPR ``model_dict`` key names, flax
  ``[in, out]`` kernels transposed to torch ``[out, in]``.
  It is written here because ``ance_tpu.models`` imports jax on import;
  the tests hold it against ``ance_tpu.models.hf_export``.
* :func:`load_pretrained` loads an HF-layout checkpoint directory (a
  reference ANCE checkpoint, or one ``ance_tpu`` exported) into a model,
  through :func:`load_weights`, which loads a state dict already read.
"""

from __future__ import annotations

import os
from typing import Mapping

import numpy as np
import torch
from torch import nn

# Keys a reference checkpoint carries that the models never read: the
# sequence-classification head and the BERT-style pooler that transformers
# 2.x RobertaModel always built (RobertaDot_NLL_LN), each DPR tower's
# pooler (HFBertEncoder discards pooled_output, models.py:252-260), and the
# position-id buffer newer transformers save. Everything else must match
# exactly.
_TOWERS = ("roberta", "question_model", "ctx_model")
_UNUSED_PREFIXES = ("classifier.",) + tuple(
    f"{t}.{k}" for t in _TOWERS for k in ("pooler.", "embeddings.position_ids"))


def _f32(x) -> np.ndarray:
    """A leaf as an fp32 numpy array: numpy or jax arrays, or the
    ``torch.bfloat16`` tensors :mod:`ance_tpu_torch.train.flax_msgpack`
    reads bf16 leaves into."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).cpu().numpy()
    return np.asarray(x, np.float32)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(_f32(x)))


def _dense(sd: dict, prefix: str, p: Mapping) -> None:
    sd[prefix + ".weight"] = _t(_f32(p["kernel"]).T)
    sd[prefix + ".bias"] = _t(p["bias"])


def _layer_norm(sd: dict, prefix: str, p: Mapping) -> None:
    sd[prefix + ".weight"] = _t(p["scale"])
    sd[prefix + ".bias"] = _t(p["bias"])


def _encoder_state_dict(sd: dict, prefix: str, enc: Mapping) -> None:
    """A flax ``TransformerEncoder`` tree under ``prefix`` (``roberta.``,
    ``question_model.``): HF ``BertModel`` / ``RobertaModel`` key names."""
    emb = enc["embeddings"]
    for name in ("word_embeddings", "position_embeddings",
                 "token_type_embeddings"):
        if name in emb:
            sd[f"{prefix}embeddings.{name}.weight"] = _t(
                emb[name]["embedding"])
    _layer_norm(sd, f"{prefix}embeddings.LayerNorm", emb["layer_norm"])
    i = 0
    while f"layer_{i}" in enc:
        layer, lp = enc[f"layer_{i}"], f"{prefix}encoder.layer.{i}."
        attn = layer["attention"]
        for name in ("query", "key", "value"):
            _dense(sd, lp + f"attention.self.{name}", attn[name])
        _dense(sd, lp + "attention.output.dense", attn["out"])
        _layer_norm(sd, lp + "attention.output.LayerNorm",
                    layer["attention_layer_norm"])
        _dense(sd, lp + "intermediate.dense", layer["mlp"]["intermediate"])
        _dense(sd, lp + "output.dense", layer["mlp"]["output"])
        _layer_norm(sd, lp + "output.LayerNorm", layer["output_layer_norm"])
        i += 1
    if i == 0:
        raise KeyError("no layer_0 in encoder params — wrong tree?")


def state_dict_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """flax params (numpy, jax or torch leaves) → port state dict, fp32:
    a RobertaDot tree (``{"encoder", "embedding_head", "norm"}``) or a
    BiEncoder one (``{"question_model": {"encoder"}, "ctx_model":
    {"encoder"}}``)."""
    sd: dict[str, torch.Tensor] = {}
    if "question_model" in params:
        for tower in ("question_model", "ctx_model"):
            _encoder_state_dict(sd, f"{tower}.", params[tower]["encoder"])
        return sd
    _encoder_state_dict(sd, "roberta.", params["encoder"])
    _dense(sd, "embeddingHead", params["embedding_head"])
    _layer_norm(sd, "norm", params["norm"])
    return sd


def checkpoint_file(model_dir: str) -> str:
    """The directory's single torch checkpoint: ``pytorch_model.bin`` when
    present, else the only ``*.bin``/``*.pt`` besides ``training_args.bin``
    (the file rules of ``ance_tpu/models/hf_loader.py:246-268``)."""
    preferred = os.path.join(model_dir, "pytorch_model.bin")
    if os.path.exists(preferred):
        return preferred
    cands = sorted(f for f in os.listdir(model_dir)
                   if f.endswith((".bin", ".pt")) and f != "training_args.bin")
    if not cands:
        raise FileNotFoundError(f"no torch checkpoint in {model_dir}")
    if len(cands) > 1:
        raise FileNotFoundError(
            f"ambiguous checkpoint dir {model_dir}: {cands}; expected a "
            "single pytorch_model.bin/.pt (sharded checkpoints are not "
            "supported — consolidate first)")
    return os.path.join(model_dir, cands[0])


def load_pretrained(model: nn.Module, model_dir: str) -> str:
    """Strictly load ``model_dir``'s checkpoint into ``model`` (host-side
    ``weights_only`` load; the caller moves the model afterwards).

    A checkpoint without the projection head (plain ``roberta-base``)
    keeps the model's seeded head, as the reference's ``from_pretrained``
    keeps a fresh one. Returns the file loaded."""
    path = checkpoint_file(model_dir)
    load_weights(model, torch.load(path, map_location="cpu",
                                   weights_only=True))
    return path


def load_weights(model: nn.Module, sd: Mapping[str, torch.Tensor]) -> None:
    """Strictly load a state dict in HF key names into ``model``: the keys
    the models never read are dropped, and a RobertaDot state dict without
    the projection head keeps the model's own (see
    :func:`load_pretrained`)."""
    sd = {k: v for k, v in sd.items() if not k.startswith(_UNUSED_PREFIXES)}
    own = model.state_dict()
    if "embeddingHead.weight" in own and "embeddingHead.weight" not in sd:
        for k in ("embeddingHead.weight", "embeddingHead.bias",
                  "norm.weight", "norm.bias"):
            sd[k] = own[k]
    model.load_state_dict(sd, strict=True)
