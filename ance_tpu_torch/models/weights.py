"""Weights in and out of the torch port.

* :func:`state_dict_from_flax` maps a (numpy) flax ``RobertaDot``,
  ``BiEncoder`` or ``SeedForMaskedLM`` parameter tree onto this package's
  state dict — the reference ``RobertaDot_NLL_LN`` / DPR ``model_dict``
  key names, and for SEED's pretraining model the fairseq decoder and LM
  head names (``models/seed.py``), flax ``[in, out]`` kernels transposed
  to torch ``[out, in]``. It is written here because ``ance_tpu.models``
  imports jax on import; the tests hold it against
  ``ance_tpu.models.hf_export``.
* :func:`seeddot_state_dict_from_fairseq` /
  :func:`seed_mlm_state_dict_from_fairseq` import a SEED checkpoint in the
  reference's fairseq names (``ance_tpu/models/hf_loader.py:123-245``);
  :func:`seeddot_warm_start` is what a ``seeddot_nll`` model loads from
  any SEED state dict.
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


SEED_ATTENTION = ("self_attn", "encoder_attn")
SEED_PROJECTIONS = (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                    ("out", "out_proj"))
SEED_LAYER_NORMS = ("self_attn_layer_norm", "encoder_attn_layer_norm",
                    "final_layer_norm")
# the SeedForMaskedLM leaves outside the decoder layers: flax name → port
# prefix (ance_tpu/models/seed.py:331-352)
SEED_MLM_MODULES = (("decoder_embed_norm", "decoder.layernorm_embedding"),
                    ("decoder_final_norm", "decoder.layer_norm"),
                    ("lm_dense", "lm_head.dense"),
                    ("lm_norm", "lm_head.layer_norm"))


def _seed_mlm_state_dict(sd: dict, params: Mapping) -> None:
    """The decoder and LM head of a flax ``SeedForMaskedLM`` tree."""
    i = 0
    while f"decoder_layer_{i}" in params:
        layer, lp = params[f"decoder_layer_{i}"], f"decoder.layers.{i}."
        for attn in SEED_ATTENTION:
            for part, proj in SEED_PROJECTIONS:
                _dense(sd, f"{lp}{attn}.{proj}", layer[f"{attn}_{part}"])
        for name in SEED_LAYER_NORMS:
            _layer_norm(sd, lp + name, layer[name])
        _dense(sd, lp + "fc1", layer["fc1"])
        _dense(sd, lp + "fc2", layer["fc2"])
        i += 1
    if "decoder_pos" in params:  # absent with the sinusoidal table
        sd["decoder.embed_positions.weight"] = _t(
            params["decoder_pos"]["embedding"])
    for flax_name, prefix in SEED_MLM_MODULES:
        (_dense if "dense" in flax_name else _layer_norm)(
            sd, prefix, params[flax_name])
    sd["lm_head.bias"] = _t(params["lm_bias"])


def state_dict_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """flax params (numpy, jax or torch leaves) → port state dict, fp32:
    a RobertaDot tree (``{"encoder", "embedding_head", "norm"}``), a
    BiEncoder one (``{"question_model": {"encoder"}, "ctx_model":
    {"encoder"}}``) or a SeedForMaskedLM one (``{"encoder",
    "decoder_layer_<i>", "decoder_pos", "decoder_embed_norm",
    "decoder_final_norm", "lm_dense", "lm_norm", "lm_bias"}``)."""
    sd: dict[str, torch.Tensor] = {}
    if "question_model" in params:
        for tower in ("question_model", "ctx_model"):
            _encoder_state_dict(sd, f"{tower}.", params[tower]["encoder"])
        return sd
    _encoder_state_dict(sd, "roberta.", params["encoder"])
    if "lm_dense" in params:
        _seed_mlm_state_dict(sd, params)
        return sd
    _dense(sd, "embeddingHead", params["embedding_head"])
    _layer_norm(sd, "norm", params["norm"])
    return sd


def find_seed_prefix(sd: Mapping) -> str:
    """The fairseq sentence-encoder prefix of a SEED state dict:
    ``seed_encoder.encoder.sentence_encoder.`` in HF-saved checkpoints
    (reference modeling_seed_encoder.py:115-135), ``encoder.sentence_
    encoder.`` in raw fairseq ones. KeyError when there is none."""
    marker = "sentence_encoder."
    for k in sd:
        idx = k.find(marker)
        if idx >= 0 and k.endswith("embed_tokens.weight"):
            return k[:idx + len(marker)]
    raise KeyError("no fairseq sentence_encoder found in state dict")


def pad_position_table(table: torch.Tensor, rows: int) -> torch.Tensor:
    """fairseq allocates max_positions + pad + 1 position rows (514); the
    SEED config keeps 516. Rows past the table are never indexed at seq ≤
    max_positions, so zero rows are exact."""
    if table.shape[0] > rows:
        raise ValueError(f"position table {table.shape[0]} rows exceeds the "
                         f"model's {rows}")
    pad = torch.zeros(rows - table.shape[0], table.shape[1],
                      dtype=table.dtype)
    return torch.cat([table, pad])


def _num_layers(sd: Mapping, prefix: str) -> int:
    """One more than the largest layer index under ``prefix``."""
    ids = [k[len(prefix):].split(".", 1)[0] for k in sd
           if k.startswith(prefix)]
    ids = [int(i) for i in ids if i.isdigit()]
    if not ids:
        raise KeyError(f"no layers under {prefix!r} in state dict")
    return max(ids) + 1


# the fairseq encoder layer's modules and the port's (HF) names for them
SEED_ENCODER_LAYER = (("self_attn.q_proj", "attention.self.query"),
                      ("self_attn.k_proj", "attention.self.key"),
                      ("self_attn.v_proj", "attention.self.value"),
                      ("self_attn.out_proj", "attention.output.dense"),
                      ("self_attn_layer_norm", "attention.output.LayerNorm"),
                      ("fc1", "intermediate.dense"),
                      ("fc2", "output.dense"),
                      ("final_layer_norm", "output.LayerNorm"))


def _copy(out: dict, dst: str, sd: Mapping, src: str) -> None:
    for part in ("weight", "bias"):
        out[f"{dst}.{part}"] = _t(sd[f"{src}.{part}"])


def seed_encoder_state_dict_from_fairseq(
        sd: Mapping, max_position_embeddings: int = 516
) -> dict[str, torch.Tensor]:
    """A fairseq TransformerSentenceEncoder (reference
    transformer_sentence_encoder.py:695-925) → the port's ``roberta.*``
    keys: ``embed_tokens`` / ``embed_positions`` (zero-padded to
    ``max_position_embeddings`` rows) / ``emb_layer_norm``, then each
    layer's projections, FFN and post-LN norms
    (``hf_loader.seed_encoder_params_from_torch``)."""
    p = find_seed_prefix(sd)
    out = {"roberta.embeddings.word_embeddings.weight":
           _t(sd[p + "embed_tokens.weight"]),
           "roberta.embeddings.position_embeddings.weight":
           pad_position_table(_t(sd[p + "embed_positions.weight"]),
                              max_position_embeddings)}
    _copy(out, "roberta.embeddings.LayerNorm", sd, p + "emb_layer_norm")
    for i in range(_num_layers(sd, p + "layers.")):
        for src, dst in SEED_ENCODER_LAYER:
            _copy(out, f"roberta.encoder.layer.{i}.{dst}", sd,
                  f"{p}layers.{i}.{src}")
    return out


def seeddot_state_dict_from_fairseq(
        sd: Mapping, max_position_embeddings: int = 516
) -> dict[str, torch.Tensor]:
    """A SEED checkpoint (pretrained SEEDEncoderForMaskedLM, or a
    fine-tuned SEEDEncoderDot_NLL_LN with ``embeddingHead`` / ``norm``) →
    a ``seeddot_nll`` state dict (``hf_loader.seeddot_params_from_torch``);
    without a head the model keeps its own (:func:`load_weights`)."""
    out = seed_encoder_state_dict_from_fairseq(sd, max_position_embeddings)
    if "embeddingHead.weight" in sd:
        _copy(out, "embeddingHead", sd, "embeddingHead")
        _copy(out, "norm", sd, "norm")
    return out


def seed_mlm_state_dict_from_fairseq(
        sd: Mapping, max_position_embeddings: int = 516
) -> dict[str, torch.Tensor]:
    """A pretrained SEED checkpoint → a :class:`SeedForMaskedLM` state
    dict: the encoder as :func:`seed_encoder_state_dict_from_fairseq`, the
    decoder (``decoder.*``) and LM head (``lm_head.*``), whose fairseq
    names the port keeps (``hf_loader.seed_mlm_params_from_torch``)."""
    out = seed_encoder_state_dict_from_fairseq(sd, max_position_embeddings)
    for i in range(_num_layers(sd, "decoder.layers.")):
        lp = f"decoder.layers.{i}."
        names = [f"{attn}.{proj}" for attn in SEED_ATTENTION
                 for _, proj in SEED_PROJECTIONS]
        for name in names + list(SEED_LAYER_NORMS) + ["fc1", "fc2"]:
            _copy(out, lp + name, sd, lp + name)
    out["decoder.embed_positions.weight"] = _t(
        sd["decoder.embed_positions.weight"])
    for _, prefix in SEED_MLM_MODULES:
        _copy(out, prefix, sd, prefix)
    out["lm_head.bias"] = _t(sd["lm_head.bias"])
    return out


def seeddot_warm_start(sd: Mapping, model: nn.Module) -> dict:
    """What a ``seeddot_nll`` model loads from a SEED state dict: fairseq
    names imported (:func:`seeddot_state_dict_from_fairseq`), and a
    pretraining checkpoint's decoder and LM head dropped, so the encoder
    warm-starts and the head keeps its seeded init
    (``ance_tpu/cli.py:212-225``)."""
    if any("sentence_encoder." in k for k in sd):
        sd = seeddot_state_dict_from_fairseq(
            sd, model.config.max_position_embeddings)
    return {k: v for k, v in sd.items()
            if not k.startswith(("decoder.", "lm_head."))}


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
