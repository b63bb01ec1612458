"""Seeded weights of the DeepSeek-V2 dual encoder (``dsv2dot_nll``), made
on the device a leaf at a time.

Both the port and the plain reference (``reference/deepseek_v2.py``) get
their weights from here, from ``(seed, config)``: the port's key names
(HF ``DeepseekV2ForCausalLM``'s under ``model.``, the routed experts
stacked [E, out, in]; ``embeddingHead``, ``norm``), fp32. Each leaf is
drawn by its own ``torch.Generator`` seeded from ``(seed, its place in
:func:`leaf_shapes`)``, so one layer's leaves can be made again alone (the
reference walks the model a layer at a time): matrices, tables, routers,
expert stacks and the head's biases N(0, std), norm gains 1 + N(0, std),
``std`` being the configuration's ``benchmark_weights.std``.
"""

from __future__ import annotations

import torch

from benchmark.weights import derived_seed


def layer_shapes(cfg: dict, i: int) -> list[tuple[str, tuple[int, ...]]]:
    """(name, shape) of layer ``i``'s parameters, in a fixed order."""
    H, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, vd = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                      cfg["v_head_dim"])
    r = cfg["kv_lora_rank"]
    p = f"model.layers.{i}."
    a = p + "self_attn."
    leaves = [(a + "q_proj.weight", (nh * (nope + rope), H)),
              (a + "kv_a_proj_with_mqa.weight", (r + rope, H)),
              (a + "kv_a_layernorm.weight", (r,)),
              (a + "kv_b_proj.weight", (nh * (nope + vd), r)),
              (a + "o_proj.weight", (H, nh * vd))]
    m = p + "mlp."
    if i < cfg["first_k_dense_replace"]:
        I = cfg["intermediate_size"]
        leaves += [(m + "gate_proj.weight", (I, H)),
                   (m + "up_proj.weight", (I, H)),
                   (m + "down_proj.weight", (H, I))]
    else:
        E, I = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
        S = cfg["n_shared_experts"] * I
        leaves += [(m + "gate.weight", (E, H)),
                   (m + "experts.gate_proj", (E, I, H)),
                   (m + "experts.up_proj", (E, I, H)),
                   (m + "experts.down_proj", (E, H, I)),
                   (m + "shared_experts.gate_proj.weight", (S, H)),
                   (m + "shared_experts.up_proj.weight", (S, H)),
                   (m + "shared_experts.down_proj.weight", (H, S))]
    leaves += [(p + "input_layernorm.weight", (H,)),
               (p + "post_attention_layernorm.weight", (H,))]
    return leaves


def leaf_shapes(cfg: dict) -> list[tuple[str, tuple[int, ...]]]:
    """(name, shape) of every parameter, in a fixed order."""
    H, out_dim = cfg["hidden_size"], cfg["embedding_head"]["out_dim"]
    leaves = [("model.embed_tokens.weight", (cfg["vocab_size"], H))]
    for i in range(cfg["num_hidden_layers"]):
        leaves += layer_shapes(cfg, i)
    leaves += [("model.norm.weight", (H,)),
               ("embeddingHead.weight", (out_dim, H)),
               ("embeddingHead.bias", (out_dim,)),
               ("norm.weight", (out_dim,)), ("norm.bias", (out_dim,))]
    return leaves


def is_gain(name: str) -> bool:
    return name.endswith(("norm.weight", "layernorm.weight"))


def make_leaf(cfg: dict, seed: int, place: int, name: str, shape,
              device) -> torch.Tensor:
    """Leaf number ``place`` of :func:`leaf_shapes`, fp32 on ``device``."""
    g = torch.Generator(device=device).manual_seed(
        derived_seed(seed, 1, place))
    t = torch.randn(shape, generator=g, device=device)
    t.mul_(cfg["benchmark_weights"]["std"])
    if is_gain(name):
        t.add_(1.0)
    return t


def make_weights(cfg: dict, seed: int, device, prefix: str = ""
                 ) -> dict[str, torch.Tensor]:
    """The state dict for ``(cfg, seed)`` on ``device``; with ``prefix``
    only the leaves whose names start with it (``model.layers.3.``)."""
    return {name: make_leaf(cfg, seed, place, name, shape, device)
            for place, (name, shape) in enumerate(leaf_shapes(cfg))
            if name.startswith(prefix)}


def param_count(cfg: dict) -> int:
    n = 0
    for _, shape in leaf_shapes(cfg):
        k = 1
        for s in shape:
            k *= s
        n += k
    return n
