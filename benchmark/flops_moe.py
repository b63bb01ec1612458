"""Operations and bytes of the DeepSeek-V2 dual encoder from shapes and
lengths, counting real tokens only (``flops.py``'s rule: the work the
inputs need; padding the program computes anyway is not counted).

A real token a layer: the MLA's products 2·(H·nh·(nope + rope) + H·(r +
rope) + r·nh·(nope + v) + nh·v·H), with the router's 2·H·E in a MoE
layer; then the FFN: a dense layer's 2·3·H·I, a MoE layer's k routed
SwiGLUs 2·3·H·I_moe each and the shared one 2·3·H·(n_shared·I_moe). The
attention a row of L real tokens a layer: query i sees i + 1 keys, so
Σ_i (i + 1)·nh·((nope + rope) + v)·2 for the scores and the weighted sum.
The head: 2·H·out a row.
"""

from __future__ import annotations

import numpy as np


def _widths(cfg: dict):
    H, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, v = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                     cfg["v_head_dim"])
    return H, nh, nope, rope, v, cfg["kv_lora_rank"]


def mla_product_flops(cfg: dict) -> float:
    """The MLA's projection FLOPs a real token a layer."""
    H, nh, nope, rope, v, r = _widths(cfg)
    return 2.0 * (H * nh * (nope + rope) + H * (r + rope)
                  + r * nh * (nope + v) + nh * v * H)


def expert_flops(cfg: dict) -> float:
    """The routed and shared experts' FLOPs a real token a MoE layer."""
    H, I = cfg["hidden_size"], cfg["moe_intermediate_size"]
    k, S = cfg["num_experts_per_tok"], cfg["n_shared_experts"] * I
    return 2.0 * 3 * H * (k * I + S)


def layer_token_flops(cfg: dict, moe: bool) -> float:
    """A real token's product FLOPs in one layer, the attention apart."""
    H = cfg["hidden_size"]
    if not moe:
        return mla_product_flops(cfg) + 2.0 * 3 * H * cfg["intermediate_size"]
    return mla_product_flops(cfg) + 2.0 * H * cfg["n_routed_experts"] \
        + expert_flops(cfg)


def causal_attention_flops(lengths, cfg: dict) -> float:
    """Scores and weighted sums of one layer over rows of real
    ``lengths``: Σ_rows L(L + 1)/2 · nh · (nope + rope + v) · 2."""
    L = np.asarray(lengths, dtype=np.float64)
    H, nh, nope, rope, v, _ = _widths(cfg)
    return float((L * (L + 1) / 2).sum() * nh * (nope + rope + v) * 2.0)


def encoder_flops(lengths, cfg: dict) -> float:
    """Forward FLOPs of the decoder and the head over rows of real
    ``lengths`` (one pooled row each)."""
    L = np.asarray(lengths, dtype=np.float64)
    layers, dense = cfg["num_hidden_layers"], cfg["first_k_dense_replace"]
    tokens = L.sum()
    per_layer = dense * layer_token_flops(cfg, moe=False) \
        + (layers - dense) * layer_token_flops(cfg, moe=True)
    head = 2.0 * cfg["hidden_size"] * cfg["embedding_head"]["out_dim"]
    return float(tokens * per_layer
                 + layers * causal_attention_flops(L, cfg) + head * len(L))


def experts_work(lengths, batches: int, cfg: dict, elem_bytes: int = 2
                 ) -> tuple[float, float]:
    """(FLOPs, bytes) of the MoE layers' experts over rows of real
    ``lengths`` encoded in ``batches`` calls: k routed SwiGLUs and the
    shared one a real token a layer; each call reads every expert's
    weights once a layer and the real tokens' activations, permuted, in
    and out (k routed rows and one shared row a token, in and out), at
    ``elem_bytes``."""
    tokens = float(np.asarray(lengths, dtype=np.float64).sum())
    H, I = cfg["hidden_size"], cfg["moe_intermediate_size"]
    E, k = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    S = cfg["n_shared_experts"] * I
    moe_layers = cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
    flops = moe_layers * tokens * expert_flops(cfg)
    weights = 3.0 * H * (E * I + S) * elem_bytes
    acts = 2.0 * tokens * (k + 1) * H * elem_bytes
    return float(flops), float(moe_layers * (batches * weights + acts))
