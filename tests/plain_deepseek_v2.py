"""DeepSeek-V2's decoder under ANCE's head, in plain fp32 PyTorch: the
yardstick the port's ``dsv2dot_nll`` is held to on the CPU.

Written from the published ``modeling_deepseek.py`` (DeepSeek-V2-Lite,
arXiv:2405.04434) and nothing of the port: RMSNorm pre-norm layers; MLA
without a q-LoRA (the latent ``c`` normed, one rope key shared by the
heads); YaRN rope tables from their formulas, applied after the published
de-interleave of each pair; the softmax scale ``q_head_dim^−½ ·
mscale(factor, mscale_all_dim)²``; a causal mask over real keys; a dense
SwiGLU in the first ``first_k_dense_replace`` layers, then an fp32 softmax
router with greedy top-k, no renormalisation, and every routed expert
computed for every token (a dense loop, each weighted by its gate
probability where the token chose it, else 0) beside the shared experts;
a final RMSNorm; the hidden state at each row's last real token through
``embeddingHead`` and a LayerNorm.

Weights are HF ``DeepseekV2ForCausalLM``'s names under ``model.``, the
experts one by one (``model.layers.N.mlp.experts.E.gate_proj.weight``).
Every product is fp32 with TF32 off; ``rnd`` (identity by default) is
applied to each operand of every product but the router's, so a test can
compute the same function at a lower precision.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _ident(t):
    return t


def yarn(cfg: dict, S: int):
    """(cos, sin) [S, rope_dim] at positions 0..S−1."""
    rs = cfg["rope_scaling"]
    d, base, s = cfg["qk_rope_head_dim"], cfg["rope_theta"], rs["factor"]

    def corr(beta):
        return d * math.log(rs["original_max_position_embeddings"]
                            / (beta * 2 * math.pi)) / (2 * math.log(base))

    def mscale(m):
        return 0.1 * m * math.log(s) + 1.0 if s > 1 else 1.0
    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), d - 1)
    i = torch.arange(d // 2, dtype=torch.float64)
    f_extra = base ** (-2 * i / d)
    f_inter = f_extra / s
    m = 1 - ((i - low) / max(high - low, 0.001)).clamp(0, 1)
    inv_freq = f_inter * (1 - m) + f_extra * m
    ang = torch.arange(S, dtype=torch.float64)[:, None] * inv_freq[None]
    ang = torch.cat([ang, ang], dim=1)
    k = mscale(rs["mscale"]) / mscale(rs["mscale_all_dim"])
    return (ang.cos() * k).float(), (ang.sin() * k).float()


def encode(sd: dict, cfg: dict, ids: torch.Tensor, mask: torch.Tensor,
           rnd=_ident) -> torch.Tensor:
    """[B, S] ids and {0, 1} mask (real tokens first) → [B, out] fp32."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return _encode(sd, cfg, ids, mask, rnd)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _encode(sd, cfg, ids, mask, rnd):
    def lin(x, name):
        return rnd(x) @ rnd(sd[name]).t()

    def norm(x, name):
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True)
                               + cfg["rms_norm_eps"]) * sd[name]

    def swiglu(x, p):
        return lin(F.silu(lin(x, p + "gate_proj.weight"))
                   * lin(x, p + "up_proj.weight"), p + "down_proj.weight")

    B, S = ids.shape
    nh = cfg["num_attention_heads"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    rank = cfg["kv_lora_rank"]
    rs = cfg["rope_scaling"]
    ms = 0.1 * rs["mscale_all_dim"] * math.log(rs["factor"]) + 1.0
    scale = (dn + dr) ** -0.5 * ms * ms
    cos, sin = yarn(cfg, S)

    def rope(t):  # [B, h, S, dr]
        t = t.reshape(*t.shape[:-1], dr // 2, 2).transpose(-1, -2) \
            .reshape(t.shape)
        rot = torch.cat([-t[..., dr // 2:], t[..., :dr // 2]], dim=-1)
        return t * cos + rot * sin

    allowed = torch.tril(torch.ones(S, S, dtype=torch.bool))[None, None] \
        & mask.bool()[:, None, None, :]
    x = sd["model.embed_tokens.weight"][ids].float()
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        a = p + "self_attn."
        h = norm(x, p + "input_layernorm.weight")
        q = lin(h, a + "q_proj.weight").view(B, S, nh, dn + dr) \
            .transpose(1, 2)
        ckv = lin(h, a + "kv_a_proj_with_mqa.weight")
        kv = lin(norm(ckv[..., :rank], a + "kv_a_layernorm.weight"),
                 a + "kv_b_proj.weight").view(B, S, nh, dn + dv) \
            .transpose(1, 2)
        k_pe = rope(ckv[..., rank:].reshape(B, 1, S, dr)).expand(
            B, nh, S, dr)
        q = torch.cat([q[..., :dn], rope(q[..., dn:])], dim=-1)
        k = torch.cat([kv[..., :dn], k_pe], dim=-1)
        logits = (rnd(q) @ rnd(k).transpose(-1, -2)) * scale
        probs = torch.softmax(logits.masked_fill(~allowed, -math.inf), -1)
        ctx = (rnd(probs) @ rnd(kv[..., dn:])).transpose(1, 2) \
            .reshape(B, S, nh * dv)
        x = x + lin(ctx, a + "o_proj.weight")
        h = norm(x, p + "post_attention_layernorm.weight")
        m = p + "mlp."
        if i < cfg["first_k_dense_replace"]:
            x = x + swiglu(h, m)
            continue
        gate = torch.softmax(h @ sd[m + "gate.weight"].t(), dim=-1)
        top_p, top_e = torch.topk(gate, cfg["num_experts_per_tok"], dim=-1)
        out = swiglu(h, m + "shared_experts.")
        for e in range(cfg["n_routed_experts"]):
            weight = (top_p * (top_e == e)).sum(-1, keepdim=True) \
                * cfg["routed_scaling_factor"]
            out = out + weight * swiglu(h, f"{m}experts.{e}.")
        x = x + out
    last = x[torch.arange(B), mask.sum(1) - 1]
    pooled = norm(last, "model.norm.weight")
    emb = lin(pooled, "embeddingHead.weight") + sd["embeddingHead.bias"]
    return F.layer_norm(emb, (emb.shape[-1],), sd["norm.weight"],
                        sd["norm.bias"], 1e-5)
