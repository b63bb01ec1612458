"""The DeepSeek-V2 dual encoder's forward in plain PyTorch.

The published decoder (``modeling_deepseek.py`` of
``deepseek-ai/DeepSeek-V2-Lite``, arXiv:2405.04434) written out: RMSNorm
pre-norm layers; MLA without a q-LoRA, the rope parts rotated by YaRN rope
after the published de-interleave, the softmax scale ``q_head_dim^−½ ·
mscale²``, a causal mask over real keys and an fp32 softmax; the first
``first_k_dense_replace`` layers a dense SwiGLU, the rest an fp32 softmax
router, greedy top-k without renormalisation, a Python loop over the
routed experts (each computing the tokens that chose it) and the shared
SwiGLU; a final RMSNorm. Then the system's head: the hidden state at each
row's last real token through ``embeddingHead`` and ``norm``. Every
position is routed, as the published code routes them; pad positions come
after a row's real ones, so under the causal mask they change no real
position.

``precision`` sets every matrix product but the router's (fp32, as
published): ``"fp32"`` (TF32 off) or ``"fp8"`` (the control one step below
the configuration's bf16: each operand rounded to float8 e4m3 under a
per-tensor scale, fp32 sums). The weights come from ``weights_dsv2.py`` a
layer at a time, so the reference never holds more than one layer's.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.encoder import fp8_round, matmul_precision
from benchmark.weights_dsv2 import layer_shapes, leaf_shapes, make_leaf


def _mm(a, b, precision):
    if precision == "fp8":
        return torch.matmul(fp8_round(a), fp8_round(b))
    return torch.matmul(a, b)


def lin(x, w, precision):
    return _mm(x, w.t(), precision)


def rms_norm(x, g, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * g


def yarn_cos_sin(cfg: dict, S: int, device):
    """(cos, sin) [S, d] of the published ``DeepseekV2YarnRotaryEmbedding``
    at positions 0..S−1."""
    rs = cfg["rope_scaling"]
    d, base, factor = cfg["qk_rope_head_dim"], cfg["rope_theta"], rs["factor"]
    L = rs["original_max_position_embeddings"]

    def corr(rot):
        return d * math.log(L / (rot * 2 * math.pi)) / (2 * math.log(base))

    def mscale(s, m):
        return 1.0 if s <= 1 else 0.1 * m * math.log(s) + 1.0
    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), d - 1)
    extra = 1.0 / base ** (torch.arange(0, d, 2, dtype=torch.float32) / d)
    inter = 1.0 / (factor * base ** (torch.arange(0, d, 2,
                                                  dtype=torch.float32) / d))
    ramp = ((torch.arange(d // 2, dtype=torch.float32) - low)
            / (high - low if high != low else 0.001)).clamp(0, 1)
    keep = 1.0 - ramp
    inv_freq = inter * (1 - keep) + extra * keep
    freqs = torch.outer(torch.arange(S, dtype=torch.float32), inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    m = mscale(factor, rs["mscale"]) / mscale(factor, rs["mscale_all_dim"])
    return (emb.cos() * m).to(device), (emb.sin() * m).to(device)


def rope(x, cos, sin):
    """x [B, h, S, d]: pairs de-interleaved, then rotated."""
    B, h, S, d = x.shape
    x = x.view(B, h, S, d // 2, 2).transpose(4, 3).reshape(B, h, S, d)
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return x * cos + torch.cat([-x2, x1], dim=-1) * sin


def softmax_scale(cfg: dict) -> float:
    rs = cfg["rope_scaling"]
    m = 0.1 * rs["mscale_all_dim"] * math.log(rs["factor"]) + 1.0
    return (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5 * m * m


def swiglu(x, g, u, d, precision):
    return lin(F.silu(lin(x, g, precision)) * lin(x, u, precision), d,
               precision)


def layer(w: dict, i: int, x, bias, cos, sin, cfg: dict, precision: str,
          routes: list | None = None):
    """Layer ``i`` over x [B, S, H]; the routed experts' top-k ids [B, S,
    k] appended to ``routes`` where given."""
    p = f"model.layers.{i}."
    a = p + "self_attn."
    B, S, H = x.shape
    nh = cfg["num_attention_heads"]
    nope, rd, vd = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                    cfg["v_head_dim"])
    r, eps = cfg["kv_lora_rank"], cfg["rms_norm_eps"]
    xn = rms_norm(x, w[p + "input_layernorm.weight"], eps)
    q = lin(xn, w[a + "q_proj.weight"], precision).view(
        B, S, nh, nope + rd).transpose(1, 2)
    q_nope, q_pe = q[..., :nope], q[..., nope:]
    ckv = lin(xn, w[a + "kv_a_proj_with_mqa.weight"], precision)
    c, k_pe = ckv[..., :r], ckv[..., r:]
    k_pe = k_pe.view(B, S, 1, rd).transpose(1, 2)
    kv = lin(rms_norm(c, w[a + "kv_a_layernorm.weight"], eps),
             w[a + "kv_b_proj.weight"], precision).view(
        B, S, nh, nope + vd).transpose(1, 2)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    q_pe, k_pe = rope(q_pe, cos, sin), rope(k_pe, cos, sin)
    qs = torch.cat([q_nope, q_pe], dim=-1)
    ks = torch.cat([k_nope, k_pe.expand(B, nh, S, rd)], dim=-1)
    scores = _mm(qs, ks.transpose(2, 3), precision) * softmax_scale(cfg)
    probs = torch.softmax(scores + bias, dim=-1, dtype=torch.float32)
    ctx = _mm(probs, v, precision).transpose(1, 2).reshape(B, S, nh * vd)
    h = x + lin(ctx, w[a + "o_proj.weight"], precision)
    hn = rms_norm(h, w[p + "post_attention_layernorm.weight"], eps)
    m = p + "mlp."
    if i < cfg["first_k_dense_replace"]:
        return h + swiglu(hn, w[m + "gate_proj.weight"],
                          w[m + "up_proj.weight"], w[m + "down_proj.weight"],
                          precision)
    flat = hn.reshape(B * S, H)
    probs = torch.softmax(flat @ w[m + "gate.weight"].t(), dim=-1)
    top_w, top_i = torch.topk(probs, cfg["num_experts_per_tok"], dim=-1)
    top_w = top_w * cfg["routed_scaling_factor"]
    if routes is not None:
        routes.append(top_i.view(B, S, -1).cpu())
    out = swiglu(flat, w[m + "shared_experts.gate_proj.weight"],
                 w[m + "shared_experts.up_proj.weight"],
                 w[m + "shared_experts.down_proj.weight"], precision)
    for e in range(cfg["n_routed_experts"]):
        tok, slot = torch.nonzero(top_i == e, as_tuple=True)
        if len(tok) == 0:
            continue
        y = swiglu(flat[tok], w[m + "experts.gate_proj"][e],
                   w[m + "experts.up_proj"][e], w[m + "experts.down_proj"][e],
                   precision)
        out.index_add_(0, tok, y * top_w[tok, slot, None])
    return h + out.view(B, S, H)


def encode_rows(cfg: dict, seed: int, ids, mask, device,
                precision: str = "fp32", block: int = 64,
                routes: list | None = None) -> torch.Tensor:
    """[N, out_dim] fp32 embeddings of the rows ``ids`` [N, S] under the
    {0, 1} ``mask``, without autograd, a layer at a time over blocks of
    ``block`` rows. ``routes``, where given, gets each MoE layer's top-k
    ids [N, S, k] (on the host)."""
    shapes = leaf_shapes(cfg)
    place = {name: k for k, (name, _) in enumerate(shapes)}

    def leaves(names):
        return {n: make_leaf(cfg, seed, place[n], n, dict(shapes)[n], device)
                for n in names}
    ids = torch.as_tensor(ids).to(device, torch.int64)
    mask = torch.as_tensor(mask).to(device, torch.int64)
    N, S = ids.shape
    eps = cfg["rms_norm_eps"]
    cos, sin = yarn_cos_sin(cfg, S, device)
    keys = torch.arange(S, device=device)
    causal = keys[None, :] <= keys[:, None]
    with torch.no_grad(), matmul_precision(precision):
        emb = leaves(["model.embed_tokens.weight"])
        x = emb["model.embed_tokens.weight"][ids]
        del emb
        for i in range(cfg["num_hidden_layers"]):
            w = leaves([n for n, _ in layer_shapes(cfg, i)])
            per = [] if routes is not None else None
            for s in range(0, N, block):
                m = mask[s:s + block]
                seen = causal[None, None] & (m[:, None, None, :] != 0)
                bias = torch.zeros(seen.shape, device=device).masked_fill(
                    ~seen, torch.finfo(torch.float32).min)
                x[s:s + block] = layer(w, i, x[s:s + block], bias, cos, sin,
                                       cfg, precision, per)
            if per:
                routes.append(torch.cat(per))
            del w
        head = leaves(["model.norm.weight", "embeddingHead.weight",
                       "embeddingHead.bias", "norm.weight", "norm.bias"])
        last = mask.sum(1) - 1
        pooled = x[torch.arange(N, device=device), last]
        pooled = rms_norm(pooled, head["model.norm.weight"], eps)
        out = lin(pooled, head["embeddingHead.weight"], precision) \
            + head["embeddingHead.bias"]
        return F.layer_norm(out, (out.shape[-1],), head["norm.weight"],
                            head["norm.bias"],
                            cfg["embedding_head"]["layer_norm_eps"])
