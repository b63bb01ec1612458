"""DeepSeek-V2's decoder (HF ``DeepseekV2Model``) as an encoder tower.

The published model (arXiv:2405.04434; ``modeling_deepseek.py`` of
``deepseek-ai/DeepSeek-V2-Lite``), for the ANCE dual encoder of
``models/dot_models.py::DeepseekV2Dot``. Parameters are fp32; every
product runs in the config's compute ``dtype`` (bf16 on the card), the
weights cast per call as ``models/transformer.py::_dense`` does; the
norms, the rotary tables and the router are fp32, and so is the residual
stream. Per layer, with pre-norm residuals and no biases:

* RMSNorm: ``x / sqrt(mean(x²) + eps) · g``;
* ``h = x + MLA(RMSNorm_in(x))``, ``out = h + FFN(RMSNorm_post(h))``, a
  final RMSNorm after the last layer; no position embeddings;
* MLA (no q-LoRA): ``q = W_q x`` [heads, nope + rope], ``W_kva x`` gives
  the latent ``c`` [kv_lora_rank] and one ``k_pe`` [rope] shared by all
  heads, ``W_kvb RMSNorm_kv(c)`` gives ``k_nope`` and ``v`` per head; the
  rope parts are rotated by YaRN rope (:func:`yarn_tables`) at positions
  0..S−1 after the published de-interleave of their pairs; the softmax
  scale is ``q_head_dim^−½ · mscale(factor, mscale_all_dim)²``; the mask
  is causal and the key real (``ops/attention.py``);
* FFN: the first ``first_k_dense_replace`` layers a SwiGLU of width
  ``intermediate_size``; the rest MoE (``ops/moe.py``): an fp32 softmax
  router over ``n_routed_experts``, greedy top-``num_experts_per_tok``,
  no renormalisation, ``routed_scaling_factor``, no capacity, plus one
  SwiGLU of width ``n_shared_experts · moe_intermediate_size``.

Departures from the published code, each inside the CPU tests'
tolerances: the residual stream and the rope rotation are fp32 (the
published code keeps them in the model's dtype); a routed expert's
SwiGLU is formed from its fp32 sums before one rounding, and its output is
scaled by the gate weight before it is rounded (``ops/grouped_gemm.py``);
pad tokens are never routed (the published code routes every position);
the attention's softmax is bf16 for bf16 inputs, as the RoBERTa encoder's
einsum path (the published code's is fp32).

Parameter names are HF ``DeepseekV2ForCausalLM``'s under ``model.``
(``model.layers.N.self_attn.q_proj.weight``, ``...mlp.gate.weight``,
``...mlp.shared_experts.gate_proj.weight``, ``...input_layernorm.weight``)
but for the routed experts, held stacked for the grouped product:
``...mlp.experts.gate_proj`` and ``up_proj`` [E, I, H], ``down_proj``
[E, H, I]. :func:`stack_experts` maps HF's per-expert keys onto them.
Inference only: nothing here is differentiated (``dsv2dot_nll`` does not
train).
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from ance_tpu_torch.ops.attention import multi_head_attention
from ance_tpu_torch.ops.moe import moe_forward
from ance_tpu_torch.utils.observability import span


@dataclasses.dataclass(frozen=True)
class DeepseekV2Config:
    """DeepSeek-V2-Lite's published widths by default (its ``config.json``
    keys; ``rope_scaling``'s under ``rope_*``)."""
    vocab_size: int = 102400
    hidden_size: int = 2048
    intermediate_size: int = 10944
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    routed_scaling_factor: float = 1.0
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_factor: float = 40.0
    rope_original_max_position_embeddings: int = 4096
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 0.707
    rope_mscale_all_dim: float = 0.707
    pad_token_id: int = 100001
    initializer_range: float = 0.02
    dtype: torch.dtype = torch.float32  # compute dtype
    attention_impl: str = "auto"

    # what the published config may say that this port does not compute
    _REQUIRED = {"q_lora_rank": None, "topk_method": "greedy",
                 "scoring_func": "softmax", "norm_topk_prob": False,
                 "n_group": 1, "topk_group": 1, "moe_layer_freq": 1,
                 "attention_bias": False, "hidden_act": "silu"}

    @classmethod
    def from_hf(cls, hf: Mapping, **kw) -> "DeepseekV2Config":
        """From a published ``config.json`` dict (extra keys ignored);
        ``kw`` overrides any field. Raises on a setting the port does not
        compute (a q-LoRA, grouped routing, renormalised top-k, ...)."""
        for key, want in cls._REQUIRED.items():
            if key in hf and hf[key] != want:
                raise ValueError(f"DeepSeek-V2 {key}={hf[key]!r}: the port "
                                 f"computes {key}={want!r} only")
        names = {f.name for f in dataclasses.fields(cls)}
        args = {k: v for k, v in hf.items() if k in names}
        rope = hf.get("rope_scaling") or {}
        if rope:
            if rope.get("type") != "yarn":
                raise ValueError(f"rope_scaling type {rope.get('type')!r}: "
                                 f"the port computes yarn only")
            args.update(
                rope_factor=rope["factor"],
                rope_original_max_position_embeddings=rope[
                    "original_max_position_embeddings"],
                rope_beta_fast=rope["beta_fast"],
                rope_beta_slow=rope["beta_slow"],
                rope_mscale=rope["mscale"],
                rope_mscale_all_dim=rope["mscale_all_dim"])
        args.update(kw)
        return cls(**args)

    @classmethod
    def hf_overrides(cls, hf: Mapping) -> dict:
        """:meth:`from_hf`'s fields as registry overrides (all but the
        compute dtype and the attention implementation)."""
        cfg = dataclasses.asdict(cls.from_hf(hf))
        return {k: v for k, v in cfg.items()
                if k not in ("dtype", "attention_impl")}

    def q_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    def softmax_scale(self) -> float:
        m = yarn_mscale(self.rope_factor, self.rope_mscale_all_dim)
        return self.q_head_dim() ** -0.5 * m * m


def yarn_mscale(scale: float, mscale: float) -> float:
    """``0.1 · mscale · ln(scale) + 1`` (1 for a scale ≤ 1)."""
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_correction_range(cfg: DeepseekV2Config) -> tuple[int, int]:
    """(low, high): the floor and ceil of ``d · ln(L / (β · 2π)) / (2 ·
    ln base)`` at β = beta_fast and beta_slow, clamped to [0, d − 1]."""
    d, base = cfg.qk_rope_head_dim, cfg.rope_theta
    L = cfg.rope_original_max_position_embeddings

    def dim(beta):
        return d * math.log(L / (beta * 2 * math.pi)) / (2 * math.log(base))
    low = math.floor(dim(cfg.rope_beta_fast))
    high = math.ceil(dim(cfg.rope_beta_slow))
    return max(low, 0), min(high, d - 1)


def yarn_inv_freq(cfg: DeepseekV2Config) -> torch.Tensor:
    """[d/2] fp32: ``f_inter · (1 − m) + f_extra · m`` with ``f_extra_i =
    base^(−2i/d)``, ``f_inter = f_extra / factor`` and ``m = 1 −
    clamp((i − low) / (high − low), 0, 1)``."""
    d, base = cfg.qk_rope_head_dim, cfg.rope_theta
    extra = 1.0 / base ** (torch.arange(0, d, 2, dtype=torch.float32) / d)
    inter = extra / cfg.rope_factor
    low, high = yarn_correction_range(cfg)
    if low == high:
        high += 0.001  # the published ramp's guard against 0 / 0
    ramp = ((torch.arange(d // 2, dtype=torch.float32) - low)
            / (high - low)).clamp(0, 1)
    m = 1.0 - ramp
    return inter * (1.0 - m) + extra * m


def yarn_tables(cfg: DeepseekV2Config, S: int, device=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) [S, d] fp32 at positions 0..S−1: the angles
    ``t · inv_freq`` twice over (``rotate_half``'s halves), times
    ``mscale(factor, mscale) / mscale(factor, mscale_all_dim)``."""
    t = torch.arange(S, dtype=torch.float32)
    freqs = torch.outer(t, yarn_inv_freq(cfg))
    emb = torch.cat([freqs, freqs], dim=-1)
    scale = yarn_mscale(cfg.rope_factor, cfg.rope_mscale) \
        / yarn_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim)
    return (emb.cos() * scale).to(device), (emb.sin() * scale).to(device)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """[B, S, h, d] → fp32, rotated: the pairs (2j, 2j+1) de-interleaved
    into halves, then ``x · cos + rotate_half(x) · sin`` (cos, sin [S, d])."""
    B, S, h, d = x.shape
    x = x.float().reshape(B, S, h, d // 2, 2).transpose(-1, -2) \
        .reshape(B, S, h, d)
    return x * cos[None, :, None] + rotate_half(x) * sin[None, :, None]


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """fp32 in and out (fp64 for an fp64 model)."""
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        x = x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps)
        return x * self.weight.to(x.dtype)


def _lin(x: torch.Tensor, layer: nn.Linear, dtype) -> torch.Tensor:
    """A bias-free product in ``dtype``, input and weight cast per call."""
    return F.linear(x.to(dtype), layer.weight.to(dtype))


class MLA(nn.Module):
    """Multi-head latent attention without a q-LoRA (module docstring)."""

    def __init__(self, cfg: DeepseekV2Config):
        super().__init__()
        self.cfg = cfg
        H, nh = cfg.hidden_size, cfg.num_attention_heads
        self.q_proj = nn.Linear(H, nh * cfg.q_head_dim(), bias=False)
        self.kv_a_proj_with_mqa = nn.Linear(
            H, cfg.kv_lora_rank + cfg.qk_rope_head_dim, bias=False)
        self.kv_a_layernorm = RMSNorm(cfg.kv_lora_rank, cfg.rms_norm_eps)
        self.kv_b_proj = nn.Linear(
            cfg.kv_lora_rank, nh * (cfg.qk_nope_head_dim + cfg.v_head_dim),
            bias=False)
        self.o_proj = nn.Linear(nh * cfg.v_head_dim, H, bias=False)

    def forward(self, x, attention_mask, cos, sin):
        """x [B, S, H] (normed) → [B, S, H] in the compute dtype."""
        cfg, dt = self.cfg, self.cfg.dtype
        B, S, _ = x.shape
        nh, nope, rope = (cfg.num_attention_heads, cfg.qk_nope_head_dim,
                          cfg.qk_rope_head_dim)
        q = _lin(x, self.q_proj, dt).view(B, S, nh, nope + rope)
        q_nope, q_pe = q.split([nope, rope], dim=-1)
        c, k_pe = _lin(x, self.kv_a_proj_with_mqa, dt).split(
            [cfg.kv_lora_rank, rope], dim=-1)
        kv = _lin(self.kv_a_layernorm(c), self.kv_b_proj, dt).view(
            B, S, nh, nope + cfg.v_head_dim)
        k_nope, v = kv.split([nope, cfg.v_head_dim], dim=-1)
        q_pe = apply_rope(q_pe, cos, sin).to(dt)
        k_pe = apply_rope(k_pe.view(B, S, 1, rope), cos, sin).to(dt)
        q = torch.cat([q_nope, q_pe], dim=-1)
        k = torch.cat([k_nope, k_pe.expand(B, S, nh, rope)], dim=-1)
        ctx = multi_head_attention(q, k, v, attention_mask,
                                   impl=cfg.attention_impl, causal=True,
                                   scale=cfg.softmax_scale())
        return _lin(ctx.reshape(B, S, nh * cfg.v_head_dim), self.o_proj, dt)


class MLP(nn.Module):
    """SwiGLU: ``down(silu(gate x) ⊙ up x)``, bias-free."""

    def __init__(self, cfg: DeepseekV2Config, width: int):
        super().__init__()
        self.cfg = cfg
        H = cfg.hidden_size
        self.gate_proj = nn.Linear(H, width, bias=False)
        self.up_proj = nn.Linear(H, width, bias=False)
        self.down_proj = nn.Linear(width, H, bias=False)

    def forward(self, x, real, base):
        """``base`` + the SwiGLU of x, in fp32 (``real`` unused: every row
        goes through a dense layer)."""
        dt = self.cfg.dtype
        out = _lin(F.silu(_lin(x, self.gate_proj, dt))
                   * _lin(x, self.up_proj, dt), self.down_proj, dt)
        return base + out.to(base.dtype)


class Gate(nn.Module):
    """The router's weight [E, H] (HF ``MoEGate``), applied in fp32."""

    def __init__(self, E: int, H: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(E, H))


class Experts(nn.Module):
    """The routed experts' SwiGLU weights, stacked over the experts."""

    def __init__(self, E: int, H: int, I: int):
        super().__init__()
        self.gate_proj = nn.Parameter(torch.empty(E, I, H))
        self.up_proj = nn.Parameter(torch.empty(E, I, H))
        self.down_proj = nn.Parameter(torch.empty(E, H, I))


class MoE(nn.Module):
    """Routed experts plus the shared experts (``ops/moe.py``)."""

    def __init__(self, cfg: DeepseekV2Config):
        super().__init__()
        self.cfg = cfg
        E, H = cfg.n_routed_experts, cfg.hidden_size
        self.gate = Gate(E, H)
        self.experts = Experts(E, H, cfg.moe_intermediate_size)
        self.shared_experts = MLP(
            cfg, cfg.n_shared_experts * cfg.moe_intermediate_size)

    def forward(self, x, real, base):
        """``base`` + the MoE output of x [B, S, H]; ``real`` [B·S] bool
        marks the tokens that are routed."""
        cfg, s = self.cfg, self.shared_experts
        B, S, H = x.shape
        out = moe_forward(
            x.reshape(B * S, H), real, self.gate.weight,
            self.experts.gate_proj, self.experts.up_proj,
            self.experts.down_proj,
            (s.gate_proj.weight, s.up_proj.weight, s.down_proj.weight),
            top_k=cfg.num_experts_per_tok, dtype=cfg.dtype,
            base=base.reshape(B * S, H), scaling=cfg.routed_scaling_factor)
        return out.view(B, S, H)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DeepseekV2Config, index: int):
        super().__init__()
        self.self_attn = MLA(cfg)
        self.mlp = MLP(cfg, cfg.intermediate_size) \
            if index < cfg.first_k_dense_replace else MoE(cfg)
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size,
                                                cfg.rms_norm_eps)

    def forward(self, x, attention_mask, real, cos, sin):
        """x [B, S, H] fp32 → the layer's output, fp32. The attention block
        is the span ``encoder.mla``."""
        with span("encoder.mla"):
            h = x + self.self_attn(self.input_layernorm(x), attention_mask,
                                   cos, sin).to(x.dtype)
        return self.mlp(self.post_attention_layernorm(h), real, h)


class DeepseekV2Model(nn.Module):
    """Token ids → final-normed hidden states [B, S, H] fp32. The
    embedding lookup and the rope tables are the span
    ``encoder.embeddings``, each layer ``encoder.layer``."""

    def __init__(self, cfg: DeepseekV2Config):
        super().__init__()
        self.config = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(DecoderLayer(cfg, i)
                                    for i in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self._rope: dict = {}

    def rope(self, S: int, device) -> tuple[torch.Tensor, torch.Tensor]:
        """The (cos, sin) tables for length S on ``device``, made once."""
        key = (S, str(device))
        if key not in self._rope:
            self._rope[key] = yarn_tables(self.config, S, device)
        return self._rope[key]

    def forward(self, input_ids, attention_mask=None):
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        B, S = input_ids.shape
        with span("encoder.embeddings"):
            x = self.embed_tokens(input_ids)
            x = x.to(torch.promote_types(x.dtype, torch.float32))
            cos, sin = self.rope(S, input_ids.device)
            real = attention_mask.reshape(B * S) != 0
        for layer in self.layers:
            with span("encoder.layer"):
                x = layer(x, attention_mask, real, cos, sin)
        return self.norm(x)


_EXPERT_KEY = re.compile(r"^(.*\.mlp\.experts)\.(\d+)\.(gate_proj|up_proj|"
                         r"down_proj)\.weight$")


def stack_experts(sd: Mapping[str, torch.Tensor]) -> dict:
    """HF's per-expert keys (``...mlp.experts.E.gate_proj.weight``) stacked
    into the port's ``...mlp.experts.gate_proj`` [E, out, in]; every other
    key as it is. Raises when a layer's experts are not 0..E−1."""
    out, groups = {}, {}
    for k, v in sd.items():
        m = _EXPERT_KEY.match(k)
        if m is None:
            out[k] = v
        else:
            groups.setdefault((m.group(1), m.group(3)), {})[
                int(m.group(2))] = v
    for (prefix, proj), by_e in groups.items():
        if sorted(by_e) != list(range(len(by_e))):
            raise ValueError(f"{prefix}.*.{proj}: experts {sorted(by_e)} "
                             f"are not 0..{len(by_e) - 1}")
        out[f"{prefix}.{proj}"] = torch.stack([by_e[e]
                                               for e in range(len(by_e))])
    return out


def init_weights(module: nn.Module, cfg: DeepseekV2Config,
                 generator: torch.Generator) -> None:
    """Seeded init: N(0, initializer_range) for every matrix, embedding
    table, router and expert stack; norms' gains 1, biases 0. A module
    built on the meta device is left as it is (its weights are assigned
    afterwards)."""
    std = cfg.initializer_range
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.is_meta:
                continue
            if p.dim() >= 2:
                p.copy_(torch.randn(p.shape, generator=generator) * std)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.fill_(1.0)
