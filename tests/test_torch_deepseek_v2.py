"""``dsv2dot_nll``: ANCE's head over DeepSeek-V2's MoE + MLA decoder,
held on the CPU to the plain fp32 reference (``plain_deepseek_v2.py``) at
a tiny size, with the pieces it brought to the port: YaRN rope, the
causal attention, the MoE op and its grouped products, the registry entry
on the normal encode / search / mining path, and the attention calls that
were there before, unchanged bit for bit.

Tolerances: the fp32 port against the fp32 reference differs by the order
of fp32 sums only (the rope tables are made in fp64 by the reference, in
fp32 by the port), so 1e-5 relative. The bf16 port differs by bf16
rounding of every product's operands and outputs over 3 layers, and by the
few router choices that rounding flips at a near-tie (1 to 3 of ~100 real
tokens' top-2 sets at these seeds; the reference with its own operands
rounded to bf16 flips alike): 0.013-0.031 at weights of std 0.15, so 5e-2
relative; the same function with float8 operands reads 0.2 and above, so
a float8 path fails it. (At std 0.3 a tiny decoder turns a flip into 0.1
of an embedding, on the reference's own bf16 rounding as on the port.)
"""

from __future__ import annotations

import json
import math
import random

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import plain_deepseek_v2 as plain
from ance_tpu_torch.data.cache import TokenCache, TokenCacheWriter
from ance_tpu_torch.models import deepseek_v2 as dsv2
from ance_tpu_torch.models.registry import get_model_spec
from ance_tpu_torch.ops import attention, grouped_gemm, moe

# DeepSeek-V2-Lite's published rope and routing settings, every width cut
HF = {"vocab_size": 300, "hidden_size": 64, "intermediate_size": 96,
      "moe_intermediate_size": 32, "num_hidden_layers": 3,
      "num_attention_heads": 4, "n_routed_experts": 8, "n_shared_experts": 1,
      "num_experts_per_tok": 2, "first_k_dense_replace": 1,
      "kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
      "v_head_dim": 16, "rms_norm_eps": 1e-6, "rope_theta": 10000,
      "routed_scaling_factor": 1.0, "q_lora_rank": None,
      "topk_method": "greedy", "scoring_func": "softmax",
      "norm_topk_prob": False,
      "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40,
                       "mscale": 0.707, "mscale_all_dim": 0.707,
                       "original_max_position_embeddings": 4096,
                       "type": "yarn"}}
LITE = dict(HF, hidden_size=2048, qk_nope_head_dim=128, qk_rope_head_dim=64)
FP32_RTOL = 1e-5
BF16_RTOL = 5e-2


def hf_state_dict(cfg: dict, seed: int, std: float = 0.3) -> dict:
    """A seeded state dict in HF ``DeepseekV2ForCausalLM`` names (experts
    one by one, an LM head), fp32: matrices N(0, std), gains 1 + N(0, std),
    the head's biases N(0, std)."""
    g = torch.Generator().manual_seed(seed)
    H, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    r, E, I = (cfg["kv_lora_rank"], cfg["n_routed_experts"],
               cfg["moe_intermediate_size"])
    shapes = {"model.embed_tokens.weight": (cfg["vocab_size"], H),
              "model.norm.weight": (H,), "lm_head.weight": (7, H),
              "embeddingHead.weight": (768, H), "embeddingHead.bias": (768,),
              "norm.weight": (768,), "norm.bias": (768,)}

    def swiglu(p, width):
        shapes.update({p + "gate_proj.weight": (width, H),
                       p + "up_proj.weight": (width, H),
                       p + "down_proj.weight": (H, width)})
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        a = p + "self_attn."
        shapes.update({a + "q_proj.weight": (nh * (dn + dr), H),
                       a + "kv_a_proj_with_mqa.weight": (r + dr, H),
                       a + "kv_a_layernorm.weight": (r,),
                       a + "kv_b_proj.weight": (nh * (dn + dv), r),
                       a + "o_proj.weight": (H, nh * dv),
                       p + "input_layernorm.weight": (H,),
                       p + "post_attention_layernorm.weight": (H,)})
        if i < cfg["first_k_dense_replace"]:
            swiglu(p + "mlp.", cfg["intermediate_size"])
        else:
            shapes[p + "mlp.gate.weight"] = (E, H)
            swiglu(p + "mlp.shared_experts.", cfg["n_shared_experts"] * I)
            for e in range(E):
                swiglu(f"{p}mlp.experts.{e}.", I)
    sd = {}
    for name, shape in shapes.items():
        t = torch.randn(shape, generator=g) * std
        sd[name] = t + 1.0 if name.endswith("norm.weight") and \
            not name.startswith("embeddingHead") else t
    return sd


def port_model(cfg: dict, sd: dict, dtype=torch.float32):
    """The registry's model at ``cfg``'s widths loaded from an HF-named
    state dict through the spec's ``adapt_weights``."""
    spec = get_model_spec("dsv2dot_nll")
    model = spec.build(dtype=dtype,
                       config_overrides=dsv2.DeepseekV2Config.hf_overrides(
                           cfg))
    model.load_state_dict(spec.adapt_weights(dict(sd), model), strict=True)
    return model


def tokens(seed: int, B: int = 6, S: int = 16, vocab: int = 300):
    """(ids, mask): rows of seeded lengths (one full, one of length 1),
    real tokens first, pads after."""
    rs = np.random.RandomState(seed)
    lengths = rs.randint(2, S + 1, B)
    lengths[0], lengths[-1] = S, 1
    ids = torch.as_tensor(rs.randint(3, vocab, (B, S)))
    mask = torch.as_tensor(np.arange(S)[None] < lengths[:, None]).long()
    return ids, mask


def rel_err(got, want):
    got, want = got.double(), want.double()
    return ((got - want).norm(dim=1) / want.norm(dim=1)).max().item()


def fp8(t):
    """t rounded to float8 e4m3 under a per-tensor scale."""
    s = t.abs().amax().clamp_min(1e-30) / 448.0
    return (t / s).to(torch.float8_e4m3fn).to(t.dtype) * s


# -- the model against the plain reference --------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fp32_port_matches_plain(seed):
    sd = hf_state_dict(HF, seed)
    ids, mask = tokens(seed)
    want = plain.encode(sd, HF, ids, mask)
    with torch.inference_mode():
        got = port_model(HF, sd).body_emb(ids, mask)
    assert rel_err(got, want) < FP32_RTOL


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_port_within_bf16_of_plain_and_float8_is_not(seed):
    sd = hf_state_dict(HF, seed, std=0.15)
    ids, mask = tokens(seed)
    want = plain.encode(sd, HF, ids, mask)
    with torch.inference_mode():
        got = port_model(HF, sd, torch.bfloat16).body_emb(ids, mask)
    assert rel_err(got, want) < BF16_RTOL
    assert rel_err(plain.encode(sd, HF, ids, mask, rnd=fp8), want) \
        > 2 * BF16_RTOL


def test_query_and_body_are_one_tower():
    sd = hf_state_dict(HF, 3)
    ids, mask = tokens(3)
    model = port_model(HF, sd)
    with torch.inference_mode():
        assert torch.equal(model.query_emb(ids, mask),
                           model.body_emb(ids, mask))
        assert torch.equal(model(ids, mask), model.body_emb(ids, mask))


# -- YaRN rope -------------------------------------------------------------

def test_yarn_range_and_scales_at_the_published_settings():
    cfg = dsv2.DeepseekV2Config.from_hf(LITE)
    # 64·ln(4096 / (β·2π)) / (2·ln 10000) at β = 32 and 1: 10.47, 22.52
    assert dsv2.yarn_correction_range(cfg) == (10, 23)
    m = 0.1 * 0.707 * math.log(40) + 1.0
    assert cfg.softmax_scale() == pytest.approx(192 ** -0.5 * m * m,
                                                rel=1e-12)
    assert dsv2.yarn_mscale(40, 0.707) / dsv2.yarn_mscale(40, 0.707) == 1.0


@pytest.mark.parametrize("hf", [HF, LITE], ids=["tiny", "lite"])
def test_yarn_tables_match_the_formulas(hf):
    cfg = dsv2.DeepseekV2Config.from_hf(hf)
    d = cfg.qk_rope_head_dim
    low, high = dsv2.yarn_correction_range(cfg)
    i = np.arange(d // 2, dtype=np.float64)
    f_extra = 10000.0 ** (-2 * i / d)
    m = 1 - np.clip((i - low) / (high - low), 0, 1)
    inv = f_extra / 40 * (1 - m) + f_extra * m
    np.testing.assert_allclose(dsv2.yarn_inv_freq(cfg).numpy(), inv,
                               rtol=1e-6)
    cos, sin = dsv2.yarn_tables(cfg, 40)
    ang = np.arange(40)[:, None] * np.concatenate([inv, inv])[None]
    np.testing.assert_allclose(cos.numpy(), np.cos(ang), atol=2e-5)
    np.testing.assert_allclose(sin.numpy(), np.sin(ang), atol=2e-5)
    pc, ps = plain.yarn(hf, 40)
    assert torch.allclose(cos, pc, atol=2e-5) and torch.allclose(sin, ps,
                                                                  atol=2e-5)


def test_rope_deinterleaves_pairs_before_rotating():
    """Pair (2j, 2j+1) becomes (j, j + d/2): at position 0 (cos 1, sin 0)
    the rotation is the de-interleave alone."""
    x = torch.arange(8.0).view(1, 1, 1, 8)
    cos, sin = torch.ones(1, 8), torch.zeros(1, 8)
    assert dsv2.apply_rope(x, cos, sin).flatten().tolist() == \
        [0, 2, 4, 6, 1, 3, 5, 7]


# -- attention --------------------------------------------------------------

def _old_xla_attention(q, k, v, bias=None, softmax_dtype=torch.float32):
    """The einsum path as it stood before ``causal`` and ``scale``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(softmax_dtype),
                          k.to(softmax_dtype))
    logits = logits * torch.tensor(scale, dtype=softmax_dtype)
    if bias is not None:
        logits = logits + bias.to(softmax_dtype)
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("impl", ["xla", "xla_bf16", "auto"])
@pytest.mark.parametrize("masked", [False, True])
def test_existing_attention_calls_unchanged_bit_for_bit(dtype, impl, masked):
    g = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(3, 20, 4, 64, generator=g).to(dtype)
               for _ in range(3))
    mask = torch.ones(3, 20, dtype=torch.long)
    mask[1, 12:] = 0
    mask[2, 3:] = 0
    got = attention.multi_head_attention(q, k, v, mask if masked else None,
                                         impl=impl)
    sm = torch.bfloat16 if impl == "xla_bf16" or (
        impl == "auto" and dtype == torch.bfloat16) else \
        torch.promote_types(dtype, torch.float32)
    want = _old_xla_attention(q, k, v, attention.mask_to_bias(mask)
                              if masked else None, softmax_dtype=sm)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dv", [16, 24])
def test_causal_attention_with_scale_and_v_width(dv):
    """Each query against a plain softmax over the keys at or before it
    that are real, at an explicit scale, v wider or narrower than q."""
    g = torch.Generator().manual_seed(dv)
    B, S, H, D = 2, 9, 3, 24
    q, k = (torch.randn(B, S, H, D, generator=g) for _ in range(2))
    v = torch.randn(B, S, H, dv, generator=g)
    mask = torch.ones(B, S, dtype=torch.long)
    mask[1, 6:] = 0
    got = attention.multi_head_attention(q, k, v, mask, impl="auto",
                                         causal=True, scale=0.37)
    assert got.shape == (B, S, H, dv)
    for b in range(B):
        for i in range(S):
            keys = [j for j in range(i + 1) if mask[b, j]]
            s = torch.einsum("hd,khd->hk", q[b, i], k[b, keys]) * 0.37
            want = torch.einsum("hk,khd->hd", torch.softmax(s, -1),
                                v[b, keys])
            assert torch.allclose(got[b, i], want, atol=1e-5)


def test_kernels_refuse_causal_and_scale():
    q = torch.zeros(1, 4, 2, 64)
    for impl in ("fused", "flash"):
        with pytest.raises(ValueError, match="causal mask"):
            attention.multi_head_attention(q, q, q, impl=impl, causal=True)


# -- the MoE op --------------------------------------------------------------

def _routing(T, E, k, counts_wanted=None, seed=0):
    """Sorted-pair routing metadata as ``moe_forward`` builds it; with
    ``counts_wanted`` the pairs go to experts in those numbers."""
    g = torch.Generator().manual_seed(seed)
    if counts_wanted is None:
        experts = torch.stack([torch.randperm(E, generator=g)[:k]
                               for _ in range(T)])
    else:
        flat = torch.repeat_interleave(torch.arange(E),
                                       torch.tensor(counts_wanted))
        experts = flat[torch.randperm(T * k, generator=g)].view(T, k)
    weights = torch.rand(T, k, generator=g)
    real = torch.rand(T, generator=g) < 0.7
    experts = experts.masked_fill(~real[:, None], E)
    flat = experts.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.zeros(E + 1, dtype=torch.long).index_add_(
        0, flat, torch.ones_like(flat))[:E]
    pair_off, tile_off, slots = grouped_gemm.schedule(counts, T * k)
    return dict(experts=experts, weights=weights, real=real, order=order,
                counts=counts, pair_off=pair_off, tile_off=tile_off,
                slots=slots, rows=(order // k).to(torch.int32),
                gate=weights.reshape(-1)[order])


@pytest.mark.parametrize("counts_wanted", [
    None,                        # random distinct experts a token
    [0, 0, 30, 1, 0, 17, 0, 12],  # empty, single-row and uneven groups
    [60, 0, 0, 0, 0, 0, 0, 0],    # every pair to one expert
], ids=["random", "uneven", "one_expert"])
def test_grouped_products_match_a_per_pair_loop(counts_wanted):
    T, E, k, H, I = 30, 8, 2, 16, 12
    r = _routing(T, E, k, counts_wanted)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(T, H, generator=g)
    wg, wu = torch.randn(E, I, H, generator=g), torch.randn(E, I, H,
                                                            generator=g)
    wd = torch.randn(E, H, I, generator=g)
    h = grouped_gemm.grouped_swiglu(x, r["rows"], wg, wu, r["pair_off"],
                                    r["tile_off"], r["slots"])
    y = grouped_gemm.grouped_down(h, wd, r["gate"], r["pair_off"],
                                  r["tile_off"], r["slots"])
    flat_e = r["experts"].reshape(-1)[r["order"]]
    for p in range(T * k):
        e, t = int(flat_e[p]), int(r["rows"][p])
        if e == E:  # a pad token's pair: never computed
            assert not h[p].any() and not y[p].any()
            continue
        want_h = F.silu(wg[e] @ x[t]) * (wu[e] @ x[t])
        assert torch.allclose(h[p], want_h, rtol=1e-5, atol=1e-5)
        assert torch.allclose(y[p], r["gate"][p] * (wd[e] @ want_h),
                              rtol=1e-4, atol=1e-4)


def test_schedule_bounds_every_routing():
    counts = torch.tensor([0, 129, 1, 0, 256, 128])
    pair_off, tile_off, slots = grouped_gemm.schedule(counts, 600)
    assert pair_off.tolist() == [0, 0, 129, 130, 130, 386, 514]
    assert tile_off.tolist() == [0, 0, 2, 3, 3, 5, 6]
    assert slots == math.ceil(600 / 128) + 6 >= tile_off[-1]
    x, w = torch.zeros(4, 8), torch.zeros(6, 4, 8)
    with pytest.raises(ValueError, match="row tiles"):
        grouped_gemm.grouped_swiglu(x, torch.zeros(4, dtype=torch.int32),
                                    w, w, pair_off, tile_off,
                                    grouped_gemm.MAX_SLOTS + 1)


def test_pad_tokens_are_not_routed_and_change_no_real_row():
    sd = hf_state_dict(HF, 4)
    ids, mask = tokens(4, B=5, S=12)
    model = port_model(HF, sd)
    moe.reset_moe_counters()
    with torch.inference_mode():
        model.body_emb(ids, mask)  # no profiler: nothing counted
    assert moe.moe_counters() == dict.fromkeys(moe._COUNTER_NAMES, 0)
    with torch.inference_mode(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        a = model.body_emb(ids, mask)
    got = moe.moe_counters()
    real = int(mask.sum())
    moe_layers = HF["num_hidden_layers"] - HF["first_k_dense_replace"]
    assert got["routed_tokens"] == moe_layers * real
    assert got["routed_pairs"] == moe_layers * real * 2
    assert 0 < got["expert_tokens_max"] <= got["routed_pairs"]
    # other pad ids, and more pad columns, leave every embedding as it was
    ids2 = torch.where(mask.bool(), ids, torch.full_like(ids, 7))
    wide = torch.cat([ids2, torch.full((5, 4), 9)], dim=1)
    wide_mask = torch.cat([mask, torch.zeros(5, 4, dtype=torch.long)], dim=1)
    with torch.inference_mode():
        b = model.body_emb(ids2, mask)
        c = model.body_emb(wide, wide_mask)
    assert torch.allclose(a, b, atol=1e-6) and torch.allclose(a, c,
                                                              atol=1e-5)


def test_moe_forward_pads_take_base_plus_shared_only():
    T, H, E, I = 6, 8, 4, 5
    g = torch.Generator().manual_seed(2)
    x, base = torch.randn(T, H, generator=g), torch.randn(T, H, generator=g)
    gate = torch.randn(E, H, generator=g)
    w = (torch.randn(E, I, H, generator=g), torch.randn(E, I, H, generator=g),
         torch.randn(E, H, I, generator=g))
    shared = (torch.randn(3, H, generator=g), torch.randn(3, H, generator=g),
              torch.randn(H, 3, generator=g))
    real = torch.tensor([True, True, False, True, False, False])
    out = moe.moe_forward(x, real, gate, *w, shared, top_k=2,
                          dtype=torch.float32, base=base)
    s = F.linear(F.silu(F.linear(x, shared[0])) * F.linear(x, shared[1]),
                 shared[2])
    probs = torch.softmax(x @ gate.t(), -1)
    top_p, top_e = torch.topk(probs, 2, -1)
    for t in range(T):
        want = base[t] + s[t]
        if real[t]:
            for p, e in zip(top_p[t], top_e[t]):
                want = want + p * (w[2][e] @ (F.silu(w[0][e] @ x[t])
                                              * (w[1][e] @ x[t])))
        # fp32 sums of magnitude ~10-100 in another order: a few ulps
        assert torch.allclose(out[t], want, rtol=1e-5, atol=1e-4)


# -- weights, registry and the normal path ------------------------------------

def test_adapt_weights_stacks_hf_experts_and_drops_the_lm_head():
    sd = hf_state_dict(HF, 6)
    spec = get_model_spec("dsv2dot_nll")
    model = spec.build(config_overrides=dsv2.DeepseekV2Config.hf_overrides(
        HF))
    adapted = spec.adapt_weights(dict(sd), model)
    assert "lm_head.weight" not in adapted
    assert set(adapted) == set(model.state_dict())
    stack = adapted["model.layers.2.mlp.experts.down_proj"]
    assert stack.shape == (8, 64, 32)
    assert torch.equal(stack[5], sd["model.layers.2.mlp.experts.5."
                                    "down_proj.weight"])
    model.load_state_dict(adapted, strict=True)
    bad = {k: v for k, v in sd.items() if ".experts.3." not in k}
    with pytest.raises(ValueError, match="experts"):
        dsv2.stack_experts(bad)


def test_config_from_hf_refuses_what_the_port_does_not_compute():
    for key, value in [("q_lora_rank", 1536), ("topk_method", "group_limited_greedy"),
                       ("norm_topk_prob", True), ("scoring_func", "sigmoid")]:
        with pytest.raises(ValueError, match=key):
            dsv2.DeepseekV2Config.from_hf(dict(HF, **{key: value}))


def _write_cache(path, n, seq, rs):
    lengths = rs.randint(2, seq + 1, n)
    with TokenCacheWriter(str(path), seq) as w:
        for length in lengths:
            row = np.full(seq, 2, np.int32)
            row[:length] = rs.randint(3, HF["vocab_size"], length)
            w.write(int(length), row)


def test_registry_model_encodes_searches_and_mines(tmp_path):
    from ance_tpu_torch.index.flat import FlatIPIndex
    from ance_tpu_torch.train.ann_gen import mine_negatives
    from ance_tpu_torch.train.encode import (encode_cache_to_device,
                                             make_encode_fn)
    rs = np.random.RandomState(0)
    _write_cache(tmp_path / "passages", 40, 12, rs)
    _write_cache(tmp_path / "queries", 9, 6, rs)
    model = port_model(HF, hf_state_dict(HF, 7))
    dev = torch.device("cpu")
    cls = type(model)
    with TokenCache(str(tmp_path / "passages")) as pc, \
            TokenCache(str(tmp_path / "queries")) as qc:
        p_emb, p_ids = encode_cache_to_device(
            make_encode_fn(model, cls.body_emb, dev), pc, 16)
        q_emb, q_ids = encode_cache_to_device(
            make_encode_fn(model, cls.query_emb, dev), qc, 4)
        lengths, toks = pc.batch(np.arange(40))
    assert p_emb.shape == (40, 768) and q_emb.shape == (9, 768)
    mask = torch.as_tensor(np.arange(12)[None] < lengths[:, None]).long()
    with torch.inference_mode():
        direct = model.body_emb(torch.as_tensor(np.array(toks)).long(), mask)
    assert torch.allclose(p_emb, direct, atol=1e-5)
    index = FlatIPIndex(dim=768, device=dev)
    index.add(p_emb)
    scores, ids = index.search(q_emb, 10)
    want = (q_emb.double() @ p_emb.double().t()).topk(10, dim=1)
    assert torch.equal(torch.as_tensor(np.asarray(ids)), want.indices)
    assert len(set(np.asarray(ids)[:, 0].tolist())) > 1  # not one vector
    positives = {int(q): int(rs.randint(40)) for q in q_ids}
    negs, _ = mine_negatives(q_ids, p_ids, positives, np.asarray(ids), 3,
                             rng=random.Random(1))
    assert set(negs) == set(positives)
    for q, ns in negs.items():
        assert len(ns) == 3 and positives[q] not in ns


def test_cli_generate_runs_dsv2dot_nll(tmp_path):
    """``generate --model_type dsv2dot_nll`` on the CPU: encode, dev
    search, training search and mining through the normal path."""
    from ance_tpu_torch.cli import main
    rs = np.random.RandomState(1)
    data = tmp_path / "data"
    data.mkdir()
    _write_cache(data / "passages", 48, 12, rs)
    _write_cache(data / "train-query", 10, 6, rs)
    _write_cache(data / "dev-query", 4, 6, rs)
    (data / "train-qrel.tsv").write_text(
        "".join(f"{q}\t{rs.randint(48)}\t1\n" for q in range(10)))
    (data / "dev-qrel.tsv").write_text(
        "".join(f"{q}\t{rs.randint(48)}\t1\n" for q in range(4)))
    over = dict(dsv2.DeepseekV2Config.hf_overrides(HF),
                initializer_range=0.3)
    main(["generate", "--model_type", "dsv2dot_nll", "--encoder_overrides",
          json.dumps(over), "--data_dir", str(data), "--device", "cpu",
          "--training_dir", str(tmp_path / "train"), "--output_dir",
          str(tmp_path / "ann"), "--max_seq_length", "12",
          "--max_query_length", "6", "--per_device_eval_batch_size", "8",
          "--topk_training", "10", "--negative_sample", "2",
          "--ann_chunk_factor", "1"])
    lines = (tmp_path / "ann" / "ann_training_data_0").read_text() \
        .splitlines()
    assert len(lines) == 10
    ndcg = json.loads((tmp_path / "ann" / "ann_ndcg_0").read_text())
    assert 0.0 <= ndcg["ndcg"] <= 1.0


@pytest.mark.parametrize("command,flag", [("train", "--data_dir"),
                                          ("warmup", "--train_file"),
                                          ("ance-loop", "--data_dir")])
def test_training_commands_refuse_dsv2dot_nll(command, flag, tmp_path):
    from ance_tpu_torch.cli import main
    with pytest.raises(SystemExit, match="training it is out of scope"):
        main([command, "--model_type", "dsv2dot_nll", flag, str(tmp_path),
              "--output_dir", str(tmp_path / "out")])


def test_export_refuses_dsv2dot_nll(tmp_path):
    with pytest.raises(SystemExit, match="no reference checkpoint format"):
        get_model_spec("dsv2dot_nll").export(str(tmp_path), {}, 1, {})


# -- the grouped kernels on the card ------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel #7 and the Triton "
                    "combine have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("counts_wanted", [None, [0, 0, 300, 1, 0, 170, 0,
                                                  129]],
                         ids=["random", "uneven"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_grouped_kernels_match_plain_on_cuda(counts_wanted, dtype):
    dev = _cuda()
    T, E, k, H, I = 300, 8, 2, 256, 192
    r = _routing(T, E, k, counts_wanted)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(T, H, generator=g).to(dtype)
    w = [(torch.randn(*s, generator=g) * 0.1).to(dtype)
         for s in ((E, I, H), (E, I, H), (E, H, I))]
    base, shared = torch.randn(T, H, generator=g), \
        torch.randn(T, H, generator=g).to(dtype)
    pos = torch.empty(T * k, dtype=torch.int32).scatter_(
        0, r["order"], torch.arange(T * k, dtype=torch.int32)).view(T, k)

    def run(d):
        to = (lambda t: t.to(d))
        h = grouped_gemm.grouped_swiglu(
            to(x), to(r["rows"]), to(w[0]), to(w[1]), to(r["pair_off"]),
            to(r["tile_off"]), r["slots"])
        y = grouped_gemm.grouped_down(h, to(w[2]), to(r["gate"]),
                                      to(r["pair_off"]), to(r["tile_off"]),
                                      r["slots"])
        out = grouped_gemm.combine(to(base), to(shared), y, to(pos),
                                   to(r["real"]))
        P = int(r["pair_off"][-1])
        return h[:P].float().cpu(), y[:P].float().cpu(), out.cpu()
    if dtype == torch.float32:  # kernel #7 takes bf16 only
        with pytest.raises(TypeError, match="bfloat16 only"):
            run(dev)
        return
    launches = grouped_gemm.grouped_swiglu.launches
    got, want = run(dev), run(torch.device("cpu"))
    torch.cuda.synchronize()
    assert grouped_gemm.grouped_swiglu.launches == launches + 2
    tol = 2e-2
    for a, b in zip(got, want):
        assert rel_err(a.reshape(1, -1), b.reshape(1, -1)) < tol
