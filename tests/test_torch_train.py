"""The port's training path against the JAX package on the same numpy
inputs and weights: the fused-attention backward (kernel #3's plain
version against the Pallas kernel in interpret mode), its autograd
``Function``, the losses, dropout and remat, and whole train steps (clip +
LAMB or AdamW + warmup-linear, FirstP and MaxP, with accumulation and
``fused_body``). The ``cuda`` tests hold the backward kernel to its plain
version on the card and skip elsewhere."""

import faulthandler
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ance_tpu.models import losses as jax_losses
from ance_tpu.models.dot_models import RobertaDot as JaxRobertaDot
from ance_tpu.models.transformer import EncoderConfig as JaxConfig
from ance_tpu.ops.fused_attention import _fused_backward as jax_fused_backward
from ance_tpu_torch.models import losses
from ance_tpu_torch.models.dot_models import RobertaDot
from ance_tpu_torch.models.transformer import EncoderConfig, dropout
from ance_tpu_torch.models.weights import state_dict_from_flax
from ance_tpu_torch.ops.attention import multi_head_attention
from ance_tpu_torch.ops.fused_attention import (
    MAX_SEQ_BACKWARD, fused_attention, fused_attention_backward,
    fused_attention_backward_reference, fused_attention_reference,
    fused_kernel_for)
from test_torch_attention import (assert_bf16_slice_close, fp32_operands,
                                 key_tiles, row_stats, running_product,
                                 schedule_inputs, score_tiles, tile_scores)

torch.set_num_threads(1)

TINY = {"num_layers": 2, "hidden_size": 32, "num_heads": 2,
        "intermediate_size": 64, "vocab_size": 100,
        "max_position_embeddings": 40}
NO_DROPOUT = {"hidden_dropout": 0.0, "attention_dropout": 0.0}
_JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16}
_TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _time_limit():
    """Pallas interpret mode re-enters JAX from its callbacks: should a
    test hang, print every thread's stack and end this worker after 300 s,
    so one test fails instead of the whole suite being cut."""
    faulthandler.dump_traceback_later(300, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()


def _attn_inputs(B, S, H, D, seed):
    """q, k, v, do ~ N(0, 1) and a mask: row 0 all padding (an empty MaxP
    chunk), row 1 unpadded, the rest ragged."""
    rs = np.random.RandomState(seed)
    q, k, v, do = (rs.randn(B, S, H, D).astype(np.float32) for _ in range(4))
    lengths = rs.randint(1, S + 1, B)
    lengths[0], lengths[1] = 0, S
    mask = (np.arange(S)[None, :] < lengths[:, None]).astype(np.int32)
    return q, k, v, do, mask


# -- kernel #3: the fused-attention backward ---------------------------------

@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,D", [(3, 64, 2, 16), (2, 40, 3, 8)])
def test_fused_backward_plain_matches_jax_kernel(kind, B, S, H, D):
    """The plain backward against ``_fused_backward`` run as the JAX tests
    run Pallas on the CPU: one jitted call with ``interpret=True``. fp32
    within the JAX attention tests' bounds (atol 3e-5, rtol 1e-4); bf16 by
    ``assert_bf16_slice_close`` (exp and the sums round differently, which
    can move a bf16 p or ds by one step)."""
    q, k, v, do, mask = _attn_inputs(B, S, H, D, seed=S)
    want = jax_fused_backward(*(jnp.asarray(a).astype(_JNP[kind])
                                for a in (q, k, v)), jnp.asarray(mask),
                              jnp.asarray(do).astype(_JNP[kind]),
                              interpret=True)
    got = fused_attention_backward(
        *(torch.as_tensor(a).to(_TORCH[kind]) for a in (q, k, v)),
        torch.as_tensor(mask, dtype=torch.int64),
        torch.as_tensor(do).to(_TORCH[kind]))  # CPU: the plain version
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == _TORCH[kind] and g.shape == (B, S, H, D)
        g = g.float().numpy()
        w = np.asarray(w.astype(jnp.float32))
        if kind == "f32":
            np.testing.assert_allclose(g, w, atol=3e-5, rtol=1e-4,
                                       err_msg=name)
        else:
            assert_bf16_slice_close(g, w, name)


KEY_BLOCK = 128  # keys a block of the keys kernel owns


def backward_schedule(q, k, v, mask, do):
    """Kernel #3's schedule, tile for tile. Rows kernel: loop A is the
    forward's ``row_stats`` with, rescaled beside l, the sum d of
    dp ⊙ exp(s − m), so delta = rowsum(dp ⊙ p) = d / l; loop B forms
    ds = p ⊙ (dp − delta) and dq += bf16(ds·scale)·k. Keys kernel: each
    block of 128 keys walks the
    64-query tiles with transposed scores sᵀ = k·qᵀ and dpᵀ = v·doᵀ, takes
    p from the rows kernel's m and l, and accumulates dv += bf16(pᵀ)·do and
    dk += bf16(dsᵀ·scale)·q. Returns (dq, dk, dv) [B, S, H, D]."""
    f32 = torch.float32
    B, S, H, D = q.shape
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=f32)
    bias = (1.0 - mask.to(f32)) * -1e9
    # rows: A, then B
    m = torch.full((B, H, S, 1), -math.inf)
    l = torch.zeros((B, H, S, 1))
    d = torch.zeros((B, H, S, 1))
    for t0, t1 in key_tiles(S):
        s = tile_scores(q, k, bias, t0, t1)
        dp = torch.einsum("bqhd,bkhd->bhqk", do.to(f32), v[:, t0:t1].to(f32))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        e = torch.exp(s - m_new)
        l = l * torch.exp(m - m_new) + e.sum(-1, keepdim=True)
        d = d * torch.exp(m - m_new) + (dp * e).sum(-1, keepdim=True)
        m = m_new
    assert all(torch.equal(a, b) for a, b in zip((m, l), row_stats(q, k, bias)))
    delta = d / l
    dq = torch.zeros(B, H, S, D)
    for t0, t1 in key_tiles(S):
        p = torch.exp(tile_scores(q, k, bias, t0, t1) - m) / l
        dp = torch.einsum("bqhd,bkhd->bhqk", do.to(f32), v[:, t0:t1].to(f32))
        dsb = (p * (dp - delta) * scale).to(q.dtype).to(f32)
        dq = dq + torch.einsum("bhqk,bkhd->bhqd", dsb, k[:, t0:t1].to(f32))
    # keys: the statistics as the keys kernel reads them, [B, H, 1, S]
    m_t, l_t, delta_t = (x.transpose(2, 3) for x in (m, l, delta))
    dk = torch.zeros(B, H, S, D)
    dv = torch.zeros(B, H, S, D)
    for k0 in range(0, S, KEY_BLOCK):
        k1 = min(k0 + KEY_BLOCK, S)
        for t0, t1 in key_tiles(S):  # query tiles
            st = tile_scores(k[:, k0:k1], q, torch.zeros_like(bias), t0, t1)
            st = st + bias[:, None, k0:k1, None]  # [B, H, keys, queries]
            pt = torch.exp(st - m_t[..., t0:t1]) / l_t[..., t0:t1]
            dpt = torch.einsum("bkhd,bqhd->bhkq", v[:, k0:k1].to(f32),
                               do[:, t0:t1].to(f32))
            dst = (pt * (dpt - delta_t[..., t0:t1]) * scale).to(q.dtype)
            dv[:, :, k0:k1] += torch.einsum(
                "bhkq,bqhd->bhkd", pt.to(v.dtype).to(f32),
                do[:, t0:t1].to(f32))
            dk[:, :, k0:k1] += torch.einsum(
                "bhkq,bqhd->bhkd", dst.to(f32), q[:, t0:t1].to(f32))
    return tuple(x.transpose(1, 2).to(q.dtype) for x in (dq, dk, dv))


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("S,strided", [(1, False), (63, True), (65, False),
                                       (300, True)])
def test_backward_schedule_matches_plain(kind, S, strided):
    """The rows kernel's two loops and the keys kernel's transposed
    scores give the plain backward's gradients: bf16 within
    ``assert_bf16_slice_close``, fp32 within 1e-5 (sums in other orders);
    at S = 300 the last 128-key block holds 44 keys."""
    q, k, v, mask = schedule_inputs(3, S, 2, 64, seed=S, kind=kind,
                                    strided=strided)
    do = torch.as_tensor(np.random.RandomState(S + 1).randn(3, S, 2, 64)
                         .astype(np.float32)).to(q.dtype)
    got = backward_schedule(q, k, v, mask, do)
    want = fused_attention_backward_reference(q, k, v, mask, do)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        if kind == "f32":
            torch.testing.assert_close(g, w, atol=1e-5, rtol=0, msg=name)
        else:
            assert_bf16_slice_close(g.float().numpy(), w.float().numpy(),
                                    name)


def backward_pieces_emulated(q, k, v, mask, do, fresh=True):
    """What ``fused_bwd_rows_pieces`` and ``fused_bwd_keys_pieces`` compute,
    on the CPU: s and dp per 64-key tile as fresh tile products of the
    bf16 pieces, truncated toward zero (``score_tiles``; the keys pass's
    sᵀ and dpᵀ are the same bits); the rows pass's running max, rescaled
    sum and rescaled sum d of dp ⊙ exp(s − m), delta = d / l; p =
    exp(s − m) / l and ds = p ⊙ (dp − delta)·scale in fp32; then dq = ds·k
    (rows pass), dv = pᵀ·do and dk = dsᵀ·q (keys pass, 64-query tiles),
    each a running fp32 total of its tiles' fresh products
    (``fresh=False``: one running accumulator). Returns (dq, dk, dv)."""
    B, S, H, D = q.shape
    bias = ((1.0 - mask.float()) * -1e9)[:, None, None, :]
    s = score_tiles(q, k, bias)
    dp = score_tiles(do, v, torch.zeros_like(bias)) * 8.0  # unscaled
    m = torch.full((B, H, S, 1), -math.inf)
    l = torch.zeros((B, H, S, 1))
    d = torch.zeros((B, H, S, 1))
    for t0, t1 in key_tiles(S):
        m_new = torch.maximum(m, s[..., t0:t1].amax(-1, keepdim=True))
        e = torch.exp(s[..., t0:t1] - m_new)
        a = torch.exp(m - m_new)
        l = l * a + e.sum(-1, keepdim=True)
        d = d * a + (dp[..., t0:t1] * e).sum(-1, keepdim=True)
        m = m_new
    p = torch.exp(s - m) / l
    ds = p * (dp - d / l) * 0.125
    qh, kh, oh = (t.transpose(1, 2).float() for t in (q, k, do))
    dq = running_product(ds, kh, fresh)
    dv = running_product(p.transpose(-1, -2), oh, fresh)
    dk = running_product(ds.transpose(-1, -2), qh, fresh)
    return tuple(x.transpose(1, 2) for x in (dq, dk, dv))


@pytest.mark.parametrize("S,strided", [(65, True), (300, False),
                                       (512, False), (512, True)])
def test_fp32_pieces_backward_emulated_matches_plain_and_jax(S, strided):
    """The fp32 backward's arithmetic (pieces, products smallest first,
    each tile's accumulator truncated toward zero, the rows pass and the
    keys pass) within 1e-5 of the plain version (chip_smoke.py's fp32
    tolerance) and of ``_fused_backward`` in interpret mode, with a fully
    masked row 0 and, at S = 65 and one S = 512, the qkv.chunk views."""
    q, k, v, mask = schedule_inputs(3, S, 2, 64, seed=S, kind="f32",
                                    strided=strided)
    do = torch.as_tensor(np.random.RandomState(S + 1).randn(3, S, 2, 64)
                         .astype(np.float32))
    got = backward_pieces_emulated(q, k, v, mask, do)
    want = fused_attention_backward_reference(q, k, v, mask, do)
    jax_grads = jax_fused_backward(
        *(jnp.asarray(t.contiguous().numpy()) for t in (q, k, v)),
        jnp.asarray(mask.numpy()), jnp.asarray(do.numpy()), interpret=True)
    for name, g, w, j in zip(("dq", "dk", "dv"), got, want, jax_grads):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0, msg=name)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=1e-5,
                                   rtol=0, err_msg=name)


def test_fp32_pieces_backward_needs_a_fresh_accumulator():
    """Why a fresh accumulator a tile in the backward too: 128 valid keys a
    row and same-signed output gradients give dv up to ~5.5 summed over
    512 queries, every partial sum growing one way; one running
    accumulator's truncated updates drift dk and dv beyond the 1e-5
    tolerance (2.5e-5, 2.7e-5 here), the tiles' fresh sums added to
    nearest stay within half of it."""
    q, k, v, mask = schedule_inputs(2, 512, 2, 64, seed=11, kind="f32",
                                    strided=False)
    mask = (torch.arange(512)[None] < 128).long().expand(2, 512)
    do = 0.5 + torch.as_tensor(np.random.RandomState(12).rand(2, 512, 2, 64)
                               .astype(np.float32))
    want = fused_attention_backward_reference(q, k, v, mask, do)
    got = backward_pieces_emulated(q, k, v, mask, do)
    one = backward_pieces_emulated(q, k, v, mask, do, fresh=False)
    assert float(want[2].abs().max()) > 4
    for i in (1, 2):  # dk, dv
        assert float((got[i] - want[i]).abs().max()) < 1e-5 / 2
        assert float((one[i] - want[i]).abs().max()) > 1e-5


@pytest.mark.parametrize("with_mask", [True, False])
def test_fused_function_gradients_on_cpu(with_mask):
    """The autograd ``Function`` on CPU tensors: its forward is the plain
    forward, bit for bit; its gradients are the plain backward's, bit for
    bit, and equal autograd through the plain forward within 1e-5 (fp32;
    the kernel's delta = rowsum(dp ⊙ p) form against autograd's softmax
    backward)."""
    q, k, v, do, mask = _attn_inputs(3, 24, 2, 8, seed=5)
    mask = torch.as_tensor(mask, dtype=torch.int64) if with_mask else None
    leaves = [torch.as_tensor(a).requires_grad_() for a in (q, k, v)]
    out = fused_attention(*leaves, mask)
    assert torch.equal(out, fused_attention_reference(*leaves, mask))
    grads = torch.autograd.grad(out, leaves, torch.as_tensor(do))
    want = fused_attention_backward_reference(
        *(t.detach() for t in leaves), mask, torch.as_tensor(do))
    for g, w in zip(grads, want):
        assert torch.equal(g, w)
    auto = torch.autograd.grad(fused_attention_reference(*leaves, mask),
                               leaves, torch.as_tensor(do))
    for g, w in zip(grads, auto):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)


def test_flash_function_gradient_is_the_einsum_vjp():
    """Flash's backward is the VJP of the fp32-softmax einsum attention, as
    the JAX ``custom_vjp`` defines it: equal to autograd through
    ``fused_attention_reference`` on fp32."""
    from ance_tpu_torch.ops.flash_attention import flash_attention
    q, k, v, do, mask = _attn_inputs(2, 16, 2, 8, seed=6)
    leaves = [torch.as_tensor(a).requires_grad_() for a in (q, k, v)]
    m = torch.as_tensor(mask, dtype=torch.int64)
    got = torch.autograd.grad(flash_attention(*leaves, m), leaves,
                              torch.as_tensor(do))
    want = torch.autograd.grad(fused_attention_reference(*leaves, m), leaves,
                               torch.as_tensor(do))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=0)


# -- losses ------------------------------------------------------------------

def test_losses_and_their_gradients_match_jax():
    """NLL and MaxP losses: values within 1e-5 and gradients within 1e-6
    (fp32). Document 0 has dead chunks 1 and 2, and document 1 two chunks
    with equal scores (``amax`` shares the gradient between them, as
    ``jnp.max`` does)."""
    rs = np.random.RandomState(0)
    B, C, L, D = 4, 3, 5, 8
    q, pos, neg = (rs.randn(B, D).astype(np.float32) for _ in range(3))
    pc, nc = (rs.randn(B, C, D).astype(np.float32) for _ in range(2))
    pc[1, 2] = pc[1, 0]
    pm = np.ones((B, C * L), np.int32)
    pm[0, L:] = 0
    nm = np.ones((B, C * L), np.int32)
    nm[2, 2 * L:] = 0
    # NLL
    jl, jg = jax.value_and_grad(jax_losses.nll_triplet_loss, (0, 1, 2))(
        q, pos, neg)
    ts = [torch.as_tensor(a).requires_grad_() for a in (q, pos, neg)]
    pl = losses.nll_triplet_loss(*ts)
    pg = torch.autograd.grad(pl, ts)
    np.testing.assert_allclose(pl.item(), float(jl), rtol=1e-5)
    for g, w in zip(pg, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    # MaxP scores and loss
    np.testing.assert_allclose(
        losses.multichunk_scores(torch.as_tensor(q), torch.as_tensor(pc),
                                 torch.as_tensor(pm)).numpy(),
        np.asarray(jax_losses.multichunk_scores(q, pc, pm)), atol=1e-5)

    def jax_mc(q, pc, nc):
        return jax_losses.nll_multichunk_loss(q, pc, pm, nc, nm)

    jl, jg = jax.value_and_grad(jax_mc, (0, 1, 2))(q, pc, nc)
    ts = [torch.as_tensor(a).requires_grad_() for a in (q, pc, nc)]
    pl = losses.nll_multichunk_loss(ts[0], ts[1], torch.as_tensor(pm), ts[2],
                                    torch.as_tensor(nm))
    pg = torch.autograd.grad(pl, ts)
    np.testing.assert_allclose(pl.item(), float(jl), rtol=1e-5)
    for g, w in zip(pg, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    assert losses.EMPTY_CHUNK_BIAS == jax_losses.EMPTY_CHUNK_BIAS == -9999.0


# -- dropout and remat -------------------------------------------------------

def test_dropout_keeps_the_right_share_with_inverted_scaling():
    """Philox and threefry draw other masks, so the distributions are
    compared: over 200,000 entries both keep 1 − p within 5 standard
    deviations, kept entries are exactly x / (1 − p), and the rest 0."""
    import flax.linen as fnn
    p, n = 0.1, 200_000
    x = np.full(n, 2.0, np.float32)
    jout = np.asarray(fnn.Dropout(p).apply(
        {}, jnp.asarray(x), deterministic=False,
        rngs={"dropout": jax.random.PRNGKey(0)}))
    pout = dropout(torch.as_tensor(x), p,
                   torch.Generator().manual_seed(0)).numpy()
    sigma = math.sqrt(p * (1 - p) / n)
    for out in (jout, pout):
        kept = out != 0
        assert abs(kept.mean() - (1 - p)) < 5 * sigma
        np.testing.assert_array_equal(out[kept], np.float32(2.0) /
                                      np.float32(1 - p))
    assert torch.equal(dropout(torch.as_tensor(x), p, None),
                       torch.as_tensor(x))


def test_attention_dropout_takes_the_einsum_path_and_drops_weights():
    """Dropout > 0 sends ``fused`` / ``auto`` to the einsum path (no kernel
    launch, as ``ance_tpu/ops/attention.py:102-103``); with all-ones v the
    output of a row is the kept share of its probability mass / (1 − p)."""
    q, k, _, _, mask = _attn_inputs(2, 64, 2, 8, seed=7)
    q, k = torch.as_tensor(q), torch.as_tensor(k)
    v = torch.ones_like(q)
    m = torch.as_tensor(mask, dtype=torch.int64)
    before = fused_attention.launches
    outs = [multi_head_attention(q, k, v, m, impl=impl, dropout_rate=0.5,
                                 generator=torch.Generator().manual_seed(3))
            for impl in ("fused", "auto", "xla")]
    assert fused_attention.launches == before
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    assert not torch.allclose(outs[0], torch.ones_like(outs[0]))
    assert abs(outs[0].mean().item() - 1.0) < 0.1


def _tiny_models(multichunk=False, overrides=NO_DROPOUT, port_impl="xla",
                 seed=0, base_len=16):
    jm = JaxRobertaDot(JaxConfig(attention_impl="xla", **TINY, **overrides),
                       base_len=base_len)
    ids = jnp.ones((2, 8), jnp.int32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed), ids, ids)["params"]
    params = jax.tree.map(np.asarray, params)
    pm = RobertaDot(EncoderConfig(attention_impl=port_impl, **TINY,
                                  **overrides), base_len=base_len)
    pm.load_state_dict(state_dict_from_flax(params), strict=True)
    return jm, params, pm


def _tokens(rs, n, seq, min_len=2):
    lengths = rs.randint(min_len, seq + 1, n)
    ids = rs.randint(3, TINY["vocab_size"], (n, seq)).astype(np.int32)
    ids[:, 0] = 0
    mask = (np.arange(seq)[None, :] < lengths[:, None]).astype(np.int32)
    return np.where(mask == 1, ids, 1).astype(np.int32), mask


def _batches(n, B, q_len, p_len, seed, multichunk):
    """Seeded triple batches; MaxP bodies are 2 chunks of 16, some with an
    all-padding second chunk."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        b = {}
        b["query_ids"], b["query_mask"] = _tokens(rs, B, q_len)
        for side in ("pos", "neg"):
            ids, mask = _tokens(rs, B, p_len, min_len=4 if multichunk else 2)
            b[f"{side}_ids"], b[f"{side}_mask"] = ids, mask
        out.append(b)
    return out


def test_remat_recomputes_with_the_same_dropout_masks():
    """``remat`` with dropout on: the same loss and gradients as without
    it, from the same generator seed (the recompute replays the masks)."""
    from ance_tpu_torch.train.trainer import triplet_loss_fn
    _, _, plain = _tiny_models(overrides={})
    remat = RobertaDot(EncoderConfig(remat=True, attention_impl="xla",
                                     **TINY), base_len=16)
    remat.load_state_dict(plain.state_dict())
    batch = {k: torch.as_tensor(v).long()
             for k, v in _batches(1, 4, 8, 16, 0, False)[0].items()}
    loss_fn = triplet_loss_fn()
    results = []
    for model in (plain, remat):
        model.train()
        loss = loss_fn(model, batch, torch.Generator().manual_seed(11))
        grads = torch.autograd.grad(loss, list(model.parameters()))
        results.append((loss, grads))
    (l0, g0), (l1, g1) = results
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    # and dropout is live: another seed gives another loss
    other = loss_fn(plain, batch, torch.Generator().manual_seed(12))
    assert not torch.equal(other, l0)


def test_eval_mode_ignores_the_generator():
    _, _, pm = _tiny_models(overrides={})
    ids, mask = (torch.as_tensor(a).long()
                 for a in _tokens(np.random.RandomState(1), 3, 8))
    pm.eval()
    with torch.inference_mode():
        a = pm.query_emb(ids, mask, torch.Generator().manual_seed(0))
        b = pm.query_emb(ids, mask)
    assert torch.equal(a, b)


# -- whole train steps -------------------------------------------------------

STEP_CASES = [  # (multichunk, accum_steps, fused_body, port attention, opt)
    (False, 1, False, "xla", "lamb"),
    (False, 2, False, "xla", "lamb"),
    (False, 1, True, "xla", "lamb"),
    (False, 1, False, "xla", "adamw"),
    (True, 1, False, "fused", "lamb"),
    (True, 2, True, "fused", "lamb"),
]


@pytest.mark.parametrize("multichunk,accum,fused_body,impl,opt", STEP_CASES)
def test_train_step_matches_jax(multichunk, accum, fused_body, impl, opt):
    """3 steps from the same weights and batches, dropout off: clip at 1.0,
    LAMB (weight decay 0.01 off biases and LayerNorms) or AdamW, under a
    warmup-linear schedule. MaxP runs the port's fused ``Function`` (its
    CPU backward is kernel #3's plain version) against JAX's einsum path.
    fp32 bounds: the loss of every step within 1e-4 + 1e-5 relative
    (scores are dot products of LayerNorm'd 768-d embeddings, |s| ~
    10²-10³, where an fp32 ulp reaches 6e-5) and its gradient norm within
    1e-4 relative; every parameter after the last step within 2e-6,
    except the attention key biases (:func:`_assert_params_close`). The
    init is wide (0.2) so that the embeddings do not collapse (ROADMAP
    Queue 3)."""
    from ance_tpu.optim.schedules import warmup_linear as jax_warmup
    from ance_tpu.train import trainer as jax_trainer
    from ance_tpu_torch.optim.schedules import warmup_linear
    from ance_tpu_torch.train import trainer

    jm, params, pm = _tiny_models(
        multichunk, overrides=dict(NO_DROPOUT, initializer_range=0.2),
        port_impl=impl)
    init = state_dict_from_flax(params)
    batches = _batches(3, 4, 8, 32 if multichunk else 16, 1, multichunk)
    kw = dict(eps=1e-8, weight_decay=0.01, max_grad_norm=1.0)
    jopt = jax_trainer.make_optimizer(opt, jax_warmup(2e-3, 2, 6), **kw)
    jstep = jax_trainer.make_train_step(
        jax_trainer.triplet_loss_fn(jm, multichunk=multichunk,
                                    fused_body=fused_body), jopt,
        accum_steps=accum)
    jstate = jax_trainer.init_train_state(jax.tree.map(jnp.asarray, params),
                                          jopt)
    pstate = trainer.init_train_state(pm, trainer.make_optimizer(
        pm, opt, warmup_linear(2e-3, 2, 6), **kw))
    pstep = trainer.make_train_step(
        trainer.triplet_loss_fn(multichunk=multichunk,
                                fused_body=fused_body), accum_steps=accum)
    gen = torch.Generator().manual_seed(0)
    for i, batch in enumerate(batches):
        jstate, jmetrics = jstep(jstate, batch, jax.random.PRNGKey(i))
        pstate, pmetrics = pstep(pstate, batch, gen)
        np.testing.assert_allclose(pmetrics["loss"].item(),
                                   float(jmetrics["loss"]), atol=1e-4,
                                   rtol=1e-5)
        np.testing.assert_allclose(pmetrics["grad_norm"].item(),
                                   float(jmetrics["grad_norm"]), rtol=1e-4)
    assert pstate.step == int(jstate.step) == 3
    want = state_dict_from_flax(jax.tree.map(np.asarray, jstate.params))
    _assert_params_close(pm.state_dict(), want, lr_sum=3e-3)
    moved = max(float((want[k] - init[k]).abs().max()) for k in want)
    assert moved > 1e-3  # the steps did move the weights


def _assert_params_close(got, want, lr_sum, atol=2e-6, share=0.0):
    """Every parameter within ``atol`` but the attention key biases and at
    most ``share`` of all entries, and every entry within the Adam-step
    bound. A key bias's true gradient is 0 (softmax ignores a shift shared
    by a row's logits), and other entries can have gradients that cancel
    to nearly 0; Adam and LAMB (trust ratio 1 on a zero-initialised bias)
    divide by |g| and turn such rounding noise into steps of up to
    (1 − b1)/√(1 − b2) ≈ 3.2 × lr of unknown sign. The bound is twice
    that over the steps' summed rates ``lr_sum``."""
    bound = 2 * 3.2 * lr_sum
    outside, total = 0, 0
    for key, w in want.items():
        diff = (torch.as_tensor(got[key]) - torch.as_tensor(w)).abs()
        assert float(diff.max()) <= bound, key
        if not key.endswith("attention.self.key.bias"):
            outside += int((diff > atol).sum())
            total += diff.numel()
    assert outside <= share * total, f"{outside} of {total} entries differ"


def test_accumulation_equals_one_big_batch():
    """accum 2 on a batch of 4 against accum 1 on it, without dropout: the
    same loss and the same (clipped) gradients within fp32 rounding, the
    micro-batch losses and gradients averaged. Gradients, not updated
    weights, are compared: Adam's first step divides by |g| and so blows
    the rounding of a near-zero gradient up to a full step."""
    from ance_tpu_torch.train import trainer
    results = []
    for accum in (1, 2):
        _, _, pm = _tiny_models(overrides=dict(NO_DROPOUT,
                                               initializer_range=0.2))
        state = trainer.init_train_state(pm, trainer.make_optimizer(
            pm, "lamb", 0.0))
        step = trainer.make_train_step(trainer.triplet_loss_fn(),
                                       accum_steps=accum)
        state, m = step(state, _batches(1, 4, 8, 16, 2, False)[0],
                        torch.Generator().manual_seed(0))
        results.append((m, {n: p.grad for n, p in pm.named_parameters()}))
    (m1, g1), (m2, g2) = results
    np.testing.assert_allclose(m2["loss"].item(), m1["loss"].item(),
                               rtol=1e-6)
    np.testing.assert_allclose(m2["grad_norm"].item(),
                               m1["grad_norm"].item(), rtol=1e-5)
    for n in g1:
        torch.testing.assert_close(g2[n], g1[n], atol=1e-6, rtol=1e-5)


# -- on the card -------------------------------------------------------------

def backward_fp64(q, k, v, mask, do):
    """The fp32 backward's function evaluated in fp64 (the pieces route's
    yardstick): masked keys weigh 0, a fully masked row weighs every key
    alike, as the fp32 function's s rounds to -1e9 on every key. The fp32
    plain version's 512-deep sums are themselves up to ~4e-5 from it on a
    row of a few valid keys, where the CUDA-core kernels, summing in
    cuBLAS's order, follow it and the pieces kernels do not.
    Returns fp64 (dq, dk, dv)."""
    f64 = torch.float64
    qd, kd, vd, dd = (t.to(f64) for t in (q, k, v, do))
    s = torch.einsum("bqhd,bkhd->bhqk", qd, kd) / math.sqrt(q.shape[-1])
    valid = mask.bool()[:, None, None, :].expand_as(s)
    empty = ~valid.any(-1, keepdim=True).expand_as(s)
    s = torch.where(valid, s, torch.where(empty, torch.zeros_like(s),
                                          torch.full_like(s, -math.inf)))
    p = torch.softmax(s, -1)
    dp = torch.einsum("bqhd,bkhd->bhqk", dd, vd)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) / math.sqrt(q.shape[-1])
    return (torch.einsum("bhqk,bkhd->bqhd", ds, kd),
            torch.einsum("bhqk,bqhd->bkhd", ds, qd),
            torch.einsum("bhqk,bqhd->bkhd", p, dd))


def test_backward_fp64_is_the_plain_backward():
    """The fp64 yardstick computes the plain backward's function: within
    fp32 rounding of it, the fully masked row included."""
    q, k, v, do, mask = (torch.as_tensor(a) for a in
                         _attn_inputs(3, 40, 2, 64, seed=3))
    want = fused_attention_backward_reference(q, k, v, mask, do)
    for g, w in zip(backward_fp64(q, k, v, mask, do), want):
        torch.testing.assert_close(g.float(), w, atol=2e-6, rtol=0)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("S,strided", [(1, False), (64, False), (65, True),
                                       (256, False), (300, False),
                                       (512, True), (1024, False)])
def test_fused_backward_kernel_matches_plain_on_cuda(kind, S, strided):
    """Kernel #3 against its plain version at H = 12, D = 64, a fully
    masked row and ragged lengths, q/k/v also as strided chunks of one
    fused-QKV projection: bf16 by ``assert_bf16_slice_close``, fp32 (the
    pieces route) within 1e-5 of the function in fp64
    (``backward_fp64``); a second call gives the same bits (no
    atomics)."""
    dev = _cuda()
    q, k, v, do, mask = (torch.as_tensor(a).to(dev) for a in
                         _attn_inputs(4, S, 12, 64, seed=S))
    q, k, v, do = (t.to(_TORCH[kind]) for t in (q, k, v, do))
    if strided:
        qkv = torch.cat([q, k, v], dim=-1).reshape(4, S, 3 * 768)
        q, k, v = (t.reshape(4, S, 12, 64) for t in qkv.chunk(3, dim=-1))
        assert not q.is_contiguous()
    before = fused_attention_backward.launches
    got = fused_attention_backward(q, k, v, mask, do)
    assert fused_attention_backward.launches == before + 1
    again = fused_attention_backward(q, k, v, mask, do)
    want = fused_attention_backward_reference(q, k, v, mask, do)
    if kind == "f32":
        want = backward_fp64(q, k, v, mask, do)
    torch.cuda.synchronize()
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        if kind == "f32":
            torch.testing.assert_close(g.double(), w, atol=1e-5, rtol=0)
        else:
            assert_bf16_slice_close(g.float().cpu(), w.float().cpu(), name)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [65, 512])
@pytest.mark.parametrize("layout", ["contiguous", "qkv.chunk", "misaligned"])
def test_fused_backward_fp32_routes_on_cuda(layout, S):
    """The fp32 backward on the route ``fused_kernel_for`` names (the
    pieces kernels, or the CUDA-core pair for rows off alignment), each
    call counted under it, the same bits from a second call, within 1e-5
    of its yardstick: the function in fp64 for the pieces kernels, the
    fp32 plain version (whose summation order they share) for the
    CUDA-core pair."""
    dev = _cuda()
    q, k, v, do = fp32_operands(4, S, layout, dev, seed=S, n=4)
    mask = torch.as_tensor(_attn_inputs(4, S, 1, 1, seed=S)[-1]).to(dev)
    kernel = "fused_bwd_f32" if layout == "misaligned" else "fused_bwd_pieces"
    assert fused_kernel_for(q, k, v, backward=True) == kernel
    counts = fused_attention_backward.kernel_launches
    before = counts[kernel]
    got = fused_attention_backward(q, k, v, mask, do)
    again = fused_attention_backward(q, k, v, mask, do)
    assert counts[kernel] == before + 2
    want = fused_attention_backward_reference(q, k, v, mask, do)
    if kernel == "fused_bwd_pieces":
        want = backward_fp64(q, k, v, mask, do)
    for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
        assert torch.equal(g, a), name
        torch.testing.assert_close(g.to(w.dtype), w, atol=1e-5, rtol=0,
                                   msg=name)


@pytest.mark.cuda
def test_fused_function_on_cuda_and_its_limits():
    """Forward and backward kernels through autograd, each launched once,
    the same bits from a second pass; S beyond MAX_SEQ_BACKWARD raises in
    the backward."""
    dev = _cuda()
    q, k, v, do, mask = (torch.as_tensor(a).to(dev) for a in
                         _attn_inputs(2, 512, 12, 64, seed=1))
    leaves = [t.to(torch.bfloat16).requires_grad_() for t in (q, k, v)]
    f0, b0 = fused_attention.launches, fused_attention_backward.launches
    out = fused_attention(*leaves, mask)
    grads = torch.autograd.grad(out, leaves, do.to(torch.bfloat16))
    assert (fused_attention.launches, fused_attention_backward.launches) == \
        (f0 + 1, b0 + 1)
    want = fused_attention_backward_reference(
        *(t.detach() for t in leaves), mask, do.to(torch.bfloat16))
    for name, g, w in zip(("dq", "dk", "dv"), grads, want):
        assert_bf16_slice_close(g.float().cpu(), w.float().cpu(), name)
    again = torch.autograd.grad(fused_attention(*leaves, mask), leaves,
                                do.to(torch.bfloat16))
    for g, a in zip(grads, again):
        assert torch.equal(g, a)
    long = torch.zeros(1, MAX_SEQ_BACKWARD + 64, 1, 64, device=dev,
                       dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="sequence length"):
        fused_attention_backward(long, long, long, None, long)
