"""The port's attention (plain versions, dispatch, kernel wrappers) against
the JAX package's fused and flash attention, on the same numpy inputs.

On the CPU the port's ``fused`` / ``flash`` run their plain versions; the
JAX kernels run as the JAX package's own tests run them (Pallas interpret
mode). The ``cuda`` tests hold the hand-written kernels to those plain
versions on the card and skip elsewhere."""

import faulthandler
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ance_tpu.ops.flash_attention import flash_attention as jax_flash
from ance_tpu.ops.fused_attention import _fused_forward as jax_fused_forward
from ance_tpu_torch.ops.attention import (kernel_operands, mask_to_bias,
                                          multi_head_attention, xla_attention)
from ance_tpu_torch.ops.flash_attention import (flash_attention,
                                                flash_attention_reference,
                                                flash_kernel_for)
from ance_tpu_torch.ops.fused_attention import (fused_attention,
                                                fused_attention_reference,
                                                fused_kernel_for)
from ance_tpu_torch.ops.topk import split_bf16_pieces

torch.set_num_threads(1)

_JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16}
_TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}


def _inputs(B, S, H, D, seed):
    """q, k, v ~ N(0, 1) and a mask with ragged lengths, row 0 fully
    masked (an all-padding MaxP chunk) and row 1 unpadded."""
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(B, S, H, D).astype(np.float32) for _ in range(3))
    lengths = rs.randint(1, S + 1, B)
    lengths[0], lengths[1] = 0, S
    mask = (np.arange(S)[None, :] < lengths[:, None]).astype(np.int32)
    return q, k, v, mask


def _both(arrays, kind):
    """numpy arrays → (jax arrays, torch tensors) in ``kind``; the int mask
    (last) stays int."""
    *qkv, mask = arrays
    js = [jnp.asarray(a).astype(_JNP[kind]) for a in qkv] + [jnp.asarray(mask)]
    ts = [torch.as_tensor(a).to(_TORCH[kind]) for a in qkv] + [
        torch.as_tensor(mask, dtype=torch.int64)]
    return js, ts


def _bf16_ulps(x: np.ndarray, n: int) -> float:
    """n bf16 ulps at max |x| (8 significant bits)."""
    top = float(np.abs(x).max())
    return n * 2.0 ** (math.floor(math.log2(top)) - 7)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp (8 significant bits) of each |x|; 0 where x is 0."""
    x = np.abs(np.asarray(x, np.float32))
    _, e = np.frexp(x)
    return np.where(x > 0, np.ldexp(1.0, e - 8), 0.0)


def assert_bf16_slice_close(got, want, what=""):
    """bf16 attention outputs or gradients [B, S, H, D]: each element within
    2 ulps of its own |want| plus 2 of the largest |want| in its (batch row,
    head) slice. Slices differ in scale by up to ~100x (a row of 1-3 valid
    keys: its output is one v row, its dk and dv sum over every query), so
    a bound from the whole tensor's max would not see the ordinary rows."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    tol = 2 * _bf16_ulp(want) + 2 * _bf16_ulp(
        np.abs(want).max(axis=(1, 3), keepdims=True))
    err = np.abs(got - want)
    assert (err <= tol).all(), (f"{what}: {(err > tol).sum()} elements "
                                f"beyond the bound, worst |err| {err.max()}")


def _assert_close(got, want, kind):
    got = got.to(torch.float32).numpy()
    want = np.asarray(want.astype(jnp.float32))
    assert got.shape == want.shape and np.isfinite(got).all()
    if kind == "f32":
        # the JAX attention tests' own bounds (tests/test_fused_attention.py)
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)
    else:
        # bf16 output: exp and the sums round differently in XLA and torch,
        # which can move a bf16 probability (fused) or the output by one
        # rounding step
        assert_bf16_slice_close(got, want)


@pytest.fixture(autouse=True)
def _time_limit():
    """Pallas interpret mode re-enters JAX from its callbacks: should a
    test hang, print every thread's stack and end this worker after 300 s,
    so one test fails instead of the whole suite being cut."""
    faulthandler.dump_traceback_later(300, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,D", [(3, 64, 2, 16), (2, 40, 3, 8)])
def test_fused_plain_matches_jax_kernel(kind, B, S, H, D):
    (jq, jk, jv, jm), (q, k, v, m) = _both(_inputs(B, S, H, D, seed=S), kind)
    want = jax_fused_forward(jq, jk, jv, jm, interpret=True)
    got = fused_attention(q, k, v, m)  # CPU tensor: the plain version
    _assert_close(got, want, kind)
    # the fully masked row attends uniformly: the mean of v over all keys
    torch.testing.assert_close(
        got[0].float(), v[0].float().mean(0, keepdim=True).expand(S, H, D)
        .to(v.dtype).float(), atol=_bf16_ulps(v[0].float().numpy(), 1)
        if kind == "bf16" else 1e-6, rtol=0)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,D,block", [(3, 64, 2, 16, 32),
                                           (2, 40, 3, 8, 256)])
def test_flash_plain_matches_jax_kernel(kind, B, S, H, D, block):
    from jax.experimental.pallas import tpu as pltpu
    (jq, jk, jv, jm), (q, k, v, m) = _both(_inputs(B, S, H, D, seed=S + 1),
                                           kind)
    flash = jax.jit(jax_flash, static_argnums=(4, 5))
    with pltpu.force_tpu_interpret_mode():  # one jitted call, no eager JAX
        want = flash(jq, jk, jv, jm, block, block)
    got = flash_attention(q, k, v, m)  # CPU tensor: the plain version
    _assert_close(got, want, kind)


def test_flash_and_fused_are_different_functions():
    """bf16: fused rounds p to bf16 before PV, flash keeps it fp32; on the
    same inputs the two differ (but agree to bf16 precision)."""
    _, (q, k, v, m) = _both(_inputs(2, 64, 2, 16, seed=5), "bf16")
    fused = fused_attention_reference(q, k, v, m).float()
    flash = flash_attention_reference(q, k, v, m).float()
    assert not torch.equal(fused, flash)
    torch.testing.assert_close(fused, flash, rtol=0,
                               atol=_bf16_ulps(flash.numpy(), 4))


@pytest.mark.parametrize("S,kind,want_softmax", [
    (128, "f32", "xla"), (128, "bf16", "xla_bf16"),
    (512, "f32", "xla"), (512, "bf16", "xla_bf16"), (2048, "bf16", "xla_bf16")])
def test_auto_on_cpu_takes_the_einsum_path(S, kind, want_softmax):
    """On a CPU tensor ``auto`` is the einsum path at every length (the JAX
    package's choice off the TPU), with a bf16 softmax for bf16 inputs."""
    _, (q, k, v, m) = _both(_inputs(2, S, 1, 8, seed=1), kind)
    softmax = torch.bfloat16 if want_softmax == "xla_bf16" else torch.float32
    want = xla_attention(q, k, v, mask_to_bias(m), softmax_dtype=softmax)
    before = (fused_attention.launches, flash_attention.launches)
    assert torch.equal(multi_head_attention(q, k, v, m, impl="auto"), want)
    assert (fused_attention.launches, flash_attention.launches) == before


@pytest.mark.parametrize("impl", ["fused", "flash"])
def test_explicit_kernel_impl_on_cpu_takes_its_plain_version(impl):
    _, (q, k, v, m) = _both(_inputs(2, 32, 2, 8, seed=2), "bf16")
    plain = {"fused": fused_attention_reference,
             "flash": flash_attention_reference}[impl]
    assert torch.equal(multi_head_attention(q, k, v, m, impl=impl),
                       plain(q, k, v, m))
    assert torch.equal(multi_head_attention(q, k, v, None, impl=impl),
                       plain(q, k, v, None))


def test_unknown_impl_raises():
    x = torch.zeros(1, 4, 1, 8)
    with pytest.raises(ValueError, match="unknown attention impl"):
        multi_head_attention(x, x, x, impl="sdpa")


@pytest.mark.parametrize("case,error,match", [
    ("shape", ValueError, "one shape"),
    ("dtype", TypeError, "float32 or bfloat16"),
    ("mixed_dtype", TypeError, "float32 or bfloat16"),
    ("device", ValueError, "CUDA device"),
    ("strides", ValueError, "one set of strides"),
    ("misaligned", ValueError, "16-byte-aligned rows"),
])
def test_kernel_operands_raise_on_what_the_kernels_do_not_take(case, error,
                                                               match):
    """The wrapper checks run before any launch; on a CPU tensor the last
    of them (the device) is what stops the kernel path. ``misaligned``:
    bf16 rows 2 bytes off, which the TMA boxes of the bf16 fused and
    flash kernels refuse (both wrappers pass ``align16`` for bf16)."""
    q = torch.zeros(2, 8, 2, 64)
    k, v = q.clone(), q.clone()
    if case == "shape":
        k = torch.zeros(2, 8, 2, 32)
    elif case == "dtype":
        q, k, v = (t.to(torch.float16) for t in (q, k, v))
    elif case == "mixed_dtype":
        k = k.to(torch.bfloat16)
    elif case == "strides":
        k = torch.zeros(2, 2, 8, 64).transpose(1, 2)
    elif case == "misaligned":
        q = k = v = torch.zeros(2, 8, 2, 66, dtype=torch.bfloat16)[..., 1:65]
    with pytest.raises(error, match=match):
        kernel_operands(q, k, v, None, name="test",
                        align16=q.dtype == torch.bfloat16)


# -- the bf16 kernel's schedule, tile for tile, on the CPU ---------------------

KEY_TILE = 64  # keys a wgmma score tile holds (csrc/fused_attention.cu)


def schedule_inputs(B, S, H, D, seed, kind, strided):
    """``_inputs`` as torch tensors in ``kind``; with ``strided``, q, k and
    v are the three chunks of one [B, S, 3·H·D] fused-QKV projection, the
    views the encoder hands the kernel."""
    q, k, v, mask = _inputs(B, S, H, D, seed)
    if strided:
        qkv = torch.as_tensor(np.concatenate([q, k, v], axis=-1).reshape(
            B, S, 3 * H * D)).to(_TORCH[kind])
        q, k, v = (t.view(B, S, H, D) for t in qkv.chunk(3, dim=-1))
        assert not q.is_contiguous()
    else:
        q, k, v = (torch.as_tensor(a).to(_TORCH[kind]) for a in (q, k, v))
    return q, k, v, torch.as_tensor(mask, dtype=torch.int64)


def key_tiles(S):
    return [(t, min(t + KEY_TILE, S)) for t in range(0, S, KEY_TILE)]


def tile_scores(a, b, bias, t0, t1):
    """fp32(a · b[t0:t1]ᵀ) · scale + bias, two roundings: [B, H, S, keys]."""
    f32 = torch.float32
    scale = torch.tensor(1.0 / math.sqrt(a.shape[-1]), dtype=f32)
    s = torch.einsum("bqhd,bkhd->bhqk", a.to(f32), b[:, t0:t1].to(f32))
    return s * scale + bias[:, None, None, t0:t1]


def row_stats(q, k, bias):
    """Pass 1 of the forward and loop A of the backward's rows kernel: the
    exact running row max m, and the sum l of exp(s − m) rescaled by
    exp(m_old − m_new) whenever a tile raises the max. [B, H, S, 1] each."""
    B, S, H, _ = q.shape
    m = torch.full((B, H, S, 1), -math.inf)
    l = torch.zeros((B, H, S, 1))
    for t0, t1 in key_tiles(k.shape[1]):
        s = tile_scores(q, k, bias, t0, t1)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        l = l * torch.exp(m - m_new) + torch.exp(s - m_new).sum(-1, keepdim=True)
        m = m_new
    return m, l


def forward_schedule(q, k, v, mask):
    """Kernel #2's schedule: pass 1 (``row_stats``), then per key tile s
    again, p = exp(s − m) / l rounded to the input dtype, o += p·v in
    fp32."""
    f32 = torch.float32
    bias = (1.0 - mask.to(f32)) * -1e9
    m, l = row_stats(q, k, bias)
    o = torch.zeros(q.shape[0], q.shape[2], q.shape[1], q.shape[3])
    for t0, t1 in key_tiles(k.shape[1]):
        p = (torch.exp(tile_scores(q, k, bias, t0, t1) - m) / l).to(v.dtype)
        o = o + torch.einsum("bhqk,bkhd->bhqd", p.to(f32), v[:, t0:t1].to(f32))
    return o.transpose(1, 2).to(q.dtype)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("S,strided", [(1, False), (63, True), (65, False),
                                       (300, True)])
def test_two_pass_forward_schedule_matches_plain(kind, S, strided):
    """The running max and rescaled running sum over 64-key tiles, then
    bf16 p from the final m and l, give the plain forward's output: bf16
    within ``assert_bf16_slice_close``, fp32 within 2e-6 (the sum taken in
    another order); the fully masked row 0 comes out as the mean of v."""
    q, k, v, mask = schedule_inputs(3, S, 2, 64, seed=S, kind=kind,
                                    strided=strided)
    got = forward_schedule(q, k, v, mask)
    want = fused_attention_reference(q, k, v, mask)
    assert got.shape == want.shape and got.dtype == want.dtype
    if kind == "f32":
        torch.testing.assert_close(got, want, atol=2e-6, rtol=0)
    else:
        assert_bf16_slice_close(got.float().numpy(), want.float().numpy(),
                                "schedule")
    mean_v = v[0].float().mean(0, keepdim=True).expand(S, 2, 64)
    torch.testing.assert_close(got[0].float(), mean_v.to(v.dtype).float(),
                               atol=_bf16_ulps(mean_v.numpy(), 1)
                               if kind == "bf16" else 1e-6, rtol=0)


# -- the fp32 pieces route's arithmetic (csrc/fused_attention.cu), on the CPU --

# fused_*_pieces' piece products (A piece, B piece) in issue order, the
# smallest first; each is issued for the four k-steps of 16 of a 64-deep
# tile
PIECE_PRODUCTS = ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))


def toward_zero(x):
    """fp64 ``x`` rounded to fp32 toward zero, as the tensor cores' fp32
    accumulation rounds (it does not round to nearest)."""
    y = x.float()
    return torch.where(y.double().abs() > x.abs(),
                       torch.nextafter(y, torch.zeros_like(y)), y)


def tile_product(a, b, acc=None):
    """One tile product of the pieces kernels, a [..., M, K] · b [..., K, N]
    with K ≤ 64: both fp32 operands as their three bf16 pieces
    (``split_bf16_pieces``, the kernels' ``split3``); per piece product in
    issue order and per k-step of 16, one wgmma update: its 16 products
    summed exactly (fp64) and added to the accumulator rounded toward
    zero. The accumulator is fresh (``acc`` None: the first update
    overwrites it), as in the kernels, or, for contrast, a running one.
    A ragged tile's missing rows are the kernels' zero-filled ones and add
    nothing."""
    ap = split_bf16_pieces(a.float()).double()
    bp = split_bf16_pieces(b.float()).double()
    for i, j in PIECE_PRODUCTS:
        for k0 in range(0, a.shape[-1], 16):
            x = ap[i][..., k0:k0 + 16] @ bp[j][..., k0:k0 + 16, :]
            acc = toward_zero(x if acc is None else acc.double() + x)
    return acc


def running_product(a, b, fresh=True):
    """a [..., M, S] · b [..., S, N] over 64-deep tiles of S: each tile a
    fresh ``tile_product`` added to a running fp32 total rounded to
    nearest, as the kernels sum p·v, dq, dv and dk (``fresh=False``: every
    update into one running accumulator)."""
    total = None
    for t0, t1 in key_tiles(a.shape[-1]):
        if fresh:
            part = tile_product(a[..., t0:t1], b[..., t0:t1, :])
            total = part if total is None else total + part
        else:
            total = tile_product(a[..., t0:t1], b[..., t0:t1, :], acc=total)
    return total


def score_tiles(a, b, bias):
    """s = (a·bᵀ)·scale + bias [B, H, S, S] for a, b [B, S, H, 64], each
    64-key tile a fresh ``tile_product`` (the keys pass pairs its pieces
    so that its sᵀ = k·qᵀ takes the same updates in the same order: the
    same bits)."""
    ah, bh = a.transpose(1, 2).float(), b.transpose(1, 2).float()
    s = torch.cat([tile_product(ah, bh[:, :, t0:t1].transpose(-1, -2))
                   for t0, t1 in key_tiles(b.shape[1])], -1)
    return s * 0.125 + bias


def forward_pieces_emulated(q, k, v, mask, fresh=True):
    """What ``flash_fwd_pieces`` (the fp32 forward of both the flash and
    the fused attention) computes, on the CPU: per 64-key tile s = q·kᵀ,
    scale and that tile's 64 bias values (fp32; the producer streams them
    with the K and V tiles, so S has no cap), the online max and rescaled
    sum (l and the total times exp(m − m')), p = exp(s − m') in fp32, p·v
    as a fresh ``tile_product`` added to the total to nearest
    (``fresh=False``: into the running total); out = total / l.
    [B, S, H, D] fp32."""
    B, S, H, D = q.shape
    bias = ((1.0 - mask.float()) * -1e9)[:, None, None, :]
    qh, kh = q.transpose(1, 2).float(), k.transpose(1, 2).float()
    vh = v.transpose(1, 2).float()
    m = torch.full((B, H, S, 1), -math.inf)
    l = torch.zeros((B, H, S, 1))
    total = torch.zeros((B, H, S, D))
    for t0, t1 in key_tiles(S):
        s = tile_product(qh, kh[:, :, t0:t1].transpose(-1, -2)) * 0.125 \
            + bias[..., t0:t1]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        a = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * a + p.sum(-1, keepdim=True)
        total = total * a
        if fresh:
            total = total + tile_product(p, vh[:, :, t0:t1])
        else:
            total = tile_product(p, vh[:, :, t0:t1], acc=total)
        m = m_new
    return (total / l).transpose(1, 2)


@pytest.mark.parametrize("S,strided", [(65, True), (300, False),
                                       (512, False), (512, True)])
def test_fp32_pieces_forward_emulated_matches_plain_and_jax(S, strided):
    """The fp32 forward's arithmetic (pieces, products smallest first,
    each tile's accumulator truncated toward zero, one pass with an online
    softmax) within 1e-4 of the plain version (chip_smoke.py's fp32
    tolerance) and of the Pallas kernel in interpret mode; the fully
    masked row 0 is the mean of v."""
    q, k, v, mask = schedule_inputs(3, S, 2, 64, seed=S, kind="f32",
                                    strided=strided)
    got = forward_pieces_emulated(q, k, v, mask)
    want = fused_attention_reference(q, k, v, mask)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    jax_out = jax_fused_forward(*(jnp.asarray(t.contiguous().numpy())
                                  for t in (q, k, v)),
                                jnp.asarray(mask.numpy()), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_out), atol=1e-4,
                               rtol=0)
    torch.testing.assert_close(got[0], v[0].mean(0, keepdim=True).expand(
        S, 2, 64), atol=1e-5, rtol=0)


def test_fp32_pieces_forward_needs_a_fresh_accumulator():
    """Why a fresh accumulator a tile: with large same-signed values (v
    in [32, 36), every partial sum growing one way) the truncated updates
    of one running total (192 of them over 512 keys) drift toward zero by
    more than the 1e-4 tolerance (1.7e-4 here); the tiles' fresh sums
    added to nearest stay within half of it (3.1e-5: each tile's four
    (0, 0) updates still truncate, ~8 ulps of an output near 34)."""
    q, k, v, mask = schedule_inputs(2, 512, 2, 64, seed=7, kind="f32",
                                    strided=False)
    v = 32.0 + v.abs()
    mask = torch.ones_like(mask)
    want = fused_attention_reference(q, k, v, mask)
    got = forward_pieces_emulated(q, k, v, mask)
    one = forward_pieces_emulated(q, k, v, mask, fresh=False)
    assert float((got - want).abs().max()) < 1e-4 / 2
    assert float((one - want).abs().max()) > 1e-4


@pytest.mark.parametrize("S", [65, 300, 2100])
def test_flash_fp32_pieces_emulated_matches_plain_and_jax(S):
    """``flash_fwd_pieces``' arithmetic (pieces, fresh truncating
    accumulators, the bias streamed a 64-key tile at a time) against the
    flash plain version and the Pallas flash kernel (one jitted call in
    interpret mode, one block of S: the JAX kernel's blocks must divide S)
    within the JAX attention tests' fp32 bounds; S = 2100 is past the
    fused attention's 2048, which the streamed bias lifts. The fully
    masked row 0 is the mean of v."""
    from jax.experimental.pallas import tpu as pltpu
    q, k, v, mask = schedule_inputs(3, S, 1, 64, seed=S, kind="f32",
                                    strided=False)
    got = forward_pieces_emulated(q, k, v, mask)
    want = flash_attention_reference(q, k, v, mask)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5,
                               rtol=1e-4)
    flash = jax.jit(jax_flash, static_argnums=(4, 5))
    with pltpu.force_tpu_interpret_mode():  # one jitted call, no eager JAX
        jax_out = flash(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                        jnp.asarray(mask.numpy().astype(np.int32)), S, S)
    _assert_close(got, jax_out, "f32")
    torch.testing.assert_close(got[0], v[0].mean(0, keepdim=True).expand(
        S, 1, 64), atol=1e-5, rtol=0)


def test_flash_kernel_for_names_each_route():
    """bf16 takes ``flash_fwd_bf16``; fp32 ``flash_fwd_pieces`` where every
    row is 16-byte aligned (contiguous, or the encoder's qkv.chunk
    views), else the CUDA-core ``flash_fwd_f32``."""
    def ops(dtype, width=64, lo=0):
        x = torch.zeros(2, 8, 3, width, dtype=dtype)[..., lo:lo + 64]
        return x, x, x
    q, k, v, _ = schedule_inputs(2, 8, 2, 64, seed=0, kind="f32",
                                 strided=True)
    assert flash_kernel_for(*ops(torch.bfloat16)) == "flash_fwd_bf16"
    assert flash_kernel_for(*ops(torch.float32)) == "flash_fwd_pieces"
    assert flash_kernel_for(q, k, v) == "flash_fwd_pieces"
    assert flash_kernel_for(*ops(torch.float32, 66, 1)) == "flash_fwd_f32"
    assert flash_kernel_for(*ops(torch.float32, 66, 2)) == "flash_fwd_f32"


def test_fused_kernel_for_names_each_route():
    """bf16 takes the bf16 kernels; fp32 the pieces kernels where every
    row is 16-byte aligned (contiguous, or the encoder's qkv.chunk views),
    the forward's being the flash kernel ``flash_fwd_pieces``, else the
    CUDA-core kernels."""
    def ops(dtype, width=64, lo=0):
        x = torch.zeros(2, 8, 3, width, dtype=dtype)[..., lo:lo + 64]
        return x, x, x
    q, k, v, _ = schedule_inputs(2, 8, 2, 64, seed=0, kind="f32",
                                 strided=True)
    for backward, kind, pieces in ((False, "fwd", "flash_fwd_pieces"),
                                   (True, "bwd", "fused_bwd_pieces")):
        assert fused_kernel_for(*ops(torch.bfloat16),
                                backward=backward) == f"fused_{kind}_bf16"
        assert fused_kernel_for(*ops(torch.float32),
                                backward=backward) == pieces
        assert fused_kernel_for(q, k, v, backward=backward) == pieces
        assert fused_kernel_for(*ops(torch.float32, 66, 1),
                                backward=backward) == f"fused_{kind}_f32"


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["fused", "flash"])
@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("S,strided", [(1, False), (64, False), (65, True),
                                       (256, True), (300, False),
                                       (512, False), (2048, False),
                                       (1, True), (300, True), (2048, True)])
def test_attention_kernel_matches_plain_on_cuda(impl, kind, S, strided):
    """Each kernel against its plain version on the card: ragged S (one key
    tile, one key past a tile, 2048 = the fused forward's MAX_SEQ), a fully
    masked row, and q/k/v as strided chunks of one fused-QKV projection
    (the bf16 flash kernel's TMA maps at S 1, 65, 300 and 2048).
    bf16 by ``assert_bf16_slice_close``; fp32 within 1e-4 (summation order
    and expf against torch's exp)."""
    dev = _cuda()
    kernel, plain = {"fused": (fused_attention, fused_attention_reference),
                     "flash": (flash_attention, flash_attention_reference)}[impl]
    q, k, v, mask = _inputs(4, S, 12, 64, seed=S)
    if strided:
        qkv = np.concatenate([q, k, v], axis=-1).reshape(4, S, 3 * 768)
        ts = torch.as_tensor(qkv).to(dev, _TORCH[kind]).chunk(3, dim=-1)
        q, k, v = (t.reshape(4, S, 12, 64) for t in ts)
        assert not q.is_contiguous()
    else:
        q, k, v = (torch.as_tensor(a).to(dev, _TORCH[kind]) for a in (q, k, v))
    mask = torch.as_tensor(mask).to(dev)
    before = kernel.launches
    got = kernel(q, k, v, mask)
    assert kernel.launches == before + 1
    want = plain(q, k, v, mask).float()
    torch.cuda.synchronize()
    if kind == "f32":
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    else:
        assert_bf16_slice_close(got.float().cpu(), want.cpu(), impl)


def fp32_operands(B, S, layout, dev, seed, n=3):
    """n fp32 [B, S, 12, 64] operands on ``dev`` sharing one layout:
    contiguous, the chunks of one fused projection (``qkv.chunk``), or
    rows 4 bytes off 16-byte alignment (``misaligned``: views into
    [..., 66] tensors)."""
    rs = np.random.RandomState(seed)
    if layout == "qkv.chunk":
        x = torch.as_tensor(rs.randn(B, S, n * 768).astype(np.float32))
        return [t.reshape(B, S, 12, 64) for t in x.to(dev).chunk(n, dim=-1)]
    width = 66 if layout == "misaligned" else 64
    return [torch.as_tensor(rs.randn(B, S, 12, width).astype(np.float32))
            .to(dev)[..., width - 64:] for _ in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("S", [300, 512])
@pytest.mark.parametrize("layout", ["contiguous", "qkv.chunk", "misaligned"])
def test_fused_fp32_routes_on_cuda(layout, S):
    """The fp32 forward on the route ``fused_kernel_for`` names: the
    pieces kernel (``flash_fwd_pieces``) for contiguous operands and the
    encoder's qkv.chunk views, the CUDA-core kernel for rows off
    alignment; each launch counted under its kernel in
    ``fused_attention.kernel_launches`` (none in flash's), each within
    1e-4 of the fused plain version."""
    dev = _cuda()
    q, k, v = fp32_operands(4, S, layout, dev, seed=S)
    _, _, _, mask = _inputs(4, S, 1, 1, seed=S)
    mask = torch.as_tensor(mask).to(dev)
    kernel = "fused_fwd_f32" if layout == "misaligned" else "flash_fwd_pieces"
    assert fused_kernel_for(q, k, v) == kernel
    before = fused_attention.kernel_launches[kernel]
    flash_before = flash_attention.launches
    got = fused_attention(q, k, v, mask)
    assert fused_attention.kernel_launches[kernel] == before + 1
    assert flash_attention.launches == flash_before
    want = fused_attention_reference(q, k, v, mask)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 65, 2048, 2100])
@pytest.mark.parametrize("layout", ["contiguous", "qkv.chunk", "misaligned"])
def test_flash_fp32_routes_on_cuda(layout, S):
    """The flash forward's fp32 route by layout, as ``flash_kernel_for``
    names it: the pieces kernel for contiguous operands and the encoder's
    qkv.chunk views (any S: 2100 is past the fused kernel's cap), the
    CUDA-core kernel for rows off alignment; each launch counted under its
    kernel, each within 1e-4 of the plain version."""
    dev = _cuda()
    q, k, v = fp32_operands(3, S, layout, dev, seed=S)
    _, _, _, mask = _inputs(3, S, 1, 1, seed=S)
    mask = torch.as_tensor(mask).to(dev)
    kernel = "flash_fwd_f32" if layout == "misaligned" else "flash_fwd_pieces"
    assert flash_kernel_for(q, k, v) == kernel
    before = flash_attention.kernel_launches[kernel]
    got = flash_attention(q, k, v, mask)
    assert flash_attention.kernel_launches[kernel] == before + 1
    want = flash_attention_reference(q, k, v, mask)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_attention_kernels_raise_and_never_launch_on_bad_operands():
    dev = _cuda()
    x = torch.zeros(1, 64, 2, 48, device=dev, dtype=torch.bfloat16)
    for kernel in (fused_attention, flash_attention):
        before = kernel.launches
        with pytest.raises(ValueError, match="head dim"):
            kernel(x, x, x)
        assert kernel.launches == before
    long = torch.zeros(1, 4096, 1, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="sequence length"):
        fused_attention(long, long, long)
    odd = torch.zeros(1, 8, 1, 66, device=dev, dtype=torch.bfloat16)
    shifted = odd[..., 1:65]  # rows no longer 16-byte aligned
    with pytest.raises(ValueError, match="aligned"):
        fused_attention(shifted, shifted, shifted)


# -- the bf16 flash kernel's arithmetic (csrc/flash_attention.cu), on the CPU --

def bf16_pieces(p: torch.Tensor, n: int) -> list:
    """fp32 p as n bf16 pieces (as fp32 tensors): p1 = bf16(p),
    p2 = bf16(p − p1), p3 = bf16(p − p1 − p2), each subtraction exact."""
    out, rest = [], p
    for _ in range(n):
        piece = rest.to(torch.bfloat16).to(torch.float32)
        out.append(piece)
        rest = rest - piece
    return out


def flash_bf16_schedule(q, k, v, mask, pieces):
    """Kernel #4's bf16 route in fp32, tile for tile: s = fma(q·k, 1/8,
    bias) over 64-key tiles (q·k of bf16 values: exact products, fp32
    sums), the online max and rescaled sum, acc·a, then p·v as ``pieces``
    bf16 products of p's pieces (smallest first) into the fp32
    accumulator; out = acc / l, in fp32. q, k, v: fp32 tensors holding
    bf16 values."""
    f32 = torch.float32
    B, S, H, D = q.shape
    bias = (1.0 - mask.to(f32)) * NEG_INF_BIAS
    m = torch.full((B, H, S, 1), -math.inf)
    l = torch.zeros((B, H, S, 1))
    acc = torch.zeros((B, H, S, D))
    for t0, t1 in key_tiles(S):
        s = torch.einsum("bqhd,bkhd->bhqk", q, k[:, t0:t1]) \
            * torch.tensor(0.125) + bias[:, None, None, t0:t1]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        a = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * a + p.sum(-1, keepdim=True)
        acc = acc * a
        for piece in reversed(bf16_pieces(p, pieces)):
            acc = acc + torch.einsum("bhqk,bkhd->bhqd", piece, v[:, t0:t1])
        m = m_new
    return (acc / l).transpose(1, 2)


NEG_INF_BIAS = -1e9


def _bf16_valued(B, S, H, D, seed):
    """``_inputs`` with q, k, v rounded to bf16 and held as fp32, so the
    plain version and the JAX kernel compute the bf16 route's function in
    fp32 and compare to 1e-6."""
    q, k, v, mask = _inputs(B, S, H, D, seed)
    q, k, v = (torch.as_tensor(a).to(torch.bfloat16).to(torch.float32)
               for a in (q, k, v))
    return q, k, v, torch.as_tensor(mask, dtype=torch.int64)


def test_flash_bf16_scores_are_the_functions():
    """(a) q·(1/8) is exact in bf16, and so is every bf16 product in fp32:
    the bf16 q'·k the tensor cores take equals the fp32 q'·k of the
    function, and q·k scaled after the sum is the same bits; the kernel's
    fma(q·k, 1/8, bias) then rounds once where the function rounds twice
    (q'·k, + bias) and gets the same bits."""
    rs = np.random.RandomState(3)
    shape = (4, 96, 64)
    # values across bf16's range, and the mask bias
    q, k = (torch.as_tensor(rs.randn(*shape).astype(np.float32)
                            * np.exp2(rs.randint(-40, 40, shape)))
            .to(torch.bfloat16) for _ in range(2))
    q8 = q * torch.tensor(0.125, dtype=torch.bfloat16)  # in bf16
    assert torch.equal(q8.float(), q.float() * 0.125)
    prods32 = q8.float()[:, :, None] * k.float()[:, None]
    prods64 = q8.double()[:, :, None] * k.double()[:, None]
    assert torch.equal(prods32.double(), prods64)
    x = q.float() @ k.float().transpose(1, 2)      # what the wgmma sums
    x8 = q8.float() @ k.float().transpose(1, 2)    # the function's q'·k
    assert torch.equal(x * 0.125, x8)
    bias = torch.as_tensor(np.where(rs.rand(4, 1, 96) < 0.3, NEG_INF_BIAS,
                                    0.0).astype(np.float32))
    fma = (x.double() * 0.125 + bias.double()).float()  # x/8 + bias exact
    assert torch.equal(fma, x8 + bias)


def test_flash_bf16_three_pieces_are_p():
    """(b) p1 + p2 + p3 is p for every fp32 p in [2^-126, 1] (the range
    the kernel's ex2.approx.ftz leaves: below it p is 0): exactly for
    p ≥ 2^-110, and within 2^-134 (half the least bf16 subnormal, a lost
    piece below it) under that, near bf16's subnormals; two pieces carry
    16 bits and miss by up to 2^-17 of p."""
    rs = np.random.RandomState(4)
    n = 200_000
    e = rs.randint(-126, 1, n)
    p = torch.as_tensor(np.ldexp(rs.uniform(1.0, 2.0, n), e).astype(
        np.float32)).clamp(2.0 ** -126, 1.0)
    p1, p2, p3 = bf16_pieces(p, 3)
    assert torch.equal(p2, (p - p1).to(torch.bfloat16).float())
    three = p1.double() + p2.double() + p3.double()
    err = (three - p.double()).abs()
    big = p >= 2.0 ** -110
    assert err[big].max().item() == 0.0
    assert err.max().item() <= 2.0 ** -134
    assert err[~big].max().item() > 0.0  # the subnormal shortfall exists
    two = ((p1.double() + p2.double() - p.double()).abs() / p.double())
    assert 2.0 ** -19 < two[big].max().item() <= 2.0 ** -17


@pytest.mark.parametrize("S,block", [(130, 256), (128, 32)])
def test_flash_bf16_three_piece_schedule_matches_plain_and_jax(S, block):
    """(c) The bf16 route tile for tile, p·v from three bf16 pieces,
    against the plain version and the JAX kernel on the same bf16 values
    (in fp32, interpret mode): within 1e-6 (fp32 sums in other orders, the
    online rescaling). With two pieces it is another function: it misses
    that bound, and its RMS error against an fp64 evaluation of the same
    function is over 4x the three-piece schedule's."""
    from jax.experimental.pallas import tpu as pltpu
    q, k, v, mask = _bf16_valued(3, S, 2, 64, seed=S)
    got = flash_bf16_schedule(q, k, v, mask, pieces=3)
    want = flash_attention_reference(q, k, v, mask)
    tol = 1e-6
    assert (got - want).abs().max().item() <= tol
    flash = jax.jit(jax_flash, static_argnums=(4, 5))
    with pltpu.force_tpu_interpret_mode():  # one jitted call, no eager JAX
        jax_out = flash(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                        jnp.asarray(mask.numpy().astype(np.int32)), block,
                        block)
    assert np.abs(got.numpy() - np.asarray(jax_out)).max() <= tol
    two = flash_bf16_schedule(q, k, v, mask, pieces=2)
    assert (two - want).abs().max().item() > tol
    # the function in fp64 from the same fp32 scores (the -1e9 bias
    # swamps q·k in fp32, which makes the fully masked row uniform)
    d = torch.float64
    s = (torch.einsum("bqhd,bkhd->bhqk", q.to(d), k.to(d)) / 8
         + ((1.0 - mask.to(d)) * NEG_INF_BIAS)[:, None, None, :]).float()
    exact = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s.to(d), -1),
                         v.to(d))
    rms = lambda x: (x.to(d) - exact).pow(2).mean().sqrt().item()  # noqa: E731
    assert rms(two) > 4 * rms(got)
