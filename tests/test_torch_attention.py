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
                                                flash_attention_reference)
from ance_tpu_torch.ops.fused_attention import (fused_attention,
                                                fused_attention_reference)

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
])
def test_kernel_operands_raise_on_what_the_kernels_do_not_take(case, error,
                                                               match):
    """The wrapper checks run before any launch; on a CPU tensor the last
    of them (the device) is what stops the kernel path."""
    q = torch.zeros(2, 8, 2, 64)
    k, v = q.clone(), q.clone()
    if case == "shape":
        k = torch.zeros(2, 8, 2, 32)
    elif case == "dtype":
        q, k, v = (t.to(torch.float16) for t in (q, k, v))
    elif case == "mixed_dtype":
        k = k.to(torch.bfloat16)
    with pytest.raises(error, match=match):
        kernel_operands(q, k, v, None, name="test")


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


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["fused", "flash"])
@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("S,strided", [(1, False), (64, False), (65, True),
                                       (256, True), (300, False),
                                       (512, False), (2048, False)])
def test_attention_kernel_matches_plain_on_cuda(impl, kind, S, strided):
    """Each kernel against its plain version on the card: ragged S (one key
    tile, one key past a tile, 2048 = the fused forward's MAX_SEQ), a fully
    masked row, and q/k/v as strided chunks of one fused-QKV projection.
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
