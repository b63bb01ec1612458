"""The port's attention (plain versions, dispatch, kernel wrappers) against
the JAX package's fused and flash attention, on the same numpy inputs.

On the CPU the port's ``fused`` / ``flash`` run their plain versions; the
JAX kernels run as the JAX package's own tests run them (Pallas interpret
mode). The ``cuda`` tests hold the hand-written kernels to those plain
versions on the card and skip elsewhere."""

import math

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
        # rounding step; 2 ulps of the largest value bound both
        np.testing.assert_allclose(got, want, atol=_bf16_ulps(want, 2),
                                   rtol=0)


@pytest.fixture
def tpu_interpret():
    from jax.experimental.pallas import tpu as pltpu
    with pltpu.force_tpu_interpret_mode():
        yield


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
def test_flash_plain_matches_jax_kernel(tpu_interpret, kind, B, S, H, D,
                                        block):
    (jq, jk, jv, jm), (q, k, v, m) = _both(_inputs(B, S, H, D, seed=S + 1),
                                           kind)
    want = jax_flash(jq, jk, jv, jm, block, block)
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


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["fused", "flash"])
@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("S,strided", [(512, False), (300, False),
                                       (256, True)])
def test_attention_kernel_matches_plain_on_cuda(impl, kind, S, strided):
    """Each kernel against its plain version on the card: ragged S, a fully
    masked row, and q/k/v as strided chunks of one fused-QKV projection.
    bf16 within 2 ulps of max |plain|; fp32 within 1e-4 (summation order
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
    tol = 1e-4 if kind == "f32" else _bf16_ulps(want.cpu().numpy(), 2)
    torch.testing.assert_close(got.float(), want, atol=tol, rtol=0)


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
