"""The seq-128 experiment's kernels (#5 ``fused128``, #6 ``fused_block``)
and its mirror encoder: the port against ``docs/perf_attn128_r3.py`` on
the same numpy inputs.

The JAX script is imported by path with its shape globals (B, S, H, HEADS,
DH, I, L) shrunk through ``monkeypatch``; its Pallas kernels run on the CPU
under ``pltpu.force_tpu_interpret_mode()``, each JAX computation one
jitted call. On the CPU the port's wrappers run their plain versions; the
``cuda`` tests hold the hand-written kernels to those plain versions on
the card and skip elsewhere."""

import faulthandler
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ance_tpu_torch.experiments import perf_attn128 as port
from ance_tpu_torch.ops.attn128 import (LAUNCHES_PER_CALL, _check, fused128,
                                        fused128_reference, fused_block,
                                        fused_block_reference)
from test_torch_attention import _bf16_ulp, assert_bf16_slice_close

torch.set_num_threads(1)

SCRIPT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "docs", "perf_attn128_r3.py")
# B=4 rows, S=16, two heads of 64 (H=128), FFN 256, 2 layers
SMALL = {"B": 4, "S": 16, "H": 128, "HEADS": 2, "DH": 64, "I": 256, "L": 2}


@pytest.fixture(autouse=True)
def _time_limit():
    """Pallas interpret mode re-enters JAX from its callbacks: should a
    test hang, print every thread's stack and end this worker after 300 s,
    so one test fails instead of the whole suite being cut."""
    faulthandler.dump_traceback_later(300, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location("perf_attn128_r3", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def small(script, monkeypatch):
    for name, value in SMALL.items():
        monkeypatch.setattr(script, name, value)
    return script


def _interpret(fn, *args):
    """One jitted JAX call under Pallas interpret mode (no eager JAX)."""
    from jax.experimental.pallas import tpu as pltpu
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jax.jit(fn)(*args).astype(jnp.float32))


def _mask(B, S):
    """A padding tail from S - 4 and row 1 fully masked."""
    mask = np.ones((B, S), np.int32)
    mask[:, S - 4:] = 0
    mask[1] = 0
    return mask


def _bf16(rs, *shape, std=1.0):
    a = (rs.randn(*shape) * std).astype(np.float32)
    return jnp.asarray(a, jnp.bfloat16), torch.as_tensor(a).to(torch.bfloat16)


def _heads4(x, B, S):
    """[B, S, 2·64] → [B, S, 2, 64], the layout the slice bound reads."""
    return np.asarray(x, np.float32).reshape(B, S, SMALL["HEADS"], 64)


def test_fused128_plain_matches_jax_kernel(small):
    B, S, H = SMALL["B"], SMALL["S"], SMALL["H"]
    rs = np.random.RandomState(0)
    (jq, q), (jk, k), (jv, v) = (_bf16(rs, B, S, H) for _ in range(3))
    mask = _mask(B, S)
    want = _interpret(functools.partial(small.fused128, group=2), jq, jk, jv,
                      jnp.asarray(mask))
    got = fused128(q, k, v, torch.as_tensor(mask))  # CPU: the plain version
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, H)
    assert fused128.launches == 0
    # bf16 context: exp and the sums round differently in XLA and torch,
    # which can move a bf16 probability or the output by one rounding step
    assert_bf16_slice_close(_heads4(got.float(), B, S), _heads4(want, B, S),
                            "fused128")
    # the fully masked row attends uniformly: the mean of v over every key
    mean_v = v[1].float().mean(0, keepdim=True).expand(S, H)
    assert (got[1].float() - mean_v).abs().max() <= _bf16_ulp(
        mean_v.numpy()).max() * 2


def test_fused_block_plain_matches_jax_kernel(small):
    B, S, H = SMALL["B"], SMALL["S"], SMALL["H"]
    rs = np.random.RandomState(1)
    jx, x = _bf16(rs, B, S, H)
    (jwq, wq), (jwk, wk), (jwv, wv), (jwo, wo) = (
        _bf16(rs, H, H, std=H ** -0.5) for _ in range(4))
    mask = _mask(B, S)
    want = _interpret(functools.partial(small.fused_block, group=2), jx, jwq,
                      jwk, jwv, jwo, jnp.asarray(mask))
    got = fused_block(x, wq, wk, wv, wo, torch.as_tensor(mask))
    assert got.dtype == torch.bfloat16 and fused_block.launches == 0
    # q/k/v, the context and the output are each one bf16 rounding of an
    # fp32 sum taken in another order: one rounding step moves an output
    # by an ulp of its slice
    assert_bf16_slice_close(_heads4(got.float(), B, S), _heads4(want, B, S),
                            "fused_block")
    assert torch.equal(got, fused_block_reference(x, wq, wk, wv, wo,
                                                  torch.as_tensor(mask)))


def _toward_zero(x):
    """fp64 ``x`` rounded to fp32 toward zero, as the tensor cores' fp32
    accumulation rounds each update."""
    y = x.float()
    return torch.where(y.double().abs() > x.abs(),
                       torch.nextafter(y, torch.zeros_like(y)), y)


def project_emulated(x, w):
    """Kernel #6's projection x [..., K] · w [K, N] tile for tile: one fp32
    accumulator over the whole depth (K / 64 ring stages of four wgmma
    k-steps), each k-step's 16 bf16 products summed exactly and added to
    it rounded toward zero (the first update overwrites it); the product
    rounded to bf16, as the kernel stores q, k, v, the context's
    projection and the output."""
    xd, wd = x.double(), w.double()
    acc = None
    for k0 in range(0, x.shape[-1], 16):
        step = xd[..., k0:k0 + 16] @ wd[k0:k0 + 16]
        acc = _toward_zero(step if acc is None else acc.double() + step)
    return acc.to(x.dtype)


def block_emulated(x, wq, wk, wv, wo, mask):
    """What ``qkv_attend_kernel`` + ``out_proj_kernel`` compute: q, k, v
    by ``project_emulated`` (bf16, kept on chip), the attention of kernel
    #5 on them (its plain version: the kernels share ``attend_head``), the
    output projection by ``project_emulated``."""
    q, k, v = (project_emulated(x, w) for w in (wq, wk, wv))
    return project_emulated(fused128_reference(q, k, v, mask), wo)


def test_block_tiling_emulated_matches_plain_and_jax(small):
    """Kernel #6's tiling (16-deep wgmma steps into one truncating fp32
    accumulator a projection, q, k, v rounded to bf16) against the plain
    version and the Pallas kernel in interpret mode, per element under the
    bf16 slice rule: a truncated update moves a sum by under an fp32 ulp,
    far below the bf16 rounding that follows."""
    B, S, H = SMALL["B"], SMALL["S"], SMALL["H"]
    rs = np.random.RandomState(7)
    jx, x = _bf16(rs, B, S, H)
    (jwq, wq), (jwk, wk), (jwv, wv), (jwo, wo) = (
        _bf16(rs, H, H, std=H ** -0.5) for _ in range(4))
    mask = _mask(B, S)
    got = block_emulated(x, wq, wk, wv, wo, torch.as_tensor(mask))
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, H)
    want = fused_block_reference(x, wq, wk, wv, wo, torch.as_tensor(mask))
    assert_bf16_slice_close(_heads4(got.float(), B, S),
                            _heads4(want.float(), B, S), "emulated vs plain")
    jax_out = _interpret(functools.partial(small.fused_block, group=2), jx,
                         jwq, jwk, jwv, jwo, jnp.asarray(mask))
    assert_bf16_slice_close(_heads4(got.float(), B, S),
                            _heads4(jax_out, B, S), "emulated vs jax")


@pytest.mark.parametrize("S", [128, 77])
def test_block_tiling_emulated_at_full_width_matches_plain(S):
    """The same at the encoder's width (768-deep sums: 48 truncating
    updates a projection) and at a ragged S."""
    B, H = 2, 768
    rs = np.random.RandomState(S)
    x = torch.as_tensor(rs.randn(B, S, H).astype(np.float32)).bfloat16()
    wq, wk, wv, wo = (torch.as_tensor((rs.randn(H, H) * H ** -0.5).astype(
        np.float32)).bfloat16() for _ in range(4))
    mask = torch.as_tensor(_mask(B, S))
    got = block_emulated(x, wq, wk, wv, wo, mask)
    want = fused_block_reference(x, wq, wk, wv, wo, mask)
    assert_bf16_slice_close(got.float().reshape(B, S, 12, 64).numpy(),
                            want.float().reshape(B, S, 12, 64).numpy(),
                            "emulated vs plain")


def _jax_params(small, seed):
    return jax.tree.map(np.asarray,
                        small.make_params(np.random.RandomState(seed)))


def _port_params(seed):
    return port.make_params(np.random.RandomState(seed), layers=SMALL["L"],
                            hidden=SMALL["H"], intermediate=SMALL["I"],
                            seq=SMALL["S"])


def test_make_params_and_params_from_jax_key_for_key(small):
    """The same RandomState gives the same weights in both packages, and
    ``params_from_jax`` carries the JAX tree over value for value."""
    tree = _jax_params(small, 0)
    mine = _port_params(0)
    carried = port.params_from_jax(tree)

    def leaves(p):
        out = {"emb": p["emb"], "pos": p["pos"], "head": p["head"],
               "ln0.scale": p["ln0"][0], "ln0.bias": p["ln0"][1]}
        for i, lp in enumerate(p["layers"]):
            for key in ("q", "k", "v", "o", "up", "down"):
                out[f"{i}.{key}"] = lp[key]
            for key in ("ln1", "ln2"):
                out[f"{i}.{key}.scale"], out[f"{i}.{key}.bias"] = lp[key]
        return out

    want = {k: np.asarray(v, np.float32) for k, v in leaves(tree).items()}
    assert sorted(leaves(mine)) == sorted(leaves(carried)) == sorted(want)
    assert len(want) == 5 + SMALL["L"] * 10
    for key, t in leaves(carried).items():
        assert t.dtype == leaves(mine)[key].dtype, key
        assert torch.equal(t, leaves(mine)[key]), key
        np.testing.assert_array_equal(t.float().numpy(), want[key], key)
    assert mine["emb"].shape == (port.VOCAB, SMALL["H"])
    assert mine["layers"][0]["up"].dtype == torch.bfloat16


def test_layer_norm_matches_jax(small):
    rs = np.random.RandomState(2)
    jx, x = _bf16(rs, 6, SMALL["H"], std=3.0)
    a = rs.rand(SMALL["H"]).astype(np.float32)
    b = rs.randn(SMALL["H"]).astype(np.float32)
    want = np.asarray(jax.jit(small.layer_norm)(
        jx, (jnp.asarray(a), jnp.asarray(b))).astype(jnp.float32))
    got = port.layer_norm(x, (torch.as_tensor(a), torch.as_tensor(b)))
    assert got.dtype == torch.bfloat16
    # fp32 standardize, then one bf16 rounding: rsqrt may differ by an fp32
    # ulp between XLA and torch, which can flip that rounding
    err = np.abs(got.float().numpy() - want)
    assert (err <= _bf16_ulp(want)).all()


def test_script_xla_softmax_runs_in_fp32(small):
    """The script's ``xla`` branch divides its bf16 scores by a numpy
    float64 (``np.sqrt(DH)``), which promotes them: its softmax runs in
    fp32, which the port's ``xla`` variant follows."""
    import re
    B, S, HEADS = SMALL["B"], SMALL["S"], SMALL["HEADS"]
    tree = jax.tree.map(jnp.asarray, _jax_params(small, 0))
    ids = jnp.zeros((B, S), jnp.int32)
    jaxpr = str(jax.make_jaxpr(functools.partial(small.encoder, attn="xla"))(
        tree, ids, jnp.asarray(_mask(B, S))))
    exps = re.findall(rf":(\w+)\[{B},{HEADS},{S},{S}\] = exp\b", jaxpr)
    assert exps and set(exps) == {"f32"}, exps


def _script_xla_attention(q, k, v, mask):
    """``docs/perf_attn128_r3.py:194-200``, the ``xla`` branch of the
    script's encoder, on [B, S, H] projections."""
    B, S, H = q.shape
    heads, dh = SMALL["HEADS"], SMALL["DH"]
    bias = jnp.where(mask[:, None, None, :] > 0, 0.0, -1e9
                     ).astype(jnp.float32)
    r = lambda t: t.reshape(B, S, heads, dh)  # noqa: E731
    q, k, v = r(q), r(k), r(v)
    s = jnp.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(dh)
    s = s + bias.astype(s.dtype)
    p = jax.nn.softmax(s, axis=-1)
    return jnp.einsum("bhqk,bkhd->bqhd", p, v.astype(p.dtype)
                      ).astype(jnp.bfloat16).reshape(B, S, H)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_xla_attention_matches_script_per_element(seed):
    """One layer's ``xla`` attention against the script's expression, each
    element under the bf16 slice rule. Both round the scores to bf16 once
    after an fp32 sum, then run the softmax and p·v in fp32 and round the
    context once, so only the order of the fp32 sums differs: it can flip
    a rounding now and then, and at most 1 element in 1000 may differ at
    all (seen: at most 1 of these 8192; at S=128, 2 in 10⁴). Rounding the
    softmax in bf16 instead moves about 30% of them, within the slice
    rule."""
    B, S, H = SMALL["B"], SMALL["S"], SMALL["H"]
    rs = np.random.RandomState(10 + seed)
    (jq, q), (jk, k), (jv, v) = (_bf16(rs, B, S, H) for _ in range(3))
    mask = _mask(B, S)
    want = np.asarray(jax.jit(_script_xla_attention)(
        jq, jk, jv, jnp.asarray(mask)).astype(jnp.float32))
    got = port._xla_attention(q, k, v, torch.as_tensor(mask),
                              SMALL["HEADS"])
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, H)
    assert_bf16_slice_close(_heads4(got.float(), B, S), _heads4(want, B, S),
                            "xla attention")
    assert (got.float().numpy() != want).mean() <= 1e-3


# Per-row cosine of the port's [B, H] output against the JAX encoder's,
# 2 layers. Each variant rounds at the same points in bf16, but torch and
# XLA sum in other orders and compute exp/tanh/rsqrt differently, so
# roundings differ by an ulp here and there and spread through two layers.
# Seen: >= 0.99997 for every variant.
ENCODER_COSINE = 0.9999


@pytest.mark.parametrize("attn", ["xla", "fold", "fused128", "block"])
def test_mirror_encoder_matches_jax(small, attn):
    tree = _jax_params(small, 3)
    rs = np.random.RandomState(4)
    ids = rs.randint(4, 50000, (SMALL["B"], SMALL["S"])).astype(np.int32)
    mask = _mask(SMALL["B"], SMALL["S"])
    want = _interpret(functools.partial(small.encoder, attn=attn, group=2),
                      jax.tree.map(jnp.asarray, tree), jnp.asarray(ids),
                      jnp.asarray(mask))
    got = port.encoder(port.params_from_jax(tree), torch.as_tensor(ids),
                       torch.as_tensor(mask), attn=attn,
                       heads=SMALL["HEADS"]).float().numpy()
    assert got.shape == want.shape == (SMALL["B"], SMALL["H"])
    assert np.isfinite(got).all()
    cos = (got * want).sum(1) / (np.linalg.norm(got, axis=1)
                                 * np.linalg.norm(want, axis=1))
    assert cos.min() >= ENCODER_COSINE, cos


def test_variants_agree_and_unknown_raises():
    """On the CPU the four variants are four roundings of one function."""
    params = _port_params(5)
    ids, mask = port.inputs(np.random.RandomState(6), 3, SMALL["S"], "cpu",
                            pad_from=12)
    outs = {a: port.encoder(params, ids, mask, attn=a, heads=SMALL["HEADS"])
            for a in port.VARIANTS}
    ref = outs["xla"].float()
    for attn, out in outs.items():
        cos = torch.nn.functional.cosine_similarity(out.float(), ref, dim=1)
        assert cos.min() > 0.999, (attn, cos)
    with pytest.raises(ValueError, match="attn must be one of"):
        port.encoder(params, ids, mask, attn="sdpa")


@pytest.mark.parametrize("case,error,match", [
    ("dtype", TypeError, "bfloat16 only"),
    ("device", ValueError, "CUDA device"),
    ("strided", ValueError, "contiguous"),
    ("misaligned", ValueError, "16-byte-aligned base"),
    ("long", ValueError, "sequence length 129"),
])
def test_kernel_checks_raise_on_what_the_kernels_do_not_take(case, error,
                                                             match):
    """Every check but the device's runs first, so a CPU tensor meets it:
    kernel #5's TMA boxes need a contiguous [B, S, H] with a 16-byte-
    aligned base, and S ≤ 128."""
    S = 129 if case == "long" else 8
    x = torch.zeros(2, S, 128, dtype=torch.bfloat16)
    if case == "dtype":
        x = x.float()
    elif case == "strided":
        x = torch.zeros(2, S, 256, dtype=torch.bfloat16)[..., :128]
    elif case == "misaligned":  # 2 bytes past an aligned base
        x = torch.zeros(2 * S * 128 + 1, dtype=torch.bfloat16)[1:].view(
            2, S, 128)
    with pytest.raises(error, match=match):
        _check("test", {"x": (x, (2, S, 128))})
    with pytest.raises(ValueError, match="heads x 64"):
        fused128(torch.zeros(2, 8, 100), torch.zeros(2, 8, 100),
                 torch.zeros(2, 8, 100))


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _cuda_inputs(B, S, H, seed, dev):
    rs = np.random.RandomState(seed)
    q, k, v = (torch.as_tensor(rs.randn(B, S, H).astype(np.float32)).to(
        dev, torch.bfloat16) for _ in range(3))
    return q, k, v, torch.as_tensor(_mask(B, S)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H", [(8, 128, 768), (5, 77, 768), (3, 16, 128),
                                   (23, 1, 768), (23, 16, 768),
                                   (23, 77, 768), (23, 128, 768)])
def test_fused128_kernel_matches_plain_on_cuda(B, S, H):
    """23 x 12 = 276 heads: more than one per persistent block, and not a
    multiple of the grid (one block an SM)."""
    dev = _cuda()
    q, k, v, mask = _cuda_inputs(B, S, H, S, dev)
    before = fused128.launches
    got = fused128(q, k, v, mask)
    assert fused128.launches == before + LAUNCHES_PER_CALL["fused128"]
    want = fused128_reference(q, k, v, mask)
    torch.cuda.synchronize()
    assert_bf16_slice_close(got.float().cpu().reshape(B, S, H // 64, 64),
                            want.float().cpu().reshape(B, S, H // 64, 64),
                            "fused128")


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H", [(4, 128, 768), (3, 77, 768), (2, 16, 128)])
def test_fused_block_kernel_matches_plain_on_cuda(B, S, H):
    dev = _cuda()
    x, _, _, mask = _cuda_inputs(B, S, H, S + 1, dev)
    g = torch.Generator(device=dev).manual_seed(S)
    wq, wk, wv, wo = (torch.randn(H, H, generator=g, device=dev).mul(
        H ** -0.5).to(torch.bfloat16) for _ in range(4))
    before = fused_block.launches
    got = fused_block(x, wq, wk, wv, wo, mask)
    assert fused_block.launches == before + LAUNCHES_PER_CALL["fused_block"]
    want = fused_block_reference(x, wq, wk, wv, wo, mask)
    torch.cuda.synchronize()
    assert_bf16_slice_close(got.float().cpu().reshape(B, S, H // 64, 64),
                            want.float().cpu().reshape(B, S, H // 64, 64),
                            "fused_block")


@pytest.mark.cuda
def test_attn128_kernels_raise_and_never_launch_on_bad_operands():
    dev = _cuda()
    long = torch.zeros(1, 129, 128, device=dev, dtype=torch.bfloat16)
    f32 = torch.zeros(1, 16, 128, device=dev)
    for bad, error in ((long, ValueError), (f32, TypeError)):
        before = fused128.launches
        with pytest.raises(error):
            fused128(bad, bad, bad)
        assert fused128.launches == before
    w = torch.zeros(128, 128, device=dev, dtype=torch.bfloat16)
    x = torch.zeros(1, 16, 128, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="not"):
        fused_block(x, w, w, w, w[:64])
