"""Torch block-max top-k vs the JAX Pallas kernel (interpret mode) and the
scan top-k, on the same numpy inputs."""

import faulthandler

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ance_tpu.index.flat import quantize_dims_int8 as jax_quantize_dims
from ance_tpu.index.flat import topk_inner_product as jax_scan
from ance_tpu.ops.topk import blockmax_scores as jax_blockmax
from ance_tpu.ops.topk import topk_blockmax as jax_topk_blockmax
from ance_tpu_torch.index.flat import topk_inner_product
from ance_tpu_torch.ops.topk import (blockmax_scores,
                                     blockmax_scores_reference, topk_blockmax)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _time_limit():
    """Pallas interpret mode re-enters JAX from its callbacks: should a
    test hang, print every thread's stack and end this worker after 300 s,
    so one test fails instead of the whole suite being cut."""
    faulthandler.dump_traceback_later(300, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()


_JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8}
_TORCH = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


def _operand(rs, shape, kind):
    if kind == "int8":
        return rs.randint(-127, 128, shape).astype(np.int8)
    return rs.randn(*shape).astype(np.float32)


def _both(x, kind):
    """One numpy array → (jax array, torch tensor) of the same dtype."""
    j = jnp.asarray(x).astype(_JNP[kind])
    t = torch.as_tensor(x).to(_TORCH[kind])
    return j, t


@pytest.mark.parametrize("qk,ck", [("f32", "f32"), ("bf16", "bf16"),
                                   ("f32", "int8"), ("int8", "int8")])
def test_blockmax_scores_plain_matches_jax_kernel(qk, ck):
    """Phase 1 on the CPU (the plain version) against the Pallas kernel in
    interpret mode, for the four dtype pairs. int32 is exact; floats within
    1e-5 (fp32 accumulation of exact products, different summation order)."""
    rs = np.random.RandomState(0)
    Q, N, D, BS, CHUNK = 8, 256, 16, 8, 64
    qj, qt = _both(_operand(rs, (Q, D), qk), qk)
    cj, ct = _both(_operand(rs, (N, D), ck), ck)
    want = np.asarray(jax_blockmax(qj, cj, block_size=BS, chunk_rows=CHUNK,
                                   interpret=True))
    got = blockmax_scores(qt, ct, block_size=BS, chunk_rows=CHUNK).numpy()
    assert got.shape == (Q, N // BS)
    if qk == ck == "int8":
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    else:
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-6)


def test_blockmax_scores_checks_its_inputs():
    q = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="multiple of chunk_rows"):
        blockmax_scores(q, torch.zeros(100, 8), chunk_rows=64)
    with pytest.raises(TypeError, match="dtype pair"):
        blockmax_scores(q.to(torch.int8), torch.zeros(64, 8), chunk_rows=64)


def _jax_and_port(q, c, k, **kw):
    n = c.shape[0]
    js, ji = jax_topk_blockmax(jnp.asarray(q), jnp.asarray(c), k=k,
                               interpret=True,
                               valid_rows=jnp.asarray(n, jnp.int32), **kw)
    ps, pi = topk_blockmax(torch.as_tensor(q), torch.as_tensor(c), k=k,
                           valid_rows=n, **kw)
    return (np.asarray(js), np.asarray(ji)), (ps.numpy(), pi.numpy())


@pytest.mark.parametrize("n,k", [(256, 10), (250, 25), (300, 7)])
def test_topk_blockmax_matches_jax(n, k):
    rs = np.random.RandomState(1)
    q = rs.randn(13, 16).astype(np.float32)
    c = rs.randn(n, 16).astype(np.float32)
    (js, ji), (ps, pi) = _jax_and_port(q, c, k, block_size=8, chunk_rows=64,
                                       q_tile=8)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(ps, js, atol=1e-5, rtol=0)


def test_topk_blockmax_all_negative_scores_with_padding():
    """Padded rows score 0 and would beat all-negative real scores unless
    their blocks are masked."""
    rs = np.random.RandomState(2)
    q = rs.rand(4, 8).astype(np.float32)
    c = (-rs.rand(100, 8)).astype(np.float32)  # pads to 128 with chunk 64
    (js, ji), (ps, pi) = _jax_and_port(q, c, 5, block_size=8, chunk_rows=64,
                                       q_tile=8)
    np.testing.assert_array_equal(pi, ji)
    assert (ps < 0).all()
    np.testing.assert_allclose(ps, js, atol=1e-5, rtol=0)


def test_topk_blockmax_k_exceeds_candidates():
    """k=20 over 16 rows: the tail is −1 ids at NEG_INF, as in JAX."""
    rs = np.random.RandomState(3)
    q = rs.randn(3, 8).astype(np.float32)
    c = rs.randn(16, 8).astype(np.float32)
    (js, ji), (ps, pi) = _jax_and_port(q, c, 20, block_size=8, chunk_rows=16,
                                       q_tile=8)
    np.testing.assert_array_equal(pi, ji)
    assert (pi[:, 16:] == -1).all()
    np.testing.assert_allclose(ps[:, :16], js[:, :16], atol=1e-5, rtol=0)


@pytest.mark.parametrize("p1", [None, "bf16", "int8"])
def test_topk_blockmax_int8_corpus_phase1_variants(p1):
    """int8 (dims-quantized) corpus under each phase-1 query dtype; codes
    from JAX's quantizer feed both, rescore in fp32 (atol 1e-4 as in
    tests/test_topk_kernel.py)."""
    rs = np.random.RandomState(4)
    q = rs.randn(13, 16).astype(np.float32)
    c = rs.randn(256, 16).astype(np.float32)
    c8, scales = (np.array(a) for a in jax_quantize_dims(jnp.asarray(c)))
    qs = (q * scales[None, :]).astype(np.float32)
    js, ji = jax_topk_blockmax(jnp.asarray(qs), jnp.asarray(c8), k=10,
                               block_size=8, chunk_rows=64, q_tile=8,
                               phase1_dtype=_JNP.get(p1), interpret=True)
    ps, pi = topk_blockmax(torch.as_tensor(qs), torch.as_tensor(c8), k=10,
                           block_size=8, chunk_rows=64, q_tile=8,
                           phase1_dtype=_TORCH.get(p1))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), atol=1e-4, rtol=0)


def test_topk_blockmax_bf16_corpus():
    """bf16 corpus: phase 1 in bf16 × bf16 → fp32, phase 3 rescores the
    bf16 rows in fp32; identical ids, scores within 1e-4 (fp32 sums of
    bf16-exact products in another order)."""
    rs = np.random.RandomState(6)
    q = rs.randn(9, 32).astype(np.float32)
    c = rs.randn(512, 32).astype(np.float32)
    qb = np.asarray(jnp.asarray(q).astype(jnp.bfloat16).astype(jnp.float32))
    js, ji = jax_topk_blockmax(jnp.asarray(qb).astype(jnp.bfloat16),
                               jnp.asarray(c).astype(jnp.bfloat16), k=10,
                               interpret=True, chunk_rows=128)
    ps, pi = topk_blockmax(torch.as_tensor(q).to(torch.bfloat16),
                           torch.as_tensor(c).to(torch.bfloat16), k=10,
                           chunk_rows=128)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), atol=1e-4, rtol=0)


@pytest.mark.parametrize("scaled", [False, True])
def test_topk_inner_product_matches_jax(scaled):
    rs = np.random.RandomState(7)
    q = rs.randn(11, 16).astype(np.float32)
    c = rs.randn(300, 16).astype(np.float32)
    scales = rs.rand(300).astype(np.float32) + 0.5 if scaled else None
    js, ji = jax_scan(jnp.asarray(q), jnp.asarray(c), k=12, chunk_rows=64,
                      valid_rows=jnp.asarray(290, jnp.int32),
                      row_scales=None if scales is None
                      else jnp.asarray(scales))
    ps, pi = topk_inner_product(torch.as_tensor(q), torch.as_tensor(c), k=12,
                                chunk_rows=64, valid_rows=290,
                                row_scales=None if scales is None
                                else torch.as_tensor(scales))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_blockmax_kernel_matches_plain_on_cuda():
    """The hand-written kernel against the plain version on the card, for
    every dtype pair it takes (int32 exact; fp32 accumulation in another
    order: atol 1e-3 on scores of magnitude ~sqrt(D))."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    rs = np.random.RandomState(8)
    Q, N, D = 70, 4096, 96
    for qk, ck in [("f32", "f32"), ("bf16", "bf16"), ("f32", "int8"),
                   ("bf16", "int8"), ("int8", "int8")]:
        q = torch.as_tensor(_operand(rs, (Q, D), qk)).to("cuda", _TORCH[qk])
        c = torch.as_tensor(_operand(rs, (N, D), ck)).to("cuda", _TORCH[ck])
        before = blockmax_scores.launches
        got = blockmax_scores(q, c)
        assert blockmax_scores.launches == before + 1
        want = blockmax_scores_reference(q, c)
        torch.cuda.synchronize()
        if qk == ck == "int8":
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-5)


@pytest.mark.cuda
def test_blockmax_kernel_rejects_operands_it_cannot_take():
    """bf16 and int8 queries go to the tensor-core kernel only, which loads
    8-element chunks: D % 8 != 0 or a misaligned base raises, never runs a
    second kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    q = torch.ones(4, 100, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="D % 8"):
        blockmax_scores(q, torch.ones(1024, 100, dtype=torch.bfloat16,
                                      device="cuda"))
    q8 = torch.ones(4, 8, dtype=torch.int8, device="cuda")
    shifted = torch.ones(1025, 8, dtype=torch.int8, device="cuda")[1:]
    before = blockmax_scores.launches
    with pytest.raises(ValueError, match="aligned"):
        blockmax_scores(q8, shifted)
    assert blockmax_scores.launches == before
