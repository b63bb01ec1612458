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


# csrc/blockmax.cu's bf16 route: corpus rows a block (two warpgroups of 64,
# wgmma's M), queries a block (wgmma's N), floats a row of the maxima tile
_BF16_ROWS, _BF16_Q, _MAXIMA_LD = 128, 256, 256 + 4


def _fragments(tile):
    """A warpgroup's [64, 256] accumulator as its threads hold it
    (``csrc/hopper.cuh``'s layout, j = 0..31): acc[w, lane, 4j + 2h + e] =
    tile[16w + g + 8h, 8j + c + e], g = lane // 4, c = 2 (lane % 4)."""
    w, lane, j, h, e = np.meshgrid(np.arange(4), np.arange(32),
                                   np.arange(32), np.arange(2), np.arange(2),
                                   indexing="ij")
    g, c = lane // 4, 2 * (lane % 4)
    acc = np.empty((4, 32, 128), np.float32)
    acc[w, lane, 4 * j + 2 * h + e] = tile[16 * w + g + 8 * h, 8 * j + c + e]
    return acc


def _lane_max_scatter(acc, off):
    """``lane_max_scatter<Off>`` on every warp at once: three xor shuffles
    (16, 8, 4), each lane keeping the half of its columns whose j bit
    (4, 2, 1) equals its g bit and maxing in the partner's values."""
    lane = np.arange(32)
    g = lane // 4
    for s in range(3):
        jbit, lanes = 4 >> s, 16 >> s
        up = (g & jbit) != 0
        for j in range(32):
            if j & (8 - jbit):
                continue
            for e in range(2):
                lo = acc[:, :, 4 * j + off + e].copy()
                hi = acc[:, :, 4 * (j + jbit) + off + e].copy()
                send = np.where(up, lo, hi)
                keep = np.where(up, hi, lo)
                acc[:, :, 4 * j + off + e] = np.maximum(
                    keep, send[:, lane ^ lanes])


def _blockmax_bf16_emulated(q, c, block_size):
    """What ``blockmax_bf16`` computes, step for step: the grid (query tile
    fastest), each block's tiles as TMA leaves them (rows and columns out of
    bounds zero), its score tile as two warpgroups' fragments, the block
    maxima in registers and through the maxima tile, and the store loop.
    Returns (out, how many times each output element was written)."""
    n_q, dim = q.shape
    n_rows = c.shape[0]
    n_blocks = n_rows // block_size
    n_q_tiles = -(-n_q // _BF16_Q)
    n_row_tiles = -(-n_rows // _BF16_ROWS)
    n_k = -(-dim // 64)
    out = np.full((n_q, n_blocks), np.nan, np.float32)
    writes = np.zeros((n_q, n_blocks), np.int64)
    # maxima-tile rows a block: 16-row groups, 8-row groups, single rows
    per = block_size // 16 if block_size >= 16 else \
        1 if block_size == 8 else block_size
    blocks_per_tile = _BF16_ROWS // block_size
    for bid in range(n_q_tiles * n_row_tiles):
        q0 = (bid % n_q_tiles) * _BF16_Q
        row0 = (bid // n_q_tiles) * _BF16_ROWS
        qt = np.zeros((_BF16_Q, 64 * n_k), np.float32)
        ct = np.zeros((_BF16_ROWS, 64 * n_k), np.float32)
        qs, cs = q[q0:q0 + _BF16_Q], c[row0:row0 + _BF16_ROWS]
        qt[:len(qs), :dim], ct[:len(cs), :dim] = qs, cs
        scores = np.zeros((_BF16_ROWS, _BF16_Q), np.float32)
        for t in range(n_k):  # one ring stage a 64-column step
            k = slice(64 * t, 64 * t + 64)
            scores += ct[:, k] @ qt[:, k].T
        maxima = np.full((_BF16_ROWS // 8, _MAXIMA_LD), np.nan, np.float32)
        lane = np.arange(32)
        g, cc = lane // 4, 2 * (lane % 4)
        if block_size < 8:  # every row's score, over the spent ring
            maxima = np.full((_BF16_ROWS, _MAXIMA_LD), np.nan, np.float32)
            for wg in range(2):
                acc = _fragments(scores[64 * wg:64 * wg + 64])
                for w in range(4):
                    for h in range(2):
                        for j in range(32):
                            for e in range(2):
                                maxima[16 * (4 * wg + w) + g + 8 * h,
                                       8 * j + cc + e] = \
                                    acc[w, :, 4 * j + 2 * h + e]
        for wg in range(2 if block_size >= 8 else 0):
            acc = _fragments(scores[64 * wg:64 * wg + 64])
            if block_size >= 16:
                for j in range(32):
                    for e in range(2):
                        acc[:, :, 4 * j + e] = np.maximum(
                            acc[:, :, 4 * j + e], acc[:, :, 4 * j + 2 + e])
                _lane_max_scatter(acc, 0)
                groups = [(4 * wg + w, w, 0) for w in range(4)]
            else:
                _lane_max_scatter(acc, 0)
                _lane_max_scatter(acc, 2)
                groups = [(2 * (4 * wg + w) + h, w, 2 * h)
                          for w in range(4) for h in range(2)]
            for row, w, off in groups:
                for i in range(4):
                    for e in range(2):
                        maxima[row, 64 * i + 8 * g + cc + e] = \
                            acc[w, :, 32 * i + off + e]
        block0 = row0 // block_size
        for i in range(blocks_per_tile * _BF16_Q):
            b, n = i % blocks_per_tile, i // blocks_per_tile
            gb, qi = block0 + b, q0 + n
            if gb >= n_blocks or qi >= n_q:
                continue
            out[qi, gb] = maxima[b * per:b * per + per, n].max()
            writes[qi, gb] += 1
    return out, writes


def _exact_bf16(rs, shape):
    """Multiples of 1/8 in [-2, 2]: exact in bf16, and every sum of D ≤ 768
    of their products exact in fp32, so any summation order agrees."""
    return (rs.randint(-16, 17, shape) / 8).astype(np.float32)


@pytest.mark.parametrize("block_size", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("dim", [64, 72, 768])
@pytest.mark.parametrize("n_q", [1, 65, 300])
def test_blockmax_bf16_epilogue_emulated_matches_plain(n_q, dim, block_size):
    """The bf16 route's design on the CPU: the accumulator fragments, the
    in-thread max of rows g and g + 8, the xor-16/8/4 reduce-scatter, the
    maxima tile (and its per-16-row groups for block_size 32; the whole
    score tile for block_size 1, 2 and 4), and the store loop give exactly
    the plain version's block maxima, and the grid writes every output
    once. 448 corpus rows: the last 128-row tile is half empty."""
    rs = np.random.RandomState(n_q * 1000 + dim + block_size)
    q, c = _exact_bf16(rs, (n_q, dim)), _exact_bf16(rs, (448, dim))
    got, writes = _blockmax_bf16_emulated(q, c, block_size)
    want = blockmax_scores_reference(
        torch.as_tensor(q).to(torch.bfloat16),
        torch.as_tensor(c).to(torch.bfloat16), block_size=block_size)
    np.testing.assert_array_equal(writes, 1)
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("block_size", [64, 128])
def test_blockmax_bf16_epilogue_emulated_wide_blocks(block_size):
    """block_size 64 and 128, which the wrapper also takes: the store loop
    maxes 4 and 8 row groups, across warps and across warpgroups."""
    rs = np.random.RandomState(block_size)
    q, c = _exact_bf16(rs, (70, 64)), _exact_bf16(rs, (384, 64))
    got, writes = _blockmax_bf16_emulated(q, c, block_size)
    want = blockmax_scores_reference(
        torch.as_tensor(q).to(torch.bfloat16),
        torch.as_tensor(c).to(torch.bfloat16), block_size=block_size)
    np.testing.assert_array_equal(writes, 1)
    np.testing.assert_array_equal(got, want.numpy())


def test_blockmax_bf16_reduce_scatter_places_each_column_once():
    """After ``lane_max_scatter`` lane (g, c) holds columns 64i + 8g + c + e
    (i = 0..3, e = 0, 1): over a warp's 32 lanes, each of the 256 columns
    exactly once, each the maximum over the 8 lanes g of its c."""
    rs = np.random.RandomState(5)
    acc = rs.randn(4, 32, 128).astype(np.float32)
    want = {}
    for w in range(4):
        for lane in range(32):
            cc = 2 * (lane % 4)
            for j in range(32):
                for e in range(2):
                    col = 8 * j + cc + e
                    same_c = [lane % 4 + 4 * gg for gg in range(8)]
                    want[w, col] = acc[w, same_c, 4 * j + e].max()
    _lane_max_scatter(acc, 0)
    seen = np.zeros((4, 256), np.int64)
    for w in range(4):
        for lane in range(32):
            g, cc = lane // 4, 2 * (lane % 4)
            for i in range(4):
                for e in range(2):
                    col = 64 * i + 8 * g + cc + e
                    seen[w, col] += 1
                    assert acc[w, lane, 32 * i + e] == want[w, col]
    np.testing.assert_array_equal(seen, 1)


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
    # blockmax_bf16 (wgmma + TMA) at the shapes it serves: the 1M search
    # shapes, the serve shapes, ragged Q, D 64 / 72 / 768, block_size 1 /
    # 2 / 4 / 8 / 16 / 32 (fp32 sums of exact products in another order: atol 2e-3 on
    # scores of magnitude ~sqrt(D), as chip_smoke.py)
    g = torch.Generator(device="cuda").manual_seed(8)
    cases = [(Q, 1_000_448, 768, 16) for Q in (2048, 512)]
    cases += [(Q, N, 768, 16) for Q in (1, 64, 256) for N in (16_384, 32_768)]
    cases += [(Q, 4096, D, BS) for Q in (65, 300) for D in (64, 72, 768)
              for BS in (1, 2, 4, 8, 16, 32)]
    for Q, N, D, BS in cases:
        q = torch.randn(Q, D, generator=g, device="cuda").to(torch.bfloat16)
        c = torch.randn(N, D, generator=g, device="cuda").to(torch.bfloat16)
        before = blockmax_scores.launches
        got = blockmax_scores(q, c, block_size=BS)
        assert blockmax_scores.launches == before + 1
        want = blockmax_scores_reference(q, c, block_size=BS)
        torch.cuda.synchronize()
        assert got.shape == (Q, N // BS), (Q, N, D, BS)
        torch.testing.assert_close(got, want, atol=2e-3, rtol=0,
                                   msg=lambda m: f"{(Q, N, D, BS)}: {m}")
        del q, c, got, want
        torch.cuda.empty_cache()


@pytest.mark.cuda
def test_blockmax_kernel_rejects_operands_it_cannot_take():
    """bf16 and int8 queries go to the tensor-core kernels only (TMA boxes
    of 16-byte rows; 8-element chunks): D % 8 != 0 or a misaligned base
    raises, never runs a second kernel. The launcher itself refuses them
    too (cudaErrorInvalidValue), for bf16 × bf16 without handing the call
    to the WMMA kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from ance_tpu_torch.ops.topk import _kernel_library
    q = torch.ones(4, 100, dtype=torch.bfloat16, device="cuda")
    c100 = torch.ones(1024, 100, dtype=torch.bfloat16, device="cuda")
    before = blockmax_scores.launches
    with pytest.raises(ValueError, match="D % 8"):
        blockmax_scores(q, c100)
    q8 = torch.ones(4, 8, dtype=torch.int8, device="cuda")
    shifted = torch.ones(1025, 8, dtype=torch.int8, device="cuda")[1:]
    with pytest.raises(ValueError, match="aligned"):
        blockmax_scores(q8, shifted)
    qb = torch.ones(4, 64, dtype=torch.bfloat16, device="cuda")
    cb = torch.ones(1024 * 64 + 1, dtype=torch.bfloat16,
                    device="cuda")[1:].view(1024, 64)  # base 2 bytes off
    with pytest.raises(ValueError, match="aligned"):
        blockmax_scores(qb, cb)
    assert blockmax_scores.launches == before
    lib = _kernel_library()
    out = torch.full((4, 64), -7.0, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for qq, cc, d in ((q, c100, 100), (qb, cb, 64), (qb[:, 1:], cb, 63)):
        err = lib.blockmax_scores_launch(1, 1, qq.data_ptr(), cc.data_ptr(),
                                         out.data_ptr(), 4, 1024, d, 16,
                                         stream)
        assert err == 1  # cudaErrorInvalidValue, nothing launched
    torch.cuda.synchronize()
    assert bool((out == -7.0).all())
