"""Torch block-max top-k vs the JAX Pallas kernel (interpret mode) and the
scan top-k, on the same numpy inputs."""

import faulthandler

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from ance_tpu.index.flat import quantize_dims_int8 as jax_quantize_dims
from ance_tpu.index.flat import topk_inner_product as jax_scan
from ance_tpu.ops.topk import blockmax_scores as jax_blockmax
from ance_tpu.ops.topk import topk_blockmax as jax_topk_blockmax
from ance_tpu_torch.index.flat import topk_inner_product
from ance_tpu_torch.ops.topk import (blockmax_kernel_for, blockmax_scores,
                                     blockmax_scores_reference,
                                     split_bf16_pieces, topk_blockmax)

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


@pytest.mark.parametrize("group", [1, 3, 8, 13])
def test_topk_blockmax_query_groups_match_jax(monkeypatch, group):
    """The queries through phases 1 and 2 in groups of ``group`` (what
    ``query_group_rows`` gives on the card when the block maxima of all of
    them do not fit; a ragged last group, padding rows in the corpus):
    one phase-1 call a group, and the ids and scores of one pass through
    JAX. On the CPU there is one group."""
    from ance_tpu_torch.ops import topk
    assert topk.query_group_rows(500, 10**6, 64, torch.device("cpu")) == 500
    calls = []
    real = topk.blockmax_scores

    def counted(q, c, **kw):
        calls.append(q.shape[0])
        return real(q, c, **kw)

    monkeypatch.setattr(topk, "blockmax_scores", counted)
    monkeypatch.setattr(topk, "query_group_rows",
                        lambda n, n_blocks, q_tile, device: group)
    rs = np.random.RandomState(9)
    q = rs.randn(13, 16).astype(np.float32)
    c = rs.randn(250, 16).astype(np.float32)  # pads to 256
    (js, ji), (ps, pi) = _jax_and_port(q, c, 9, block_size=8, chunk_rows=64,
                                       q_tile=4)
    assert len(calls) == -(-13 // group) and sum(calls) == 13
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
_BF16_ROWS, _BF16_Q = 128, 256


def _fragments(tile):
    """A warpgroup's [64, NQ] accumulator (NQ = 256, or 128 for the
    fp32-query routes) as its threads hold it (``csrc/hopper.cuh``'s
    layout, j = 0..NQ/8 - 1): acc[w, lane, 4j + 2h + e] =
    tile[16w + g + 8h, 8j + c + e], g = lane // 4, c = 2 (lane % 4)."""
    n_j = tile.shape[1] // 8
    w, lane, j, h, e = np.meshgrid(np.arange(4), np.arange(32),
                                   np.arange(n_j), np.arange(2), np.arange(2),
                                   indexing="ij")
    g, c = lane // 4, 2 * (lane % 4)
    acc = np.empty((4, 32, 4 * n_j), np.float32)
    acc[w, lane, 4 * j + 2 * h + e] = tile[16 * w + g + 8 * h, 8 * j + c + e]
    return acc


def _lane_max_scatter(acc, off):
    """``lane_max_scatter<Off, NQ>`` on every warp at once: three xor
    shuffles (16, 8, 4), each lane keeping the half of its columns whose j
    bit (4, 2, 1) equals its g bit and maxing in the partner's values."""
    lane = np.arange(32)
    g = lane // 4
    for s in range(3):
        jbit, lanes = 4 >> s, 16 >> s
        up = (g & jbit) != 0
        for j in range(acc.shape[2] // 4):
            if j & (8 - jbit):
                continue
            for e in range(2):
                lo = acc[:, :, 4 * j + off + e].copy()
                hi = acc[:, :, 4 * (j + jbit) + off + e].copy()
                send = np.where(up, lo, hi)
                keep = np.where(up, hi, lo)
                acc[:, :, 4 * j + off + e] = np.maximum(
                    keep, send[:, lane ^ lanes])


def _blockmax_bf16_emulated(q, c, block_size, n_tile=_BF16_Q):
    """What ``blockmax_bf16`` computes, step for step: the grid (query tile
    fastest), each block's tiles as TMA leaves them (rows and columns out of
    bounds zero), its score tile as two warpgroups' fragments, the block
    maxima in registers and through the maxima tile, and the store loop.
    ``n_tile=128``: the fp32-query routes' blocks of 128 queries, the same
    epilogue. Returns (out, how many times each output element was
    written)."""
    n_q, dim = q.shape
    n_rows = c.shape[0]
    n_blocks = n_rows // block_size
    n_q_tiles = -(-n_q // n_tile)
    n_row_tiles = -(-n_rows // _BF16_ROWS)
    n_k = -(-dim // 64)
    out = np.full((n_q, n_blocks), np.nan, np.float32)
    writes = np.zeros((n_q, n_blocks), np.int64)
    # maxima-tile rows a block: 16-row groups, 8-row groups, single rows
    per = block_size // 16 if block_size >= 16 else \
        1 if block_size == 8 else block_size
    blocks_per_tile = _BF16_ROWS // block_size
    for bid in range(n_q_tiles * n_row_tiles):
        q0 = (bid % n_q_tiles) * n_tile
        row0 = (bid // n_q_tiles) * _BF16_ROWS
        qt = np.zeros((n_tile, 64 * n_k), np.float32)
        ct = np.zeros((_BF16_ROWS, 64 * n_k), np.float32)
        qs, cs = q[q0:q0 + n_tile], c[row0:row0 + _BF16_ROWS]
        qt[:len(qs), :dim], ct[:len(cs), :dim] = qs, cs
        scores = np.zeros((_BF16_ROWS, n_tile), np.float32)
        for t in range(n_k):  # one ring stage a 64-column step
            k = slice(64 * t, 64 * t + 64)
            scores += ct[:, k] @ qt[:, k].T
        maxima = np.full((_BF16_ROWS // 8, n_tile + 4), np.nan, np.float32)
        lane = np.arange(32)
        g, cc = lane // 4, 2 * (lane % 4)
        if block_size < 8:  # every row's score, over the spent ring
            maxima = np.full((_BF16_ROWS, n_tile + 4), np.nan, np.float32)
            for wg in range(2):
                acc = _fragments(scores[64 * wg:64 * wg + 64])
                for w in range(4):
                    for h in range(2):
                        for j in range(n_tile // 8):
                            for e in range(2):
                                maxima[16 * (4 * wg + w) + g + 8 * h,
                                       8 * j + cc + e] = \
                                    acc[w, :, 4 * j + 2 * h + e]
        for wg in range(2 if block_size >= 8 else 0):
            acc = _fragments(scores[64 * wg:64 * wg + 64])
            if block_size >= 16:
                for j in range(n_tile // 8):
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
                for i in range(n_tile // 64):
                    for e in range(2):
                        maxima[row, 64 * i + 8 * g + cc + e] = \
                            acc[w, :, 32 * i + off + e]
        block0 = row0 // block_size
        for i in range(blocks_per_tile * n_tile):
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


# ------------------------------------------------ the fp32-query routes

# blockmax_pieces_*'s products a k step of 16, in issue order, as (corpus
# piece, query piece): the six with i + j <= 2 of an fp32 corpus's three
# pieces, the three query pieces against an int8 code
_F32_PRODUCTS = ((0, 0), (1, 0), (0, 1), (2, 0), (1, 1), (0, 2))
_INT8_PRODUCTS = ((0, 0), (0, 1), (0, 2))


def _toward_zero(x):
    """fp64 ``x`` rounded to fp32 toward zero."""
    y = x.float()
    return torch.where(y.double().abs() > x.abs(),
                       torch.nextafter(y, torch.zeros_like(y)), y)


def _blockmax_pieces_emulated(q, c, block_size, stage=32):
    """What ``blockmax_pieces_f32`` / ``_int8`` compute, on the CPU: the
    bf16 pieces of the fp32 queries (``split_bf16_pieces``) and of an fp32
    corpus (the kernel splits it in registers with the same arithmetic; an
    int8 code is its own piece); per 32-column stage a fresh accumulator
    takes, per k step of 16 in the kernel's order, one wgmma each piece
    product: its 16 products summed in fp64 and added with one rounding
    toward zero, as the tensor cores' fp32 accumulation truncates (it is not
    round-to-nearest); and a running total takes each stage's accumulator
    with one round-to-nearest fp32 add (``stage=None``: one accumulator
    over all of D, for contrast). Columns past D are zero in the kernel and
    add nothing. Returns [Q, N/BS]."""
    qp = split_bf16_pieces(q).double()
    if c.dtype == torch.int8:
        cp, products = c.double()[None], _INT8_PRODUCTS
    else:
        cp, products = split_bf16_pieces(c).double(), _F32_PRODUCTS
    n_q, dim = q.shape
    total = torch.zeros(c.shape[0], n_q, dtype=torch.float32)
    stage = stage or -(-dim // 16) * 16
    for s0 in range(0, dim, stage):
        part = torch.zeros_like(total)
        for k0 in range(s0, min(s0 + stage, dim), 16):
            k = slice(k0, k0 + 16)
            for ci, qi in products:
                part = _toward_zero(part.double()
                                    + cp[ci][:, k] @ qp[qi][:, k].T)
        total = total + part
    return total.T.reshape(n_q, -1, block_size).amax(-1)


def _pieces_allowance(q, c, block_size):
    """Per block maximum, how far the fp32-query routes may lie from the
    exact maximum, and the exact maxima (fp64): (U 2^-23 + (S + 1) 2^-24)
    times the maximum over the block's rows of sum_d |q_d c_d|. A stage's
    U accumulator updates (6 piece products a k step of 16 for fp32, 3 for
    int8; two k steps a stage) each truncate by less than an ulp of the
    stage's sum, 2^-23 of its share of that mass; the S = ceil(D / 32)
    round-to-nearest adds to the total each lose at most 2^-24 of it; and
    the last 2^-24 covers the dropped piece products (below 2^-25 of
    |q||c| for fp32; none for int8)."""
    qd, cd = q.double(), c.double()
    n_q, n = q.shape[0], c.shape[0]
    exact = (qd @ cd.T).reshape(n_q, n // block_size, block_size).amax(-1)
    mass = (qd.abs() @ cd.abs().T).reshape(n_q, n // block_size,
                                          block_size).amax(-1)
    updates = (6 if c.dtype == torch.float32 else 3) * 2
    stages = -(-q.shape[1] // 32)
    return exact, (updates * 2.0 ** -23 + (stages + 1) * 2.0 ** -24) * mass


def _normal_floats(rs, shape, lo=-100, hi=127):
    """Random fp32 of both signs over exponents [lo, hi): 24-bit
    significands times 2^e."""
    m = rs.randint(2 ** 23, 2 ** 24, shape).astype(np.float64)
    e = rs.randint(lo - 23, hi - 24, shape)
    sign = np.where(rs.rand(*shape) < 0.5, -1.0, 1.0)
    return (sign * np.ldexp(m, e)).astype(np.float32)


@settings(max_examples=200, deadline=None, database=None)
@given(st.lists(st.tuples(st.integers(2 ** 23, 2 ** 24 - 1),
                          st.integers(-100 - 23, 126 - 23), st.booleans()),
                min_size=1, max_size=64))
def test_split_bf16_pieces_sum_exactly(parts):
    """x0 + x1 + x2 == x for fp32 of either sign across the exponents the
    split takes (2^-100 <= |x| < 2^127) and 0: each piece a bf16, the
    pieces shrinking by 2^8, and their sum exact in fp32 in either
    order."""
    x = np.array([(-1.0 if neg else 1.0) * np.ldexp(float(m), e)
                  for m, e, neg in parts] + [0.0], np.float32)
    t = torch.as_tensor(x)
    pieces = split_bf16_pieces(t)
    assert pieces.shape == (3, len(x)) and pieces.dtype == torch.bfloat16
    x0, x1, x2 = pieces.float()
    assert torch.equal((x0 + x1) + x2, t)
    assert torch.equal(x0 + (x1 + x2), t)
    assert torch.equal(x0, t.to(torch.bfloat16).float())
    nz = t != 0
    assert bool((x1.abs() <= x0.abs() * 2.0 ** -8)[nz].all())
    assert bool((x2.abs() <= x1.abs() * 2.0 ** -8).all())


@pytest.mark.parametrize("ck", ["f32", "int8"])
def test_blockmax_pieces_emulated_matches_jax_kernel(ck):
    """The fp32-query routes' arithmetic (fp32 queries against an fp32 or
    a dims-quantized int8 corpus) against the Pallas kernel in interpret
    mode, as the plain version is: within 1e-5 at D = 48 (three k steps,
    the last stage half zero)."""
    rs = np.random.RandomState(10)
    Q, N, D, BS, CHUNK = 8, 256, 48, 8, 64
    q = rs.randn(Q, D).astype(np.float32)
    c = rs.randn(N, D).astype(np.float32)
    if ck == "int8":
        c8, scales = (np.array(a) for a in jax_quantize_dims(jnp.asarray(c)))
        q, c = (q * scales[None, :]).astype(np.float32), c8
    want = np.asarray(jax_blockmax(jnp.asarray(q), jnp.asarray(c),
                                   block_size=BS, chunk_rows=CHUNK,
                                   interpret=True))
    got = _blockmax_pieces_emulated(torch.as_tensor(q), torch.as_tensor(c),
                                    BS).numpy()
    assert got.shape == want.shape == (Q, N // BS)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("ck", ["f32", "int8"])
@pytest.mark.parametrize("dim", [16, 72, 768])
def test_blockmax_pieces_emulated_within_its_bound(ck, dim):
    """Per block maximum, the emulated route (accumulator updates rounded
    toward zero, a fresh accumulator a 32-column stage) against the exact
    (fp64) maximum: within ``_pieces_allowance``, 2^-23 of the stage's
    mass an update. The queries span eight binades, the corpus rows too,
    so the pieces differ in exponent."""
    rs = np.random.RandomState(dim)
    Q, N, BS = 5, 512, 16
    q = (rs.randn(Q, dim) * np.exp2(rs.randint(-4, 4, (Q, dim)))
         ).astype(np.float32)
    c = (rs.randn(N, dim) * np.exp2(rs.randint(-4, 4, (N, dim)))
         ).astype(np.float32)
    if ck == "int8":
        c = rs.randint(-127, 128, (N, dim)).astype(np.int8)
    q, c = torch.as_tensor(q), torch.as_tensor(c)
    got = _blockmax_pieces_emulated(q, c, BS).double()
    exact, allowed = _pieces_allowance(q, c, BS)
    assert bool(((got - exact).abs() <= allowed).all())
    # and far tighter than bf16 queries would be: the pieces carry fp32
    mass = (q.double().abs() @ c.double().abs().T).reshape(
        Q, N // BS, BS).amax(-1)
    assert float(((got - exact).abs() / mass).max()) < 2.0 ** -20


def _near_duplicates(rs, n_q, n, dim, spread):
    """LayerNorm'd rows around one random vector, as an encoder's
    embeddings of related text: every score near dim, every partial sum
    growing one way."""
    m = rs.randn(dim)

    def rows(k):
        x = torch.as_tensor(m + spread * rs.randn(k, dim), dtype=torch.float32)
        return torch.nn.functional.layer_norm(x, (dim,))
    return rows(n_q), rows(n)


@pytest.mark.parametrize("ck", ["f32", "int8"])
def test_blockmax_pieces_stage_accumulator_on_near_duplicates(ck):
    """Why a fresh accumulator a stage: on near-duplicate LayerNorm'd
    embeddings (scores up to ~760 at D = 768) truncated updates of one
    long running sum drift toward zero by more than chip_smoke.py's
    FLOAT_ATOL (2e-3; half of it for int8 codes, three products a k step
    where fp32 takes six); the route's 32-column stages added to the total
    to nearest stay within a quarter of it and within
    ``_pieces_allowance``."""
    rs = np.random.RandomState(13)
    q, c = _near_duplicates(rs, 4, 64, 768, 0.2)
    if ck == "int8":
        scale = c.abs().amax(0).clamp_min(1e-12) / 127
        c = torch.round(c / scale).clamp(-127, 127).to(torch.int8)
        q = q * scale
    exact, allowed = _pieces_allowance(q, c, 16)
    assert float(exact.max()) > 600
    got = _blockmax_pieces_emulated(q, c, 16).double()
    one = _blockmax_pieces_emulated(q, c, 16, stage=None).double()
    assert bool(((got - exact).abs() <= allowed).all())
    assert float((got - exact).abs().max()) < 2e-3 / 4
    assert float((one - exact).abs().max()) > 2e-3 * (1 if ck == "f32"
                                                       else 0.5)


@pytest.mark.parametrize("block_size", [1, 2, 4, 8, 16, 32, 64, 128])
@pytest.mark.parametrize("n_q", [1, 65, 300])
def test_blockmax_pieces_epilogue_emulated_matches_plain(n_q, block_size):
    """The fp32-query routes' blocks of 128 queries through the shared
    epilogue (``block_maxima<128>``: 16 accumulator n-blocks, the
    reduce-scatter leaving columns 64i + 8g + c + e for i = 0, 1, a maxima
    tile of 132 floats a row): exactly the plain version's block maxima on
    values whose sums are exact, every output written once."""
    rs = np.random.RandomState(n_q * 100 + block_size)
    q, c = _exact_bf16(rs, (n_q, 72)), _exact_bf16(rs, (384, 72))
    got, writes = _blockmax_bf16_emulated(q, c, block_size, n_tile=128)
    want = blockmax_scores_reference(torch.as_tensor(q), torch.as_tensor(c),
                                     block_size=block_size)
    np.testing.assert_array_equal(writes, 1)
    np.testing.assert_array_equal(got, want.numpy())


def _bank_words(addresses, width):
    """Distinct 4-byte words each of the 32 banks serves for one warp's
    loads of ``width`` bytes at ``addresses``."""
    words = {}
    for a in addresses:
        for w in range(a // 4, (a + width + 3) // 4):
            words.setdefault(w % 32, set()).add(w)
    return max(len(v) for v in words.values())


def _stage_offset(r, k, esize, row_bytes):
    """``PieceStage::offset``: the byte of row r, column k of a corpus
    tile whose rows are one swizzle span of ``row_bytes``, the 16-byte
    chunk j of row r at chunk j ^ (r / (128 / row_bytes) % (row_bytes /
    16))."""
    at = k * esize
    swz = (r // (128 // row_bytes)) % (row_bytes // 16)
    return r * row_bytes + (((at >> 4) ^ swz) << 4) + (at & 15)


@pytest.mark.parametrize("ck,cols", [("f32", 32), ("int8", 32),
                                     ("int8", 128)])
def test_blockmax_pieces_a_fragment_gather(ck, cols):
    """The consumer's A-fragment reads from the TMA-loaded corpus tile
    ([128 rows][32 columns] under fp32 queries: fp32 128-byte swizzled,
    the 16-byte chunk j of row r at chunk j ^ (r % 8); int8 32-byte
    swizzled, chunk j at j ^ (r / 4 % 2); [128][128] int8 under bf16
    queries, 128-byte swizzled), through ``PieceStage::offset``: for every
    warp (rows 16 w .. + 15), lane (g, c) and k step, a[i] holds rows
    16 w + g (+ 8 for i = 1, 3) and columns 16 kk + c, + 1 (+ 8 for i = 2,
    3), the layout of hopper.cuh, and its pieces are the split of those
    values; a warp's loads are served in the fewest wavefronts (fp32:
    8-byte loads, each bank two words; int8: 2-byte loads, one word)."""
    rs = np.random.RandomState(11)
    if ck == "f32":
        tile = rs.randn(128, cols).astype(np.float32)
        esize = 4
    else:
        tile = rs.randint(-127, 128, (128, cols)).astype(np.int8)
        esize = 1
    row_bytes = cols * esize
    # the image TMA writes: chunk j of row r at chunk j ^ swizzle(r), the
    # 128-byte swizzle's r % 8 or the 32-byte swizzle's r / 4 % 2
    swizzle = (lambda r: r % 8) if row_bytes == 128 \
        else (lambda r: (r >> 2) & 1)
    image = np.zeros(128 * row_bytes, np.uint8)
    per_chunk = 16 // esize
    for r in range(128):
        for j in range(row_bytes // 16):
            at = r * row_bytes + 16 * (j ^ swizzle(r))
            image[at:at + 16] = tile[r, per_chunk * j:per_chunk * (j + 1)
                                     ].view(np.uint8)

    def offset(r, k):
        return _stage_offset(r, k, esize, row_bytes)
    dtype = np.float32 if ck == "f32" else np.int8
    pieces = split_bf16_pieces(torch.as_tensor(tile).float())
    for warp in range(8):
        for kk in range(cols // 16):
            for i in range(4):
                addresses = []
                for lane in range(32):
                    g, c = lane // 4, 2 * (lane % 4)
                    r = 16 * warp + g + 8 * (i & 1)
                    k = 16 * kk + c + 8 * (i >> 1)
                    at = offset(r, k)
                    addresses.append(at)
                    pair = image[at:at + 2 * esize].view(dtype)
                    np.testing.assert_array_equal(pair, tile[r, k:k + 2])
                    if ck == "f32":  # the kernel's split3 of the pair
                        got = split_bf16_pieces(torch.as_tensor(pair))
                        assert torch.equal(got, pieces[:, r, k:k + 2])
                assert _bank_words(addresses, 2 * esize) == \
                    (2 if ck == "f32" else 1)


def test_blockmax_kernel_for_names_each_route():
    """The kernel each operand pair and shape takes on the card, chosen
    before any launch: bf16 x bf16 -> blockmax_bf16; bf16 or int8 queries
    over int8 at D = 768 -> blockmax_bf16_int8 / blockmax_int8 (the int8
    routes by shape: test_blockmax_kernel_for_names_the_int8_routes);
    fp32 queries -> the pieces kernel of the corpus dtype where a tensor
    map describes the corpus (rows a multiple of 16 bytes, a
    16-byte-aligned base), else blockmax_simt."""
    f32, bf16, i8 = torch.float32, torch.bfloat16, torch.int8

    def named(qd, cd, dim, shift=0):
        c = torch.zeros(64 * dim + shift, dtype=cd)[shift:].view(64, dim)
        return blockmax_kernel_for(torch.zeros(2, dim, dtype=qd), c)

    assert named(bf16, bf16, 768) == "blockmax_bf16"
    assert named(bf16, i8, 768) == "blockmax_bf16_int8"
    assert named(i8, i8, 768) == "blockmax_int8"
    for dim in (64, 72, 96, 768):
        assert named(f32, f32, dim) == "blockmax_pieces_f32"
    for dim in (64, 768):
        assert named(f32, i8, dim) == "blockmax_pieces_int8"
    for qd, cd, dim, shift in ((f32, f32, 66, 0), (f32, f32, 63, 0),
                               (f32, f32, 64, 1), (f32, i8, 72, 0),
                               (f32, i8, 96 + 8, 0), (f32, i8, 64, 8)):
        assert named(qd, cd, dim, shift) == "blockmax_simt", (cd, dim, shift)


@pytest.mark.parametrize("dim,shift,want", [
    (64, 0, "wgmma"), (768, 0, "wgmma"),    # int8 rows of 16-byte multiples
    (72, 0, "blockmax_wmma"), (104, 0, "blockmax_wmma"),  # D % 16 == 8
    (64, 8, "blockmax_wmma")])              # a corpus base 8 bytes off
@pytest.mark.parametrize("qk", ["bf16", "int8"])
def test_blockmax_kernel_for_names_the_int8_routes(qk, dim, shift, want):
    """bf16 and int8 queries over an int8 corpus take the wgmma kernels
    (blockmax_bf16_int8, blockmax_int8) where tensor maps describe both
    operands (D % 16 == 0, 16-byte-aligned bases), and blockmax_wmma where
    not; chosen from dtypes, shapes and addresses, with no launch."""
    c = torch.zeros(64 * dim + shift, dtype=torch.int8)[shift:].view(64, dim)
    q = torch.zeros(2, dim, dtype=_TORCH[qk])
    if want == "wgmma":
        want = "blockmax_int8" if qk == "int8" else "blockmax_bf16_int8"
    assert blockmax_kernel_for(q, c) == want


@pytest.fixture
def pieces_phase1(monkeypatch):
    """Phase 1 of ``topk_blockmax`` (and so of ``FlatIPIndex``) through
    the fp32-query routes' emulation; records the dtype pairs it saw."""
    import ance_tpu_torch.ops.topk as topk_mod
    seen = []

    def phase1(q, c, *, block_size=16, chunk_rows=1024):
        assert q.dtype == torch.float32 and c.shape[0] % chunk_rows == 0
        seen.append((q.dtype, c.dtype))
        return _blockmax_pieces_emulated(q, c, block_size)
    monkeypatch.setattr(topk_mod, "blockmax_scores", phase1)
    return seen


def _with_ties(rs, n, dim, n_q, alpha):
    """A corpus whose every 7th row is one vector, and queries near it
    (alpha 1: its copies top every list and tie there)."""
    c = rs.randn(n, dim).astype(np.float32)
    dup = rs.randn(dim).astype(np.float32)
    c[::7] = dup
    q = (alpha * dup + rs.randn(n_q, dim)).astype(np.float32)
    return q, c


def _eighths(rs, shape, top=16):
    """Multiples of 1/8 in [-top/8, top/8]: every product and every sum of
    a few dozen of them exact in fp32, so any summation order agrees."""
    return (rs.randint(-top, top + 1, shape) / 8).astype(np.float32)


@pytest.mark.parametrize("kind", ["f32", "dims"])
@pytest.mark.parametrize("n,k,data", [(256, 10, "random"),
                                      (700, 40, "random"),
                                      (300, 7, "ties"), (700, 40, "ties")])
def test_topk_blockmax_through_pieces_matches_jax(pieces_phase1, kind, n, k,
                                                  data):
    """``topk_blockmax`` with phase 1 on the fp32-query routes' arithmetic
    gives the JAX package's ids (its Pallas kernel in interpret mode), for
    an fp32 corpus and a dims-quantized one. "random": full fp32 values.
    "ties": every 7th row one vector that tops the queries' lists, on
    values whose fp32 sums are exact (multiples of 1/8; for dims every
    column's maximum 127/8, so each scale is 1/8), so that the JAX
    package's fp32 rescore gives the copies one score and both order them
    by id; otherwise its rescore can break a tie by rounding."""
    rs = np.random.RandomState(n + k)
    D = 24
    if data == "random":
        q = rs.randn(11, D).astype(np.float32)
        c = rs.randn(n, D).astype(np.float32)
    else:
        c = _eighths(rs, (n, D), 127 if kind == "dims" else 16)
        c[::7] = c[0]
        c[1] = np.where(c[0] < 0, 127 / 8, -127 / 8)  # each column's max
        q = (_eighths(rs, (11, D), 8) + 2 * c[0]).astype(np.float32)
    if kind == "dims":
        c8, scales = (np.array(a) for a in jax_quantize_dims(jnp.asarray(c)))
        if data == "ties":
            assert (scales == 1 / 8).all()
        q, c = (q * scales[None, :]).astype(np.float32), c8
    (js, ji), (ps, pi) = _jax_and_port(q, c, k, block_size=8, chunk_rows=64,
                                       q_tile=8)
    assert pieces_phase1 and all(
        pair == (torch.float32, torch.from_numpy(c).dtype)
        for pair in pieces_phase1)
    if data == "ties":  # the copies fill every list's top k
        assert (ji % 7 == 0).all()
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(ps, js, atol=1e-4, rtol=0)


@pytest.mark.parametrize("quant", ["none", "dims"])
@pytest.mark.parametrize("alpha", [1.0, 0.2])
def test_flat_index_through_pieces_matches_jax(pieces_phase1, quant, alpha):
    """``FlatIPIndex`` (fp32 and ``quantize="dims"``, the generator's
    indexes) searching with phase 1 on the fp32-query routes' arithmetic
    returns the JAX index's ids, at k 10 and 50, where every 7th row is
    one vector near the queries."""
    from ance_tpu.index.flat import FlatIPIndex as JaxIndex
    from ance_tpu_torch.index.flat import FlatIPIndex
    rs = np.random.RandomState(12)
    q, c = _with_ties(rs, 400, 32, 9, alpha)
    quantize = False if quant == "none" else "dims"
    ji = JaxIndex(dim=32, method="scan", quantize=quantize)
    pi = FlatIPIndex(dim=32, device="cpu", quantize=quantize)
    ji.add(c)
    pi.add(c)
    for k in (10, 50):
        js, jid = ji.search(q, k)
        ps, pid = pi.search(q, k)
        np.testing.assert_array_equal(pid.numpy(), np.asarray(jid))
        np.testing.assert_allclose(ps.numpy(), np.asarray(js), atol=1e-4,
                                   rtol=0)
    assert len(pieces_phase1) == 2


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
    # the wgmma routes at the shapes they serve: the 1M search shapes, the
    # serve shapes, ragged Q, D 64 / 72 / 768, block_size 1 / 2 / 4 / 8 /
    # 16 / 32, for bf16 x bf16 (blockmax_bf16), fp32 queries against an
    # fp32 or a dims-quantized int8 corpus (blockmax_pieces_*; int8 at D=72
    # takes blockmax_simt), and bf16 / per-row int8 queries against the
    # int8 codes (blockmax_bf16_int8, blockmax_int8; at D=72
    # blockmax_wmma); fp32 sums of exact products in another order: atol
    # 2e-3 on scores of magnitude ~sqrt(D), as chip_smoke.py; int32 exact
    from ance_tpu_torch.index.flat import quantize_dims_int8
    from ance_tpu_torch.ops.topk import quantize_query_rows_int8
    g = torch.Generator(device="cuda").manual_seed(8)
    cases = [(Q, 1_000_448, 768, 16) for Q in (2048, 512)]
    cases += [(Q, N, 768, 16) for Q in (1, 64, 256) for N in (16_384, 32_768)]
    cases += [(Q, 4096, D, BS) for Q in (65, 300) for D in (64, 72, 768)
              for BS in (1, 2, 4, 8, 16, 32)]
    for route in ("bf16xbf16", "f32xf32", "f32xint8", "bf16xint8",
                  "int8xint8"):
        for Q, N, D, BS in cases:
            q = torch.randn(Q, D, generator=g, device="cuda")
            c = torch.randn(N, D, generator=g, device="cuda")
            if route == "bf16xbf16":
                q, c = q.to(torch.bfloat16), c.to(torch.bfloat16)
            elif route.endswith("int8"):
                c, scales = quantize_dims_int8(c)
                q = q * scales
                if route == "bf16xint8":
                    q = q.to(torch.bfloat16)
                elif route == "int8xint8":
                    q = quantize_query_rows_int8(q)
            kernel = blockmax_kernel_for(q, c)
            before = blockmax_scores.kernel_launches[kernel]
            got = blockmax_scores(q, c, block_size=BS)
            assert blockmax_scores.kernel_launches[kernel] == before + 1
            want = blockmax_scores_reference(q, c, block_size=BS)
            torch.cuda.synchronize()
            case = (route, kernel, Q, N, D, BS)
            assert got.shape == (Q, N // BS), case
            if route == "int8xint8":
                assert got.dtype == torch.int32 and torch.equal(got, want), \
                    case
            else:
                torch.testing.assert_close(got, want, atol=2e-3, rtol=0,
                                           msg=lambda m: f"{case}: {m}")
            if kernel.startswith("blockmax_pieces"):
                # per element, against the exact maxima: the route's own
                # bound, which grows with sum |q c| where atol does not
                exact, allowed = _pieces_allowance(q[:64], c, BS)
                assert bool(((got[:64].double() - exact).abs()
                             <= allowed).all()), case
                del exact, allowed
            del q, c, got, want
            torch.cuda.empty_cache()
    # the generator's data: LayerNorm'd near-duplicate embeddings, scores
    # up to ~760, at its mining shape
    q, c = _near_duplicates(np.random.RandomState(14), 1024, 32_768, 768,
                            0.2)
    q, c = q.cuda(), c.cuda()
    codes, scales = quantize_dims_int8(c)
    for qq, cc in ((q, c), (q * scales, codes)):
        got = blockmax_scores(qq, cc)
        want = blockmax_scores_reference(qq, cc)
        torch.testing.assert_close(got, want, atol=2e-3, rtol=0)
        exact, allowed = _pieces_allowance(qq[:64], cc, 16)
        assert bool(((got[:64].double() - exact).abs() <= allowed).all())


@pytest.mark.cuda
def test_blockmax_fp32_query_kernel_by_shape_on_cuda():
    """Each fp32-query shape launches the kernel ``blockmax_kernel_for``
    names, counted under that name: the pieces kernels where a tensor map
    describes the corpus (D 64 / 72 / 96 / 768 fp32, D 64 / 768 int8),
    ``blockmax_simt`` where not (D 66 fp32, D 72 / 104 int8, a misaligned
    fp32 base), each within 1e-3 of the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(9)
    cases = [(torch.float32, 64, 0, "blockmax_pieces_f32"),
             (torch.float32, 72, 0, "blockmax_pieces_f32"),
             (torch.float32, 96, 0, "blockmax_pieces_f32"),
             (torch.float32, 768, 0, "blockmax_pieces_f32"),
             (torch.int8, 64, 0, "blockmax_pieces_int8"),
             (torch.int8, 768, 0, "blockmax_pieces_int8"),
             (torch.float32, 66, 0, "blockmax_simt"),
             (torch.int8, 72, 0, "blockmax_simt"),
             (torch.int8, 104, 0, "blockmax_simt"),
             (torch.float32, 64, 1, "blockmax_simt")]
    for dtype, D, shift, name in cases:
        q = torch.randn(70, D, generator=g, device="cuda")
        c = torch.randn(1024 * D + shift, generator=g, device="cuda")
        c = c[shift:].view(1024, D)  # shift 1: the base 4 bytes off
        if dtype == torch.int8:
            c = torch.randint(-127, 128, (1024, D), generator=g,
                              device="cuda").to(torch.int8)
            q = q / 64
        assert blockmax_kernel_for(q, c) == name, (dtype, D, shift)
        counts = dict(blockmax_scores.kernel_launches)
        got = blockmax_scores(q, c)
        counts[name] = counts.get(name, 0) + 1
        assert dict(blockmax_scores.kernel_launches) == counts
        want = blockmax_scores_reference(q, c)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-5)


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


@pytest.mark.cuda
def test_blockmax_launcher_refuses_what_no_fp32_query_kernel_takes():
    """The launcher never hands a call to another kernel: the pieces
    kernels (type code 3) refuse a corpus a tensor map cannot describe (D
    66 fp32, D 72 int8, a misaligned base) with cudaErrorInvalidValue, as
    it refuses pairs no kernel takes (fp32 or pieces × bf16) and a
    block_size that does not divide the 128-row tile; nothing is
    written."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from ance_tpu_torch.ops.topk import _kernel_library
    lib = _kernel_library()
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.full((4, 64), -7.0, device="cuda")
    pieces = torch.zeros(3, 4, 72, dtype=torch.bfloat16, device="cuda")
    c32 = torch.zeros(1024 * 72 + 1, device="cuda")
    c8 = torch.zeros(1024, 72, dtype=torch.int8, device="cuda")
    cb = torch.zeros(1024, 64, dtype=torch.bfloat16, device="cuda")
    q32 = torch.zeros(4, 64, device="cuda")
    calls = [(3, 0, pieces, c32[:1024 * 66], 66, 16),   # D % 4 != 0
             (3, 2, pieces, c8, 72, 16),                # D % 16 != 0
             (3, 0, pieces, c32[1:], 64, 16),           # base 4 bytes off
             (3, 1, pieces, cb, 64, 16),                # pieces x bf16
             (0, 1, q32, cb, 64, 16),                   # fp32 x bf16
             (3, 0, pieces, c32, 64, 3)]                # block_size 3
    for q_code, c_code, qq, cc, d, bs in calls:
        err = lib.blockmax_scores_launch(q_code, c_code, qq.data_ptr(),
                                         cc.data_ptr(), out.data_ptr(), 4,
                                         1024, d, bs, stream)
        assert err == 1, (q_code, c_code, d, bs)  # cudaErrorInvalidValue
    torch.cuda.synchronize()
    assert bool((out == -7.0).all())


@pytest.mark.cuda
def test_blockmax_launchers_refuse_what_the_int8_kernels_cannot_take():
    """blockmax_int8 and blockmax_bf16_int8 (blockmax_scores_launch with
    codes (2, 2) and (1, 2)) refuse what their tensor maps cannot describe
    (D % 16 != 0, a base not 16-byte aligned) with cudaErrorInvalidValue
    and never hand the call to blockmax_wmma; blockmax_wmma_launch refuses
    D % 8 != 0 and every pair but those two; nothing is written."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from ance_tpu_torch.ops.topk import _kernel_library
    lib = _kernel_library()
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.full((4, 64), -7, dtype=torch.int32, device="cuda")
    q8 = torch.zeros(4, 80, dtype=torch.int8, device="cuda")
    qb = torch.zeros(4, 80, dtype=torch.bfloat16, device="cuda")
    c8 = torch.zeros(1024 * 80 + 16, dtype=torch.int8, device="cuda")
    cb = torch.zeros(1024, 64, dtype=torch.bfloat16, device="cuda")
    calls = [(lib.blockmax_scores_launch, 2, 2, q8, c8, 72),      # D % 16
             (lib.blockmax_scores_launch, 1, 2, qb, c8, 72),      # D % 16
             (lib.blockmax_scores_launch, 2, 2, q8, c8[8:], 64),  # base off
             (lib.blockmax_scores_launch, 1, 2, qb[:, 1:], c8, 64),
             (lib.blockmax_wmma_launch, 2, 2, q8, c8, 68),        # D % 8
             (lib.blockmax_wmma_launch, 2, 2, q8, c8[8:], 64),    # base off
             (lib.blockmax_wmma_launch, 1, 1, qb, cb, 64),        # bf16 pair
             (lib.blockmax_wmma_launch, 0, 2, qb, c8, 64)]        # fp32 x int8
    for launch, q_code, c_code, qq, cc, d in calls:
        err = launch(q_code, c_code, qq.data_ptr(), cc.data_ptr(),
                     out.data_ptr(), 4, 1024, d, 16, stream)
        assert err == 1, (launch.__name__, q_code, c_code, d)
    torch.cuda.synchronize()
    assert bool((out == -7).all())
