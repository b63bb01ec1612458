"""Torch FlatIPIndex vs the JAX FlatIPIndex on the same embeddings."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ance_tpu.index.flat import FlatIPIndex as JaxIndex
from ance_tpu.index.flat import quantize_dims_int8 as jax_quantize_dims
from ance_tpu.index.flat import quantize_rows_int8 as jax_quantize_rows
from ance_tpu_torch.index.flat import (FlatIPIndex, merge_topk,
                                       quantize_dims_int8, quantize_rows_int8)

torch.set_num_threads(1)

_QUANT = {"none": False, "dims": "dims", "rows": "rows"}


def _data(n=300, d=16, q=9, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, d).astype(np.float32),
            rs.randn(q, d).astype(np.float32))


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("quant,build", [
    ("none", "add"), ("dims", "add"), ("rows", "add"),
    ("none", "add_chunked"), ("dims", "add_chunked")])  # rows: add() only
def test_search_matches_jax(quant, build):
    """Same corpus, same queries: identical ids, scores within 1e-5
    (fp32 sums in another order; quantized codes are identical)."""
    emb, q = _data()
    ji = JaxIndex(dim=16, method="scan", quantize=_QUANT[quant])
    pi = FlatIPIndex(dim=16, device="cpu", quantize=_QUANT[quant])
    if build == "add":
        ji.add(emb)
        pi.add(emb)
    else:
        ji.add_chunked(emb, slice_rows=64)
        pi.add_chunked(emb, slice_rows=64)
    assert pi.ntotal == ji.ntotal == 300
    js, jid = ji.search(q, 10)
    ps, pid = pi.search(q, 10)
    np.testing.assert_array_equal(_np(pid), _np(jid))
    np.testing.assert_allclose(_np(ps), _np(js), atol=1e-5, rtol=0)
    # the port's blockmax (auto) and scan paths agree on the same index
    if quant != "rows":
        pi.method = "scan"
        ss, sid = pi.search(q, 10)
        np.testing.assert_array_equal(_np(sid), _np(pid))


def test_update_slice_matches_jax():
    """allocate + update_slice (in place) + set_scales on a dims index,
    then search — against the same sequence in JAX."""
    emb, q = _data(n=200, seed=1)
    scales = np.abs(emb).max(0) / 127.0
    ji = JaxIndex(dim=16, quantize="dims")
    pi = FlatIPIndex(dim=16, device="cpu", quantize="dims")
    for idx in (ji, pi):
        idx.allocate(200, 16, slice_rows=64, scales=scales)
        buf = idx._emb
        for s in range(0, 200, 64):
            idx.update_slice(s, emb[s:s + 64])
        idx.set_scales(scales * 1.5)
        idx.update_slice(64, emb[64:128] * 0.5)
    assert pi._emb.data_ptr() == buf.data_ptr()  # written in place
    np.testing.assert_array_equal(_np(pi._emb), _np(ji._emb))
    js, jid = ji.search(q, 7)
    ps, pid = pi.search(q, 7)
    np.testing.assert_array_equal(_np(pid), _np(jid))
    np.testing.assert_allclose(_np(ps), _np(js), atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="aligned"):
        pi.update_slice(10, emb[:4])


def test_int8_codes_identical_to_jax():
    emb, _ = _data(n=128, seed=2)
    emb[3, 5] = 0.0
    for jf, pf in ((jax_quantize_dims, quantize_dims_int8),
                   (jax_quantize_rows, quantize_rows_int8)):
        jv, js = jf(jnp.asarray(emb))
        pv, ps = pf(torch.as_tensor(emb))
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))


@pytest.mark.parametrize("method", ["blockmax", "scan"])
def test_ids_minus_one_when_k_exceeds_ntotal(method):
    emb, q = _data(n=5, seed=3)
    pi = FlatIPIndex(dim=16, device="cpu", method=method)
    pi.add(emb)
    s, i = pi.search(q, 8)
    assert (_np(i)[:, 5:] == -1).all()
    assert sorted(_np(i)[0, :5].tolist()) == list(range(5))
    ji = JaxIndex(dim=16, method="scan")
    ji.add(emb)
    js, jid = ji.search(q, 8)
    np.testing.assert_array_equal(_np(i), _np(jid))


@pytest.mark.parametrize("kind", ["f32", "bf16", "dims", "rows"])
def test_npz_round_trip_both_directions(tmp_path, kind):
    """JAX-written .npz loads in the port and the port's loads in JAX,
    bit for bit, including bf16 (stored as a uint16 view)."""
    emb, q = _data(n=100, seed=4)
    kw = {"f32": {}, "bf16": {}, "dims": {"quantize": "dims"},
          "rows": {"quantize": "rows"}}[kind]
    jdtype = jnp.bfloat16 if kind == "bf16" else jnp.float32
    tdtype = torch.bfloat16 if kind == "bf16" else torch.float32
    ji = JaxIndex(dim=16, dtype=jdtype, method="scan", **kw)
    ji.add(emb)
    ji.save(str(tmp_path / "jax"))
    pi = FlatIPIndex(dim=16, device="cpu", dtype=tdtype, **kw)
    pi.add(emb)
    pi.save(str(tmp_path / "port"))

    from_jax = FlatIPIndex.load(str(tmp_path / "jax"), device="cpu")
    from_port = JaxIndex.load(str(tmp_path / "port"), method="scan")
    for a, b in ((from_jax, ji), (pi, from_port)):
        assert a.ntotal == b.ntotal and a.quantize == b.quantize
        ta = a._emb[:a.ntotal]
        if ta.dtype == torch.bfloat16:
            ta = ta.to(torch.float32)
        np.testing.assert_array_equal(
            ta.numpy(), np.asarray(b._emb[:b.ntotal], np.float32))
        if a.quantize:
            np.testing.assert_array_equal(a._scales.numpy()[:a.ntotal],
                                          np.asarray(b._scales)[:b.ntotal])
    ps, pid = from_jax.search(q, 5)
    js, jid = ji.search(q, 5)
    np.testing.assert_array_equal(_np(pid), _np(jid))


def test_merge_topk_matches_union_top_k():
    rs = np.random.RandomState(5)
    s = torch.as_tensor(rs.randn(3, 4, 6).astype(np.float32))
    i = torch.arange(3 * 4 * 6).reshape(3, 4, 6)
    top_s, top_i = merge_topk(s, i, 5)
    flat_s = s.permute(1, 0, 2).reshape(4, -1)
    want = torch.sort(flat_s, dim=1, descending=True).values[:, :5]
    torch.testing.assert_close(top_s, want)
    assert top_i.shape == (4, 5)
