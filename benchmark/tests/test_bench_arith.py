"""FLOPs, bytes, rooflines and the trace's interval arithmetic on shapes
worked out by hand."""

import pytest

from benchmark import flops
from benchmark.trace import merged, reduce_trace, union_length

CFG = {"hidden_size": 4, "intermediate_size": 16, "num_hidden_layers": 2,
       "embedding_head": {"out_dim": 4}}


def test_encoder_flops_by_hand():
    # a layer: 2·(4·16 + 2·4·16) = 384 a token, 4·L·H = 16·L a token
    # lengths 3 and 1: 384·4 + 16·(9 + 1) = 1696; two layers 3392; the
    # head 2·4·4 = 32 a sequence, 64
    assert flops.encoder_flops([3, 1], CFG) == 3392 + 64
    assert flops.encoder_flops([3, 0, 1], CFG, head_rows=2) == 3392 + 64


def test_roberta_base_matches_24_h_squared():
    cfg = {"hidden_size": 768, "intermediate_size": 3072,
           "num_hidden_layers": 12, "embedding_head": {"out_dim": 768}}
    per_token = 24 * 768 ** 2 * 12
    got = flops.encoder_flops([1], cfg) - 2 * 768 * 768
    assert got == per_token + 12 * 4 * 768


def test_chunk_lengths():
    assert flops.chunk_lengths([1300, 512, 2048], 512, 4).tolist() == [
        512, 512, 276, 0, 512, 0, 0, 0, 512, 512, 512, 512]


def test_attention_and_search_work():
    f, b = flops.attention_work([2, 3], CFG)
    assert f == 2 * 4 * 4 * (4 + 9) and b == 2 * 4 * 4 * 2 * 5
    ops, nbytes = flops.search_work(2, 10, 3, 4)
    assert ops == 120 and nbytes == 10 * 3 * 4 + 2 * 3 * 4 + 2 * 4 * 12


def test_roofline_and_mfu():
    peak, bw = flops.PEAK_BF16_FLOPS, flops.PEAK_HBM_BYTES
    # compute-bound: the bound is ops / peak; measured twice that: 50%
    assert flops.roofline_pct(peak, 1.0, 2.0) == pytest.approx(50.0)
    # memory-bound: bytes / bandwidth
    assert flops.roofline_pct(1.0, bw, 4.0) == pytest.approx(25.0)
    assert flops.roofline_pct(1.0, 1.0, 0.0) is None
    assert flops.mfu_pct(peak * 3, 10.0) == pytest.approx(30.0)


def test_interval_union():
    assert union_length([(0, 2), (1, 3), (5, 6)]) == 4
    assert union_length([(0, 10), (2, 3)]) == 10
    assert merged([(5, 6), (0, 2), (1, 3)]) == [(0, 3), (5, 6)]


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_reduce_trace_by_hand():
    """A 100 µs slice: kernels at [10, 30) and [20, 40) on two streams
    (busy 30), [60, 70) (busy 10): busy 40 µs, idle 60. The first two are
    launched inside ``bench.search``, the third outside it. The gaps
    [0, 10) and [70, 100) fall in ``aten::item`` and no op, [40, 60) in a
    runtime call."""
    ev = [_x("user_annotation", "bench.slice", 0, 100),
          _x("user_annotation", "bench.search", 5, 20),
          _x("cuda_runtime", "cudaLaunchKernel", 6, 1, corr=1),
          _x("cuda_runtime", "cudaLaunchKernel", 8, 1, corr=2),
          _x("cuda_runtime", "cudaLaunchKernel", 30, 1, corr=3),
          _x("kernel", "k1", 10, 20, tid=7, corr=1),
          _x("kernel", "k2", 20, 20, tid=8, corr=2),
          _x("kernel", "k1", 60, 10, tid=7, corr=3),
          _x("cpu_op", "aten::item", 0, 9),
          _x("cuda_runtime", "cudaStreamSynchronize", 41, 18)]
    out = reduce_trace(ev, ranges=("bench.search",))
    assert out["window_s"] == pytest.approx(100e-6)
    assert out["busy_s"] == pytest.approx(40e-6)
    assert out["range_device_s"]["bench.search"] == pytest.approx(30e-6)
    assert out["range_calls"]["bench.search"] == 1
    assert dict(out["device_ops"]) == pytest.approx({"k1": 30e-6,
                                                     "k2": 20e-6})
    gaps = dict(out["idle_gaps"])
    assert gaps == pytest.approx({"python (no op open)": 30e-6,
                                  "cudaStreamSynchronize": 20e-6,
                                  "aten::item": 10e-6})
