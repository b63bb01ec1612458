"""The port's spans (``utils/observability.py::span``) and the feed's token
counters: nothing recorded without a profiler; under one, ranges in the
trace and a store of calls, host and self time, parents and, on the card,
device time; the spans in the search, the feed and the encoder; results
the same with the profiler on and off. Imports no JAX, so the ``cuda``
test runs on the card as it is."""

import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ance_tpu_torch.data.cache import TokenCache, TokenCacheWriter
from ance_tpu_torch.utils import observability as obs
from ance_tpu_torch.utils.observability import reset_spans, span, span_totals

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _empty_store():
    reset_spans()
    yield
    reset_spans()


def _cpu_profiler():
    return profile(activities=[ProfilerActivity.CPU])


def test_span_off_is_the_shared_noop_and_records_nothing():
    assert not torch.autograd._profiler_enabled()
    a, b = span("test.a"), span("test.b", torch.device("cpu"))
    assert a is b is obs._NO_SPAN
    with a:
        with span("test.c"):
            time.sleep(0.001)
    assert span_totals() == {}


def test_nested_spans_in_the_trace_and_the_store(tmp_path):
    """Sleep-timed nest: outer (2 ms) around inner (5 ms) twice, then a
    sibling; the trace holds each as a user annotation, the store counts
    calls, host time at least the sleeps, self time = host time less the
    children's, and each span's parent."""
    with _cpu_profiler() as prof:
        with span("test.outer"):
            time.sleep(0.002)
            for _ in range(2):
                with span("test.inner"):
                    time.sleep(0.005)
        with span("test.sibling"):
            pass
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert sorted(names) == ["test.inner", "test.inner", "test.outer",
                             "test.sibling"]
    outer_ev = next(e for e in events if e.get("name") == "test.outer")
    for e in events:
        if e.get("name") == "test.inner":  # inside the outer range
            assert outer_ev["ts"] <= e["ts"]
            assert e["ts"] + e["dur"] <= outer_ev["ts"] + outer_ev["dur"]

    got = span_totals()
    assert set(got) == {"test.outer", "test.inner", "test.sibling"}
    outer, inner = got["test.outer"], got["test.inner"]
    assert (outer["calls"], inner["calls"], got["test.sibling"]["calls"]) \
        == (1, 2, 1)
    assert inner["host_s"] >= 0.010 and outer["host_s"] >= 0.012
    assert inner["self_s"] == inner["host_s"]  # no children
    assert outer["self_s"] == pytest.approx(
        outer["host_s"] - inner["host_s"], abs=1e-9)
    assert 0.002 <= outer["self_s"] < outer["host_s"] - 0.010
    assert (outer["parent"], inner["parent"],
            got["test.sibling"]["parent"]) == (None, "test.outer", None)
    assert all(t["device_ms"] is None for t in got.values())
    reset_spans()
    assert span_totals() == {}


def _cache(path, lengths, width):
    with TokenCacheWriter(path, width) as w:
        for i, n in enumerate(lengths):
            w.write(n, np.full(width, i + 1))
    return TokenCache(path).open()


@pytest.mark.parametrize("num_hosts", [1, 2])
def test_feed_counts_real_tokens_and_slots_by_hand(tmp_path, num_hosts):
    """Seven records (one longer than the width) at batch 4: the last
    batch is three real rows and one repeat. Each rank counts the real
    rows of its block, capped at the width, against every row it encodes
    times the width. Under a profiler each batch is one ``encode.feed``
    span, closed before the consumer's own span opens."""
    from ance_tpu_torch.train.encode import iter_cache_batches
    lengths, width = [3, 9, 1, 6, 8, 2, 5], 8
    cache = _cache(str(tmp_path / "c"), lengths, width)
    capped = np.minimum(lengths, width)
    blocks = [range(0, 4), range(4, 8)]  # global rows of each batch
    per = 4 // num_hosts
    for host in range(num_hosts):
        real0 = iter_cache_batches.real_tokens
        slots0 = iter_cache_batches.token_slots
        want = sum(int(capped[r]) for rows in blocks
                   for r in list(rows)[host * per:(host + 1) * per]
                   if r < len(lengths))
        reset_spans()
        with _cpu_profiler():
            for keys, ids, mask in iter_cache_batches(
                    cache, 4, host_id=host, num_hosts=num_hosts):
                with span("test.consumer"):
                    assert ids.shape == mask.shape == (per, width)
        assert iter_cache_batches.real_tokens - real0 == want
        assert iter_cache_batches.token_slots - slots0 == 2 * per * width
        got = span_totals()
        assert got["encode.feed"]["calls"] == 2
        assert got["encode.feed"]["parent"] is None
        assert got["test.consumer"]["parent"] is None
    assert want == (3 + 8 + 1 + 6 + 8 + 2 + 5 if num_hosts == 1
                    else 1 + 6 + 5)  # rank 1: rows 2-3 and 6 (7 repeats 6)
    cache.close()


@pytest.mark.parametrize("groups", [1, 3])
def test_search_records_each_phase_once_a_query_group(monkeypatch, groups):
    """``FlatIPIndex.search`` is one ``index.search`` span holding the
    three phases, each once a query group; the result is the one without
    a profiler."""
    from ance_tpu_torch.index.flat import FlatIPIndex
    from ance_tpu_torch.ops import topk
    rs = np.random.RandomState(0)
    queries = rs.randn(groups * 64, 16).astype(np.float32)
    index = FlatIPIndex(dim=16, device="cpu")
    index.add(rs.randn(3000, 16).astype(np.float32))
    monkeypatch.setattr(topk, "query_group_rows", lambda *a: 64)
    plain = index.search(queries, 10)
    assert span_totals() == {}
    with _cpu_profiler():
        traced = index.search(queries, 10)
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)
    got = span_totals()
    assert got["index.search"]["calls"] == 1
    for phase in ("topk.phase1", "topk.phase2", "topk.phase3"):
        assert got[phase]["calls"] == groups
        assert got[phase]["parent"] == "index.search"
        assert got[phase]["device_ms"] is None
    assert sum(got[p]["host_s"] for p in ("topk.phase1", "topk.phase2",
                                          "topk.phase3")) \
        <= got["index.search"]["host_s"]


@pytest.mark.parametrize("method", ["body_emb", "body_emb_multichunk"])
def test_encoder_spans_and_the_same_embeddings(method):
    """One forward of a two-layer RobertaDot: the embeddings and the head
    once, each layer and its attention once a layer, nested so; the
    embeddings equal those without a profiler."""
    from ance_tpu_torch.models.dot_models import RobertaDot
    from ance_tpu_torch.models.transformer import EncoderConfig
    torch.manual_seed(0)
    cfg = EncoderConfig(vocab_size=50, hidden_size=16, num_layers=2,
                        num_heads=2, intermediate_size=32,
                        max_position_embeddings=40, hidden_dropout=0.0,
                        attention_dropout=0.0)
    model = RobertaDot(cfg, out_dim=8, base_len=8).eval()
    ids = torch.randint(3, 50, (3, 16))
    mask = torch.ones_like(ids)
    mask[1, 5:] = 0
    fn = getattr(model, method)
    with torch.inference_mode():
        plain = fn(ids, mask)
        with _cpu_profiler():
            traced = fn(ids, mask)
    assert torch.equal(plain, traced)
    got = span_totals()
    calls = {name: t["calls"] for name, t in got.items()}
    assert calls == {"encoder.embeddings": 1, "encoder.layer": 2,
                     "encoder.attention": 2, "encoder.head": 1}
    assert got["encoder.attention"]["parent"] == "encoder.layer"
    assert got["encoder.layer"]["self_s"] < got["encoder.layer"]["host_s"]


@pytest.mark.cuda
def test_search_phases_cover_the_search_on_the_card():
    """At a shape the device's work dominates (2,048 fp32 queries over
    1M × 768 fp32 rows), the three phases' device ms sum to within 10% of
    CUDA events around the whole search, and the ``index.search`` span's
    own device ms is that search's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from ance_tpu_torch.index.flat import FlatIPIndex
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    index = FlatIPIndex(dim=768, device=dev)
    index.add(torch.randn(1 << 20, 768, device=dev, generator=g))
    queries = torch.randn(2048, 768, device=dev, generator=g)
    index.search(queries, 200)  # builds and warms the kernel
    torch.cuda.synchronize(dev)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with profile(activities=[ProfilerActivity.CPU]):
        start.record()
        index.search(queries, 200)
        end.record()
    torch.cuda.synchronize(dev)
    whole = start.elapsed_time(end)
    got = span_totals()
    phases = sum(got[p]["device_ms"] for p in ("topk.phase1", "topk.phase2",
                                              "topk.phase3"))
    assert got["index.search"]["calls"] == 1
    assert phases == pytest.approx(whole, rel=0.10), (phases, whole)
    assert got["index.search"]["device_ms"] == pytest.approx(whole,
                                                             rel=0.10)
