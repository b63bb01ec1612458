"""The readers of the program's spans and counters: nothing recorded (or a
port without them) reads None; a store or counter filled by hand reads the
number worked out by hand."""

import pytest

from ance_tpu_torch.train.encode import iter_cache_batches
from ance_tpu_torch.utils import observability as obs
from benchmark import harness

PHASES = ["topk_phase1_ms", "topk_phase2_ms", "topk_phase3_ms"]
SPAN_READERS = PHASES + ["mine_shuffle_ms"]


def reader(name):
    return harness.load_module("metrics", name).read


@pytest.fixture(autouse=True)
def _empty_store():
    obs.reset_spans()
    yield
    obs.reset_spans()


def _fill(**totals):
    """The store as if the profiler had recorded these spans."""
    for name, kw in totals.items():
        obs._totals[name] = obs._Total(**kw)


@pytest.mark.parametrize("name", SPAN_READERS)
def test_span_readers_read_none_with_nothing_recorded(name, monkeypatch):
    assert reader(name)({}) is None
    _fill(**{"index.search": {"calls": 1}})  # no phase, no mining
    assert reader(name)({}) is None
    monkeypatch.delattr(obs, "span_totals")  # the parent's port
    assert reader(name)({}) is None


@pytest.mark.parametrize("n", [1, 2, 3])
def test_phase_reader_is_device_ms_over_searches(n):
    name = f"topk.phase{n}"
    _fill(**{"index.search": {"calls": 2, "host_ns": 9_000_000},
             name: {"calls": 6, "host_ns": 5_000_000, "device_ms": None}})
    assert reader(f"topk_phase{n}_ms")({}) is None  # spans on the CPU
    obs._totals[name].device_ms = 30.5  # three query groups, two searches
    assert reader(f"topk_phase{n}_ms")({}) == pytest.approx(15.25)


def test_shuffle_reader_is_host_ms_over_mined_chunks():
    _fill(**{"ann_gen.mine_negatives": {"calls": 4, "host_ns": 9 * 10**8},
             "ann_gen.shuffle": {"calls": 8, "host_ns": 6 * 10**8,
                                 "self_ns": 6 * 10**8}})
    assert reader("mine_shuffle_ms")({}) == pytest.approx(150.0)


@pytest.mark.parametrize("name", ["token_use.encode", "token_use.mine"])
def test_token_use_reader_is_real_tokens_over_slots(name, monkeypatch):
    monkeypatch.setattr(iter_cache_batches, "real_tokens", 0)
    monkeypatch.setattr(iter_cache_batches, "token_slots", 0)
    assert reader(name)({}) is None  # nothing encoded
    monkeypatch.setattr(iter_cache_batches, "real_tokens", 3 * 64 + 17)
    monkeypatch.setattr(iter_cache_batches, "token_slots", 4 * 64)
    assert reader(name)({}) == pytest.approx(100 * 209 / 256)
    monkeypatch.delattr(iter_cache_batches, "token_slots")  # parent's port
    assert reader(name)({}) is None
