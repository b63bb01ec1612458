"""The port's indexed and seeded token-cache reads and its one-thread
prefetcher (``ance_tpu_torch/data/cache.py::TokenCache``,
``ance_tpu_torch/data/feed.py::prefetch_batches``) against the JAX
package's (``ance_tpu/data/cache.py``, ``ance_tpu/data/feed.py``) on one
written cache and one feed."""

import threading
import time

import numpy as np
import pytest

from ance_tpu.data.cache import TokenCache as JaxCache
from ance_tpu.data.cache import TokenCacheWriter as JaxWriter
from ance_tpu.data.feed import TripletBatches as JaxBatches
from ance_tpu.data.feed import prefetch_batches as jax_prefetch
from ance_tpu_torch.data.cache import TokenCache
from ance_tpu_torch.data.feed import (TripletBatches, expand_triples,
                                      feed_threads, infinite_batches,
                                      live_feed_threads, prefetch_batches)

N_RECORDS, SEQ = 37, 9


def _cache(path):
    """N_RECORDS records of SEQ int32 tokens (lengths 1..SEQ), written by
    the JAX writer."""
    rs = np.random.RandomState(11)
    with JaxWriter(str(path), SEQ) as w:
        for _ in range(N_RECORDS):
            w.write(int(rs.randint(1, SEQ + 1)),
                    rs.randint(0, 50265, SEQ).astype(np.int32))
    return str(path)


def test_indexed_reads_match_jax(tmp_path):
    """``cache[i]`` for every record: the same length and tokens."""
    base = _cache(tmp_path / "c")
    with TokenCache(base) as pc, JaxCache(base) as jc:
        for i in range(N_RECORDS):
            (pl, pt), (jl, jt) = pc[i], jc[i]
            assert pl == jl and isinstance(pl, int)
            np.testing.assert_array_equal(pt, jt)
            assert pt.dtype == jt.dtype == np.int32 and pt.shape == (SEQ,)


@pytest.mark.parametrize("key", [-1, N_RECORDS, N_RECORDS + 5])
def test_out_of_range_raises_jax_message(tmp_path, key):
    base = _cache(tmp_path / "c")
    with pytest.raises(IndexError) as want:
        JaxCache(base)[key]
    with pytest.raises(IndexError) as got:
        TokenCache(base)[key]
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("seed", [-1, 0, 7])
def test_seeded_iteration_matches_jax(tmp_path, seed):
    """``ix_array`` and iteration order at each seed."""
    base = _cache(tmp_path / "c")
    pc, jc = TokenCache(base, seed=seed), JaxCache(base, seed=seed)
    np.testing.assert_array_equal(pc.ix_array, jc.ix_array)
    got, want = list(pc), list(jc)
    assert len(got) == len(want) == N_RECORDS
    for (pl, pt), (jl, jt) in zip(got, want):
        assert pl == jl
        np.testing.assert_array_equal(pt, jt)
    if seed >= 0:
        assert not np.array_equal(pc.ix_array, np.arange(N_RECORDS))
    # batch() is untouched by the seed: it reads the keys it is given
    lengths, tokens = pc.batch([3, 0])
    assert lengths[0] == pc[3][0]
    np.testing.assert_array_equal(tokens[1], pc[0][1])


def _feeds(tmp_path):
    """The same triples over one query and one passage cache, as a port
    and a JAX ``TripletBatches`` (shuffled, batch 4)."""
    qbase, pbase = _cache(tmp_path / "q"), _cache(tmp_path / "p")
    lines = [f"{i}\t{(i * 5) % N_RECORDS}\t{(i + 1) % N_RECORDS},"
             f"{(i + 7) % N_RECORDS}" for i in range(N_RECORDS)]
    triples = expand_triples(lines)
    port = TripletBatches(TokenCache(qbase).open(), TokenCache(pbase).open(),
                          triples, batch_size=4, seed=3)
    jax = JaxBatches(JaxCache(qbase).open(), JaxCache(pbase).open(),
                     triples, batch_size=4, seed=3)
    return port, jax


def test_prefetch_yields_the_jax_batches(tmp_path):
    port, jax = _feeds(tmp_path)
    got = list(prefetch_batches(port.epoch(1), depth=2))
    want = list(jax_prefetch(jax.epoch(1), depth=2))
    assert len(got) == len(want) == len(port) > 0
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype


def test_prefetch_reraises_worker_errors():
    def broken():
        yield {"ok": 1}
        raise RuntimeError("worker failure")

    for fn in (prefetch_batches, jax_prefetch):
        it = fn(broken(), depth=2)
        assert next(it) == {"ok": 1}
        with pytest.raises(RuntimeError, match="worker failure"):
            next(it)


def test_prefetch_depth_one_over_1000_items():
    """depth=1 over 1,000 items: every item in order, and the worker never
    more than one item (plus the one it holds) ahead of the consumer."""
    produced = []

    def source():
        for i in range(1000):
            produced.append(i)
            yield i

    got = []
    for x in prefetch_batches(source(), depth=1):
        # taken from the queue: at most one queued and one in the put
        assert len(produced) - len(got) <= 3, (len(produced), len(got))
        got.append(x)
    assert got == list(range(1000))
    assert got == list(jax_prefetch(iter(range(1000)), depth=1))


def _wait_feed_threads(n: int, timeout: float = 5.0) -> int:
    deadline = time.time() + timeout
    while live_feed_threads() != n and time.time() < deadline:
        time.sleep(0.02)
    return live_feed_threads()


def test_prefetch_worker_ends_on_close():
    """The worker thread is alive (and counted) while the generator runs,
    and gone after ``close()`` with items still staged."""
    assert _wait_feed_threads(0) == 0
    it = prefetch_batches(iter(range(1000)), depth=1)
    assert next(it) == 0
    assert any(t.name == "feed-prefetch" and t.is_alive()
               for t in threading.enumerate())
    assert live_feed_threads() == 1
    it.close()
    assert _wait_feed_threads(0) == 0


def test_feed_thread_count_sees_a_gather_pool(tmp_path):
    """``live_feed_threads`` counts ``epoch_prefetched``'s pool while it
    lives, and 0 once the generator is closed."""
    port, _ = _feeds(tmp_path)
    it = port.epoch_prefetched(0, workers=3, depth=4)
    next(it)
    assert 1 <= live_feed_threads() <= 3
    it.close()
    assert _wait_feed_threads(0) == 0


def test_closing_the_feed_ends_its_epochs_pool(tmp_path):
    """Closing ``infinite_batches`` closes the epoch it is in at once,
    even while the epoch's generator is still referenced (as some Python
    3.12 releases keep a closed generator's locals until it is freed):
    the gather pool is gone when ``close()`` returns."""
    port, _ = _feeds(tmp_path)
    before = feed_threads()
    g = infinite_batches(port, workers=3)
    next(g)
    next(g)
    epoch = g.gi_frame.f_locals["it"]
    assert live_feed_threads(before) >= 1
    g.close()
    assert epoch.gi_frame is None
    assert live_feed_threads(before) == 0
