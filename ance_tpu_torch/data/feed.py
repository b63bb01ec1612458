"""Host-side triple batches from token caches (numpy only).

The port's own copy of ``ance_tpu/data/feed.py`` (the trainer's part of
it): a training-data line ``qid \\t pos_pid \\t neg1,neg2,...`` expands into
one (query, positive, negative) triple per negative (or, for DPR, one
triple with a negative drawn at random), and batches are
vectorised gathers over the memory-mapped caches, attention masks from the
stored lengths. Batches are the JAX package's, byte for byte, on the same
caches and seed, host by host: with ``num_hosts`` ranks each takes its
stripe of the triples (``TripletBatches``).
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Sequence

import numpy as np

from ance_tpu_torch.data.cache import TokenCache
from ance_tpu_torch.train.encode import mask_from_lengths

# the name prefix of every feed thread: ``epoch_prefetched``'s pool threads
# ("feed_0", ...) and ``prefetch_batches``' worker ("feed-prefetch")
FEED_THREAD_PREFIX = "feed"


def parse_triple_line(line: str) -> tuple[int, int, list[int]]:
    """``qid\\tpos\\tneg1,neg2,...`` (reference msmarco_data.py:338-343)."""
    qid_s, pos_s, negs_s = line.rstrip("\n").split("\t")
    return int(qid_s), int(pos_s), [int(x) for x in negs_s.split(",")]


def expand_triples(lines: Sequence[str]) -> np.ndarray:
    """Lines → [T, 3] int64 (qid, pos_pid, neg_pid), one row per negative."""
    rows = []
    for line in lines:
        if not line.strip():
            continue
        qid, pos, negs = parse_triple_line(line)
        for neg in negs:
            rows.append((qid, pos, neg))
    return np.asarray(rows, dtype=np.int64).reshape(-1, 3)


def sample_one_neg_triples(lines: Sequence[str], seed: int = 0) -> np.ndarray:
    """Lines → [T, 3] with ONE negative per line drawn by
    ``np.random.RandomState(seed)``: the DPR feed (reference
    DPR_data.py:321-327 shuffles the negatives and takes the first). The
    JAX function's draws, so both packages pick the same negative."""
    rs = np.random.RandomState(seed)
    rows = []
    for line in lines:
        if not line.strip():
            continue
        qid, pos, negs = parse_triple_line(line)
        rows.append((qid, pos, negs[rs.randint(len(negs))]))
    return np.asarray(rows, dtype=np.int64).reshape(-1, 3)


def gather_padded(cache: TokenCache, keys: np.ndarray
                  ) -> tuple[np.ndarray, np.ndarray]:
    """(ids [B, L] int32, mask [B, L] int32) for a batch of cache offsets."""
    lengths, tokens = cache.batch(keys)
    return tokens.astype(np.int32), mask_from_lengths(
        lengths, cache.embedding_size)


@dataclasses.dataclass
class TripletBatches:
    """(query, pos, neg) batches from caches and training-data triples.

    ``seed >= 0`` shuffles the triples each epoch (``RandomState(seed +
    epoch)``); an incomplete trailing batch is dropped. With ``num_hosts``
    ranks, rank ``host_id`` takes every ``num_hosts``-th triple from its
    own index on (the reference's StreamingDataset striping,
    utils/util.py:318-329) and shuffles that stripe."""

    query_cache: TokenCache
    passage_cache: TokenCache
    triples: np.ndarray            # [T, 3] from expand_triples
    batch_size: int
    seed: int = -1
    host_id: int = 0
    num_hosts: int = 1

    def __len__(self) -> int:
        local = len(range(self.host_id, self.triples.shape[0],
                          self.num_hosts))
        return local // self.batch_size

    def _epoch_triples(self, epoch_idx: int) -> np.ndarray:
        triples = self.triples[self.host_id::self.num_hosts]
        if self.seed >= 0:
            perm = np.random.RandomState(self.seed + epoch_idx).permutation(
                triples.shape[0])
            triples = triples[perm]
        return triples

    def _build_batch(self, rows: np.ndarray) -> dict:
        q_ids, q_mask = gather_padded(self.query_cache, rows[:, 0])
        p_ids, p_mask = gather_padded(self.passage_cache, rows[:, 1])
        n_ids, n_mask = gather_padded(self.passage_cache, rows[:, 2])
        return {"query_ids": q_ids, "query_mask": q_mask,
                "pos_ids": p_ids, "pos_mask": p_mask,
                "neg_ids": n_ids, "neg_mask": n_mask}

    def epoch(self, epoch_idx: int = 0) -> Iterator[dict]:
        triples = self._epoch_triples(epoch_idx)
        B = self.batch_size
        for start in range(0, triples.shape[0] - B + 1, B):
            yield self._build_batch(triples[start:start + B])

    def epoch_prefetched(self, epoch_idx: int = 0, workers: int = 4,
                         depth: int = 8) -> Iterator[dict]:
        """``epoch()`` with up to ``workers`` batches gathered at once on
        threads (the same batches in the same order): gathers from a cache
        that is not in the page cache wait on disk with the GIL released.
        ``depth`` bounds the finished batches held ahead."""
        triples = self._epoch_triples(epoch_idx)
        B = self.batch_size
        pending: collections.deque = collections.deque()
        with ThreadPoolExecutor(max_workers=workers,
                                thread_name_prefix=FEED_THREAD_PREFIX) as ex:
            try:
                for s in range(0, triples.shape[0] - B + 1, B):
                    pending.append(
                        ex.submit(self._build_batch, triples[s:s + B]))
                    if len(pending) >= max(depth, workers):
                        yield pending.popleft().result()
                while pending:
                    yield pending.popleft().result()
            finally:
                for f in pending:
                    f.cancel()


def prefetch_batches(batches: Iterator[dict], depth: int = 4
                     ) -> Iterator[dict]:
    """``batches`` staged ahead on one background thread ("feed-prefetch"):
    the same batches in the same order, at most ``depth`` of them waiting.
    An exception in the worker is raised again at the consumer; closing
    the generator (or dropping it) stops the worker within 0.1 s."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    end = object()

    def put(item) -> bool:
        """Put ``item`` unless told to stop; False when told."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for b in batches:
                if not put(b):
                    return
            item = end
        except BaseException as e:  # raised again at the consumer
            item = e
        put(item)

    t = threading.Thread(target=worker, daemon=True,
                         name=f"{FEED_THREAD_PREFIX}-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


def feed_threads() -> set:
    """The live threads whose name starts with ``FEED_THREAD_PREFIX``:
    the feed's gather pools and prefetch workers."""
    return {t for t in threading.enumerate()
            if t.name.startswith(FEED_THREAD_PREFIX) and t.is_alive()}


def live_feed_threads(ignore=()) -> int:
    """How many feed threads live, leaving out those in ``ignore`` (the
    ones a caller saw before it started)."""
    return len(feed_threads() - set(ignore))


def infinite_batches(batches: TripletBatches, *,
                     workers: int = 8) -> Iterator[dict]:
    """Re-iterate epochs forever (the reference re-iterates its dataset on
    StopIteration); ``workers > 0`` gathers through ``epoch_prefetched``,
    ``0`` serially. Closing it closes the epoch's iterator at once (its
    gather threads end then), not when the garbage collector finds it:
    some Python 3.12 releases keep a closed generator's locals until the
    generator itself is freed."""
    epoch = 0
    while True:
        yielded = False
        it = (batches.epoch_prefetched(epoch, workers=workers) if workers
              else batches.epoch(epoch))
        try:
            for b in it:
                yielded = True
                yield b
        finally:
            it.close()
        if not yielded:
            raise ValueError("dataset smaller than one batch")
        epoch += 1
