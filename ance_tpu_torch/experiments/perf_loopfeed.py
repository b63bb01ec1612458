"""The prefetched feed inside the real pipelined loop on the card (the port
of ``docs/perf_loopfeed_r5.py``).

A ``PipelinedAnce`` at 100,000 passages of seq 128 (256 train and 64 dev
queries of seq 32; tokens from ``RandomState(0)``, written as the JAX
script writes them), a RoBERTa-base-geometry ``RobertaDot`` in bf16 with
LAMB, and a bf16 index (kernel #1's ``blockmax_bf16``), driven through
whole refresh cycles twice: with the prefetched feed (``feed_workers`` 8,
``epoch_prefetched``'s gather pool) and with the serial one (0). Each arm:
bootstrap, one cycle off the clock, then two whole cycles timed. A line an
arm, then the comparison:

  * ``s_per_cycle``; ``feed_threads_live``: the most feed threads alive
    at any train step (one pool of at most 8; the refresh boundary
    replaces the feed, and the replaced one must not leave its pool
    behind);
    ``feed_threads_leaked``: those alive after the loop is closed and
    dropped. Counted by the port's thread names (``data/feed.py``'s
    ``FEED_THREAD_PREFIX``), leaving out threads alive before the arm;
  * ``prefetched_vs_serial_pct``: the prefetched arm's wall against the
    serial one's;
  * the checks the JAX script lacks, on a digest of every train batch from
    the bootstrap's feed to the last step: ``batches_equal_serial_regather``
    (an arm) — the batches the loop took, feed by feed across every
    refresh boundary, equal and in order to what the serial feed gives
    over the same triples afterwards; ``batches_equal`` — the two arms'
    batches equal step for step; ``batches_equal_on_equal_triples`` —
    equal wherever the two arms' refreshes mined the same triples
    (``triples_equal_by_feed``). A refresh whose encoder is the trained
    one can mine other triples in each arm where the arms' training parts
    in its last bits.

    python -m ance_tpu_torch.experiments.perf_loopfeed --device cuda
        [--log loopfeed.jsonl]

The JAX script's loop builds an fp32 index (its ``PipelinedAnce`` default)
although its docstring names a bf16 one; the port gives the loop a bf16
``FlatIPIndex``, as that docstring says. Weights from the integer of the
JAX script's ``PRNGKey(0)``, the loop's dropout from ``PRNGKey(1)``'s.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import hashlib
import itertools
import json
import os
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch

from ance_tpu_torch.data.cache import TokenCache, TokenCacheWriter
from ance_tpu_torch.data.feed import (feed_threads, infinite_batches,
                                      live_feed_threads)
from ance_tpu_torch.experiments.demo import DTYPES, Log
from ance_tpu_torch.experiments.perf_refresh8m8 import build_model, card, sync
from ance_tpu_torch.index.flat import FlatIPIndex
from ance_tpu_torch.models.dot_models import RobertaDot
from ance_tpu_torch.optim.schedules import warmup_linear
from ance_tpu_torch.train import pipelined
from ance_tpu_torch.train.pipelined import PipelineConfig, PipelinedAnce
from ance_tpu_torch.train.trainer import (init_train_state, make_optimizer,
                                          make_train_step, triplet_loss_fn)

N_P, PLEN, QLEN = 100_000, 128, 32
N_TQ, N_DQ = 256, 64
LR, LR_WARMUP, LR_TOTAL = 1e-5, 100, 100_000
LOOP_SEED = 1
ARMS = (("prefetched", 8), ("serial", 0))


def pipeline_config(feed_workers: int, slice_size: int = 4096
                    ) -> PipelineConfig:
    """``docs/perf_loopfeed_r5.py``'s ``PipelineConfig``."""
    return PipelineConfig(
        train_steps_per_slice=8, encode_slice_size=slice_size,
        encode_batch_size=128, batch_size=32, topk_training=64,
        negative_sample=4, ann_chunk_factor=1, dev_search_depth=10,
        search_chunk_queries=256, feed_workers=feed_workers)


def build_caches(root: str, passages: int = N_P, train_q: int = N_TQ,
                 dev_q: int = N_DQ) -> dict:
    """The JAX script's caches: every record full length, tokens drawn
    from one ``RandomState(0)`` in the order passages, train, dev."""
    rs = np.random.RandomState(0)
    paths = {}
    for name, n, L in (("passages", passages, PLEN),
                       ("train-query", train_q, QLEN),
                       ("dev-query", dev_q, QLEN)):
        paths[name] = os.path.join(root, name)
        with TokenCacheWriter(paths[name], L) as w:
            for _ in range(n):
                w.write(L, rs.randint(4, 50000, L).astype(np.int32))
    return paths


class StepProbe:
    """A train step that keeps, for every batch it is given, a digest of
    the batch, the feed threads alive (leaving out ``before``) and which
    of ``feeds`` (the refreshes' feeds so far) it came from."""

    def __init__(self, step: Callable, feeds: list, before=()):
        self.step, self.feeds, self.before = step, feeds, set(before)
        self.digests: list[str] = []
        self.feed_threads: list[int] = []
        self.feed_of_step: list[int] = []

    def __call__(self, state, batch, generator):
        self.digests.append(digest(batch))
        self.feed_threads.append(live_feed_threads(self.before))
        self.feed_of_step.append(len(self.feeds) - 1)
        return self.step(state, batch, generator)


def digest(batch: dict) -> str:
    h = hashlib.sha1()
    for k in sorted(batch):
        h.update(k.encode())
        h.update(np.ascontiguousarray(batch[k]).tobytes())
    return h.hexdigest()


@contextlib.contextmanager
def recorded_feeds():
    """Every ``TripletBatches`` a refresh hands the loop, in order (the
    loop module's name wrapped while the context lasts)."""
    feeds, real = [], pipelined.TripletBatches

    def make(*args, **kwargs):
        feeds.append(real(*args, **kwargs))
        return feeds[-1]
    pipelined.TripletBatches = make
    try:
        yield feeds
    finally:
        pipelined.TripletBatches = real


def serial_digests(feeds: list, feed_of_step: list) -> list[str]:
    """The digests the serial feed gives over the same feeds, as many
    batches of each as the loop took from it."""
    out = []
    for k, feed in enumerate(feeds):
        n = feed_of_step.count(k)
        out += [digest(b) for b in itertools.islice(
            infinite_batches(feed, workers=0), n)]
    return out


def build_loop(paths: dict, feed_workers: int, device, dtype: torch.dtype,
               overrides: Optional[dict] = None, slice_size: int = 4096,
               feeds: Optional[list] = None, before=()
               ) -> tuple[PipelinedAnce, dict]:
    """The JAX script's loop over ``paths`` with a bf16 index on
    ``device``, its step a :class:`StepProbe` → (loop, open caches)."""
    device = torch.device(device)
    caches = {n: TokenCache(p).open() for n, p in paths.items()}
    n_p = len(caches["passages"])
    model = build_model(dtype, device, overrides)
    state = init_train_state(model, make_optimizer(
        model, "lamb", warmup_linear(LR, LR_WARMUP, LR_TOTAL)))
    loop = PipelinedAnce(
        pipeline_config(feed_workers, slice_size), state=state,
        train_step=StepProbe(make_train_step(triplet_loss_fn()),
                             [] if feeds is None else feeds, before),
        generator=torch.Generator().manual_seed(LOOP_SEED),
        query_method=RobertaDot.query_emb, body_method=RobertaDot.body_emb,
        passage_cache=caches["passages"],
        train_query_cache=caches["train-query"],
        dev_query_cache=caches["dev-query"],
        train_qrels={q: {q % n_p: 1}
                     for q in range(len(caches["train-query"]))},
        dev_qrels={q: {q % n_p: 1} for q in range(len(caches["dev-query"]))},
        device=device)
    # the loop allocates its buffer in the index it is given
    loop.index = FlatIPIndex(model.embeddingHead.out_features, device=device,
                             dtype=torch.bfloat16)
    return loop, caches


def run_arm(arm: str, workers: int, paths: dict, device, dtype,
            overrides: Optional[dict] = None, slice_size: int = 4096,
            cycles: int = 2) -> dict:
    """Bootstrap, one cycle off the clock, ``cycles`` whole cycles timed;
    the loop then closed and dropped. → the arm's record, with its batch
    digests under ``_digests``, its feeds under ``_feeds`` and the feed
    of each step under ``_feed_of_step``."""
    device = torch.device(device)
    before = feed_threads()
    with recorded_feeds() as feeds:
        loop, caches = build_loop(paths, workers, device, dtype, overrides,
                                  slice_size, feeds, before)
        t0 = time.perf_counter()
        loop.bootstrap()
        sync(device)
        boot_s = time.perf_counter() - t0
        steps = len(loop._work) * loop.cfg.train_steps_per_slice
        loop.run(steps)
        r0, s0 = loop.refresh_no, int(loop.state.step)
        sync(device)
        t0 = time.perf_counter()
        loop.run(cycles * steps)
        sync(device)
        wall = time.perf_counter() - t0
    probe = loop.train_step
    out = {"arm": arm, "feed_workers": workers, "bootstrap_s": boot_s,
           "steps": cycles * steps, "wall_s": wall,
           "s_per_cycle": wall / cycles, "refreshes": loop.refresh_no - r0,
           "train_steps_taken": int(loop.state.step) - s0,
           "index_dtype": str(loop.index._emb.dtype),
           # the most alive at any step of the run, and at its end (after
           # the last F item replaced the feed, whose pool has not started)
           "feed_threads_live": max(probe.feed_threads),
           "feed_threads_at_end": live_feed_threads(before)}
    loop.close()
    for c in caches.values():
        c.close()
    del loop, caches
    gc.collect()
    deadline = time.time() + 5
    while live_feed_threads(before) and time.time() < deadline:
        time.sleep(0.05)
    out["feed_threads_leaked"] = live_feed_threads(before)
    out["batches"] = len(probe.digests)
    out["feeds"] = len(feeds)
    out["batches_equal_serial_regather"] = probe.digests == serial_digests(
        feeds, probe.feed_of_step)
    out.update(_digests=probe.digests, _feeds=feeds,
               _feed_of_step=probe.feed_of_step)
    return out


def compare_arms(a: dict, b: dict) -> dict:
    """The two arms' batches, step by step, and their feeds' triples,
    refresh by refresh: where the triples are equal the batches must be
    (the feed's work); where they differ, the mining did."""
    da, db = a["_digests"], b["_digests"]
    triples = [bool(np.array_equal(fa.triples, fb.triples))
               for fa, fb in zip(a["_feeds"], b["_feeds"])]
    same_feed = [i for i, (ka, kb) in enumerate(zip(a["_feed_of_step"],
                                                    b["_feed_of_step"]))
                 if ka == kb and all(triples[:ka + 1])]
    return {"batches_equal": da == db,
            "batches_compared": min(len(da), len(db)),
            "first_difference": next((i for i, (x, y) in
                                      enumerate(zip(da, db)) if x != y),
                                     None),
            "triples_equal_by_feed": triples,
            "steps_on_equal_triples": len(same_feed),
            "batches_equal_on_equal_triples": all(
                da[i] == db[i] for i in same_feed)}


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype", choices=tuple(DTYPES), default="bf16")
    p.add_argument("--passages", type=int, default=N_P)
    p.add_argument("--train_q", type=int, default=N_TQ)
    p.add_argument("--dev_q", type=int, default=N_DQ)
    p.add_argument("--slice", type=int, default=4096,
                   help="encode_slice_size")
    p.add_argument("--cycles", type=int, default=2,
                   help="whole cycles timed an arm")
    p.add_argument("--encoder_overrides", default=None,
                   help="JSON of EncoderConfig fields over RoBERTa-base's")
    p.add_argument("--log", default=None,
                   help="JSON-lines file the lines are appended to")
    return p.parse_args(argv)


def run(args, log: Optional[Log] = None) -> dict:
    log = log or Log(args.log)
    device = torch.device(args.device)
    overrides = json.loads(args.encoder_overrides) \
        if args.encoder_overrides else None
    log(device=card(device), passages=args.passages)
    results = {}
    with tempfile.TemporaryDirectory(prefix="ance_loopfeed_") as root:
        paths = build_caches(root, args.passages, args.train_q, args.dev_q)
        for arm, workers in ARMS:
            r = run_arm(arm, workers, paths, device, DTYPES[args.dtype],
                        overrides, args.slice, args.cycles)
            results[arm] = r
            log(**{k: v for k, v in r.items() if not k.startswith("_")})
    return log(prefetched_vs_serial_pct=100.0 * (
        results["prefetched"]["wall_s"] / results["serial"]["wall_s"] - 1),
        **compare_arms(*(results[arm] for arm, _ in ARMS)), done=True)


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
