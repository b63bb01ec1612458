"""The host feed at MS MARCO's cache geometry (the port of
``docs/perf_feed_r5.py``): random-access triple gathers over an 18.14 GB
passage cache, cold and warm, and what they cost a training step.

The caches are written in bulk (``perf_refresh8m8.build_cache``, the JAX
scripts' byte-identical writer): 8,841,823 passage records at seq 512 and
502,939 query records at seq 64, under ``--root`` (~18.3 GB; where the
disk has less room the passage count is cut to what fits, and the first
line says so). Batches are the port's ``TripletBatches`` (batch 64: 192
random records a batch) over 200 batches of random (query, passage,
passage) triples from ``RandomState(7)``. Seven phases, each with fresh
caches opened:

  1. ``cold_random``: serial gathers (``epoch``), the cache cold;
  2. ``warm_random``: the same, warm (the page cache's ceiling);
  3. ``cold_random_workers8``: ``epoch_prefetched`` (8 threads);
  4-7. ``*_sim_train_*``: a consumer that sleeps ``--step_ms`` a batch (the
     card's batch-64 train step, as ``perf_refresh8m8``'s
     ``train_no_refresh`` measures it) and reports the stall a step, with
     no prefetch, ``prefetch_batches`` (one thread), and
     ``epoch_prefetched`` (8 threads) cold and warm.

"Cold" evicts only this script's own files, never the machine's page
cache: every mapping of the caches is dropped (the kernel keeps the pages
a live mapping holds), each file is ``fsync``'d and given
``posix_fadvise(POSIX_FADV_DONTNEED)``, and fresh caches are opened; the
share of the passage file still resident after that (``mincore`` on a
mapping of it) is printed beside the phase. The first line names the
host's CPU and the filesystem under ``--root``.

    python -m ance_tpu_torch.experiments.perf_feed --step_ms MS
        [--root DIR] [--passages N] [--log feed.jsonl]

Host only: no device is touched. Against the JAX script: ``--step_ms``
in place of its 95.6 ms (a TPU v5e step), the eviction in place of
writing ``/proc/sys/vm/drop_caches``, and numbers unrounded.
"""

from __future__ import annotations

import argparse
import ctypes
import gc
import mmap
import os
import platform
import shutil
import tempfile
import time
from typing import Callable, Iterator, Optional

import numpy as np

from ance_tpu_torch.data.cache import TokenCache
from ance_tpu_torch.data.feed import TripletBatches, prefetch_batches
from ance_tpu_torch.experiments.demo import Log
from ance_tpu_torch.experiments.perf_refresh8m8 import build_cache

N_PASSAGES = 8_841_823
N_QUERIES = 502_939
PLEN, QLEN = 512, 64
B = 64
N_BATCHES = 200
ROOM_MARGIN_BYTES = 1 << 30  # left free on the disk when the cut is made


def record_bytes(seq: int) -> int:
    return 4 + 4 * seq


def fit_passages(free_bytes: int, passages: int, queries: int) -> int:
    """The most passages (at most ``passages``) whose cache fits beside the
    query cache in ``free_bytes`` less ROOM_MARGIN_BYTES."""
    room = free_bytes - ROOM_MARGIN_BYTES - queries * record_bytes(QLEN)
    return max(0, min(passages, room // record_bytes(PLEN)))


def host_info(root: str) -> dict:
    """The host's CPU model and cores, and the filesystem under ``root``
    (the longest mount point above it in ``/proc/mounts``)."""
    cpu = platform.processor() or None
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    cpu = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    fs, mount = None, ""
    real = os.path.realpath(root)
    try:
        with open("/proc/mounts") as f:
            for line in f:
                parts = line.split()
                point = parts[1]
                if (real == point or real.startswith(point.rstrip("/") + "/")) \
                        and len(point) >= len(mount):
                    mount, fs = point, parts[2]
    except OSError:
        pass
    return {"cpu": cpu, "cores": os.cpu_count(), "fs": fs, "mount": mount,
            "free_gb": shutil.disk_usage(root).free / 1e9}


def resident_share(path: str) -> Optional[float]:
    """The share of ``path``'s pages in the page cache (``mincore`` on a
    fresh read-only mapping, which faults nothing in); None where the
    calls are not available."""
    size = os.path.getsize(path)
    if size == 0:
        return 0.0
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        libc.mmap.restype = ctypes.c_void_p
        libc.mmap.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
                              ctypes.c_int, ctypes.c_int, ctypes.c_long]
        libc.munmap.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
        libc.mincore.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                 ctypes.c_void_p]
    except (OSError, AttributeError):
        return None
    pages = -(-size // mmap.PAGESIZE)
    vec = np.zeros(pages, np.uint8)
    fd = os.open(path, os.O_RDONLY)
    try:
        addr = libc.mmap(None, size, mmap.PROT_READ, mmap.MAP_SHARED, fd, 0)
        if addr is None or addr == ctypes.c_void_p(-1).value:
            return None
        try:
            if libc.mincore(addr, size, vec.ctypes.data) != 0:
                return None
        finally:
            libc.munmap(addr, size)
    finally:
        os.close(fd)
    return float((vec & 1).mean())


def evict(paths: list[str]) -> None:
    """Drop these files' pages from the page cache: ``fsync`` then
    ``POSIX_FADV_DONTNEED`` over the whole file. Pages a live mapping
    holds stay, so every cache over them must be closed first."""
    gc.collect()  # a closed TokenCache's memmap goes with its last view
    for path in paths:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        finally:
            os.close(fd)


def batch_times(feed_iter: Iterator[dict], n: int, step_ms: float) -> dict:
    """ms between consecutive batches as fast as the feed gives them."""
    times = []
    t_prev = time.perf_counter()
    for _ in feed_iter:
        t = time.perf_counter()
        times.append((t - t_prev) * 1000.0)
        t_prev = t
        if len(times) >= n:
            break
    a = np.asarray(times)
    return {"batches": len(times), "p50_ms": float(np.percentile(a, 50)),
            "p99_ms": float(np.percentile(a, 99)), "mean_ms": float(a.mean()),
            "rows_per_s": B * 1000.0 / float(a.mean())}


def simulated_train(feed_iter: Iterator[dict], n: int, step_ms: float
                    ) -> dict:
    """A consumer that takes ``step_ms`` a batch (sleeping, so the feed's
    threads run meanwhile); the wait for each batch is its stall."""
    stalls = []
    while len(stalls) < n:
        t0 = time.perf_counter()
        try:
            next(feed_iter)
        except StopIteration:
            break
        stalls.append((time.perf_counter() - t0) * 1000.0)
        time.sleep(step_ms / 1000.0)
    a = np.asarray(stalls)
    return {"batches": len(stalls),
            "stall_p50_ms": float(np.percentile(a, 50)),
            "stall_p99_ms": float(np.percentile(a, 99)),
            "stall_mean_ms": float(a.mean()),
            "step_overhead_pct": 100.0 * float(a.mean()) / step_ms}


PHASES: list[tuple[str, Callable, Callable, bool]] = [
    ("cold_random", lambda f: f.epoch(0), batch_times, True),
    ("warm_random", lambda f: f.epoch(0), batch_times, False),
    ("cold_random_workers8",
     lambda f: f.epoch_prefetched(0, workers=8, depth=16), batch_times, True),
    ("cold_sim_train_noprefetch", lambda f: f.epoch(0), simulated_train,
     True),
    ("cold_sim_train_prefetch_1thread",
     lambda f: prefetch_batches(f.epoch(0), depth=8), simulated_train, True),
    ("cold_sim_train_workers8",
     lambda f: f.epoch_prefetched(0, workers=8, depth=16), simulated_train,
     True),
    ("warm_sim_train_workers8",
     lambda f: f.epoch_prefetched(0, workers=8, depth=16), simulated_train,
     False),
]


def make_triples(n_queries: int, n_passages: int, n_batches: int
                 ) -> np.ndarray:
    """The JAX script's random triples: ``RandomState(7)``, 8 batches
    spare."""
    rs = np.random.RandomState(7)
    n_rows = B * (n_batches + 8)
    return np.stack([rs.randint(0, n_queries, n_rows),
                     rs.randint(0, n_passages, n_rows),
                     rs.randint(0, n_passages, n_rows)], axis=1)


def run_phase(name: str, make_iter: Callable, measure: Callable,
              cold: bool, paths: dict, triples: np.ndarray, n_batches: int,
              step_ms: float) -> dict:
    """One phase over freshly opened caches (evicted first when ``cold``);
    the feed is closed before the caches."""
    if cold:
        evict([paths["passages"], paths["queries"]])
    resident = resident_share(paths["passages"])
    with TokenCache(paths["queries"]) as qc, \
            TokenCache(paths["passages"]) as pc:
        feed = TripletBatches(qc, pc, triples, batch_size=B, seed=-1)
        it = make_iter(feed)
        try:
            out = measure(it, n_batches, step_ms)
        finally:
            it.close()
    out["cold"] = cold
    out["resident_share_at_start"] = resident
    if measure is simulated_train:
        out["step_ms"] = step_ms
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--step_ms", type=float, required=True,
                   help="the simulated train step: the card's batch-64 "
                   "step (perf_refresh8m8's train_no_refresh step_ms)")
    p.add_argument("--root", default=os.path.join(tempfile.gettempdir(),
                                                  "ance_feed"))
    p.add_argument("--passages", type=int, default=N_PASSAGES)
    p.add_argument("--queries", type=int, default=N_QUERIES)
    p.add_argument("--batches", type=int, default=N_BATCHES)
    p.add_argument("--log", default=None,
                   help="JSON-lines file the lines are appended to")
    return p.parse_args(argv)


def run(args, log: Optional[Log] = None) -> dict:
    """The host line, the caches, the seven phases → {name: record}."""
    log = log or Log(args.log)
    os.makedirs(args.root, exist_ok=True)
    paths = {"passages": os.path.join(args.root, "passages"),
             "queries": os.path.join(args.root, "queries")}
    # room for what is not written yet (a cache already there is kept)
    free = shutil.disk_usage(args.root).free
    for name in paths:
        if os.path.exists(paths[name]):
            free += os.path.getsize(paths[name])
    passages = fit_passages(free, args.passages, args.queries)
    if passages < 2:
        raise SystemExit(f"{args.root}: {free / 1e9:.1f} GB free, too "
                         "little for the caches")
    out = {"host": log(host=host_info(args.root), passages=passages,
                       queries=args.queries, plen=PLEN, qlen=QLEN, batch=B,
                       reduced=None if passages == args.passages else {
                           "passages": [args.passages, passages],
                           "why": "disk room under --root"})}
    for name, n, seq in (("passages", passages, PLEN),
                         ("queries", args.queries, QLEN)):
        built = build_cache(paths[name], n, seq)
        if built is not None:
            log(**built)
    triples = make_triples(args.queries, passages, args.batches)
    for name, make_iter, measure, cold in PHASES:
        out[name] = log(**{name: run_phase(
            name, make_iter, measure, cold, paths, triples, args.batches,
            args.step_ms)})[name]
    log(done=True)
    return out


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
