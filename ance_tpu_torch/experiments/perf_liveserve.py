"""Serving from the training program on the card: what a serving thread
costs the pipelined loop, and the tails of concurrent HTTP clients across
refresh boundaries (the port of ``docs/perf_liveserve_r4.py`` and its
follow-up ``docs/perf_servetails_r5.py``, which share the loop and its
``PipelineConfig``).

A real ``PipelinedAnce`` at 100,000 passages of seq 128 (256 train and
64 dev queries of seq 32; tokens from ``RandomState(0)``, written as the
scripts write them), a RoBERTa-base-geometry ``RobertaDot`` in bf16, LAMB
on ``warmup_linear(1e-5, 100, 100_000)``, the loop's default fp32 index
(kernel #1's ``blockmax_pieces_f32``; ``--index_dtype bf16`` gives a bf16
index, ``blockmax_bf16``), a ``LoopRetriever`` behind
``RetrieverHTTPServer`` as ``cli ance-loop --http`` wires them. Every
timed phase is one whole refresh cycle (the work items differ wildly in
cost, so a window of another length compares other work). A JSON line a
stage, with the scripts' names and keys:

  * ``bootstrap_s``; one cycle off the clock (first calls of every shape);
  * ``train_alone``: one cycle of training;
  * ``train_while_serving``: one cycle with a thread calling
    ``LoopRetriever.search_tokens`` (B = 64, k = 10) back to back:
    ``train_slowdown_pct``, ``served_qps``;
  * for each client arm: ``ready``; ``idle_chip``: 4 HTTP clients POSTing
    B = 64 back to back for 20 s with the loop stopped;
    ``during_refresh_cycle``: the 4 clients across one whole cycle, the
    finalize's swap under ``loop.index_lock`` included: p50 / p90 / p99 /
    max, ``served_qps`` and the server's ``lock_wait_ms_per_req``;
  * ``kernels``: kernel #1's launches against the searches served plus the
    loop's S and M items; ``done``: the threads left after shutdown.

Beyond the scripts: the gaps between train steps in every cycle (a CUDA
event after each step, read after the cycle; ``step_gap``), whether a
client's load stretches every step or some; ``loop.index_lock`` timed,
its holds and waits by the loop's thread and the servers' (``lock``);
the client arms, ``thread`` (the scripts': threads of the serving
process) and ``process`` (the 4 clients in one spawned process,
``http_clients.py``, so that only the server's own JSON shares the loop's
interpreter lock); and ``live_vs_scan``: searches of each window sampled
inside ``loop.index_lock`` (at least 32 when as many were served, spread
over the window) with a copy of the index as it stood, each held after
the window to a scan of that copy on the same query embeddings, ids
exactly (ties lower id first in both).

    python -m ance_tpu_torch.experiments.perf_liveserve --device cuda
        [--clients thread,process] [--index_dtype bf16]
        [--log liveserve.jsonl]

The weights come from the integer of the scripts' ``PRNGKey(0)``, the
loop's dropout from ``PRNGKey(1)``'s; other random values than JAX's.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from typing import Optional

import numpy as np
import torch

from ance_tpu_torch.data.cache import TokenCache, TokenCacheWriter
from ance_tpu_torch.data.feed import feed_threads, live_feed_threads
from ance_tpu_torch.experiments import http_clients
from ance_tpu_torch.experiments.demo import DTYPES, Log
from ance_tpu_torch.experiments.perf_http import cuda_device, start_line
from ance_tpu_torch.experiments.perf_refresh8m8 import (
    StepClock, build_model, reset_blockmax_counts, sync)
from ance_tpu_torch.index.flat import FlatIPIndex
from ance_tpu_torch.models.dot_models import RobertaDot
from ance_tpu_torch.ops.topk import blockmax_scores, rescore
from ance_tpu_torch.optim.schedules import warmup_linear
from ance_tpu_torch.serve import LoopRetriever
from ance_tpu_torch.serve_http import RetrieverHTTPServer
from ance_tpu_torch.train.pipelined import PipelineConfig, PipelinedAnce
from ance_tpu_torch.train.trainer import (init_train_state, make_optimizer,
                                          make_train_step, triplet_loss_fn)

N_P, PLEN, QLEN = 100_000, 128, 32
N_TQ, N_DQ = 256, 64
SERVE_B = 64
N_CLIENTS = 4
K = 10
IDLE_S = 20.0
LR, LR_WARMUP, LR_TOTAL = 1e-5, 100, 100_000
LOOP_SEED = 1
SAMPLES = 64  # live searches kept a window: between SAMPLES and 2 x SAMPLES
ARMS = ("thread", "process")


def pipeline_config(slice_size: int = 4096) -> PipelineConfig:
    """The scripts' ``PipelineConfig`` (``docs/perf_servetails_r5.py:113-117``
    = ``docs/perf_liveserve_r4.py:67-71``)."""
    return PipelineConfig(
        train_steps_per_slice=8, encode_slice_size=slice_size,
        encode_batch_size=128, batch_size=32, topk_training=64,
        negative_sample=4, ann_chunk_factor=1, dev_search_depth=10,
        search_chunk_queries=256)


def write_caches(root: str, rs: np.random.RandomState, passages: int = N_P,
                 train_q: int = N_TQ, dev_q: int = N_DQ) -> dict:
    """The scripts' caches, drawn from ``rs`` (their ``RandomState(0)``,
    whose next draw is the served batch): every record full length, in
    the order passages, train, dev."""
    paths = {}
    for name, n, L in (("passages", passages, PLEN),
                       ("train-query", train_q, QLEN),
                       ("dev-query", dev_q, QLEN)):
        paths[name] = os.path.join(root, name)
        with TokenCacheWriter(paths[name], L) as w:
            for _ in range(n):
                w.write(L, rs.randint(4, 50000, L).astype(np.int32))
    return paths


class TimedLock:
    """``threading.Lock`` for ``with`` that keeps each section's wait and
    hold (seconds) and who took it: the loop's thread or a server's."""

    def __init__(self, loop_thread: threading.Thread):
        self._lock = threading.Lock()
        self._local = threading.local()
        self.loop_thread = loop_thread
        self.sections: list[tuple[str, float, float]] = []

    def __enter__(self):
        t0 = time.perf_counter()
        self._lock.acquire()
        self._local.t = (t0, time.perf_counter())
        return self

    def __exit__(self, *exc):
        t0, t1 = self._local.t
        hold = time.perf_counter() - t1
        self._lock.release()
        who = "loop" if threading.current_thread() is self.loop_thread \
            else "serve"
        self.sections.append((who, t1 - t0, hold))
        return False

    def summary(self, since: int = 0) -> dict:
        """The sections since the ``since``-th: count, wait and hold ms
        (total, mean, p99, max) by who took the lock."""
        out = {}
        for who in ("loop", "serve"):
            w = np.array([s[1] for s in self.sections[since:]
                          if s[0] == who]) * 1e3
            h = np.array([s[2] for s in self.sections[since:]
                          if s[0] == who]) * 1e3
            out[who] = {"n": int(len(h))} if not len(h) else {
                "n": int(len(h)),
                "wait_ms_total": float(w.sum()),
                "wait_ms_mean": float(w.mean()),
                "wait_ms_max": float(w.max()),
                "hold_ms_total": float(h.sum()),
                "hold_ms_mean": float(h.mean()),
                "hold_ms_p99": float(np.percentile(h, 99)),
                "hold_ms_max": float(h.max())}
        return out


class Recorder:
    """Live searches sampled inside ``loop.index_lock``: each kept search's
    query embeddings and rows with a copy of the index as it stood (one
    copy an index state; the loop's ``allocate``, ``set_scales`` and
    ``update_slice`` each make a new state). Searches of a window are
    kept at a stride that doubles whenever 2 x SAMPLES are held (every
    other one dropped), so the kept ones spread over the window."""

    def __init__(self, samples: int = SAMPLES):
        self.cap = samples
        self.searches = 0  # every search, armed or not
        self.version = 0
        self.armed = False

    def attach(self, index: FlatIPIndex) -> None:
        """Count ``index``'s state changes (the loop calls these under
        the lock)."""
        for name in ("allocate", "set_scales", "update_slice"):
            real = getattr(index, name)

            def bumped(*args, _real=real, **kwargs):
                out = _real(*args, **kwargs)
                self.version += 1
                return out
            setattr(index, name, bumped)

    def arm(self) -> None:
        self.armed, self.window = True, 0
        self.stride, self.samples, self.states = 1, [], {}

    def record(self, index: FlatIPIndex, q: torch.Tensor,
               rows: torch.Tensor) -> None:
        """Called inside the lock, after the search."""
        self.searches += 1
        if not self.armed:
            return
        i, self.window = self.window, self.window + 1
        if i % self.stride:
            return
        if self.version not in self.states:
            self.states[self.version] = (
                index._emb.clone(), None if index._scales is None
                else index._scales.clone(), index.ntotal)
        self.samples.append((self.version, q.clone(), rows.clone()))
        if len(self.samples) >= 2 * self.cap:
            self.samples, self.stride = self.samples[::2], 2 * self.stride
            kept = {v for v, _, _ in self.samples}
            self.states = {v: s for v, s in self.states.items() if v in kept}

    def verify(self, index: FlatIPIndex) -> dict:
        """Disarm; each kept search against a scan of its index copy. A
        search that differs is searched again, alone, through the live
        index's method on the same copy (``rerun_equal_live``: the same
        rows again, so the difference is the search's own and not the
        concurrency's), and its rows' exact scores are set against the
        scan's (``max_rel_score_gap``: the largest difference of the two
        sorted score lists over the scan's top score; near 0 for a swap
        of rows whose scores tie within phase 1's rounding)."""
        self.armed = False
        scan, again = copy.copy(index), copy.copy(index)
        scan.method = "scan"
        equal, first_bad, rerun_live, rerun_scan = 0, None, 0, 0
        gaps, spreads = [], []
        for n, (v, q, rows) in enumerate(self.samples):
            for x in (scan, again):
                x._emb, x._scales, x._ntotal = self.states[v]
            want_s, want = scan.search(q, rows.shape[1])
            if torch.equal(want.cpu(), rows.cpu()):
                equal += 1
                continue
            first_bad = n if first_bad is None else first_bad
            with uncounted():  # a check's search, not one served
                _, redo = again.search(q, rows.shape[1])
            rerun_live += bool(torch.equal(redo.cpu(), rows.cpu()))
            rerun_scan += bool(torch.equal(redo.cpu(), want.cpu()))
            got_s = exact_scores(scan, q, rows).sort(1, descending=True)[0]
            top = want_s[:, :1].abs().clamp_min(1e-30)
            gaps.append(float(((got_s - want_s).abs() / top).max()))
            spreads.append(float(((want_s[:, 0] - want_s[:, -1]).abs()
                                  / top[:, 0]).median()))
        out = {"searches": self.window, "samples": len(self.samples),
               "states": len(self.states), "equal": equal,
               "all_equal": equal == len(self.samples),
               "first_unequal": first_bad}
        if gaps:
            out.update(rerun_equal_live=rerun_live,
                       rerun_equal_scan=rerun_scan,
                       max_rel_score_gap=max(gaps),
                       top_k_rel_spread_median=statistics.median(spreads))
        self.samples, self.states = [], {}
        return out


@contextlib.contextmanager
def uncounted():
    """Kernel #1's launch counts as they were before the block."""
    launches = blockmax_scores.launches
    kernels = dict(blockmax_scores.kernel_launches)
    try:
        yield
    finally:
        blockmax_scores.launches = launches
        blockmax_scores.kernel_launches.clear()
        blockmax_scores.kernel_launches.update(kernels)


def exact_scores(index: FlatIPIndex, q: torch.Tensor,
                 rows: torch.Tensor) -> torch.Tensor:
    """[Q, k] fp64-exact scores (rounded to fp32) of ``rows`` for queries
    ``q`` against ``index``'s rows, as its search rescores them: the
    queries cast to the index's query dtype, the per-dim scales folded
    in; −inf at empty (−1) slots."""
    qc = q.to(index.device, torch.float32 if index.quantize else index.dtype)
    if index.quantize == "dims":
        qc = qc * index._scales
    s = rescore(qc, index._emb[rows.clamp_min(0)])
    return s.masked_fill(rows < 0, float("-inf"))


class ProbedRetriever(LoopRetriever):
    """``LoopRetriever`` whose searches (run inside the loop's lock) are
    handed to a :class:`Recorder`."""

    def __init__(self, loop, recorder: Recorder):
        super().__init__(loop)
        self.recorder = recorder

    def embed_queries(self, ids, mask) -> torch.Tensor:
        self._q = super().embed_queries(ids, mask)
        return self._q

    def _search_rows(self, ids, mask, k: int):
        scores, rows = super()._search_rows(ids, mask, k)
        self.recorder.record(self.index, self._q, rows)
        return scores, rows


class ProcessClients:
    """The clients of :mod:`http_clients` in a process of their own, with
    ``http_clients.Clients``' ``start`` / ``finish``."""

    def __init__(self, url: str, body: dict, clients: int, batch: int,
                 k: int):
        self.cfg = {"url": url, "body": body, "clients": clients,
                    "batch": batch, "k": k}
        self.proc: Optional[subprocess.Popen] = None

    def start(self) -> "ProcessClients":
        self.proc = subprocess.Popen(
            [sys.executable, http_clients.__file__], stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, text=True)
        self.proc.stdin.write(json.dumps(self.cfg) + "\n")
        self.proc.stdin.flush()
        started = self.proc.stdout.readline()
        if not started:
            raise RuntimeError("the client process ended at its start")
        return self

    def finish(self, timeout: float = 120.0) -> dict:
        try:
            out, _ = self.proc.communicate("stop\n", timeout=timeout)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
        return json.loads(out.strip().splitlines()[-1])


@contextlib.contextmanager
def clients_running(arm: str, base: str, body: dict):
    """N_CLIENTS clients of ``arm`` posting ``body`` while the block runs
    → a dict that holds their record (``Clients.finish``) after it; they
    are stopped however the block ends."""
    cls = http_clients.Clients if arm == "thread" else ProcessClients
    clients, res = cls(base + "/search", body, N_CLIENTS, SERVE_B,
                       K).start(), {}
    try:
        yield res
    finally:
        res.update(clients.finish())


def get(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=30) as resp:
        return json.loads(resp.read())


def lat_pcts(ms: list) -> dict:
    """The servetails script's summary of request latencies (ms)."""
    if not ms:
        return {"n": 0, "p50_ms": None, "p90_ms": None, "p99_ms": None,
                "max_ms": None}
    a = np.asarray(ms)
    return {"n": len(ms), "p50_ms": float(np.percentile(a, 50)),
            "p90_ms": float(np.percentile(a, 90)),
            "p99_ms": float(np.percentile(a, 99)),
            "max_ms": float(a.max())}


def gap_ms(clock: StepClock) -> Optional[dict]:
    """The cycle's gaps between train steps (ms)."""
    gaps = clock.gaps_s()
    if not gaps:
        return None
    a = np.asarray(gaps) * 1e3
    return {"n": len(gaps), "p50_ms": float(np.percentile(a, 50)),
            "p90_ms": float(np.percentile(a, 90)),
            "p99_ms": float(np.percentile(a, 99)),
            "max_ms": float(a.max()), "source": clock.source}


def build_loop(paths: dict, device, dtype: torch.dtype,
               overrides: Optional[dict], slice_size: int, index_dtype: str
               ) -> tuple[PipelinedAnce, dict]:
    """The scripts' loop over ``paths``, its step a :class:`StepClock`,
    its lock a :class:`TimedLock` → (loop, open caches)."""
    caches = {n: TokenCache(p).open() for n, p in paths.items()}
    n_p = len(caches["passages"])
    model = build_model(dtype, device, overrides)
    state = init_train_state(model, make_optimizer(
        model, "lamb", warmup_linear(LR, LR_WARMUP, LR_TOTAL)))
    loop = PipelinedAnce(
        pipeline_config(slice_size), state=state,
        train_step=StepClock(make_train_step(triplet_loss_fn()), device),
        generator=torch.Generator().manual_seed(LOOP_SEED),
        query_method=RobertaDot.query_emb, body_method=RobertaDot.body_emb,
        passage_cache=caches["passages"],
        train_query_cache=caches["train-query"],
        dev_query_cache=caches["dev-query"],
        train_qrels={q: {q % n_p: 1}
                     for q in range(len(caches["train-query"]))},
        dev_qrels={q: {q % n_p: 1} for q in range(len(caches["dev-query"]))},
        device=device)
    if index_dtype == "bf16":
        # the loop allocates its buffer in the index it is given
        loop.index = FlatIPIndex(model.embeddingHead.out_features,
                                 device=device, dtype=torch.bfloat16)
    loop.index_lock = TimedLock(threading.current_thread())
    return loop, caches


def timed_cycle(loop: PipelinedAnce, steps: int, device) -> tuple[float, int]:
    """One whole cycle → (wall s, refreshes), the step clock cleared
    first; the device synchronized before the wall is read."""
    loop.train_step.marks.clear()
    r0 = loop.refresh_no
    sync(device)
    t0 = time.perf_counter()
    loop.run(steps)
    sync(device)
    return time.perf_counter() - t0, loop.refresh_no - r0


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype", choices=tuple(DTYPES), default="bf16")
    p.add_argument("--index_dtype", choices=("fp32", "bf16"), default="fp32")
    p.add_argument("--passages", type=int, default=N_P)
    p.add_argument("--train_q", type=int, default=N_TQ)
    p.add_argument("--dev_q", type=int, default=N_DQ)
    p.add_argument("--slice", type=int, default=4096,
                   help="encode_slice_size")
    p.add_argument("--clients", default="thread",
                   help="client arms in order: thread, process or both "
                   "(thread,process)")
    p.add_argument("--idle_s", type=float, default=IDLE_S)
    p.add_argument("--warm_cycles", type=int, default=1)
    p.add_argument("--no_train_while_serving", action="store_true",
                   help="leave out the serving thread's cycle")
    p.add_argument("--encoder_overrides", default=None,
                   help="JSON of EncoderConfig fields over RoBERTa-base's")
    p.add_argument("--log", default=None,
                   help="JSON-lines file the lines are appended to")
    args = p.parse_args(argv)
    args.arms = args.clients.split(",")
    if not args.arms or set(args.arms) - set(ARMS):
        p.error(f"--clients: a comma-separated list of {ARMS}")
    return args


def run(args, log: Optional[Log] = None) -> dict:
    """Every stage in order → {stage: its record} (the client stages a
    list, one record an arm)."""
    log = log or Log(args.log)
    device = cuda_device(args.device)
    threads_before = set(threading.enumerate())
    feed_before = feed_threads()
    overrides = json.loads(args.encoder_overrides) \
        if args.encoder_overrides else None
    out = {"device": start_line(log, device, passages=args.passages,
                                index_dtype=args.index_dtype,
                                clients=args.arms),
           "ready": [], "idle_chip": [], "during_refresh_cycle": []}
    recorder = Recorder()
    srv = None
    with tempfile.TemporaryDirectory(prefix="ance_liveserve_") as root:
        rs = np.random.RandomState(0)
        paths = write_caches(root, rs, args.passages, args.train_q,
                             args.dev_q)
        loop, caches = build_loop(paths, device, DTYPES[args.dtype],
                                  overrides, args.slice, args.index_dtype)
        lock = loop.index_lock
        try:
            reset_blockmax_counts()
            t0 = time.perf_counter()
            loop.bootstrap()
            sync(device)
            steps = len(loop._work) * loop.cfg.train_steps_per_slice
            out["bootstrap_s"] = log(
                stage="bootstrap_s", value=time.perf_counter() - t0,
                ntotal=int(loop.index.ntotal), steps_per_cycle=steps,
                index_dtype=str(loop.index._emb.dtype))
            recorder.attach(loop.index)
            retriever = ProbedRetriever(loop, recorder)
            srv = RetrieverHTTPServer(retriever, port=0).start()
            host, port = srv.address
            base = f"http://{host}:{port}"
            ids = rs.randint(4, 50000, (SERVE_B, QLEN)).astype(np.int32)
            mask = np.ones_like(ids)
            body = {"ids": ids.tolist(), "k": K}
            # the serve shapes' first calls, then a cycle off the clock
            retriever.search_tokens(ids, mask, K)
            http_clients.post(base + "/search", json.dumps(body).encode())
            for _ in range(args.warm_cycles):
                loop.run(steps)

            alone_s, refreshes = timed_cycle(loop, steps, device)
            out["train_alone"] = log(
                stage="train_alone", steps=steps, wall_s=alone_s,
                refreshes=refreshes, steps_per_s=steps / alone_s,
                step_gap=gap_ms(loop.train_step))

            if not args.no_train_while_serving:
                served, stop = {"n": 0}, threading.Event()

                def hammer():
                    while not stop.is_set():
                        retriever.search_tokens(ids, mask, K)
                        served["n"] += 1

                th = threading.Thread(target=hammer, daemon=True,
                                      name="serve-hammer")
                recorder.arm()
                mark = len(lock.sections)
                th.start()
                serving_s, refreshes = timed_cycle(loop, steps, device)
                stop.set()
                th.join(timeout=60)
                out["train_while_serving"] = log(
                    stage="train_while_serving", steps=steps,
                    wall_s=serving_s, refreshes=refreshes,
                    steps_per_s=steps / serving_s,
                    train_slowdown_pct=100 * (serving_s / alone_s - 1),
                    search_batches_served=served["n"],
                    served_qps=served["n"] * SERVE_B / serving_s,
                    step_gap=gap_ms(loop.train_step),
                    lock=lock.summary(mark),
                    live_vs_scan=recorder.verify(loop.index))

            for arm in args.arms:
                out["ready"].append(log(
                    stage="ready", ntotal=int(loop.index.ntotal),
                    steps_per_cycle=steps, clients=N_CLIENTS, batch=SERVE_B,
                    client_arm=arm))
                # the loop stopped: the floor
                recorder.arm()
                mark = len(lock.sections)
                w0 = get(base + "/metrics")["lock_wait_ms_total"]
                with clients_running(arm, base, body) as res:
                    time.sleep(args.idle_s)
                wait_ms = get(base + "/metrics")["lock_wait_ms_total"] - w0
                lat = res["lat_ms"]
                out["idle_chip"].append(log(
                    stage="idle_chip", client_arm=arm, **lat_pcts(lat),
                    qps=len(lat) * SERVE_B / res["window_s"],
                    window_s=res["window_s"],
                    lock_wait_ms_per_req=wait_ms / max(len(lat), 1),
                    errors=res["errors"], first_error=res["first_error"],
                    partial=res["partial"],
                    lock=lock.summary(mark),
                    live_vs_scan=recorder.verify(loop.index)))

                # one whole cycle: slices, searches, the finalize's swap
                recorder.arm()
                mark = len(lock.sections)
                w0 = get(base + "/metrics")["lock_wait_ms_total"]
                with clients_running(arm, base, body) as res:
                    cycle_s, refreshes = timed_cycle(loop, steps, device)
                wait_ms = get(base + "/metrics")["lock_wait_ms_total"] - w0
                lat = res["lat_ms"]
                out["during_refresh_cycle"].append(log(
                    stage="during_refresh_cycle", client_arm=arm,
                    **lat_pcts(lat), cycle_wall_s=cycle_s,
                    served_qps=len(lat) * SERVE_B / cycle_s,
                    lock_wait_ms_per_req=wait_ms / max(len(lat), 1),
                    refreshes=refreshes, steps=steps,
                    train_slowdown_pct=100 * (cycle_s / alone_s - 1),
                    errors=res["errors"], first_error=res["first_error"],
                    partial=res["partial"],
                    step_gap=gap_ms(loop.train_step),
                    lock=lock.summary(mark),
                    live_vs_scan=recorder.verify(loop.index)))
            launches = dict(blockmax_scores.kernel_launches)
            items = sum(tag in "SM" for tag in loop.schedule_trace)
            route = {"fp32": "blockmax_pieces_f32",
                     "bf16": "blockmax_bf16"}[args.index_dtype]
            out["kernels"] = log(
                stage="kernels", launches=launches,
                served_searches=recorder.searches, sm_items=items,
                launches_equal=None if device.type != "cuda" else
                launches == {route: recorder.searches + items})
        finally:
            if srv is not None:
                srv.shutdown()
            loop.close()
            for c in caches.values():
                c.close()
    deadline = time.time() + 10
    left = []
    while time.time() < deadline:
        left = [t.name for t in threading.enumerate()
                if t not in threads_before and t.is_alive()]
        if not left and not live_feed_threads(feed_before):
            break
        time.sleep(0.05)
    out["done"] = log(stage="done", done=True, threads_left=left,
                      feed_threads_after_close=live_feed_threads(
                          feed_before))
    return out


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
