"""One pipelined ANCE refresh at MS MARCO's 8,841,823 passages on the card:
the corpus re-encode and index refresh minutes, measured end to end (the
port of ``docs/perf_refresh8m8_r5.py``).

The real ``PipelinedAnce``: a RoBERTa-base-geometry ``RobertaDot`` (768
out) in bf16, LAMB, batch 64, passages of seq 128 and queries of seq 32,
an int8 ``dims`` index (or fp32 with ``--index_quantize none``), mining
over the whole corpus through kernel #1 (``blockmax_pieces_int8`` on every
dev search and mining item). Tokens are uniform random ids written in bulk
(``build_cache``, byte for byte the JAX script's files); the weights are
random, from a seed. One JSON line a stage, flushed as it ends (and
appended to ``--log``), so a run that is cut keeps the stages it reached:

  * ``device``: the card's name and power limit (``nvidia-smi``);
  * ``preflight``: before any cache is built, the index at its full
    capacity (8,847,360 rows, 270 slices of 32,768) allocated in ``dims``
    and in fp32, a batch-64 train step beside each, and the peak GiB;
  * ``build_cache``: the passage and query caches;
  * ``bootstrap``: the first refresh, every item back to back;
  * ``warm_step``: one train step off the clock (the card's first-call
    costs);
  * ``cycle``: one production cycle (the JAX script's ``PipelineConfig``):
    wall minutes, item times by tag, and the step gaps — a CUDA event
    recorded after each train step and read after the cycle (the port's
    step does not synchronize, so the events add no sync and one cycle
    gives both the production wall and the gaps);
  * ``train_no_refresh``: 100 steps on the same feed without work items,
    and the refresh's cost to train throughput as the JAX script computes
    it;
  * ``mining_vs_scan``: the ids of the first 64 train queries of the
    cycle's first mining item against an exact scan of the same index;
  * ``kernels``: kernel #1's launches by route against the S and M items
    the schedule ran, and the kernel at the mining item's shape (Q = 512)
    timed with CUDA events beside its bound and its plain version;
  * ``done``: the feed's threads left once the loop is closed.

    python -m ance_tpu_torch.experiments.perf_refresh8m8 --device cuda
        [--root DIR] [--passages N] [--batch 64] [--index_quantize dims]
        [--cycles 1] [--log run.jsonl]

The caches take ~4.6 GB under ``--root`` (default: a directory in the
system's temporary directory); they are kept and reused by a later run.
Against the JAX script: flags in place of its environment variables; one
production cycle gives the gaps (the JAX script ran a second cycle with a
step that forced its loss); the torch generators are seeded with the
integers of the JAX script's ``PRNGKey(0)`` (weights) and ``PRNGKey(1)``
(the loop's dropout), so the weights are other random weights.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import shutil
import statistics
import subprocess
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch

from ance_tpu_torch.data.cache import TokenCache
from ance_tpu_torch.data.feed import feed_threads, live_feed_threads
from ance_tpu_torch.experiments.demo import DTYPES, Log
from ance_tpu_torch.models.dot_models import RobertaDot
from ance_tpu_torch.models.transformer import EncoderConfig, init_weights
from ance_tpu_torch.optim.schedules import warmup_linear
from ance_tpu_torch.ops.topk import (_pad_rows, blockmax_kernel_for,
                                     blockmax_scores,
                                     blockmax_scores_reference)
from ance_tpu_torch.train.pipelined import PipelineConfig, PipelinedAnce
from ance_tpu_torch.train.trainer import (init_train_state, make_optimizer,
                                          make_train_step, triplet_loss_fn)

MSMARCO_PASSAGES = 8_841_823
TRAIN_Q, DEV_Q = 4096, 512
PLEN, QLEN = 128, 32
SLICE = 32_768
OUT_DIM = 768
LR, LR_WARMUP, LR_TOTAL = 1e-5, 1000, 1_000_000
INIT_SEED, LOOP_SEED, WARM_SEED = 0, 1, 9  # the JAX script's PRNGKey ints
NO_REFRESH_STEPS = 100
SAMPLE_QUERIES = 64  # mining ids held against the scan
BUILD_CHUNK_ROWS = 65_536
BLOCK, CHUNK_ROWS = 16, 1024  # kernel #1's block and row multiple
PLAIN_ROWS = 1 << 20  # corpus rows a call of the plain version (memory;
                      # a multiple of CHUNK_ROWS)
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12


def pipeline_config(batch: int = 64, quantize: Optional[str] = "dims",
                    slice_size: int = SLICE) -> PipelineConfig:
    """``docs/perf_refresh8m8_r5.py``'s ``PipelineConfig``."""
    return PipelineConfig(
        train_steps_per_slice=4, encode_slice_size=slice_size,
        encode_batch_size=128, batch_size=batch, topk_training=200,
        negative_sample=2, ann_chunk_factor=4, dev_search_depth=10,
        search_chunk_queries=512, index_quantize=quantize)


def capacity_rows(n: int, slice_size: int = SLICE) -> int:
    """The index buffer's rows for ``n`` passages: whole slices."""
    return -(-n // slice_size) * slice_size


def build_cache(base: str, n: int, seqlen: int) -> Optional[dict]:
    """Write ``n`` records of ``seqlen`` int32 tokens in bulk, byte for
    byte the JAX script's file: every record of length ``seqlen``, the
    tokens of one ``RandomState(0)`` block of BUILD_CHUNK_ROWS rows
    repeated. A cache already there with ``n`` records is kept (→ None);
    else → {"built", "gb", "sec"}."""
    meta_path = base + "_meta"
    rec = 4 + 4 * seqlen
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        if (meta.get("total_number"), meta.get("embedding_size")) == \
                (n, seqlen) and os.path.getsize(base) == n * rec:
            return None
    rs = np.random.RandomState(0)
    block = np.empty((BUILD_CHUNK_ROWS, rec), np.uint8)
    block[:, :4] = np.array([0, 0, seqlen // 256, seqlen % 256], np.uint8)
    tok = rs.randint(4, 50000, size=(BUILD_CHUNK_ROWS, seqlen)).astype(
        np.int32)
    block[:, 4:] = tok.view(np.uint8).reshape(BUILD_CHUNK_ROWS, 4 * seqlen)
    t0 = time.perf_counter()
    with open(base, "wb") as f:
        left = n
        while left > 0:
            take = min(BUILD_CHUNK_ROWS, left)
            f.write(block[:take].tobytes())
            left -= take
    with open(meta_path, "w") as f:
        json.dump({"type": "int32", "total_number": n,
                   "embedding_size": seqlen}, f)
    return {"built": base, "gb": n * rec / 1e9,
            "sec": time.perf_counter() - t0}


def gap_pcts(gaps) -> dict:
    """The JAX script's step-gap summary (seconds, rounded to ms)."""
    a = np.asarray(gaps)
    return {"n": len(gaps),
            "p50_s": round(float(np.percentile(a, 50)), 3),
            "p90_s": round(float(np.percentile(a, 90)), 3),
            "p99_s": round(float(np.percentile(a, 99)), 3),
            "max_s": round(float(a.max()), 3)}


def card(device: torch.device) -> dict:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None, "nvidia_smi": None}
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={device.index or 0}"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    return {"name": torch.cuda.get_device_name(device),
            "power_limit": line.rsplit(",", 1)[-1].strip(),
            "nvidia_smi": line, "torch": torch.__version__,
            "cuda": torch.version.cuda}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_gib(device: torch.device) -> Optional[float]:
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2 ** 30


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def build_model(dtype: torch.dtype, device, overrides: Optional[dict] = None
                ) -> RobertaDot:
    """RoBERTa-base geometry (``EncoderConfig``'s defaults, ``overrides``
    on top) at compute ``dtype``, ``OUT_DIM`` out, seeded with
    ``INIT_SEED`` on the host."""
    cfg = EncoderConfig(dtype=dtype, **(overrides or {}))
    model = RobertaDot(cfg, out_dim=OUT_DIM)
    init_weights(model, cfg, torch.Generator().manual_seed(INIT_SEED))
    return model.to(device)


def make_state(model: RobertaDot):
    """LAMB on the JAX script's schedule (1e-5 after 1,000 warmup steps,
    linear to 0 at 1,000,000)."""
    return init_train_state(model, make_optimizer(
        model, "lamb", warmup_linear(LR, LR_WARMUP, LR_TOTAL)))


def random_batch(batch: int, rs: np.random.RandomState) -> dict:
    """A triple batch of uniform random ids, every token real."""
    b = {}
    for side, seq in (("query", QLEN), ("pos", PLEN), ("neg", PLEN)):
        b[f"{side}_ids"] = rs.randint(4, 50000, (batch, seq)).astype(
            np.int32)
        b[f"{side}_mask"] = np.ones((batch, seq), np.int32)
    return b


def preflight(quantize: Optional[str], rows: int, batch: int, state,
              device) -> dict:
    """The index buffer at ``rows``' full capacity (int8 for ``dims``,
    fp32 otherwise) and one train step of ``state`` beside it: the peak
    of memory the loop reaches when a step runs beside the index, before
    any cache is built."""
    device = torch.device(device)
    reset_peak(device)
    cap = capacity_rows(rows)
    index = torch.zeros((cap, OUT_DIM), device=device,
                        dtype=torch.int8 if quantize == "dims"
                        else torch.float32)
    t0 = time.perf_counter()
    state, metrics = make_train_step(triplet_loss_fn())(
        state, random_batch(batch, np.random.RandomState(0)),
        torch.Generator().manual_seed(WARM_SEED))
    out = {"index": quantize or "fp32", "capacity_rows": cap,
           "index_gb": index.numel() * index.element_size() / 1e9,
           "batch": batch, "step_s": time.perf_counter() - t0,
           "loss": float(metrics["loss"]), "peak_gib": peak_gib(device)}
    del index, metrics
    reset_peak(device)
    return out


def free_gb(path: str) -> float:
    return shutil.disk_usage(path).free / 1e9


def build_caches(root: str, passages: int, train_q: int, dev_q: int
                 ) -> tuple[dict, list]:
    """The three caches under ``root`` → (paths, what each write built)."""
    os.makedirs(root, exist_ok=True)
    paths, built = {}, []
    for name, n, seq in (("passages", passages, PLEN),
                         ("train-query", train_q, QLEN),
                         ("dev-query", dev_q, QLEN)):
        paths[name] = os.path.join(root, name)
        b = build_cache(paths[name], n, seq)
        if b is not None:
            built.append(b)
    return paths, built


class ProbedAnce(PipelinedAnce):
    """``PipelinedAnce`` that, once ``sample_mining`` is set, keeps the
    first mining item's queries and the ids its search gave them."""

    sample_mining = False
    sample: Optional[dict] = None

    def _mine_chunk(self, qs: int, qe: int, chunk_no: int) -> None:
        if not self.sample_mining or self.sample is not None:
            return super()._mine_chunk(qs, qe, chunk_no)
        index = self.index
        search = index.search

        def kept(queries, k):
            scores, ids = search(queries, k)
            self.sample = {"queries": queries.clone(), "ids": ids.clone(),
                           "k": k, "refresh": self.refresh_no,
                           "chunk": chunk_no}
            return scores, ids

        index.search = kept
        try:
            super()._mine_chunk(qs, qe, chunk_no)
        finally:
            del index.search


def make_loop(cfg: PipelineConfig, model: RobertaDot, paths: dict,
              device) -> tuple[ProbedAnce, dict]:
    """The JAX script's loop over the caches at ``paths`` (train and dev
    query q's positive is passage q mod N) → (loop, open caches)."""
    caches = {n: TokenCache(p).open() for n, p in paths.items()}
    n_p = len(caches["passages"])
    loop = ProbedAnce(
        cfg, state=make_state(model),
        train_step=make_train_step(triplet_loss_fn()),
        generator=torch.Generator().manual_seed(LOOP_SEED),
        query_method=RobertaDot.query_emb, body_method=RobertaDot.body_emb,
        passage_cache=caches["passages"],
        train_query_cache=caches["train-query"],
        dev_query_cache=caches["dev-query"],
        train_qrels={q: {q % n_p: 1}
                     for q in range(len(caches["train-query"]))},
        dev_qrels={q: {q % n_p: 1} for q in range(len(caches["dev-query"]))},
        device=device)
    return loop, caches


class StepClock:
    """A train step that marks its end: a CUDA event recorded on the
    stream after the step's work (no synchronize), or the host clock on
    the CPU. ``gaps_s()`` reads the gaps between consecutive marks."""

    def __init__(self, step: Callable, device: torch.device):
        self.step, self.device = step, device
        self.marks: list = []

    def __call__(self, state, batch, generator):
        out = self.step(state, batch, generator)
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())
        return out

    @property
    def source(self) -> str:
        return "cuda_events" if self.device.type == "cuda" else "host_clock"

    def gaps_s(self) -> list:
        m = self.marks
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            return [a.elapsed_time(b) / 1e3 for a, b in zip(m, m[1:])]
        return [b - a for a, b in zip(m, m[1:])]


def item_summary(times: dict) -> dict:
    """Item times by tag → {tag: {n, total_s, p50_s}}."""
    return {tag: {"n": len(ts), "total_s": sum(ts),
                  "p50_s": statistics.median(ts)}
            for tag, ts in times.items() if ts}


def blockmax_counts() -> dict:
    return dict(blockmax_scores.kernel_launches)


def reset_blockmax_counts() -> None:
    blockmax_scores.launches = 0
    blockmax_scores.kernel_launches.clear()


def mining_vs_scan(loop: PipelinedAnce, sample: dict, n: int) -> dict:
    """The first ``n`` queries of the kept mining item against a scan of
    the index as it stands (no slice has been written since the item)."""
    scan = copy.copy(loop.index)
    scan.method = "scan"
    q = sample["queries"][:n]
    _, ids = scan.search(q, sample["k"])
    got = sample["ids"][:n]
    return {"queries": int(q.shape[0]), "k": sample["k"],
            "refresh": sample["refresh"], "chunk": sample["chunk"],
            "equal": bool(torch.equal(ids.cpu(), got.cpu())),
            "equal_share": float((ids.cpu() == got.cpu()).double().mean())}


def kernel_bound_ms(Q: int, N: int, D: int, q_bytes: int = 4,
                    c_bytes: int = 1, pieces: int = 3) -> tuple[float, str]:
    """Kernel #1's least time on the card for [Q, D] × [N, D] → [Q, N/16]:
    the larger of its bytes (each operand read once, the maxima written
    once) over the memory rate and its ``pieces`` bf16 products over the
    bf16 peak (fp32 queries are three bf16 pieces)."""
    t_bytes = (Q * D * q_bytes + N * D * c_bytes
               + Q * (N // BLOCK) * 4) / HBM_BYTES_PER_S
    t_ops = pieces * 2.0 * Q * N * D / BF16_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(fn, device: torch.device, reps: int = 5) -> Optional[float]:
    """Median CUDA-event ms of ``fn()`` after one warm-up (None on the
    CPU: no device time there)."""
    if device.type != "cuda":
        return None
    from ance_tpu_torch.utils.timing import cuda_ms
    return cuda_ms(fn, reps)


def kernel_stage(loop: PipelinedAnce, sample: dict, launches: dict,
                 searches: int) -> dict:
    """Kernel #1 on the mining item's operands (its queries with the
    per-dim scales folded in, the whole index buffer): the route, its ms
    against its bound, the plain version's ms (in PLAIN_ROWS calls, to
    fit beside the index) and the largest difference between them."""
    index = loop.index
    device = index._emb.device
    q = sample["queries"].to(device, torch.float32)
    if index.quantize == "dims":
        q = q * index._scales
    q = q.contiguous()
    c = _pad_rows(index._emb, CHUNK_ROWS)  # as the search pads it
    Q, D = q.shape
    N = c.shape[0]
    kernel = blockmax_kernel_for(q, c) if device.type == "cuda" else "plain"
    got = blockmax_scores(q, c)
    top = got.abs().max().item()
    err = 0.0
    for s in range(0, N, PLAIN_ROWS):
        want = blockmax_scores_reference(q, c[s:s + PLAIN_ROWS])
        part = got[:, s // BLOCK:(s + want.shape[1] * BLOCK) // BLOCK]
        err = max(err, (part - want).abs().max().item())
    del got, want
    reset_blockmax_counts()
    ms = time_ms(lambda: blockmax_scores(q, c), device)
    reset_blockmax_counts()

    def plain():
        for s in range(0, N, PLAIN_ROWS):
            blockmax_scores_reference(q, c[s:s + PLAIN_ROWS])
    plain_ms = time_ms(plain, device, reps=3)
    bound, by = kernel_bound_ms(Q, N, D, c_bytes=c.element_size(),
                                pieces=3 if c.dtype != torch.float32 else 6)
    return {"launches": launches, "searches": searches,
            "launches_equal_searches":
            device.type != "cuda" or launches == {kernel: searches},
            "kernel": kernel, "Q": Q, "N": N, "D": D,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": None, "max_abs_err": err,
            "max_abs_score": top}


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype", choices=tuple(DTYPES), default="bf16")
    p.add_argument("--root", default=os.path.join(tempfile.gettempdir(),
                                                  "ance_refresh8m8"),
                   help="directory of the caches (~4.6 GB at full size)")
    p.add_argument("--passages", type=int, default=MSMARCO_PASSAGES)
    p.add_argument("--train_q", type=int, default=TRAIN_Q)
    p.add_argument("--dev_q", type=int, default=DEV_Q)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--slice", type=int, default=SLICE,
                   help="encode_slice_size")
    p.add_argument("--index_quantize", choices=("dims", "none"),
                   default="dims")
    p.add_argument("--cycles", type=int, default=1)
    p.add_argument("--no_refresh_steps", type=int, default=NO_REFRESH_STEPS)
    p.add_argument("--preflight_passages", type=int,
                   default=MSMARCO_PASSAGES,
                   help="the preflight's index capacity in passages (0: "
                   "no preflight)")
    p.add_argument("--encoder_overrides", default=None,
                   help="JSON of EncoderConfig fields over RoBERTa-base's")
    p.add_argument("--log", default=None,
                   help="JSON-lines file the stages are appended to")
    return p.parse_args(argv)


def run(args, log: Optional[Log] = None) -> dict:
    """Every stage in order; → {stage name: its record} (``cycle`` a list
    of one record a cycle)."""
    log = log or Log(args.log)
    before = feed_threads()  # another loop's, in a process that had one
    device = torch.device(args.device)
    dtype = DTYPES[args.dtype]
    overrides = json.loads(args.encoder_overrides) \
        if args.encoder_overrides else None
    quantize = None if args.index_quantize == "none" else "dims"
    out = {"device": log(stage="device", **card(device))}

    if args.preflight_passages:
        state = make_state(build_model(dtype, device, overrides))
        cases = [preflight(q, args.preflight_passages, args.batch, state,
                           device) for q in ("dims", None)]
        del state
        out["preflight"] = log(stage="preflight",
                               passages=args.preflight_passages, cases=cases)

    os.makedirs(args.root, exist_ok=True)
    need = (args.passages * (4 + 4 * PLEN)
            + (args.train_q + args.dev_q) * (4 + 4 * QLEN)) / 1e9
    if free_gb(args.root) < need:
        have = os.path.exists(os.path.join(args.root, "passages_meta"))
        if not have:
            raise SystemExit(
                f"{args.root}: {free_gb(args.root):.1f} GB free, the caches "
                f"need {need:.1f} GB; give --root another disk or a smaller "
                f"--passages")
    t0 = time.perf_counter()
    paths, built = build_caches(args.root, args.passages, args.train_q,
                                args.dev_q)
    out["build_cache"] = log(stage="build_cache", root=args.root,
                             built=built, free_gb=free_gb(args.root),
                             sec=time.perf_counter() - t0)

    cfg = pipeline_config(args.batch, quantize, args.slice)
    loop, caches = make_loop(cfg, build_model(dtype, device, overrides),
                             paths, device)
    base_step = loop.train_step
    try:
        reset_blockmax_counts()
        reset_peak(device)
        t0 = time.perf_counter()
        boot = loop.bootstrap()
        sync(device)
        boot_s = time.perf_counter() - t0
        steps = len(loop._work) * cfg.train_steps_per_slice
        out["bootstrap"] = log(
            stage="bootstrap", wall_min=boot_s / 60.0,
            ntotal=int(loop.index.ntotal), steps_per_cycle=steps,
            num_triples=boot["num_triples"], work_items=len(loop._work),
            dev_ndcg=boot["dev_ndcg"],
            int8_clip_frac=boot.get("int8_clip_frac"),
            int8_scale_widenings=boot.get("int8_scale_widenings"),
            item_times=item_summary(loop.item_times),
            peak_gib=peak_gib(device))

        # one step off the clock: the card's first-call costs
        t0 = time.perf_counter()
        loop.state, m = base_step(loop.state, next(loop._batches),
                                  torch.Generator().manual_seed(WARM_SEED))
        out["warm_step"] = log(stage="warm_step", batch=args.batch,
                               loss=float(m["loss"]),
                               sec=time.perf_counter() - t0)

        clock = StepClock(base_step, device)
        loop.train_step = clock
        out["cycle"] = []
        walls = []
        for c in range(args.cycles):
            # the last cycle's first mining item: the index it searched
            # stands until the next cycle's first slice is written
            loop.sample_mining = c == args.cycles - 1
            clock.marks.clear()
            done = {tag: len(ts) for tag, ts in loop.item_times.items()}
            r0 = loop.refresh_no
            reset_peak(device)
            t0 = time.perf_counter()
            loop.run(steps)
            sync(device)
            wall = time.perf_counter() - t0
            walls.append(wall)
            e = loop.history[-1]
            out["cycle"].append(log(
                stage="cycle", cycle=c + 1, wall_min=wall / 60.0,
                refreshes=loop.refresh_no - r0, steps=steps,
                steps_per_s=steps / wall, dev_ndcg=e.get("dev_ndcg"),
                dev_recall=e.get("dev_recall"),
                int8_clip_frac=e.get("int8_clip_frac"),
                int8_scale_widenings=e.get("int8_scale_widenings"),
                num_triples=e.get("num_triples"),
                refresh_sec=e.get("refresh_sec"),
                mean_loss=e.get("mean_loss"),
                step_gap=gap_pcts(clock.gaps_s()),
                gap_source=clock.source,
                item_times=item_summary({
                    tag: ts[done.get(tag, 0):]
                    for tag, ts in loop.item_times.items()}),
                peak_gib=peak_gib(device)))
        launches = blockmax_counts()
        searches = sum(tag in "SM" for tag in loop.schedule_trace)
        sample = loop.sample

        clock.marks.clear()
        sync(device)
        t0 = time.perf_counter()
        for _ in range(args.no_refresh_steps):
            loop.state, m = clock(loop.state, next(loop._batches),
                                  loop.generator)
        sync(device)
        pure_s = time.perf_counter() - t0
        pure_sps = args.no_refresh_steps / pure_s
        cyc_sps = steps * len(walls) / sum(walls)
        out["train_no_refresh"] = log(
            stage="train_no_refresh", steps=args.no_refresh_steps,
            steps_per_s=pure_sps, step_ms=1e3 / pure_sps,
            step_gap=gap_pcts(gaps) if (gaps := clock.gaps_s()) else None,
            gap_source=clock.source,
            refresh_throughput_cost_pct=100.0 * (1.0 - cyc_sps / pure_sps))

        out["mining_vs_scan"] = log(stage="mining_vs_scan", **mining_vs_scan(
            loop, sample, SAMPLE_QUERIES))
        out["kernels"] = log(stage="kernels", **kernel_stage(
            loop, sample, launches, searches))
    finally:
        loop.close()
        for c in caches.values():
            c.close()
    deadline = time.time() + 10
    while live_feed_threads(before) and time.time() < deadline:
        time.sleep(0.05)
    out["done"] = log(stage="done", done=True,
                      feed_threads_after_close=live_feed_threads(before))
    return out


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
