"""The FirstP learning demo: the pipelined ANCE loop trained from chance to
perfect retrieval (the port's counterpart of ``docs/tpu_demo.py``).

A synthetic task that a random encoder scores at chance and that a working
loop learns: 100,000 passages of seq 128, the first ``N_CLASSES`` carrying
a class signature of 8 tokens (shifted by ``SHIFT`` into the passage range
of the vocabulary), the rest filler; 8,192 train and 512 dev queries of seq
32, query i asking for class i % N_CLASSES by the unshifted signature. The
encoder has to learn the shift. A 4-layer, 256-wide encoder in bf16
(``--model rdot``: RoBERTa-style ``RobertaDot``; ``--model seeddot``:
SEED's retrieval model on the same task), LAMB at 1e-3 after a 100-step
linear warmup, 1,000 in-batch contrastive warmup steps on random negatives
(the role the reference's BM25 warmup plays), then ``PipelinedAnce`` with
the in-batch step (``train/dpr_trainer.py``) on mined negatives: every
dev search and mining pass goes through kernel #1 (``csrc/blockmax.cu``,
``blockmax_pieces_f32`` at D = 256) on the card.

    python -m ance_tpu_torch.experiments.demo [--model seeddot]
        [--passages N] [--steps N] [--log run.jsonl]

Against the JAX script:

  * flags in place of its environment variables (``--passages`` for
    DEMO_PASSAGES, ``--steps`` for DEMO_STEPS, ``--model seeddot`` for
    DEMO_MODEL), with its defaults, and ``--warm``, ``--batch``,
    ``--train_q``, ``--dev_q`` for what it fixes; ``--device`` (default
    ``cuda``; the CPU only when asked, ``--device cpu --dtype fp32``),
    ``--dtype`` (default ``bf16``) and ``--log``;
  * the task's caches and qrels are byte-identical to the script's at the
    same sizes (the same numpy seeds: ``RandomState(7)`` for the corpus,
    3 for the warmup triples, 5 for the feed);
  * the torch generators are seeded with the integers of the script's
    ``PRNGKey(0)`` (weights), ``PRNGKey(9)`` (warmup dropout) and
    ``PRNGKey(1)`` (the loop's dropout): other streams than JAX's, so the
    two runs draw other weights and masks and give curves of the same
    kind, not the same numbers;
  * the log (``--log``, one JSON object a line, each also printed) has
    the script's events and keys in its order; the start line adds the
    card's name and power limit. The device's idle share over a profiled
    window of warmup steps is printed (``{"idle": ...}``), not logged.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch

from ance_tpu_torch.data.cache import TokenCache, TokenCacheWriter
from ance_tpu_torch.data.feed import TripletBatches, infinite_batches
from ance_tpu_torch.models.dot_models import RobertaDot
from ance_tpu_torch.models.transformer import EncoderConfig, init_weights
from ance_tpu_torch.optim.schedules import warmup_linear
from ance_tpu_torch.train.dpr_trainer import make_dpr_train_step
from ance_tpu_torch.train.pipelined import PipelineConfig, PipelinedAnce
from ance_tpu_torch.train.trainer import init_train_state, make_optimizer

VOCAB = 30522
QLEN, PLEN = 32, 128
N_CLASSES = 1024
SHIFT = 15000
# the encoder the scripts train from random weights
SHAPE = dict(hidden_size=256, num_layers=4, num_heads=8,
             intermediate_size=1024)
OUT_DIM = 256
LR, LR_WARMUP, LR_TOTAL = 1e-3, 100, 100_000
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
# the integers of the JAX scripts' PRNGKey(0) / (9) / (1)
INIT_SEED, WARM_SEED, LOOP_SEED = 0, 9, 1
PROGRESS_EVERY = 104  # loop steps between progress lines, as the scripts
PROFILE_FROM, PROFILE_STEPS = 100, 16  # the idle share's window of steps


def pipeline_config(batch: int = 128) -> PipelineConfig:
    """``docs/tpu_demo.py``'s ``PipelineConfig``."""
    return PipelineConfig(train_steps_per_slice=8, encode_slice_size=8192,
                          encode_batch_size=256, batch_size=batch,
                          topk_training=1000, negative_sample=8,
                          ann_chunk_factor=2, dev_search_depth=100)


class Log:
    """JSON lines to ``path`` (appended, as the scripts do) and stdout."""

    def __init__(self, path: Optional[str]):
        self.path = path
        if path and os.path.dirname(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)

    def __call__(self, rec: dict) -> None:
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        print(json.dumps(rec), flush=True)


def rounded(entry: dict) -> dict:
    """A loop history entry as the scripts log it: floats to 4 places."""
    return {k: round(v, 4) if isinstance(v, float) else v
            for k, v in entry.items()}


def devices(device: torch.device) -> str:
    """The start line's ``devices`` (the scripts' ``str(jax.devices())``)."""
    if device.type != "cuda":
        return f"[{device}]"
    return f"[{device} {torch.cuda.get_device_name(device)}]"


def card(device: torch.device) -> dict:
    """What the port's start line adds: the card's name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit`` gives them."""
    if device.type != "cuda":
        return {"device": "cpu", "power_limit": None}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={device.index or 0}"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    limit = smi.rsplit(",", 1)[-1].strip() if "," in smi else None
    return {"device": torch.cuda.get_device_name(device),
            "power_limit": limit}


def signature(c) -> np.ndarray:
    return 100 + (c * 7 + np.arange(8)) % (SHIFT - 200)


def build_corpus(root: str, n_passages: int, n_train_q: int = 8192,
                 n_dev_q: int = 512):
    """The script's ``build_corpus`` at these sizes → (cache paths, train
    qrels, dev qrels); byte-identical caches."""
    rs = np.random.RandomState(7)
    paths = {n: os.path.join(root, n)
             for n in ("passages", "train-query", "dev-query")}
    with TokenCacheWriter(paths["passages"], PLEN) as w:
        for i in range(n_passages):
            toks = np.zeros(PLEN, np.int32)
            if i < N_CLASSES:
                toks[1:9] = signature(i) + SHIFT
                toks[9:60] = SHIFT + 200 + rs.randint(
                    0, VOCAB - SHIFT - 300, 51)
            else:
                toks[1:60] = SHIFT + 200 + rs.randint(
                    0, VOCAB - SHIFT - 300, 59)
            w.write(60, toks)
    for name, n_q in (("train-query", n_train_q), ("dev-query", n_dev_q)):
        with TokenCacheWriter(paths[name], QLEN) as w:
            for i in range(n_q):
                toks = np.zeros(QLEN, np.int32)
                toks[1:9] = signature(i % N_CLASSES)
                toks[9:12] = 100 + rs.randint(0, SHIFT - 200, 3)
                w.write(12, toks)
    train_qrels = {i: {i % N_CLASSES: 1} for i in range(n_train_q)}
    dev_qrels = {i: {i % N_CLASSES: 1} for i in range(n_dev_q)}
    return paths, train_qrels, dev_qrels


def warm_triples(n_train_q: int, n_classes: int, n_rows: int) -> np.ndarray:
    """The warmup's (query, positive, random negative) triples,
    ``RandomState(3)`` as the scripts draw them."""
    rs = np.random.RandomState(3)
    return np.stack([np.arange(n_train_q), np.arange(n_train_q) % n_classes,
                     rs.randint(n_classes, n_rows, n_train_q)], axis=1)


def build_model(kind: str = "rdot", dtype: torch.dtype = torch.bfloat16,
                base_len: int = 512) -> RobertaDot:
    """The scripts' encoder (``SHAPE``, ``OUT_DIM``) at ``dtype``, seeded
    on the host with ``INIT_SEED``: ``rdot`` (RobertaDot; ``base_len`` is
    the MaxP chunk length) or ``seeddot`` (``seed_dot_model``)."""
    if kind == "seeddot":
        from ance_tpu_torch.models.seed import seed_dot_model
        model = seed_dot_model(vocab_size=VOCAB, out_dim=OUT_DIM,
                               config_overrides=dict(SHAPE, dtype=dtype))
    elif kind == "rdot":
        model = RobertaDot(EncoderConfig(vocab_size=VOCAB, dtype=dtype,
                                         **SHAPE),
                           out_dim=OUT_DIM, base_len=base_len)
    else:
        raise ValueError(f"unknown demo model {kind!r}: rdot or seeddot")
    init_weights(model, model.config,
                 torch.Generator().manual_seed(INIT_SEED))
    return model


def demo_optimizer(model):
    """LAMB at 1e-3, linear warmup over 100 steps, the scripts' schedule."""
    return make_optimizer(model, "lamb", warmup_linear(LR, LR_WARMUP,
                                                       LR_TOTAL))


def device_idle(step: Callable[[], None], n: int, device) -> dict:
    """``n`` calls of ``step`` under ``torch.profiler``: wall ms a step,
    the device's kernel and copy ms a step, and the idle share
    (1 - device / wall)."""
    from torch.autograd import DeviceType
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize(device)
    wall_ms = (time.perf_counter() - t0) * 1e3
    device_ms = sum(e.time_range.elapsed_us() / 1e3 for e in prof.events()
                    if e.device_type == DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False))
    return {"steps": n, "wall_ms_per_step": wall_ms / n,
            "device_ms_per_step": device_ms / n,
            "idle_share": max(0.0, 1.0 - device_ms / wall_ms)}


def train_steps(state, step, batches, n_steps: int, generator, device,
                on_step: Optional[Callable] = None,
                profiled: Optional[str] = None):
    """``n_steps`` calls of ``step`` on the next batches, ``on_step(i, m)``
    after step i (counted from 1) with its metrics. With ``profiled`` (the
    window's name) on the card, steps PROFILE_FROM + 1 to PROFILE_FROM +
    PROFILE_STEPS run under the profiler and the idle share is printed."""
    i = 0
    while i < n_steps:
        window = []

        def one():
            nonlocal state
            state, m = step(state, next(batches), generator)
            window.append(m)
        if device.type == "cuda" and profiled and i == PROFILE_FROM \
                and i + PROFILE_STEPS <= n_steps:
            print(json.dumps({"idle": {"where": profiled, **device_idle(
                one, PROFILE_STEPS, device)}}), flush=True)
        else:
            one()
        for m in window:
            i += 1
            if on_step is not None:
                on_step(i, m)
    return state


def run_warmup(state, step, batches, n_steps: int, generator, device,
               log: Log, every: int, mean_of: int = 50):
    """The in-batch warmup: a ``warmup`` line every ``every`` steps (the
    loss averaged over the last ``mean_of`` steps, 1 for the last step's
    alone; the last step's correct ratio), then ``warmup_done``."""
    losses = []

    def on_step(i, m):
        losses.append(m["loss"])
        if i % every == 0:
            loss = float(torch.stack(losses[-mean_of:]).float().mean())
            log({"event": "warmup", "step": i, "loss": round(loss, 4),
                 "correct_ratio": round(float(m["correct_ratio"]), 3)})
    t0 = time.time()
    state = train_steps(state, step, batches, n_steps, generator, device,
                        on_step, profiled="warmup in-batch step")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    log({"event": "warmup_done", "steps": n_steps,
         "sec": round(time.time() - t0, 1)})
    return state


def run_loop(loop: PipelinedAnce, total: int, device, log: Log) -> None:
    """``total`` loop steps in chunks of PROGRESS_EVERY: after each, its
    refresh lines and a progress line (steps/s over the chunk, the device
    synchronized before the clock is read)."""
    done = 0
    while done < total:
        t0 = time.time()
        chunk = min(PROGRESS_EVERY, total - done)
        n_hist = len(loop.history)
        loop.run(chunk)
        done += chunk
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.time() - t0
        for h in loop.history[n_hist:]:
            log({"event": "refresh", **rounded(h)})
        log({"event": "progress", "steps": done,
             "steps_per_sec": round(chunk / dt, 2)})


def make_loop(cfg: PipelineConfig, state, train_step, caches: dict,
              passages: str, train_qrels, dev_qrels, device,
              body_method=RobertaDot.body_emb) -> PipelinedAnce:
    """The scripts' ``PipelinedAnce`` over ``caches`` (``passages`` names
    the corpus cache), dropout from ``LOOP_SEED``."""
    return PipelinedAnce(
        cfg, state=state, train_step=train_step,
        generator=torch.Generator().manual_seed(LOOP_SEED),
        query_method=RobertaDot.query_emb, body_method=body_method,
        passage_cache=caches[passages],
        train_query_cache=caches["train-query"],
        dev_query_cache=caches["dev-query"], train_qrels=train_qrels,
        dev_qrels=dev_qrels, device=device)


def parse_args(argv=None, description: str = __doc__):
    p = argparse.ArgumentParser(
        description=description.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", choices=("rdot", "seeddot"), default="rdot",
                   help="DEMO_MODEL: the encoder family")
    p.add_argument("--passages", type=int, default=100_000,
                   help="DEMO_PASSAGES: corpus size")
    p.add_argument("--steps", type=int, default=3640,
                   help="DEMO_STEPS: loop steps after the bootstrap")
    p.add_argument("--warm", type=int, default=1000,
                   help="in-batch warmup steps")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--train_q", type=int, default=8192)
    p.add_argument("--dev_q", type=int, default=512)
    add_device_args(p)
    return p.parse_args(argv)


def add_device_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype", choices=tuple(DTYPES), default="bf16")
    p.add_argument("--log", default=None,
                   help="JSON-lines file the events are appended to")


def main(argv=None) -> dict:
    """Build the task in a temporary directory (removed at the end), run
    the demo, and return its history (and its last loop or result)."""
    args = parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="ance_demo_") as root:
        return run(args, root)


def run(args, root: str) -> dict:
    device = torch.device(args.device)
    log = Log(args.log)
    t_start = time.time()
    log({"event": "start", "devices": devices(device),
         "corpus": args.passages, "train_q": args.train_q, **card(device)})
    paths, train_qrels, dev_qrels = build_corpus(
        root, args.passages, args.train_q, args.dev_q)
    log({"event": "corpus_built", "sec": round(time.time() - t_start, 1)})

    model = build_model(args.model, DTYPES[args.dtype]).to(device)
    n_params = sum(p.numel() for p in model.parameters())
    log({"event": "model", "params_m": round(float(n_params) / 1e6, 1)})
    state = init_train_state(model, demo_optimizer(model))
    step = make_dpr_train_step()

    caches = {n: TokenCache(p).open() for n, p in paths.items()}
    feed = TripletBatches(caches["train-query"], caches["passages"],
                          warm_triples(args.train_q, N_CLASSES,
                                       args.passages),
                          batch_size=args.batch, seed=5)
    state = run_warmup(state, step, infinite_batches(feed), args.warm,
                       torch.Generator().manual_seed(WARM_SEED), device,
                       log, every=100)

    loop = make_loop(pipeline_config(args.batch), state, step, caches,
                     "passages", train_qrels, dev_qrels, device)
    t0 = time.time()
    loop.bootstrap()
    log({"event": "bootstrap_refresh", "sec": round(time.time() - t0, 1),
         **rounded(loop.history[-1])})
    run_loop(loop, args.steps, device, log)
    log({"event": "done", "total_sec": round(time.time() - t_start, 1),
         "refreshes": loop.refresh_no,
         "final_dev_ndcg": loop.history[-1]["dev_ndcg"]})
    return {"history": loop.history, "loop": loop}


if __name__ == "__main__":
    main()
