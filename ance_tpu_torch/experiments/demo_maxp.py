"""The MaxP learning demo: the long-document ANCE loop trained from chance
to perfect retrieval (the port's counterpart of ``docs/tpu_demo_maxp.py``).

Documents of 4 chunks of 128 tokens ([B, C·L] folded to [B·C, L] encoder
passes, ``RobertaDot.body_emb_multichunk``), a multi-vector index (one row
a chunk, mining deduplicated by document id), and the in-batch loss over
each document's best live chunk (``losses.dpr_inbatch_multichunk_loss``,
the −9999 empty-chunk bias). Each class signature hides in a random chunk
of its document (chunk 0 a quarter of the time), so first-chunk scoring
cannot solve the task. Contrastive warmup on chunk-sized passages, then
``PipelinedAnce`` with ``multichunk=True``, training with the step
``make_dpr_train_step(multichunk=True)`` on mined negatives. Every dev
search and mining pass goes through kernel #1 (``blockmax_pieces_f32`` at
D = 256) on the card.

    python -m ance_tpu_torch.experiments.demo_maxp [--docs N] [--warm N]
        [--steps N] [--batch N] [--log run.jsonl]

Flags for the script's environment variables, with its defaults
(``--docs`` DEMO_DOCS, ``--classes`` DEMO_CLASSES, ``--train_q``
DEMO_TRAIN_Q, ``--dev_q`` DEMO_DEV_Q, ``--warm`` DEMO_WARM, ``--steps``
DEMO_STEPS, ``--batch`` DEMO_BATCH), and ``--device``, ``--dtype``,
``--log`` as in :mod:`ance_tpu_torch.experiments.demo`, whose notes on
seeds, generators and the log hold here too.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from ance_tpu_torch.data.cache import TokenCache, TokenCacheWriter
from ance_tpu_torch.data.feed import TripletBatches, infinite_batches
from ance_tpu_torch.experiments import demo
from ance_tpu_torch.experiments.demo import (QLEN, SHIFT, VOCAB, Log, card,
                                             devices, rounded, signature)
from ance_tpu_torch.models.dot_models import RobertaDot
from ance_tpu_torch.train.dpr_trainer import make_dpr_train_step
from ance_tpu_torch.train.pipelined import PipelineConfig
from ance_tpu_torch.train.trainer import init_train_state

CHUNK_LEN, N_CHUNKS = 128, 4
PLEN = CHUNK_LEN * N_CHUNKS  # 512-token documents


def pipeline_config(batch: int = 64) -> PipelineConfig:
    """``docs/tpu_demo_maxp.py``'s ``PipelineConfig``."""
    return PipelineConfig(train_steps_per_slice=8, encode_slice_size=4096,
                          encode_batch_size=64, batch_size=batch,
                          topk_training=500, negative_sample=8,
                          ann_chunk_factor=2, dev_search_depth=100,
                          multichunk=True)


def filler(rs, n):
    return SHIFT + 200 + rs.randint(0, VOCAB - SHIFT - 300, n)


def build_task(root: str, n_docs: int, n_classes: int, n_train_q: int = 8192,
               n_dev_q: int = 512):
    """The script's ``build_task`` at these sizes → (cache paths, train
    qrels, dev qrels, the chunk each class signature sits in);
    byte-identical caches."""
    rs = np.random.RandomState(7)
    paths = {n: os.path.join(root, n) for n in
             ("docs", "warm-passages", "train-query", "dev-query")}
    sig_chunks = rs.randint(0, N_CHUNKS, n_classes)
    with TokenCacheWriter(paths["docs"], PLEN) as w:
        for i in range(n_docs):
            toks = np.zeros(PLEN, np.int32)
            for c in range(N_CHUNKS):  # every chunk non-empty
                base = c * CHUNK_LEN
                toks[base + 1:base + 60] = filler(rs, 59)
            if i < n_classes:
                base = sig_chunks[i] * CHUNK_LEN
                toks[base + 1:base + 9] = signature(i) + SHIFT
            w.write(PLEN, toks)
    with TokenCacheWriter(paths["warm-passages"], CHUNK_LEN) as w:
        for i in range(n_docs):  # chunk-sized warmup rows
            toks = np.zeros(CHUNK_LEN, np.int32)
            if i < n_classes:
                toks[1:9] = signature(i) + SHIFT
                toks[9:60] = filler(rs, 51)
            else:
                toks[1:60] = filler(rs, 59)
            w.write(60, toks)
    for name, n_q in (("train-query", n_train_q), ("dev-query", n_dev_q)):
        with TokenCacheWriter(paths[name], QLEN) as w:
            for i in range(n_q):
                toks = np.zeros(QLEN, np.int32)
                toks[1:9] = signature(i % n_classes)
                toks[9:12] = 100 + rs.randint(0, SHIFT - 200, 3)
                w.write(12, toks)
    train_qrels = {i: {i % n_classes: 1} for i in range(n_train_q)}
    dev_qrels = {i: {i % n_classes: 1} for i in range(n_dev_q)}
    return paths, train_qrels, dev_qrels, sig_chunks


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--docs", type=int, default=25_000)
    p.add_argument("--classes", type=int, default=None,
                   help="default min(1024, docs // 8)")
    p.add_argument("--train_q", type=int, default=8192)
    p.add_argument("--dev_q", type=int, default=512)
    p.add_argument("--warm", type=int, default=800)
    p.add_argument("--steps", type=int, default=1200)
    p.add_argument("--batch", type=int, default=64)
    demo.add_device_args(p)
    args = p.parse_args(argv)
    if args.classes is None:
        args.classes = min(1024, args.docs // 8)
    return args


def main(argv=None) -> dict:
    """Build the task in a temporary directory (removed at the end), run
    the demo, and return its history (and its last loop or result)."""
    args = parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="maxp_demo_") as root:
        return run(args, root)


def run(args, root: str) -> dict:
    device = torch.device(args.device)
    log = Log(args.log)
    t_start = time.time()
    log({"event": "start", "devices": devices(device), "docs": args.docs,
         "chunks": N_CHUNKS, "doc_len": PLEN, "train_q": args.train_q,
         **card(device)})
    paths, train_qrels, dev_qrels, sig_chunks = build_task(
        root, args.docs, args.classes, args.train_q, args.dev_q)
    log({"event": "task_built", "sec": round(time.time() - t_start, 1),
         "signature_in_chunk0_frac": round(float(np.mean(sig_chunks == 0)),
                                           3)})

    model = demo.build_model("rdot", demo.DTYPES[args.dtype],
                             base_len=CHUNK_LEN).to(device)
    state = init_train_state(model, demo.demo_optimizer(model))
    caches = {n: TokenCache(p).open() for n, p in paths.items()}
    # contrastive warmup on chunk-sized passages (FirstP geometry)
    feed = TripletBatches(caches["train-query"], caches["warm-passages"],
                          demo.warm_triples(args.train_q, args.classes,
                                            args.docs),
                          batch_size=min(128, args.train_q), seed=5)
    state = demo.run_warmup(state, make_dpr_train_step(),
                            infinite_batches(feed), args.warm,
                            torch.Generator().manual_seed(demo.WARM_SEED),
                            device, log, every=200, mean_of=1)

    # the loop: in-batch contrastive over MaxP chunk-max scores on mined
    # negatives, over the multi-vector index
    loop = demo.make_loop(pipeline_config(args.batch), state,
                          make_dpr_train_step(multichunk=True), caches,
                          "docs", train_qrels, dev_qrels, device,
                          body_method=RobertaDot.body_emb_multichunk)
    t0 = time.time()
    loop.bootstrap()
    log({"event": "bootstrap_refresh", "sec": round(time.time() - t0, 1),
         "index_rows": loop.index.ntotal, **rounded(loop.history[-1])})
    demo.run_loop(loop, args.steps, device, log)
    log({"event": "done", "total_sec": round(time.time() - t_start, 1),
         "refreshes": loop.refresh_no,
         "final_dev_ndcg": loop.history[-1]["dev_ndcg"]})
    return {"history": loop.history, "loop": loop}


if __name__ == "__main__":
    main()
