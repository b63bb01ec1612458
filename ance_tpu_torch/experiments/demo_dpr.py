"""The DPR learning demo: alternating train and generate cycles from chance
to perfect answer retrieval (the port's counterpart of
``docs/tpu_demo_dpr.py``).

Two independent towers (``BiEncoder``) at the demos' geometry, answer-string
validation (the top-k hit curve) and answer-filtered negative mining: a
synthetic open-QA task in which passage K carries the literal answer
"ansK" in its raw text and a token signature, and query i asks for class
i % N_CLASSES (the FirstP demo's vocabulary geometry). A cycle trains
``--steps`` in-batch steps, then runs ``generate_new_ann_dpr`` over a bf16
``FlatIPIndex(dim=256)`` (kernel #1's ``blockmax_bf16`` at D = 256 on the
card) with ``seed=cycle``, and re-reads the mined triples, one random hard
negative a line. Cycle 0 trains on random negatives (the warmup's role).

    python -m ance_tpu_torch.experiments.demo_dpr [--cycles N] [--steps N]
        [--batch N] [--passages N] [--log run.jsonl]

Flags for the script's environment variables, with its defaults
(``--passages`` DEMO_PASSAGES, ``--classes`` DEMO_CLASSES, ``--train_q``
DEMO_TRAIN_Q, ``--test_q`` DEMO_TEST_Q, ``--trivia_q`` DEMO_TRIVIA_Q,
``--cycles`` DEMO_CYCLES, ``--steps`` DEMO_STEPS, ``--batch`` DEMO_BATCH),
and ``--device``, ``--dtype``, ``--log`` as in
:mod:`ance_tpu_torch.experiments.demo`, whose notes on seeds, generators
and the log hold here too. The index is bf16 wherever the encoder is (the
script's ``on_tpu`` switch becomes ``--dtype``).
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
from ance_tpu_torch.experiments.demo import (PLEN, QLEN, SHIFT, VOCAB, Log,
                                             card, devices, signature)
from ance_tpu_torch.index.flat import FlatIPIndex
from ance_tpu_torch.models.dot_models import BiEncoder
from ance_tpu_torch.models.transformer import EncoderConfig, init_weights
from ance_tpu_torch.train.dpr_gen import generate_new_ann_dpr
from ance_tpu_torch.train.dpr_trainer import make_dpr_train_step
from ance_tpu_torch.train.encode import make_encode_fn
from ance_tpu_torch.train.trainer import init_train_state

QUERY_CACHES = ("train-query", "test-query", "trivia-test-query")


def build_task(root: str, n_passages: int, n_classes: int,
               n_train_q: int = 8192, n_test_q: int = 1024,
               n_trivia_q: int = 512):
    """The script's ``build_task`` at these sizes → (cache paths, passage
    texts by offset, answers(n), train positives); byte-identical caches."""
    rs = np.random.RandomState(7)
    paths = {n: os.path.join(root, n) for n in ("passages",) + QUERY_CACHES}
    passage_texts = {}
    with TokenCacheWriter(paths["passages"], PLEN) as w:
        for i in range(n_passages):
            toks = np.zeros(PLEN, np.int32)
            if i < n_classes:
                toks[1:9] = signature(i) + SHIFT
                toks[9:60] = SHIFT + 200 + rs.randint(
                    0, VOCAB - SHIFT - 300, 51)
                passage_texts[i] = (f"the answer here is ans{i} indeed",
                                    f"title{i}")
            else:
                toks[1:60] = SHIFT + 200 + rs.randint(
                    0, VOCAB - SHIFT - 300, 59)
                passage_texts[i] = ("filler passage with no answers",
                                    f"title{i}")
            w.write(60, toks)
    for name, n_q in zip(QUERY_CACHES, (n_train_q, n_test_q, n_trivia_q)):
        with TokenCacheWriter(paths[name], QLEN) as w:
            for i in range(n_q):
                toks = np.zeros(QLEN, np.int32)
                toks[1:9] = signature(i % n_classes)
                toks[9:12] = 100 + rs.randint(0, SHIFT - 200, 3)
                w.write(12, toks)

    def answers(n):
        return {i: [f"ans{i % n_classes}"] for i in range(n)}
    positives = {i: i % n_classes for i in range(n_train_q)}
    return paths, passage_texts, answers, positives


def parse_triples(path: str, rs: np.random.RandomState) -> np.ndarray:
    """The training file's lines → (qid, pos, one hard negative drawn by
    ``rs``) rows, as the script reads them."""
    rows = []
    with open(path) as f:
        for line in f:
            qid, pos, negs = line.rstrip("\n").split("\t")
            negs = negs.split(",")
            rows.append((int(qid), int(pos), int(negs[rs.randint(len(negs))])))
    return np.asarray(rows, np.int64)


def build_model(dtype: torch.dtype = torch.bfloat16) -> BiEncoder:
    """``BiEncoder`` of two towers at the demos' ``demo.SHAPE``, seeded as
    :func:`ance_tpu_torch.experiments.demo.build_model`."""
    cfg = EncoderConfig(vocab_size=VOCAB, dtype=dtype, **demo.SHAPE)
    model = BiEncoder(cfg)
    init_weights(model, cfg, torch.Generator().manual_seed(demo.INIT_SEED))
    return model


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--passages", type=int, default=100_000)
    p.add_argument("--classes", type=int, default=None,
                   help="default min(1024, passages // 8)")
    p.add_argument("--train_q", type=int, default=8192)
    p.add_argument("--test_q", type=int, default=1024)
    p.add_argument("--trivia_q", type=int, default=512)
    p.add_argument("--cycles", type=int, default=8)
    p.add_argument("--steps", type=int, default=300,
                   help="train steps a cycle")
    p.add_argument("--batch", type=int, default=128)
    demo.add_device_args(p)
    args = p.parse_args(argv)
    if args.classes is None:
        args.classes = min(1024, args.passages // 8)
    return args


def main(argv=None) -> dict:
    """Build the task in a temporary directory (removed at the end), run
    the demo, and return its history (and its last loop or result)."""
    args = parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="dpr_demo_") as root:
        return run(args, root)


def run(args, root: str) -> dict:
    device = torch.device(args.device)
    dtype = demo.DTYPES[args.dtype]
    log = Log(args.log)
    t_start = time.time()
    log({"event": "start", "devices": devices(device),
         "corpus": args.passages, "train_q": args.train_q, **card(device)})
    paths, passage_texts, answers, positives = build_task(
        root, args.passages, args.classes, args.train_q, args.test_q,
        args.trivia_q)
    log({"event": "task_built", "sec": round(time.time() - t_start, 1)})

    model = build_model(dtype).to(device)
    n_params = sum(p.numel() for p in model.parameters())
    log({"event": "model", "towers": 2,
         "params_m": round(float(n_params) / 1e6, 1)})
    state = init_train_state(model, demo.demo_optimizer(model))
    step = make_dpr_train_step()
    qfn = make_encode_fn(model, BiEncoder.query_emb, device)
    bfn = make_encode_fn(model, BiEncoder.body_emb, device)

    caches = {n: TokenCache(p).open() for n, p in paths.items()}
    rs = np.random.RandomState(3)
    generator = torch.Generator().manual_seed(demo.WARM_SEED)
    # cycle 0 trains on random negatives (the warmup's role); later cycles
    # on the generator's answer-filtered hard negatives
    triples = np.stack([np.arange(args.train_q),
                        np.arange(args.train_q) % args.classes,
                        rs.randint(args.classes, args.passages,
                                   args.train_q)], axis=1)
    history = []
    for cycle in range(args.cycles):
        feed = TripletBatches(caches["train-query"], caches["passages"],
                              triples, batch_size=args.batch,
                              seed=5 + cycle)
        it = infinite_batches(feed)
        t0 = time.time()
        losses, last = [], {}

        def on_step(i, m):
            losses.append(m["loss"])
            last.update(m)
        state = demo.train_steps(
            state, step, it, args.steps, generator, device, on_step,
            profiled="in-batch step, two towers" if cycle == 0 else None)
        loss_val = float(torch.stack(losses[-50:]).float().mean())
        correct = float(last["correct_ratio"])
        train_sec = time.time() - t0
        t0 = time.time()
        model.eval()  # the encodes drop nothing (the JAX encode functions)
        result = generate_new_ann_dpr(
            output_num=cycle, checkpoint_path=f"cycle{cycle}",
            query_encode_fn=qfn, body_encode_fn=bfn,
            train_query_cache=caches["train-query"],
            test_query_cache=caches["test-query"],
            trivia_test_query_cache=caches["trivia-test-query"],
            passage_cache=caches["passages"], passage_texts=passage_texts,
            train_answers=answers(args.train_q),
            test_answers=answers(args.test_q),
            trivia_test_answers=answers(args.trivia_q),
            training_query_positive_id=positives,
            output_dir=os.path.join(root, "ann"), device=device,
            topk_training=200, negative_sample=8, dev_search_depth=100,
            encode_batch_size=512,
            index=FlatIPIndex(dim=256, device=device, dtype=dtype),
            seed=cycle)
        triples = parse_triples(result["data_path"], rs)
        rec = {"event": "cycle", "cycle": cycle, "loss": round(loss_val, 4),
               "correct_ratio": round(correct, 3),
               "top20": round(result["top20"], 4),
               "top100": round(result["top100"], 4),
               "top20_trivia": round(result["top20_trivia"], 4),
               "train_sec": round(train_sec, 1),
               "gen_sec": round(time.time() - t0, 1)}
        log(rec)
        history.append(dict(rec, top100_trivia=result["top100_trivia"]))
    log({"event": "done", "total_sec": round(time.time() - t_start, 1),
         "final_top20": round(result["top20"], 4),
         "final_top100": round(result["top100"], 4)})
    return {"history": history, "result": result}


if __name__ == "__main__":
    main()
