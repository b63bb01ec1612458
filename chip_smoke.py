#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``ance_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the four kernel sources of
``ance_tpu_torch/csrc`` (block-max top-k, fused and flash attention, the
seq-128 attention pair; one nvcc each, all at once), prints ptxas's
registers and spills and the SASS counts of HGMMA / IGMMA (wgmma on bf16
or int8) and UTMALDG
(TMA loads) of the fifteen wgmma kernels (the fused forward and its two
backward passes on bf16, the two backward passes on fp32 pieces; the
flash forward on bf16 and on fp32 pieces, the latter also the fused
attention's fp32 forward; seq-128 kernel #5 and kernel #6's two launches;
block-max's bf16 route, its two fp32-query kernels and its two int8-corpus
kernels under bf16 and int8 queries), and then:

  * block-max: the kernel against its plain PyTorch version at the FirstP
    search shapes (1,000,448 × 768 corpus; Q=2048 k=10 and Q=512 k=200) for
    every dtype pair, the bf16 and fp32-query routes timed in turns with
    cuBLAS's product of the same operands (a rate reference: it takes no
    maxima) and with the kernel at D=64 (a tile's fixed part), the int8
    routes with their yardsticks (``torch._int_mm``; cuBLAS's bf16 product
    of the widened codes) and at D=64 (int8 x int8 bit-equal, bf16 x int8
    also against the exact fp64 maxima); the int8 routes at D=72
    (``blockmax_wmma``) and fp32 queries over a corpus view 4 bytes off
    alignment (``blockmax_simt``), the shapes no tensor map describes;
    ``FlatIPIndex`` block-max ids against the scan for the none / bf16 /
    dims indexes (each search's phase-1 kernel counted), each search's
    device time split by ``torch.profiler``
    (phase 1 and the largest kernels); the int8 phase-1 study
    (``experiments/perf_topk_int8.py``) at 1,000,000 × 768: each search
    variant's ids against the scan (``phase1_dtype=None`` equal to it),
    the bf16 and int8 phase 1's agreement, times in turns, and the study's
    block-max launches held to its calls; and the tie check: a
    1,000,448 × 768 bf16 index in which every 7th row is one vector that
    the queries rank inside their top k, where block-max ids must equal
    the scan's;
  * attention: each kernel against its plain version at the MaxP shapes
    (fused S = 256 / 300 / 512 / 1024 and the encoder's ``qkv.chunk``
    views, flash S = 512 / 2048 / 2100; bf16 and fp32, each fp32 forward
    on its pieces route and, on rows off alignment, its CUDA-core kernel,
    the route its wrapper names counted), timed in turns with SDPA (on
    fp32 operands for flash, whose function is fp32); the fp32 pieces
    routes also against the function in fp64; then the crossover series,
    bf16 and fp32 at S = 128 to 2048, the einsum paths, fused and flash
    timed in turns;
  * FirstP serve: RoBERTa-base at full width (seeded random weights, bf16)
    through the ``serve`` CLI in a subprocess and the HTTP server in
    process;
  * IVF and HNSW: ``IVFIPIndex`` over a clustered 262,144 × 768 corpus
    made on the card (nlist 512; fp32, bf16 and ``dims`` bins): two builds
    bit-equal, an exhaustive probe equal to the exact fp32 index (kernel
    #1), bf16 bins scoring in fp32, recall@10 at nprobe 8, times at B 1 to
    256 in turns with the exact bf16 and ``dims`` indexes, the build
    split; ``serve --index ivf`` over the FirstP passages (ranking as
    ``--index flat`` at nprobe = nlist, a saved ``dims`` artifact through
    ``--load_index --nprobe`` and ``POST /reload``); the HNSW indexer on
    the port's C++ core over 5,000 of the rows, its recall@10 against the
    exact search on the card;
  * MaxP serve: the same weights as ``rdot_nll_multi_chunk`` over 4,096
    documents of seq 2048 (16,384 chunk rows of 512): the ``serve`` CLI,
    an in-process encode through the fused kernel (and a slice of it
    through the flash kernel and the plain path), and the HTTP server,
    every answer held against a scan;
  * attention backward: kernel #3 (the fused backward) against its plain
    version at the MaxP training shape (64 chunk rows of S = 512, also as
    ``qkv.chunk`` views) and at S = 256 / 1024 / a ragged 300 and 65, bf16
    and fp32 (the pieces route, and the CUDA-core pair on rows off
    alignment), each call bit-equal to a second one, and the autograd
    ``Function`` (both kernels) against autograd through the plain
    forward; timed beside the backward of
    ``torch.nn.functional.scaled_dot_product_attention`` (a yardstick the
    port never calls);
  * train: ``python -m ance_tpu_torch.cli train`` (in process, as
    ``cli.main``) at full RoBERTa-base width, FirstP (batch 32, query seq
    64, passage seq 128, dropout 0.1, 20 steps) and MaxP (8 documents of
    seq 2048 per batch, attention dropout 0 so the fused kernels and their
    backward run: launches == 12 layers x 2 chunked passes x steps), each
    writing a checkpoint that loads strictly;
  * MaxP at the CLI's default fp32 (no --bf16): ``cli serve`` in process
    over 512 documents of seq 2048 (the fused forward's pieces route,
    ``flash_fwd_pieces``, on every layer, an fp32 index on ``blockmax_pieces_f32``), every ranking
    held against a scan of its saved index, an fp32 encode rate, the
    first batches encoded with ``--attention flash`` (the flash kernel's
    pieces route on every layer, the chunk embeddings against the fused
    encode's by cosine), ``cli train`` (4 documents a batch, attention
    dropout 0, so the pieces forward and backward run on every layer)
    writing a checkpoint that loads strictly, the launches of each route
    counted, and the kernels held to their plain versions on the operands
    this path gave them;
  * step parity: 3 steps, dropout off, two layers at full width (init std
    0.05, so no loss saturates): fp32 on the card against the port's CPU
    path, and bf16 (the kernels) against fp32 on the card by loss, update
    cosine and first-step gradient cosines, MaxP's also against a control
    that runs bf16 through the plain einsum attention;
  * seq-128 attention: kernels #5 (``fused128``) and #6 (``fused_block``)
    against their plain versions at B=128 × S=128 × 768 bf16 (a padding
    tail from 100, one fully masked row), timed in turns with SDPA and the
    unfused composition, #6's two launches split by ``torch.profiler``;
    then the experiment's mirror encoder (12 layers,
    FFN 3072, vocabulary 50265, seeded bf16 weights) through its four
    attention variants, each against ``xla`` by per-row cosine, with the
    kernels' launches counted over one forward;
  * generate: the generator job at full RoBERTa-base width over the
    FirstP serve caches (32,768 passages, 1,024 train and 256 dev queries,
    synthetic qrels): ``cli generate`` at k=500 (an fp32 index: phase 1 on
    ``blockmax_pieces_f32``) and again with ``--index_quantize dims``
    (``blockmax_pieces_int8``), the mining ids of each against a scan of
    its index and its phase 1 on the operands its searches gave it (the
    encoder's embeddings) against the plain version, ``infer`` +
    ``eval-full`` (its NDCG@10 equals generate's),
    ``cli train`` on the file and ``generate --training_dir`` on its
    checkpoint, then ``run_ance_cycles`` (2 cycles x 3 steps);
  * warmup: the front of the pipeline on raw MS MARCO-format TSVs made
    from a seed (16,384 passages of 40-120 words, 1,024 train and 256 dev
    queries with qrels, top1000.dev, 48 x 32 triples), tokenized by a
    word-hash tokenizer in RoBERTa's id space (no tokenizer files, no
    hub): ``cli preprocess`` over 4 spawned workers (every record against
    the tokenizer, the qrels against the rows), ``cli warmup`` at full
    width (bf16, LAMB 2e-4, batch 32) to step 12 with an in-training
    eval, a rerun to 24 that resumes, ``cli generate --training_dir`` on
    the warmup checkpoint (``blockmax_pieces_f32`` launched exactly twice,
    mining ids == a scan, dev NDCG == ``eval-full``'s), ``cli export-hf``
    and ``serve`` from the export (rankings byte-equal to serving the
    checkpoint, embeddings bit-equal);
  * ance-loop: the pipelined refresh through ``cli ance-loop`` on the
    generator's data and weights: FirstP over an fp32 index with
    ``--http`` and a client sending B=1, k=10 searches at 10/s while it
    trains (bootstrap, a whole cycle of 8 slices of 4,096 passages, 4
    steps an item, then 4 steps more; its bootstrap dev NDCG equal to
    ``generate``'s, every mining search equal to a scan of the index as
    it stood, every live answer 200 and, after the run, equal to
    ``LoopRetriever.search_tokens``, block-max launches == S and M items
    plus live searches), over an int8 ``dims`` index, and MaxP (bf16,
    kernel #2 counted in the encode items, #3 in the steps), each
    kernel held to its plain version on the loop's own operands;
  * dpr: DPR's BiEncoder (two seeded BERT-base towers, seq 256) as its
    runbook drives it, over a psgs_w100.tsv-format corpus of 8,192
    passages and NQ / TriviaQA question files made from a seed and
    tokenized by a word-hash tokenizer in BERT's id space:
    ``preprocess-dpr`` over 4 spawned workers (records against the
    tokenizer), a polling ``train`` at the default dropout (the einsum
    attention, no #2 / #3 launch), ``train --num_epoch 2 --dev_data``
    with attention dropout 0 and GradCache accumulation (#2 and #3 at
    S = 256, launches == 24 a tower pass), the fp32 GradCache step against
    an unaccumulated step on the card (loss, correct, gradient norm and
    every gradient; its #2 / #3 pieces launches counted and its first
    forward and backward held to plain), ``generate-dpr`` in bf16, at the CLI's
    fp32 and over a ``dims`` index (#1 once a search; mining ids and the
    test hit curve == a scan; no mined negative holds an answer),
    ``export-hf --model_type dpr`` (its ``model_dict`` loads strictly and
    encodes bit for bit as the checkpoint), #1 / #2 / #3 held to their
    plain versions on the operands each of those paths gave them, and
    the 21M-passage capacity check: ``FlatIPIndex`` of 21,015,324 x 768
    rows filled on the card from a seed, as ``dims`` and as fp32, beside
    the resident encoder, a mining (Q=512 k=200) and a dev (Q=2048 k=100)
    ``index.search`` each (the search splits its queries as far as the
    memory left needs), a sample held to a scan, peak memory printed;
  * seed: SEED at ``seed_encoder_config``'s width (12 layers, 768,
    vocabulary 32,769; a 3-layer window-2 decoder) from a seed: a
    32,768-line vocab.txt, ``preprocess --model_type seeddot_nll`` of the
    warmup phase's kind of raw TSVs over 4 spawned workers on the C++
    WordPiece core (every record against the Python path),
    ``seed-pretrain`` (B=16 x S=512, bf16, attention dropout 0: #2 and #3
    launched 12 a step, held to plain on the operands it gave them), a
    two-layer step parity (fp32 card vs CPU, bf16 vs fp32),
    ``greedy_decode`` against the teacher-forced decoder, ``train
    --model_type seeddot_nll`` warm-started from the pretrain
    checkpoint's encoder (bit-equal before step 1), ``generate`` (#1 on
    an fp32 index, twice) with ``infer`` + ``eval-full``, ``export-hf``
    of both checkpoints re-imported bit for bit, and ``serve --bf16``
    from the export (rankings byte-equal to serving the checkpoint);
  * mesh: data parallelism, two ranks sharing this card through gloo
    (``phase_mesh``; not a multi-GPU measurement), each a process of
    ``ance_tpu_torch.experiments.mesh_worker`` or of the CLI with a time
    limit: the row-sharded exact index over 1,000,003 x 768 rows (fp32,
    bf16, dims; kernel #1 on every shard) equal to the one-process index
    at 2 gloo ranks and at 1 NCCL rank; ``cli train`` FirstP (fp32, 3
    steps) and ``cli ance-loop`` (bootstrap equal to the one-process one
    exactly, then 2 steps) against one process; the DPR GradCache step
    (bf16, #2 and #3) against the one-process step; NCCL with two ranks
    on one card and a rank without a GPU refused;
  * tp: tensor parallelism (``core/tp.py``), two CLI ranks sharing this
    card through gloo (``phase_tp``): ``generate`` at tp 2 (RoBERTa-base,
    fp32, xla attention) against one process (passage embeddings, dev
    NDCG, mined ids but for near-ties, #1 on both ranks, each rank half
    of every column-parallel weight), ``generate`` at tp 1 (hand-off files
    byte-equal), ``generate-dpr --bf16`` at tp 2 on the DPR phase's
    towers, and the refusals (``--attention auto``, tp 3 at two ranks,
    NCCL on one card);
  * demo: the learning demos' paths (``experiments/demo*.py``): (a) the
    MaxP in-batch step (``make_dpr_train_step(multichunk=True)``) of
    ``rdot_nll_multi_chunk`` at full width, 8 queries of seq 64 and 16
    documents of 4 x 512 with empty chunks, in bf16 with attention dropout
    0 (#2 / #3 12 a step, the first call of each held to plain; step ms,
    peak memory), then in fp32 the GradCache step (accumulation 2) against
    the unaccumulated one and both against the step in fp64, each
    distance printed against the element and the normwise bound; (b) the
    FirstP demo cut only in corpus size (16,384 passages; 1,000 warmup
    steps and 1,856 loop steps), in a process of its own beside the DPR,
    SEED, mesh and tp phases (its loop is bound by the host): bootstrap dev
    NDCG@10 at chance, the last refresh at 0.5 or above, every mining pass
    equal to a scan, #1 once a search item and on the loop's own D = 256
    operands against plain and the exact maxima, timed beside its bound.
    The DPR phase's GradCache check is held against the fp64 step too.

Each phase's wall seconds print before the result lines.

Any failed check raises, so the exit code is non-zero and no result line
is printed. The last two lines are a JSON object of per-kernel results
(each with its launches on the main path, its error against the plain
version, its time, the plain version's, a library call's where one
computes the same function, and the bound: the larger of the bytes it
must move over 3.35 TB/s and its operations over the H100's dense peak for
their type; and the SM clock and power draw that ``nvidia-smi`` read just
before and just after the kernel was timed with its yardstick, in turns)
and ``{"ok": true, "device": {...}}``. Every kernel's line of output
carries those clock readings too.

Exits non-zero at once where CUDA is unavailable or the package is not
beside this file.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_CORPUS = 1_000_000
CHUNK_ROWS = 1024
DIM = 768
SHAPES = {"dev": (2048, 10), "mining": (512, 200)}
N_PASSAGES, PASSAGE_LEN = 32_768, 128
N_QUERIES, QUERY_LEN = 256, 64
N_DOCS, DOC_LEN, CHUNK_LEN = 4096, 2048, 512  # MaxP: 16,384 chunk rows
DOC_BATCH = 32  # documents per MaxP encode batch: 128 chunk rows
N_CHECK_DOCS = 8  # documents re-encoded on the plain / fp32 paths
REPEATS = 5  # timed requests per (batch, k) after one warm-up each
KERNELS = ("blockmax", "fused_attention", "flash_attention",
           "attn128")
# fp32 sums of 768 products (|score| up to ~150, ulp ~1.5e-5) taken in
# another order than cuBLAS's: the drift stays well under 2e-3
FLOAT_ATOL = 2e-3
FLOAT_ATOL_SCORE = 150.0  # the |score| that FLOAT_ATOL was set for
N_ORACLE = 256  # queries per search held against a plain torch.topk
# H100 SXM: HBM bytes/s and dense peaks by operation type (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
TRAIN_QUERIES, TRAIN_PASSAGES = 1024, 8192
TRAIN_BATCH, TRAIN_STEPS = 32, 20
MAXP_TRAIN_DOCS, MAXP_TRAIN_BATCH, MAXP_TRAIN_STEPS = 256, 8, 5
# MaxP at the CLI's default fp32: a slice of documents to serve (2,048
# chunk rows), and a smaller train batch
N_F32_DOCS = 512
MAXP_F32_TRAIN_BATCH, MAXP_F32_TRAIN_STEPS = 4, 5
TIMED_FROM = 3  # step times are medians over the steps after these
SEQ128_BATCH, SEQ128_LEN, SEQ128_PAD_FROM = 128, 128, 100
# per-row cosine of a mirror-encoder variant's [B, 768] output against
# xla's: the variants compute one function with other roundings (xla
# rounds its scores to bf16 before the softmax, the kernels do not),
# through 12 bf16 layers (seen on an H100: 0.99991-0.99992)
MIRROR_COSINE = 0.999
GEN_TRAIN_QUERIES, GEN_TOPK, GEN_NEGATIVES = 1024, 500, 5


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def no_reference_modules() -> bool:
    """True while neither jax nor the JAX package has been imported."""
    return not any(m in ("jax", "flax", "ance_tpu")
                   or m.startswith(("jax.", "flax.", "ance_tpu."))
                   for m in sys.modules)


def bound(bytes_moved: float, ops: float, op_type: str) -> tuple[float, str]:
    """(least ms the card could take, what bounds it): the larger of the
    bytes over the HBM rate and the operations over the peak for their
    type."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[op_type]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def reset_blockmax_counts() -> None:
    """Set the block-max wrapper's launch counts (all kernels, and each
    kernel's) to 0, just before a path runs."""
    from ance_tpu_torch.ops.topk import blockmax_scores
    blockmax_scores.launches = 0
    blockmax_scores.kernel_launches.clear()


def blockmax_counts() -> dict:
    """The block-max launches of each kernel since the last reset."""
    from ance_tpu_torch.ops.topk import blockmax_scores
    return dict(blockmax_scores.kernel_launches)


def phase_device():
    import torch
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    print(f"device: {name} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s))")
    print(smi.strip().splitlines()[0])
    return name


def phase_build() -> tuple[dict, dict]:
    """One nvcc per kernel source, all started together; returns the
    seconds each took and each (library path, nvcc's stderr: "" where the
    library was current already)."""
    from concurrent.futures import ThreadPoolExecutor
    from ance_tpu_torch.ops import _build

    def timed(name):
        t0 = time.perf_counter()
        path, log = _build.build(name)
        return path, log, time.perf_counter() - t0

    with ThreadPoolExecutor(len(KERNELS)) as pool:
        done = dict(zip(KERNELS, pool.map(timed, KERNELS)))
    for name, (path, log, seconds) in done.items():
        print(f"build: {path.name} in {seconds:.2f} s")
        if log:
            print(log, file=sys.stderr)
    return ({name: seconds for name, (_, _, seconds) in done.items()},
            {name: (path, log) for name, (path, log, _) in done.items()})


# the wgmma + TMA kernels of each source; ``<source>_bf16_smem`` reports
# the dynamic shared memory each is launched with, in this order
WGMMA_KERNELS = {
    "fused_attention": ("fused_fwd_bf16", "fused_bwd_rows_bf16",
                        "fused_bwd_keys_bf16", "fused_bwd_rows_pieces",
                        "fused_bwd_keys_pieces"),
    "flash_attention": ("flash_fwd_bf16", "flash_fwd_pieces"),
    "attn128": ("attn128_kernel", "qkv_attend_kernel", "out_proj_kernel"),
    "blockmax": ("blockmax_bf16", "blockmax_pieces_f32",
                 "blockmax_pieces_int8", "blockmax_int8",
                 "blockmax_bf16_int8"),
}
# block-max's fp32-query routes run each fp32 product as bf16 piece
# products on wgmma: the six with i + j <= 2 of three query pieces and
# three corpus pieces, or the three of the query pieces with an int8 code
FP32_PIECE_PRODUCTS = {"f32xf32": 6, "f32xint8": 3}
# the block-max routes timed with a tile split and cuBLAS's product: piece
# products a k step
WGMMA_PRODUCTS = {"bf16xbf16": 1, **FP32_PIECE_PRODUCTS}
# the phase-1 kernel of each dtype pair at D = 768 on aligned operands, and
# of each FlatIPIndex kind
ROUTE_KERNEL = {"f32xf32": "blockmax_pieces_f32", "bf16xbf16": "blockmax_bf16",
                "f32xint8": "blockmax_pieces_int8",
                "bf16xint8": "blockmax_bf16_int8", "int8xint8": "blockmax_int8"}
# the int8 phase-1 study (experiments/perf_topk_int8.py): its search
# variants' phase-1 kernels, and its calls a timed variant (reps small)
STUDY_KERNEL = {"bf16_corpus": "blockmax_bf16",
                "int8_fp32": "blockmax_pieces_int8",
                "int8_bf16": "blockmax_bf16_int8", "int8_int8": "blockmax_int8"}
STUDY_REPS = 3
INDEX_KERNEL = {"none": "blockmax_pieces_f32", "bf16": "blockmax_bf16",
                "dims": "blockmax_pieces_int8"}


def kernel_named(symbol: str, kernels) -> str | None:
    """The kernel of ``kernels`` a (mangled) symbol names: the longest
    name it holds, since ``blockmax_bf16_int8``'s also holds
    ``blockmax_bf16``."""
    return max((n for n in kernels if n in symbol), key=len, default=None)


def phase_machine_code(built: dict) -> dict:
    """For each wgmma kernel (``WGMMA_KERNELS``): ptxas's registers, stack
    and spills (from the build's ``-Xptxas -v`` report, so only when this
    run built the library), the dynamic shared memory it is launched with
    and, where ``cuobjdump`` exists, the SASS counts of HGMMA and IGMMA
    (wgmma on bf16 and on int8) and
    UTMALDG (TMA tile loads). ``built`` maps each source to (library path,
    nvcc's stderr)."""
    import ctypes
    import re
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = {}
    for source, kernels in WGMMA_KERNELS.items():
        path, log = built[source]
        smem = (ctypes.c_int * len(kernels))()
        getattr(ctypes.CDLL(str(path)), f"{source}_bf16_smem")(smem)
        own = {name: {"source": f"{source}.cu", "smem_bytes": smem[i]}
               for i, name in enumerate(kernels)}
        current = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                current = kernel_named(m.group(1), kernels)
                continue
            if current is None:
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m:
                own[current].update(stack_bytes=int(m.group(1)),
                                    spill_store_bytes=int(m.group(2)),
                                    spill_load_bytes=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                own[current]["registers"] = int(m.group(1))
        if os.path.exists(cuobjdump):
            sass = subprocess.run([cuobjdump, "-sass", str(path)],
                                  capture_output=True, text=True, check=True,
                                  timeout=300).stdout
            current = None
            for line in sass.splitlines():
                m = re.search(r"Function : (\S+)", line)
                if m:
                    current = kernel_named(m.group(1), kernels)
                    if current:
                        own[current].update(hgmma=0, igmma=0, utmaldg=0)
                elif current:
                    own[current]["hgmma"] += "HGMMA" in line
                    own[current]["igmma"] += "IGMMA" in line
                    own[current]["utmaldg"] += "UTMALDG" in line
        for name, info in own.items():
            print(f"machine code {name}: {info}", flush=True)
            if log:
                check("registers" in info, f"no ptxas report for {name}")
            if "hgmma" in info:
                check(info["hgmma"] + info["igmma"] > 0
                      and info["utmaldg"] > 0,
                      f"{name}: no HGMMA or IGMMA / UTMALDG in its SASS")
        out.update(own)
    return out


def check_against_plain_topk(scores, ids, q, c, k: int) -> float:
    """Hold a search's first N_ORACLE answers against ``torch.topk`` over a
    full fp32 ``q @ c.T``, which shares no code with either search path.
    Sorted scores agree within FLOAT_ATOL; ids agree wherever the reference
    score is more than 2 * FLOAT_ATOL from its neighbours (closer pairs may
    legitimately swap between fp32 and exact sums). Returns the share of
    positions whose ids were compared."""
    import torch
    ref_s, ref_i = torch.topk(q[:N_ORACLE] @ c.T, k + 1, dim=1)
    got_s, got_i = scores[:N_ORACLE], ids[:N_ORACLE]
    err = (got_s - ref_s[:, :k]).abs().max().item()
    check(err <= FLOAT_ATOL, f"scores differ from plain topk by {err}")
    gaps = ref_s[:, :-1] - ref_s[:, 1:]                 # [n, k]
    before = torch.cat([torch.full_like(gaps[:, :1], float("inf")),
                        gaps[:, :-1]], dim=1)
    clear = torch.minimum(before, gaps) > 2 * FLOAT_ATOL
    check(torch.equal(got_i[clear], ref_i[:, :k][clear]),
          "ids differ from plain topk at well-separated scores")
    share = clear.float().mean().item()
    check(share >= 0.5, f"only {share:.3f} of positions well separated")
    return share


def device_split(fn) -> dict:
    """``torch.profiler`` over one ``fn()`` (after one warm-up): device ms
    summed over its kernels and copies, the block-max kernel's part of it
    (phase 1), and the eight largest kernels by name (cut to 80
    characters, kernels whose cut names agree summed)."""
    import collections
    import torch
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(
                e, "is_user_annotation", False):
            kernels[e.name[:80]] += e.time_range.elapsed_us() / 1e3
    device_ms = sum(kernels.values())
    phase1 = sum(ms for name, ms in kernels.items() if "blockmax" in name)
    return {"device_ms": device_ms, "phase1_ms": phase1,
            "top_kernels_ms": dict(kernels.most_common(8))}


def phase_kernel():
    """Kernel vs plain at the 1M search shapes; FlatIPIndex block-max ids
    vs the scan on the same index, and both against a plain torch.topk."""
    import torch
    from ance_tpu_torch.utils.timing import (clocks_text, cuda_ms,
                                             timed_in_turns)
    from ance_tpu_torch.index.flat import FlatIPIndex, quantize_dims_int8
    from ance_tpu_torch.ops.topk import (blockmax_kernel_for,
                                         blockmax_scores,
                                         blockmax_scores_reference,
                                         quantize_query_rows_int8)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    n_pad = -(-N_CORPUS // CHUNK_ROWS) * CHUNK_ROWS
    corpus = torch.randn(n_pad, DIM, generator=g, device=dev)
    corpus[N_CORPUS:] = 0  # topk_blockmax pads with zero rows
    c8, dim_scales = quantize_dims_int8(corpus[:N_CORPUS])
    c8 = torch.cat([c8, c8.new_zeros(n_pad - N_CORPUS, DIM)])
    queries = {name: torch.randn(q, DIM, generator=g, device=dev)
               for name, (q, _) in SHAPES.items()}

    cases = []
    # the 1M search shapes for every dtype pair, and the serve phase's own
    # shape (bf16 index of N_PASSAGES rows, a 256-query request)
    serve_q = queries["dev"][:N_QUERIES].to(torch.bfloat16)
    shapes = [(shape, {
        "f32xf32": (q, corpus),
        "bf16xbf16": (q.to(torch.bfloat16), corpus.to(torch.bfloat16)),
        "f32xint8": (q * dim_scales, c8),
        "bf16xint8": ((q * dim_scales).to(torch.bfloat16), c8),
        "int8xint8": (quantize_query_rows_int8(q * dim_scales), c8),
    }) for shape, q in queries.items()]
    # the int8 routes at D = 64 (one half-empty 128-column stage), and at
    # D = 72, which no tensor map describes (blockmax_wmma), over the
    # serve phase's row count
    q_dev = queries["dev"] * dim_scales
    shapes.append(("d64", {
        "bf16xint8": (q_dev[:, :64].to(torch.bfloat16), c8[:, :64].clone()),
        "int8xint8": (quantize_query_rows_int8(q_dev[:, :64]),
                      c8[:, :64].clone())}))
    shapes.append(("d72", {
        "bf16xint8": (q_dev[:N_QUERIES, :72].to(torch.bfloat16),
                      c8[:N_PASSAGES, :72].clone()),
        "int8xint8": (quantize_query_rows_int8(q_dev[:N_QUERIES, :72]),
                      c8[:N_PASSAGES, :72].clone())}))
    shapes.append(("serve", {"bf16xbf16": (
        serve_q, corpus[:N_PASSAGES].to(torch.bfloat16))}))
    # fp32 queries over an fp32 corpus whose base is 4 bytes off 16-byte
    # alignment: no tensor map describes it, so blockmax_simt takes it
    offset = torch.empty(N_PASSAGES * DIM + 1, device=dev)
    unaligned = offset[1:].view(N_PASSAGES, DIM)
    unaligned.copy_(corpus[:N_PASSAGES])
    shapes.append(("unaligned", {"f32xf32": (queries["dev"][:N_QUERIES],
                                             unaligned)}))
    for shape, operands in shapes:
        for dtypes, (qq, cc) in operands.items():
            kernel_name = {"unaligned": "blockmax_simt",
                           "d72": "blockmax_wmma"}.get(shape,
                                                       ROUTE_KERNEL[dtypes])
            check(blockmax_kernel_for(qq, cc) == kernel_name, f"{dtypes} "
                  f"{shape}: phase 1 would take "
                  f"{blockmax_kernel_for(qq, cc)}, not {kernel_name}")
            reset_blockmax_counts()
            got = blockmax_scores(qq, cc, chunk_rows=CHUNK_ROWS)
            check(blockmax_counts() == {kernel_name: 1}, f"{dtypes} {shape}: "
                  f"launched {blockmax_counts()}")
            want = blockmax_scores_reference(qq, cc)
            torch.cuda.synchronize()
            check(got.shape == want.shape ==
                  (qq.shape[0], cc.shape[0] // 16),
                  f"blockmax shape {tuple(got.shape)}")
            exact = {}
            if dtypes == "int8xint8":
                check(got.dtype == torch.int32 and torch.equal(got, want),
                      f"{dtypes} {shape}: int32 block maxima differ")
                err = 0.0
            else:
                err = (got - want).abs().max().item()
                check(err <= FLOAT_ATOL, f"{dtypes} {shape}: max |err| "
                      f"{err} > {FLOAT_ATOL}")
            if dtypes == "bf16xint8":
                # both against the exact maxima (fp64) of the first 64
                # queries: how much of the gap is the kernel's
                qd = qq[:64].double()
                x = (qd @ cc.double().T).reshape(qd.shape[0], -1, 16).amax(-1)
                exact = {"max_abs_err_exact":
                         (got[:64].double() - x).abs().max().item(),
                         "plain_max_abs_err_exact":
                         (want[:64].double() - x).abs().max().item()}
                del qd, x
            del got, want
            kernel = {"ms": lambda: blockmax_scores(qq, cc,
                                                    chunk_rows=CHUNK_ROWS)}
            # the wgmma routes at the search shapes, and how many piece
            # products each runs a k step (fp32 queries: bf16 pieces)
            products = WGMMA_PRODUCTS.get(dtypes) if shape in SHAPES \
                else None
            if dtypes in ("bf16xint8", "int8xint8") and shape in SHAPES:
                # yardsticks: the same product at the library's rate (it
                # writes the whole score matrix, no block maxima):
                # torch._int_mm's int8 product with int32 output, and
                # cuBLAS's bf16 product of the widened codes (exact in
                # bf16) with fp32 output
                if dtypes == "bf16xint8":
                    cf = cc.to(torch.bfloat16)  # outside the window
                    kernel["yardstick_ms"] = lambda: torch.mm(
                        qq, cf.T, out_dtype=torch.float32)
                else:
                    kernel["yardstick_ms"] = lambda: torch._int_mm(qq, cc.T)
            if products:
                # cuBLAS's product of the same operands (fp32 output; for
                # fp32 queries the fp32 GEMM, TF32 off, of the corpus as
                # fp32), the rate a library reaches on this GEMM (it takes
                # no block maxima: a reference, not a yardstick); and the
                # kernel at D = 64, for a tile's fixed part
                q64, c64 = qq[:, :64].contiguous(), cc[:, :64].contiguous()
                if dtypes == "bf16xbf16":
                    kernel["gemm_ms"] = lambda: torch.mm(
                        qq, cc.T, out_dtype=torch.float32)
                else:
                    cf = cc.float()  # exact; outside the timed window
                    kernel["gemm_ms"] = lambda: torch.mm(qq, cf.T)
                kernel["d64_ms"] = lambda: blockmax_scores(
                    q64, c64, chunk_rows=CHUNK_ROWS)
            times, sampled = timed_in_turns(kernel)
            ms = times.pop("ms")
            plain_ms = cuda_ms(lambda: blockmax_scores_reference(qq, cc))
            extra = dict(exact)
            if "yardstick_ms" in times:
                extra["yardstick_ms"] = times["yardstick_ms"]
                extra["yardstick"] = (
                    "torch._int_mm(q8, c8.T)" if dtypes == "int8xint8" else
                    "torch.mm(q, c8.to(bf16).T, out_dtype=torch.float32)")
                cf = None
            if products:
                del q64, c64
                cf = None
                # a wave is one tile on every SM (128 rows x 256 queries,
                # x 128 for fp32 queries); the line through (D = 64) and
                # (D = DIM), in 64-column k steps (two 32-deep stages for
                # fp32 queries)
                n_sms = torch.cuda.get_device_properties(
                    dev).multi_processor_count
                tile_q = 256 if dtypes == "bf16xbf16" else 128
                tiles = -(-qq.shape[0] // tile_q) * -(-cc.shape[0] // 128)
                waves = -(-tiles // n_sms)
                steps = DIM // 64
                step_us = ((ms - times["d64_ms"]) * 1e3 / waves
                           / (steps - 1))
                extra = {"gemm_ms": times["gemm_ms"],
                         "d64_ms": times["d64_ms"], "waves": waves,
                         "tile_step_us": step_us,
                         "tile_step_us_a_product": step_us / products,
                         "tile_fixed_us":
                         times["d64_ms"] * 1e3 / waves - step_us}
            # read q and c once, write the [Q, N/16] maxima; 2QND products
            # at the rate of the type they run in; fp32 queries run them as
            # bf16 piece products (6 or 3 a product, at the bf16 rate), and
            # beside that the bound at the CUDA cores' fp32 rate
            nq, nc, dim = qq.shape[0], cc.shape[0], qq.shape[1]
            moved = (nq * dim * qq.element_size()
                     + nc * dim * cc.element_size() + nq * (nc // 16) * 4)
            qtype = dtypes.split("x")[0]
            if qtype == "f32":
                b_ms, b_by = bound(moved, 2.0 * nq * nc * dim
                                   * FP32_PIECE_PRODUCTS[dtypes], "bf16")
                extra["fp32_rate_bound_ms"] = bound(
                    moved, 2.0 * nq * nc * dim, "f32")[0]
            else:
                b_ms, b_by = bound(moved, 2.0 * nq * nc * dim, qtype)
            cases.append({"dtypes": dtypes, "shape": shape,
                          "kernel": kernel_name,
                          "Q": nq, "N": nc, "D": dim,
                          "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": b_ms, "bound_by": b_by,
                          "clocks": sampled, **extra})
            gemm_text = (f"  cuBLAS GEMM {extra['gemm_ms']:.3f} ms  D=64 "
                         f"{extra['d64_ms']:.3f} ms: a tile "
                         f"{extra['tile_fixed_us']:.3f} us fixed + "
                         f"{extra['tile_step_us']:.3f} us a 64-column k step"
                         f" ({extra['tile_step_us_a_product']:.3f} a product)"
                         if products else
                         f"  yardstick {extra['yardstick']} "
                         f"{extra['yardstick_ms']:.3f} ms"
                         if "yardstick_ms" in extra else "")
            if exact:
                gemm_text += (f"  vs fp64 exact (64 queries): kernel "
                              f"{exact['max_abs_err_exact']:.3g}, plain "
                              f"{exact['plain_max_abs_err_exact']:.3g}")
            fp32_text = (f", fp32 rate {extra['fp32_rate_bound_ms']:.3f} ms"
                         if "fp32_rate_bound_ms" in extra else "")
            print(f"kernel {dtypes:10s} {shape:6s} Q={qq.shape[0]:5d} "
                  f"N={cc.shape[0]} D={dim} ({cases[-1]['kernel']}): max|err| "
                  f"{err:.3g}  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms"
                  f"{gemm_text}  bound {b_ms:.3f} ms ({b_by}{fp32_text})  "
                  f"{clocks_text(sampled)}", flush=True)
            torch.cuda.empty_cache()

    searches = []
    for kind in ("none", "bf16", "dims"):
        index = FlatIPIndex(
            DIM, device=dev,
            dtype=torch.bfloat16 if kind == "bf16" else torch.float32,
            quantize="dims" if kind == "dims" else False)
        index.add_chunked(corpus[:N_CORPUS])
        # what the index holds and the queries it searches with, in fp32
        c_ref = {"none": corpus[:N_CORPUS],
                 "bf16": corpus[:N_CORPUS].to(torch.bfloat16).float(),
                 "dims": c8[:N_CORPUS].float()}[kind]
        for shape, (nq, k) in SHAPES.items():
            q = queries[shape]
            q_ref = {"none": q, "bf16": q.to(torch.bfloat16).float(),
                     "dims": q * dim_scales}[kind]
            reset_blockmax_counts()
            s1, i1 = index.search(q, k)
            by_kernel = blockmax_counts()
            check(by_kernel == {INDEX_KERNEL[kind]: 1}, f"index {kind} "
                  f"{shape}: phase 1 launched {by_kernel}")
            index.method = "scan"
            s2, i2 = index.search(q, k)
            index.method = "auto"
            same = (i1 == i2).float().mean().item()
            check(same == 1.0, f"index {kind} {shape}: blockmax ids match "
                  f"the scan on {same:.6f} of positions, not all")
            check(torch.equal(s1, s2), f"index {kind} {shape}: scores differ")
            check(bool((i1 >= 0).all()) and bool((i1 < N_CORPUS).all()),
                  f"index {kind} {shape}: ids out of range")
            share = check_against_plain_topk(s1, i1, q_ref, c_ref, k)
            ms = cuda_ms(lambda: index.search(q, k), reps=3)
            split = device_split(lambda: index.search(q, k))
            searches.append({"index": kind, "kernel": INDEX_KERNEL[kind],
                             "shape": shape, "Q": nq, "k": k,
                             "search_ms": ms, "oracle_ids_compared": share,
                             "split": split})
            print(f"index {kind:4s} {shape:6s} Q={nq} k={k} "
                  f"({INDEX_KERNEL[kind]}): ids == scan, "
                  f"== plain topk on {share:.4f} of {N_ORACLE}x{k}, search "
                  f"{ms:.3f} ms ({nq / ms * 1000:.0f} qps); device "
                  f"{split['device_ms']:.3f} ms, phase 1 "
                  f"{split['phase1_ms']:.3f}; {split['top_kernels_ms']}",
                  flush=True)
        del index, c_ref
        torch.cuda.empty_cache()
    del corpus, c8, queries, offset, unaligned, q_dev, shapes
    torch.cuda.empty_cache()
    return cases, searches


def phase_topk_int8() -> dict:
    """The int8 phase-1 study (``experiments/perf_topk_int8.py``, the port
    of ``docs/perf_topk_int8_r4.py``) at its full shape, 1,000,000 × 768
    dims-quantized, through its own functions: at Q=2048 k=10 and Q=512
    k=200 each search variant's ids against the scan over the same int8
    corpus (``phase1_dtype=None`` must equal it id for id; bf16 and int8
    agreement printed), times in turns; phase 1 alone at Q=2048. The
    block-max launches of the whole study, counted from 0, must equal the
    calls it made of each variant, by the kernel each variant takes."""
    import collections
    import torch
    from ance_tpu_torch.experiments import perf_topk_int8 as study

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    corpus = study.make_corpus(N_CORPUS, DIM, g, dev)
    rows, expected = [], collections.Counter()
    reset_blockmax_counts()
    for tag, n_q, k in study.SHAPES:
        q, qs = study.make_queries(n_q, corpus["scales"], g)
        row = study.study_shape(tag, q, qs, k, corpus, reps=STUDY_REPS)
        for name, kernel in STUDY_KERNEL.items():
            check(row[f"{name}_kernel"] == kernel, f"study {tag} {name}: "
                  f"phase 1 takes {row[f'{name}_kernel']}, not {kernel}")
            expected[kernel] += row["runs"][name]
        check(row["int8_fp32_equal"], f"study {tag}: phase1_dtype=None ids "
              "differ from the scan's")
        rows.append(row)
        print(f"topk_int8 {tag} Q={n_q} k={k}: scan {row['scan_int8_ms']:.3f}"
              " ms; " + "; ".join(
                  f"{name} {row[f'{name}_ms']:.3f} ms ({row[f'{name}_qps']:.0f}"
                  f" qps) agree {row[f'{name}_agree']:.6f}"
                  for name in STUDY_KERNEL), flush=True)
        if tag == "dev":
            phase1 = study.study_phase1(qs, corpus, reps=STUDY_REPS)
            for name, info in phase1.items():
                if name != "phase1_shape":
                    expected[info["kernel"]] += info["runs"]
            print("topk_int8 phase 1 " + "; ".join(
                f"{name} ({info['kernel']}) {info['ms']:.3f} ms "
                f"{info['tf_s']:.1f} TFLOP/s" for name, info in phase1.items()
                if name != "phase1_shape"), flush=True)
        del q, qs
    launches = blockmax_counts()
    check(launches == dict(expected), f"the study launched {launches}, its "
          f"calls were {dict(expected)}")
    del corpus
    torch.cuda.empty_cache()
    return {"shapes": rows, "phase1": phase1, "launches": launches}


def phase_ties():
    """Block-max ids against the scan where blocks tie at the k-th block
    maximum, as all-padding MaxP chunks make them: every 7th row of a
    1,000,448 × 768 bf16 index is one vector, so every 16-row block holds
    a copy. Queries near it (alpha 1: it tops every list; alpha 0.2: it
    ranks inside the top k among random rows)."""
    import torch
    from ance_tpu_torch.index.flat import FlatIPIndex

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    n = -(-N_CORPUS // CHUNK_ROWS) * CHUNK_ROWS
    corpus = torch.randn(n, DIM, generator=g, device=dev)
    dup = torch.randn(DIM, generator=g, device=dev)
    corpus[::7] = dup
    index = FlatIPIndex(DIM, device=dev, dtype=torch.bfloat16)
    index.add_chunked(corpus)
    del corpus
    out = []
    for alpha, k, need in ((1.0, 10, 1.0), (1.0, 100, 1.0), (0.2, 100, 0.9)):
        q = alpha * dup + torch.randn(512, DIM, generator=g, device=dev)
        s1, i1 = index.search(q, k)
        index.method = "scan"
        s2, i2 = index.search(q, k)
        index.method = "auto"
        inside = (i2 % 7 == 0).any(1).float().mean().item()
        check(inside >= need, f"ties alpha={alpha} k={k}: the repeated row "
              f"is in the top k of only {inside:.3f} of the queries")
        same = (i1 == i2).float().mean().item()
        check(same == 1.0 and torch.equal(s1, s2), f"ties alpha={alpha} "
              f"k={k}: block-max ids equal the scan on {same:.6f} of "
              "positions, not all")
        out.append({"alpha": alpha, "k": k, "inside_top_k": inside,
                    "ids_equal_scan": same})
        print(f"ties alpha={alpha} k={k}: repeated row in the top k of "
              f"{inside:.3f} of 512 queries; block-max ids == scan",
              flush=True)
    del index
    torch.cuda.empty_cache()
    return out


def _bf16_ulp(x):
    """One bf16 ulp (8 significant bits) of each |x|; 0 where x is 0."""
    import torch
    x = x.float().abs()
    _, e = torch.frexp(x)
    return torch.where(x > 0, torch.ldexp(torch.ones_like(x), e - 8),
                       torch.zeros_like(x))


BF16_SLICE_TOL = "2 bf16 ulps of |plain| + 2 of its (row, head) slice's max"


def bf16_slice_excess(got, want) -> tuple[int, float, float]:
    """A bf16 attention output or gradient [B, S, H, D] against its plain
    version: (elements beyond BF16_SLICE_TOL, max |err|, the largest error
    in ulps of its slice's max). Slices differ in scale by ~100x: a row of
    1-3 valid keys sums its dk and dv over every query, so a bound from the
    whole tensor's max would pass a kernel that zeroed the ordinary rows.
    The two can differ by one rounding of the output and of a bf16 p or ds,
    each a fraction of an ulp of the slice."""
    import torch
    w = want.float()
    err = (got.float() - w).abs()
    slice_ulp = _bf16_ulp(w.abs().amax(dim=(1, 3), keepdim=True))
    n_bad = int((err > 2 * _bf16_ulp(w) + 2 * slice_ulp).sum())
    in_ulps = torch.where(err > 0, err / slice_ulp, torch.zeros_like(err))
    return n_bad, err.max().item(), in_ulps.max().item()


def slice_rel_err(got, want) -> float:
    """The largest over (batch row, head) slices of ||got − want|| /
    ||want|| for [B, S, H, D] tensors (||got − want|| where want is 0)."""
    import torch
    d = (got.float() - want.float()).pow(2).sum(dim=(1, 3)).sqrt()
    n = want.float().pow(2).sum(dim=(1, 3)).sqrt()
    return torch.where(n > 0, d / n, d).max().item()


def _attention_inputs(B, S, dtype, seed, H=12, D=64, strided=False,
                      misaligned=False):
    """q, k, v ~ N(0, 1) [B, S, H, D] on the card (``strided``: the three
    chunks of one [B, S, 3·H·D] fused-QKV projection, as the encoder
    passes them; ``misaligned``: views into [..., D + 2] tensors, rows 8
    bytes off 16-byte alignment for fp32); a mask of random lengths with
    row 0 fully masked (an all-padding MaxP chunk)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    if strided:
        qkv = torch.randn(B, S, 3 * H * D, generator=g, device="cuda").to(dtype)
        q, k, v = (t.view(B, S, H, D) for t in qkv.chunk(3, dim=-1))
    elif misaligned:
        q, k, v = (torch.randn(B, S, H, D + 2, generator=g, device="cuda")
                   .to(dtype)[..., 2:] for _ in range(3))
    else:
        q, k, v = (torch.randn(B, S, H, D, generator=g, device="cuda")
                   .to(dtype) for _ in range(3))
    lengths = torch.randint(1, S + 1, (B,), generator=g, device="cuda")
    mask = (torch.arange(S, device="cuda")[None] < lengths[:, None]).long()
    mask[0] = 0
    return q, k, v, mask


def exact_attention(q, k, v, mask, do=None):
    """The fp32 fused function in fp64 on the card (rounding only the
    inputs): out, or (dq, dk, dv) for an output gradient ``do``. Keys the
    mask drops weigh 0; a fully masked row weighs every key alike, as the
    fp32 function does (its s rounds to -1e9 on every key), while its
    gradient flows through s as the fp32 function's does (s - s.detach():
    0, differentiable), so autograd through this forward is the
    backward's formula too."""
    import torch
    f64 = torch.float64
    qd, kd, vd = (t.to(f64) for t in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qd, kd) / math.sqrt(q.shape[-1])
    valid = mask.bool()[:, None, None, :].expand_as(s)
    empty = ~valid.any(-1, keepdim=True).expand_as(s)
    s = torch.where(valid, s, torch.where(empty, s - s.detach(),
                                          torch.full_like(s, -math.inf)))
    p = torch.softmax(s, -1)
    if do is None:
        return torch.einsum("bhqk,bkhd->bqhd", p, vd)
    dd = do.to(f64)
    dp = torch.einsum("bqhd,bkhd->bhqk", dd, vd)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) / math.sqrt(q.shape[-1])
    return (torch.einsum("bhqk,bkhd->bqhd", ds, kd),
            torch.einsum("bhqk,bqhd->bkhd", ds, qd),
            torch.einsum("bhqk,bqhd->bkhd", p, dd))


# the kernels of the attention kernels' fp32 pieces routes and of #6, by
# their names in csrc/
PIECES_KERNELS = ("split_pieces", "flash_fwd_pieces", "fused_bwd_rows_pieces",
                  "fused_bwd_keys_pieces")
BLOCK_KERNELS = ("qkv_attend_kernel", "out_proj_kernel")


def pieces_split(fn, names=PIECES_KERNELS) -> dict:
    """``device_split`` of one call of ``fn``: device ms of each kernel in
    ``names`` that it launched (default: the fp32 pieces routes'
    ``split_pieces`` and wgmma kernels)."""
    split = device_split(fn)["top_kernels_ms"]
    return {n: sum(ms for k, ms in split.items() if n in k) for n in names
            if any(n in k for k in split)}


def exact_in_rows(q, k, v, mask, do=None, rows=8) -> tuple:
    """``exact_attention`` ``rows`` batch rows at a time: (out,) or (dq,
    dk, dv), fp64."""
    import torch
    parts = [exact_attention(q[b0:b0 + rows], k[b0:b0 + rows],
                             v[b0:b0 + rows], mask[b0:b0 + rows],
                             None if do is None else do[b0:b0 + rows])
             for b0 in range(0, q.shape[0], rows)]
    if do is None:
        return (torch.cat(parts),)
    return tuple(torch.cat(x) for x in zip(*parts))


# The fp32 backward's yardstick. The CUDA-core kernels sum in the plain
# version's own order (cuBLAS's), and are held to its fp32 evaluation.
# The pieces route sums in another order, so it is held to the function
# evaluated in fp64 (exact_attention): on a row of 1-6 valid keys the fp32
# plain version's 256- to 512-deep sums are themselves 1.5e-5 to 4.3e-5
# from it (seen on an H100), beyond the 1e-5 tolerance, where the pieces
# kernels stay within 3e-6 of it.
FP32_BACKWARD_YARDSTICK = {"fused_bwd_pieces": "fp64 function",
                           "fused_bwd_f32": "fp32 plain version"}


def exact_errors(got, plain, exact, mask) -> dict:
    """The kernel's output (or gradients) and the plain version's against
    the fp64 ``exact`` (tuples): max |kernel - exact|, max |plain - exact|,
    max |kernel - plain| and where it is (that element's batch row, its
    valid keys, |plain| and both errors against exact there)."""
    import torch
    if not isinstance(got, tuple):
        got, plain = (got,), (plain,)
    out = {"kernel_vs_exact": 0.0, "plain_vs_exact": 0.0}
    worst = (-1.0, None)
    for g, w, x in zip(got, plain, exact):
        g, w = g.double(), w.double()
        out["kernel_vs_exact"] = max(out["kernel_vs_exact"],
                                     (g - x).abs().max().item())
        out["plain_vs_exact"] = max(out["plain_vs_exact"],
                                    (w - x).abs().max().item())
        d = (g - w).abs()
        i = int(d.argmax())
        if d.flatten()[i].item() > worst[0]:
            at = tuple(int(j) for j in torch.unravel_index(
                torch.tensor(i), d.shape))
            worst = (d.flatten()[i].item(), {
                "row": at[0], "valid_keys": int(mask[at[0]].sum()),
                "abs_plain": abs(w[at].item()),
                "kernel_vs_exact": abs((g - x)[at].item()),
                "plain_vs_exact": abs((w - x)[at].item())})
    out["kernel_vs_plain"] = worst[0]
    out["at_worst"] = worst[1]
    return out


def phase_attention():
    """Each attention kernel against its plain version at the MaxP shapes
    (H = 12, D = 64), each on the route its wrapper names, both timed;
    then, for bf16 and fp32 at S = 128 to 2048, the fused and flash
    kernels beside the einsum paths ``auto`` takes below S = 256, timed in
    turns, to re-choose the crossovers per dtype."""
    import torch
    from ance_tpu_torch.utils.timing import (clocks_text, cuda_ms,
                                             timed_in_turns)
    import torch.nn.functional as F
    from ance_tpu_torch.ops.attention import mask_to_bias, multi_head_attention
    from ance_tpu_torch.ops.flash_attention import (flash_attention,
                                                    flash_attention_reference,
                                                    flash_kernel_for)
    from ance_tpu_torch.ops.fused_attention import (fused_attention,
                                                    fused_attention_reference,
                                                    fused_kernel_for)

    pairs = {"fused_attention": (fused_attention, fused_attention_reference),
             "flash_attention": (flash_attention, flash_attention_reference)}
    bf16, f32 = torch.bfloat16, torch.float32
    shapes = [("fused_attention", bf16, 128, 512),   # one MaxP encode batch
              ("fused_attention", bf16, 128, 512, "qkv.chunk"),  # its views
              ("fused_attention", bf16, 128, 256),
              ("fused_attention", bf16, 128, 300),
              ("fused_attention", bf16, 32, 1024),
              ("fused_attention", f32, 32, 512),  # fp32 pieces
              ("fused_attention", f32, 32, 512, "qkv.chunk"),
              ("fused_attention", f32, 8, 512, "misaligned"),  # CUDA cores
              ("flash_attention", bf16, 128, 512),
              ("flash_attention", f32, 128, 512),  # fp32 pieces
              ("flash_attention", bf16, 8, 2048),
              ("flash_attention", f32, 8, 2048),
              ("flash_attention", f32, 8, 2048, "qkv.chunk"),
              ("flash_attention", f32, 4, 2100),  # past fused's MAX_SEQ
              ("flash_attention", f32, 8, 512, "misaligned")]  # CUDA cores
    cases = []
    for i, (name, dtype, B, S, *layout) in enumerate(shapes):
        kernel, plain = pairs[name]
        layout = layout[0] if layout else "contiguous"
        strided = layout == "qkv.chunk"
        q, k, v, mask = _attention_inputs(B, S, dtype, seed=i, strided=strided,
                                          misaligned=layout == "misaligned")
        route = (fused_kernel_for if name == "fused_attention"
                 else flash_kernel_for)(q, k, v)
        before = kernel.kernel_launches[route]
        got = kernel(q, k, v, mask)
        want = plain(q, k, v, mask).float()
        torch.cuda.synchronize()
        check(kernel.kernel_launches[route] == before + 1,
              f"{name} {dtype} B={B} S={S} {layout}: {route} did not launch")
        exact = split = None
        pieces = route == "flash_fwd_pieces"
        if pieces:  # both against the function in fp64
            exact = exact_errors(got, want, exact_in_rows(
                q, k, v, mask, rows=max(1, 8 * 512 // S)), mask)
            split = pieces_split(lambda: kernel(q, k, v, mask))
        check(got.shape == q.shape and got.dtype == dtype
              and bool(torch.isfinite(got).all()),
              f"{name} {dtype} B={B} S={S}: output not finite {tuple(q.shape)}")
        # fp32: the two sum in other orders and exp differs by an ulp or
        # two; bf16: either can round a value (fused: a probability) to
        # the neighbouring bf16, held per (row, head) slice
        if dtype == f32:
            err, tol, ulps = (got - want).abs().max().item(), 1e-4, None
            check(err <= tol, f"{name} fp32 B={B} S={S}: max |kernel - "
                  f"plain| {err} > {tol}")
        else:
            n_bad, err, ulps = bf16_slice_excess(got, want)
            tol = BF16_SLICE_TOL
            check(n_bad == 0, f"{name} bf16 B={B} S={S}: {n_bad} elements "
                  f"beyond {tol} (worst {ulps} slice ulps)")
        del got, want
        # the library call that computes the same function: SDPA with the
        # additive bias; for flash on fp32 operands (its q, k, v and p are
        # fp32), the output cast back to the input dtype
        # (SDPA's kernels take no rows off alignment: those get copies)
        lib_dtype = f32 if name == "flash_attention" else dtype
        qt, kt, vt = (t.transpose(1, 2).to(lib_dtype) for t in (q, k, v))
        if layout == "misaligned":
            qt, kt, vt = (t.contiguous() for t in (qt, kt, vt))
        bias4 = mask_to_bias(mask, lib_dtype)
        plain_ms = cuda_ms(lambda: plain(q, k, v, mask))
        times, sampled = timed_in_turns({
            "ms": lambda: kernel(q, k, v, mask),
            "library_ms": lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=bias4).to(dtype)})
        ms, library_ms = times["ms"], times["library_ms"]
        dt = "bf16" if dtype == bf16 else "f32"
        # q, k, v in and out once, the int64 mask; the operations, the
        # least any implementation of the function needs: fused, q.k and
        # p.v at 2·S²·D a head each, in the input type; flash on fp32
        # operands, the same in fp32 (k, v and p are fp32 in its
        # function); flash on bf16 operands, q.k as bf16 products (the
        # scale 1/8 is exact, so are bf16 × bf16 products in fp32) and
        # p.v with a 24-bit p as three bf16 passes (p = p1 + p2 + p3
        # exactly, two pieces would carry 16 bits): 2·S²·D + 3·2·S²·D a
        # head at the bf16 rate
        # The fp32 pieces route runs each product as the six bf16 piece
        # products of block-max's f32 x f32 route: its bound is those at
        # the bf16 rate, the fp32-rate bound beside it.
        flash_bf16 = name == "flash_attention" and dtype == bf16
        io_bytes = 4 * q.numel() * q.element_size() + mask.numel() * 8
        ops = (8.0 if flash_bf16 else 4.0) * B * 12 * S * S * 64
        fp32_rate_ms = None
        if pieces:
            fp32_rate_ms = bound(io_bytes, ops, "f32")[0]
            b_ms, b_by = bound(io_bytes, FP32_PIECE_PRODUCTS["f32xf32"] * ops, "bf16")
        else:
            b_ms, b_by = bound(io_bytes, ops,
                               "bf16" if dtype == bf16 else "f32")
        cases.append({"name": name, "dtype": dt, "B": B, "S": S, "H": 12,
                      "D": 64, "strided": strided, "layout": layout,
                      "kernel": route, "max_abs_err": err, "tolerance": tol,
                      "err_slice_ulps": ulps, "exact": exact,
                      "device_split_ms": split, "ms": ms,
                      "plain_ms": plain_ms, "library_ms": library_ms,
                      "bound_ms": b_ms, "bound_by": b_by,
                      "fp32_rate_bound_ms": fp32_rate_ms, "clocks": sampled})
        print(f"{name} {dt:4s} B={B:3d} S={S:4d}"
              f"{'' if layout == 'contiguous' else ' ' + layout}"
              f" ({route}): max|err| {err:.3g} "
              f"({'fp32 tol 1e-4' if ulps is None else f'{ulps:.3g} slice ulps'})"
              + (f", vs fp64 exact: kernel {exact['kernel_vs_exact']:.3g} "
                 f"plain {exact['plain_vs_exact']:.3g}" if exact else "")
              + f"  kernel {ms:.3f} ms"
              + (f" {({n: round(t, 4) for n, t in split.items()})}"
                 if split else "")
              + f"  plain {plain_ms:.3f} ms"
              f"  sdpa{' fp32' if lib_dtype != dtype else ''} {library_ms:.3f} ms"
              f"  bound {b_ms:.3f} ms ({b_by})"
              + (f", fp32 rate {fp32_rate_ms:.3f} ms" if fp32_rate_ms else "")
              + f"  {clocks_text(sampled)}", flush=True)
        del q, k, v, mask
        torch.cuda.empty_cache()

    # the crossover series: at each S, every path ``auto`` could take for
    # that dtype, timed in turns (B·S = 65,536 tokens to S = 512, then
    # 32 and 8 batch rows): the data to re-choose the thresholds per dtype
    crossover = []
    for dtype, impls in ((bf16, ("xla_bf16", "xla", "fused", "flash")),
                         (f32, ("xla", "fused", "flash"))):
        dt = "bf16" if dtype == bf16 else "f32"
        for S, B in ((128, 128), (256, 128), (512, 128), (1024, 32),
                     (2048, 8)):
            q, k, v, mask = _attention_inputs(B, S, dtype, seed=S)
            times, sampled = timed_in_turns({
                f"{impl}_ms": (lambda impl=impl: multi_head_attention(
                    q, k, v, mask, impl=impl)) for impl in impls})
            crossover.append({"dtype": dt, "S": S, "B": B, **times,
                              "clocks": sampled})
            print(f"crossover {dt} B={B} S={S}: "
                  + ", ".join(f"{impl} {times[f'{impl}_ms']:.3f} ms"
                              for impl in impls)
                  + f"  {clocks_text(sampled)}", flush=True)
            del q, k, v, mask
            torch.cuda.empty_cache()
    return cases, crossover


def phase_attention_backward():
    """Kernel #3 (the fused backward) against its plain version at the MaxP
    training shape (64 chunk rows of S = 512, H = 12, D = 64; row 0 all
    padding, the rest ragged; also as ``qkv.chunk`` views) and at S = 256,
    1024 and a ragged 300 and 65, bf16 and fp32, each call bit-equal to a
    second one, timed in turns with the backward of SDPA with the same
    additive bias; then the autograd ``Function`` (forward and backward
    kernels) against autograd through the plain forward."""
    import torch
    from ance_tpu_torch.utils.timing import (clocks_text, cuda_ms,
                                             timed_in_turns)
    import torch.nn.functional as F
    from ance_tpu_torch.ops.attention import mask_to_bias
    from ance_tpu_torch.ops.fused_attention import (
        fused_attention, fused_attention_backward,
        fused_attention_backward_reference, fused_attention_reference,
        fused_kernel_for)

    torch.manual_seed(0)  # the output gradients
    bf16, f32 = torch.bfloat16, torch.float32
    shapes = [(bf16, 64, 512), (bf16, 64, 512, "qkv.chunk"), (bf16, 64, 256),
              (bf16, 16, 1024), (bf16, 16, 300), (bf16, 16, 65),
              (f32, 64, 512), (f32, 64, 512, "qkv.chunk"), (f32, 64, 256),
              (f32, 16, 1024), (f32, 16, 300), (f32, 16, 65),
              (f32, 16, 512, "misaligned")]  # the CUDA-core pair
    cases = []
    for i, (dtype, B, S, *layout) in enumerate(shapes):
        layout = layout[0] if layout else "contiguous"
        strided = layout == "qkv.chunk"
        q, k, v, mask = _attention_inputs(B, S, dtype, seed=100 + i,
                                          strided=strided,
                                          misaligned=layout == "misaligned")
        do = torch.randn_like(q, dtype=f32).to(dtype)
        route = fused_kernel_for(q, k, v, backward=True)
        before = fused_attention_backward.kernel_launches[route]
        got = fused_attention_backward(q, k, v, mask, do)
        again = fused_attention_backward(q, k, v, mask, do)
        want = fused_attention_backward_reference(q, k, v, mask, do)
        torch.cuda.synchronize()
        check(fused_attention_backward.kernel_launches[route] == before + 2,
              f"backward {dtype} B={B} S={S} {layout}: {route} did not "
              "launch")
        exact, yard, split = None, want, None
        if route == "fused_bwd_pieces":  # both against the function in fp64
            yard = exact_in_rows(q, k, v, mask, do, rows=max(1, 4096 // S))
            exact = exact_errors(got, want, yard, mask)
            split = pieces_split(
                lambda: fused_attention_backward(q, k, v, mask, do))
        # no atomics: a second call gives the same bits
        deterministic = all(torch.equal(a, b) for a, b in zip(got, again))
        check(deterministic, f"backward {dtype} B={B} S={S}: two calls differ")
        del again
        err, ulps = 0.0, 0.0
        tol = 1e-5 if dtype == f32 else BF16_SLICE_TOL
        for name, g, w in zip(("dq", "dk", "dv"), got, yard):
            check(g.shape == q.shape and g.dtype == dtype
                  and bool(torch.isfinite(g).all()),
                  f"backward {name} {dtype} B={B} S={S}: not finite")
            # fp32: sums in other orders (FP32_BACKWARD_YARDSTICK); bf16:
            # a p or ds one rounding step apart, held per (row, head) slice
            if dtype == f32:
                e = (g.double() - w.double()).abs().max().item()
                check(e <= tol, f"backward {name} fp32 B={B} S={S} {layout}:"
                      f" max |kernel - {FP32_BACKWARD_YARDSTICK[route]}| "
                      f"{e} > {tol}")
            else:
                n_bad, e, u = bf16_slice_excess(g, w)
                check(n_bad == 0, f"backward {name} bf16 B={B} S={S}: "
                      f"{n_bad} elements beyond {tol} (worst {u} slice ulps)")
                ulps = max(ulps, u)
            err = max(err, e)
        control = None
        if dtype == bf16 and (B, S) == (64, 512) and not strided:
            # the bound's power: copies of dk and dv with their longest row
            # zeroed, or off by 10%, must fail it; beside each, whether a
            # bound from the whole gradient's largest value (2 ulps of it)
            # would pass the copy
            row = int(mask.sum(1).argmax())
            control = {"row": row, "row_len": int(mask[row].sum())}
            for name, g, w in (("dk", got[1], want[1]), ("dv", got[2], want[2])):
                whole = 2 * _bf16_ulp(w.float().abs().max()).item()
                for damage, factor in (("zeroed", 0.0), ("x0.9", 0.9)):
                    broken = g.clone()
                    broken[row] *= factor
                    n_bad, e, _ = bf16_slice_excess(broken, w)
                    check(n_bad > 0, f"control: {name} with row {row} "
                          f"{damage} passes the bound")
                    control[f"{name} {damage}"] = {
                        "elements_beyond": n_bad, "max_abs_err": e,
                        "whole_tensor_bound": whole,
                        "whole_tensor_bound_passes": e <= whole}
                    print(f"control: {name} with row {row} ({control['row_len']}"
                          f" keys) {damage}: {n_bad} elements beyond the "
                          f"bound, max |err| {e:.3g}; the whole-tensor bound "
                          f"{whole:.3g} would {'pass' if e <= whole else 'fail'}"
                          " it", flush=True)
        del got, want, yard
        # (SDPA takes no rows off alignment: those get copies)
        leaves = [(t.transpose(1, 2).contiguous() if layout == "misaligned"
                   else t.transpose(1, 2)).detach().requires_grad_()
                  for t in (q, k, v)]
        out = F.scaled_dot_product_attention(
            *leaves, attn_mask=mask_to_bias(mask, dtype))
        grad_out = do.transpose(1, 2)
        plain_ms = cuda_ms(
            lambda: fused_attention_backward_reference(q, k, v, mask, do))
        times, sampled = timed_in_turns({
            "ms": lambda: fused_attention_backward(q, k, v, mask, do),
            "library_ms": lambda: torch.autograd.grad(
                out, leaves, grad_out, retain_graph=True)})
        ms, library_ms = times["ms"], times["library_ms"]
        del out, leaves
        # q, k, v, do in and dq, dk, dv out once, the int64 mask; the
        # recomputed s and the four gradient products: 10·S²·D a head (on
        # the pieces route six bf16 piece products each, the fp32-rate
        # bound beside)
        io_bytes = 7 * q.numel() * q.element_size() + mask.numel() * 8
        ops = 10.0 * B * 12 * S * S * 64
        fp32_rate_ms = None
        if route == "fused_bwd_pieces":
            fp32_rate_ms = bound(io_bytes, ops, "f32")[0]
            b_ms, b_by = bound(io_bytes, FP32_PIECE_PRODUCTS["f32xf32"] * ops, "bf16")
        else:
            b_ms, b_by = bound(io_bytes, ops,
                               "bf16" if dtype == bf16 else "f32")
        dt = "bf16" if dtype == bf16 else "f32"
        cases.append({"dtype": dt, "B": B, "S": S, "H": 12, "D": 64,
                      "strided": strided, "layout": layout, "kernel": route,
                      "yardstick": (FP32_BACKWARD_YARDSTICK[route]
                                    if dtype == f32 else "bf16 plain"),
                      "deterministic": deterministic,
                      "max_abs_err": err, "tolerance": tol,
                      "err_slice_ulps": ulps if dtype == bf16 else None,
                      "exact": exact, "device_split_ms": split,
                      "control": control, "ms": ms,
                      "plain_ms": plain_ms, "library_ms": library_ms,
                      "bound_ms": b_ms, "bound_by": b_by,
                      "fp32_rate_bound_ms": fp32_rate_ms, "clocks": sampled})
        print(f"fused backward {dt:4s} B={B:3d} S={S:4d}"
              f"{'' if layout == 'contiguous' else ' ' + layout} ({route}):"
              f" max|err| {err:.3g}"
              f" ({f'{ulps:.3g} slice ulps' if dtype == bf16 else 'tol 1e-5 against the ' + FP32_BACKWARD_YARDSTICK[route]})"
              + (f", vs fp64 exact: kernel {exact['kernel_vs_exact']:.3g} "
                 f"plain {exact['plain_vs_exact']:.3g}; kernel - fp32 plain "
                 f"{exact['kernel_vs_plain']:.3g} (there: "
                 f"{exact['at_worst']})" if exact else "")
              + f"  kernel {ms:.3f} ms"
              + (f" {({n: round(t, 4) for n, t in split.items()})}"
                 if split else "")
              + f"  plain {plain_ms:.3f} ms"
              f"  sdpa backward {library_ms:.3f} ms  bound {b_ms:.3f} ms "
              f"({b_by})"
              + (f", fp32 rate {fp32_rate_ms:.3f} ms" if fp32_rate_ms else "")
              + f"  {clocks_text(sampled)}", flush=True)
        del q, k, v, mask, do
        torch.cuda.empty_cache()

    # the Function: kernel forward + kernel backward through autograd
    functions = []
    for dtype in (f32, bf16):
        q, k, v, mask = _attention_inputs(64, 512, dtype, seed=200)
        do = torch.randn_like(q, dtype=f32).to(dtype)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        f0, b0 = fused_attention.launches, fused_attention_backward.launches
        got = torch.autograd.grad(fused_attention(*leaves, mask), leaves, do)
        check((fused_attention.launches, fused_attention_backward.launches)
              == (f0 + 1, b0 + 1), "the Function did not launch both kernels")
        want = torch.autograd.grad(fused_attention_reference(*leaves, mask),
                                   leaves, do)
        plain_errs = None
        if dtype == f32:
            # the pieces route's yardstick (FP32_BACKWARD_YARDSTICK):
            # autograd through the function in fp64; beside it, the error
            # against autograd through the fp32 plain forward
            plain_errs = [(g.double() - w.double()).abs().max().item()
                          for g, w in zip(got, want)]
            leaves64 = [t.detach().double().requires_grad_()
                        for t in (q, k, v)]
            want = torch.autograd.grad(exact_attention(*leaves64, mask),
                                       leaves64, do.double())
            del leaves64
        torch.cuda.synchronize()
        errs = [(g.double() - w.double()).abs().max().item()
                for g, w in zip(got, want)]
        rel = max(slice_rel_err(g, w) for g, w in zip(got, want))
        # fp32: the kernel's delta = rowsum(dp ⊙ p) against autograd's
        # softmax backward, same function; bf16: autograd's chain rounds dp
        # to bf16 (2^-9 relative) where the kernel keeps it fp32 and rounds
        # ds, so each (row, head) slice within 1e-2 of its norm
        if dtype == f32:
            check(max(errs) <= 1e-5, f"Function fp32 grads differ from "
                  f"autograd through the fp64 function by {errs}")
        else:
            check(rel <= 1e-2, f"Function bf16 grads: a (row, head) slice "
                  f"off by {rel} of its norm")
        functions.append({"dtype": "bf16" if dtype == bf16 else "f32",
                          "yardstick": ("autograd through the fp64 function"
                                        if dtype == f32 else
                                        "autograd through the plain forward"),
                          "max_abs_err": max(errs),
                          "max_abs_err_vs_fp32_plain_autograd": (
                              max(plain_errs) if plain_errs else None),
                          "max_slice_rel_err": rel})
        print(f"fused Function {functions[-1]['dtype']:4s} B=64 S=512: "
              f"grads vs {functions[-1]['yardstick']}: max|err| "
              f"{max(errs):.3g}"
              + (f" (vs the fp32 plain forward's: {max(plain_errs):.3g})"
                 if plain_errs else "")
              + f", worst (row, head) slice {rel:.3g} of its norm",
              flush=True)
        del q, k, v, mask, do, leaves, got, want
        torch.cuda.empty_cache()
    return cases, functions


def _write_cache(path: Path, n: int, seq: int, min_len: int, rs) -> None:
    """n random RoBERTa token rows (<s>, then ids, pad id 1 past a random
    length in [min_len, seq])."""
    import numpy as np
    from ance_tpu_torch.data.cache import TokenCacheWriter
    lengths = rs.randint(min_len, seq + 1, n)
    tokens = rs.randint(3, 50265, (n, seq)).astype(np.int32)
    tokens[:, 0] = 0                                         # <s>
    tokens[np.arange(seq)[None, :] >= lengths[:, None]] = 1  # pad
    with TokenCacheWriter(str(path), seq) as w:
        for length, row in zip(lengths, tokens):
            w.write(int(length), row)


def _write_caches(data: Path, seed: int = 0) -> None:
    import numpy as np
    rs = np.random.RandomState(seed)
    for name, n, seq in (("passages", N_PASSAGES, PASSAGE_LEN),
                         ("dev-query", N_QUERIES, QUERY_LEN)):
        _write_cache(data / name, n, seq, 8, rs)


def _post(addr, path, payload):
    req = urllib.request.Request(
        f"http://{addr[0]}:{addr[1]}{path}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        return json.loads(resp.read())


def _get(addr, path):
    with urllib.request.urlopen(f"http://{addr[0]}:{addr[1]}{path}",
                                timeout=60) as resp:
        return json.loads(resp.read())


def phase_serve(work: Path):
    """RoBERTa-base, full width, seeded weights saved as an HF-layout
    directory; the serve CLI in a subprocess, then the HTTP server."""
    import numpy as np
    import torch
    from ance_tpu_torch.data.cache import TokenCache
    from ance_tpu_torch.index.flat import FlatIPIndex
    from ance_tpu_torch.models.dot_models import RobertaDot
    from ance_tpu_torch.models.registry import get_model_spec
    from ance_tpu_torch.models.weights import load_pretrained
    from ance_tpu_torch.ops.topk import blockmax_scores
    from ance_tpu_torch.serve import Retriever
    from ance_tpu_torch.serve_http import RetrieverHTTPServer
    from ance_tpu_torch.train.encode import (encode_cache_to_device,
                                             iter_cache_batches,
                                             make_encode_fn)

    dev = torch.device("cuda")
    spec = get_model_spec("rdot_nll")
    weights = work / "roberta_base_seeded"
    weights.mkdir()
    model = spec.build(seed=0)  # EncoderConfig() defaults: RoBERTa-base
    cfg = model.config
    check((cfg.num_layers, cfg.hidden_size, cfg.num_heads,
           cfg.intermediate_size, cfg.vocab_size) ==
          (12, 768, 12, 3072, 50265), "not RoBERTa-base geometry")
    torch.save(model.state_dict(), weights / "pytorch_model.bin")
    del model
    data = work / "data"
    data.mkdir()
    _write_caches(data)

    # 1. the serve CLI, as a user runs it
    ranking, saved = work / "ranking.tsv", work / "index"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "ance_tpu_torch.cli", "serve", "--bf16",
         "--model_name_or_path", str(weights), "--data_dir", str(data),
         "--query_cache", str(data / "dev-query"), "--topk", "10",
         "--max_seq_length", str(PASSAGE_LEN),
         "--max_query_length", str(QUERY_LEN),
         "--output", str(ranking), "--save_index", str(saved)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    cli_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"serve CLI failed:\n{proc.stderr[-4000:]}")
    lines = ranking.read_text().splitlines()
    check(len(lines) == N_QUERIES * 10,
          f"serve CLI wrote {len(lines)} ranking lines, not "
          f"{N_QUERIES * 10}")
    ranks = [int(line.split("\t")[2]) for line in lines]
    check(ranks == list(range(1, 11)) * N_QUERIES, "ranks are not 1..10")
    print(f"serve CLI: {len(lines)} ranking lines in {cli_s:.1f} s "
          f"(build, load, encode {N_PASSAGES} passages, index, rank)",
          flush=True)

    # 2. in process: the same weights, the saved index, the HTTP server
    torch.cuda.reset_peak_memory_stats()
    model = spec.build(dtype=torch.bfloat16)
    load_pretrained(model, str(weights))
    model = model.to(dev)
    encode_q = make_encode_fn(model, RobertaDot.query_emb, dev)
    encode_p = make_encode_fn(model, RobertaDot.body_emb, dev)

    # encode throughput over the passage cache (after one warm-up batch)
    with TokenCache(str(data / "passages")) as pc:
        encode_cache_to_device(encode_p, pc, 128, stop=128)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        emb, _ = encode_cache_to_device(encode_p, pc, 128)
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
    check(emb.shape == (N_PASSAGES, DIM) and bool(torch.isfinite(emb).all()),
          "passage embeddings are not finite [N, 768]")
    norms = emb.float().norm(dim=1)
    print(f"encode: {N_PASSAGES / enc_s:.0f} passages/s at seq {PASSAGE_LEN}, "
          f"batch 128, bf16 (norms {norms.min():.1f}..{norms.max():.1f})",
          flush=True)

    index = FlatIPIndex.load(str(saved), device=dev)
    e2id = np.load(str(saved) + ".ids.npy")
    check(index.ntotal == N_PASSAGES and index.dtype == torch.bfloat16,
          "saved index is not the bf16 32768-row index")
    with TokenCache(str(data / "dev-query")) as qc:
        _, q_ids, q_mask = next(iter_cache_batches(qc, N_QUERIES))

    # bf16 vs fp32 encoder on a small input: same function within bf16
    ref_model = spec.build()
    load_pretrained(ref_model, str(weights))
    ref = make_encode_fn(ref_model.to(dev), RobertaDot.query_emb, dev)(
        q_ids[:8], q_mask[:8])
    got = encode_q(q_ids[:8], q_mask[:8])
    cos = torch.nn.functional.cosine_similarity(got, ref, dim=1)
    check(bool((cos > 0.99).all()), f"bf16 vs fp32 query embeddings: cos "
          f"{cos.min().item():.4f}")
    del ref_model

    retriever = Retriever(encode_q, index, embedding2id=e2id)
    server = RetrieverHTTPServer(retriever, port=0, pid_space="real",
                                 pad_token_id=cfg.pad_token_id).start()
    requests = [(b, k) for b in (1, 64, N_QUERIES) for k in (10, 100)]
    payloads = [{"ids": q_ids[:b].tolist(), "mask": q_mask[:b].tolist(),
                 "k": k} for b, k in requests]
    try:
        addr = server.address
        for payload in payloads:  # first use of each shape: lazy loading
            _post(addr, "/search", payload)
        reset_blockmax_counts()
        answers, latency = [], []
        for payload in payloads:
            times = []
            for _ in range(REPEATS):
                t0 = time.perf_counter()
                body = _post(addr, "/search", payload)
                times.append((time.perf_counter() - t0) * 1000.0)
            answers.append(body)
            latency.append(statistics.median(times))
        launches, by_kernel = blockmax_scores.launches, blockmax_counts()
        health = _get(addr, "/healthz")
        metrics = _get(addr, "/metrics")
    finally:
        server.shutdown()
    n_searches = len(requests) * REPEATS
    check(launches == n_searches and by_kernel == {"blockmax_bf16": launches},
          f"blockmax kernels launched {by_kernel} for {n_searches} searches "
          "of a bf16 index")
    check(health["status"] == "ok" and health["ntotal"] == N_PASSAGES,
          f"/healthz {health}")
    check(metrics["requests"] == n_searches + len(requests) and
          metrics["errors"] == 0, f"/metrics {metrics}")

    # every answer equals a scan search of the same index
    scan = Retriever(encode_q, FlatIPIndex.load(str(saved), device=dev,
                                                method="scan"),
                     embedding2id=e2id)
    for (b, k), body in zip(requests, answers):
        want_s, want_p = scan.search_tokens(q_ids[:b], q_mask[:b], k)
        got = body["results"]
        check(len(got) == b and all(len(r) == k for r in got),
              f"/search b={b} k={k}: result shape")
        check([[e["pid"] for e in r] for r in got] == want_p.tolist(),
              f"/search b={b} k={k}: pids differ from the scan")
        got_s = np.array([[e["score"] for e in r] for r in got])
        check(np.isfinite(got_s).all() and
              np.allclose(got_s, want_s, atol=0, rtol=0),
              f"/search b={b} k={k}: scores differ from the scan")
    check(no_reference_modules(), "the port imported jax or ance_tpu")
    peak = torch.cuda.max_memory_allocated()
    for (b, k), ms in zip(requests, latency):
        print(f"http /search B={b:3d} k={k:3d}: median {ms:.2f} ms of "
              f"{REPEATS}")
    print(f"http: {launches} kernel launches for {n_searches} searches, "
          f"answers == scan; peak device memory {peak / 2**30:.2f} GiB",
          flush=True)
    return {"launches": launches, "blockmax_kernels": by_kernel,
            "encode_passages_per_s": N_PASSAGES / enc_s,
            "latency_ms": {f"B{b}_k{k}": ms
                           for (b, k), ms in zip(requests, latency)},
            "peak_mem_gib": peak / 2**30, "cli_s": cli_s}


# IVF (ROADMAP Queue 1 #10): docs/perf_ivf.py's clustered corpus at full
# width, cut in depth to a quarter million rows (nlist √N = 512)
IVF_ROWS, IVF_CENTRES, IVF_NLIST, IVF_QUERIES = 262_144, 1024, 512, 256
IVF_RECALL_FLOOR = 0.9  # recall@10 at nprobe 8, B = 1 and 16
IVF_SCORE_ATOL = 1e-4  # fp32 IVF scores against fp64, |score| ≲ 1.3
IVF_BF16_RTOL = 1e-3  # bf16 bins' fp32 scores against fp64 of the operands
IVF_REPS = 7
IVF_SERVE_BATCH = 8  # queries a batch where nprobe must matter: 8 x 4 < 181
HNSW_ROWS, HNSW_EF, HNSW_RECALL_FLOOR = 5_000, 256, 0.85


def _ranking(path: Path) -> dict:
    """qid → [(pid, score)] in rank order, from a ``--with_scores`` TSV."""
    out: dict = {}
    for line in path.read_text().splitlines():
        qid, pid, _, score = line.split("\t")
        out.setdefault(int(qid), []).append((int(pid), float(score)))
    return out


def _swaps_within(got: dict, want: dict, slack: float) -> int:
    """Positions where ``got`` ranks another pid than ``want``; raises
    unless every such position is a near-tie: the score of the pid ``got``
    put there (``want``'s where it ranks it, else ``got``'s) within
    ``slack`` of ``want``'s score at that position."""
    check(got.keys() == want.keys(), "rankings cover other queries")
    swaps = 0
    for qid, rows in want.items():
        score_of = dict(got[qid]) | dict(rows)
        for (p_got, _), (p_want, s_want) in zip(got[qid], rows):
            if p_got != p_want:
                swaps += 1
                check(abs(score_of[p_got] - s_want) <= slack,
                      f"query {qid}: {p_got} in place of {p_want} at a "
                      f"score gap past {slack}")
    return swaps


def phase_ivf(work: Path) -> dict:
    """``IVFIPIndex`` on the card over ``experiments/perf_ivf.py``'s
    clustered corpus (262,144 × 768, 1,024 centres, nlist 512, slack 1.3,
    10 k-means iterations; fp32, bf16 and ``dims`` bins): (a) two fp32
    builds from one seed bit-equal; (b) nprobe = nlist on fp32 bins: each
    query's top-10 id set the exact fp32 ``FlatIPIndex``'s (kernel #1),
    each score within IVF_SCORE_ATOL of fp64; (c) bf16 bins give fp32
    scores within IVF_BF16_RTOL of fp64 on the bf16 operands; (d) recall@10
    at nprobe 8 ≥ IVF_RECALL_FLOOR for bf16 and ``dims`` at B = 1 and 16.
    Times at B 1 / 16 / 64 / 256, nprobe 4 / 8, in turns with the exact
    bf16 and ``dims`` indexes; the build split. Then ``serve --index ivf``
    over the FirstP serve phase's 32,768 passages (its index as an
    ``infer``-style dump): at nprobe = nlist it ranks as ``--index flat``;
    a saved ``dims`` artifact served by ``--load_index --nprobe 4`` ranks
    as the index loaded in process; ``POST /reload`` of it answers
    ``"kind": "ivf"`` and then the in-process index's rows. Last the HNSW
    indexer (the port's C++ core, built by g++ here) over 5,000 rows of
    the corpus: recall@10 at ef 256 against the exact search on the card,
    and its inserts/s."""
    import numpy as np
    import torch
    from ance_tpu_torch.data.cache import TokenCache
    from ance_tpu_torch.experiments import perf_ivf as exp
    from ance_tpu_torch.index.flat import FlatIPIndex
    from ance_tpu_torch.index.hnsw import DenseHnswIndexer
    from ance_tpu_torch.index.ivf import IVFIPIndex
    from ance_tpu_torch.models.dot_models import RobertaDot
    from ance_tpu_torch.models.registry import get_model_spec
    from ance_tpu_torch.models.weights import load_pretrained
    from ance_tpu_torch.ops.topk import rescore
    from ance_tpu_torch.serve import Retriever
    from ance_tpu_torch.serve_http import RetrieverHTTPServer
    from ance_tpu_torch.train.encode import (iter_cache_batches,
                                             make_encode_fn)

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    reset_blockmax_counts()
    g = torch.Generator(device=dev).manual_seed(17)
    corpus = exp.make_corpus(IVF_ROWS, DIM, IVF_CENTRES, g, dev)
    queries = exp.make_queries(corpus, IVF_QUERIES, g)
    exact = {}
    for name, dtype, quantize in (("fp32", torch.float32, False),
                                  ("bf16", torch.bfloat16, False),
                                  ("dims", torch.float32, "dims")):
        exact[name] = FlatIPIndex(dim=DIM, device=dev, dtype=dtype,
                                  quantize=quantize)
        exact[name].add_chunked(corpus)
    _, truth = exact["fp32"].search(queries, 10)
    ivf, builds = {}, {}
    for name, dtype, quantize in (("fp32", torch.float32, False),
                                  ("bf16", torch.bfloat16, False),
                                  ("dims", torch.float32, "dims")):
        ivf[name], seconds = exp.build_ivf(corpus, IVF_NLIST, dtype, quantize)
        builds[name] = {"s": seconds, **ivf[name].build_seconds}
        print(f"ivf build {name}: {seconds:.2f} s (" + ", ".join(
            f"{k} {v:.3f}" for k, v in ivf[name].build_seconds.items())
            + f"), capacity {ivf[name].capacity}", flush=True)
    again, _ = exp.build_ivf(corpus, IVF_NLIST, torch.float32, False)
    check(torch.equal(again.centroids, ivf["fp32"].centroids)
          and torch.equal(again._bins_ids, ivf["fp32"]._bins_ids)
          and torch.equal(again._bins_emb, ivf["fp32"]._bins_emb),
          "(a) two fp32 IVF builds from one seed differ")
    del again

    scores, ids = ivf["fp32"].search(queries, 10, nprobe=IVF_NLIST)
    check(all(set(a) == set(b) for a, b in zip(ids.tolist(),
                                                truth.tolist())),
          "(b) nprobe = nlist: top-10 id sets differ from the exact index")
    err_b = (scores - rescore(queries, corpus[ids])).abs().max().item()
    check(err_b <= IVF_SCORE_ATOL, f"(b) fp32 IVF scores {err_b} from fp64")
    scores, ids = ivf["bf16"].search(queries, 10, nprobe=IVF_NLIST)
    want = rescore(queries.to(torch.bfloat16), corpus[ids].to(torch.bfloat16))
    rel_c = ((scores - want).abs() / want.abs()).max().item()
    # a bf16 output would hold only bf16 values; an fp32 one almost none
    bf16_valued = (scores.to(torch.bfloat16).float() == scores).float() \
        .mean().item()
    check(scores.dtype == torch.float32 and rel_c <= IVF_BF16_RTOL,
          f"(c) bf16 bins: scores {scores.dtype}, {rel_c} relative from "
          "fp64 of the bf16 operands")
    print(f"ivf checks: (a) builds bit-equal; (b) nprobe {IVF_NLIST} ids == "
          f"exact fp32, max |score - fp64| {err_b:.3e}; (c) bf16 bins fp32 "
          f"scores, max rel {rel_c:.3e}, bf16-valued share {bf16_valued:.4f}",
          flush=True)

    rows = exp.sweep({"bf16": exact["bf16"], "dims": exact["dims"]},
                     {"bf16": ivf["bf16"], "dims": ivf["dims"]}, queries,
                     truth, reps=IVF_REPS)
    for row in rows:
        print(f"ivf B={row['batch']:3d} nprobe {row['nprobe']} union "
              f"{row['union']:3d}: exact bf16 {row['exact_bf16_ms']:.3f} ms, "
              f"dims {row['exact_dims_ms']:.3f}; " + "; ".join(
                  f"ivf {n} {row[f'ivf_{n}_ms']:.3f} ms "
                  f"({row[f'ivf_{n}_qps']:.0f} qps, "
                  f"{row[f'ivf_{n}_speedup_vs_exact_bf16']:.2f}x exact bf16;"
                  f" enqueue {row[f'ivf_{n}_enqueue_ms']:.3f}, wall "
                  f"{row[f'ivf_{n}_wall_ms']:.3f}) recall@10 "
                  f"{row[f'ivf_{n}_recall_at_10']:.4f}"
                  for n in ("bf16", "dims")), flush=True)
        if row["nprobe"] == 8 and row["batch"] in (1, 16):
            for n in ("bf16", "dims"):
                check(row[f"ivf_{n}_recall_at_10"] >= IVF_RECALL_FLOOR,
                      f"(d) {n} B={row['batch']} recall@10 "
                      f"{row[f'ivf_{n}_recall_at_10']}")
    in_process = blockmax_counts()

    # HNSW on the host over the corpus's first rows
    hnsw_rows = corpus[:HNSW_ROWS].cpu().numpy()
    hnsw_q = exp.make_queries(corpus[:HNSW_ROWS], IVF_QUERIES, g)
    hnsw_exact = FlatIPIndex(dim=DIM, device=dev)
    hnsw_exact.add(corpus[:HNSW_ROWS])
    _, hnsw_truth = hnsw_exact.search(hnsw_q, 10)
    indexer = DenseHnswIndexer(DIM, ef_search=HNSW_EF)
    t0 = time.perf_counter()
    indexer.index_data(np.arange(HNSW_ROWS), hnsw_rows)
    hnsw_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    found = indexer.search_knn(hnsw_q.cpu().numpy(), 10)
    hnsw_qps = IVF_QUERIES / (time.perf_counter() - t0)
    hnsw_recall = float(np.mean([len(set(got) & set(want)) / 10 for
                                 (got, _), want in zip(found,
                                                       hnsw_truth.tolist())]))
    check(hnsw_recall >= HNSW_RECALL_FLOOR,
          f"HNSW recall@10 {hnsw_recall} at ef {HNSW_EF}")
    print(f"hnsw: {HNSW_ROWS} rows x {DIM + 1} in {hnsw_build:.2f} s "
          f"({HNSW_ROWS / hnsw_build:.0f} inserts/s, one host thread); "
          f"ef {HNSW_EF}: recall@10 {hnsw_recall:.4f} against the exact "
          f"index on the card, {hnsw_qps:.0f} qps", flush=True)
    del corpus, queries, exact, ivf, hnsw_exact
    torch.cuda.empty_cache()

    # serve --index ivf over the FirstP serve phase's passages
    weights, data, saved = work / "roberta_base_seeded", work / "data", \
        work / "index"
    flat = FlatIPIndex.load(str(saved), device=dev)
    e2id = np.load(str(saved) + ".ids.npy")
    dump = work / "ivf_dump"
    dump.mkdir()
    np.save(dump / "emb_data_obj_0.npy",
            flat._emb[:flat.ntotal].float().cpu().numpy())
    np.save(dump / "embid_data_obj_0.npy", e2id)
    nlist = int(round(N_PASSAGES ** 0.5))
    base = ["serve", "--bf16", "--model_name_or_path", str(weights),
            "--emb_prefix", str(dump / "emb"),
            "--emb_id_prefix", str(dump / "embid"),
            "--query_cache", str(data / "dev-query"), "--topk", "10",
            "--max_query_length", str(QUERY_LEN), "--with_scores"]
    t0 = time.perf_counter()
    _cli(base + ["--output", str(work / "flat.tsv")])
    _cli(base + ["--index", "ivf", "--nlist", str(nlist), "--nprobe",
                 str(nlist), "--output", str(work / "ivf_all.tsv")])
    artifact = work / "ivf_dims"
    _cli(base + ["--index", "ivf", "--quantize", "dims", "--save_index",
                 str(artifact), "--output", str(work / "ivf_dims.tsv")])
    _cli(base[:base.index("--emb_prefix")] + base[base.index(
        "--query_cache"):] + ["--load_index", str(artifact), "--index", "ivf",
                              "--nprobe", "4", "--per_device_eval_batch_size",
                              str(IVF_SERVE_BATCH), "--output",
                              str(work / "ivf_load.tsv")])
    cli_s = time.perf_counter() - t0
    flat_rank, ivf_rank = (_ranking(work / f"{n}.tsv")
                           for n in ("flat", "ivf_all"))
    top = max(abs(s) for rows_ in flat_rank.values() for _, s in rows_)
    # the worst fp32 rounding of a 768-term sum at this magnitude
    swaps = _swaps_within(ivf_rank, flat_rank, DIM * 2.0 ** -24 * top)
    check(len(flat_rank) == N_QUERIES, "serve wrote too few queries")
    dims_rank = _ranking(work / "ivf_dims.tsv")
    dims_recall = float(np.mean([len({p for p, _ in dims_rank[q]}
                               & {p for p, _ in rows_}) / 10
                           for q, rows_ in flat_rank.items()]))
    print(f"serve --index ivf --nlist {nlist} --nprobe {nlist}: ranks as "
          f"--index flat ({swaps} near-tie swaps of "
          f"{N_QUERIES * 10} positions); --quantize dims --nprobe 8: "
          f"recall@10 {dims_recall:.4f} against flat (the seeded encoder's "
          "passages are not clustered)", flush=True)

    spec = get_model_spec("rdot_nll")
    model = spec.build(dtype=torch.bfloat16)
    load_pretrained(model, str(weights))
    encode_q = make_encode_fn(model.to(dev), RobertaDot.query_emb, dev)
    with TokenCache(str(data / "dev-query")) as qc:
        batches = list(iter_cache_batches(qc, IVF_SERVE_BATCH))
    loaded = IVFIPIndex.load(str(artifact), device=dev, nprobe=4)
    check(loaded.quantize == "dims" and loaded.nlist == nlist,
          "the saved artifact is not the dims IVF index")
    got = _ranking(work / "ivf_load.tsv")
    retriever = Retriever(encode_q, loaded,
                          embedding2id=np.load(str(artifact) + ".ids.npy"))
    for keys, q_ids, q_mask in batches:
        s, p = retriever.search_tokens(q_ids[:len(keys)], q_mask[:len(keys)],
                                       10)
        for key, ps, ss in zip(keys, p.tolist(), s.tolist()):
            check([pid for pid, _ in got[int(key)]] == ps,
                  f"--load_index --nprobe 4: query {key} ranks otherwise "
                  "than the index loaded in process")
    keys, q_ids, q_mask = batches[0]
    q_ids, q_mask = q_ids[:len(keys)], q_mask[:len(keys)]
    server = RetrieverHTTPServer(Retriever(encode_q, flat, embedding2id=e2id),
                                 port=0, pad_token_id=model.config.pad_token_id,
                                 allow_reload=True).start()
    try:
        rep = _post(server.address, "/reload",
                    {"index": str(artifact) + ".npz"})
        body = _post(server.address, "/search", {
            "ids": q_ids.tolist(), "mask": q_mask.tolist(), "k": 10})
    finally:
        server.shutdown()
    check(rep.get("kind") == "ivf" and rep.get("ntotal") == N_PASSAGES,
          f"/reload of the IVF artifact answered {rep}")
    want_s, want_p = Retriever(
        encode_q, IVFIPIndex.load(str(artifact), device=dev),
        embedding2id=e2id).search_tokens(q_ids, q_mask, 10)
    check([[e["pid"] for e in r] for r in body["results"]]
          == want_p.tolist(), "/search after the IVF /reload: rows differ "
          "from the artifact's index in process")
    check(no_reference_modules(), "the port imported jax or ance_tpu")
    launches = blockmax_counts()
    phase_s = time.perf_counter() - t_phase
    print(f"ivf serve: flat, ivf at nprobe = nlist, dims --save_index, "
          f"--load_index --nprobe 4 in {cli_s:.1f} s; /reload kind ivf, "
          f"/search == in process; kernel #1 launches {launches}; phase "
          f"{phase_s:.1f} s", flush=True)
    del model, flat, loaded
    torch.cuda.empty_cache()
    return {"builds": builds, "err_b": err_b, "bf16_rel_err": rel_c,
            "bf16_valued_share": bf16_valued, "sweep": rows,
            "hnsw": {"rows": HNSW_ROWS, "dim": DIM + 1,
                     "build_s": hnsw_build,
                     "inserts_per_s": HNSW_ROWS / hnsw_build,
                     "ef": HNSW_EF, "recall_at_10": hnsw_recall,
                     "qps": hnsw_qps},
            "serve_swaps": swaps, "serve_dims_recall": dims_recall,
            "cli_s": cli_s,
            "blockmax_kernels_in_process": in_process,
            "blockmax_kernels": launches, "seconds": phase_s}


def _cosines(a, b):
    import torch
    return torch.nn.functional.cosine_similarity(
        a.float().reshape(-1, a.shape[-1]), b.float().reshape(-1, b.shape[-1]),
        dim=1)


def phase_maxp(work: Path):
    """MaxP document serving: the FirstP phase's seeded RoBERTa-base
    weights as ``rdot_nll_multi_chunk`` over N_DOCS documents of DOC_LEN
    tokens (lengths 64..DOC_LEN, so many chunks are all padding). The serve
    CLI in a subprocess; in process, the corpus encode through the fused
    kernel (launch count, rate), a slice through the flash kernel, the
    plain path and fp32, then the HTTP server against a scan."""
    import numpy as np
    import torch
    from ance_tpu_torch.data.cache import TokenCache
    from ance_tpu_torch.index.flat import FlatIPIndex
    from ance_tpu_torch.models.dot_models import RobertaDot
    from ance_tpu_torch.models.registry import get_model_spec
    from ance_tpu_torch.models.weights import load_pretrained
    from ance_tpu_torch.ops.flash_attention import flash_attention
    from ance_tpu_torch.ops.fused_attention import fused_attention
    from ance_tpu_torch.ops.topk import blockmax_scores
    from ance_tpu_torch.serve import Retriever
    from ance_tpu_torch.serve_http import RetrieverHTTPServer
    from ance_tpu_torch.train.encode import (encode_cache_to_device,
                                             iter_cache_batches,
                                             make_encode_fn)

    dev = torch.device("cuda")
    spec = get_model_spec("rdot_nll_multi_chunk")
    weights, queries = work / "roberta_base_seeded", work / "data" / "dev-query"
    docs = work / "maxp"
    docs.mkdir()
    _write_cache(docs / "passages", N_DOCS, DOC_LEN, 64,
                 np.random.RandomState(1))
    n_chunks = DOC_LEN // CHUNK_LEN
    n_rows = N_DOCS * n_chunks

    # 1. the serve CLI, as a user runs it
    ranking, saved = work / "maxp_ranking.tsv", work / "maxp_index"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "ance_tpu_torch.cli", "serve",
         "--model_type", "rdot_nll_multi_chunk", "--bf16",
         "--model_name_or_path", str(weights), "--data_dir", str(docs),
         "--query_cache", str(queries), "--topk", "10",
         "--max_query_length", str(QUERY_LEN),
         "--per_device_eval_batch_size", str(DOC_BATCH),
         "--output", str(ranking), "--save_index", str(saved)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    cli_s = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"MaxP serve CLI failed:\n{proc.stderr[-4000:]}")
    rows = [line.split("\t") for line in ranking.read_text().splitlines()]
    check(len(rows) == N_QUERIES * 10, f"MaxP serve CLI wrote {len(rows)} "
          f"ranking lines, not {N_QUERIES * 10}")
    check([int(r[2]) for r in rows] == list(range(1, 11)) * N_QUERIES,
          "MaxP ranks are not 1..10")
    pids = np.array([int(r[1]) for r in rows]).reshape(N_QUERIES, 10)
    check(all(len(set(p)) == 10 for p in pids),
          "MaxP ranking repeats a document within a query")
    print(f"maxp serve CLI: {len(rows)} ranking lines in {cli_s:.1f} s "
          f"(load, encode {N_DOCS} documents = {n_rows} chunk rows, index, "
          "rank)", flush=True)

    # 2. in process: the corpus encode through the fused kernel
    torch.cuda.reset_peak_memory_stats()

    def model(impl, dtype=torch.bfloat16):
        m = spec.build(dtype=dtype, attention_impl=impl)
        load_pretrained(m, str(weights))
        return m.to(dev)

    def body_fn(m):
        return make_encode_fn(m, RobertaDot.body_emb_multichunk, dev)

    fused_model = model("auto")
    encode_b = body_fn(fused_model)
    with TokenCache(str(docs / "passages")) as dc:
        encode_cache_to_device(encode_b, dc, DOC_BATCH, multichunk=True,
                               stop=DOC_BATCH)  # warm-up batch
        fused_attention.launches = flash_attention.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        emb, e2id = encode_cache_to_device(encode_b, dc, DOC_BATCH,
                                           multichunk=True)
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
        fused_launches, flash_launches = (fused_attention.launches,
                                          flash_attention.launches)
        n_batches = -(-N_DOCS // DOC_BATCH)
        layers = fused_model.config.num_layers
        check(fused_launches == layers * n_batches and flash_launches == 0,
              f"MaxP encode: {fused_launches} fused / {flash_launches} flash "
              f"launches for {n_batches} batches of {layers} layers")
        check(emb.shape == (n_rows, DIM) and bool(torch.isfinite(emb).all()),
              "chunk embeddings are not finite [16384, 768]")
        check(np.array_equal(e2id, np.repeat(np.arange(N_DOCS), n_chunks)),
              "chunk rows do not repeat each document id per chunk")
        print(f"maxp encode: {n_rows / enc_s:.0f} chunk rows/s = "
              f"{N_DOCS / enc_s:.1f} documents/s (seq {DOC_LEN} = "
              f"{n_chunks} x {CHUNK_LEN}, {DOC_BATCH} documents per batch, "
              f"bf16); {fused_launches} fused launches = {layers} layers x "
              f"{n_batches} batches", flush=True)

        # 3. the flash kernel on the first batches, the plain path and fp32
        flash_b = body_fn(model("flash"))
        fused_attention.launches = flash_attention.launches = 0
        flash_attention.kernel_launches.clear()
        n_flash = 4 * DOC_BATCH
        flash_emb, _ = encode_cache_to_device(flash_b, dc, DOC_BATCH,
                                              multichunk=True, stop=n_flash)
        torch.cuda.synchronize()
        flash_launches = flash_attention.launches
        check(flash_launches == layers * 4 and fused_attention.launches == 0
              and dict(flash_attention.kernel_launches)
              == {"flash_fwd_bf16": flash_launches},
              f"flash encode: {dict(flash_attention.kernel_launches)} flash "
              "launches for 4 batches, not all on flash_fwd_bf16")
        cos_flash = _cosines(flash_emb, emb[:n_flash * n_chunks]).min().item()
        _, ids, mask = next(iter_cache_batches(dc, N_CHECK_DOCS))
    got = encode_b(ids, mask)
    cos_plain = _cosines(got, body_fn(model("xla"))(ids, mask)).min().item()
    cos_fp32 = _cosines(got, body_fn(model("auto", torch.float32))(
        ids, mask)).min().item()
    print(f"maxp chunk embeddings: cosine flash vs fused >= {cos_flash:.5f} "
          f"({n_flash} documents), fused vs plain >= {cos_plain:.5f}, bf16 vs"
          f" fp32 >= {cos_fp32:.5f} ({N_CHECK_DOCS} documents)", flush=True)
    check(cos_flash > 0.999, f"flash vs fused chunk embeddings: {cos_flash}")
    check(cos_plain > 0.999, f"kernel vs plain chunk embeddings: {cos_plain}")
    check(cos_fp32 > 0.99, f"bf16 vs fp32 chunk embeddings: {cos_fp32}")

    # 4. HTTP over the CLI's saved index, every answer against a scan
    index = FlatIPIndex.load(str(saved), device=dev)
    saved_ids = np.load(str(saved) + ".ids.npy")
    check(index.ntotal == n_rows and index.dtype == torch.bfloat16
          and np.array_equal(saved_ids, e2id),
          "saved MaxP index is not the bf16 16384-row index")
    encode_q = make_encode_fn(fused_model, RobertaDot.query_emb, dev)
    with TokenCache(str(queries)) as qc:
        _, q_ids, q_mask = next(iter_cache_batches(qc, N_QUERIES))
    server = RetrieverHTTPServer(Retriever(encode_q, index,
                                           embedding2id=saved_ids),
                                 port=0, pid_space="real",
                                 pad_token_id=fused_model.config.pad_token_id
                                 ).start()
    requests = [(b, k) for b in (1, 64, N_QUERIES) for k in (10, 100)]
    payloads = [{"ids": q_ids[:b].tolist(), "mask": q_mask[:b].tolist(),
                 "k": k} for b, k in requests]
    try:
        addr = server.address
        for payload in payloads:  # first use of each shape
            _post(addr, "/search", payload)
        reset_blockmax_counts()
        answers, latency = [], []
        for payload in payloads:
            times = []
            for _ in range(REPEATS):
                t0 = time.perf_counter()
                body = _post(addr, "/search", payload)
                times.append((time.perf_counter() - t0) * 1000.0)
            answers.append(body)
            latency.append(statistics.median(times))
        search_launches, by_kernel = blockmax_scores.launches, \
            blockmax_counts()
    finally:
        server.shutdown()
    n_searches = len(requests) * REPEATS
    check(search_launches == n_searches
          and by_kernel == {"blockmax_bf16": search_launches},
          f"blockmax kernels launched {by_kernel} for {n_searches} MaxP "
          "searches of a bf16 index")
    scan = Retriever(encode_q, FlatIPIndex.load(str(saved), device=dev,
                                                method="scan"),
                     embedding2id=saved_ids)
    for (b, k), body in zip(requests, answers):
        want_s, want_p = scan.search_tokens(q_ids[:b], q_mask[:b], k)
        got_p = [[e["pid"] for e in r] for r in body["results"]]
        check(got_p == [[p for p in row if p >= 0] for row in want_p.tolist()]
              and all(len(set(r)) == len(r) for r in got_p),
              f"MaxP /search b={b} k={k}: pids differ from the scan")
        got_s = [[e["score"] for e in r] for r in body["results"]]
        check(got_s == [[float(s) for s, p in zip(srow, prow) if p >= 0]
                        for srow, prow in zip(want_s, want_p)],
              f"MaxP /search b={b} k={k}: scores differ from the scan")
    check(no_reference_modules(), "the port imported jax or ance_tpu")
    peak = torch.cuda.max_memory_allocated()
    for (b, k), ms in zip(requests, latency):
        print(f"maxp http /search B={b:3d} k={k:3d}: median {ms:.2f} ms of "
              f"{REPEATS}")
    print(f"maxp http: answers == scan (pids and scores); {search_launches} "
          f"block-max launches for {n_searches} searches; peak device memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    return {"fused_launches": fused_launches, "flash_launches": flash_launches,
            "blockmax_launches": search_launches,
            "blockmax_kernels": by_kernel, "encode_batches": n_batches,
            "encode_chunk_rows_per_s": n_rows / enc_s,
            "encode_docs_per_s": N_DOCS / enc_s,
            "cos_flash_vs_fused": cos_flash, "cos_fused_vs_plain": cos_plain,
            "cos_bf16_vs_fp32": cos_fp32,
            "latency_ms": {f"B{b}_k{k}": ms
                           for (b, k), ms in zip(requests, latency)},
            "peak_mem_gib": peak / 2**30, "cli_s": cli_s}


def _write_ann(ann: Path, n_queries: int, n_passages: int, rs,
               negatives: int = 4) -> None:
    """An ``ann_training_data_0`` of one line per query (a random positive
    and ``negatives`` random negatives), then its ready signal."""
    ann.mkdir()
    with open(ann / "ann_training_data_0", "w") as f:
        for q in range(n_queries):
            pids = rs.choice(n_passages, negatives + 1, replace=False)
            f.write(f"{q}\t{pids[0]}\t{','.join(map(str, pids[1:]))}\n")
    (ann / "ann_ndcg_0").write_text(json.dumps({"ndcg": 0.0}))


def _cli(argv: list[str]) -> dict:
    """``python -m ance_tpu_torch.cli ...`` in this process (so the launch
    counts are visible here); returns its last stdout line as JSON."""
    import contextlib
    import io
    from ance_tpu_torch.cli import main as cli_main
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli_main(argv)
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _check_checkpoint(summary: dict, model_type: str, weights: Path,
                      steps: int) -> None:
    """checkpoint-<steps> is complete, loads strictly, is finite and moved
    away from the starting weights."""
    import torch
    from ance_tpu_torch.models.registry import get_model_spec
    from ance_tpu_torch.models.weights import load_pretrained
    path = Path(summary["checkpoint"])
    check(summary["steps"] == steps and path.name == f"checkpoint-{steps}"
          and (path / "DONE").exists(), f"no complete {path}")
    model = get_model_spec(model_type).build()
    load_pretrained(model, str(path))  # strict
    start = torch.load(weights / "pytorch_model.bin", weights_only=True)
    sd = model.state_dict()
    check(all(bool(torch.isfinite(t).all()) for t in sd.values()),
          f"{path}: parameters not finite")
    moved = max((sd[k] - start[k]).abs().max().item() for k in sd)
    check(moved > 0, f"{path}: training did not move the weights")


def phase_train(work: Path):
    """The trainer job through ``cli train`` at full RoBERTa-base width from
    the seeded weights of the serve phases: FirstP (batch 32, query seq 64,
    passage seq 128, dropout 0.1) for TRAIN_STEPS steps, then MaxP (8
    documents of seq 2048 per batch, attention dropout 0) for
    MAXP_TRAIN_STEPS steps. Each run's launch counts are set to 0 before it
    and read after it."""
    import numpy as np
    import shutil as sh
    import torch
    from ance_tpu_torch.ops.fused_attention import (fused_attention,
                                                    fused_attention_backward)

    weights = work / "roberta_base_seeded"
    rs = np.random.RandomState(2)
    data = work / "train"
    data.mkdir()
    _write_cache(data / "train-query", TRAIN_QUERIES, QUERY_LEN, 8, rs)
    _write_cache(data / "passages", TRAIN_PASSAGES, PASSAGE_LEN, 8, rs)
    _write_ann(data / "ann", TRAIN_QUERIES, TRAIN_PASSAGES, rs)
    docs = work / "train_maxp"
    docs.mkdir()
    for suffix in ("", "_meta"):
        sh.copy(data / f"train-query{suffix}", docs / f"train-query{suffix}")
    _write_cache(docs / "passages", MAXP_TRAIN_DOCS, DOC_LEN, 64, rs)
    _write_ann(docs / "ann", TRAIN_QUERIES, MAXP_TRAIN_DOCS, rs)

    def common(d: Path, out: str, steps: int, batch: int) -> list[str]:
        return ["train", "--device", "cuda", "--bf16",
                "--model_name_or_path", str(weights), "--data_dir", str(d),
                "--ann_dir", str(d / "ann"), "--output_dir", str(work / out),
                "--max_steps", str(steps), "--save_steps", str(steps),
                "--warmup_steps", "2", "--per_device_train_batch_size",
                str(batch), "--max_query_length", str(QUERY_LEN),
                "--max_seq_length", str(PASSAGE_LEN)]

    results = {}
    for name, argv, steps in (
            ("firstp", common(data, "ckpt_firstp", TRAIN_STEPS, TRAIN_BATCH),
             TRAIN_STEPS),
            ("maxp", common(docs, "ckpt_maxp", MAXP_TRAIN_STEPS,
                            MAXP_TRAIN_BATCH)
             + ["--model_type", "rdot_nll_multi_chunk",
                "--encoder_overrides", '{"attention_dropout": 0.0}'],
             MAXP_TRAIN_STEPS)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fused_attention.launches = fused_attention_backward.launches = 0
        t0 = time.perf_counter()
        summary = _cli(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fwd, bwd = fused_attention.launches, fused_attention_backward.launches
        peak = torch.cuda.max_memory_allocated()
        losses = summary["loss"]
        check(len(losses) == steps and all(math.isfinite(x) for x in losses),
              f"{name} train: losses {losses}")
        model_type = "rdot_nll_multi_chunk" if name == "maxp" else "rdot_nll"
        _check_checkpoint(summary, model_type, weights, steps)
        step_ms = statistics.median(summary["step_ms"][TIMED_FROM:])
        if name == "maxp":
            # the query pass is seq 64 (einsum); positives and negatives
            # are chunked passes at S = 512 through the kernels
            want = 12 * 2 * steps
            check(fwd == want and bwd == want, f"MaxP train: {fwd} fused "
                  f"forward / {bwd} backward launches, not {want} each")
        else:
            check(fwd == 0 and bwd == 0, "FirstP at seq 64/128 should take "
                  "the einsum path")
        results[name] = {"steps": steps, "loss": losses,
                         "train_step_ms": step_ms,
                         "step_ms": summary["step_ms"],
                         "fused_forward_launches": fwd,
                         "fused_backward_launches": bwd,
                         "peak_mem_gib": peak / 2**30, "wall_s": wall}
        print(f"train {name}: {steps} steps, loss {losses[0]:.3f} -> "
              f"{losses[-1]:.3f}, all finite; step {step_ms:.1f} ms (median "
              f"after {TIMED_FROM}); fused launches {fwd} forward / {bwd} "
              f"backward; peak device memory {peak / 2**30:.2f} GiB; "
              f"{summary['checkpoint']} loads strictly", flush=True)
    check(no_reference_modules(), "the port imported jax or ance_tpu")
    return results


def _keep_layout(t):
    """A copy of ``t`` in its own strides: a view of a copy of the
    contiguous tensor it views (the encoder's q, k, v are chunks of one
    projection), else a plain copy."""
    base = t if t._base is None else t._base
    if not base.is_contiguous():
        return t.clone()
    return base.clone().as_strided(t.size(), t.stride(),
                                   t.storage_offset() - base.storage_offset())


@contextlib.contextmanager
def picked_calls(direction: str, picks, kept: dict, function=None):
    """``FusedAttention.forward`` (``direction`` "forward": q, k, v, mask)
    or ``.backward`` ("backward": q, k, v, mask, do), or that of another
    autograd ``function`` (``FlashAttention``), wrapped so that ``kept[i]``
    receives copies of the operands of its call number i (from 0) for each
    i in ``picks`` (floating ones in their own strides); the kernels'
    wrappers and their launch counts stay as they are."""
    import torch
    from ance_tpu_torch.ops.fused_attention import FusedAttention
    function = function or FusedAttention
    real = getattr(function, direction)
    n = [0]

    def wrapper(ctx, *args):
        if direction == "backward":
            ops = (*ctx.saved_tensors, *args)
        else:
            ops = args
        if n[0] in picks:
            kept[n[0]] = [a if not torch.is_tensor(a) else _keep_layout(a)
                          if torch.is_floating_point(a) else a.clone()
                          for a in ops]
        n[0] += 1
        return real(ctx, *args)

    setattr(function, direction, staticmethod(wrapper))
    try:
        yield
    finally:
        setattr(function, direction, staticmethod(real))


def phase_maxp_fp32(work: Path):
    """MaxP at the CLI's default dtype (no --bf16: an fp32 encoder and an
    fp32 index), where every seq-512 chunk's attention takes the fused
    kernels' fp32 pieces route: the serve CLI in process over
    N_F32_DOCS documents of seq 2048, every ranking against a scan of its
    saved index; an in-process encode for the rate; ``cli train`` for
    MAXP_F32_TRAIN_STEPS steps (attention dropout 0); and the kernels
    against their plain versions on the operands this path gave them (the
    first forward of the serve encode, the first backward of training).
    Each run's launch counts are set to 0 before it and read after it,
    per route."""
    import numpy as np
    import torch
    from ance_tpu_torch.data.cache import TokenCache
    from ance_tpu_torch.index.flat import FlatIPIndex
    from ance_tpu_torch.models.dot_models import RobertaDot
    from ance_tpu_torch.models.registry import get_model_spec
    from ance_tpu_torch.models.weights import load_pretrained
    from ance_tpu_torch.ops import fused_attention as fa
    from ance_tpu_torch.ops.flash_attention import (
        FlashAttention, flash_attention, flash_attention_forward,
        flash_attention_reference)
    from ance_tpu_torch.ops.topk import blockmax_scores
    from ance_tpu_torch.serve import Retriever
    from ance_tpu_torch.train.encode import (encode_cache_to_device,
                                             iter_cache_batches,
                                             make_encode_fn)

    def reset():
        for f in (fa.fused_attention, fa.fused_attention_backward):
            f.launches = 0
            f.kernel_launches.clear()
        flash_attention.launches = 0
        flash_attention.kernel_launches.clear()
        reset_blockmax_counts()

    dev = torch.device("cuda")
    weights, queries = work / "roberta_base_seeded", work / "data" / "dev-query"
    docs = work / "maxp_fp32"
    docs.mkdir()
    _write_cache(docs / "passages", N_F32_DOCS, DOC_LEN, 64,
                 np.random.RandomState(3))
    n_chunks = DOC_LEN // CHUNK_LEN
    n_rows = N_F32_DOCS * n_chunks
    n_batches = -(-N_F32_DOCS // DOC_BATCH)

    # 1. the serve CLI, as a user runs it: no --bf16
    ranking, saved = work / "maxp_fp32_ranking.tsv", work / "maxp_fp32_index"
    fwd_ops = {}
    reset()
    t0 = time.perf_counter()
    with picked_calls("forward", (0,), fwd_ops):
        summary = _cli(["serve", "--device", "cuda",
                        "--model_type", "rdot_nll_multi_chunk",
                        "--max_seq_length", str(DOC_LEN),
                        "--model_name_or_path", str(weights),
                        "--data_dir", str(docs), "--query_cache", str(queries),
                        "--topk", "10", "--max_query_length", str(QUERY_LEN),
                        "--per_device_eval_batch_size", str(DOC_BATCH),
                        "--output", str(ranking), "--save_index", str(saved)])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    serve_fwd = dict(fa.fused_attention.kernel_launches)
    serve_search = blockmax_counts()
    layers = 12
    check(serve_fwd == {"flash_fwd_pieces": layers * n_batches}
          and flash_attention.launches == 0,
          f"fp32 MaxP serve: fused launches {serve_fwd}, flash "
          f"{flash_attention.launches}, not {layers} layers x {n_batches} "
          "batches on flash_fwd_pieces")
    n_q_batches = -(-N_QUERIES // DOC_BATCH)
    check(serve_search == {"blockmax_pieces_f32": n_q_batches},
          f"fp32 MaxP serve: block-max launches {serve_search}, not "
          f"{n_q_batches} on blockmax_pieces_f32 (an fp32 index)")
    check(summary["queries"] == N_QUERIES and summary["corpus_rows"] == n_rows,
          f"fp32 MaxP serve CLI: {summary}")
    rows = [line.split("\t") for line in ranking.read_text().splitlines()]
    check(len(rows) == N_QUERIES * 10 and [int(r[2]) for r in rows]
          == list(range(1, 11)) * N_QUERIES,
          f"fp32 MaxP serve CLI wrote {len(rows)} lines, not ranks 1..10 "
          f"for {N_QUERIES} queries")
    cli_pids = np.array([int(r[1]) for r in rows]).reshape(N_QUERIES, 10)

    # 2. every ranking against a scan of the saved fp32 index, with the
    # same fp32 query encoder in the CLI's batches
    model = get_model_spec("rdot_nll_multi_chunk").build(dtype=torch.float32)
    load_pretrained(model, str(weights))
    model = model.to(dev)
    index = FlatIPIndex.load(str(saved), device=dev, method="scan")
    saved_ids = np.load(str(saved) + ".ids.npy")
    check(index.ntotal == n_rows and index.dtype == torch.float32,
          "saved fp32 MaxP index is not an fp32 index of every chunk row")
    scan = Retriever(make_encode_fn(model, RobertaDot.query_emb, dev), index,
                     embedding2id=saved_ids)
    with TokenCache(str(queries)) as qc:
        _, q_ids, q_mask = next(iter_cache_batches(qc, N_QUERIES))
    want = np.concatenate([
        scan.search_tokens(q_ids[i:i + DOC_BATCH], q_mask[i:i + DOC_BATCH],
                           10)[1] for i in range(0, N_QUERIES, DOC_BATCH)])
    check(np.array_equal(cli_pids, want),
          f"fp32 MaxP serve CLI: {(cli_pids != want).sum()} ranked pids "
          "differ from the scan")

    # 3. the fp32 encode rate in process (after one warm-up batch)
    encode_b = make_encode_fn(model, RobertaDot.body_emb_multichunk, dev)
    with TokenCache(str(docs / "passages")) as dc:
        encode_cache_to_device(encode_b, dc, DOC_BATCH, multichunk=True,
                               stop=DOC_BATCH)
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        emb, _ = encode_cache_to_device(encode_b, dc, DOC_BATCH,
                                        multichunk=True)
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
    check(dict(fa.fused_attention.kernel_launches)
          == {"flash_fwd_pieces": layers * n_batches}
          and emb.shape == (n_rows, DIM) and bool(torch.isfinite(emb).all()),
          "fp32 MaxP encode: not finite, or not on flash_fwd_pieces")

    # 3b. the flash kernel's fp32 route on the first batches: the same
    # weights with --attention flash, against the fused fp32 encode
    flash_model = get_model_spec("rdot_nll_multi_chunk").build(
        dtype=torch.float32, attention_impl="flash")
    load_pretrained(flash_model, str(weights))
    encode_f = make_encode_fn(flash_model.to(dev),
                              RobertaDot.body_emb_multichunk, dev)
    n_flash_batches = 4
    n_flash = n_flash_batches * DOC_BATCH
    flash_ops = {}
    with TokenCache(str(docs / "passages")) as dc:
        reset()
        with picked_calls("forward", (0,), flash_ops,
                          FlashAttention):
            flash_emb, _ = encode_cache_to_device(
                encode_f, dc, DOC_BATCH, multichunk=True, stop=n_flash)
        torch.cuda.synchronize()
    flash_fwd = dict(flash_attention.kernel_launches)
    check(flash_fwd == {"flash_fwd_pieces": layers * n_flash_batches}
          and not fa.fused_attention.kernel_launches,
          f"fp32 MaxP flash encode: flash launches {flash_fwd}, fused "
          f"{dict(fa.fused_attention.kernel_launches)}, not {layers} layers x "
          f"{n_flash_batches} batches on flash_fwd_pieces alone")
    cos_flash = _cosines(flash_emb, emb[:n_flash * n_chunks]).min().item()
    check(cos_flash > 0.999, f"fp32 MaxP chunk embeddings, flash vs fused: "
          f"per-row cosine {cos_flash}")
    q, k, v, mask = flash_ops[0]
    got = flash_attention_forward(q, k, v, mask)
    plain = flash_attention_reference(q, k, v, mask)
    flash_err = (got - plain).abs().max().item()
    flash_exact = exact_errors(got, plain, exact_in_rows(q, k, v, mask),
                               mask)
    check(flash_err <= 1e-4, f"flash_fwd_pieces on the fp32 flash encode's "
          f"operands: max |kernel - plain| {flash_err} > 1e-4")
    flash_shape = {"shape": list(q.shape), "strides": list(q.stride())}
    print(f"maxp fp32 flash encode: {n_flash} documents, flash launches "
          f"{flash_fwd}, chunk embeddings' cosine vs fused >= "
          f"{cos_flash:.6f}; flash_fwd_pieces on its first call "
          f"{flash_shape}: max|err| {flash_err:.3g} (tol 1e-4; vs fp64 "
          f"exact: kernel {flash_exact['kernel_vs_exact']:.3g}, plain "
          f"{flash_exact['plain_vs_exact']:.3g})", flush=True)
    del model, scan, index, encode_b, emb, flash_model, encode_f, flash_emb
    del q, k, v, mask, got, plain, flash_ops
    torch.cuda.empty_cache()
    print(f"maxp fp32 serve CLI: {N_QUERIES * 10} ranking lines == scan in "
          f"{cli_s:.1f} s ({N_F32_DOCS} documents = {n_rows} chunk rows, fp32 "
          f"index); fused launches {serve_fwd}, block-max {serve_search}; "
          f"encode {n_rows / enc_s:.0f} chunk rows/s = "
          f"{N_F32_DOCS / enc_s:.1f} documents/s (fp32, {DOC_BATCH} "
          "documents per batch)", flush=True)

    # 4. cli train, fp32 MaxP through the fused forward and backward
    data = work / "train_maxp"  # phase_train's MaxP caches
    steps = MAXP_F32_TRAIN_STEPS
    bwd_ops = {}
    reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with picked_calls("backward", (0,), bwd_ops):
        train = _cli(["train", "--device", "cuda",
                      "--model_type", "rdot_nll_multi_chunk",
                      "--model_name_or_path", str(weights),
                      "--data_dir", str(data), "--ann_dir", str(data / "ann"),
                      "--output_dir", str(work / "ckpt_maxp_fp32"),
                      "--max_steps", str(steps), "--save_steps", str(steps),
                      "--warmup_steps", "2", "--per_device_train_batch_size",
                      str(MAXP_F32_TRAIN_BATCH),
                      "--max_query_length", str(QUERY_LEN),
                      "--max_seq_length", str(PASSAGE_LEN),
                      "--encoder_overrides", '{"attention_dropout": 0.0}'])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    train_fwd = dict(fa.fused_attention.kernel_launches)
    train_bwd = dict(fa.fused_attention_backward.kernel_launches)
    want_n = layers * 2 * steps  # positives and negatives, chunked at S=512
    check(train_fwd == {"flash_fwd_pieces": want_n}
          and train_bwd == {"fused_bwd_pieces": want_n},
          f"fp32 MaxP train: fused launches {train_fwd} / {train_bwd}, not "
          f"{want_n} each on the pieces route")
    losses = train["loss"]
    check(len(losses) == steps and all(math.isfinite(x) for x in losses),
          f"fp32 MaxP train: losses {losses}")
    _check_checkpoint(train, "rdot_nll_multi_chunk", weights, steps)
    step_ms = statistics.median(train["step_ms"][TIMED_FROM:])
    print(f"train maxp fp32: {steps} steps of {MAXP_F32_TRAIN_BATCH} "
          f"documents, loss {losses[0]:.3f} -> {losses[-1]:.3f}; step "
          f"{step_ms:.1f} ms (median after {TIMED_FROM}); fused launches "
          f"{train_fwd} / {train_bwd}; peak device memory "
          f"{peak / 2**30:.2f} GiB; {train['checkpoint']} loads strictly",
          flush=True)

    # 5. the kernels on this path's own operands
    q, k, v, mask = fwd_ops[0]
    got = fa.fused_attention_forward(q, k, v, mask)
    plain = fa.fused_attention_reference(q, k, v, mask)
    fwd_err = (got - plain).abs().max().item()
    fwd_exact = exact_errors(got, plain, exact_in_rows(q, k, v, mask), mask)
    check(fwd_err <= 1e-4, f"flash_fwd_pieces on the serve path's operands: "
          f"max |kernel - plain| {fwd_err} > 1e-4")
    fwd_shape = {"shape": list(q.shape), "strides": list(q.stride())}
    q, k, v, mask, do = bwd_ops[0]
    got = fa.fused_attention_backward(q, k, v, mask, do)
    again = fa.fused_attention_backward(q, k, v, mask, do)
    plain = fa.fused_attention_backward_reference(q, k, v, mask, do)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          "fused_bwd_pieces on the train path's operands: two calls differ")
    bwd_exact = exact_errors(got, plain, exact_in_rows(q, k, v, mask, do),
                             mask)
    bwd_err = bwd_exact["kernel_vs_exact"]  # FP32_BACKWARD_YARDSTICK
    check(bwd_err <= 1e-5, f"fused_bwd_pieces on the train path's operands: "
          f"max |kernel - fp64 function| {bwd_err} > 1e-5")
    bwd_plain = max((g - w).abs().max().item() for g, w in zip(got, plain))
    print(f"maxp fp32 path operands: flash_fwd_pieces on the serve encode's "
          f"first call {fwd_shape}: max|err| {fwd_err:.3g} (tol 1e-4; vs "
          f"fp64 exact: kernel {fwd_exact['kernel_vs_exact']:.3g}, plain "
          f"{fwd_exact['plain_vs_exact']:.3g}); fused_bwd_pieces on the "
          f"train step's first backward {list(q.shape)}: max|err| against "
          f"the fp64 function {bwd_err:.3g} (tol 1e-5; the fp32 plain "
          f"version's {bwd_exact['plain_vs_exact']:.3g}, kernel - fp32 plain "
          f"{bwd_plain:.3g}), two calls bit-equal", flush=True)
    check(no_reference_modules(), "the port imported jax or ance_tpu")
    return {"serve_fused_launches": serve_fwd,
            "serve_blockmax_kernels": serve_search, "cli_s": cli_s,
            "encode_chunk_rows_per_s": n_rows / enc_s,
            "encode_docs_per_s": N_F32_DOCS / enc_s,
            "flash_launches": flash_fwd, "cos_flash_vs_fused": cos_flash,
            "path_flash": dict(flash_shape, max_abs_err=flash_err,
                               **flash_exact),
            "train_fused_forward_launches": train_fwd,
            "train_fused_backward_launches": train_bwd,
            "train_steps": steps, "train_loss": losses,
            "train_step_ms": step_ms, "step_ms": train["step_ms"],
            "train_peak_mem_gib": peak / 2**30, "train_wall_s": wall,
            "path_forward": dict(fwd_shape, max_abs_err=fwd_err, **fwd_exact),
            "path_backward": dict(shape=list(q.shape), max_abs_err=bwd_err,
                                  yardstick="fp64 function",
                                  max_abs_err_vs_fp32_plain=bwd_plain,
                                  **bwd_exact)}


ZERO_GRADIENT = ("attention.self.key.bias",)
# SEED's decoder: its self-attention key biases, and the cross-attention's
# query and key projections (a softmax over the one memory token is 1
# whatever its logit)
SEED_ZERO_GRADIENT = ZERO_GRADIENT + (
    "self_attn.k_proj.bias", "encoder_attn.q_proj.weight",
    "encoder_attn.q_proj.bias", "encoder_attn.k_proj.weight",
    "encoder_attn.k_proj.bias")


def _params_close(got: dict, want: dict, atol: float, lr_sum: float,
                  share: float, zero_gradient=ZERO_GRADIENT) -> None:
    """All but ``share`` of the parameter entries within ``atol`` (the
    ``zero_gradient`` tensors aside, the attention key biases: their true
    gradient is 0, so Adam/LAMB turn rounding noise into steps of up to
    ~3.2 x lr) and every entry within twice that step over the rates'
    sum."""
    outside = total = 0
    for key, w in want.items():
        diff = (got[key].float().cpu() - w.float().cpu()).abs()
        check(diff.max().item() <= 2 * 3.2 * lr_sum, f"{key} moved apart")
        if not key.endswith(zero_gradient):
            outside += int((diff > atol).sum())
            total += diff.numel()
    check(outside <= share * total, f"{outside} of {total} entries differ "
          f"by more than {atol}")


def random_batches(n: int, batch: int, q_len: int, p_len: int,
                   seed: int) -> list[dict]:
    """``n`` train batches of random RoBERTa token ids: ``batch`` queries
    of ``q_len`` and as many positives and negatives of ``p_len``, each row
    ``<s>`` then ids, padded (id 1) past a length uniform from 8."""
    import numpy as np
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        b = {}
        for side, seq in (("query", q_len), ("pos", p_len), ("neg", p_len)):
            lengths = rs.randint(8, seq + 1, batch)
            ids = rs.randint(3, 50265, (batch, seq))
            ids[:, 0] = 0
            mask = np.arange(seq)[None] < lengths[:, None]
            b[f"{side}_ids"] = np.where(mask, ids, 1).astype(np.int32)
            b[f"{side}_mask"] = mask.astype(np.int32)
        out.append(b)
    return out


def train_setup(model_type: str, dtype, device, overrides: dict,
                start: dict | None = None, *, attention_impl: str = "auto",
                schedule: tuple = (1e-4, 1, 10), weight_decay: float = 0.01):
    """(model, optimizer, loss_fn): a ``model_type`` RobertaDot
    (``overrides`` on RoBERTa-base) at ``dtype`` on ``device``, from the
    state dict ``start`` or seed 0, with the trainer's clip + LAMB over
    ``warmup_linear(*schedule)`` and the model's triplet loss. The step
    parity here and ``profile_train_step.py`` build their steps with it."""
    from ance_tpu_torch.models.registry import get_model_spec
    from ance_tpu_torch.optim.schedules import warmup_linear
    from ance_tpu_torch.train import trainer
    spec = get_model_spec(model_type)
    model = spec.build(dtype=dtype, config_overrides=overrides,
                       attention_impl=attention_impl)
    if start is not None:
        model.load_state_dict(start)
    model = model.to(device)
    optimizer = trainer.make_optimizer(model, "lamb", warmup_linear(*schedule),
                                       weight_decay=weight_decay)
    return model, optimizer, trainer.triplet_loss_fn(multichunk=spec.multichunk)


def parity_run(model_type: str, overrides: dict, start: dict, batches,
               device, dtype, attention_impl: str = "auto"):
    """The trainer's step over ``batches`` from ``start``: (losses, the
    parameters after, the first step's gradients), on the host in fp32.
    The gradients are read after clipping, a factor common to all."""
    import torch
    from ance_tpu_torch.train import trainer
    model, optimizer, loss_fn = train_setup(
        model_type, dtype, device, overrides, start,
        attention_impl=attention_impl)
    state = trainer.init_train_state(model, optimizer)
    step = trainer.make_train_step(loss_fn)
    gen = torch.Generator().manual_seed(0)
    losses, grads = [], None
    for b in batches:
        state, metrics = step(state, b, gen)
        losses.append(metrics["loss"].item())
        if grads is None:
            grads = {n: p.grad.detach().float().cpu()
                     for n, p in model.named_parameters()
                     if p.grad is not None}
    return losses, {k: v.detach().float().cpu()
                    for k, v in model.state_dict().items()}, grads


def _cos(a, b) -> float:
    """Cosine of two tensors as flat vectors, in fp64."""
    a, b = a.double().flatten(), b.double().flatten()
    return (a @ b / (a.norm() * b.norm())).item()


def bf16_readings(start: dict, ref, run,
                  zero_gradient=ZERO_GRADIENT) -> dict:
    """How far a bf16 ``parity_run`` is from the fp32 one ``ref``: the
    largest |loss − loss_ref| / max(1, |loss_ref|) over the steps, the
    cosine of the two parameter updates, and the least per-tensor cosine of
    the first step's gradients (the ``zero_gradient`` tensors aside, the
    attention key biases: their true gradient is 0)."""
    import torch
    (l_ref, p_ref, g_ref), (l, p, g) = ref, run
    keys = [k for k in g_ref if not k.endswith(zero_gradient)]
    return {"loss": max(abs(a - b) / max(1.0, abs(b))
                        for a, b in zip(l, l_ref)),
            "update_cosine": _cos(
                torch.cat([(p[k] - start[k]).flatten() for k in start]),
                torch.cat([(p_ref[k] - start[k]).flatten() for k in start])),
            "grad_cosine": min(_cos(g[k], g_ref[k]) for k in keys)}


def phase_step_parity():
    """3 train steps from the same weights and batches, dropout off, two
    layers at full width (768, 12 heads): fp32 on the card against the
    port's CPU path; bf16 (for MaxP through the fused kernels and their
    backward) against fp32 on the card; and for MaxP a control, bf16
    through the plain einsum attention, that the kernel path is held to.
    FirstP: batch 8, seq 64 / 128; MaxP: 4 documents of 2 x 512 chunks."""
    import numpy as np
    import torch
    from ance_tpu_torch.models.registry import get_model_spec
    from ance_tpu_torch.ops.fused_attention import (fused_attention,
                                                    fused_attention_backward)

    # init std 0.05: at 0.02 a random encoder maps every text to nearly one
    # embedding, so MaxP's bf16 gradients are mostly rounding; at 0.2 score
    # gaps run to hundreds and the softplus saturates (losses of 0 and of
    # tens), where bf16 and fp32 cannot be compared
    overrides = {"num_layers": 2, "hidden_dropout": 0.0,
                 "attention_dropout": 0.0, "initializer_range": 0.05}
    lr_sum = 2e-4  # warmup_linear(1e-4, 1, 10): 0, 1e-4, 8/9 1e-4
    out = {}
    for model_type, batch, p_len in (("rdot_nll", 8, PASSAGE_LEN),
                                     ("rdot_nll_multi_chunk", 4, 1024)):
        maxp = model_type == "rdot_nll_multi_chunk"
        start = get_model_spec(model_type).build(
            config_overrides=overrides, seed=3).state_dict()
        batches = random_batches(3, batch, QUERY_LEN, p_len, seed=4)
        runs = {"cpu": ("cpu", torch.float32), "f32": ("cuda", torch.float32),
                "bf16": ("cuda", torch.bfloat16)}
        if maxp:
            runs["bf16_plain"] = ("cuda", torch.bfloat16, "xla")
        res, launches = {}, {}
        for name, args in runs.items():
            fused_attention.launches = fused_attention_backward.launches = 0
            res[name] = parity_run(model_type, overrides, start, batches,
                                   *args)
            launches[name] = (fused_attention.launches,
                              fused_attention_backward.launches)
        if maxp:  # 2 layers x 2 chunked passes x 3 steps
            check(launches["bf16"] == (12, 12)
                  and launches["bf16_plain"] == (0, 0),
                  f"MaxP parity fused launches {launches}")
        cpu_l, cpu_p, _ = res["cpu"]
        f32_l, f32_p, _ = res["f32"]
        check(all(x >= 0.01 for x in cpu_l), f"{model_type} parity losses "
              f"{cpu_l}: saturated, nothing to compare")
        diffs = [(f32_p[k] - cpu_p[k]).abs() for k in start
                 if not k.endswith("attention.self.key.bias")]
        worst = max(d.max().item() for d in diffs)
        share = sum(int((d > 1e-5).sum()) for d in diffs) / sum(
            d.numel() for d in diffs)
        loss32 = max(abs(a - b) for a, b in zip(f32_l, cpu_l))
        b16 = bf16_readings(start, res["f32"], res["bf16"])
        print(f"parity {model_type}: fp32 cuda vs cpu losses {f32_l} vs "
              f"{cpu_l} (max |diff| {loss32:.3g}), max param diff "
              f"{worst:.3g} ({share:.2e} of entries > 1e-5, key biases "
              f"aside); bf16 losses {res['bf16'][0]}: within "
              f"{b16['loss']:.3g} of max(1, |loss|), update cosine "
              f"{b16['update_cosine']:.5f}, least step-1 gradient cosine "
              f"{b16['grad_cosine']:.5f}", flush=True)
        # fp32: the card and the CPU sum in other orders. Scores are dot
        # products of LayerNorm'd 768-d embeddings, |s| ~ 700, where one
        # fp32 ulp is 6e-5 and a 768-term sum taken in another order
        # through two layers moves s by tens of ulps: losses within 2e-3 +
        # 1e-3 relative. Entries whose gradient is nearly 0 may take
        # opposite Adam steps (ROADMAP Queue 3), so at most 1e-3 of the
        # parameter entries off by more than 1e-5
        check(np.allclose(f32_l, cpu_l, atol=2e-3, rtol=1e-3),
              f"{model_type} fp32 cuda vs cpu losses {f32_l} vs {cpu_l}")
        _params_close(f32_p, cpu_p, 1e-5, lr_sum, 1e-3)
        # bf16 against fp32: each bound allows 2.5-3x the deviation of
        # plain bf16 steps at this set-up (FirstP's bf16 path is the plain
        # one; MaxP's control below reads it)
        check(b16["loss"] <= 0.1 and b16["update_cosine"] >= 0.95
              and b16["grad_cosine"] >= 0.98,
              f"{model_type} bf16 vs fp32 on the card: {b16}")
        out[model_type] = {"cpu_loss": cpu_l, "cuda_f32_loss": f32_l,
                           "cuda_bf16_loss": res["bf16"][0],
                           "f32_max_loss_diff": loss32,
                           "f32_max_param_diff": worst,
                           "f32_share_outside_1e-5": share,
                           "bf16_vs_f32": b16}
        if maxp:
            # the control shares every rounding with the kernel path but
            # attention's, and its update and gradient cosines are sums
            # over millions of entries: the kernel path must sit no farther
            # from fp32 than twice the control does. Losses are held by the
            # bound above only: the kernel and the einsum path sum in other
            # orders, so their bf16 losses are two draws of the noise
            ctrl = bf16_readings(start, res["f32"], res["bf16_plain"])
            ctrl_l = res["bf16_plain"][0]
            apart = max(abs(a - b) / max(1.0, abs(b))
                        for a, b in zip(res["bf16"][0], ctrl_l))
            print(f"parity {model_type} control (bf16, einsum attention): "
                  f"losses {ctrl_l}, within {ctrl['loss']:.3g} of fp32's, "
                  f"update cosine {ctrl['update_cosine']:.5f}, least "
                  f"gradient cosine {ctrl['grad_cosine']:.5f}; kernel path "
                  f"losses within {apart:.3g} of the control's", flush=True)
            check(1 - b16["update_cosine"] <= 2 * (1 - ctrl["update_cosine"])
                  and 1 - b16["grad_cosine"] <= 2 * (1 - ctrl["grad_cosine"]),
                  f"MaxP bf16 kernel path {b16} against the control {ctrl}")
            out[model_type].update(control_bf16_loss=ctrl_l,
                                   control_vs_f32=ctrl,
                                   bf16_vs_control_loss=apart)
    return out


def _seq128_mask(B: int, S: int):
    """The experiment's mask: a padding tail from SEQ128_PAD_FROM, and row
    0 fully masked."""
    import torch
    mask = torch.ones(B, S, dtype=torch.int64, device="cuda")
    mask[:, SEQ128_PAD_FROM:] = 0
    mask[0] = 0
    return mask


def phase_seq128():
    """Kernels #5 and #6 against their plain versions at the FirstP encode
    shape, B=128 × S=128 × 768 (12 heads of 64), bf16, each element held
    to BF16_SLICE_TOL on [B, S, 12, 64] views; each timed in turns with its
    yardstick (SDPA on the [B, 12, S, 64] views with the same additive
    bias for #5, the unfused composition, four torch.matmul and SDPA, for
    #6; calls the port never makes), the clocks sampled around the pair,
    and the plain version timed apart."""
    import torch
    from ance_tpu_torch.utils.timing import (clocks_text, cuda_ms,
                                             timed_in_turns)
    import torch.nn.functional as F
    from ance_tpu_torch.ops.attention import mask_to_bias
    from ance_tpu_torch.ops.attn128 import (fused128, fused128_reference,
                                            fused_block,
                                            fused_block_reference)

    B, S, H = SEQ128_BATCH, SEQ128_LEN, DIM
    bf16 = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(11)
    q, k, v, x = (torch.randn(B, S, H, generator=g, device="cuda").to(bf16)
                  for _ in range(4))
    wq, wk, wv, wo = ((torch.randn(H, H, generator=g, device="cuda")
                       * H ** -0.5).to(bf16) for _ in range(4))
    mask = _seq128_mask(B, S)
    heads = lambda t: t.reshape(B, S, H // 64, 64)  # noqa: E731
    bias4 = mask_to_bias(mask, bf16)
    cases = {}
    for name, kernel, plain, args in (
            ("fused128", fused128, fused128_reference, (q, k, v, mask)),
            ("fused_block", fused_block, fused_block_reference,
             (x, wq, wk, wv, wo, mask))):
        got = kernel(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        check(got.shape == (B, S, H) and got.dtype == bf16
              and bool(torch.isfinite(got).all()), f"{name}: not finite")
        n_bad, err, ulps = bf16_slice_excess(heads(got), heads(want))
        check(n_bad == 0, f"{name}: {n_bad} elements beyond {BF16_SLICE_TOL}"
              f" (worst {ulps} slice ulps)")
        del got, want
        plain_ms = cuda_ms(lambda: plain(*args))
        split = lambda t: heads(t).transpose(1, 2)  # noqa: E731
        if name == "fused128":
            yardstick = "library_ms"

            def yard():
                return F.scaled_dot_product_attention(
                    split(q), split(k), split(v), attn_mask=bias4)
            # q, k, v in and the context out once, the int64 mask; QK^T and
            # PV at 2·S²·64 each a head, bf16 on the tensor cores
            b_ms, b_by = bound(4 * q.numel() * 2 + mask.numel() * 8,
                               4.0 * B * (H // 64) * S * S * 64, "bf16")
        else:
            yardstick = "unfused_ms"

            def yard():
                qf, kf, vf = (x @ w for w in (wq, wk, wv))
                ctx = F.scaled_dot_product_attention(
                    split(qf), split(kf), split(vf), attn_mask=bias4)
                return ctx.transpose(1, 2).reshape(B, S, H) @ wo
            # x in, out once, the four weights, the mask; four [B·S, H] x
            # [H, H] projections and the attention, bf16
            b_ms, b_by = bound(2 * x.numel() * 2 + 4 * H * H * 2
                               + mask.numel() * 8,
                               8.0 * B * S * H * H
                               + 4.0 * B * (H // 64) * S * S * 64, "bf16")
        times, sampled = timed_in_turns({"ms": lambda: kernel(*args),
                                         yardstick: yard})
        ms = times["ms"]
        library_ms = times.get("library_ms")
        unfused_ms = times.get("unfused_ms")
        # #6's two launches apart (torch.profiler over one call)
        split_ms = pieces_split(lambda: kernel(*args), BLOCK_KERNELS) \
            if name == "fused_block" else None
        cases[name] = {"B": B, "S": S, "H": H, "max_abs_err": err,
                       "tolerance": BF16_SLICE_TOL, "err_slice_ulps": ulps,
                       "ms": ms, "plain_ms": plain_ms,
                       "library_ms": library_ms, "unfused_ms": unfused_ms,
                       "bound_ms": b_ms, "bound_by": b_by,
                       "launch_split_ms": split_ms, "clocks": sampled}
        yard_text = (f"sdpa {library_ms:.3f} ms" if library_ms is not None
                     else f"unfused (4 matmul + sdpa) {unfused_ms:.3f} ms")
        print(f"{name} bf16 B={B} S={S} H={H}: max|err| {err:.3g} ({ulps:.3g}"
              f" slice ulps)  kernel {ms:.3f} ms"
              + (f" {({n: round(t, 4) for n, t in split_ms.items()})}"
                 if split_ms else "")
              + f"  plain {plain_ms:.3f} ms  {yard_text}  bound {b_ms:.4f} ms"
              f" ({b_by})  {clocks_text(sampled)}", flush=True)
    del q, k, v, x
    torch.cuda.empty_cache()
    return cases


def phase_mirror():
    """The seq-128 experiment's mirror encoder at full width (12 layers,
    768, FFN 3072, vocabulary 50265, seeded bf16 weights) over B=128 × S=128
    with the padding tail: each attention variant's launches over one
    forward (counts set to 0 just before it), its output against ``xla``
    by per-row cosine, and its time, the four variants timed in turns
    (the clocks sampled around them)."""
    import numpy as np
    import torch
    from ance_tpu_torch.utils.timing import clocks_text, timed_in_turns
    from ance_tpu_torch.experiments import perf_attn128 as exp
    from ance_tpu_torch.ops.attn128 import (LAUNCHES_PER_CALL, fused128,
                                            fused_block)
    from ance_tpu_torch.ops.fused_attention import fused_attention

    rs = np.random.RandomState(0)
    params = exp.make_params(rs, seq=SEQ128_LEN, device="cuda")
    ids, mask = exp.inputs(rs, SEQ128_BATCH, SEQ128_LEN, "cuda",
                           pad_from=SEQ128_PAD_FROM)
    layers = len(params["layers"])
    counters = {"fold": (fused_attention, 1),
                "fused128": (fused128, LAUNCHES_PER_CALL["fused128"]),
                "block": (fused_block, LAUNCHES_PER_CALL["fused_block"])}
    outs, rows, launches = {}, {}, {}
    for attn in exp.VARIANTS:
        for fn, _ in counters.values():
            fn.launches = 0
        outs[attn] = exp.encoder(params, ids, mask, attn=attn)
        torch.cuda.synchronize()
        launches[attn] = {n: fn.launches for n, (fn, _) in zip(
            ("fused_attention", "fused128", "fused_block"),
            counters.values())}
        want = {n: 0 for n in launches[attn]}
        if attn in counters:
            fn, per_call = counters[attn]
            want[fn.__name__] = layers * per_call
        check(launches[attn] == want, f"mirror {attn}: launches "
              f"{launches[attn]}, not {want}")
        check(outs[attn].shape == (SEQ128_BATCH, DIM)
              and bool(torch.isfinite(outs[attn]).all()),
              f"mirror {attn}: output not finite [{SEQ128_BATCH}, {DIM}]")
    times, sampled = timed_in_turns({
        attn: (lambda attn=attn: exp.encoder(params, ids, mask, attn=attn))
        for attn in exp.VARIANTS})
    print(f"mirror: {clocks_text(sampled)}", flush=True)
    for attn in exp.VARIANTS:
        cos = _cosines(outs[attn], outs["xla"]).min().item()
        check(cos >= MIRROR_COSINE, f"mirror {attn} vs xla: per-row cosine "
              f"{cos} < {MIRROR_COSINE}")
        ms = times[attn]
        rows[attn] = {"ms": ms, "passages_per_s": SEQ128_BATCH / ms * 1e3,
                      "min_row_cosine_vs_xla": cos,
                      "launches": launches[attn]}
        print(f"mirror {attn:8s}: {ms:.2f} ms a batch of {SEQ128_BATCH} = "
              f"{SEQ128_BATCH / ms * 1e3:.0f} passages/s; per-row cosine vs "
              f"xla >= {cos:.5f}; launches in one forward "
              f"{launches[attn]}", flush=True)
    del params, outs
    torch.cuda.empty_cache()
    rows["clocks"] = sampled
    return rows


DEV_FROM_PASSAGE = 7  # dev query i is the first QUERY_LEN tokens of this x i


def _write_generate_data(data: Path, gen: Path, rs) -> None:
    """The generator's data directory: the serve phase's passages (linked),
    GEN_TRAIN_QUERIES random train queries, each with one random positive,
    and N_QUERIES dev queries that are the first QUERY_LEN tokens of
    passage DEV_FROM_PASSAGE x i, judged relevant (2) beside one random
    passage (1). A random encoder ranks a passage it shares its tokens
    with high, so dev NDCG@10 is far from 0 and the cross-check of two
    NDCG computations has something to compare."""
    import numpy as np
    from ance_tpu_torch.data.cache import TokenCache, TokenCacheWriter
    gen.mkdir()
    for suffix in ("", "_meta"):
        os.symlink(data / f"passages{suffix}", gen / f"passages{suffix}")
    _write_cache(gen / "train-query", GEN_TRAIN_QUERIES, QUERY_LEN, 8, rs)
    with open(gen / "train-qrel.tsv", "w") as f:
        for q in range(GEN_TRAIN_QUERIES):
            f.write(f"{q}\t{rs.randint(N_PASSAGES)}\t1\n")
    sources = np.arange(N_QUERIES) * DEV_FROM_PASSAGE
    with TokenCache(str(data / "passages")) as pc:
        lengths, tokens = pc.batch(sources)
    with TokenCacheWriter(str(gen / "dev-query"), QUERY_LEN) as w:
        for length, row in zip(lengths, tokens):
            n = int(min(length, QUERY_LEN))
            q = np.ones(QUERY_LEN, np.int32)  # pad id 1
            q[:n] = row[:n]
            w.write(n, q)
    with open(gen / "dev-qrel.tsv", "w") as f:
        for q, p in enumerate(sources):
            f.write(f"{q}\t{p}\t2\n{q}\t{rs.randint(N_PASSAGES)}\t1\n")


def phase1_against_plain(searched: list, dtypes: str, what: str,
                         names=("dev", "mining"), scaled: bool = False
                         ) -> list:
    """Phase 1 on the operands a path's searches gave it (recorded through
    ``index.flat.topk_blockmax``: its queries against its index, the
    encoder's embeddings, not randn), the kernel against the plain version
    within FLOAT_ATOL and both against the exact fp64 maxima. Run after
    the path's launches were read, so not counted in them; empties
    ``searched``.

    ``scaled`` (SEED's operands, whose block maxima reach ~750, five times
    FLOAT_ATOL_SCORE): two fp32 sums in different orders drift apart in
    proportion to the maxima, so the kernel is held to plain within
    FLOAT_ATOL × max(1, maxima / FLOAT_ATOL_SCORE), the same bound in ulps
    of the largest maximum, and to the exact fp64 maxima within
    FLOAT_ATOL itself."""
    import torch
    from ance_tpu_torch.ops.topk import (_pad_rows, blockmax_kernel_for,
                                         blockmax_scores,
                                         blockmax_scores_reference)
    check(len(searched) == len(names), f"{what} searched "
          f"{len(searched)} times through block-max, not {len(names)}")
    out = []
    for name, (q, corpus) in zip(names, searched):
        q = q.contiguous()
        c = _pad_rows(corpus, CHUNK_ROWS)  # as topk_blockmax pads
        kernel = blockmax_kernel_for(q, c)
        check(kernel == ROUTE_KERNEL[dtypes], f"{what} {name}: phase 1 "
              f"takes {kernel}")
        got = blockmax_scores(q, c, chunk_rows=CHUNK_ROWS)
        want = blockmax_scores_reference(q, c)
        err = (got - want).abs().max().item()
        top = want.abs().max().item()
        tol = FLOAT_ATOL * max(1.0, top / FLOAT_ATOL_SCORE) if scaled \
            else FLOAT_ATOL
        # both against the exact maxima (fp64): how much of the gap is the
        # kernel's and how much cuBLAS's fp32 sum
        exact = (q.double() @ c.double().T).reshape(
            q.shape[0], -1, 16).amax(-1)
        k_err = (got.double() - exact).abs().max().item()
        p_err = (want.double() - exact).abs().max().item()
        out.append({"dtypes": dtypes, "shape": f"{what} {name}",
                    "kernel": kernel, "Q": q.shape[0], "N": c.shape[0],
                    "D": q.shape[1], "max_abs_err": err, "tolerance": tol,
                    "max_abs_err_exact": k_err,
                    "plain_max_abs_err_exact": p_err,
                    "max_abs_block_max": top})
        print(f"kernel {dtypes:10s} {what} {name:6s} Q={q.shape[0]:5d} "
              f"N={c.shape[0]} ({kernel}): max|err| {err:.3g} (bound "
              f"{tol:.3g}) on the encoder's embeddings (block maxima up to "
              f"{top:.1f}); against the exact maxima: kernel {k_err:.3g}, "
              f"plain {p_err:.3g}", flush=True)
        check(err <= tol, f"{dtypes} {what} {name}: max |err| {err} > "
              f"{tol} (block maxima up to {top})")
        check(not scaled or k_err <= FLOAT_ATOL, f"{dtypes} {what} {name}: "
              f"the kernel is {k_err} from the exact maxima, > {FLOAT_ATOL}")
        del got, want, exact, c
    searched.clear()
    torch.cuda.empty_cache()
    return out


def phase_generate(work: Path):
    """The generator job at full RoBERTa-base width from the serve phase's
    seeded weights, over its passages (``_write_generate_data``). Block-max
    launches are counted over the first ``generate`` (set to 0 just before
    it)."""
    import numpy as np
    import torch
    from ance_tpu_torch.data.cache import TokenCache
    from ance_tpu_torch.data.feed import parse_triple_line
    from ance_tpu_torch.models.dot_models import RobertaDot
    from ance_tpu_torch.models.registry import get_model_spec
    from ance_tpu_torch.models.weights import load_pretrained
    from ance_tpu_torch.index import flat
    from ance_tpu_torch.ops.topk import blockmax_scores
    from ance_tpu_torch.optim.schedules import warmup_linear
    from ance_tpu_torch.train import ann_gen, trainer
    from ance_tpu_torch.train.ance_loop import (AnceCycleConfig,
                                                load_offset_qrels,
                                                run_ance_cycles)
    from ance_tpu_torch.train.encode import make_encode_fn

    weights, data = work / "roberta_base_seeded", work / "gen_data"
    _write_generate_data(work / "data", data, np.random.RandomState(3))
    ann, ckpts = work / "gen_ann", work / "gen_ckpt"
    flags = ["--device", "cuda", "--bf16", "--model_name_or_path",
             str(weights), "--data_dir", str(data), "--training_dir",
             str(ckpts), "--max_seq_length", str(PASSAGE_LEN),
             "--max_query_length", str(QUERY_LEN),
             "--topk_training", str(GEN_TOPK),
             "--negative_sample", str(GEN_NEGATIVES),
             "--ann_chunk_factor", "1"]

    # 1. generate, as a user runs it (in process: its result and launches);
    #    its index is fp32, so phase 1 runs blockmax_pieces_f32
    results, searched = [], []
    real, real_topk = ann_gen.generate_new_ann, flat.topk_blockmax

    def keep(*args, **kwargs):
        results.append(real(*args, **kwargs))
        return results[-1]

    def recorded(queries, corpus, **kwargs):  # each search's operands
        searched.append((queries, corpus))
        return real_topk(queries, corpus, **kwargs)

    def generate(out: Path, *extra):
        ann_gen.generate_new_ann, flat.topk_blockmax = keep, recorded
        try:
            torch.cuda.synchronize()
            reset_blockmax_counts()
            t0 = time.perf_counter()
            summary = _cli(["generate", *flags, "--output_dir", str(out),
                            *extra])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            ann_gen.generate_new_ann, flat.topk_blockmax = real, real_topk
        return (summary, results.pop(), seconds, blockmax_scores.launches,
                blockmax_counts())

    summary, result, gen_s, launches, by_kernel = generate(ann)
    kernel_cases = phase1_against_plain(searched, "f32xf32", "generate")
    data_path, ndcg_path = ann / "ann_training_data_0", ann / "ann_ndcg_0"
    check(data_path.exists() and ndcg_path.exists()
          and ndcg_path.stat().st_mtime_ns >= data_path.stat().st_mtime_ns,
          "generate did not write ann_training_data_0, then ann_ndcg_0")
    check(launches > 0 and by_kernel == {"blockmax_pieces_f32": launches},
          f"generate's fp32 index launched {by_kernel}, not only "
          "blockmax_pieces_f32")
    check(summary["checkpoint"] == "<init>", f"generate cited "
          f"{summary['checkpoint']}, not <init>")
    secs = result["seconds"]
    enc_rate = N_PASSAGES / secs["encode_passages"]
    print(f"generate: {gen_s:.1f} s (CLI, in process: load, encode "
          f"{N_PASSAGES} passages at {enc_rate:.0f} passages/s, index, dev "
          f"search, mine {GEN_TRAIN_QUERIES} queries at k={GEN_TOPK} in "
          f"{secs['mining_search'] * 1e3:.1f} ms, write); dev NDCG@10 "
          f"{result['dev_ndcg']:.4f}; block-max launches {by_kernel}",
          flush=True)

    # 2. repair (c): the mining ids equal a scan of the same index, and no
    #    mined negative is its query's positive
    index = result["index"]
    index.method = "scan"
    _, scan_ids = index.search(result["train_query_embedding"], GEN_TOPK)
    same = (scan_ids.cpu().numpy() == result["train_neighbor_ids"]).mean()
    check(same == 1.0, f"mining ids equal the scan on {same:.6f} of "
          f"positions, not all")
    positives = {q: next(iter(r)) for q, r in load_offset_qrels(
        str(data / "train-qrel.tsv")).items()}
    lines = data_path.read_text().splitlines()
    check(len(lines) == GEN_TRAIN_QUERIES, f"{len(lines)} mined lines")
    for line in lines:
        qid, pos, negs = parse_triple_line(line)
        check(pos == positives[qid] and pos not in negs
              and len(negs) == GEN_NEGATIVES, f"bad mined line {line!r}")
    del index, result
    torch.cuda.empty_cache()
    print(f"generate: mining ids == scan at k={GEN_TOPK} "
          f"({GEN_TRAIN_QUERIES} queries); no negative is its positive",
          flush=True)

    # 2b. generate over an int8 index (--index_quantize dims): phase 1 on
    #     blockmax_pieces_int8, mining ids equal a scan of that index
    _, dims, dims_s, dims_launches, dims_kernels = generate(
        work / "gen_ann_dims", "--index_quantize", "dims")
    kernel_cases += phase1_against_plain(searched, "f32xint8", "generate")
    check(dims_launches > 0
          and dims_kernels == {"blockmax_pieces_int8": dims_launches},
          f"generate's dims index launched {dims_kernels}, not only "
          "blockmax_pieces_int8")
    index = dims["index"]
    check(index.quantize == "dims", "generate --index_quantize dims built "
          f"a {index.quantize} index")
    index.method = "scan"
    _, scan_ids = index.search(dims["train_query_embedding"], GEN_TOPK)
    same = (scan_ids.cpu().numpy() == dims["train_neighbor_ids"]).mean()
    check(same == 1.0, f"dims mining ids equal the scan on {same:.6f} of "
          f"positions, not all")
    del index, dims
    torch.cuda.empty_cache()
    print(f"generate --index_quantize dims: {dims_s:.1f} s, {dims_launches} "
          f"blockmax_pieces_int8 launches; mining ids == scan at "
          f"k={GEN_TOPK}", flush=True)

    # 3. infer, then eval-full on its dump: the same NDCG@10
    emb = work / "gen_emb"
    _cli(["infer", *flags, "--output_dir", str(emb)])
    pre = str(emb / "step0")
    full = _cli(["eval-full", "--device", "cuda",
                 "--query_prefix", pre + "_dev_query_emb_p_",
                 "--query_id_prefix", pre + "_dev_query_embid_p_",
                 "--passage_prefix", pre + "_passage_emb_p_",
                 "--passage_id_prefix", pre + "_passage_embid_p_",
                 "--qrels", str(data / "dev-qrel.tsv")])
    # the same per-query NDCGs, averaged by sum()/n in generate and by
    # np.mean (pairwise) in eval-full: equal to the last bit or two
    gap = abs(full["ndcg_10"] - summary["dev_ndcg"])
    check(gap <= 1e-12 and summary["dev_ndcg"] > 0.1, f"eval-full ndcg_10 "
          f"{full['ndcg_10']} vs generate's dev_ndcg {summary['dev_ndcg']} "
          "(apart, or not above 0.1)")
    print(f"infer + eval-full: ndcg_10 {full['ndcg_10']!r} == generate's "
          f"dev_ndcg {summary['dev_ndcg']!r} (within 1e-12); mrr_10 "
          f"{full['mrr_10']:.4f}", flush=True)

    # 4. the two-job loop: train on the file, generate on the checkpoint
    train = _cli([
        "train", "--device", "cuda", "--bf16", "--model_name_or_path",
        str(weights), "--data_dir", str(data), "--ann_dir", str(ann),
        "--output_dir", str(ckpts), "--max_steps", "3", "--save_steps", "3",
        "--warmup_steps", "1", "--per_device_train_batch_size", "32",
        "--max_query_length", str(QUERY_LEN),
        "--max_seq_length", str(PASSAGE_LEN)])
    check(all(math.isfinite(x) for x in train["loss"]),
          f"train on the mined file: losses {train['loss']}")
    second = _cli(["generate", *flags, "--output_dir", str(ann),
                   "--output_num", "1"])
    meta = json.loads((ann / "ann_ndcg_1").read_text())
    check(second["checkpoint"].endswith("checkpoint-3")
          and meta["checkpoint"] == second["checkpoint"],
          f"generate --training_dir cited {meta['checkpoint']}")
    print(f"two-job loop: train 3 steps (losses {train['loss']}) -> "
          f"generate on {second['checkpoint']} -> ann data 1, dev NDCG@10 "
          f"{second['dev_ndcg']:.4f}", flush=True)

    # 5. run_ance_cycles in process: 2 cycles x 3 steps
    spec = get_model_spec("rdot_nll")
    model = spec.build(dtype=torch.bfloat16)
    load_pretrained(model, str(weights))
    model = model.to("cuda")
    state = trainer.init_train_state(model, trainer.make_optimizer(
        model, "lamb", warmup_linear(1e-4, 1, 10)))
    with TokenCache(str(data / "dev-query")) as dev_c, \
            TokenCache(str(data / "passages")) as pass_c, \
            TokenCache(str(data / "train-query")) as train_c:
        t0 = time.perf_counter()
        state, history = run_ance_cycles(
            AnceCycleConfig(steps_per_cycle=3, batch_size=32, num_cycles=2,
                            checkpoint_dir=str(work / "cycle_ckpt")),
            ann_gen.AnnGenConfig(topk_training=GEN_TOPK,
                                 negative_sample=GEN_NEGATIVES,
                                 ann_chunk_factor=1),
            state=state, train_step=trainer.make_train_step(
                trainer.triplet_loss_fn()),
            generator=torch.Generator().manual_seed(0),
            query_encode_fn=make_encode_fn(model, RobertaDot.query_emb,
                                           "cuda"),
            body_encode_fn=make_encode_fn(model, RobertaDot.body_emb, "cuda"),
            dev_query_cache=dev_c, passage_cache=pass_c,
            train_query_cache=train_c,
            train_qrels=load_offset_qrels(str(data / "train-qrel.tsv")),
            dev_qrels=load_offset_qrels(str(data / "dev-qrel.tsv")),
            output_dir=str(work / "cycle_ann"), device="cuda")
        torch.cuda.synchronize()
        cycles_s = time.perf_counter() - t0
    check(len(history) == 2 and state.step == 6
          and all(math.isfinite(h["mean_loss"]) for h in history),
          f"run_ance_cycles: {history}")
    check(ann_gen.get_latest_ann_data(str(work / "cycle_ann"))[0] == 1,
          "run_ance_cycles wrote no ann data 1")
    print(f"run_ance_cycles: 2 cycles x 3 steps in {cycles_s:.1f} s; "
          f"dev NDCG@10 {[round(h['dev_ndcg'], 4) for h in history]}, "
          f"mean losses {[round(h['mean_loss'], 4) for h in history]}",
          flush=True)
    check(no_reference_modules(), "the port imported jax or ance_tpu")
    del state, model
    torch.cuda.empty_cache()
    return {"generate_s": gen_s, "encode_passages_per_s": enc_rate,
            "mining_search_ms_k500": secs["mining_search"] * 1e3,
            "blockmax_launches": launches, "blockmax_kernels": by_kernel,
            "dims_generate_s": dims_s, "dims_blockmax_kernels": dims_kernels,
            "kernel_cases": kernel_cases,
            "dev_ndcg": summary["dev_ndcg"],
            "eval_full_ndcg_10": full["ndcg_10"],
            "second_checkpoint": second["checkpoint"],
            "cycles_s": cycles_s, "cycles": history}


# the front of the pipeline: raw MS MARCO-format TSVs made from a seed
WARMUP_PASSAGES = 16_384
WARMUP_WORDS = (40, 120)  # words a passage
WARMUP_VOCAB_WORDS = 30_000  # distinct words of the synthetic corpus
WARMUP_TRAIN_QUERIES, WARMUP_DEV_QUERIES = 1024, 256
WARMUP_CANDIDATES = 100  # top1000.dev lines a dev query, its positive among
WARMUP_BATCH, WARMUP_TRIPLE_BATCHES = 32, 48  # triples: 48 x 32 lines
WARMUP_STEPS, WARMUP_SAVE = 12, 6  # then a resumed run to 2 x WARMUP_STEPS
PREPROCESS_WORKERS = 4
ROBERTA_VOCAB = 50265
WORD_HASH_SEED = 0x5EED


class WordHashTokenizer:
    """A seeded word-hash tokenizer in RoBERTa's id space (``<s>`` 0, pad
    1, ``</s>`` 2, words crc32-hashed into [3, 50265)) with HF's
    ``encode(text, add_special_tokens=, max_length=)``, ``pad_token_id``
    and ``sep_token``; truncation keeps ``<s>`` and ``</s>``, as HF's
    does. crc32 is the same in every process (``hash`` is not), so
    spawned preprocessing workers tokenize as this process does. The smoke
    tokenizes with it because the card may have no tokenizer files and no
    hub may be tried."""
    pad_token_id = 1
    sep_token = "</s>"

    def encode(self, text, add_special_tokens=True, max_length=None):
        import zlib
        ids = [3 + zlib.crc32(w.encode(), WORD_HASH_SEED)
               % (ROBERTA_VOCAB - 3) for w in text.split()]
        if not add_special_tokens:
            return ids[:max_length]
        if max_length is not None:
            ids = ids[:max_length - 2]
        return [0] + ids + [2]


class WordHashFactory:
    """Stands in for ``cli.TokenizerFactory`` (same constructor); a
    module-level class, so spawned workers unpickle it."""

    def __init__(self, name=None, model_dir=None):
        pass

    def __call__(self):
        return WordHashTokenizer()


def _write_raw_msmarco(raw: Path, rs) -> dict:
    """collection.tsv, queries.{train,dev.small}.tsv with their qrels,
    top1000.dev and triples.train.small.tsv in the MS MARCO layouts. A
    query is 4-8 words of its positive passage; ids are sparse, as MS
    MARCO's are. Returns the raw pieces the checks need."""
    import numpy as np
    raw.mkdir()
    words = np.array([f"t{i}" for i in range(WARMUP_VOCAB_WORDS)])
    pids = np.sort(rs.choice(8_841_823, WARMUP_PASSAGES, replace=False))
    lengths = rs.randint(WARMUP_WORDS[0], WARMUP_WORDS[1] + 1,
                         WARMUP_PASSAGES)
    texts = [" ".join(words[rs.randint(0, WARMUP_VOCAB_WORDS, n)])
             for n in lengths]
    with open(raw / "collection.tsv", "w") as f:
        f.writelines(f"{p}\t{t}\n" for p, t in zip(pids, texts))
    n_q = WARMUP_TRAIN_QUERIES + WARMUP_DEV_QUERIES
    qids = rs.choice(1_200_000, n_q, replace=False)
    positives = rs.choice(WARMUP_PASSAGES, n_q, replace=False)
    queries = []
    for pos in positives:
        toks = texts[pos].split()
        start = rs.randint(0, len(toks) - 8)
        queries.append(" ".join(toks[start:start + rs.randint(4, 9)]))
    splits = {"train": slice(0, WARMUP_TRAIN_QUERIES),
              "dev": slice(WARMUP_TRAIN_QUERIES, n_q)}
    for split, (qfile, rfile) in {
            "train": ("queries.train.tsv", "qrels.train.tsv"),
            "dev": ("queries.dev.small.tsv", "qrels.dev.small.tsv")}.items():
        sl = splits[split]
        with open(raw / qfile, "w") as f, open(raw / rfile, "w") as r:
            for q, text, pos in zip(qids[sl], queries[sl], positives[sl]):
                f.write(f"{q}\t{text}\n")
                r.write(f"{q}\t0\t{pids[pos]}\t1\n")
    with open(raw / "top1000.dev", "w") as f:
        sl = splits["dev"]
        for q, text, pos in zip(qids[sl], queries[sl], positives[sl]):
            others = rs.choice(WARMUP_PASSAGES, WARMUP_CANDIDATES, False)
            cands = [pos] + [c for c in others if c != pos][
                :WARMUP_CANDIDATES - 1]
            f.writelines(f"{q}\t{pids[c]}\t{text}\t{texts[c]}\n"
                         for c in cands)
    with open(raw / "triples.train.small.tsv", "w") as f:
        for i in range(WARMUP_BATCH * WARMUP_TRIPLE_BATCHES):
            q = i % WARMUP_TRAIN_QUERIES
            neg = rs.randint(WARMUP_PASSAGES)
            f.write(f"{queries[q]}\t{texts[positives[q]]}\t{texts[neg]}\n")
    return {"pids": pids, "texts": texts, "qids": qids, "queries": queries,
            "positives": positives, "splits": splits}


def _check_preprocessed(data: Path, raw: dict, encode=None,
                        pad: int = 1) -> int:
    """Every passage record holds the tokenizer's ids for its raw line (cut
    to the sequence, padded with ``pad``); every query record its query's;
    each offset-space qrel points at the rows of its query and its
    positive. ``encode(texts, max_length)`` gives the ids, by default
    :class:`WordHashTokenizer`'s. Returns the number of passage ids."""
    import numpy as np
    from ance_tpu_torch.data.cache import TokenCache
    from ance_tpu_torch.data.preprocess import load_id_map
    if encode is None:
        tok = WordHashTokenizer()

        def encode(texts, max_length):
            return [tok.encode(t, max_length=max_length) for t in texts]
    pid2off = load_id_map(str(data / "pid2offset.pickle"))
    check(sorted(pid2off) == raw["pids"].tolist()
          and sorted(pid2off.values()) == list(range(WARMUP_PASSAGES)),
          "pid2offset does not map every passage id onto the rows")
    with TokenCache(str(data / "passages")) as pc:
        lengths, tokens = pc.batch([pid2off[int(p)] for p in raw["pids"]])
    n_ids = 0
    for ids, n, row in zip(encode(raw["texts"], PASSAGE_LEN), lengths,
                           tokens):
        check(n == len(ids) and row[:n].tolist() == ids
              and bool((row[n:] == pad).all()),
              "a passage record is not its line's tokens")
        n_ids += n
    for split, n_split in (("train", WARMUP_TRAIN_QUERIES),
                           ("dev", WARMUP_DEV_QUERIES)):
        q2off = load_id_map(str(data / f"{split}-query_qid2offset.pickle"))
        sl = raw["splits"][split]
        check(len(q2off) == n_split, f"{split}: {len(q2off)} queries mapped")
        with TokenCache(str(data / f"{split}-query")) as qc:
            lengths, tokens = qc.batch([q2off[int(q)] for q in raw["qids"][sl]])
        for ids, n, row in zip(encode(raw["queries"][sl], QUERY_LEN),
                               lengths, tokens):
            check(n == len(ids) and row[:n].tolist() == ids,
                  f"a {split} query record is not its line's tokens")
        want = sorted((q2off[int(q)], pid2off[int(raw["pids"][p])])
                      for q, p in zip(raw["qids"][sl],
                                      raw["positives"][sl]))
        got = sorted(tuple(map(int, line.split("\t")[:2])) for line in
                     (data / f"{split}-qrel.tsv").read_text().splitlines())
        check(got == want, f"{split}-qrel.tsv does not point at the rows "
              "of its queries and positives")
    return n_ids


@contextlib.contextmanager
def _warmup_probes():
    """Hooks around ``cli warmup``: the tokenizer factory replaced by
    :class:`WordHashFactory` (also in spawned workers, which unpickle it;
    ``_load_tokenizer`` refuses, so no hub is ever tried), each train
    step's host-clock ms (a device synchronize before it and the loss read
    after it), each in-training eval's seconds, each run's full history,
    and the seconds of each tokenization fan-out (the corpus's first)."""
    import torch
    from ance_tpu_torch import cli
    from ance_tpu_torch.data import preprocess
    from ance_tpu_torch.evaluation import mrr_eval
    from ance_tpu_torch.train import warmup

    probes = {"step_ms": [], "eval_s": [], "histories": [], "tokenize_s": []}
    real = {"factory": cli.TokenizerFactory,
            "tokenize": preprocess.multi_process_tokenize,
            "tokenizer": cli._load_tokenizer,
            "make": cli._make_training, "eval": mrr_eval.passage_dist_eval,
            "run": warmup.run_warmup}

    def no_tokenizer(name, model_dir):
        raise OSError(f"no tokenizer files in {model_dir}")

    def make_training(*args, **kwargs):
        state, step = real["make"](*args, **kwargs)

        def timed(state, batch, generator):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch, generator)
            float(metrics["loss"])
            probes["step_ms"].append((time.perf_counter() - t0) * 1e3)
            return state, metrics
        return state, timed

    def evaluate(*args, **kwargs):
        t0 = time.perf_counter()
        out = real["eval"](*args, **kwargs)
        probes["eval_s"].append(time.perf_counter() - t0)
        return out

    def run(*args, **kwargs):
        state, history = real["run"](*args, **kwargs)
        probes["histories"].append(history)
        return state, history

    def tokenize(*args, **kwargs):
        t0 = time.perf_counter()
        real["tokenize"](*args, **kwargs)
        probes["tokenize_s"].append(time.perf_counter() - t0)

    cli.TokenizerFactory, cli._load_tokenizer = WordHashFactory, no_tokenizer
    cli._make_training, mrr_eval.passage_dist_eval = make_training, evaluate
    warmup.run_warmup, preprocess.multi_process_tokenize = run, tokenize
    try:
        yield probes
    finally:
        preprocess.multi_process_tokenize = real["tokenize"]
        cli.TokenizerFactory = real["factory"]
        cli._load_tokenizer = real["tokenizer"]
        cli._make_training = real["make"]
        mrr_eval.passage_dist_eval = real["eval"]
        warmup.run_warmup = real["run"]


def phase_warmup(work: Path):
    """The front of the ANCE pipeline as its runbook drives it
    (``commands/run_msmarco_firstp.sh``: preprocess, BM25 warmup, then the
    generator from the warmup checkpoint), through the port's CLI in
    process at full RoBERTa-base width from the serve phase's seeded
    weights: ``preprocess`` of raw TSVs over PREPROCESS_WORKERS spawned
    workers; ``warmup`` (bf16, LAMB at 2e-4, batch 32, seq 128) to
    WARMUP_STEPS with an in-training eval at its end, then a second run to
    twice that which must resume (checkpoints every WARMUP_SAVE steps); ``generate --training_dir`` on the warmup
    checkpoint (an fp32 index: block-max launches counted from 0 just
    before it, read just after) with ``infer`` + ``eval-full``;
    ``export-hf`` and ``serve`` from the export."""
    import numpy as np
    import torch
    from ance_tpu_torch.data.feed import parse_triple_line
    from ance_tpu_torch.models.dot_models import RobertaDot
    from ance_tpu_torch.models.registry import get_model_spec
    from ance_tpu_torch.models.weights import load_pretrained
    from ance_tpu_torch.train import ann_gen, checkpoint as ckpt
    from ance_tpu_torch.train.ance_loop import load_offset_qrels

    torch.cuda.reset_peak_memory_stats()
    weights = work / "roberta_base_seeded"
    raw_dir, data = work / "warm_raw", work / "warm_data"
    raw = _write_raw_msmarco(raw_dir, np.random.RandomState(14))
    seq_flags = ["--max_seq_length", str(PASSAGE_LEN),
                 "--max_query_length", str(QUERY_LEN)]
    with _warmup_probes() as probes:
        # 1. preprocess over spawned workers
        t0 = time.perf_counter()
        maps = _cli(["preprocess", "--data_dir", str(raw_dir),
                     "--out_data_dir", str(data), *seq_flags,
                     "--num_processes", str(PREPROCESS_WORKERS)])
        pre_s = time.perf_counter() - t0
        check(maps == {"pid2offset": WARMUP_PASSAGES,
                       "train_qid2offset": WARMUP_TRAIN_QUERIES,
                       "dev_qid2offset": WARMUP_DEV_QUERIES},
              f"preprocess map sizes {maps}")
        _check_preprocessed(data, raw)
        corpus_s = probes["tokenize_s"][0]
        print(f"preprocess: {WARMUP_PASSAGES} passages, "
              f"{WARMUP_TRAIN_QUERIES} + {WARMUP_DEV_QUERIES} queries over "
              f"{PREPROCESS_WORKERS} spawned workers in {pre_s:.2f} s; the "
              f"corpus's fan-out {corpus_s:.2f} s "
              f"({WARMUP_PASSAGES / corpus_s:.0f} passages/s, the workers' "
              "start-up included); every record == the tokenizer's ids for "
              "its line; qrels point at their rows", flush=True)

        # 2. warmup to WARMUP_STEPS, then a rerun to twice that: a resume
        warm = work / "warm_ckpt"
        warm_flags = [
            "warmup", "--device", "cuda", "--bf16", "--model_name_or_path",
            str(weights), "--train_file",
            str(raw_dir / "triples.train.small.tsv"), "--output_dir",
            str(warm), "--optimizer", "lamb", "--learning_rate", "2e-4",
            "--warmup_steps", "8", "--save_steps", str(WARMUP_SAVE),
            "--evaluate_during_training", "--eval_steps", str(WARMUP_STEPS),
            "--log_trust_ratios", "--data_dir", str(raw_dir),
            "--per_device_train_batch_size", str(WARMUP_BATCH), *seq_flags]
        t0 = time.perf_counter()
        _cli(warm_flags + ["--max_steps", str(WARMUP_STEPS)])
        _cli(warm_flags + ["--max_steps", str(2 * WARMUP_STEPS)])
        warm_s = time.perf_counter() - t0
    first, second = probes["histories"]
    for history, steps in ((first, range(1, WARMUP_STEPS + 1)),
                           (second, range(WARMUP_STEPS + 1,
                                          2 * WARMUP_STEPS + 1))):
        losses = [h for h in history if "loss" in h]
        evals = [h for h in history if "reranking_mrr" in h]
        ratios = [h for h in history if "trust_ratio_mean" in h]
        check([h["step"] for h in losses] == list(steps),
              f"warmup trained steps {[h['step'] for h in losses]}")
        check(all(math.isfinite(h["loss"]) for h in losses),
              f"warmup losses {[h['loss'] for h in losses]}")
        check([h["step"] for h in evals] == [steps[-1]]
              and all(0.0 <= h[k] <= 1.0 for h in evals
                      for k in ("reranking_mrr", "full_ranking_mrr")),
              f"warmup evals {evals}")
        check([h["step"] for h in ratios] == [h["step"] for h in evals]
              and all(0 < h["trust_ratio_min"] <= h["trust_ratio_mean"]
                      <= h["trust_ratio_max"] < math.inf for h in ratios),
              f"warmup trust ratios {ratios}")
    final, step = ckpt.get_latest_checkpoint(str(warm))
    saved = sorted(ckpt.checkpoint_no(d) for d in os.listdir(warm))
    check(step == 2 * WARMUP_STEPS and ckpt.is_complete(final)
          and saved == list(range(WARMUP_SAVE, 2 * WARMUP_STEPS + 1,
                                  WARMUP_SAVE)),
          f"warmup checkpoints at steps {saved}")
    model = get_model_spec("rdot_nll").build()
    load_pretrained(model, final)  # strict
    start = torch.load(weights / "pytorch_model.bin", weights_only=True)
    sd = model.state_dict()
    check(all(bool(torch.isfinite(t).all()) for t in sd.values())
          and max((sd[k] - start[k]).abs().max().item() for k in sd) > 0,
          f"{final}: parameters not finite or not moved")
    del model, sd, start
    step_ms = statistics.median(probes["step_ms"][TIMED_FROM:])
    losses = [h["loss"] for h in first + second if "loss" in h]
    evals = [h for h in first + second if "reranking_mrr" in h]
    mrrs = [(round(h["reranking_mrr"], 4), round(h["full_ranking_mrr"], 4))
            for h in evals]
    ratio_means = [h["trust_ratio_mean"] for h in first + second
                   if "trust_ratio_mean" in h]
    print(f"warmup: {2 * WARMUP_STEPS} steps of batch {WARMUP_BATCH} in two "
          f"runs ({warm_s:.1f} s), the second resumed at step "
          f"{WARMUP_STEPS}; step {step_ms:.1f} ms (median after the first "
          f"{TIMED_FROM}); losses {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"evals {[round(s, 2) for s in probes['eval_s']]} s, MRR@10 "
          f"rerank / full {mrrs}; trust ratio means {ratio_means}",
          flush=True)

    # 3. generate from the warmup checkpoint: the fp32 index's phase 1 on
    #    blockmax_pieces_f32, twice (dev search and mining)
    flags = ["--device", "cuda", "--bf16", "--model_name_or_path",
             str(weights), "--data_dir", str(data), "--training_dir",
             str(warm), *seq_flags, "--topk_training", str(GEN_TOPK),
             "--negative_sample", str(GEN_NEGATIVES), "--ann_chunk_factor",
             "1"]
    results, real = [], ann_gen.generate_new_ann

    def keep(*args, **kwargs):
        results.append(real(*args, **kwargs))
        return results[-1]

    ann = work / "warm_ann"
    ann_gen.generate_new_ann = keep
    try:
        torch.cuda.synchronize()
        reset_blockmax_counts()
        t0 = time.perf_counter()
        summary = _cli(["generate", *flags, "--output_dir", str(ann)])
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        launches = blockmax_counts()
    finally:
        ann_gen.generate_new_ann = real
    result = results.pop()
    check(launches == {"blockmax_pieces_f32": 2}, "generate from the warmup "
          f"checkpoint launched {launches}, not blockmax_pieces_f32 twice")
    check(summary["checkpoint"] == final, f"generate loaded "
          f"{summary['checkpoint']}, not {final}")
    index = result["index"]
    index.method = "scan"
    _, scan_ids = index.search(result["train_query_embedding"], GEN_TOPK)
    same = (scan_ids.cpu().numpy() == result["train_neighbor_ids"]).mean()
    check(same == 1.0, f"warmup generate: mining ids equal the scan on "
          f"{same:.6f} of positions, not all")
    positives = {q: next(iter(r)) for q, r in load_offset_qrels(
        str(data / "train-qrel.tsv")).items()}
    lines = (ann / "ann_training_data_0").read_text().splitlines()
    check(len(lines) == WARMUP_TRAIN_QUERIES, f"{len(lines)} mined lines")
    for line in lines:
        qid, pos, negs = parse_triple_line(line)
        check(pos == positives[qid] and pos not in negs,
              f"bad mined line {line!r}")
    del index, result, scan_ids
    torch.cuda.empty_cache()
    emb = work / "warm_emb"
    _cli(["infer", *flags, "--output_dir", str(emb)])
    pre = str(emb / "step0")
    full = _cli(["eval-full", "--device", "cuda",
                 "--query_prefix", pre + "_dev_query_emb_p_",
                 "--query_id_prefix", pre + "_dev_query_embid_p_",
                 "--passage_prefix", pre + "_passage_emb_p_",
                 "--passage_id_prefix", pre + "_passage_embid_p_",
                 "--qrels", str(data / "dev-qrel.tsv")])
    gap = abs(full["ndcg_10"] - summary["dev_ndcg"])
    check(gap <= 1e-12, f"eval-full ndcg_10 {full['ndcg_10']} vs generate's "
          f"dev_ndcg {summary['dev_ndcg']}")
    print(f"generate --training_dir (warmup {final}): {gen_s:.1f} s, "
          f"{launches} ; mining ids == scan at k={GEN_TOPK}; dev NDCG@10 "
          f"{summary['dev_ndcg']!r} == eval-full's {full['ndcg_10']!r} "
          f"(within 1e-12)", flush=True)

    # 4. export-hf, then serve from the export: the same rankings as from
    #    the checkpoint, and bit-equal embeddings on one batch
    export = work / "warm_export"
    t0 = time.perf_counter()
    exported = _cli(["export-hf", "--training_dir", str(warm), "--out_dir",
                     str(export)])
    export_s = time.perf_counter() - t0
    check(exported["step"] == 2 * WARMUP_STEPS and exported["from"] == final
          and sorted(os.listdir(export)) == ["config.json",
                                             "pytorch_model.bin"],
          f"export-hf: {exported}")
    serve = ["serve", "--device", "cuda", "--bf16", "--data_dir", str(data),
             "--query_cache", str(data / "dev-query"), "--topk", "10",
             "--with_scores", *seq_flags]
    served = _cli(serve + ["--model_name_or_path", str(export), "--output",
                           str(work / "warm_rank_export.tsv")])
    _cli(serve + ["--training_dir", str(warm), "--output",
                  str(work / "warm_rank_ckpt.tsv")])
    ranking = (work / "warm_rank_export.tsv").read_text()
    check(served["params"] == str(export / "pytorch_model.bin")
          and len(ranking.splitlines()) == WARMUP_DEV_QUERIES * 10
          and ranking == (work / "warm_rank_ckpt.tsv").read_text(),
          "serve from the export does not rank as serve from the checkpoint")
    from ance_tpu_torch.data.cache import TokenCache
    from ance_tpu_torch.train.encode import make_encode_fn
    rows = np.arange(min(128, WARMUP_DEV_QUERIES))
    with TokenCache(str(data / "passages")) as pc:
        p_ids = pc.batch(rows)[1].copy()
    with TokenCache(str(data / "dev-query")) as qc:
        q_ids = qc.batch(rows)[1].copy()
    embs = []
    for path in (export, Path(final)):
        m = get_model_spec("rdot_nll").build(dtype=torch.bfloat16)
        load_pretrained(m, str(path))  # strict
        m = m.to("cuda")
        embs.append([make_encode_fn(m, method, "cuda")(ids, ids != 1)
                     for method, ids in ((RobertaDot.query_emb, q_ids),
                                         (RobertaDot.body_emb, p_ids))])
        del m
    check(all(torch.equal(a, b) for a, b in zip(*embs)),
          "the export's embeddings are not bit-equal to the checkpoint's")
    del embs
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"export-hf: step {exported['step']} in {export_s:.2f} s; serve "
          "from the export == serve from the checkpoint (rankings byte "
          f"for byte), query and passage embeddings bit-equal on {len(rows)} "
          "rows; "
          f"peak {peak:.2f} GiB", flush=True)
    check(no_reference_modules(), "the port imported jax or ance_tpu")
    return {"preprocess_s": pre_s, "tokenize_s": probes["tokenize_s"],
            "preprocess_passages_per_s": WARMUP_PASSAGES / corpus_s,
            "warmup_step_ms": step_ms, "warmup_steps_ms": probes["step_ms"],
            "warmup_losses": losses,
            "warmup_evals": evals, "eval_s": probes["eval_s"],
            "generate_s": gen_s, "blockmax_kernels": launches,
            "dev_ndcg": summary["dev_ndcg"],
            "eval_full_ndcg_10": full["ndcg_10"], "export_s": export_s,
            "peak_gib": peak}


LOOP_SLICE, LOOP_STEPS_PER_SLICE = 4096, 4  # passages an E item; steps an item
MAXP_LOOP_SLICE = 128  # documents an E item of the MaxP loop (4 batches)
IDLE_SEARCHES = 100  # live B=1 searches timed after the run, the loop idle
LIVE_QPS = 10  # the offered rate of the live client during the run (open
               # loop: a request every 1/LIVE_QPS s, at once if one is late)


@contextlib.contextmanager
def _loop_probes():
    """Hooks around the pipelined loop that ``cli ance-loop`` runs
    through, yielding the dict they fill: the loop object; each work item's
    tag, host-clock start and end (the loop synchronizes the device before
    and after an item) and the fused-attention launches inside it; a copy
    of each mining search's queries, neighbours and index; a copy of the
    first dev and mining phase-1 operands of the loop's own thread; the HTTP server, whose shutdown is held (``stopped`` is set)
    until the context exits, so its answers can be compared after the
    run. The smoke's seeded weights carry no tokenizer files, so the
    tokenizer load is refused at once (live serving then takes token
    arrays), never tried against a hub."""
    import threading
    import torch
    from ance_tpu_torch import cli
    from ance_tpu_torch.index import flat
    from ance_tpu_torch.ops import fused_attention as fa
    from ance_tpu_torch.serve_http import RetrieverHTTPServer
    from ance_tpu_torch.train import pipelined

    probes = {"loops": [], "items": [], "mined": [], "phase1": {},
              "servers": [], "stopped": threading.Event()}
    cls = pipelined.PipelinedAnce
    real = {"init": cls.__init__, "item": cls._run_item,
            "mine": cls._mine_chunk, "negatives": pipelined.mine_negatives,
            "topk": flat.topk_blockmax, "tokenizer": cli._load_tokenizer,
            "start": RetrieverHTTPServer.start,
            "shutdown": RetrieverHTTPServer.shutdown}
    caught = {}

    def init(self, *args, **kwargs):
        real["init"](self, *args, **kwargs)
        probes["loops"].append(self)

    def run_item(self):
        tag = self._work[0][0]
        f0 = (fa.fused_attention.launches, fa.fused_attention_backward.launches)
        t0 = time.perf_counter()
        real["item"](self)
        probes["items"].append({
            "tag": tag, "start": t0, "end": time.perf_counter(),
            "forward": fa.fused_attention.launches - f0[0],
            "backward": fa.fused_attention_backward.launches - f0[1]})

    def negatives(qids, pids, positives, neighbor_ids, *args, **kwargs):
        caught["neighbors"] = neighbor_ids
        return real["negatives"](qids, pids, positives, neighbor_ids,
                                 *args, **kwargs)

    def mine(self, qs, qe, chunk_no):
        real["mine"](self, qs, qe, chunk_no)
        index = self.index
        probes["mined"].append({
            "queries": self._cyc["tq_emb"][qs:qe].clone(),
            "neighbors": caught.pop("neighbors"),
            "emb": index._emb.clone(), "ntotal": index.ntotal,
            "scales": None if index._scales is None
            else index._scales.clone(),
            "k": min(self.cfg.topk_training, index.ntotal)})

    def topk(queries, corpus, **kwargs):
        seen = probes["phase1"]
        if threading.current_thread() is threading.main_thread() \
                and len(seen) < 2:  # a cycle's S items come before its M
            seen["mining" if seen else "dev"] = (queries.clone(),
                                                 corpus.clone())
        return real["topk"](queries, corpus, **kwargs)

    def no_tokenizer(name, model_dir):
        raise OSError(f"no tokenizer files in {model_dir}")

    def start(self):
        probes["servers"].append(self)
        return real["start"](self)

    def shutdown(self):
        probes["stopped"].set()

    cls.__init__, cls._run_item, cls._mine_chunk = init, run_item, mine
    pipelined.mine_negatives, flat.topk_blockmax = negatives, topk
    cli._load_tokenizer = no_tokenizer
    RetrieverHTTPServer.start, RetrieverHTTPServer.shutdown = start, shutdown
    try:
        yield probes
    finally:
        cls.__init__, cls._run_item = real["init"], real["item"]
        cls._mine_chunk = real["mine"]
        pipelined.mine_negatives = real["negatives"]
        flat.topk_blockmax = real["topk"]
        cli._load_tokenizer = real["tokenizer"]
        RetrieverHTTPServer.start = real["start"]
        RetrieverHTTPServer.shutdown = real["shutdown"]
        probes["stopped"].set()
        for server in probes["servers"]:
            real["shutdown"](server)


def _mining_equals_scan(probes, what: str) -> int:
    """Every mining search of the run against a scan of the index as it
    stood then (``FlatIPIndex.search`` with ``method="scan"``), id for id.
    Returns the number of searches compared."""
    import copy
    check(len(probes["mined"]) >= 1, f"{what}: no mining search ran")
    for m in probes["mined"]:
        index = copy.copy(probes["loops"][0].index)
        index._emb, index._scales, index._ntotal = (m["emb"], m["scales"],
                                                    m["ntotal"])
        index.method = "scan"
        _, ids = index.search(m["queries"], m["k"])
        same = (ids.cpu().numpy() == m["neighbors"]).mean()
        check(same == 1.0, f"{what}: mining ids equal the scan on "
              f"{same:.6f} of positions, not all")
    return len(probes["mined"])


def _phase1_on_loop_operands(probes, dtypes: str, what: str) -> list:
    """Kernel #1's phase 1 against its plain version on the operands the
    loop's own dev and mining searches gave it."""
    from ance_tpu_torch.ops.topk import (_pad_rows, blockmax_kernel_for,
                                         blockmax_scores,
                                         blockmax_scores_reference)
    out = []
    for key in ("dev", "mining"):
        q, corpus = probes["phase1"][key]
        q = q.contiguous()
        c = _pad_rows(corpus, CHUNK_ROWS)
        kernel = blockmax_kernel_for(q, c)
        check(kernel == ROUTE_KERNEL[dtypes], f"{what} {key}: phase 1 takes "
              f"{kernel}")
        got = blockmax_scores(q, c, chunk_rows=CHUNK_ROWS)
        want = blockmax_scores_reference(q, c)
        err = (got - want).abs().max().item()
        check(err <= FLOAT_ATOL, f"{what} {key}: phase 1 max |err| {err} > "
              f"{FLOAT_ATOL}")
        out.append({"dtypes": dtypes, "shape": f"{what} {key}",
                    "kernel": kernel, "Q": q.shape[0], "N": c.shape[0],
                    "D": q.shape[1], "max_abs_err": err})
        print(f"kernel {dtypes:10s} {what} {key:6s} Q={q.shape[0]:5d} "
              f"N={c.shape[0]} ({kernel}): max|err| {err:.3g} on the loop's "
              "operands", flush=True)
    return out


def phase_ance_loop(work: Path, generate: dict, train: dict):
    """The single-program pipelined refresh through ``cli ance-loop`` (in
    process) at full RoBERTa-base width from the serve phase's seeded
    weights, on the generator phase's data: (a) FirstP over an fp32 index
    with ``--http``, a client thread sending B=1, k=10 searches at
    LIVE_QPS while it trains, bootstrap and a whole cycle plus
    LOOP_STEPS_PER_SLICE steps; (b) FirstP over an int8 (``dims``) index
    without serving, bootstrap and 3 x LOOP_STEPS_PER_SLICE steps; (c)
    MaxP (bf16, attention dropout 0) over the fp32 MaxP phase's 512
    documents of seq 2048, bootstrap and LOOP_STEPS_PER_SLICE steps. Each
    run's
    launch counts are set to 0 just before it and read just after it."""
    import collections
    import gc
    import threading
    import numpy as np
    import torch
    from ance_tpu_torch.data.cache import TokenCache
    from ance_tpu_torch.models.registry import get_model_spec
    from ance_tpu_torch.models.weights import load_pretrained
    from ance_tpu_torch.ops import fused_attention as fa
    from ance_tpu_torch.train.encode import iter_cache_batches

    weights, data = work / "roberta_base_seeded", work / "gen_data"
    # 8 slices, then D, S, V, Q, M, F: 256 dev and 1,024 train queries a
    # search item each
    cycle = "E" * -(-N_PASSAGES // LOOP_SLICE) + "DSVQMF"
    first_steps = (len(cycle) + 1) * LOOP_STEPS_PER_SLICE

    def flags(out: str, steps: int, data_dir: Path = data,
              seq: int = PASSAGE_LEN, eval_batch: int = 128,
              slice_size: int = LOOP_SLICE, batch: int = TRAIN_BATCH):
        return ["ance-loop", "--device", "cuda", "--bf16",
                "--model_name_or_path", str(weights),
                "--data_dir", str(data_dir), "--output_dir", str(work / out),
                "--max_steps", str(steps), "--warmup_steps", "2",
                "--max_seq_length", str(seq),
                "--max_query_length", str(QUERY_LEN),
                "--per_device_train_batch_size", str(batch),
                "--per_device_eval_batch_size", str(eval_batch),
                "--encode_slice_size", str(slice_size),
                "--train_steps_per_slice", str(LOOP_STEPS_PER_SLICE),
                "--topk_training", str(GEN_TOPK),
                "--negative_sample", str(GEN_NEGATIVES),
                "--ann_chunk_factor", "1"]

    def run(argv, after=None) -> dict:
        """``cli ance-loop`` with the counts set to 0 before it; ``after``
        (the live client's join) runs before they are read."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_blockmax_counts()
        fa.fused_attention.launches = fa.fused_attention_backward.launches = 0
        t0 = time.perf_counter()
        try:
            _cli(argv)
        finally:
            if after is not None:
                after()
        torch.cuda.synchronize()
        return {"wall_s": time.perf_counter() - t0,
                "blockmax_kernels": blockmax_counts(),
                "fused_forward": fa.fused_attention.launches,
                "fused_backward": fa.fused_attention_backward.launches,
                "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}

    def searches(loop) -> int:
        return sum(tag in "SM" for tag in loop.schedule_trace)

    def loop_step_ms(probes, boot_items: int) -> list:
        """ms a train step inside the loop: each run of steps between two
        items (from one item's end to the next one's start, both after a
        device synchronize), from the bootstrap's last item on."""
        items = probes["items"][boot_items - 1:]
        return [(b["start"] - x["end"]) * 1e3 / LOOP_STEPS_PER_SLICE
                for x, b in zip(items, items[1:])]

    def release() -> None:
        gc.collect()  # the loop's work items refer back to it
        torch.cuda.empty_cache()

    def item_p50(loop) -> dict:
        return {tag: statistics.median(loop.item_times[tag]) * 1e3
                for tag in "ESMF" if loop.item_times[tag]}

    def tails(ms: list) -> dict:
        return {"p50": statistics.median(ms),
                "p99": float(np.percentile(ms, 99)), "n": len(ms)}

    def one(i: int) -> dict:
        return {"ids": q_ids[i:i + 1].tolist(),
                "mask": q_mask[i:i + 1].tolist(), "k": 10}

    with TokenCache(str(data / "dev-query")) as qc:
        _, q_ids, q_mask = next(iter_cache_batches(qc, N_QUERIES))
    results = {}

    # (a) FirstP, fp32 index, live HTTP searches during the run
    during, client_errors, stop = [], [], threading.Event()

    def client(probes):
        while not probes["servers"]:  # the server starts after bootstrap
            if stop.wait(0.05):
                return
        addr, i = probes["servers"][0].address, 0
        due = time.perf_counter()
        while not probes["stopped"].wait(max(0.0, due - time.perf_counter())):
            try:
                t0 = time.perf_counter()
                _post(addr, "/search", one(i % N_QUERIES))
                during.append((time.perf_counter() - t0) * 1e3)
            except Exception as e:  # collected, checked after the run
                client_errors.append(repr(e))
            i += 1
            due += 1.0 / LIVE_QPS

    with _loop_probes() as probes:
        thread = threading.Thread(target=client, args=(probes,))
        thread.start()

        def join_client():
            probes["stopped"].set()
            stop.set()
            thread.join(timeout=600)

        a = run(flags("loop_a", first_steps) + ["--http", "127.0.0.1:0"],
                after=join_client)
        check(not thread.is_alive(), "the live-search client hung")
        check(not client_errors, f"live searches failed: {client_errors[:3]}")
        loop, server = probes["loops"][0], probes["servers"][0]
        n_live = len(during)
        want = {"blockmax_pieces_f32": searches(loop) + n_live}
        check(a["blockmax_kernels"] == want, f"ance-loop (a): block-max "
              f"launches {a['blockmax_kernels']}, not {want} (S + M items "
              "and live searches, over the fp32 index)")
        check(n_live >= 10, f"only {n_live} live searches during the run")
        trace = "".join(loop.schedule_trace)
        check(trace.replace("T", "") == cycle * 2 + "E"
              and loop.state.step == first_steps and loop.refresh_no == 2,
              f"ance-loop (a): schedule {trace.replace('T', '')}, step "
              f"{loop.state.step}")
        boot = loop.history[0]["dev_ndcg"]
        check(abs(boot - generate["dev_ndcg"]) <= 1e-12, f"ance-loop (a): "
              f"bootstrap dev NDCG {boot!r} vs generate's "
              f"{generate['dev_ndcg']!r}")
        mined = _mining_equals_scan(probes, "ance-loop (a)")
        lines = (work / "loop_a" / "refresh.jsonl").read_text().splitlines()
        check(len(lines) == 2 and all(
            {"refresh", "dev_ndcg", "dev_recall", "ann_mrr", "num_triples",
             "refresh_sec"} <= set(json.loads(x)) for x in lines),
            f"refresh.jsonl: {lines}")
        final = work / "loop_a" / f"checkpoint-{first_steps}"
        check((final / "DONE").exists(), f"no complete {final}")
        load_pretrained(get_model_spec("rdot_nll").build(), str(final))
        stats = _get(server.address, "/metrics")
        check(stats["errors"] == 0 and stats["requests"] == n_live,
              f"/metrics {stats}")
        # the loop idle: latencies, then every answer == search_tokens
        idle = []
        for i in range(IDLE_SEARCHES):
            t0 = time.perf_counter()
            _post(server.address, "/search", one(i % N_QUERIES))
            idle.append((time.perf_counter() - t0) * 1e3)
        for i in range(16):
            body = _post(server.address, "/search", one(i))
            _, want_p = server.retriever.search_tokens(
                q_ids[i:i + 1], q_mask[i:i + 1], 10)
            check([[e["pid"] for e in r] for r in body["results"]]
                  == want_p.tolist(), f"live answer {i} != search_tokens")
        kernel_cases = _phase1_on_loop_operands(probes, "f32xf32",
                                                "ance-loop")
        step_ms = loop_step_ms(probes, len(cycle))
        results["firstp"] = {
            **a, "schedule": trace, "searches": searches(loop),
            "live_searches": n_live, "mining_searches_vs_scan": mined,
            "history": loop.history,
            "refresh_sec": [h["refresh_sec"] for h in loop.history],
            "item_p50_ms": item_p50(loop),
            "item_ms": {t: [x * 1e3 for x in v]
                        for t, v in loop.item_times.items()},
            "loop_step_ms": step_ms,
            "loop_step_ms_median": statistics.median(step_ms),
            "train_step_ms_alone": train["firstp"]["train_step_ms"],
            "live_qps_offered": LIVE_QPS,
            "live_ms_during": tails(during), "live_ms_idle": tails(idle),
            "lock_wait_ms_total": stats["lock_wait_ms_total"],
            "bootstrap_dev_ndcg": boot,
            "generate_dev_ndcg": generate["dev_ndcg"]}
    r = results["firstp"]
    print(f"ance-loop (a) FirstP, fp32 index, --http: {a['wall_s']:.1f} s; "
          f"refresh_sec {r['refresh_sec']}; item p50 ms "
          f"{ {t: round(v, 2) for t, v in r['item_p50_ms'].items()} }; "
          f"train step in the loop {r['loop_step_ms_median']:.1f} ms "
          f"(median of {len(step_ms)} runs of {LOOP_STEPS_PER_SLICE}), "
          f"{r['train_step_ms_alone']:.1f} alone (phase train); live B=1 "
          f"k=10 at {LIVE_QPS}/s p50/p99 {r['live_ms_during']['p50']:.2f}/"
          f"{r['live_ms_during']['p99']:.2f} ms during the run ({n_live}, "
          f"all 200), {r['live_ms_idle']['p50']:.2f}/"
          f"{r['live_ms_idle']['p99']:.2f} idle; lock_wait_ms_total "
          f"{stats['lock_wait_ms_total']:.1f}; peak {a['peak_mem_gib']:.2f} "
          f"GiB; bootstrap dev NDCG {boot!r} == generate's; block-max "
          f"{a['blockmax_kernels']}; mining == scan in {mined} searches",
          flush=True)
    del loop, server, probes
    release()

    # (b) FirstP over an int8 (dims) index, no serving: 24 steps
    with _loop_probes() as probes:
        b = run(flags("loop_b", 3 * LOOP_STEPS_PER_SLICE)
                + ["--index_quantize", "dims"])
        loop = probes["loops"][0]
        want = {"blockmax_pieces_int8": searches(loop)}
        check(b["blockmax_kernels"] == want, f"ance-loop (b): block-max "
              f"launches {b['blockmax_kernels']}, not {want}")
        check(loop.index.quantize == "dims"
              and loop.index._emb.dtype == torch.int8, "(b) index not int8")
        mined = _mining_equals_scan(probes, "ance-loop dims")
        kernel_cases += _phase1_on_loop_operands(probes, "f32xint8",
                                                 "ance-loop dims")
        boot = loop.history[0]
        results["dims"] = {**b, "schedule": "".join(loop.schedule_trace),
                           "searches": searches(loop),
                           "mining_searches_vs_scan": mined,
                           "int8_clip_frac": boot["int8_clip_frac"],
                           "int8_scale_widenings":
                           boot["int8_scale_widenings"],
                           "item_p50_ms": item_p50(loop),
                           "refresh_sec": boot["refresh_sec"],
                           "loop_step_ms": loop_step_ms(probes, len(cycle))}
    print(f"ance-loop (b) dims index: {b['wall_s']:.1f} s; block-max "
          f"{b['blockmax_kernels']}; int8_clip_frac "
          f"{boot['int8_clip_frac']!r}, int8_scale_widenings "
          f"{boot['int8_scale_widenings']}; train step in the loop, no "
          f"serving: {[round(x, 1) for x in results['dims']['loop_step_ms']]}"
          f" ms; mining == scan in {mined} searches; peak "
          f"{b['peak_mem_gib']:.2f} GiB", flush=True)
    del loop, probes
    release()

    # (c) MaxP, bf16, attention dropout 0: #2 in the E items, #3 in steps
    docs = work / "loop_maxp"
    docs.mkdir()
    for suffix in ("", "_meta"):
        os.symlink(work / "maxp_fp32" / f"passages{suffix}",
                   docs / f"passages{suffix}")
        for split in ("train-query", "dev-query"):
            os.symlink(data / f"{split}{suffix}", docs / f"{split}{suffix}")
    rs = np.random.RandomState(5)
    for split, n in (("train", GEN_TRAIN_QUERIES), ("dev", N_QUERIES)):
        with open(docs / f"{split}-qrel.tsv", "w") as f:
            f.writelines(f"{q}\t{rs.randint(N_F32_DOCS)}\t1\n"
                         for q in range(n))
    fwd_ops, bwd_ops = {}, {}
    steps = LOOP_STEPS_PER_SLICE
    with _loop_probes() as probes, picked_calls("forward", (0,), fwd_ops), \
            picked_calls("backward", (0,), bwd_ops):
        c = run(flags("loop_c", steps, data_dir=docs, seq=DOC_LEN,
                      eval_batch=DOC_BATCH, slice_size=MAXP_LOOP_SLICE,
                      batch=MAXP_TRAIN_BATCH)
                + ["--model_type", "rdot_nll_multi_chunk",
                   "--encoder_overrides", '{"attention_dropout": 0.0}'])
        loop = probes["loops"][0]
        want = {"blockmax_pieces_f32": searches(loop)}
        check(c["blockmax_kernels"] == want, f"ance-loop (c): block-max "
              f"launches {c['blockmax_kernels']}, not {want}")
        check(loop.index.ntotal == N_F32_DOCS * DOC_LEN // CHUNK_LEN,
              f"(c) index rows {loop.index.ntotal}")
        mined = _mining_equals_scan(probes, "ance-loop MaxP")
        items = probes["items"]
    per_e = 12 * (MAXP_LOOP_SLICE // DOC_BATCH)
    in_items = collections.Counter()
    for it in items:
        in_items[it["tag"]] += it["forward"]
        check(it["backward"] == 0, f"(c) item {it['tag']} ran a backward")
    n_e = loop.schedule_trace.count("E")
    check(in_items["E"] == per_e * n_e and sum(in_items.values()) ==
          in_items["E"], f"(c) fused forward launches by item "
          f"{dict(in_items)}, not {per_e} an E item ({n_e} E items)")
    step_fwd = c["fused_forward"] - in_items["E"]
    check(step_fwd == 12 * 2 * steps and c["fused_backward"] == 12 * 2 * steps,
          f"(c) steps: {step_fwd} fused forward / {c['fused_backward']} "
          f"backward launches, not {12 * 2 * steps} each")
    q, k, v, mask = fwd_ops[0]
    n_bad, fwd_err, fwd_ulps = bf16_slice_excess(
        fa.fused_attention_forward(q, k, v, mask),
        fa.fused_attention_reference(q, k, v, mask))
    check(n_bad == 0, f"(c) #2 on an E item's operands: {n_bad} elements "
          f"beyond {BF16_SLICE_TOL}")
    fwd_shape = list(q.shape)
    q, k, v, mask, do = bwd_ops[0]
    bwd_err, bwd_ulps = 0.0, 0.0
    for name, g, w in zip(("dq", "dk", "dv"),
                          fa.fused_attention_backward(q, k, v, mask, do),
                          fa.fused_attention_backward_reference(
                              q, k, v, mask, do)):
        n_bad, e, u = bf16_slice_excess(g, w)
        check(n_bad == 0, f"(c) #3 {name} on a step's operands: {n_bad} "
              f"elements beyond {BF16_SLICE_TOL}")
        bwd_err, bwd_ulps = max(bwd_err, e), max(bwd_ulps, u)
    results["maxp"] = {
        **c, "schedule": "".join(loop.schedule_trace),
        "searches": searches(loop), "mining_searches_vs_scan": mined,
        "fused_forward_in_items": dict(in_items),
        "fused_forward_in_steps": step_fwd,
        "item_p50_ms": item_p50(loop),
        "refresh_sec": loop.history[0]["refresh_sec"],
        "path_forward": {"shape": fwd_shape, "max_abs_err": fwd_err,
                         "slice_ulps": fwd_ulps},
        "path_backward": {"shape": list(q.shape), "max_abs_err": bwd_err,
                          "slice_ulps": bwd_ulps}}
    print(f"ance-loop (c) MaxP bf16: {c['wall_s']:.1f} s; #2 launches "
          f"{dict(in_items)} in items + {step_fwd} in steps, #3 "
          f"{c['fused_backward']}; block-max {c['blockmax_kernels']}; #2 / "
          f"#3 on the path's operands within {BF16_SLICE_TOL} (max |err| "
          f"{fwd_err:.3g} / {bwd_err:.3g}); mining == scan in {mined} "
          f"searches; peak {c['peak_mem_gib']:.2f} GiB", flush=True)
    del loop, probes, fwd_ops, bwd_ops
    release()
    check(no_reference_modules(), "the port imported jax or ance_tpu")
    results["kernel_cases"] = kernel_cases
    return results


# DPR (NQ open-QA) at BERT-base width, as the runbook drives it
# (commands/run_train_dpr.sh, commands/run_ann_data_gen_dpr.sh): a
# psgs_w100.tsv-format corpus, the DPR question files and the test CSVs,
# made from a seed
DPR_PASSAGES = 8_192
DPR_WORDS = (90, 110)  # words a passage (psgs_w100's are 100)
DPR_LONG_EVERY = 97  # every 97th passage 320 words: cut to the sequence
DPR_TRAIN_Q, DPR_DEV_Q, DPR_TRIVIA_DEV_Q, DPR_TEST_Q = 128, 64, 32, 512
DPR_HARD_NEGATIVES = 3
DPR_SEQ, DPR_BATCH, DPR_LR = 256, 16, "1e-5"
DPR_TOPK, DPR_NEGATIVES = 200, 100  # --topk_training / --negative_sample
DPR_POLL_STEPS, DPR_EPOCHS, DPR_ACCUM = 4, 2, 2
DPR_EVAL_BATCH = 128
BERT_VOCAB, BERT_CLS, BERT_SEP = 30522, 101, 102
# the 21M capacity check: psgs_w100.tsv's row count, filled on the card
WIKI_ROWS = 21_015_324
CAPACITY_SLICE = 65_536
CAPACITY_SEARCHES = {"mining": (512, 200), "dev": (2048, 100)}
CAPACITY_SCAN_Q = 64  # queries of each capacity search held to a scan
CAPACITY_SEED = 21


class BertWordHashTokenizer:
    """:class:`WordHashTokenizer` in BERT's id space, with the pair
    encoding DPR's passages use: ``[CLS]`` 101, ``[SEP]`` 102, pad 0, words
    crc32-hashed into [1000, 30522) (clear of BERT's special ids);
    ``encode(text, text_pair=)`` gives ``[CLS] text [SEP] pair [SEP]``, cut
    to ``max_length`` where one is given (DPR's preprocessing cuts, and
    restores the SEP, itself)."""
    pad_token_id, sep_token_id = 0, BERT_SEP

    @staticmethod
    def _ids(text):
        import zlib
        return [1000 + zlib.crc32(w.encode(), WORD_HASH_SEED)
                % (BERT_VOCAB - 1000) for w in text.split()]

    def encode(self, text, text_pair=None, add_special_tokens=True,
               max_length=None):
        ids = [BERT_CLS] + self._ids(text) + [BERT_SEP]
        if text_pair is not None:
            ids += self._ids(text_pair) + [BERT_SEP]
        return ids[:max_length] if max_length is not None else ids


class BertWordHashFactory(WordHashFactory):
    """Stands in for ``cli.TokenizerFactory``; module level, so spawned
    workers unpickle it."""

    def __call__(self):
        return BertWordHashTokenizer()


def _write_raw_dpr(raw: Path, rs) -> dict:
    """psgs_w100.tsv (header, ids in psgs_w100's range, the text field
    quoted as the real file's is), nq-train / nq-dev / trivia-dev JSON in
    DPR's layout and nq-test / trivia-test CSVs. A question is 4-8 words of
    its positive passage; its answer another two words of that passage
    (so a passage that holds it is rarely another); two train entries
    without positives are dropped by preprocessing. Returns what the
    checks need."""
    import numpy as np
    raw.mkdir()
    words = np.array([f"t{i}" for i in range(WARMUP_VOCAB_WORDS)])
    pids = np.sort(rs.choice(WIKI_ROWS, DPR_PASSAGES, replace=False)) + 1
    lengths = rs.randint(DPR_WORDS[0], DPR_WORDS[1] + 1, DPR_PASSAGES)
    lengths[::DPR_LONG_EVERY] = 320
    texts = [" ".join(words[rs.randint(0, WARMUP_VOCAB_WORDS, n)])
             for n in lengths]
    titles = [" ".join(words[rs.randint(0, WARMUP_VOCAB_WORDS,
                                        rs.randint(1, 4))])
              for _ in range(DPR_PASSAGES)]
    with open(raw / "psgs_w100.tsv", "w") as f:
        f.write("id\ttext\ttitle\n")
        f.writelines(f'{p}\t"{t}"\t{h}\n'
                     for p, t, h in zip(pids, texts, titles))

    def question(key):
        pos = rs.randint(DPR_PASSAGES)
        toks = texts[pos].split()
        start = rs.randint(0, len(toks) - 8)
        q = " ".join(toks[start:start + rs.randint(4, 9)])
        a = rs.randint(0, len(toks) - 2)
        negs = [n for n in rs.choice(DPR_PASSAGES, DPR_HARD_NEGATIVES + 1,
                                     replace=False) if n != pos]
        return {"question": q + "?", "answers": [" ".join(toks[a:a + 2])],
                "positive_ctxs": [{key: str(pids[pos])}],
                "hard_negative_ctxs": [{key: str(pids[n])}
                                       for n in negs[:DPR_HARD_NEGATIVES]]}

    split = {}
    for name, key, n in (("nq-train", "passage_id", DPR_TRAIN_Q),
                         ("nq-dev", "passage_id", DPR_DEV_Q),
                         ("trivia-dev", "psg_id", DPR_TRIVIA_DEV_Q)):
        split[name] = [question(key) for _ in range(n)]
        dropped = [dict(question(key), positive_ctxs=[])
                   for _ in range(2 if name == "nq-train" else 0)]
        with open(raw / f"{name}.json", "w") as f:
            json.dump(split[name][:5] + dropped + split[name][5:], f)
    for name in ("nq-test", "trivia-test"):
        split[name] = [question("passage_id") for _ in range(DPR_TEST_Q)]
        with open(raw / f"{name}.csv", "w") as f:
            f.writelines(f"{s['question']}\t{s['answers']!r}\n"
                         for s in split[name])
    return {"pids": pids, "texts": texts, "titles": titles, **split}


def _check_dpr_preprocessed(data: Path, raw: dict) -> None:
    """Every 8th passage record (and every cut one) is the tokenizer's
    pair encoding of its row, cut to DPR_SEQ with the SEP restored; every
    train question's record and train-data line are its own."""
    import numpy as np
    from ance_tpu_torch.data import dpr
    from ance_tpu_torch.data.cache import TokenCache
    tok = BertWordHashTokenizer()
    pid2off, _ = dpr.load_mapping(str(data), "pid2offset")
    check(sorted(pid2off) == raw["pids"].tolist()
          and sorted(pid2off.values()) == list(range(DPR_PASSAGES)),
          "pid2offset does not map every passage id onto the rows")
    rows = sorted(set(range(0, DPR_PASSAGES, 8))
                  | set(range(0, DPR_PASSAGES, DPR_LONG_EVERY)))
    with TokenCache(str(data / "passages")) as pc:
        lengths, tokens = pc.batch([pid2off[int(raw["pids"][i])]
                                    for i in rows])
    for i, n, row in zip(rows, lengths, tokens):
        full, ids = dpr._encode_fixed(tok, DPR_SEQ, raw["titles"][i],
                                      raw["texts"][i])
        check(n == min(full, DPR_SEQ) and row.tolist() == ids,
              f"passage record {i} is not its row's pair encoding")
    check(any(dpr._encode_fixed(tok, DPR_SEQ, raw["titles"][i],
                                raw["texts"][i])[0] > DPR_SEQ for i in rows),
          "no passage was cut to the sequence")
    with TokenCache(str(data / "train-query")) as qc:
        lengths, tokens = qc.batch(np.arange(DPR_TRAIN_Q))
    lines = (data / "train-data").read_text().splitlines()
    check(len(lines) == DPR_TRAIN_Q, f"{len(lines)} train-data lines")
    for qid, (s, n, row, line) in enumerate(zip(raw["nq-train"], lengths,
                                               tokens, lines)):
        full, ids = dpr._encode_fixed(tok, DPR_SEQ,
                                      dpr.normalize_question(s["question"]))
        pos = pid2off[int(s["positive_ctxs"][0]["passage_id"])]
        negs = ",".join(str(pid2off[int(c["passage_id"])])
                        for c in s["hard_negative_ctxs"])
        check(n == full and row.tolist() == ids
              and line == f"{qid}\t{pos}\t{negs}",
              f"train question {qid}: record or train-data line not its own")


def _reset_attention_counts() -> None:
    from ance_tpu_torch.ops import fused_attention as fa
    for f in (fa.fused_attention, fa.fused_attention_backward):
        f.launches = 0
        f.kernel_launches.clear()


def _attention_counts() -> tuple[dict, dict]:
    from ance_tpu_torch.ops import fused_attention as fa
    return (dict(fa.fused_attention.kernel_launches),
            dict(fa.fused_attention_backward.kernel_launches))


def _attention_on_operands(fwd: dict, bwd: dict, what: str) -> dict:
    """#2 (and #3) against their plain versions on the operands recorded
    on a path (DPR's, SEED's): bf16 per element within BF16_SLICE_TOL; the fp32
    forward within 1e-4 of plain, the fp32 backward within 1e-5 of the
    function in fp64 (FP32_BACKWARD_YARDSTICK), each beside both
    distances to the fp64 function."""
    import torch
    from ance_tpu_torch.ops import fused_attention as fa
    out = {"forward": [], "backward": []}
    for i, (q, k, v, mask) in sorted(fwd.items()):
        got = fa.fused_attention_forward(q, k, v, mask)
        plain = fa.fused_attention_reference(q, k, v, mask)
        case = {"call": i, "shape": list(q.shape), "dtype": str(q.dtype),
                "kernel": fa.fused_kernel_for(q, k, v),
                "max_abs_err": (got - plain).abs().max().item()}
        if q.dtype == torch.bfloat16:
            n_bad, _, case["slice_ulps"] = bf16_slice_excess(got, plain)
            check(n_bad == 0, f"{what}: #2 call {i} {list(q.shape)}: {n_bad} "
                  f"elements beyond {BF16_SLICE_TOL}")
        else:
            case.update(exact_errors(got, plain,
                                     exact_in_rows(q, k, v, mask), mask))
            check(case["max_abs_err"] <= 1e-4, f"{what}: #2 call {i}: max "
                  f"|kernel - plain| {case['max_abs_err']} > 1e-4")
        out["forward"].append(case)
    for i, (q, k, v, mask, do) in sorted(bwd.items()):
        if q.dtype == torch.float32:  # FP32_BACKWARD_YARDSTICK
            got = fa.fused_attention_backward(q, k, v, mask, do)
            plain = fa.fused_attention_backward_reference(q, k, v, mask, do)
            case = {"call": i, "shape": list(q.shape),
                    "kernel": fa.fused_kernel_for(q, k, v, backward=True),
                    "max_abs_err": max((g - w).abs().max().item()
                                       for g, w in zip(got, plain))}
            case.update(exact_errors(
                got, plain, exact_in_rows(q, k, v, mask, do), mask))
            check(case["kernel_vs_exact"] <= 1e-5, f"{what}: #3 call {i}: "
                  f"max |kernel - fp64 function| {case['kernel_vs_exact']} "
                  "> 1e-5")
            out["backward"].append(case)
            continue
        errs, ulps = [], []
        for name, g, w in zip(("dq", "dk", "dv"),
                              fa.fused_attention_backward(q, k, v, mask, do),
                              fa.fused_attention_backward_reference(
                                  q, k, v, mask, do)):
            n_bad, e, u = bf16_slice_excess(g, w)
            check(n_bad == 0, f"{what}: #3 {name} call {i} {list(q.shape)}: "
                  f"{n_bad} elements beyond {BF16_SLICE_TOL}")
            errs.append(e)
            ulps.append(u)
        out["backward"].append({"call": i, "shape": list(q.shape),
                                "kernel": fa.fused_kernel_for(
                                    q, k, v, backward=True),
                                "max_abs_err": max(errs),
                                "slice_ulps": max(ulps)})
    torch.cuda.empty_cache()
    return out


def _capacity_21m(quantize: str, queries, scale: float) -> dict:
    """A FlatIPIndex of psgs_w100's WIKI_ROWS x 768 rows, filled slice by
    slice on the card from seeded randn (times ``scale``, the DPR passage
    embeddings' RMS), beside the resident encoder: the mining search (Q=512
    k=200) and the dev search (Q=2048 k=100), each one ``index.search``
    through #1, which splits its queries only as far as the memory left
    beside the index needs (one launch a group of
    ``topk.query_group_rows``); the first CAPACITY_SCAN_Q of each held to a
    scan of the same index. An index that does not fit fails the phase,
    its bytes printed."""
    import torch
    from ance_tpu_torch.index.flat import FlatIPIndex

    def fill(s, n):
        g = torch.Generator(device="cuda").manual_seed(CAPACITY_SEED + s)
        return torch.randn((n, DIM), generator=g, device="cuda") * scale

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    index = FlatIPIndex(DIM, device="cuda", chunk_rows=131_072,
                        quantize="dims" if quantize == "dims" else False)
    starts = range(0, WIKI_ROWS, CAPACITY_SLICE)
    rows = -(-WIKI_ROWS // CAPACITY_SLICE) * CAPACITY_SLICE
    need = rows * DIM * (1 if quantize == "dims" else 4)
    t0 = time.perf_counter()
    scales = None
    if quantize == "dims":  # the corpus-global per-dimension maxima
        amax = torch.zeros(DIM, device="cuda")
        for s in starts:
            amax = torch.maximum(amax, fill(s, min(CAPACITY_SLICE,
                                                   WIKI_ROWS - s))
                                 .abs().amax(0))
        scales = amax.clamp_min(1e-12) / 127.0
    try:
        index.allocate(WIKI_ROWS, DIM, slice_rows=CAPACITY_SLICE,
                       scales=scales)
    except torch.cuda.OutOfMemoryError:
        free, total = torch.cuda.mem_get_info()
        raise AssertionError(
            f"21M {quantize} index: {need} bytes ({need / 2**30:.2f} GiB) do "
            f"not fit beside the encoder's {base} bytes ({free} of {total} "
            "free)") from None
    for s in starts:
        index.update_slice(s, fill(s, min(CAPACITY_SLICE, WIKI_ROWS - s)))
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    resident = torch.cuda.memory_allocated()
    out = {"quantize": quantize, "rows": WIKI_ROWS, "index_bytes": need,
           "fill_s": fill_s, "resident_gib": resident / 2**30,
           "searches": {}}
    kernel = "blockmax_pieces_int8" if quantize == "dims" \
        else "blockmax_pieces_f32"
    for name, (Q, k) in CAPACITY_SEARCHES.items():
        q = queries[:Q]
        index.method = "auto"
        reset_blockmax_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids = index.search(q, k)[1]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = blockmax_counts()
        check(set(launches) == {kernel}
              and 1 <= launches[kernel] <= -(-Q // 64),
              f"21M {quantize} {name}: block-max launches {launches}")
        index.method = "scan"
        _, scan = index.search(q[:CAPACITY_SCAN_Q], k)
        same = (scan == ids[:CAPACITY_SCAN_Q]).float().mean().item()
        check(same == 1.0, f"21M {quantize} {name}: ids equal the scan on "
              f"{same:.6f} of the sampled positions")
        out["searches"][name] = {"Q": Q, "k": k, "ms": ms,
                                 "launches": launches[kernel]}
        del ids, scan
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"21M capacity, {quantize} index: {WIKI_ROWS} x {DIM} "
          f"({need / 2**30:.2f} GiB) filled in {fill_s:.1f} s beside "
          f"{base / 2**30:.2f} GiB resident; searches "
          f"{ {n: round(s['ms'], 1) for n, s in out['searches'].items()} } "
          f"ms ({kernel} launches "
          f"{ {n: s['launches'] for n, s in out['searches'].items()} }); "
          f"the first "
          f"{CAPACITY_SCAN_Q} queries of each == a scan; peak "
          f"{out['peak_gib']:.2f} GiB", flush=True)
    del index
    torch.cuda.empty_cache()
    return out


def phase_dpr(work: Path):
    """DPR through the port's CLI in process at BERT-base width (two seeded
    towers, seq 256), as its runbook drives it: ``preprocess-dpr`` over
    PREPROCESS_WORKERS spawned workers; a polling ``train --ann_dir`` at
    the default dropout (attention dropout 0.1 takes the einsum path in
    both packages, ``ance_tpu/ops/attention.py:102-103``, so no #2 or #3
    launch); ``train --num_epoch 2 --dev_data`` with attention dropout 0
    and ``--gradient_accumulation_steps 2`` (#2 and #3 at S = 256 inside
    the GradCache step), and the GradCache loss against an unaccumulated
    step on one batch; ``generate-dpr`` in bf16, at the CLI's fp32 and
    over a ``dims`` index (#1 once a search; mining and the test hit
    curve held to a scan); ``export-hf --model_type dpr``; each kernel on
    the operands its path gave it; then the 21M-passage capacity check
    beside the resident encoder. Every path's launches are counted from 0
    just before it and read just after."""
    import numpy as np
    import torch
    from ance_tpu_torch import cli
    from ance_tpu_torch.data import dpr
    from ance_tpu_torch.data.cache import TokenCache
    from ance_tpu_torch.data.feed import parse_triple_line
    from ance_tpu_torch.evaluation.qa_validation import has_answer
    from ance_tpu_torch.index import flat
    from ance_tpu_torch.models.registry import get_model_spec
    from ance_tpu_torch.models.weights import load_weights
    from ance_tpu_torch.train import checkpoint as ckpt
    from ance_tpu_torch.train import dpr_gen, dpr_trainer, trainer
    from ance_tpu_torch.train.encode import make_encode_fn

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # argmax ties (the in-batch loss's correct count): the first maximum
    # on the card too, as on the CPU and in jnp.argmax
    rs = np.random.RandomState(0)
    for shape in ((512, 1024), (4, 300_001)):
        scores = rs.randint(0, 3, shape).astype(np.float32)
        got = torch.argmax(torch.as_tensor(scores, device="cuda"), 1)
        check(got.cpu().numpy().tolist() == scores.argmax(1).tolist(),
              f"torch.argmax on the card does not take the first of equal "
              f"maxima at {shape}")
    raw_dir, data = work / "dpr_raw", work / "dpr_data"
    raw = _write_raw_dpr(raw_dir, np.random.RandomState(15))
    weights = work / "dpr_bert_base_seeded"
    weights.mkdir()
    torch.save(get_model_spec("dpr").build(seed=0).state_dict(),
               weights / "pytorch_model.bin")
    seq = ["--max_seq_length", str(DPR_SEQ), "--max_query_length",
           str(DPR_SEQ)]
    model_flags = ["--device", "cuda", "--model_type", "dpr",
                   "--model_name_or_path", str(weights), *seq]
    train_flags = ["train", *model_flags, "--bf16", "--data_dir", str(data),
                   "--per_device_train_batch_size", str(DPR_BATCH),
                   "--optimizer", "lamb", "--learning_rate", DPR_LR,
                   "--warmup_steps", "4"]

    def no_tokenizer(name, model_dir):
        raise OSError(f"no tokenizer files in {model_dir}")

    real = {"factory": cli.TokenizerFactory, "tokenizer": cli._load_tokenizer,
            "make": cli._make_training, "gen": dpr_gen.generate_new_ann_dpr,
            "topk": flat.topk_blockmax}
    step_ms, results, searched = [], [], []

    def make_training(*args, **kwargs):
        state, step = real["make"](*args, **kwargs)

        def timed(state, batch, generator):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch, generator)
            float(metrics["loss"])
            step_ms.append((time.perf_counter() - t0) * 1e3)
            return state, metrics
        return state, timed

    def keep(*args, **kwargs):
        results.append(real["gen"](*args, **kwargs))
        return results[-1]

    def recorded(queries, corpus, **kwargs):
        searched.append((queries, corpus))
        return real["topk"](queries, corpus, **kwargs)

    cli.TokenizerFactory, cli._load_tokenizer = BertWordHashFactory, \
        no_tokenizer
    cli._make_training = make_training
    dpr_gen.generate_new_ann_dpr, flat.topk_blockmax = keep, recorded
    try:
        # 1. preprocess-dpr over spawned workers
        t0 = time.perf_counter()
        counts = _cli(["preprocess-dpr", "--model_type", "dpr", "--wiki_dir",
                       str(raw_dir), "--question_dir", str(raw_dir),
                       "--answer_dir", str(raw_dir), "--out_data_dir",
                       str(data), "--max_seq_length", str(DPR_SEQ),
                       "--num_processes", str(PREPROCESS_WORKERS)])
        pre_s = time.perf_counter() - t0
        check(counts == {"pid2offset": DPR_PASSAGES, "train": DPR_TRAIN_Q,
                         "dev": DPR_DEV_Q, "dev_trivia": DPR_TRIVIA_DEV_Q,
                         "test": DPR_TEST_Q, "test_trivia": DPR_TEST_Q},
              f"preprocess-dpr counts {counts}")
        _check_dpr_preprocessed(data, raw)
        print(f"preprocess-dpr: {DPR_PASSAGES} passages (title + text pairs "
              f"at seq {DPR_SEQ}), {counts} over {PREPROCESS_WORKERS} "
              f"spawned workers in {pre_s:.2f} s; records == the "
              "tokenizer's, the two entries without positives dropped",
              flush=True)

        # 2. the polling trainer at the default dropout: the einsum path
        ann0 = work / "dpr_ann0"
        ann0.mkdir()
        shutil.copy(data / "train-data", ann0 / "ann_training_data_0")
        (ann0 / "ann_ndcg_0").write_text(json.dumps({"top20": 0.0}))
        _reset_attention_counts()
        step_ms.clear()
        poll = _cli([*train_flags, "--ann_dir", str(ann0), "--output_dir",
                     str(work / "dpr_poll"), "--max_steps",
                     str(DPR_POLL_STEPS), "--save_steps",
                     str(DPR_POLL_STEPS)])
        poll_launches = _attention_counts()
        check(poll_launches == ({}, {}), "polling DPR train at attention "
              f"dropout 0.1 launched #2 / #3 {poll_launches}")
        check(poll["steps"] == DPR_POLL_STEPS
              and all(math.isfinite(x) for x in poll["loss"]),
              f"polling DPR train: {poll}")
        m = get_model_spec("dpr").build()
        ckpt.load_params(poll["checkpoint"], m)  # strict
        poll_ms = statistics.median(step_ms[1:])
        print(f"train dpr --ann_dir: {DPR_POLL_STEPS} steps of batch "
              f"{DPR_BATCH} at the default dropout, losses "
              f"{[round(x, 4) for x in poll['loss']]}, step {poll_ms:.1f} ms "
              "(median after the first); #2 / #3 launches 0: attention "
              "dropout 0.1 takes the einsum path, the JAX package's rule "
              f"(not a fallback); {poll['checkpoint']} loads strictly",
              flush=True)

        # 3. train --num_epoch 2 --dev_data: the GradCache step, #2 and #3
        fwd_ops, bwd_ops = {}, {}
        _reset_attention_counts()
        step_ms.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with picked_calls("forward", (0, 12), fwd_ops), \
                picked_calls("backward", (0, 12), bwd_ops):
            epochs = _cli([*train_flags, "--num_epoch", str(DPR_EPOCHS),
                           "--dev_data", str(data / "dev-data"),
                           "--gradient_accumulation_steps", str(DPR_ACCUM),
                           "--encoder_overrides",
                           '{"attention_dropout": 0.0}', "--output_dir",
                           str(work / "dpr_ckpt")])
        torch.cuda.synchronize()
        epochs_s = time.perf_counter() - t0
        train_peak = torch.cuda.max_memory_allocated() / 2**30
        train_fwd, train_bwd = _attention_counts()
        steps = DPR_EPOCHS * (DPR_TRAIN_Q // DPR_BATCH)
        towers = 2 * 12  # two towers of 12 layers a pass
        dev_passes = DPR_EPOCHS * (DPR_DEV_Q // DPR_BATCH)
        want_fwd = steps * 2 * DPR_ACCUM * towers + dev_passes * towers
        want_bwd = steps * DPR_ACCUM * towers
        check(train_fwd == {"fused_fwd_bf16": want_fwd}
              and train_bwd == {"fused_bwd_bf16": want_bwd},
              f"train dpr --num_epoch: #2 {train_fwd} / #3 {train_bwd}, not "
              f"{want_fwd} / {want_bwd} (each micro-batch encoded twice, "
              "the dev passes once)")
        history = epochs["history"]
        check([(h["epoch"], h["step"]) for h in history]
              == [(e, (e + 1) * steps // DPR_EPOCHS)
                  for e in range(DPR_EPOCHS)]
              and all(math.isfinite(h["loss"]) and math.isfinite(h["dev_nll"])
                      and 0.0 <= h["dev_correct_ratio"] <= 1.0
                      for h in history), f"train dpr history {history}")
        final = str(work / "dpr_ckpt" / f"checkpoint-{steps}")
        m = get_model_spec("dpr").build()
        ckpt.load_params(final, m)  # strict
        dpr_step_ms = statistics.median(step_ms[TIMED_FROM:])
        print(f"train dpr --num_epoch {DPR_EPOCHS} --dev_data, accumulation "
              f"{DPR_ACCUM} (GradCache): {steps} steps in {epochs_s:.1f} s, "
              f"step {dpr_step_ms:.1f} ms (median after the first "
              f"{TIMED_FROM}); history {history}; #2 {train_fwd}, #3 "
              f"{train_bwd}; peak {train_peak:.2f} GiB; {final} loads "
              "strictly", flush=True)
        # calls 0 and 12 of each direction: one from each tower, whose
        # micro-batches differ in rows (queries m, contexts 2m)
        check(all(sorted(ops[0].shape[0] for ops in kept.values())
                  == [DPR_BATCH // DPR_ACCUM, 2 * DPR_BATCH // DPR_ACCUM]
                  for kept in (fwd_ops, bwd_ops)),
              "train dpr: the recorded #2 / #3 calls are not one a tower")
        train_path = _attention_on_operands(fwd_ops, bwd_ops,
                                                "train dpr")
        del fwd_ops, bwd_ops

        # 4. the GradCache step against the unaccumulated one on one batch
        #    (fp32, dropout off, no clipping, lr 0): the CPU test's bounds on
        #    the loss, correct, the gradient norm and every gradient; the
        #    GradCache step's fp32 #2 / #3 launches counted from 0 and its
        #    first forward and backward held to plain
        gc, grads = {}, {}
        model = get_model_spec("dpr").build(config_overrides={
            "hidden_dropout": 0.0, "attention_dropout": 0.0})
        ckpt.load_params(final, model)
        model = model.to("cuda")
        with TokenCache(str(data / "train-query")) as qc, \
                TokenCache(str(data / "passages")) as pc:
            batch = next(dpr_trainer.dpr_dev_batches(
                qc, pc, str(data / "train-data"), DPR_BATCH))
        gc_fwd, gc_bwd = {}, {}
        for accum in (1, DPR_ACCUM):
            state = trainer.init_train_state(model, trainer.make_optimizer(
                model, "lamb", 0.0, max_grad_norm=0.0))
            _reset_attention_counts()
            with picked_calls("forward", (0,) if accum > 1 else (), gc_fwd), \
                    picked_calls("backward", (0,) if accum > 1 else (),
                                 gc_bwd):
                _, metrics = dpr_trainer.make_dpr_train_step(accum)(
                    state, batch, torch.Generator().manual_seed(0))
            torch.cuda.synchronize()
            gc[accum] = {k: float(v) for k, v in metrics.items()}
            gc[accum]["launches"] = _attention_counts()
            grads[accum] = {n: p.grad.clone()
                            for n, p in model.named_parameters()}
            del state
        passes = 2 * 12  # two towers of 12 layers
        check(gc[DPR_ACCUM]["launches"]
              == ({"flash_fwd_pieces": 2 * DPR_ACCUM * passes},
                  {"fused_bwd_pieces": DPR_ACCUM * passes}),
              f"GradCache fp32 step: #2 / #3 launches "
              f"{gc[DPR_ACCUM]['launches']}, not each micro-batch encoded "
              "twice and pulled back once on the pieces routes")
        rel = abs(gc[DPR_ACCUM]["loss"] - gc[1]["loss"]) / abs(gc[1]["loss"])
        norm_rel = abs(gc[DPR_ACCUM]["grad_norm"] - gc[1]["grad_norm"]) \
            / gc[1]["grad_norm"]
        # the CPU test's element bound (atol 1e-6 + rtol 1e-5) does not
        # hold at full width: the context tower's embedding gradients sum
        # 8,192 token rows in fp32, in another order when the two
        # micro-batches' sums are added (worst element 26.6x outside it,
        # PERF.md). Each tensor is held normwise instead; a fault in the
        # pull-back (rows, masks, a micro-batch) moves a tensor by O(1).
        total = math.sqrt(sum(g.norm().item() ** 2 for g in grads[1].values()))
        per_tensor = sorted(
            ((grads[DPR_ACCUM][n] - g).norm().item()
             / (1e-4 * g.norm().item() + 1e-6 * total), n)
            for n, g in grads[1].items())
        grad_excess, worst_tensor = per_tensor[-1]
        element_excess = max(
            ((grads[DPR_ACCUM][n] - g).abs() / (1e-6 + 1e-5 * g.abs()))
            .max().item() for n, g in grads[1].items())
        # the yardstick: the unaccumulated step in fp64 (the einsum
        # attention: no kernel takes fp64); each fp32 step's distance from
        # it, against the element bound and normwise (_fp64_distances)
        model64 = get_model_spec("dpr").build(
            dtype=torch.float64, attention_impl="xla", config_overrides={
                "hidden_dropout": 0.0, "attention_dropout": 0.0})
        ckpt.load_params(final, model64)
        model64 = model64.double().to("cuda")
        gc64, g64 = _raw_grads(model64, batch, 1, False)
        vs64 = {a: _fp64_distances(grads[a], g64) for a in (1, DPR_ACCUM)}
        del model64, g64
        torch.cuda.empty_cache()
        check(rel <= 1e-6 and gc[DPR_ACCUM]["correct"] == gc[1]["correct"]
              and norm_rel <= 1e-5 and grad_excess <= 1.0,
              f"GradCache on the card: {gc[DPR_ACCUM]} against the "
              f"unaccumulated step's {gc[1]} (loss rel {rel}, grad norm rel "
              f"{norm_rel}, {worst_tensor} at {grad_excess} of its bound)")
        gc_path = _attention_on_operands(gc_fwd, gc_bwd,
                                             "GradCache fp32 step")
        print(f"GradCache (accumulation {DPR_ACCUM}) vs one pass, fp32, one "
              f"batch of {DPR_BATCH}: loss {gc[DPR_ACCUM]['loss']!r} / "
              f"{gc[1]['loss']!r} (rel {rel:.3g}, bound 1e-6), correct "
              f"{gc[DPR_ACCUM]['correct']:.0f} / {gc[1]['correct']:.0f}, grad "
              f"norm {gc[DPR_ACCUM]['grad_norm']:.9g} / "
              f"{gc[1]['grad_norm']:.9g} (rel {norm_rel:.3g}, bound 1e-5), "
              f"every gradient tensor within 1e-4 of its norm + 1e-6 of the "
              f"whole gradient's (worst {worst_tensor} at "
              f"{grad_excess:.3g} of it; the CPU test's element bound "
              f"exceeded {element_excess:.3g}x); against the fp64 step "
              f"(loss {gc64['loss']!r}): one pass element "
              f"{vs64[1]['element_excess']:.3g}x the bound "
              f"({vs64[1]['element_worst']}), normwise "
              f"{vs64[1]['normwise_excess']:.3g}; GradCache element "
              f"{vs64[DPR_ACCUM]['element_excess']:.3g}x "
              f"({vs64[DPR_ACCUM]['element_worst']}), normwise "
              f"{vs64[DPR_ACCUM]['normwise_excess']:.3g}; #2 / #3 launches "
              f"{gc[DPR_ACCUM]['launches']}; its first forward and backward "
              f"against plain {gc_path}", flush=True)
        del model, batch, grads, gc_fwd, gc_bwd
        torch.cuda.empty_cache()

        # 5. generate-dpr: bf16, the CLI's fp32, and a dims index
        pid2offset, _ = dpr.load_mapping(str(data), "pid2offset")
        texts = {pid2offset[p]: t for p, t in dpr.load_passage_texts(
            str(raw_dir / "psgs_w100.tsv")).items()}
        test_answers = dpr.load_qas_answers(str(raw_dir / "nq-test.csv"))
        train_answers = dpr.load_answers(str(data / "train-ann"))
        n_query_batches = sum(-(-n // DPR_EVAL_BATCH) for n in (
            DPR_TRAIN_Q, DPR_TEST_Q, DPR_TEST_Q))
        gen_fwd = towers // 2 * (n_query_batches
                                 + DPR_PASSAGES // DPR_EVAL_BATCH)
        gens = {}
        kernel_cases = []
        for name, extra, dtypes in (
                ("dpr_generate", ["--bf16"], "f32xf32"),
                ("dpr_generate_fp32", [], "f32xf32"),
                ("dpr_generate_dims", ["--bf16", "--index_quantize", "dims"],
                 "f32xint8")):
            out = work / name
            fwd_ops = {}
            _reset_attention_counts()
            reset_blockmax_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with picked_calls("forward", (0, 12 * n_query_batches), fwd_ops):
                summary = _cli(["generate-dpr", *model_flags, *extra,
                                "--data_dir", str(data), "--wiki_path",
                                str(raw_dir / "psgs_w100.tsv"),
                                "--test_qas", str(raw_dir / "nq-test.csv"),
                                "--trivia_qas",
                                str(raw_dir / "trivia-test.csv"),
                                "--training_dir", str(work / "dpr_ckpt"),
                                "--output_dir", str(out), "--topk_training",
                                str(DPR_TOPK), "--negative_sample",
                                str(DPR_NEGATIVES),
                                "--per_device_eval_batch_size",
                                str(DPR_EVAL_BATCH)])
            torch.cuda.synchronize()
            gen_s = time.perf_counter() - t0
            blockmax = blockmax_counts()
            fused, _ = _attention_counts()
            result = results.pop()
            route = "fused_fwd_bf16" if "--bf16" in extra \
                else "flash_fwd_pieces"
            kernel = ROUTE_KERNEL[dtypes]
            check(blockmax == {kernel: 3}, f"{name}: block-max {blockmax}, "
                  f"not {kernel} once a search (test, trivia, mining)")
            check(fused == {route: gen_fwd}, f"{name}: #2 {fused}, not "
                  f"{gen_fwd} on {route}")
            check(summary["checkpoint"] == final, f"{name} loaded "
                  f"{summary['checkpoint']}, not {final}")
            side = json.loads((out / "ann_ndcg_0").read_text())
            check(set(side) == {"top20", "top100", "top20_trivia",
                                "top100_trivia", "checkpoint"}
                  and (out / "ann_ndcg_0").stat().st_mtime_ns
                  >= (out / "ann_training_data_0").stat().st_mtime_ns,
                  f"{name}: sidecar {side}")
            index = result["index"]
            check(index.quantize == ("dims" if "dims" in extra else None),
                  f"{name}: a {index.quantize} index")
            index.method = "scan"
            _, scan = index.search(result["train_query_embedding"], DPR_TOPK)
            same = (scan.cpu().numpy() == result["train_neighbor_ids"]).mean()
            check(same == 1.0, f"{name}: mining ids equal the scan on "
                  f"{same:.6f} of positions")
            _, scan_test = index.search(result["test_query_embedding"], 100)
            scan_hits = dpr_gen.validate(
                texts, test_answers, scan_test.cpu().numpy(),
                np.arange(DPR_TEST_Q), result["passage_embedding2id"])
            check(scan_hits == result["top_k_hits"], f"{name}: the top-k hit "
                  "curve of the kernel search is not the scan's")
            lines = (out / "ann_training_data_0").read_text().splitlines()
            for line in lines:
                qid, pos, negs = parse_triple_line(line)
                check(pos not in negs and len(negs) <= DPR_NEGATIVES
                      and not any(has_answer(train_answers[qid], texts[n][0])
                                  for n in negs),
                      f"{name}: bad mined line {line[:80]!r}")
            secs = result["seconds"]
            gens[name] = {
                "s": gen_s, "seconds": secs, "blockmax_kernels": blockmax,
                "fused_forward": fused, "lines": len(lines),
                "encode_passages_per_s":
                    DPR_PASSAGES / secs["encode_passages"],
                "search_ms": {k[7:]: v * 1e3 for k, v in secs.items()
                              if k.startswith("search_")},
                **{k: side[k] for k in ("top20", "top100", "top20_trivia",
                                        "top100_trivia")}}
            print(f"generate-dpr {' '.join(extra) or '(fp32)'}: {gen_s:.1f} s "
                  f"(encode {DPR_PASSAGES} passages at "
                  f"{gens[name]['encode_passages_per_s']:.0f} passages/s); "
                  f"search ms {gens[name]['search_ms']}; block-max "
                  f"{blockmax}, #2 {fused}; top20 / top100 {side['top20']} / "
                  f"{side['top100']} (trivia {side['top20_trivia']} / "
                  f"{side['top100_trivia']}); {len(lines)} mined lines, no "
                  f"negative holds an answer; mining ids and the test hit "
                  f"curve == the scan's", flush=True)
            gens[name]["path_forward"] = _attention_on_operands(
                fwd_ops, {}, name)["forward"]
            if name == "dpr_generate":
                test_queries = result["test_query_embedding"]
            del index, scan, scan_test, fwd_ops, result
            kernel_cases += phase1_against_plain(
                searched, dtypes, name, ("test", "trivia", "mining"))
        torch.cuda.empty_cache()

        # 6. export-hf --model_type dpr: the model_dict loads strictly into a
        #    fresh BiEncoder and encodes bit for bit as the checkpoint does
        export = work / "dpr_export"
        exported = _cli(["export-hf", "--model_type", "dpr",
                         "--training_dir", str(work / "dpr_ckpt"),
                         "--out_dir", str(export)])
        check(exported["step"] == steps and exported["exported"]
              == str(export / f"checkpoint-{steps}"), f"export: {exported}")
        state_file = torch.load(exported["exported"], weights_only=True)
        check(state_file["offset"] == steps
              and all(f"{t}.pooler.dense.weight" in state_file["model_dict"]
                      for t in ("question_model", "ctx_model")),
              "the export is not a CheckpointState of the step")
        with TokenCache(str(data / "passages")) as pc, \
                TokenCache(str(data / "test-query")) as tc:
            p_ids = torch.as_tensor(pc.batch(np.arange(64))[1]).long()
            q_ids = torch.as_tensor(tc.batch(np.arange(64))[1]).long()
        embs = []
        for source in ("export", "checkpoint"):
            m = get_model_spec("dpr").build(dtype=torch.bfloat16)
            if source == "export":
                load_weights(m, state_file["model_dict"])  # strict
            else:
                ckpt.load_params(final, m)
            m = m.to("cuda")
            embs.append([make_encode_fn(m, method, "cuda")(ids, ids != 0)
                         for method, ids in ((type(m).query_emb, q_ids),
                                             (type(m).body_emb, p_ids))])
            del m
        check(all(torch.equal(a, b) for a, b in zip(*embs)),
              "the export's embeddings are not bit-equal to the checkpoint's")
        print(f"export-hf --model_type dpr: {exported['exported']} (offset "
              f"{steps}); its model_dict loads strictly into a fresh "
              "BiEncoder, query and passage embeddings bit-equal on 64 rows",
              flush=True)
        del embs, state_file
    finally:
        cli.TokenizerFactory = real["factory"]
        cli._load_tokenizer = real["tokenizer"]
        cli._make_training = real["make"]
        dpr_gen.generate_new_ann_dpr = real["gen"]
        flat.topk_blockmax = real["topk"]
    phase_peak = torch.cuda.max_memory_allocated() / 2**30

    # 7. 21M passages on one card, the encoder resident
    encoder = get_model_spec("dpr").build(dtype=torch.bfloat16)
    ckpt.load_params(final, encoder)
    encoder = encoder.to("cuda")
    with torch.inference_mode():
        passages = make_encode_fn(encoder, type(encoder).body_emb, "cuda")(
            p_ids, p_ids != 0)
    scale = passages.pow(2).mean().sqrt().item()
    queries = torch.cat([test_queries] * 4)[:2048]
    del test_queries, passages
    capacity = {q: _capacity_21m(q, queries, scale) for q in ("dims", "fp32")}
    del encoder, queries
    torch.cuda.empty_cache()
    check(no_reference_modules(), "the port imported jax or ance_tpu")
    return {"preprocess_s": pre_s, "poll_steps": poll["steps"],
            "poll_step_ms": poll_ms, "poll_launches": poll_launches,
            "train_steps": steps, "train_step_ms": dpr_step_ms,
            "train_steps_ms": list(step_ms), "train_s": epochs_s,
            "train_history": history, "train_peak_gib": train_peak,
            "train_fused_forward": train_fwd,
            "train_fused_backward": train_bwd, "train_path": train_path,
            "gradcache_vs_one_pass": gc, "gradcache_loss_rel": rel,
            "gradcache_grad_norm_rel": norm_rel,
            "gradcache_worst_tensor": [worst_tensor, grad_excess],
            "gradcache_worst_element_vs_cpu_bound": element_excess,
            "gradcache_fp64": gc64, "gradcache_against_fp64": vs64,
            "gradcache_path": gc_path,
            "generate": gens, "kernel_cases": kernel_cases,
            "phase_peak_gib": phase_peak, "capacity_21m": capacity}


SEED_VOCAB_LINES = 32_768  # vocab.txt; SeedTokenizer's <mask> makes 32,769
SEED_WORDS = 20_000  # t0 .. t19999 whole; t20000 .. split into t2000 + ##d
SEED_SEQ, SEED_BATCH, SEED_STEPS = 512, 16, 8  # seed-pretrain
SEED_PRETRAIN_ROWS = SEED_BATCH * SEED_STEPS
SEED_DECODE_BATCH, SEED_DECODE_STEPS = 16, 32
SEED_TRAIN_BATCH, SEED_TRAIN_STEPS = 32, 8
SEED_PARITY_BATCH, SEED_PARITY_SEQ, SEED_PARITY_STEPS = 2, 256, 3
CHECK_WORKERS = 8  # forked processes for the Python tokenizer's check


def _write_seed_vocab(path: Path, rs) -> list[str]:
    """``vocab.txt`` of SEED_VOCAB_LINES lines from a seed: ``[PAD] [UNK]
    [CLS] [SEP] [MASK]``, the raw corpus's words t0 .. t{SEED_WORDS-1}
    (the rest of its words split into a prefix and a ``##`` digit), the
    ten ``##`` digits, then seeded six-letter words, every third a ``##``
    piece."""
    import numpy as np
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    vocab += [f"t{i}" for i in range(SEED_WORDS)]
    vocab += [f"##{d}" for d in range(10)]
    seen = set(vocab)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    while len(vocab) < SEED_VOCAB_LINES:
        word = "".join(rs.choice(letters, 6))
        word = ("##" + word) if len(vocab) % 3 == 0 else word
        if word not in seen:
            seen.add(word)
            vocab.append(word)
    path.mkdir()
    (path / "vocab.txt").write_text("\n".join(vocab) + "\n")
    return vocab


_PYTHON_TOKENIZER = None


def _python_ids(job):
    """A forked worker's share of the records check: the port's Python
    WordPiece path (no C++ core) on each text, cut to ``max_length``."""
    texts, max_length = job
    return [_PYTHON_TOKENIZER.encode(t, max_length=max_length)
            for t in texts]


def _seed_preprocess_ids(vocab_dir: Path, texts: list, max_length: int):
    """Every text's ids on the Python path, over CHECK_WORKERS forked
    processes (the parent holds a CUDA context; the children only run
    Python)."""
    import multiprocessing
    from ance_tpu_torch.data.wordpiece import WordPieceTokenizer
    global _PYTHON_TOKENIZER
    _PYTHON_TOKENIZER = WordPieceTokenizer.from_vocab_file(vocab_dir,
                                                           native=False)
    check(_PYTHON_TOKENIZER.core == "python", "not the Python path")
    step = -(-len(texts) // CHECK_WORKERS)
    jobs = [(texts[i:i + step], max_length)
            for i in range(0, len(texts), step)]
    with multiprocessing.get_context("fork").Pool(CHECK_WORKERS) as pool:
        return [ids for part in pool.map(_python_ids, jobs) for ids in part]


def _write_seed_pretrain_cache(path: Path, rs) -> None:
    """SEED_PRETRAIN_ROWS rows at SEED_SEQ in the vocabulary's id space:
    ``[CLS]`` 2, words from 5, ``[SEP]`` 3 last, ``[PAD]`` 0 past a
    length from 256."""
    import numpy as np
    from ance_tpu_torch.data.cache import TokenCacheWriter
    lengths = rs.randint(256, SEED_SEQ + 1, SEED_PRETRAIN_ROWS)
    with TokenCacheWriter(str(path), SEED_SEQ) as w:
        for n in lengths:
            row = np.zeros(SEED_SEQ, np.int32)
            row[:n] = rs.randint(5, SEED_VOCAB_LINES, n)
            row[0], row[n - 1] = 2, 3
            w.write(int(n), row)


def _seed_mlm(dtype, overrides: dict, decoder: dict | None = None):
    """A SeedForMaskedLM at full width (pad id 0, the vocabulary's) with
    ``overrides`` on the encoder config and ``decoder`` on the decoder's."""
    from ance_tpu_torch.models.seed import (SeedDecoderConfig,
                                            SeedForMaskedLM,
                                            seed_encoder_config)
    ecfg = seed_encoder_config(pad_token_id=0, dtype=dtype, **overrides)
    return SeedForMaskedLM(ecfg, SeedDecoderConfig(**(decoder or {})))


def _seed_step_parity(vocab_dir: Path, cache_path: Path) -> dict:
    """SEED_PARITY_STEPS pretrain steps of a two-layer, full-width
    SeedForMaskedLM from the same weights (init std 0.05) and batches,
    dropout 0 in both configs: fp32 on the card against the port's CPU
    path (losses, every parameter after), and bf16 (the encoder's
    attention on #2 / #3 at S = SEED_PARITY_SEQ) against fp32 on the card
    by loss, update cosine and least step-1 gradient cosine."""
    import numpy as np
    import torch
    from ance_tpu_torch.data.cache import TokenCache
    from ance_tpu_torch.data.wordpiece import SeedTokenizer
    from ance_tpu_torch.ops.fused_attention import (fused_attention,
                                                    fused_attention_backward)
    from ance_tpu_torch.optim.schedules import warmup_linear
    from ance_tpu_torch.train import trainer
    from ance_tpu_torch.train.seed_pretrain import (make_seed_pretrain_step,
                                                    seed_pretrain_batches)
    from ance_tpu_torch.models.transformer import init_weights
    overrides = {"num_layers": 2, "hidden_dropout": 0.0,
                 "attention_dropout": 0.0, "initializer_range": 0.05}
    decoder = {"dropout": 0.0}
    start = _seed_mlm(torch.float32, overrides, decoder)
    init_weights(start, start.encoder_config,
                 torch.Generator().manual_seed(5))
    start = start.state_dict()
    tok = SeedTokenizer.from_vocab_file(vocab_dir)
    with TokenCache(str(cache_path)) as cache:
        batches = []
        for b in seed_pretrain_batches(
                cache, SEED_PARITY_BATCH, mask_token_id=tok.mask_token_id,
                vocab_size=len(tok.vocab), special_ids=[0, 1, 2, 3, 4,
                                                        tok.mask_token_id],
                pad_token_id=0, seed=6):
            batches.append({k: v[:, :SEED_PARITY_SEQ] for k, v in b.items()})
            if len(batches) == SEED_PARITY_STEPS:
                break

    def run(device, dtype):
        model = _seed_mlm(dtype, overrides, decoder)
        model.load_state_dict(start)
        model = model.to(device)
        state = trainer.init_train_state(model, trainer.make_optimizer(
            model, "lamb", warmup_linear(1e-4, 1, 10), weight_decay=0.01))
        step = make_seed_pretrain_step()
        gen = torch.Generator().manual_seed(0)
        losses, grads = [], None
        for b in batches:
            state, metrics = step(state, b, gen)
            losses.append(metrics["loss"].item())
            if grads is None:
                grads = {n: p.grad.detach().float().cpu()
                         for n, p in model.named_parameters()
                         if p.grad is not None}
        return losses, {k: v.detach().float().cpu()
                        for k, v in model.state_dict().items()}, grads

    res, launches = {}, {}
    for name, args in (("cpu", ("cpu", torch.float32)),
                       ("f32", ("cuda", torch.float32)),
                       ("bf16", ("cuda", torch.bfloat16))):
        fused_attention.launches = fused_attention_backward.launches = 0
        res[name] = run(*args)
        launches[name] = (fused_attention.launches,
                          fused_attention_backward.launches)
    want = 2 * SEED_PARITY_STEPS  # two layers a step
    check(launches["bf16"] == (want, want), f"SEED parity: #2 / #3 "
          f"launches {launches['bf16']}, not {want} each")
    cpu_l, cpu_p, _ = res["cpu"]
    f32_l, f32_p, _ = res["f32"]
    check(np.allclose(f32_l, cpu_l, atol=2e-3, rtol=1e-3),
          f"SEED fp32 cuda vs cpu losses {f32_l} vs {cpu_l}")
    lr_sum = 2e-4  # warmup_linear(1e-4, 1, 10): 0, 1e-4, 8/9 1e-4
    _params_close(f32_p, cpu_p, 1e-5, lr_sum, 1e-3, SEED_ZERO_GRADIENT)
    worst = max((f32_p[k] - cpu_p[k]).abs().max().item() for k in start
                if not k.endswith(SEED_ZERO_GRADIENT))
    b16 = bf16_readings(start, res["f32"], res["bf16"], SEED_ZERO_GRADIENT)
    check(b16["loss"] <= 0.1 and b16["update_cosine"] >= 0.95
          and b16["grad_cosine"] >= 0.98,
          f"SEED bf16 vs fp32 on the card: {b16}")
    print(f"seed parity (2 layers, full width, B={SEED_PARITY_BATCH} "
          f"S={SEED_PARITY_SEQ}): fp32 cuda vs cpu losses {f32_l} vs "
          f"{cpu_l}, max param diff {worst:.3g} (zero-gradient tensors "
          f"aside); bf16 losses {res['bf16'][0]} (#2 / #3 launches "
          f"{launches['bf16']}): within {b16['loss']:.3g} of fp32's, update "
          f"cosine {b16['update_cosine']:.5f}, least step-1 gradient cosine "
          f"{b16['grad_cosine']:.5f}", flush=True)
    return {"cpu_loss": cpu_l, "cuda_f32_loss": f32_l,
            "cuda_bf16_loss": res["bf16"][0], "f32_max_param_diff": worst,
            "bf16_vs_f32": b16, "bf16_launches": launches["bf16"]}


def phase_seed(work: Path):
    """SEED as its runbook would drive it, at full width from seeded
    weights, through the port's CLI in process: a vocab.txt from a seed
    (SeedTokenizer's ``<mask>`` makes 32,769); ``preprocess --model_type
    seeddot_nll`` of raw MS MARCO-format TSVs over PREPROCESS_WORKERS
    spawned workers on the C++ WordPiece core (every record held to the
    Python path); ``seed-pretrain`` (bf16, attention dropout 0, B=16 at
    S=512: #2 / #3 launched 12 a step each and held to their plain
    versions on the operands it gave them); a two-layer SeedForMaskedLM's
    step parity; ``greedy_decode`` from the pretrain checkpoint against
    the teacher-forced decoder; ``train --model_type seeddot_nll``
    warm-started from that checkpoint's encoder; ``generate`` (#1 on an
    fp32 index, twice) with ``infer`` + ``eval-full``; ``export-hf`` of
    both checkpoints, re-imported bit for bit; ``serve --bf16`` from the
    export against serving the checkpoint. Launch counts are set to 0 just
    before each path and read just after."""
    import numpy as np
    import torch
    from ance_tpu_torch import cli
    from ance_tpu_torch.data.cache import TokenCache
    from ance_tpu_torch.data.feed import parse_triple_line
    from ance_tpu_torch.index import flat
    from ance_tpu_torch.models import weights
    from ance_tpu_torch.models.registry import get_model_spec
    from ance_tpu_torch.models.seed import greedy_decode
    from ance_tpu_torch.ops.fused_attention import (fused_attention,
                                                    fused_attention_backward)
    from ance_tpu_torch.train import ann_gen, checkpoint as ckpt
    from ance_tpu_torch.train import seed_pretrain
    from ance_tpu_torch.train.ance_loop import load_offset_qrels
    from ance_tpu_torch.utils import native_build

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    vocab_dir, raw_dir = work / "seed_vocab", work / "seed_raw"
    data = work / "seed_data"
    rs = np.random.RandomState(16)
    _write_seed_vocab(vocab_dir, rs)
    raw = _write_raw_msmarco(raw_dir, rs)
    seq_flags = ["--max_seq_length", str(PASSAGE_LEN),
                 "--max_query_length", str(QUERY_LEN)]

    # 1. preprocess over spawned workers, on the C++ core; every record
    #    against the Python path
    lib = native_build.library_path("wordpiece")
    t0 = time.perf_counter()
    maps = _cli(["preprocess", "--model_type", "seeddot_nll",
                 "--model_name_or_path", str(vocab_dir), "--data_dir",
                 str(raw_dir), "--out_data_dir", str(data), *seq_flags,
                 "--num_processes", str(PREPROCESS_WORKERS)])
    pre_s = time.perf_counter() - t0
    check(maps == {"pid2offset": WARMUP_PASSAGES,
                   "train_qid2offset": WARMUP_TRAIN_QUERIES,
                   "dev_qid2offset": WARMUP_DEV_QUERIES},
          f"seed preprocess map sizes {maps}")
    tok = cli.TokenizerFactory("seed-wordpiece", str(vocab_dir))()
    check(tok.core == "native" and lib.exists(), "the seed tokenizer does "
          f"not run its C++ core ({tok.core}; {lib} built: {lib.exists()})")
    t0 = time.perf_counter()
    n_pieces = _check_preprocessed(
        data, raw, pad=tok.pad_token_id,
        encode=lambda texts, n: _seed_preprocess_ids(vocab_dir, texts, n))
    check_s = time.perf_counter() - t0
    print(f"seed preprocess: {WARMUP_PASSAGES} passages, "
          f"{WARMUP_TRAIN_QUERIES} + {WARMUP_DEV_QUERIES} queries over "
          f"{PREPROCESS_WORKERS} spawned workers in {pre_s:.2f} s on the "
          f"C++ WordPiece core ({lib.name}); every record == the Python "
          f"path's ids ({n_pieces} word pieces, checked in {check_s:.1f} s "
          f"over {CHECK_WORKERS} forked processes); qrels point at their "
          "rows", flush=True)

    # 2. seed-pretrain at full width: #2 / #3 12 a step each, each held to
    #    its plain version on the first call's operands
    pre_data, pre_ckpt = work / "seed_pre_data", work / "seed_pre_ckpt"
    pre_data.mkdir()
    _write_seed_pretrain_cache(pre_data / "passages", rs)
    step_ms, step_tokens = [], []
    real_make = seed_pretrain.make_seed_pretrain_step

    def timed_step(*args, **kwargs):
        step = real_make(*args, **kwargs)

        def run(state, batch, generator):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch, generator)
            float(metrics["loss"])
            step_ms.append((time.perf_counter() - t0) * 1e3)
            step_tokens.append(int(batch["attention_mask"].sum()))
            return state, metrics
        return run

    fwd_ops, bwd_ops = {}, {}
    _reset_attention_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    seed_pretrain.make_seed_pretrain_step = timed_step
    try:
        with picked_calls("forward", (0,), fwd_ops), \
                picked_calls("backward", (0,), bwd_ops):
            history = _cli([
                "seed-pretrain", "--device", "cuda", "--bf16",
                "--model_name_or_path", str(vocab_dir),
                "--encoder_overrides", '{"attention_dropout": 0.0}',
                "--data_dir", str(pre_data), "--output_dir", str(pre_ckpt),
                "--per_device_train_batch_size", str(SEED_BATCH),
                "--max_steps", str(SEED_STEPS), "--save_steps",
                str(SEED_STEPS), "--log_every", "1", "--learning_rate",
                "1e-4", "--warmup_steps", "2"])
    finally:
        seed_pretrain.make_seed_pretrain_step = real_make
    torch.cuda.synchronize()
    pre_peak = torch.cuda.max_memory_allocated() / 2**30
    pre_fwd, pre_bwd = _attention_counts()
    want = 12 * SEED_STEPS
    check(pre_fwd == {"fused_fwd_bf16": want}
          and pre_bwd == {"fused_bwd_bf16": want},
          f"seed-pretrain: #2 {pre_fwd} / #3 {pre_bwd}, not {want} each")
    check(fwd_ops[0][0].shape == (SEED_BATCH, SEED_SEQ, 12, 64),
          f"seed-pretrain's #2 operands {fwd_ops[0][0].shape}")
    pre_path = _attention_on_operands(fwd_ops, bwd_ops, "seed-pretrain")
    del fwd_ops, bwd_ops
    check([h["step"] for h in history] == list(range(SEED_STEPS - 2,
                                                      SEED_STEPS + 1))
          and all(math.isfinite(h[k]) for h in history
                  for k in ("loss", "mlm_loss", "decoder_loss")),
          f"seed-pretrain history {history}")
    pre_final = pre_ckpt / f"checkpoint-{SEED_STEPS}"
    check(ckpt.is_complete(str(pre_final)), f"no complete {pre_final}")
    mlm = _seed_mlm(torch.float32, {})
    pre_sd = torch.load(pre_final / "pytorch_model.bin", weights_only=True)
    mlm.load_state_dict(pre_sd, strict=True)
    check(all(bool(torch.isfinite(t).all()) for t in pre_sd.values()),
          f"{pre_final}: parameters not finite")
    pre_ms = statistics.median(step_ms[TIMED_FROM:])
    # the rows hold 256-512 tokens: the rate counts the real (non-pad)
    # tokens of the timed steps, positions/s counts every padded position
    tokens_per_s = sum(step_tokens[TIMED_FROM:]) \
        / (sum(step_ms[TIMED_FROM:]) / 1e3)
    positions_per_s = SEED_BATCH * SEED_SEQ / (pre_ms / 1e3)
    print(f"seed-pretrain: {SEED_STEPS} steps of B={SEED_BATCH} x S="
          f"{SEED_SEQ} at full width (12 layers, 768, vocabulary 32,769; "
          f"decoder 3 layers, window 2), bf16, attention dropout 0: losses "
          f"{[round(h['loss'], 4) for h in history]}, step {pre_ms:.1f} ms "
          f"(median after the first {TIMED_FROM}), {tokens_per_s:.0f} "
          f"tokens/s (non-pad; {positions_per_s:.0f} positions/s), peak "
          f"{pre_peak:.2f} GiB; #2 {pre_fwd}, #3 {pre_bwd}, "
          f"on its operands {pre_path}; {pre_final} loads strictly",
          flush=True)

    # 3. the step parity of a two-layer full-width SeedForMaskedLM
    parity = _seed_step_parity(vocab_dir, pre_data / "passages")

    # 4. greedy decode from the pretrain checkpoint, fp32: every token the
    #    argmax of the teacher-forced decoder on the decoded prefix
    mlm = mlm.to("cuda").eval()
    with TokenCache(str(pre_data / "passages")) as pc:
        lengths, src = pc.batch(np.arange(SEED_DECODE_BATCH))
    src = torch.as_tensor(np.array(src), dtype=torch.int64, device="cuda")
    mask = (torch.arange(SEED_SEQ, device="cuda")[None]
            < torch.as_tensor(lengths, device="cuda")[:, None]).long()
    t0 = time.perf_counter()
    toks = greedy_decode(mlm, src, mask, SEED_DECODE_STEPS, bos_token=2)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    with torch.no_grad():
        prev = torch.cat([torch.full_like(toks[:, :1], 2), toks[:, :-1]], 1)
        _, dec = mlm(src, mask, prev)
    top2 = torch.topk(dec, 2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    # the teacher-forced positions skip pad ids: a row is compared up to
    # the first pad it emitted (decode_step counts every position)
    before_pad = torch.cumsum((toks == 0).long(), 1) == 0
    before_pad = torch.cat([torch.ones_like(before_pad[:, :1]),
                            before_pad[:, :-1]], 1)
    clear = before_pad & (margin > 1e-4)
    agree = (dec.argmax(-1) == toks)
    check(bool(agree[clear].all()), f"greedy_decode: "
          f"{int((~agree & clear).sum())} tokens are not the teacher-forced "
          "argmax")
    print(f"greedy_decode: B={SEED_DECODE_BATCH} x {SEED_DECODE_STEPS} steps "
          f"(fp32, window-2 ring cache) in {decode_s:.2f} s; every token == "
          f"the teacher-forced decoder's argmax ({int(clear.sum())} of "
          f"{toks.numel()} positions compared: before a pad id, top-2 "
          f"margin > 1e-4; {int((agree & before_pad).sum())} agree of "
          f"{int(before_pad.sum())} before a pad)", flush=True)
    del mlm, dec
    torch.cuda.empty_cache()

    # 5. warm start from the pretrain checkpoint's encoder, then train
    ann = work / "seed_ann"
    _write_ann(ann, WARMUP_TRAIN_QUERIES, WARMUP_PASSAGES, rs)
    train_ms, start_sd, real_train = [], {}, cli._make_training

    def make_training(args, model, spec, mesh=None):
        start_sd.update({k: v.detach().cpu().clone()
                         for k, v in model.state_dict().items()})
        state, step = real_train(args, model, spec, mesh)

        def timed(state, batch, generator):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch, generator)
            float(metrics["loss"])
            train_ms.append((time.perf_counter() - t0) * 1e3)
            return state, metrics
        return state, timed

    cli._make_training = make_training
    try:
        summary = _cli([
            "train", "--device", "cuda", "--bf16", "--model_type",
            "seeddot_nll", "--model_name_or_path", str(pre_ckpt),
            "--data_dir", str(data), "--ann_dir", str(ann), "--output_dir",
            str(work / "seed_train"), "--max_steps", str(SEED_TRAIN_STEPS),
            "--save_steps", str(SEED_TRAIN_STEPS), "--warmup_steps", "2",
            "--per_device_train_batch_size", str(SEED_TRAIN_BATCH),
            "--seed", "42", *seq_flags])
    finally:
        cli._make_training = real_train
    encoder = {k: v for k, v in pre_sd.items() if k.startswith("roberta.")}
    check(summary["params"] == str(pre_final / "pytorch_model.bin")
          and all(torch.equal(start_sd[k], v) for k, v in encoder.items())
          and not any(k.startswith(("decoder.", "lm_head."))
                      for k in start_sd),
          "train: the encoder before step 1 is not the pretrain "
          "checkpoint's bit for bit")
    seeded = get_model_spec("seeddot_nll").build(seed=42)  # --seed
    check(all(torch.equal(start_sd[k], seeded.state_dict()[k])
              for k in start_sd if not k.startswith("roberta.")),
          "train: the head is not the seeded one")
    del seeded
    train_final = Path(summary["checkpoint"])
    check(summary["steps"] == SEED_TRAIN_STEPS
          and all(math.isfinite(x) for x in summary["loss"])
          and ckpt.is_complete(str(train_final)),
          f"seeddot train: {summary}")
    train_sd = torch.load(train_final / "pytorch_model.bin",
                          weights_only=True)
    get_model_spec("seeddot_nll").build().load_state_dict(train_sd,
                                                          strict=True)
    seed_train_ms = statistics.median(train_ms[TIMED_FROM:])
    print(f"train seeddot_nll from {pre_final} (its encoder bit-equal "
          f"before step 1, the head seeded): {SEED_TRAIN_STEPS} steps of "
          f"batch {SEED_TRAIN_BATCH}, bf16, losses "
          f"{[round(x, 4) for x in summary['loss']]}, step "
          f"{seed_train_ms:.1f} ms (median after the first {TIMED_FROM}); "
          f"{train_final} loads strictly", flush=True)

    # 6. generate on the trained checkpoint: an fp32 index, #1 twice
    flags = ["--device", "cuda", "--bf16", "--model_type", "seeddot_nll",
             "--data_dir", str(data), "--training_dir",
             str(work / "seed_train"), *seq_flags, "--topk_training",
             str(GEN_TOPK), "--negative_sample", str(GEN_NEGATIVES),
             "--ann_chunk_factor", "1"]
    results, real_gen = [], ann_gen.generate_new_ann
    searched, served, real_topk = [], [], flat.topk_blockmax

    def keep(*args, **kwargs):
        results.append(real_gen(*args, **kwargs))
        return results[-1]

    def recorded(queries, corpus, **kwargs):  # each search's operands
        searched.append((queries, corpus))
        out = real_topk(queries, corpus, **kwargs)
        served.append((queries, corpus, kwargs, out))
        return out

    ann_gen.generate_new_ann, flat.topk_blockmax = keep, recorded
    try:
        torch.cuda.synchronize()
        reset_blockmax_counts()
        t0 = time.perf_counter()
        gen = _cli(["generate", *flags, "--output_dir",
                    str(work / "seed_gen")])
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        gen_launches = blockmax_counts()
    finally:
        ann_gen.generate_new_ann, flat.topk_blockmax = real_gen, real_topk
    served.clear()
    result = results.pop()
    check(gen_launches == {"blockmax_pieces_f32": 2}, "seeddot generate "
          f"launched {gen_launches}, not blockmax_pieces_f32 twice")
    check(gen["checkpoint"] == str(train_final), f"generate loaded "
          f"{gen['checkpoint']}, not {train_final}")
    index = result["index"]
    index.method = "scan"
    _, scan_ids = index.search(result["train_query_embedding"], GEN_TOPK)
    same = (scan_ids.cpu().numpy() == result["train_neighbor_ids"]).mean()
    check(same == 1.0, f"seeddot generate: mining ids equal the scan on "
          f"{same:.6f} of positions, not all")
    positives = {q: next(iter(r)) for q, r in load_offset_qrels(
        str(data / "train-qrel.tsv")).items()}
    for line in (work / "seed_gen" / "ann_training_data_0").read_text() \
            .splitlines():
        qid, pos, negs = parse_triple_line(line)
        check(pos == positives[qid] and pos not in negs,
              f"bad mined line {line!r}")
    del index, result, scan_ids
    # #1 on the operands this generate gave it (dev, then mining)
    kernel_cases = phase1_against_plain(searched, "f32xf32", "seed generate",
                                        scaled=True)
    emb = work / "seed_emb"
    _cli(["infer", *flags, "--output_dir", str(emb)])
    pre = str(emb / "step0")
    full = _cli(["eval-full", "--device", "cuda",
                 "--query_prefix", pre + "_dev_query_emb_p_",
                 "--query_id_prefix", pre + "_dev_query_embid_p_",
                 "--passage_prefix", pre + "_passage_emb_p_",
                 "--passage_id_prefix", pre + "_passage_embid_p_",
                 "--qrels", str(data / "dev-qrel.tsv")])
    check(abs(full["ndcg_10"] - gen["dev_ndcg"]) <= 1e-12,
          f"eval-full ndcg_10 {full['ndcg_10']} vs generate's dev_ndcg "
          f"{gen['dev_ndcg']}")
    print(f"generate --model_type seeddot_nll --training_dir: {gen_s:.1f} "
          f"s, {gen_launches}; mining ids == scan at k={GEN_TOPK}; dev "
          f"NDCG@10 {gen['dev_ndcg']!r} == eval-full's {full['ndcg_10']!r} "
          "(within 1e-12)", flush=True)

    # 7. export-hf of both checkpoints, re-imported bit for bit; serve from
    #    the export against serving the checkpoint
    exports = {}
    for name, training_dir, sd, back in (
            ("pretrain", pre_ckpt, pre_sd,
             weights.seed_mlm_state_dict_from_fairseq),
            ("train", work / "seed_train", train_sd,
             weights.seeddot_state_dict_from_fairseq)):
        out = work / f"seed_export_{name}"
        exported = _cli(["export-hf", "--model_type", "seeddot_nll",
                         "--training_dir", str(training_dir), "--out_dir",
                         str(out)])
        fair = torch.load(out / "pytorch_model.bin", weights_only=True)
        again = back(fair)
        pos = "roberta.embeddings.position_embeddings.weight"
        check(sorted(again) == sorted(sd)
              and all(torch.equal(again[k], v) for k, v in sd.items()
                      if k != pos)
              and torch.equal(again[pos][:514], sd[pos][:514])
              and not again[pos][514:].any()
              and fair["seed_encoder.encoder.sentence_encoder."
                       "embed_positions.weight"].shape[0] == 514,
              f"export-hf {name}: the re-import is not the checkpoint")
        exports[name] = {"keys": len(fair), "step": exported["step"]}
    serve = ["serve", "--device", "cuda", "--bf16", "--model_type",
             "seeddot_nll", "--data_dir", str(data), "--query_cache",
             str(data / "dev-query"), "--topk", "10", "--with_scores",
             *seq_flags]
    serve_launches = {}
    for name, where in (("export", ["--model_name_or_path",
                                    str(work / "seed_export_train")]),
                        ("checkpoint", ["--training_dir",
                                        str(work / "seed_train")])):
        flat.topk_blockmax = recorded if name == "export" else real_topk
        try:
            reset_blockmax_counts()
            served_out = _cli(serve + where + [
                "--output", str(work / f"seed_rank_{name}.tsv")])
            serve_launches[name] = blockmax_counts()
        finally:
            flat.topk_blockmax = real_topk
    ranking = (work / "seed_rank_export.tsv").read_text()
    check(served_out["params"].endswith("pytorch_model.bin")
          and len(ranking.splitlines()) == WARMUP_DEV_QUERIES * 10
          and ranking == (work / "seed_rank_checkpoint.tsv").read_text(),
          "serve from the seeddot export does not rank as serve from the "
          "checkpoint")
    check(serve_launches["export"] == serve_launches["checkpoint"]
          and serve_launches["export"] == {"blockmax_bf16": len(served)},
          f"seeddot serve launches {serve_launches} for {len(served)} "
          "searches")
    # the served rows and scores against a scan of the same operands (exact
    # fp32 scores, ties to the lower row in both); the ranking file's
    # scores are the searches' first 10 in order
    file_scores = [line.split("\t")[3] for line in ranking.splitlines()]
    kept_scores = []
    for q, corpus, kwargs, (scores, rows) in served:
        scan_s, scan_rows = flat.topk_inner_product(
            q, corpus, k=kwargs["k"], valid_rows=kwargs["valid_rows"])
        check(torch.equal(scan_rows, rows) and torch.equal(scan_s, scores),
              f"seeddot serve: a search of {q.shape[0]} queries differs "
              f"from the scan on {int((scan_rows != rows).sum())} rows")
        kept_scores += [f"{float(x):.6f}" for x in scores[:, :10].flatten()]
    check(kept_scores == file_scores, "seeddot serve: the ranking file's "
          "scores are not the searches' top 10")
    serve_rows = sum(q.shape[0] for q, *_ in served)
    served.clear()
    # #1 on the operands this serve gave it
    kernel_cases += phase1_against_plain(
        searched, "bf16xbf16", "seed serve",
        tuple(f"batch {i}" for i in range(len(searched))), scaled=True)
    phase_s = time.perf_counter() - t_phase
    print(f"export-hf seeddot_nll: pretrain ({exports['pretrain']['keys']} "
          f"fairseq keys) and train ({exports['train']['keys']}), each "
          "re-imported bit for bit (the position table on its 514 rows); "
          "serve --bf16 from the export == serve --training_dir (rankings "
          f"byte for byte), #1 {serve_launches['export']} each; the "
          f"{serve_rows} queries' rows and scores == a scan's", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"seed numbers ({smi}): preprocess {pre_s:.2f} s; pretrain step "
          f"{pre_ms:.1f} ms, {tokens_per_s:.0f} tokens/s (non-pad; "
          f"{positions_per_s:.0f} positions/s), peak "
          f"{pre_peak:.2f} GiB; train step {seed_train_ms:.1f} ms; generate "
          f"{gen_s:.1f} s; the phase {phase_s:.1f} s", flush=True)
    check(no_reference_modules(), "the port imported jax or ance_tpu")
    return {"device": smi, "preprocess_s": pre_s, "check_s": check_s,
            "pretrain_step_ms": pre_ms, "pretrain_steps_ms": step_ms,
            "pretrain_tokens_per_s": tokens_per_s,
            "pretrain_positions_per_s": positions_per_s,
            "pretrain_steps_tokens": step_tokens,
            "pretrain_peak_gib": pre_peak, "pretrain_history": history,
            "pretrain_fused_forward": pre_fwd,
            "pretrain_fused_backward": pre_bwd, "pretrain_path": pre_path,
            "step_parity": parity, "decode_s": decode_s,
            "decode_compared": int(clear.sum()),
            "train_step_ms": seed_train_ms, "train_steps_ms": train_ms,
            "train_loss": summary["loss"], "generate_s": gen_s,
            "blockmax_kernels": gen_launches, "dev_ndcg": gen["dev_ndcg"],
            "serve_blockmax_kernels": serve_launches["export"],
            "kernel_cases": kernel_cases,
            "exports": exports, "phase_s": phase_s}


MESH_RANKS = 2
MESH_CORPUS = 1_000_003  # not a multiple of 2 x 16: shards carry padding
MESH_SEED = 18
MESH_REPS = 5
MESH_RANK_TIMEOUT_S = 240  # each rank process; a hung rank fails the run
MESH_TRAIN_STEPS, MESH_TRAIN_BATCH = 3, 32   # global batch, 16 a rank
MESH_LOOP_QUERIES, MESH_LOOP_DEV = 16, 64    # x 2 negatives = 32 triples
MESH_LOOP_SLICE = 2048
MESH_DPR = {"batch": 16, "seq": 256, "n_steps": 2, "accum": 2,
            "dtype": "bfloat16", "seed": 3,
            "overrides": {"hidden_dropout": 0.0, "attention_dropout": 0.0},
            "opt": {"name": "lamb", "lr": 1e-5, "weight_decay": 0.01,
                    "max_grad_norm": 1.0}}
MESH_LOSS_RTOL = 1e-4      # fp32 steps over one global batch, rows reordered
MESH_DPR_NORM_RTOL = 1e-3  # bf16 towers; a factor of the ranks is 0.5 or 2


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_ranks(job: dict, path: Path, world: int, env: dict | None = None
                 ) -> list:
    """One ``mesh_worker`` process a rank, all started at once."""
    path.write_text(json.dumps(job))
    return [subprocess.Popen(
        [sys.executable, "-m", "ance_tpu_torch.experiments.mesh_worker",
         str(path), str(r)], cwd=ROOT, env=env or _rank_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]


def _rank_env() -> dict:
    return dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="4")


def _wait_ranks(procs: list, what: str, expect_ok: bool = True) -> list:
    """(stdout, stderr) of every rank within MESH_RANK_TIMEOUT_S; every
    rank killed on a timeout, which fails the run, as does a rank that
    exits other than expected."""
    deadline = time.monotonic() + MESH_RANK_TIMEOUT_S
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic())))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"{what}: a rank hung past "
                             f"{MESH_RANK_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        if expect_ok:
            check(p.returncode == 0, f"{what}: rank {r} exited "
                  f"{p.returncode}: {err[-3000:]}")
        else:
            check(p.returncode != 0, f"{what}: rank {r} exited 0")
    return outs


def _rank_results(out_dir: Path, name: str, world: int) -> list:
    import torch
    return [torch.load(out_dir / f"{name}_rank{r}.pt", weights_only=False)
            for r in range(world)]


def _mesh_index(work: Path) -> dict:
    """(a) the row-sharded exact index at 2 gloo ranks on one card and at
    1 NCCL rank, against the one-process index on this card."""
    import torch
    from ance_tpu_torch.experiments.mesh_worker import (FLAT_MODES,
                                                        seeded_rows)
    from ance_tpu_torch.index.flat import FlatIPIndex
    out = work / "mesh_index"
    out.mkdir()
    case = {"case": "index_1m", "n": MESH_CORPUS, "dim": DIM,
            "seed": MESH_SEED, "modes": list(INDEX_KERNEL),
            "searches": [list(s) for s in SHAPES.values()],
            "reps": MESH_REPS}
    runs = {}
    for backend, world in (("gloo", MESH_RANKS), ("nccl", 1)):
        t0 = time.perf_counter()
        job = {"init_method": f"tcp://127.0.0.1:{_free_port()}",
               "world": world, "device": "cuda", "backend": backend,
               "timeout_s": MESH_RANK_TIMEOUT_S, "out_dir": str(out),
               "cases": [dict(case, name=f"index_{backend}")]}
        _wait_ranks(_start_ranks(job, out / f"{backend}.json", world),
                    f"mesh (a) {backend}")
        runs[backend] = (_rank_results(out, f"index_{backend}", world),
                         time.perf_counter() - t0)
    dev = torch.device("cuda")
    corpus = seeded_rows(MESH_CORPUS, DIM, MESH_SEED, dev)
    result = {"seconds": {b: s for b, (_, s) in runs.items()}}
    for mode, kernel in INDEX_KERNEL.items():
        index = FlatIPIndex(DIM, device=dev, **FLAT_MODES[mode])
        index.add(corpus)
        for q_n, k in SHAPES.values():
            q = seeded_rows(q_n, DIM, MESH_SEED + q_n, dev)
            want_s, want_i = (t.cpu() for t in index.search(q, k))
            key = f"{mode}/Q{q_n}k{k}"
            for backend, (ranks, _) in runs.items():
                got_s, got_i = ranks[0][key]
                check(torch.equal(got_i, want_i), f"mesh (a) {backend} "
                      f"{key}: sharded ids differ from one process")
                check(torch.equal(got_s, want_s), f"mesh (a) {backend} "
                      f"{key}: sharded scores differ from one process")
            result[key] = {
                f"{b}_rank{r['rank']}": {
                    "shard_ms": r[key + "/shard_ms"],
                    "gather_ms": r[key + "/gather_ms"]}
                for b, (ranks, _) in runs.items() for r in ranks}
        for backend, (ranks, _) in runs.items():
            for r in ranks:
                launches = r[f"{mode}/launches"]
                check(launches.get(kernel, 0) >= len(SHAPES),
                      f"mesh (a) {backend} rank {r['rank']} {mode}: "
                      f"{launches}, not {kernel} on every search")
        del index
    del corpus
    torch.cuda.empty_cache()
    result["launches"] = {f"{b}_rank{r['rank']}": {
        mode: r[f"{mode}/launches"] for mode in INDEX_KERNEL}
        for b, (ranks, _) in runs.items() for r in ranks}
    result["peak_gib"] = {f"{b}_rank{r['rank']}": r["peak_gib"]
                          for b, (ranks, _) in runs.items() for r in ranks}
    return result


def _mesh_train_argv(work: Path, data: Path, out: str, batch: int) -> list:
    return ["train", "--device", "cuda", "--model_name_or_path",
            str(work / "roberta_base_seeded"), "--data_dir", str(data),
            "--ann_dir", str(data / "ann"), "--output_dir", str(work / out),
            "--max_steps", str(MESH_TRAIN_STEPS), "--save_steps",
            str(MESH_TRAIN_STEPS), "--warmup_steps", "2",
            "--per_device_train_batch_size", str(batch),
            "--max_query_length", str(QUERY_LEN),
            "--max_seq_length", str(PASSAGE_LEN), "--feed_workers", "0",
            "--encoder_overrides", json.dumps(MESH_DPR["overrides"])]


def _rank_argv(world: int, backend: str) -> list:
    return ["--num_processes", str(world), "--coordinator_address",
            f"127.0.0.1:{_free_port()}", "--dist_backend", backend]


def _last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def _mesh_params_close(rank0: Path, one: Path, lr_sum: float) -> None:
    import torch
    from ance_tpu_torch.train.checkpoint import MODEL_FILE
    got = torch.load(rank0 / MODEL_FILE, weights_only=True)
    want = torch.load(one / MODEL_FILE, weights_only=True)
    _params_close(got, want, atol=1e-5, lr_sum=lr_sum, share=1e-3)


def phase_mesh(work: Path) -> dict:
    """Data parallelism, two ranks sharing this one card through gloo (no
    multi-GPU measurement: no scaling is measured here), each rank a
    process with a time limit:

      (a) the row-sharded exact ``FlatIPIndex`` over 1,000,003 x 768 seeded
          rows, fp32 / bf16 / dims, searches Q=2048 k=10 and Q=512 k=200:
          ids and scores equal to the one-process index on this card, at
          2 gloo ranks and at 1 NCCL rank (its collectives run), kernel #1
          launched by every rank on every search; each shard's search ms
          and the [Q, k] all_gather's ms (timed alone on the card);
      (b) ``cli train`` FirstP at RoBERTa-base width, fp32, dropout 0,
          global batch 32 (16 a rank), 3 steps, against the one-process
          ``train`` over the same global batch (accumulation 2, so its
          micro-batches are the ranks' shapes): losses and gradient norms
          within MESH_LOSS_RTOL, the parameters bit-equal on the ranks
          (the CLI checks and reports it) and within the step-parity
          bound of the one-process checkpoint;
      (c) ``cli ance-loop`` FirstP, fp32, bootstrap and 2 steps: the
          bootstrap (dev NDCG, recall, ann MRR, the mined triples) equal
          to the one-process bootstrap exactly, the step losses within
          MESH_LOSS_RTOL, kernel #1 launched on every rank;
      (d) the DPR GradCache step at 2 ranks (BERT-base towers, bf16, batch
          16, seq 256, accumulation 2, dropout 0: kernels #2 and #3)
          against the one-process step at accumulation 4 (the same
          micro-batch shapes): the first loss equal, the gradient norms
          within MESH_DPR_NORM_RTOL (a gradient off by the rank count is
          off by 0.5 or 2), parameters within the step-parity bound;
      (e) what must not run: NCCL with two ranks on one card exits naming
          ``--dist_backend gloo``; a rank that finds no GPU exits.

    (b) and (c) run at once, as do (d) and (e), each beside its
    one-process reference in this process: none of them is timed."""
    import numpy as np
    import torch
    from ance_tpu_torch.experiments.mesh_worker import (dpr_batches,
                                                        loop_probes,
                                                        loop_summary)
    from ance_tpu_torch.models.registry import get_model_spec
    from ance_tpu_torch.optim.schedules import warmup_linear
    from ance_tpu_torch.train.dpr_trainer import make_dpr_train_step
    from ance_tpu_torch.train.trainer import init_train_state, make_optimizer

    print("mesh: two ranks sharing one card through gloo (and one NCCL "
          "rank), not a multi-GPU measurement", flush=True)
    torch.cuda.empty_cache()  # the earlier phases' cache, for the ranks
    seconds, result = {}, {}
    t0 = time.perf_counter()
    result["index"] = _mesh_index(work)
    seconds["a_index"] = time.perf_counter() - t0
    for key, by_rank in result["index"].items():
        if "/Q" in key:
            print(f"mesh (a) {key}: " + "; ".join(
                f"{who} shard {v['shard_ms']:.3f} ms, [Q, k] all_gather "
                f"{v['gather_ms']:.3f} ms" for who, v in by_rank.items()))
    print(f"mesh (a) peak GiB by rank {result['index']['peak_gib']}; "
          f"ids and scores == one process; launches "
          f"{result['index']['launches']}", flush=True)

    # (b) train: 8 queries x 4 negatives = 32 triples, one global batch;
    # (c) ance-loop: 16 queries x 2 negatives, over the train passages
    rs = np.random.RandomState(18)
    data, loop_data = work / "mesh_train", work / "mesh_loop"
    for d in (data, loop_data):
        d.mkdir()
    for suffix in ("", "_meta"):
        for name in ("train-query", "passages"):
            os.symlink(work / "train" / f"{name}{suffix}",
                       data / f"{name}{suffix}")
        os.symlink(work / "train" / f"passages{suffix}",
                   loop_data / f"passages{suffix}")
    _write_ann(data / "ann", 8, TRAIN_PASSAGES, rs)
    _write_cache(loop_data / "train-query", MESH_LOOP_QUERIES, QUERY_LEN, 8,
                 rs)
    _write_cache(loop_data / "dev-query", MESH_LOOP_DEV, QUERY_LEN, 8, rs)
    for name, n in (("train", MESH_LOOP_QUERIES), ("dev", MESH_LOOP_DEV)):
        with open(loop_data / f"{name}-qrel.tsv", "w") as f:
            for q in range(n):
                f.write(f"{q}\t{rs.randint(TRAIN_PASSAGES)}\t1\n")

    def loop_argv(out: str, train_batch: int, eval_batch: int) -> list:
        return ["ance-loop", "--device", "cuda", "--model_name_or_path",
                str(work / "roberta_base_seeded"), "--data_dir",
                str(loop_data), "--output_dir", str(work / out),
                "--max_steps", "2", "--warmup_steps", "2",
                "--max_seq_length", str(PASSAGE_LEN), "--max_query_length",
                str(QUERY_LEN), "--per_device_train_batch_size",
                str(train_batch), "--per_device_eval_batch_size",
                str(eval_batch), "--encode_slice_size", str(MESH_LOOP_SLICE),
                "--train_steps_per_slice", "8", "--topk_training", "100",
                "--negative_sample", "2", "--ann_chunk_factor", "1",
                "--feed_workers", "0", "--encoder_overrides",
                json.dumps(MESH_DPR["overrides"])]

    t0 = time.perf_counter()
    dirs = {}
    for sub in ("b", "c", "d", "e"):
        dirs[sub] = work / f"mesh_{sub}"
        dirs[sub].mkdir()
    procs_b = _start_ranks(
        {"out_dir": str(dirs["b"]), "cli": _mesh_train_argv(
            work, data, "mesh_b_two", MESH_TRAIN_BATCH // MESH_RANKS)
         + _rank_argv(MESH_RANKS, "gloo")}, dirs["b"] / "job.json",
        MESH_RANKS)
    procs_c = _start_ranks(
        {"out_dir": str(dirs["c"]), "cli": loop_argv("mesh_c_two", 16, 128)
         + _rank_argv(MESH_RANKS, "gloo")}, dirs["c"] / "job.json",
        MESH_RANKS)
    one_b = _cli(_mesh_train_argv(work, data, "mesh_b_one", MESH_TRAIN_BATCH)
                 + ["--gradient_accumulation_steps", "2"])
    # the one process encodes 64 rows at a time, as each rank does
    with loop_probes() as record:
        _cli(loop_argv("mesh_c_one", 32, 64)
             + ["--gradient_accumulation_steps", "2"])
    one_c = loop_summary(record)
    ranks_b = [_last_json(o) for o, _ in _wait_ranks(procs_b,
                                                     "mesh (b) train")]
    peak_b = [r["peak_gib"] for r in _rank_results(dirs["b"], "cli",
                                                   MESH_RANKS)]
    _wait_ranks(procs_c, "mesh (c) ance-loop")
    ranks_c = _rank_results(dirs["c"], "cli", MESH_RANKS)
    seconds["b_c_train_and_loop"] = time.perf_counter() - t0

    for r, got in enumerate(ranks_b):
        check(got["dist"] == {"backend": "gloo", "rank": r,
                              "world": MESH_RANKS, "params_replicated": True},
              f"mesh (b) rank {r}: {got.get('dist')}")
        check(got["loss"] == ranks_b[0]["loss"],
              "mesh (b) ranks' losses differ")
        check(np.allclose(got["loss"], one_b["loss"], rtol=MESH_LOSS_RTOL,
                          atol=0), f"mesh (b) losses {got['loss']} vs one "
              f"process {one_b['loss']}")
        check(np.allclose(got["grad_norm"], one_b["grad_norm"],
                          rtol=MESH_LOSS_RTOL, atol=0),
              f"mesh (b) gradient norms {got['grad_norm']} vs "
              f"{one_b['grad_norm']}")
    lr_sum = sum(warmup_linear(1e-4, 2, MESH_TRAIN_STEPS)(i)
                 for i in range(MESH_TRAIN_STEPS))
    _mesh_params_close(Path(ranks_b[0]["checkpoint"]),
                       Path(one_b["checkpoint"]), lr_sum)
    result["train"] = {"losses": ranks_b[0]["loss"],
                       "one_process": one_b["loss"],
                       "grad_norm": ranks_b[0]["grad_norm"],
                       "one_process_grad_norm": one_b["grad_norm"],
                       "peak_gib": peak_b}
    print(f"mesh (b) train 2 ranks: losses {ranks_b[0]['loss']} vs one "
          f"process {one_b['loss']}; gradient norms "
          f"{ranks_b[0]['grad_norm']} vs {one_b['grad_norm']}; parameters "
          f"bit-equal on the ranks and within the step-parity bound; peak "
          f"GiB by rank {peak_b}", flush=True)

    boot = one_c["bootstrap"]
    check(boot["num_triples"] == MESH_TRAIN_BATCH,
          f"mesh (c) {boot['num_triples']} triples, not one global batch")
    for r, got in enumerate(ranks_c):
        for key in ("dev_ndcg", "dev_recall", "ann_mrr", "num_triples"):
            check(got["bootstrap"][key] == boot[key],
                  f"mesh (c) rank {r} bootstrap {key} "
                  f"{got['bootstrap'][key]} != one process {boot[key]}")
        check(got["triples"] == one_c["triples"],
              f"mesh (c) rank {r}: mined triples differ")
        check(got["losses"] == ranks_c[0]["losses"],
              "mesh (c) ranks' losses differ")
        check(np.allclose(got["losses"], one_c["losses"],
                          rtol=MESH_LOSS_RTOL, atol=0),
              f"mesh (c) losses {got['losses']} vs {one_c['losses']}")
        check(got["launches"].get("blockmax_pieces_f32", 0) >= 2,
              f"mesh (c) rank {r}: kernel #1 launches {got['launches']}")
    result["ance_loop"] = {
        "bootstrap": {k: boot[k] for k in ("dev_ndcg", "dev_recall",
                                          "ann_mrr", "num_triples")},
        "losses": ranks_c[0]["losses"], "one_process": one_c["losses"],
        "launches": {f"rank{r}": g["launches"]
                     for r, g in enumerate(ranks_c)},
        "one_process_launches": one_c["launches"],
        "peak_gib": [g["peak_gib"] for g in ranks_c]}
    print(f"mesh (c) ance-loop 2 ranks: bootstrap == one process "
          f"{result['ance_loop']['bootstrap']}, triples equal; losses "
          f"{ranks_c[0]['losses']} vs {one_c['losses']}; #1 launches "
          f"{result['ance_loop']['launches']}; peak GiB by rank "
          f"{result['ance_loop']['peak_gib']}", flush=True)

    # (d) the DPR GradCache step, beside (e) the refusals
    t0 = time.perf_counter()
    spec = dict(MESH_DPR, case="dpr_full",
                params_out=str(dirs["d"] / "params.pt"))
    procs_d = _start_ranks(
        {"init_method": f"tcp://127.0.0.1:{_free_port()}",
         "world": MESH_RANKS, "device": "cuda", "backend": "gloo",
         "timeout_s": MESH_RANK_TIMEOUT_S, "out_dir": str(dirs["d"]),
         "cases": [spec]}, dirs["d"] / "job.json", MESH_RANKS)
    refuse = _mesh_train_argv(work, data, "mesh_e", 16)
    procs_nccl = _start_ranks(
        {"out_dir": str(dirs["e"]),
         "cli": refuse + _rank_argv(MESH_RANKS, "nccl")},
        dirs["e"] / "nccl.json", MESH_RANKS)
    procs_no_gpu = _start_ranks(
        {"out_dir": str(dirs["e"]),
         "cli": refuse + _rank_argv(MESH_RANKS, "gloo")},
        dirs["e"] / "nogpu.json", 1,
        dict(_rank_env(), CUDA_VISIBLE_DEVICES=""))
    dev = torch.device("cuda")
    model = get_model_spec("dpr").build(
        dtype=torch.bfloat16, config_overrides=MESH_DPR["overrides"],
        seed=MESH_DPR["seed"]).to(dev)
    opt = MESH_DPR["opt"]
    state = init_train_state(model, make_optimizer(
        model, opt["name"], opt["lr"], weight_decay=opt["weight_decay"],
        max_grad_norm=opt["max_grad_norm"]))
    step = make_dpr_train_step(accum_steps=MESH_RANKS * MESH_DPR["accum"])
    gen = torch.Generator().manual_seed(MESH_DPR["seed"])
    losses, norms = [], []
    for batch in dpr_batches(MESH_DPR):
        state, m = step(state, batch, gen)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    one_d = {k: v.cpu() for k, v in model.state_dict().items()}
    del model, state
    torch.cuda.empty_cache()
    _wait_ranks(procs_d, "mesh (d) dpr")
    ranks_d = _rank_results(dirs["d"], "dpr_full", MESH_RANKS)
    outs_nccl = _wait_ranks(procs_nccl, "mesh (e) nccl on one card",
                            expect_ok=False)
    outs_no_gpu = _wait_ranks(procs_no_gpu, "mesh (e) no GPU",
                              expect_ok=False)
    seconds["d_e_dpr_and_refusals"] = time.perf_counter() - t0

    want = 12 * 2 * MESH_DPR["accum"] * 2 * MESH_DPR["n_steps"]
    for r, got in enumerate(ranks_d):
        check(got["loss"] == ranks_d[0]["loss"], "mesh (d) losses differ")
        check(got["loss"][0] == losses[0], f"mesh (d) rank {r} first loss "
              f"{got['loss'][0]} != one process {losses[0]}")
        check(np.allclose(got["loss"], losses, rtol=MESH_LOSS_RTOL, atol=0),
              f"mesh (d) losses {got['loss']} vs {losses}")
        check(np.allclose(got["grad_norm"], norms, rtol=MESH_DPR_NORM_RTOL,
                          atol=0), f"mesh (d) gradient norms "
              f"{got['grad_norm']} vs one process {norms}")
        # a step: each micro-batch's towers twice forward (GradCache), once
        # backward, 12 layers each
        check(sum(got["fused_forward"].values()) == want
              and sum(got["fused_backward"].values()) == want // 2,
              f"mesh (d) rank {r}: #2 {got['fused_forward']} / #3 "
              f"{got['fused_backward']}, not {want} / {want // 2}")
    _params_close(torch.load(dirs["d"] / "params.pt", weights_only=True),
                  one_d, atol=1e-5, lr_sum=opt["lr"] * MESH_DPR["n_steps"],
                  share=1e-3)
    result["dpr"] = {"losses": ranks_d[0]["loss"], "one_process": losses,
                     "grad_norm": ranks_d[0]["grad_norm"],
                     "one_process_grad_norm": norms,
                     "fused_forward": {f"rank{r}": g["fused_forward"]
                                       for r, g in enumerate(ranks_d)},
                     "fused_backward": {f"rank{r}": g["fused_backward"]
                                        for r, g in enumerate(ranks_d)},
                     "peak_gib": {f"rank{r}": g["peak_gib"]
                                  for r, g in enumerate(ranks_d)},
                     "rank_seconds": ranks_d[0]["seconds"]}
    print(f"mesh (d) DPR GradCache 2 ranks: losses {ranks_d[0]['loss']} vs "
          f"one process {losses}; gradient norms {ranks_d[0]['grad_norm']} "
          f"vs {norms}; #2 / #3 {result['dpr']['fused_forward']} / "
          f"{result['dpr']['fused_backward']}; peak GiB "
          f"{result['dpr']['peak_gib']}", flush=True)
    check(all("--dist_backend gloo" in err for _, err in outs_nccl),
          "mesh (e) NCCL's refusal does not name --dist_backend gloo: "
          + outs_nccl[0][1][-2000:])
    check("CUDA is not available" in outs_no_gpu[0][1],
          "mesh (e) a rank with no GPU: " + outs_no_gpu[0][1][-2000:])
    result["seconds"] = seconds
    print(f"mesh (e) NCCL on one card refused naming --dist_backend gloo; "
          f"a rank with no GPU exits; sub-phase seconds {seconds}",
          flush=True)
    check(no_reference_modules(), "the port imported jax or ance_tpu")
    return result


TP_RANKS = 2
TP_PASSAGES, TP_DEV, TP_TRAIN_QUERIES = 512, 32, 64
TP_EVAL_BATCH = 128
TP_TOPK, TP_NEGATIVES = 100, 5
TP_DEV_FROM = 4            # dev query i: the first QUERY_LEN tokens of 4 x i
TP_EMB_ATOL = 1e-4         # fp32 passage embeddings, tp 2 against one process
TP_NDCG_ATOL = 1e-6
TP_BF16_COSINE = 0.999     # bf16 tp 2 embeddings' rows against one process
TP_DPR_PASSAGES, TP_DPR_QUERIES = 256, 32
TP_TINY = {"num_layers": 2, "hidden_size": 64, "num_heads": 4,
           "intermediate_size": 128}


def _cut_cache(src: Path, dst: Path, n: int) -> None:
    """The first ``n`` records of the token cache ``src`` as ``dst``."""
    import numpy as np
    from ance_tpu_torch.data.cache import TokenCache, TokenCacheWriter
    with TokenCache(str(src)) as c:
        lengths, tokens = c.batch(np.arange(min(n, c.total_number)))
        seq = c.embedding_size
    with TokenCacheWriter(str(dst), seq) as w:
        for length, row in zip(lengths, tokens):
            w.write(int(length), row)


def _tp_data(work: Path, rs) -> Path:
    """(a) and (b)'s data: TP_PASSAGES random passages, TP_TRAIN_QUERIES
    random train queries with a random positive each, and TP_DEV dev
    queries that are passage prefixes (graded 2, beside a random 1), so
    dev NDCG is far from 0."""
    import numpy as np
    from ance_tpu_torch.data.cache import TokenCache, TokenCacheWriter
    data = work / "tp_data"
    data.mkdir()
    _write_cache(data / "passages", TP_PASSAGES, PASSAGE_LEN, 8, rs)
    _write_cache(data / "train-query", TP_TRAIN_QUERIES, QUERY_LEN, 8, rs)
    with open(data / "train-qrel.tsv", "w") as f:
        for q in range(TP_TRAIN_QUERIES):
            f.write(f"{q}\t{rs.randint(TP_PASSAGES)}\t1\n")
    sources = np.arange(TP_DEV) * TP_DEV_FROM
    with TokenCache(str(data / "passages")) as pc:
        lengths, tokens = pc.batch(sources)
    with TokenCacheWriter(str(data / "dev-query"), QUERY_LEN) as w:
        for length, row in zip(lengths, tokens):
            n = int(min(length, QUERY_LEN))
            q = np.ones(QUERY_LEN, np.int32)
            q[:n] = row[:n]
            w.write(n, q)
    with open(data / "dev-qrel.tsv", "w") as f:
        for q, p in enumerate(sources):
            f.write(f"{q}\t{p}\t2\n{q}\t{rs.randint(TP_PASSAGES)}\t1\n")
    return data


def _tp_dpr_data(work: Path) -> Path:
    """(c)'s data: the DPR phase's caches cut to TP_DPR_PASSAGES passages
    and TP_DPR_QUERIES questions a split (the rest linked)."""
    src, data = work / "dpr_data", work / "tp_dpr_data"
    data.mkdir()
    cut = {"passages": TP_DPR_PASSAGES, "train-query": TP_DPR_QUERIES,
           "test-query": TP_DPR_QUERIES, "trivia-test-query": TP_DPR_QUERIES}
    for name in os.listdir(src):
        if name.removesuffix("_meta") not in cut:
            os.symlink(src / name, data / name)
    for name, n in cut.items():
        _cut_cache(src / name, data / name, n)
    return data


def _near_tie_swaps(got_ids, want_ids, query_emb, corpus_emb, got_query,
                    got_corpus, what: str) -> dict:
    """Where ``got_ids`` (a rank's ranked ids) differ from ``want_ids`` (one
    process's), the two runs ranked near-ties apart: at every rank j, the
    one process's score (fp64, from its embeddings) of the rank's j-th id
    is within a tolerance of its own j-th score. The tolerance is what the
    measured differences between the two runs' embeddings can do: twice
    the most they move any score of the query (the j-th largest of two
    score lists moves by no more than the largest change of one score),
    plus 1e-6 of its largest score (the searches round their fp64
    rescoring to fp32). Returns the count of differing ranks, the widest
    score gap and the widest tolerance."""
    import numpy as np
    import torch
    q, c = query_emb.double().cpu(), corpus_emb.double().cpu()
    scores = q @ c.T
    got = torch.as_tensor(np.asarray(got_ids, np.int64))
    want = torch.as_tensor(np.asarray(want_ids, np.int64))
    gap = (scores.gather(1, got) - scores.gather(1, want)).abs()
    moved = (got_query.double().cpu() @ got_corpus.double().cpu().T
             - scores).abs().amax(1, keepdim=True)
    tol = 2 * moved + 1e-6 * scores.abs().amax(1, keepdim=True)
    bad = (gap > tol).nonzero()
    check(len(bad) == 0, f"{what}: {len(bad)} ranks beyond the tie "
          f"tolerance; first: query {int(bad[0, 0]) if len(bad) else -1} "
          f"(gap {gap.max().item():.3g}, tolerance {tol.min().item():.3g})")
    return {"count": int((got != want).sum()),
            "widest_gap": float(gap.max()), "tolerance": float(tol.max())}


def _row_cosine(a, b) -> float:
    """The smallest cosine between matching rows of ``a`` and ``b``."""
    import torch
    return float(torch.nn.functional.cosine_similarity(
        a.double(), b.double(), dim=1).min())


def _tp_argv(work: Path, command: str, data: Path, out: Path, batch: int,
             extra=()) -> list:
    """``generate`` over ``data`` from the seeded RoBERTa-base weights (no
    checkpoint under ``--training_dir``), fp32, xla attention, dropout
    0."""
    return [command, "--device", "cuda", "--model_name_or_path",
            str(work / "roberta_base_seeded"), "--data_dir", str(data),
            "--training_dir", str(work / "tp_no_checkpoints"),
            "--output_dir", str(out),
            "--max_seq_length", str(PASSAGE_LEN), "--max_query_length",
            str(QUERY_LEN), "--per_device_eval_batch_size", str(batch),
            "--topk_training", str(TP_TOPK), "--negative_sample",
            str(TP_NEGATIVES), "--ann_chunk_factor", "1", "--attention",
            "xla", "--encoder_overrides", json.dumps(MESH_DPR["overrides"]),
            *extra]


def phase_tp(work: Path) -> dict:
    """Tensor parallelism (``core/tp.py``), two ranks sharing this card
    through gloo (no multi-GPU measurement: only the sub-phase is timed),
    each a process of the CLI with a time limit. Each layer's two
    all-reduces pass through the host under gloo, so the corpora are
    small: this checks behaviour.

      (a) ``generate --num_processes 2 --tensor_parallel 2`` at RoBERTa-base
          width, fp32, ``--attention xla``, dropout 0, over TP_PASSAGES
          passages at seq 128 with TP_DEV dev and TP_TRAIN_QUERIES train
          queries, against the one-process ``generate`` on the same
          weights: passage embeddings within TP_EMB_ATOL (the worst
          printed), dev NDCG@10 within TP_NDCG_ATOL, the mined ids equal
          but for near-ties (``_near_tie_swaps``; counted), the hand-off
          files equal but for those queries' lines, kernel #1 on both
          ranks, each rank's column-parallel weights half the rows;
      (b) ``generate --num_processes 2`` at tp 1 (data-parallel, the index
          row-sharded): the hand-off files byte-equal to one process at
          the ranks' encode batch;
      (c) ``generate-dpr --bf16 --num_processes 2 --tensor_parallel 2`` on
          the DPR phase's trained BERT-base towers over its data cut to
          TP_DPR_PASSAGES passages and TP_DPR_QUERIES questions a split:
          every row of the embeddings within TP_BF16_COSINE of one
          process's, and no further from the towers in fp32 than twice
          one bf16 process's distance (1 - cosine), the ranked ids equal
          but for near-ties, a question's
          first answer-bearing rank moved only where its ranking did (the
          hit curves' equality printed), kernel #1 on both ranks;
      (d) the refusals: tp 2 with ``--attention auto``, tp 3 at two ranks,
          and NCCL with two ranks on one card (naming ``--dist_backend
          gloo``).

    Every rank group starts at once; the one-process references run in
    this process meanwhile."""
    import numpy as np
    import torch
    from ance_tpu_torch.data import dpr
    from ance_tpu_torch.evaluation.qa_validation import has_answer
    from ance_tpu_torch.train import ann_gen, dpr_gen

    print("tp: two ranks sharing one card through gloo, not a multi-GPU "
          "measurement", flush=True)
    torch.cuda.empty_cache()
    (work / "tp_no_checkpoints").mkdir()
    data = _tp_data(work, np.random.RandomState(19))
    dpr_data, raw = _tp_dpr_data(work), work / "dpr_raw"
    dirs = {}
    for sub in ("a", "b", "c", "d"):
        dirs[sub] = work / f"tp_{sub}"
        dirs[sub].mkdir()

    def ranks(sub: str, argv: list, world: int = TP_RANKS,
              backend: str = "gloo", name: str = "job") -> list:
        return _start_ranks({"out_dir": str(dirs[sub]),
                             "cli": argv + _rank_argv(TP_RANKS, backend)},
                            dirs[sub] / f"{name}.json", world)

    def one(argv: list, module, name: str) -> tuple[dict, dict]:
        """The one-process run of ``argv`` in this process, and the result
        of its pass (``module.name``)."""
        kept, real = {}, getattr(module, name)

        def keep(*args, **kw):
            kept.update(real(*args, **kw))
            return kept
        setattr(module, name, keep)
        try:
            return _cli(argv), kept
        finally:
            setattr(module, name, real)

    dpr_argv = ["generate-dpr", "--device", "cuda", "--model_type", "dpr",
                "--bf16", "--attention", "xla", "--max_seq_length",
                str(DPR_SEQ), "--max_query_length", str(DPR_SEQ),
                "--data_dir", str(dpr_data), "--wiki_path",
                str(raw / "psgs_w100.tsv"), "--test_qas",
                str(raw / "nq-test.csv"), "--trivia_qas",
                str(raw / "trivia-test.csv"), "--training_dir",
                str(work / "dpr_ckpt"), "--topk_training", str(TP_TOPK),
                "--negative_sample", str(TP_NEGATIVES),
                "--per_device_eval_batch_size", str(TP_EVAL_BATCH),
                "--encoder_overrides", json.dumps(MESH_DPR["overrides"])]
    # the refusals: a tiny encoder from its seeded init (no weights load)
    refuse = _tp_argv(work, "generate", data, dirs["d"] / "out",
                      TP_EVAL_BATCH)
    refuse = refuse[:refuse.index("--encoder_overrides")] + [
        "--encoder_overrides", json.dumps(dict(TP_TINY,
                                               **MESH_DPR["overrides"]))]
    refuse[refuse.index("--model_name_or_path") + 1] = str(
        work / "tp_no_checkpoints")
    t0 = time.perf_counter()
    procs = {
        "a": ranks("a", _tp_argv(work, "generate", data, dirs["a"] / "two",
                                 TP_EVAL_BATCH, ["--tensor_parallel",
                                                 str(TP_RANKS)])),
        "b": ranks("b", _tp_argv(work, "generate", data, dirs["b"] / "two",
                                 TP_EVAL_BATCH)),
        "c": ranks("c", dpr_argv + ["--output_dir", str(dirs["c"] / "two"),
                                    "--tensor_parallel", str(TP_RANKS)]),
        "auto": ranks("d", [x if x != "xla" else "auto" for x in refuse]
                      + ["--tensor_parallel", "2"], name="auto"),
        "three": ranks("d", refuse + ["--tensor_parallel", "3"], world=1,
                       name="three"),
        "nccl": ranks("d", refuse + ["--tensor_parallel", "2"],
                      backend="nccl", name="nccl")}
    one_a, kept_a = one(_tp_argv(work, "generate", data, dirs["a"] / "one",
                                 TP_EVAL_BATCH), ann_gen, "generate_new_ann")
    one_corpus = kept_a["index"]._emb[:kept_a["index"].ntotal].float().cpu()
    one_train_q = kept_a["train_query_embedding"].float().cpu()
    one_ids = kept_a["train_neighbor_ids"]
    del kept_a
    # the ranks of (b) encode TP_EVAL_BATCH / 2 rows at a time: so does
    # their one-process reference
    one(_tp_argv(work, "generate", data, dirs["b"] / "one",
                 TP_EVAL_BATCH // TP_RANKS), ann_gen, "generate_new_ann")
    one_c, kept_c = one(dpr_argv + ["--output_dir", str(dirs["c"] / "one")],
                        dpr_gen, "generate_new_ann_dpr")
    # the same towers in fp32: how far bf16 itself is from the function
    _, kept_f32 = one([x for x in dpr_argv if x != "--bf16"]
                      + ["--output_dir", str(dirs["c"] / "one_fp32")],
                      dpr_gen, "generate_new_ann_dpr")
    fp32 = {"passages": kept_f32["index"]._emb[:kept_f32["index"].ntotal],
            **{k: kept_f32[f"{k}_query_embedding"] for k in ("test",
                                                             "train")}}
    fp32 = {k: v.float().cpu() for k, v in fp32.items()}
    del kept_f32
    torch.cuda.empty_cache()
    outs = {k: _wait_ranks(p, f"tp {k}", expect_ok=k in ("a", "b", "c"))
            for k, p in procs.items()}
    got = {k: _rank_results(dirs[k], "cli", TP_RANKS) for k in "abc"}
    seconds = {"all": time.perf_counter() - t0}
    result = {}

    # (a)
    half = "roberta.encoder.layer.0.attention.self.query.weight"
    emb_err, swaps = 0.0, {}
    for r, (g, (out, _)) in enumerate(zip(got["a"], outs["a"])):
        dist = json.loads(out.strip().splitlines()[0])["dist"]
        check(dist == {"backend": "gloo", "rank": r, "world": TP_RANKS,
                       "device": "cuda:0", "data": 0, "model": r,
                       "tp": TP_RANKS}, f"tp (a) rank {r}: {dist}")
        check(g["local_shapes"][half] == (DIM // TP_RANKS, DIM),
              f"tp (a) rank {r}: {half} {g['local_shapes'][half]}")
        gen = g["generate"]
        err = (gen["passage_emb"] - one_corpus).abs().max().item()
        emb_err = max(emb_err, err)
        check(err <= TP_EMB_ATOL, f"tp (a) rank {r}: passage embeddings "
              f"{err:.3g} from one process (bound {TP_EMB_ATOL})")
        check(abs(gen["dev_ndcg"] - one_a["dev_ndcg"]) <= TP_NDCG_ATOL,
              f"tp (a) rank {r}: dev NDCG {gen['dev_ndcg']!r} vs one "
              f"process {one_a['dev_ndcg']!r}")
        swaps[f"rank{r}"] = _near_tie_swaps(
            gen["train_neighbor_ids"], one_ids, one_train_q, one_corpus,
            gen["train_query_embedding"], gen["passage_emb"],
            f"tp (a) rank {r} mining")
        check(g["launches"].get("blockmax_pieces_f32", 0) >= 2,
              f"tp (a) rank {r}: kernel #1 launches {g['launches']}")
    lines = {w: (dirs["a"] / w / "ann_training_data_0").read_text()
             .splitlines() for w in ("one", "two")}
    swapped = {int(q) for q in np.argwhere(
        got["a"][0]["generate"]["train_neighbor_ids"] != one_ids)[:, 0]}
    differ = [a for a, b in zip(*lines.values()) if a != b]
    check(len(lines["one"]) == len(lines["two"])
          and all(int(a.split("\t")[0]) in swapped for a in differ),
          f"tp (a) {len(differ)} hand-off lines differ, not all of them "
          "a query with near-tie swaps")
    result["generate_tp2"] = {
        "passage_emb_max_abs_err": emb_err, "near_tie_swaps": swaps,
        "lines_differing": len(differ), "dev_ndcg": one_a["dev_ndcg"],
        "dev_ndcg_tp2": [g["generate"]["dev_ndcg"] for g in got["a"]],
        "launches": {f"rank{r}": g["launches"]
                     for r, g in enumerate(got["a"])},
        "peak_gib": [g.get("peak_gib") for g in got["a"]]}
    print(f"tp (a) generate 2 ranks at tp 2: passage embeddings within "
          f"{emb_err:.3g} of one process (bound {TP_EMB_ATOL}); dev NDCG "
          f"{result['generate_tp2']['dev_ndcg_tp2']} vs "
          f"{one_a['dev_ndcg']!r}; mined ids: near-tie swaps {swaps}, "
          f"{len(differ)} of {len(lines['one'])} hand-off lines differ; "
          f"#1 launches {result['generate_tp2']['launches']}; {half} "
          f"{DIM // TP_RANKS} x {DIM} a rank; peak GiB "
          f"{result['generate_tp2']['peak_gib']}", flush=True)

    # (b)
    for r, g in enumerate(got["b"]):
        check(g["launches"].get("blockmax_pieces_f32", 0) >= 2,
              f"tp (b) rank {r}: kernel #1 launches {g['launches']}")
    for name in ("ann_training_data_0", "ann_ndcg_0"):
        check((dirs["b"] / "two" / name).read_bytes()
              == (dirs["b"] / "one" / name).read_bytes(),
              f"tp (b) {name} differs from one process")
    result["generate_dp2"] = {"launches": {
        f"rank{r}": g["launches"] for r, g in enumerate(got["b"])}}
    print(f"tp (b) generate 2 ranks at tp 1: hand-off files byte-equal to "
          f"one process; #1 launches {result['generate_dp2']['launches']}",
          flush=True)

    # (c): each test question's first answer-bearing rank, by the one
    # process's ranking and by a rank's, may differ only where the
    # rankings do
    pid2offset, _ = dpr.load_mapping(str(dpr_data), "pid2offset")
    texts = {pid2offset[p]: t for p, t in dpr.load_passage_texts(
        str(raw / "psgs_w100.tsv")).items()}
    answers = dpr.load_qas_answers(str(raw / "nq-test.csv"))

    def first_hits(ids) -> np.ndarray:
        return np.asarray([next((j for j, p in enumerate(row) if has_answer(
            answers[q], texts[int(p)][0])), -1) for q, row in enumerate(ids)])

    corpus = kept_c["index"]._emb[:kept_c["index"].ntotal].float().cpu()
    one_q = {k: kept_c[f"{k}_query_embedding"].float().cpu()
             for k in ("test", "train")}
    one_first = first_hits(kept_c["test_neighbor_ids"])
    ones = {"passages": corpus, **one_q}
    # 1 - the least row cosine of one process's bf16 embeddings to fp32's
    bf16_off = {k: 1 - _row_cosine(ones[k], fp32[k]) for k in ones}
    dpr_swaps, cosines, hits_moved, tp_off = {}, {}, {}, {}
    half_c = "ctx_model.encoder.layer.0.intermediate.dense.weight"
    for r, g in enumerate(got["c"]):
        gen = g["generate_dpr"]
        check(g["local_shapes"][half_c] == (4 * DIM // TP_RANKS, DIM),
              f"tp (c) rank {r}: the context tower is not sharded")
        check(g["launches"].get("blockmax_pieces_f32", 0) >= 3,
              f"tp (c) rank {r}: kernel #1 launches {g['launches']}")
        cosines[f"rank{r}"] = {
            "passages": _row_cosine(gen["passage_emb"], corpus),
            **{k: _row_cosine(gen[f"{k}_query_embedding"], one_q[k])
               for k in one_q}}
        check(min(cosines[f"rank{r}"].values()) >= TP_BF16_COSINE,
              f"tp (c) rank {r}: embeddings' row cosines to one process "
              f"{cosines[f'rank{r}']} (bound {TP_BF16_COSINE})")
        # tp 2 adds no more than bf16 itself costs: its rows as far from
        # fp32 as one bf16 process's, twice over at most
        tp_off[f"rank{r}"] = {
            k: 1 - _row_cosine(gen["passage_emb"] if k == "passages"
                               else gen[f"{k}_query_embedding"], fp32[k])
            for k in fp32}
        check(all(tp_off[f"rank{r}"][k] <= 2 * bf16_off[k] + 1e-7
                  for k in fp32), f"tp (c) rank {r}: 1 - cosine to fp32 "
              f"{tp_off[f'rank{r}']}, one bf16 process's {bf16_off}")
        dpr_swaps[f"rank{r}"] = {
            k: _near_tie_swaps(
                gen[f"{k}_neighbor_ids"], kept_c[f"{k}_neighbor_ids"],
                one_q[k], corpus, gen[f"{k}_query_embedding"],
                gen["passage_emb"], f"tp (c) rank {r} {k}")
            for k in one_q}
        moved = np.flatnonzero(first_hits(gen["test_neighbor_ids"])
                               != one_first)
        reranked = (gen["test_neighbor_ids"]
                    != kept_c["test_neighbor_ids"]).any(1)
        check(reranked[moved].all(), f"tp (c) rank {r}: questions "
              f"{moved[~reranked[moved]]} moved their first hit on an "
              "unchanged ranking")
        hits_moved[f"rank{r}"] = len(moved)
    result["generate_dpr_tp2"] = {
        "top20": one_c["top20"], "top100": one_c["top100"],
        "near_tie_swaps": dpr_swaps, "row_cosines": cosines,
        "one_minus_cosine_to_fp32": {"one_process_bf16": bf16_off,
                                     **tp_off},
        "questions_first_hit_moved": hits_moved,
        "curves_equal": {f"rank{r}": (
            g["generate_dpr"]["top_k_hits"] == kept_c["top_k_hits"],
            g["generate_dpr"]["top_k_hits_trivia"]
            == kept_c["top_k_hits_trivia"]) for r, g in enumerate(got["c"])},
        "launches": {f"rank{r}": g["launches"]
                     for r, g in enumerate(got["c"])}}
    print(f"tp (c) generate-dpr --bf16 2 ranks at tp 2: top-k hit curves "
          f"(NQ test, trivia) equal to one process's "
          f"{result['generate_dpr_tp2']['curves_equal']} (one process's "
          f"top20 {one_c['top20']}, top100 {one_c['top100']}); questions "
          f"whose first hit moved, each on a ranking that moved: "
          f"{hits_moved}; embeddings' least row cosine to one process "
          f"{cosines}; 1 - least cosine to the fp32 towers: one bf16 "
          f"process {bf16_off}, tp 2 {tp_off}; ranked ids: near-tie swaps "
          f"{dpr_swaps}; #1 launches "
          f"{result['generate_dpr_tp2']['launches']}", flush=True)
    del kept_c, corpus

    # (d)
    check(all("tensor parallelism requires an explicit 'xla' or "
              "'xla_bf16'" in err for _, err in outs["auto"]),
          "tp (d) --attention auto: " + outs["auto"][0][1][-2000:])
    check("--tensor_parallel 3 does not divide 2 devices"
          in outs["three"][0][1], "tp (d) tp 3: " + outs["three"][0][1][-2000:])
    check(all("--dist_backend gloo" in err for _, err in outs["nccl"]),
          "tp (d) NCCL on one card: " + outs["nccl"][0][1][-2000:])
    result["seconds"] = seconds
    print(f"tp (d) --attention auto, tp 3 at two ranks and NCCL on one "
          f"card refused; sub-phase seconds {seconds}", flush=True)
    check(no_reference_modules(), "the port imported jax or ance_tpu")
    return result

# the learning demos (experiments/demo*.py): the MaxP in-batch step at
# full width, and the FirstP demo cut in corpus size
DEMO_PASSAGES = 16_384
# loop steps of the FirstP demo's cut: 29 refreshes of 64 steps; two
# 16,384-passage card runs passed dev NDCG@10 0.5 at loop step 1,600 and
# 1,344 and read 0.754 and 0.9596 at 1,792
DEMO_LOOP_STEPS = 1_856
DEMO_CHANCE, DEMO_LEARNED = 0.05, 0.5  # bootstrap below, last refresh at
MAXP_STEP_QUERIES, MAXP_STEP_QUERY_LEN = 8, 64
MAXP_STEP_DOC_LEN = 2048  # 4 chunks of 512: 16 documents, 64 chunk rows
MAXP_STEP_STEPS = 5
FP64_ACCUM = 8  # the fp64 yardstick's micro-batches: a query, 2 documents


def _maxp_step_batch(seed: int) -> dict:
    """MAXP_STEP_QUERIES queries of MAXP_STEP_QUERY_LEN and as many
    positive and negative documents of MAXP_STEP_DOC_LEN (RoBERTa ids,
    ``<s>`` then ids, padding 1): lengths from 256, so later chunks are
    often empty (their first token padding); positive 1 is chunk 0
    alone, negative 2 chunks 0 and 1."""
    import numpy as np
    rs = np.random.RandomState(seed)
    B = MAXP_STEP_QUERIES

    def rows(seq, lengths):
        ids = rs.randint(3, 50265, (B, seq))
        ids[:, 0] = 0
        mask = np.arange(seq)[None] < lengths[:, None]
        return np.where(mask, ids, 1).astype(np.int32), mask.astype(np.int32)
    b = {}
    b["query_ids"], b["query_mask"] = rows(
        MAXP_STEP_QUERY_LEN, rs.randint(8, MAXP_STEP_QUERY_LEN + 1, B))
    for side in ("pos", "neg"):
        lengths = rs.randint(256, MAXP_STEP_DOC_LEN + 1, B)
        lengths[1 if side == "pos" else 2] = 300 if side == "pos" else 700
        b[f"{side}_ids"], b[f"{side}_mask"] = rows(MAXP_STEP_DOC_LEN,
                                                   lengths)
    return b


def _raw_grads(model, batch, accum: int, multichunk: bool) -> tuple:
    """One in-batch step without dropout, lr 0 and no clipping: (metrics,
    the raw gradients)."""
    import torch
    from ance_tpu_torch.train import dpr_trainer, trainer
    state = trainer.init_train_state(model, trainer.make_optimizer(
        model, "lamb", 0.0, max_grad_norm=0.0))
    _, metrics = dpr_trainer.make_dpr_train_step(
        accum, multichunk=multichunk, deterministic=True)(state, batch, None)
    torch.cuda.synchronize()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = None
    return {k: float(v) for k, v in metrics.items()}, grads


def _fp64_distances(grads: dict, g64: dict) -> dict:
    """An fp32 step's gradients against the fp64 step's: the worst element
    against the element bound (|g - g64| / (1e-6 + 1e-5 |g64|), at most 1
    within it) and the worst tensor against the normwise one (|g - g64| /
    (1e-4 |g64| + 1e-6 |G64|), likewise), each with its tensor. Printed
    and kept, not held: fp32's own distance from fp64 is the finding
    (a tiny encoder on the CPU already exceeds the element bound 2.8x,
    ``tests/test_torch_dpr.py``)."""
    total = math.sqrt(sum(g.norm().item() ** 2 for g in g64.values()))
    element, normwise = [], []
    for n, w in g64.items():
        d = grads[n].double() - w
        element.append(((d.abs() / (1e-6 + 1e-5 * w.abs())).max().item(), n))
        normwise.append((d.norm().item()
                         / (1e-4 * w.norm().item() + 1e-6 * total), n))
    (e, e_at), (m, m_at) = max(element), max(normwise)
    return {"element_excess": e, "element_worst": e_at,
            "element_bound_holds": e <= 1.0, "normwise_excess": m,
            "normwise_worst": m_at}


def _demo_maxp_step() -> dict:
    """(a) ``rdot_nll_multi_chunk`` at RoBERTa-base width from seeded
    weights (init std 0.05, so the in-batch scores are not all alike)
    through ``make_dpr_train_step(multichunk=True)``: in bf16 with
    attention dropout 0 (#2 / #3 on the 64 chunk rows of a step, launches
    == 12 a document pass, the first call of each held to plain), its
    step ms and peak memory; then in fp32 the GradCache step (accumulation
    2) against the unaccumulated one on the same batch, and both against
    the step in fp64 (``FP64_ACCUM`` micro-batches; the einsum attention,
    no kernel takes fp64)."""
    import numpy as np
    import torch
    from ance_tpu_torch.models.registry import get_model_spec
    from ance_tpu_torch.train import dpr_trainer, trainer
    spec = get_model_spec("rdot_nll_multi_chunk")
    batch = _maxp_step_batch(20)
    layers = 12

    # bf16, the kernels: MAXP_STEP_STEPS steps, dropout as trained but in
    # the attention (0 there, so #2 / #3 run)
    model = spec.build(dtype=torch.bfloat16, config_overrides={
        "attention_dropout": 0.0, "initializer_range": 0.05}).cuda()
    state = trainer.init_train_state(model, trainer.make_optimizer(
        model, "lamb", 1e-5))
    step = dpr_trainer.make_dpr_train_step(multichunk=True)
    gen = torch.Generator().manual_seed(0)
    fwd, bwd, times, losses = {}, {}, [], []
    torch.cuda.reset_peak_memory_stats()
    _reset_attention_counts()
    with picked_calls("forward", (0,), fwd), \
            picked_calls("backward", (0,), bwd):
        for _ in range(MAXP_STEP_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch, gen)
            losses.append(float(m["loss"]))
            times.append((time.perf_counter() - t0) * 1e3)
    launches = _attention_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = ({"fused_fwd_bf16": layers * MAXP_STEP_STEPS},
            {"fused_bwd_bf16": layers * MAXP_STEP_STEPS})
    check(launches == want, f"demo (a) MaxP in-batch step: #2 / #3 "
          f"launches {launches}, not {want} (12 a document pass)")
    check(all(math.isfinite(x) for x in losses), f"demo (a): losses {losses}")
    step_ms = statistics.median(times[TIMED_FROM:])
    path = _attention_on_operands(fwd, bwd, "demo (a) MaxP in-batch step")
    print(f"demo (a) MaxP in-batch step (rdot_nll_multi_chunk, bf16, "
          f"{MAXP_STEP_QUERIES} queries x {MAXP_STEP_QUERY_LEN}, "
          f"{2 * MAXP_STEP_QUERIES} documents x {MAXP_STEP_DOC_LEN}): step "
          f"{step_ms:.1f} ms (median after {TIMED_FROM}), peak {peak:.2f} "
          f"GiB, losses {[round(x, 4) for x in losses]}; #2 / #3 launches "
          f"{launches}; first calls against plain {path}", flush=True)
    start = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    del model, state, fwd, bwd
    torch.cuda.empty_cache()

    # fp32: accumulation 1 and 2, then the fp64 yardstick; no dropout
    quiet = {"attention_dropout": 0.0, "hidden_dropout": 0.0}
    gc, grads = {}, {}
    model = spec.build(config_overrides=quiet)
    model.load_state_dict(start)
    model = model.cuda()
    with torch.no_grad():  # the batch's largest |query . chunk| score
        q, ctx, _ = dpr_trainer.encode_towers(
            model.eval(), trainer.batch_to_device(batch, "cuda"),
            multichunk=True)
        top = torch.einsum("qd,jcd->qjc", q, ctx).abs().max().item()
        del q, ctx
    for accum in (1, 2):
        _reset_attention_counts()
        gc[accum], grads[accum] = _raw_grads(model, batch, accum, True)
        gc[accum]["launches"] = _attention_counts()
    del model
    torch.cuda.empty_cache()
    check(gc[2]["launches"] == ({"flash_fwd_pieces": 2 * 2 * layers},
                                {"fused_bwd_pieces": 2 * layers}),
          f"demo (a) fp32 GradCache: #2 / #3 launches {gc[2]['launches']}, "
          "not each micro-batch's documents encoded twice and pulled back "
          "once on the pieces routes")
    f64 = spec.build(dtype=torch.float64, attention_impl="xla",
                     config_overrides=quiet)
    f64.load_state_dict(start)
    f64 = f64.double().cuda()
    gc64, g64 = _raw_grads(f64, batch, FP64_ACCUM, True)
    del f64
    torch.cuda.empty_cache()
    rel = abs(gc[2]["loss"] - gc[1]["loss"]) / abs(gc[1]["loss"])
    # the loss is a difference of scores whose fp32 rounding scales with
    # them: held within 1e-6 of the larger of |loss| and the largest
    # |score| (one run read 2.0e-6 of |loss| ~19 at scores of hundreds,
    # another 2.0e-7)
    loss_tol = 1e-6 * max(abs(gc[1]["loss"]), top)
    total = math.sqrt(sum(g.norm().item() ** 2 for g in grads[1].values()))
    grad_excess, worst = max(
        ((grads[2][n] - g).norm().item()
         / (1e-4 * g.norm().item() + 1e-6 * total), n)
        for n, g in grads[1].items())
    vs64 = {a: _fp64_distances(grads[a], g64) for a in (1, 2)}
    check(abs(gc[2]["loss"] - gc[1]["loss"]) <= loss_tol
          and gc[2]["correct"] == gc[1]["correct"] and grad_excess <= 1.0,
          f"demo (a) fp32 GradCache: {gc[2]} against {gc[1]} (loss rel "
          f"{rel}, tolerance {loss_tol} at largest |score| {top}; {worst} "
          f"at {grad_excess} of its bound)")
    print(f"demo (a) fp32 GradCache (accumulation 2) vs one pass: loss "
          f"{gc[2]['loss']!r} / {gc[1]['loss']!r} (rel {rel:.3g}; bound "
          f"{loss_tol:.3g}, 1e-6 of the largest |score| {top:.1f} or of "
          f"|loss|; fp64 {gc64['loss']!r}), correct {gc[2]['correct']:.0f} / "
          f"{gc[1]['correct']:.0f} / fp64 {gc64['correct']:.0f}, every "
          f"tensor within 1e-4 of its norm + 1e-6 of the whole gradient's "
          f"(worst {worst} at {grad_excess:.3g}); against the fp64 step "
          f"(accumulation {FP64_ACCUM}): one pass element "
          f"{vs64[1]['element_excess']:.3g}x the bound 1e-6 + 1e-5 rel "
          f"({vs64[1]['element_worst']}), normwise "
          f"{vs64[1]['normwise_excess']:.3g}; GradCache element "
          f"{vs64[2]['element_excess']:.3g}x ({vs64[2]['element_worst']}), "
          f"normwise {vs64[2]['normwise_excess']:.3g}; #2 / #3 launches "
          f"{gc[2]['launches']}", flush=True)
    del grads, g64
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "step_ms_all": times, "peak_gib": peak,
            "losses": losses, "launches": launches, "path_operands": path,
            "gradcache": gc, "gradcache_fp64": gc64,
            "gradcache_loss_rel": rel, "gradcache_loss_tolerance": loss_tol,
            "largest_score": top, "gradcache_worst_tensor":
            [worst, grad_excess], "against_fp64": vs64,
            "shape": {"queries": MAXP_STEP_QUERIES,
                      "query_len": MAXP_STEP_QUERY_LEN,
                      "documents": 2 * MAXP_STEP_QUERIES,
                      "doc_len": MAXP_STEP_DOC_LEN}}


def _demo_firstp(work: Path) -> dict:
    """(b) ``experiments/demo.py`` (the FirstP demo, bf16, LAMB 1e-3, 1,000
    in-batch warmup steps, the pipelined loop) cut only in corpus size, to
    DEMO_PASSAGES, and to DEMO_LOOP_STEPS loop steps, under the loop's
    probes: bootstrap dev NDCG@10 below DEMO_CHANCE, the last refresh at
    DEMO_LEARNED or above, every mining pass equal to a scan, #1's
    launches == the S and M items, and #1 on the loop's own D = 256
    operands against plain and the exact maxima, timed beside its bound."""
    import torch
    from ance_tpu_torch.experiments import demo
    from ance_tpu_torch.ops.topk import (_pad_rows, blockmax_scores,
                                         blockmax_scores_reference)
    from ance_tpu_torch.utils.timing import (clocks_text, cuda_ms,
                                             timed_in_turns)
    log = work / "demo_firstp.jsonl"
    t0 = time.perf_counter()
    with _loop_probes() as probes:
        reset_blockmax_counts()
        out = demo.main(["--passages", str(DEMO_PASSAGES), "--steps",
                         str(DEMO_LOOP_STEPS), "--log", str(log)])
        launches = blockmax_counts()
        loop = out["loop"]
        seconds = time.perf_counter() - t0
        history = loop.history
        searched = sum(tag in "SM" for tag in loop.schedule_trace)
        check(launches == {"blockmax_pieces_f32": searched},
              f"demo (b): block-max launches {launches}, not one a search "
              f"item ({searched})")
        check(history[0]["dev_ndcg"] < DEMO_CHANCE, f"demo (b): bootstrap "
              f"dev NDCG@10 {history[0]['dev_ndcg']}, not chance")
        check(history[-1]["dev_ndcg"] >= DEMO_LEARNED, f"demo (b): last "
              f"refresh {history[-1]}, below {DEMO_LEARNED}")
        mined = _mining_equals_scan(probes, "demo (b)")
        cases = _phase1_on_loop_operands(probes, "f32xf32", "demo firstp")
        # the dev operands again: the exact maxima, the kernel's time
        q, corpus = probes["phase1"]["dev"]
        q, c = q.contiguous(), _pad_rows(corpus, CHUNK_ROWS)
        del probes, loop, out
    got = blockmax_scores(q, c, chunk_rows=CHUNK_ROWS)
    want = blockmax_scores_reference(q, c)
    exact = (q.double() @ c.double().T).reshape(q.shape[0], -1, 16).amax(-1)
    k_err = (got.double() - exact).abs().max().item()
    p_err = (want.double() - exact).abs().max().item()
    check(k_err <= FLOAT_ATOL, f"demo (b): #1 is {k_err} from the exact "
          f"maxima, > {FLOAT_ATOL}")
    times, sampled = timed_in_turns({"ms": lambda: blockmax_scores(
        q, c, chunk_rows=CHUNK_ROWS)})
    plain_ms = cuda_ms(lambda: blockmax_scores_reference(q, c))
    nq, nc, dim = q.shape[0], c.shape[0], q.shape[1]
    moved = (nq + nc) * dim * 4 + nq * (nc // 16) * 4
    b_ms, b_by = bound(moved, 2.0 * nq * nc * dim
                       * FP32_PIECE_PRODUCTS["f32xf32"], "bf16")
    case = dict(cases[0], shape="demo firstp dev (timed)", ms=times["ms"],
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                clocks=sampled, max_abs_err_exact=k_err,
                plain_max_abs_err_exact=p_err,
                fp32_rate_bound_ms=bound(moved, 2.0 * nq * nc * dim,
                                         "f32")[0])
    print(f"kernel f32xf32    demo firstp dev Q={nq} N={nc} D={dim} "
          f"(blockmax_pieces_f32): kernel {times['ms']:.4f} ms  plain "
          f"{plain_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by}); against the "
          f"exact maxima: kernel {k_err:.3g}, plain {p_err:.3g}  "
          f"{clocks_text(sampled)}", flush=True)
    del got, want, exact, q, c
    torch.cuda.empty_cache()
    crossing = next((h["step"] for h in history
                     if h["dev_ndcg"] >= DEMO_LEARNED), None)
    print(f"demo (b) FirstP, {DEMO_PASSAGES} passages: bootstrap "
          f"{history[0]['dev_ndcg']:.4f}, last refresh "
          f"{history[-1]['dev_ndcg']:.4f} at step {history[-1]['step']} "
          f"({len(history)} refreshes, {DEMO_LEARNED} first at step "
          f"{crossing}), {mined} mining passes equal to the scan, #1 "
          f"launches {launches}; {seconds:.1f} s", flush=True)
    return {"seconds": seconds, "refreshes": [
        {k: h[k] for k in ("refresh", "step", "dev_ndcg", "dev_recall")}
        for h in history], "crossed_at_step": crossing,
        "blockmax_kernels": launches, "mining_checked": mined,
        "kernel_cases": cases + [case]}


DEMO_CHILD_TIMEOUT_S = 900  # phase_demo (b)'s process, start to end


def phase_demo_step() -> dict:
    """The learning demos' paths, (a): the MaxP in-batch (multichunk) step
    at full width (``_demo_maxp_step``), its launches counted from 0 just
    before it and read just after."""
    a = _demo_maxp_step()
    check(no_reference_modules(), "the port imported jax or ance_tpu")
    return a


def start_demo_firstp(work: Path) -> dict:
    """Start phase_demo (b), the FirstP demo cut in corpus size, in a
    process of its own (this script with ``--demo-firstp``), so that it
    runs beside the phases that follow it (DPR, SEED, mesh, tp): its loop
    is bound by the host (~93% of the card idle), theirs mostly by their
    worker and rank processes. Their times are taken with it beside them,
    and DPR's 21M capacity check with its ~2 GiB on the card."""
    out = work / "demo_firstp.json"
    log = open(work / "demo_firstp.out", "w")
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--demo-firstp",
         str(work), str(out)], stdout=log, stderr=subprocess.STDOUT)
    return {"proc": proc, "out": out, "log": log, "t0": time.perf_counter()}


def phase_demo(child: dict) -> dict:
    """The learning demos' paths, (b): wait for the FirstP demo's process
    (``start_demo_firstp``), print its refresh lines and checks, and fail
    where it failed."""
    proc = child["proc"]
    try:
        rc = proc.wait(timeout=max(1.0, DEMO_CHILD_TIMEOUT_S - (
            time.perf_counter() - child["t0"])))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = None
    child["log"].close()
    wall = time.perf_counter() - child["t0"]
    text = (child["out"].parent / "demo_firstp.out").read_text()
    for line in text.splitlines():
        if line.startswith(("{\"event\": \"refresh", "{\"event\": \"boot",
                            "{\"event\": \"warmup_done", "{\"idle",
                            "{\"event\": \"done", "kernel ", "demo (b)",
                            "Traceback", "  ", "RuntimeError", "chip_smoke")):
            print(line, flush=True)
    check(rc == 0, f"demo (b): its process exited {rc} after {wall:.1f} s "
          f"(limit {DEMO_CHILD_TIMEOUT_S} s)")
    b = json.loads(child["out"].read_text())
    b["process_wall_s"] = wall
    print(f"demo (b): the process took {wall:.1f} s, start to end "
          "(beside the DPR, SEED, mesh and tp phases)", flush=True)
    return b


def demo_firstp_child(work: str, out: str) -> int:
    """``chip_smoke.py --demo-firstp WORK OUT``: phase_demo (b) in this
    process (the kernels already built by the parent), its result as JSON
    in OUT; a failed check exits non-zero."""
    sys.path.insert(0, str(ROOT))
    import ance_tpu_torch  # noqa: F401  (TF32 off before any work)
    b = _demo_firstp(Path(work))
    check(no_reference_modules(), "the port imported jax or ance_tpu")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"demo (b) numbers ({smi}): {b['seconds']:.1f} s", flush=True)
    Path(out).write_text(json.dumps(b))
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--demo-firstp"]:
        return demo_firstp_child(*sys.argv[2:4])
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "ance_tpu_torch" / "csrc" / "blockmax.cu").exists():
        print("chip_smoke: run from a checkout of the repository "
              "(ance_tpu_torch/ is not beside this file)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import ance_tpu_torch  # noqa: F401  (TF32 off before any work)
    # no tokenizer or model is looked up on a hub: the smoke needs no
    # network (spawned workers inherit this)
    os.environ["HF_HUB_OFFLINE"] = os.environ["TRANSFORMERS_OFFLINE"] = "1"

    phase_s = {}

    def timed(phase, *args):
        """``phase(*args)``, its wall seconds kept under its name."""
        t0 = time.perf_counter()
        out = phase(*args)
        key = phase.__name__.removeprefix("phase_")
        phase_s[key] = time.perf_counter() - t0
        print(f"phase {key}: {phase_s[key]:.1f} s", flush=True)
        return out

    name = timed(phase_device)
    build_s, built = timed(phase_build)
    machine_code = timed(phase_machine_code, built)
    cases, searches = timed(phase_kernel)
    topk_int8 = timed(phase_topk_int8)
    ties = timed(phase_ties)
    attn_cases, crossover = timed(phase_attention)
    bwd_cases, functions = timed(phase_attention_backward)
    seq128 = timed(phase_seq128)
    mirror = timed(phase_mirror)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        serve = timed(phase_serve, work)
        ivf = timed(phase_ivf, work)
        maxp = timed(phase_maxp, work)
        train = timed(phase_train, work)
        maxp_fp32 = timed(phase_maxp_fp32, work)
        generate = timed(phase_generate, work)
        warmup = timed(phase_warmup, work)
        ance_loop = timed(phase_ance_loop, work, generate, train)
        demo = {"maxp_step": timed(phase_demo_step)}
        child = start_demo_firstp(work)
        try:
            dpr = timed(phase_dpr, work)
            seed = timed(phase_seed, work)
            mesh = timed(phase_mesh, work)
            tp = timed(phase_tp, work)
        except BaseException:
            child["proc"].kill()
            raise
        demo["firstp"] = timed(phase_demo, child)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    parity = timed(phase_step_parity)
    print("phase seconds " + json.dumps(
        {k: round(v, 1) for k, v in phase_s.items()}), flush=True)
    headline = next(c for c in cases
                    if c["dtypes"] == "bf16xbf16" and c["shape"] == "dev")

    def entry(name, source, replaces, launches, head, shape, build, own):
        return {"name": name, "route": "cuda",
                "source": f"ance_tpu_torch/csrc/{source}.cu",
                "replaces": replaces, "launches": launches,
                "max_abs_err": head["max_abs_err"],
                "tolerance": head.get("tolerance"), "ms": head["ms"],
                "plain_ms": head["plain_ms"],
                "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                "library_ms": head.get("library_ms"), "shape": shape,
                "clocks": head["clocks"], "build_s": build_s[build],
                "cases": own}

    def attention_entry(kernel, replaces, B, S, launches):
        own = [c for c in attn_cases if c["name"] == kernel]
        head = next(c for c in own if c["dtype"] == "bf16" and c["B"] == B
                    and c["S"] == S and not c["strided"])
        return entry(kernel, kernel, replaces, launches, head,
                     f"bf16 B={B} S={S} H=12 D=64", kernel, own)

    def seq128_entry(kernel, replaces, variant):
        head = seq128[kernel]
        out = entry(kernel, "attn128", replaces,
                    mirror[variant]["launches"][kernel], head,
                    f"bf16 B={head['B']} S={head['S']} H={head['H']} "
                    "(12 heads of 64)", "attn128", [head])
        if head["unfused_ms"] is not None:
            out["unfused_ms"] = head["unfused_ms"]
            out["launch_split_ms"] = head["launch_split_ms"]
        return out

    # launches: each path's own run — the MaxP serve path for the
    # forward kernels and block-max (its HTTP searches; its corpus encode;
    # the encode of its first batches with --attention flash), the MaxP
    # train path for the backward, one mirror-encoder forward of the
    # fused128 / block variant for #5 / #6. No PyTorch call computes the
    # block maxima, or the whole attention sub-block (#6: the unfused
    # composition is timed instead), so those have no library time.
    bwd_head = next(c for c in bwd_cases if c["dtype"] == "bf16"
                    and c["B"] == 64 and c["S"] == 512 and not c["strided"])
    # kernel #1: blockmax_bf16 with the CUDA-core and WMMA routes' cases
    # (shapes no tensor map describes), then the fp32-query routes' two
    # kernels and the int8 routes' two, each with its launches on the path
    # that runs it (generate over an fp32 / a dims index; the int8 phase-1
    # study); the launches of every path by kernel beside the first
    apart = ("blockmax_pieces_f32", "blockmax_pieces_int8", "blockmax_int8",
             "blockmax_bf16_int8")
    # phase 1 on generate's and the pipelined loop's operands
    cases += generate.pop("kernel_cases") + ance_loop.pop("kernel_cases") \
        + dpr.pop("kernel_cases") + seed.pop("kernel_cases") \
        + demo["firstp"].pop("kernel_cases")
    own = [c for c in cases if c["kernel"] not in apart]
    blockmax = entry("blockmax_scores", "blockmax", "ance_tpu/ops/topk.py:90",
                     maxp["blockmax_launches"],
                     dict(headline, max_abs_err=max(c["max_abs_err"]
                                                    for c in own)),
                     "bf16 Q=2048 x N=1000448 x D=768, block 16", "blockmax",
                     own)
    # cuBLAS's product of the same operands (no block maxima): a rate
    # reference beside the kernel, not a yardstick
    blockmax["gemm_ms"] = headline["gemm_ms"]
    blockmax["launches_by_path"] = {
        "firstp_serve": serve["blockmax_kernels"],
        "maxp_serve": maxp["blockmax_kernels"],
        "generate": generate["blockmax_kernels"],
        "generate_index_quantize_dims": generate["dims_blockmax_kernels"],
        "warmup_generate": warmup["blockmax_kernels"],
        "ance_loop": ance_loop["firstp"]["blockmax_kernels"],
        "ance_loop_dims": ance_loop["dims"]["blockmax_kernels"],
        "ance_loop_maxp": ance_loop["maxp"]["blockmax_kernels"],
        "topk_int8_study": topk_int8["launches"],
        "ivf_phase": ivf["blockmax_kernels"],
        **{name: g["blockmax_kernels"]
           for name, g in dpr["generate"].items()},
        "seed_serve": seed["serve_blockmax_kernels"],
        # by rank (two gloo ranks sharing the card; one NCCL rank)
        "mesh_index": mesh["index"]["launches"],
        "mesh_ance_loop": mesh["ance_loop"]["launches"],
        # by rank: generate at tp 2 and tp 1, generate-dpr at tp 2
        **{f"tp_{k}": tp[k]["launches"] for k in (
            "generate_tp2", "generate_dp2", "generate_dpr_tp2")}}
    fp32_entries = []
    for kernel, dtypes, launches in (
            ("blockmax_pieces_f32", "f32xf32",
             generate["blockmax_kernels"]["blockmax_pieces_f32"]),
            ("blockmax_pieces_int8", "f32xint8",
             generate["dims_blockmax_kernels"]["blockmax_pieces_int8"])):
        own = [c for c in cases if c["kernel"] == kernel]
        head = next(c for c in own if c["shape"] == "dev")
        e = entry(kernel, "blockmax", "ance_tpu/ops/topk.py:90", launches,
                  dict(head, max_abs_err=max(c["max_abs_err"] for c in own)),
                  f"{dtypes} Q=2048 x N=1000448 x D=768, block 16",
                  "blockmax", own)
        e["gemm_ms"] = head["gemm_ms"]
        e["fp32_rate_bound_ms"] = head["fp32_rate_bound_ms"]
        # generate from a warmup and generate-dpr too
        e["launches_by_path"] = {"generate": launches, **{
            name: g["blockmax_kernels"].get(kernel, 0)
            for name, g in dpr["generate"].items()},
            "ivf_phase": ivf["blockmax_kernels"].get(kernel, 0)}
        if kernel == "blockmax_pieces_f32":
            e["launches_by_path"]["mesh_ance_loop"] = {
                rank: n.get(kernel, 0) for rank, n in
                mesh["ance_loop"]["launches"].items()}
            for k in ("generate_tp2", "generate_dp2", "generate_dpr_tp2"):
                e["launches_by_path"][f"tp_{k}"] = {
                    rank: n.get(kernel, 0) for rank, n in
                    tp[k]["launches"].items()}
            e["launches_by_path"]["warmup_generate"] = \
                warmup["blockmax_kernels"][kernel]
            e["launches_by_path"]["seed_generate"] = \
                seed["blockmax_kernels"][kernel]
            # the FirstP demo's loop at 16,384 x 256 (phase_demo (b))
            e["launches_by_path"]["demo_firstp"] = \
                demo["firstp"]["blockmax_kernels"].get(kernel, 0)
        fp32_entries.append(e)
    # the int8 routes, with their launches on the int8 phase-1 study's path
    # and their yardstick (the same product at a library's rate)
    int8_entries = []
    for kernel, dtypes in (("blockmax_int8", "int8xint8"),
                           ("blockmax_bf16_int8", "bf16xint8")):
        own = [c for c in cases if c["kernel"] == kernel]
        head = next(c for c in own if c["shape"] == "dev")
        e = entry(kernel, "blockmax", "ance_tpu/ops/topk.py:90",
                  topk_int8["launches"].get(kernel, 0),
                  dict(head, max_abs_err=max(c["max_abs_err"] for c in own)),
                  f"{dtypes} Q=2048 x N=1000448 x D=768, block 16",
                  "blockmax", own)
        e.update(yardstick=head["yardstick"],
                 yardstick_ms=head["yardstick_ms"])
        if "max_abs_err_exact" in head:
            e["max_abs_err_exact"] = max(c["max_abs_err_exact"] for c in own)
        int8_entries.append(e)
    # the fused kernels' fp32 pieces route: the forward with its launches
    # on the fp32 MaxP serve path, the backward with those of the fp32
    # MaxP train path; max_abs_err over the route's cases and the path's
    # own operands
    fp32_attention = []
    for entry_name, kernel, replaces, own, launches, path in (
            ("fused_attention_f32", "flash_fwd_pieces",
             "ance_tpu/ops/fused_attention.py:40",
             [c for c in attn_cases if c["name"] == "fused_attention"
              and c["kernel"] == "flash_fwd_pieces"],
             maxp_fp32["serve_fused_launches"]["flash_fwd_pieces"],
             maxp_fp32["path_forward"]),
            ("flash_attention_f32", "flash_fwd_pieces",
             "ance_tpu/ops/flash_attention.py:34",
             [c for c in attn_cases if c["name"] == "flash_attention"
              and c["kernel"] == "flash_fwd_pieces"],
             maxp_fp32["flash_launches"]["flash_fwd_pieces"],
             maxp_fp32["path_flash"]),
            ("fused_attention_bwd_f32", "fused_bwd_pieces",
             "ance_tpu/ops/fused_attention.py:97",
             [c for c in bwd_cases if c["kernel"] == "fused_bwd_pieces"],
             maxp_fp32["train_fused_backward_launches"]["fused_bwd_pieces"],
             maxp_fp32["path_backward"])):
        # one kernel, flash_fwd_pieces, is the fp32 forward of both
        source = "flash_attention" if kernel == "flash_fwd_pieces" \
            else "fused_attention"
        # the fused routes' head at S = 512, the flash route's at B=8 S=2048
        head = next(c for c in own if c["layout"] == "contiguous"
                    and (c["S"], c["B"]) in ((512, 32), (512, 64), (2048, 8)))
        e = entry(entry_name, source, replaces, launches,
                  dict(head, max_abs_err=max([c["max_abs_err"] for c in own]
                                             + [path["max_abs_err"]])),
                  f"f32 B={head['B']} S={head['S']} H=12 D=64 ({kernel})",
                  source, own)
        e.update(kernel=kernel, fp32_rate_bound_ms=head["fp32_rate_bound_ms"],
                 exact=head["exact"], path_operands=path)
        gc_fwd, gc_bwd = dpr["gradcache_vs_one_pass"][DPR_ACCUM]["launches"]
        if entry_name == "fused_attention_f32":
            e["launches_by_path"] = {
                "maxp_fp32_serve": launches,
                "dpr_generate_fp32": dpr["generate"]["dpr_generate_fp32"][
                    "fused_forward"][kernel],
                "dpr_gradcache_fp32": gc_fwd[kernel],
                "demo_maxp_gradcache_fp32": demo["maxp_step"]["gradcache"][
                    2]["launches"][0][kernel]}
            e["dpr_path_operands"] = dpr["generate"]["dpr_generate_fp32"][
                "path_forward"]
            e["dpr_gradcache_operands"] = dpr["gradcache_path"]["forward"]
        elif entry_name == "fused_attention_bwd_f32":
            e["launches_by_path"] = {
                "maxp_fp32_train": launches,
                "dpr_gradcache_fp32": gc_bwd[kernel],
                "demo_maxp_gradcache_fp32": demo["maxp_step"]["gradcache"][
                    2]["launches"][1][kernel]}
            e["dpr_gradcache_operands"] = dpr["gradcache_path"]["backward"]
        fp32_attention.append(e)
    fused_fwd = attention_entry("fused_attention",
                                "ance_tpu/ops/fused_attention.py:40", 128,
                                512, maxp["fused_launches"])
    fused_fwd["launches_by_path"] = {
        "maxp_serve": maxp["fused_launches"],
        "ance_loop_maxp_encode": ance_loop["maxp"]["fused_forward_in_items"],
        "ance_loop_maxp_steps": ance_loop["maxp"]["fused_forward_in_steps"],
        "dpr_train": dpr["train_fused_forward"]["fused_fwd_bf16"],
        "dpr_generate": dpr["generate"]["dpr_generate"]["fused_forward"][
            "fused_fwd_bf16"],
        "dpr_generate_dims": dpr["generate"]["dpr_generate_dims"][
            "fused_forward"]["fused_fwd_bf16"],
        "seed_pretrain": seed["pretrain_fused_forward"]["fused_fwd_bf16"],
        "mesh_dpr": {rank: n.get("fused_fwd_bf16", 0) for rank, n in
                     mesh["dpr"]["fused_forward"].items()},
        "demo_maxp_inbatch_step": demo["maxp_step"]["launches"][0][
            "fused_fwd_bf16"]}
    fused_fwd["demo_path_operands"] = demo["maxp_step"]["path_operands"][
        "forward"]
    fused_fwd["dpr_path_operands"] = dpr["train_path"]["forward"]
    fused_fwd["seed_path_operands"] = seed["pretrain_path"]["forward"]
    fused_bwd = entry("fused_attention_bwd", "fused_attention",
                      "ance_tpu/ops/fused_attention.py:97",
                      train["maxp"]["fused_backward_launches"], bwd_head,
                      "bf16 B=64 S=512 H=12 D=64", "fused_attention",
                      bwd_cases)
    fused_bwd["launches_by_path"] = {
        "maxp_train": train["maxp"]["fused_backward_launches"],
        "ance_loop_maxp": ance_loop["maxp"]["fused_backward"],
        "dpr_train": dpr["train_fused_backward"]["fused_bwd_bf16"],
        "seed_pretrain": seed["pretrain_fused_backward"]["fused_bwd_bf16"],
        "mesh_dpr": {rank: n.get("fused_bwd_bf16", 0) for rank, n in
                     mesh["dpr"]["fused_backward"].items()},
        "demo_maxp_inbatch_step": demo["maxp_step"]["launches"][1][
            "fused_bwd_bf16"]}
    fused_bwd["demo_path_operands"] = demo["maxp_step"]["path_operands"][
        "backward"]
    fused_bwd["dpr_path_operands"] = dpr["train_path"]["backward"]
    fused_bwd["seed_path_operands"] = seed["pretrain_path"]["backward"]
    print(json.dumps({"kernels": [
        blockmax, *fp32_entries, *int8_entries, fused_fwd,
        attention_entry("flash_attention", "ance_tpu/ops/flash_attention.py:34",
                        8, 2048, maxp["flash_launches"]),
        fused_bwd, *fp32_attention,
        seq128_entry("fused128", "docs/perf_attn128_r3.py:44", "fused128"),
        seq128_entry("fused_block", "docs/perf_attn128_r3.py:88", "block")],
        "fused_function": functions, "machine_code": machine_code,
        "index_search": searches, "ties": ties,
        "crossover": crossover, "serve": serve, "maxp": maxp,
        "ivf": ivf, "train": train, "maxp_fp32": maxp_fp32,
        "step_parity": parity,
        "mirror_encoder": mirror,
        "generate": generate, "warmup": warmup, "ance_loop": ance_loop,
        "dpr": dpr, "seed": seed, "topk_int8": topk_int8, "mesh": mesh,
        "tp": tp, "demo": demo, "phase_seconds": phase_s}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
