#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``ance_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the four kernel sources of
``ance_tpu_torch/csrc`` (block-max top-k, fused and flash attention, the
seq-128 attention pair; one nvcc each, all at once), prints ptxas's
registers and spills and the SASS counts of HGMMA (wgmma) and UTMALDG
(TMA loads) of the thirteen wgmma kernels (the fused forward and its two
backward passes on bf16, the two backward passes on fp32 pieces; the
flash forward on bf16 and on fp32 pieces, the latter also the fused
attention's fp32 forward; seq-128 kernel #5 and kernel #6's two launches;
block-max's bf16 route and its two fp32-query kernels), and then:

  * block-max: the kernel against its plain PyTorch version at the FirstP
    search shapes (1,000,448 × 768 corpus; Q=2048 k=10 and Q=512 k=200) for
    every dtype pair, the bf16 and fp32-query routes timed in turns with
    cuBLAS's product of the same operands (a rate reference: it takes no
    maxima) and with the kernel at D=64 (a tile's fixed part); fp32
    queries over a corpus view 4 bytes off alignment (``blockmax_simt``);
    ``FlatIPIndex`` block-max ids against the scan for the none / bf16 /
    dims indexes (each search's phase-1 kernel counted), each search's
    device time split by ``torch.profiler``
    (phase 1 and the largest kernels); and the tie check: a 1,000,448 × 768
    bf16 index in which every 7th row is one vector that the queries rank
    inside their top k, where block-max ids must equal the scan's;
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
    checkpoint, then ``run_ance_cycles`` (2 cycles x 3 steps).

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
                 "blockmax_pieces_int8"),
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
                "bf16xint8": "blockmax_wmma", "int8xint8": "blockmax_wmma"}
INDEX_KERNEL = {"none": "blockmax_pieces_f32", "bf16": "blockmax_bf16",
                "dims": "blockmax_pieces_int8"}


def phase_machine_code(built: dict) -> dict:
    """For each wgmma kernel (``WGMMA_KERNELS``): ptxas's registers, stack
    and spills (from the build's ``-Xptxas -v`` report, so only when this
    run built the library), the dynamic shared memory it is launched with
    and, where ``cuobjdump`` exists, the SASS counts of HGMMA (wgmma) and
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
                current = next((n for n in kernels if n in m.group(1)), None)
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
                    current = next((n for n in kernels if n in m.group(1)),
                                   None)
                    if current:
                        own[current].update(hgmma=0, utmaldg=0)
                elif current:
                    own[current]["hgmma"] += "HGMMA" in line
                    own[current]["utmaldg"] += "UTMALDG" in line
        for name, info in own.items():
            print(f"machine code {name}: {info}", flush=True)
            if log:
                check("registers" in info, f"no ptxas report for {name}")
            if "hgmma" in info:
                check(info["hgmma"] > 0 and info["utmaldg"] > 0,
                      f"{name}: no HGMMA / UTMALDG in its SASS")
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
                                         blockmax_scores_reference)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    n_pad = -(-N_CORPUS // CHUNK_ROWS) * CHUNK_ROWS
    corpus = torch.randn(n_pad, DIM, generator=g, device=dev)
    corpus[N_CORPUS:] = 0  # topk_blockmax pads with zero rows
    c8, dim_scales = quantize_dims_int8(corpus[:N_CORPUS])
    c8 = torch.cat([c8, c8.new_zeros(n_pad - N_CORPUS, DIM)])
    queries = {name: torch.randn(q, DIM, generator=g, device=dev)
               for name, (q, _) in SHAPES.items()}

    def int8_rows(q):  # per-row symmetric, as topk_blockmax(phase1 int8)
        qmax = q.abs().amax(1, keepdim=True).clamp_min(1e-12)
        return torch.round(q * (127.0 / qmax)).clamp(-127, 127).to(torch.int8)

    cases = []
    # the 1M search shapes for every dtype pair, and the serve phase's own
    # shape (bf16 index of N_PASSAGES rows, a 256-query request)
    serve_q = queries["dev"][:N_QUERIES].to(torch.bfloat16)
    shapes = [(shape, {
        "f32xf32": (q, corpus),
        "bf16xbf16": (q.to(torch.bfloat16), corpus.to(torch.bfloat16)),
        "f32xint8": (q * dim_scales, c8),
        "bf16xint8": ((q * dim_scales).to(torch.bfloat16), c8),
        "int8xint8": (int8_rows(q), c8),
    }) for shape, q in queries.items()]
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
            kernel_name = "blockmax_simt" if shape == "unaligned" \
                else ROUTE_KERNEL[dtypes]
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
            if dtypes == "int8xint8":
                check(got.dtype == torch.int32 and torch.equal(got, want),
                      f"{dtypes} {shape}: int32 block maxima differ")
                err = 0.0
            else:
                err = (got - want).abs().max().item()
                check(err <= FLOAT_ATOL, f"{dtypes} {shape}: max |err| "
                      f"{err} > {FLOAT_ATOL}")
            del got, want
            kernel = {"ms": lambda: blockmax_scores(qq, cc,
                                                    chunk_rows=CHUNK_ROWS)}
            # the wgmma routes at the search shapes, and how many piece
            # products each runs a k step (fp32 queries: bf16 pieces)
            products = WGMMA_PRODUCTS.get(dtypes) if shape in SHAPES \
                else None
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
            extra = {}
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
            nq, nc = qq.shape[0], cc.shape[0]
            moved = (nq * DIM * qq.element_size()
                     + nc * DIM * cc.element_size() + nq * (nc // 16) * 4)
            qtype = dtypes.split("x")[0]
            if qtype == "f32":
                b_ms, b_by = bound(moved, 2.0 * nq * nc * DIM
                                   * FP32_PIECE_PRODUCTS[dtypes], "bf16")
                extra["fp32_rate_bound_ms"] = bound(
                    moved, 2.0 * nq * nc * DIM, "f32")[0]
            else:
                b_ms, b_by = bound(moved, 2.0 * nq * nc * DIM, qtype)
            cases.append({"dtypes": dtypes, "shape": shape,
                          "kernel": kernel_name,
                          "Q": nq, "N": nc, "D": DIM,
                          "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": b_ms, "bound_by": b_by,
                          "clocks": sampled, **extra})
            gemm_text = (f"  cuBLAS GEMM {extra['gemm_ms']:.3f} ms  D=64 "
                         f"{extra['d64_ms']:.3f} ms: a tile "
                         f"{extra['tile_fixed_us']:.3f} us fixed + "
                         f"{extra['tile_step_us']:.3f} us a 64-column k step"
                         f" ({extra['tile_step_us_a_product']:.3f} a product)"
                         if products else "")
            fp32_text = (f", fp32 rate {extra['fp32_rate_bound_ms']:.3f} ms"
                         if "fp32_rate_bound_ms" in extra else "")
            print(f"kernel {dtypes:10s} {shape:6s} Q={qq.shape[0]:5d} "
                  f"N={cc.shape[0]} ({cases[-1]['kernel']}): max|err| "
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
    del corpus, c8, queries, offset, unaligned
    torch.cuda.empty_cache()
    return cases, searches


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
def first_call(direction: str, kept: list, function=None):
    """``FusedAttention.forward`` (``direction`` "forward": q, k, v, mask)
    or ``.backward`` ("backward": q, k, v, mask, do), or that of another
    autograd ``function`` (``FlashAttention``), wrapped so that ``kept``
    receives copies of the operands of its first call (floating ones in
    their own strides); the kernels' wrappers and their launch counts stay
    as they are."""
    import torch
    from ance_tpu_torch.ops.fused_attention import FusedAttention
    function = function or FusedAttention
    real = getattr(function, direction)

    def wrapper(ctx, *args):
        if direction == "backward":
            ops = (*ctx.saved_tensors, *args)
        else:
            ops = args
        if not kept:
            kept.extend(a if not torch.is_tensor(a) else _keep_layout(a)
                        if torch.is_floating_point(a) else a.clone()
                        for a in ops)
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
    fwd_ops = []
    reset()
    t0 = time.perf_counter()
    with first_call("forward", fwd_ops):
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
    flash_ops = []
    with TokenCache(str(docs / "passages")) as dc:
        reset()
        with first_call("forward", flash_ops, FlashAttention):
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
    q, k, v, mask = flash_ops
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
    bwd_ops = []
    reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with first_call("backward", bwd_ops):
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
    q, k, v, mask = fwd_ops
    got = fa.fused_attention_forward(q, k, v, mask)
    plain = fa.fused_attention_reference(q, k, v, mask)
    fwd_err = (got - plain).abs().max().item()
    fwd_exact = exact_errors(got, plain, exact_in_rows(q, k, v, mask), mask)
    check(fwd_err <= 1e-4, f"flash_fwd_pieces on the serve path's operands: "
          f"max |kernel - plain| {fwd_err} > 1e-4")
    fwd_shape = {"shape": list(q.shape), "strides": list(q.stride())}
    q, k, v, mask, do = bwd_ops
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


def _params_close(got: dict, want: dict, atol: float, lr_sum: float,
                  share: float) -> None:
    """All but ``share`` of the parameter entries within ``atol`` (the
    attention key biases aside: their true gradient is 0, so Adam/LAMB
    turn rounding noise into steps of up to ~3.2 x lr) and every entry
    within twice that step over the rates' sum."""
    outside = total = 0
    for key, w in want.items():
        diff = (got[key].float().cpu() - w.float().cpu()).abs()
        check(diff.max().item() <= 2 * 3.2 * lr_sum, f"{key} moved apart")
        if not key.endswith("attention.self.key.bias"):
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


def bf16_readings(start: dict, ref, run) -> dict:
    """How far a bf16 ``parity_run`` is from the fp32 one ``ref``: the
    largest |loss − loss_ref| / max(1, |loss_ref|) over the steps, the
    cosine of the two parameter updates, and the least per-tensor cosine of
    the first step's gradients (the attention key biases aside: their true
    gradient is 0)."""
    import torch
    (l_ref, p_ref, g_ref), (l, p, g) = ref, run
    keys = [k for k in g_ref if not k.endswith("attention.self.key.bias")]
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
    from ance_tpu_torch.ops.topk import (_pad_rows, blockmax_kernel_for,
                                         blockmax_scores,
                                         blockmax_scores_reference)
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

    def phase1_against_plain(dtypes: str) -> list:
        """Phase 1 on the operands generate's searches gave it (its dev
        queries, then its mining queries, against its index: the encoder's
        embeddings, not randn), the kernel against the plain version. Run
        after the path's launches were read, so not counted in them."""
        check(len(searched) == 2, f"generate searched {len(searched)} "
              "times through block-max, not twice")
        out = []
        for what, (q, corpus) in zip(("dev", "mining"), searched):
            q = q.contiguous()
            c = _pad_rows(corpus, CHUNK_ROWS)  # as topk_blockmax pads
            kernel = blockmax_kernel_for(q, c)
            check(kernel == ROUTE_KERNEL[dtypes], f"generate {what}: phase 1 "
                  f"takes {kernel}")
            got = blockmax_scores(q, c, chunk_rows=CHUNK_ROWS)
            want = blockmax_scores_reference(q, c)
            err = (got - want).abs().max().item()
            top = want.abs().max().item()
            check(err <= FLOAT_ATOL, f"{dtypes} generate {what}: max |err| "
                  f"{err} > {FLOAT_ATOL} (block maxima up to {top})")
            # both against the exact maxima (fp64): how much of the gap
            # is the kernel's and how much cuBLAS's fp32 sum
            exact = (q.double() @ c.double().T).reshape(
                q.shape[0], -1, 16).amax(-1)
            k_err = (got.double() - exact).abs().max().item()
            p_err = (want.double() - exact).abs().max().item()
            out.append({"dtypes": dtypes, "shape": f"generate {what}",
                        "kernel": kernel, "Q": q.shape[0], "N": c.shape[0],
                        "D": q.shape[1], "max_abs_err": err,
                        "max_abs_err_exact": k_err,
                        "plain_max_abs_err_exact": p_err,
                        "max_abs_block_max": top})
            print(f"kernel {dtypes:10s} generate {what:6s} Q={q.shape[0]:5d} "
                  f"N={c.shape[0]} ({kernel}): max|err| {err:.3g} on the "
                  f"encoder's embeddings (block maxima up to {top:.1f}); "
                  f"against the exact maxima: kernel {k_err:.3g}, plain "
                  f"{p_err:.3g}", flush=True)
            del got, want, exact, c
        searched.clear()
        return out

    summary, result, gen_s, launches, by_kernel = generate(ann)
    kernel_cases = phase1_against_plain("f32xf32")
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
    kernel_cases += phase1_against_plain("f32xint8")
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


def main() -> int:
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

    name = phase_device()
    build_s, built = phase_build()
    machine_code = phase_machine_code(built)
    cases, searches = phase_kernel()
    ties = phase_ties()
    attn_cases, crossover = phase_attention()
    bwd_cases, functions = phase_attention_backward()
    seq128 = phase_seq128()
    mirror = phase_mirror()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        serve = phase_serve(work)
        maxp = phase_maxp(work)
        train = phase_train(work)
        maxp_fp32 = phase_maxp_fp32(work)
        generate = phase_generate(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    parity = phase_step_parity()
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
    # kernel #1: blockmax_bf16 with the WMMA routes' cases,
    # then the fp32-query routes' two kernels, each with its launches on
    # the path that runs it (generate over an fp32 / a dims index); the
    # launches of every path by kernel beside the first
    pieces = ("blockmax_pieces_f32", "blockmax_pieces_int8")
    cases += generate.pop("kernel_cases")  # phase 1 on generate's operands
    own = [c for c in cases if c["kernel"] not in pieces]
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
        "generate_index_quantize_dims": generate["dims_blockmax_kernels"]}
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
        fp32_entries.append(e)
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
        fp32_attention.append(e)
    print(json.dumps({"kernels": [
        blockmax, *fp32_entries,
        attention_entry("fused_attention", "ance_tpu/ops/fused_attention.py:40",
                        128, 512, maxp["fused_launches"]),
        attention_entry("flash_attention", "ance_tpu/ops/flash_attention.py:34",
                        8, 2048, maxp["flash_launches"]),
        entry("fused_attention_bwd", "fused_attention",
              "ance_tpu/ops/fused_attention.py:97",
              train["maxp"]["fused_backward_launches"], bwd_head,
              "bf16 B=64 S=512 H=12 D=64", "fused_attention", bwd_cases),
        *fp32_attention,
        seq128_entry("fused128", "docs/perf_attn128_r3.py:44", "fused128"),
        seq128_entry("fused_block", "docs/perf_attn128_r3.py:88", "block")],
        "fused_function": functions, "machine_code": machine_code,
        "index_search": searches, "ties": ties,
        "crossover": crossover, "serve": serve, "maxp": maxp,
        "train": train, "maxp_fp32": maxp_fp32, "step_parity": parity,
        "mirror_encoder": mirror,
        "generate": generate}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
