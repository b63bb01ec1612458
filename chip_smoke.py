#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``ance_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the four kernel sources of
``ance_tpu_torch/csrc`` (block-max top-k, fused and flash attention, the
seq-128 attention pair; one nvcc each, all at once), prints ptxas's
registers and spills and the SASS counts of HGMMA (wgmma) and UTMALDG
(TMA loads) of the five wgmma kernels (the fused forward and its two
backward passes, the bf16 flash forward, seq-128 kernel #5), and then:

  * block-max: the kernel against its plain PyTorch version at the FirstP
    search shapes (1,000,448 × 768 corpus; Q=2048 k=10 and Q=512 k=200) for
    every dtype pair; ``FlatIPIndex`` block-max ids against the scan for
    the none / bf16 / dims indexes; and the tie check: a 1,000,448 × 768
    bf16 index in which every 7th row is one vector that the queries rank
    inside their top k, where block-max ids must equal the scan's;
  * attention: each kernel against its plain version at the MaxP shapes
    (fused S = 256 / 300 / 512 / 1024 and the encoder's ``qkv.chunk``
    views, flash S = 512 / 2048; bf16 and fp32), timed in turns with SDPA
    (on fp32 operands for flash, whose function is fp32), with the einsum
    path at S = 256 / 512 / 1024 beside them;
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
    and fp32, each call bit-equal to a second one, and the autograd
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
  * step parity: 3 steps, dropout off, two layers at full width (init std
    0.05, so no loss saturates): fp32 on the card against the port's CPU
    path, and bf16 (the kernels) against fp32 on the card by loss, update
    cosine and first-step gradient cosines, MaxP's also against a control
    that runs bf16 through the plain einsum attention;
  * seq-128 attention: kernels #5 (``fused128``) and #6 (``fused_block``)
    against their plain versions at B=128 × S=128 × 768 bf16 (a padding
    tail from 100, one fully masked row), timed in turns with SDPA and the
    unfused composition; then the experiment's mirror encoder (12 layers,
    FFN 3072, vocabulary 50265, seeded bf16 weights) through its four
    attention variants, each against ``xla`` by per-row cosine, with the
    kernels' launches counted over one forward;
  * generate: the generator job at full RoBERTa-base width over the
    FirstP serve caches (32,768 passages, 1,024 train and 256 dev queries,
    synthetic qrels): ``cli generate`` at k=500, ``infer`` + ``eval-full``
    (its NDCG@10 equals generate's), the mining ids against a scan of the
    same index, ``cli train`` on the file and ``generate --training_dir``
    on its checkpoint, then ``run_ance_cycles`` (2 cycles x 3 steps).

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
                        "fused_bwd_keys_bf16"),
    "flash_attention": ("flash_fwd_bf16",),
    "attn128": ("attn128_kernel",),
}


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


def phase_kernel():
    """Kernel vs plain at the 1M search shapes; FlatIPIndex block-max ids
    vs the scan on the same index, and both against a plain torch.topk."""
    import torch
    from ance_tpu_torch.utils.timing import clocks, clocks_text, cuda_ms
    from ance_tpu_torch.index.flat import FlatIPIndex, quantize_dims_int8
    from ance_tpu_torch.ops.topk import (blockmax_scores,
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

    cases, max_err = [], 0.0
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
    for shape, operands in shapes:
        for dtypes, (qq, cc) in operands.items():
            got = blockmax_scores(qq, cc, chunk_rows=CHUNK_ROWS)
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
            max_err = max(max_err, err)
            del got, want
            before = clocks()
            ms = cuda_ms(lambda: blockmax_scores(qq, cc,
                                                 chunk_rows=CHUNK_ROWS))
            plain_ms = cuda_ms(lambda: blockmax_scores_reference(qq, cc))
            sampled = {"before": before, "after": clocks()}
            # read q and c once, write the [Q, N/16] maxima; 2QND products
            # at the rate of the type they run in (fp32 queries: CUDA cores)
            nq, nc = qq.shape[0], cc.shape[0]
            b_ms, b_by = bound(
                nq * DIM * qq.element_size() + nc * DIM * cc.element_size()
                + nq * (nc // 16) * 4, 2.0 * nq * nc * DIM,
                {"f32": "f32", "bf16": "bf16",
                 "int8": "int8"}[dtypes.split("x")[0]])
            cases.append({"dtypes": dtypes, "shape": shape,
                          "Q": nq, "N": nc, "D": DIM,
                          "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": b_ms, "bound_by": b_by,
                          "clocks": sampled})
            print(f"kernel {dtypes:10s} {shape:6s} Q={qq.shape[0]:5d} "
                  f"N={cc.shape[0]}: max|err| {err:.3g}  kernel {ms:.3f} ms  "
                  f"plain {plain_ms:.3f} ms  {clocks_text(sampled)}",
                  flush=True)
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
            s1, i1 = index.search(q, k)
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
            searches.append({"index": kind, "shape": shape, "Q": nq, "k": k,
                             "search_ms": ms, "oracle_ids_compared": share})
            print(f"index {kind:4s} {shape:6s} Q={nq} k={k}: ids == scan, "
                  f"== plain topk on {share:.4f} of {N_ORACLE}x{k}, search "
                  f"{ms:.3f} ms ({nq / ms * 1000:.0f} qps)", flush=True)
        del index, c_ref
        torch.cuda.empty_cache()
    del corpus, c8, queries
    torch.cuda.empty_cache()
    return cases, max_err, searches


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


def _attention_inputs(B, S, dtype, seed, H=12, D=64, strided=False):
    """q, k, v ~ N(0, 1) [B, S, H, D] on the card (``strided``: the three
    chunks of one [B, S, 3·H·D] fused-QKV projection, as the encoder
    passes them); a mask of random lengths with row 0 fully masked (an
    all-padding MaxP chunk)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    if strided:
        qkv = torch.randn(B, S, 3 * H * D, generator=g, device="cuda").to(dtype)
        q, k, v = (t.view(B, S, H, D) for t in qkv.chunk(3, dim=-1))
    else:
        q, k, v = (torch.randn(B, S, H, D, generator=g, device="cuda")
                   .to(dtype) for _ in range(3))
    lengths = torch.randint(1, S + 1, (B,), generator=g, device="cuda")
    mask = (torch.arange(S, device="cuda")[None] < lengths[:, None]).long()
    mask[0] = 0
    return q, k, v, mask


def phase_attention():
    """Each attention kernel against its plain version at the MaxP shapes
    (H = 12, D = 64), both timed; then, at S = 256 / 512 / 1024, the
    fused kernel beside the einsum path ``auto`` takes below S = 256
    (bf16 softmax) and the flash kernel, to re-choose the crossovers."""
    import torch
    from ance_tpu_torch.utils.timing import (clocks_text, cuda_ms,
                                             timed_in_turns)
    import torch.nn.functional as F
    from ance_tpu_torch.ops.attention import mask_to_bias, multi_head_attention
    from ance_tpu_torch.ops.flash_attention import (flash_attention,
                                                    flash_attention_reference)
    from ance_tpu_torch.ops.fused_attention import (fused_attention,
                                                    fused_attention_reference)

    pairs = {"fused_attention": (fused_attention, fused_attention_reference),
             "flash_attention": (flash_attention, flash_attention_reference)}
    bf16, f32 = torch.bfloat16, torch.float32
    shapes = [("fused_attention", bf16, 128, 512),   # one MaxP encode batch
              ("fused_attention", bf16, 128, 512, True),  # its qkv.chunk views
              ("fused_attention", bf16, 128, 256),
              ("fused_attention", bf16, 128, 300),
              ("fused_attention", bf16, 32, 1024),
              ("fused_attention", f32, 32, 512),
              ("flash_attention", bf16, 128, 512),
              ("flash_attention", f32, 128, 512),
              ("flash_attention", bf16, 8, 2048),
              ("flash_attention", f32, 8, 2048)]
    cases = []
    for i, (name, dtype, B, S, *strided) in enumerate(shapes):
        kernel, plain = pairs[name]
        strided = bool(strided)
        q, k, v, mask = _attention_inputs(B, S, dtype, seed=i, strided=strided)
        got = kernel(q, k, v, mask)
        want = plain(q, k, v, mask).float()
        torch.cuda.synchronize()
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
        lib_dtype = f32 if name == "flash_attention" else dtype
        qt, kt, vt = (t.transpose(1, 2).to(lib_dtype) for t in (q, k, v))
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
        flash_bf16 = name == "flash_attention" and dtype == bf16
        b_ms, b_by = bound(
            4 * q.numel() * q.element_size() + mask.numel() * 8,
            (8.0 if flash_bf16 else 4.0) * B * 12 * S * S * 64,
            "bf16" if dtype == bf16 else "f32")
        cases.append({"name": name, "dtype": dt, "B": B, "S": S, "H": 12,
                      "D": 64, "strided": strided, "max_abs_err": err, "tolerance": tol,
                      "err_slice_ulps": ulps, "ms": ms, "plain_ms": plain_ms,
                      "library_ms": library_ms, "bound_ms": b_ms,
                      "bound_by": b_by, "clocks": sampled})
        print(f"{name} {dt:4s} B={B:3d} S={S:4d}{' qkv.chunk' if strided else ''}"
              f": max|err| {err:.3g} "
              f"({'fp32 tol 1e-4' if ulps is None else f'{ulps:.3g} slice ulps'})"
              f"  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms"
              f"  sdpa{' fp32' if lib_dtype != dtype else ''} {library_ms:.3f} ms"
              f"  bound {b_ms:.3f} ms ({b_by})  {clocks_text(sampled)}",
              flush=True)
        del q, k, v, mask
        torch.cuda.empty_cache()

    crossover = []
    for S, B in ((256, 128), (512, 128), (1024, 32)):
        q, k, v, mask = _attention_inputs(B, S, bf16, seed=S)
        row = {"S": S, "B": B}
        for impl in ("xla_bf16", "xla", "fused", "flash"):
            row[f"{impl}_ms"] = cuda_ms(
                lambda: multi_head_attention(q, k, v, mask, impl=impl))
        crossover.append(row)
        print(f"crossover bf16 B={B} S={S}: einsum bf16 softmax "
              f"{row['xla_bf16_ms']:.3f} ms, fp32 softmax {row['xla_ms']:.3f}"
              f" ms, fused {row['fused_ms']:.3f} ms, flash "
              f"{row['flash_ms']:.3f} ms", flush=True)
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
        fused_attention_backward_reference, fused_attention_reference)

    torch.manual_seed(0)  # the output gradients
    bf16, f32 = torch.bfloat16, torch.float32
    shapes = [(bf16, 64, 512), (bf16, 64, 512, True), (bf16, 64, 256),
              (bf16, 16, 1024), (bf16, 16, 300), (bf16, 16, 65),
              (f32, 64, 512), (f32, 64, 256), (f32, 16, 1024), (f32, 16, 300)]
    cases = []
    for i, (dtype, B, S, *strided) in enumerate(shapes):
        strided = bool(strided)
        q, k, v, mask = _attention_inputs(B, S, dtype, seed=100 + i,
                                          strided=strided)
        do = torch.randn_like(q, dtype=f32).to(dtype)
        got = fused_attention_backward(q, k, v, mask, do)
        again = fused_attention_backward(q, k, v, mask, do)
        want = fused_attention_backward_reference(q, k, v, mask, do)
        torch.cuda.synchronize()
        # no atomics: a second call gives the same bits
        deterministic = all(torch.equal(a, b) for a, b in zip(got, again))
        check(deterministic, f"backward {dtype} B={B} S={S}: two calls differ")
        del again
        err, ulps = 0.0, 0.0
        tol = 1e-5 if dtype == f32 else BF16_SLICE_TOL
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            check(g.shape == q.shape and g.dtype == dtype
                  and bool(torch.isfinite(g).all()),
                  f"backward {name} {dtype} B={B} S={S}: not finite")
            # fp32: sums in other orders; bf16: a p or ds one rounding
            # step apart, held per (row, head) slice
            if dtype == f32:
                e = (g - w).abs().max().item()
                check(e <= tol, f"backward {name} fp32 B={B} S={S}: max "
                      f"|kernel - plain| {e} > {tol}")
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
        del got, want
        leaves = [t.transpose(1, 2).detach().requires_grad_()
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
        # recomputed s and the four gradient products: 10·S²·D a head
        b_ms, b_by = bound(7 * q.numel() * q.element_size() + mask.numel() * 8,
                           10.0 * B * 12 * S * S * 64,
                           "bf16" if dtype == bf16 else "f32")
        dt = "bf16" if dtype == bf16 else "f32"
        cases.append({"dtype": dt, "B": B, "S": S, "H": 12, "D": 64,
                      "strided": strided, "deterministic": deterministic,
                      "max_abs_err": err, "tolerance": tol,
                      "err_slice_ulps": ulps if dtype == bf16 else None,
                      "control": control, "ms": ms,
                      "plain_ms": plain_ms, "library_ms": library_ms,
                      "bound_ms": b_ms, "bound_by": b_by, "clocks": sampled})
        print(f"fused backward {dt:4s} B={B:3d} S={S:4d}"
              f"{' qkv.chunk' if strided else ''}: max|err| {err:.3g}"
              f" ({f'{ulps:.3g} slice ulps' if dtype == bf16 else 'fp32 tol 1e-5'})"
              f"  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms"
              f"  sdpa backward {library_ms:.3f} ms  bound {b_ms:.3f} ms "
              f"({b_by})  {clocks_text(sampled)}", flush=True)
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
        torch.cuda.synchronize()
        errs = [(g.float() - w.float()).abs().max().item()
                for g, w in zip(got, want)]
        rel = max(slice_rel_err(g, w) for g, w in zip(got, want))
        # fp32: the kernel's delta = rowsum(dp ⊙ p) against autograd's
        # softmax backward, same function; bf16: autograd's chain rounds dp
        # to bf16 (2^-9 relative) where the kernel keeps it fp32 and rounds
        # ds, so each (row, head) slice within 1e-2 of its norm
        if dtype == f32:
            check(max(errs) <= 1e-5, f"Function fp32 grads differ by {errs}")
        else:
            check(rel <= 1e-2, f"Function bf16 grads: a (row, head) slice "
                  f"off by {rel} of its norm")
        functions.append({"dtype": "bf16" if dtype == bf16 else "f32",
                          "max_abs_err": max(errs),
                          "max_slice_rel_err": rel})
        print(f"fused Function {functions[-1]['dtype']:4s} B=64 S=512: "
              f"grads vs autograd of the plain forward: max|err| "
              f"{max(errs):.3g}, worst (row, head) slice {rel:.3g} of its "
              f"norm", flush=True)
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
        blockmax_scores.launches = 0
        answers, latency = [], []
        for payload in payloads:
            times = []
            for _ in range(REPEATS):
                t0 = time.perf_counter()
                body = _post(addr, "/search", payload)
                times.append((time.perf_counter() - t0) * 1000.0)
            answers.append(body)
            latency.append(statistics.median(times))
        launches = blockmax_scores.launches
        health = _get(addr, "/healthz")
        metrics = _get(addr, "/metrics")
    finally:
        server.shutdown()
    n_searches = len(requests) * REPEATS
    check(launches == n_searches, f"blockmax kernel launched {launches} "
          f"times for {n_searches} searches")
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
    return {"launches": launches, "encode_passages_per_s": N_PASSAGES / enc_s,
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
        n_flash = 4 * DOC_BATCH
        flash_emb, _ = encode_cache_to_device(flash_b, dc, DOC_BATCH,
                                              multichunk=True, stop=n_flash)
        torch.cuda.synchronize()
        flash_launches = flash_attention.launches
        check(flash_launches == layers * 4 and fused_attention.launches == 0,
              f"flash encode: {flash_launches} flash launches for 4 batches")
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
        blockmax_scores.launches = 0
        answers, latency = [], []
        for payload in payloads:
            times = []
            for _ in range(REPEATS):
                t0 = time.perf_counter()
                body = _post(addr, "/search", payload)
                times.append((time.perf_counter() - t0) * 1000.0)
            answers.append(body)
            latency.append(statistics.median(times))
        search_launches = blockmax_scores.launches
    finally:
        server.shutdown()
    n_searches = len(requests) * REPEATS
    check(search_launches == n_searches, f"blockmax kernel launched "
          f"{search_launches} times for {n_searches} MaxP searches")
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
            "blockmax_launches": search_launches, "encode_batches": n_batches,
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
        cases[name] = {"B": B, "S": S, "H": H, "max_abs_err": err,
                       "tolerance": BF16_SLICE_TOL, "err_slice_ulps": ulps,
                       "ms": ms, "plain_ms": plain_ms,
                       "library_ms": library_ms, "unfused_ms": unfused_ms,
                       "bound_ms": b_ms, "bound_by": b_by,
                       "clocks": sampled}
        yard_text = (f"sdpa {library_ms:.3f} ms" if library_ms is not None
                     else f"unfused (4 matmul + sdpa) {unfused_ms:.3f} ms")
        print(f"{name} bf16 B={B} S={S} H={H}: max|err| {err:.3g} ({ulps:.3g}"
              f" slice ulps)  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  "
              f"{yard_text}  bound {b_ms:.4f} ms ({b_by})  "
              f"{clocks_text(sampled)}", flush=True)
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

    # 1. generate, as a user runs it (in process: its result and launches)
    results = []
    real = ann_gen.generate_new_ann

    def keep(*args, **kwargs):
        results.append(real(*args, **kwargs))
        return results[-1]
    ann_gen.generate_new_ann = keep
    try:
        torch.cuda.synchronize()
        blockmax_scores.launches = 0
        t0 = time.perf_counter()
        summary = _cli(["generate", *flags, "--output_dir", str(ann)])
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        launches = blockmax_scores.launches
    finally:
        ann_gen.generate_new_ann = real
    result = results[0]
    data_path, ndcg_path = ann / "ann_training_data_0", ann / "ann_ndcg_0"
    check(data_path.exists() and ndcg_path.exists()
          and ndcg_path.stat().st_mtime_ns >= data_path.stat().st_mtime_ns,
          "generate did not write ann_training_data_0, then ann_ndcg_0")
    check(launches > 0, "generate launched no block-max kernel")
    check(summary["checkpoint"] == "<init>", f"generate cited "
          f"{summary['checkpoint']}, not <init>")
    secs = result["seconds"]
    enc_rate = N_PASSAGES / secs["encode_passages"]
    print(f"generate: {gen_s:.1f} s (CLI, in process: load, encode "
          f"{N_PASSAGES} passages at {enc_rate:.0f} passages/s, index, dev "
          f"search, mine {GEN_TRAIN_QUERIES} queries at k={GEN_TOPK} in "
          f"{secs['mining_search'] * 1e3:.1f} ms, write); dev NDCG@10 "
          f"{result['dev_ndcg']:.4f}; {launches} block-max launches",
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
    del index, result, results
    torch.cuda.empty_cache()
    print(f"generate: mining ids == scan at k={GEN_TOPK} "
          f"({GEN_TRAIN_QUERIES} queries); no negative is its positive",
          flush=True)

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
            "blockmax_launches": launches, "dev_ndcg": summary["dev_ndcg"],
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
    cases, max_err, searches = phase_kernel()
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
    print(json.dumps({"kernels": [
        entry("blockmax_scores", "blockmax", "ance_tpu/ops/topk.py:90",
              maxp["blockmax_launches"], dict(headline, max_abs_err=max_err),
              "bf16 Q=2048 x N=1000448 x D=768, block 16", "blockmax", cases),
        attention_entry("fused_attention", "ance_tpu/ops/fused_attention.py:40",
                        128, 512, maxp["fused_launches"]),
        attention_entry("flash_attention", "ance_tpu/ops/flash_attention.py:34",
                        8, 2048, maxp["flash_launches"]),
        entry("fused_attention_bwd", "fused_attention",
              "ance_tpu/ops/fused_attention.py:97",
              train["maxp"]["fused_backward_launches"], bwd_head,
              "bf16 B=64 S=512 H=12 D=64", "fused_attention", bwd_cases),
        seq128_entry("fused128", "docs/perf_attn128_r3.py:44", "fused128"),
        seq128_entry("fused_block", "docs/perf_attn128_r3.py:88", "block")],
        "fused_function": functions, "machine_code": machine_code,
        "index_search": searches, "ties": ties,
        "crossover": crossover, "serve": serve, "maxp": maxp,
        "train": train, "step_parity": parity, "mirror_encoder": mirror,
        "generate": generate}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
