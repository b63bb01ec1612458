#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``ance_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the three kernels of
``ance_tpu_torch/csrc`` (block-max top-k, fused and flash attention; one
nvcc each, all at once) and then:

  * block-max: the kernel against its plain PyTorch version at the FirstP
    search shapes (1,000,448 × 768 corpus; Q=2048 k=10 and Q=512 k=200) for
    every dtype pair; ``FlatIPIndex`` block-max ids against the scan for
    the none / bf16 / dims indexes; and the tie check: a 1,000,448 × 768
    bf16 index in which every 7th row is one vector that the queries rank
    inside their top k, where block-max ids must equal the scan's;
  * attention: each kernel against its plain version at the MaxP shapes
    (fused S = 256 / 512 / 1024, flash S = 512 / 2048; bf16 and fp32),
    timed, with the einsum path at S = 256 / 512 / 1024 beside them;
  * FirstP serve: RoBERTa-base at full width (seeded random weights, bf16)
    through the ``serve`` CLI in a subprocess and the HTTP server in
    process;
  * MaxP serve: the same weights as ``rdot_nll_multi_chunk`` over 4,096
    documents of seq 2048 (16,384 chunk rows of 512): the ``serve`` CLI,
    an in-process encode through the fused kernel (and a slice of it
    through the flash kernel and the plain path), and the HTTP server,
    every answer held against a scan.

Any failed check raises, so the exit code is non-zero and no result line
is printed. The last two lines are a JSON object of per-kernel results and
``{"ok": true, "device": {...}}``.

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
KERNELS = ("blockmax", "fused_attention", "flash_attention")
# fp32 sums of 768 products (|score| up to ~150, ulp ~1.5e-5) taken in
# another order than cuBLAS's: the drift stays well under 2e-3
FLOAT_ATOL = 2e-3
N_ORACLE = 256  # queries per search held against a plain torch.topk


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def no_reference_modules() -> bool:
    """True while neither jax nor the JAX package has been imported."""
    return not any(m in ("jax", "flax", "ance_tpu")
                   or m.startswith(("jax.", "flax.", "ance_tpu."))
                   for m in sys.modules)


def cuda_ms(fn, reps: int = 5) -> float:
    """Median CUDA-event time of ``fn()`` over ``reps`` runs, after one
    warm-up run."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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


def phase_build() -> dict:
    """One nvcc per kernel source, all started together; returns the
    seconds each took."""
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
    return {name: seconds for name, (_, _, seconds) in done.items()}


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
            ms = cuda_ms(lambda: blockmax_scores(qq, cc,
                                                 chunk_rows=CHUNK_ROWS))
            plain_ms = cuda_ms(lambda: blockmax_scores_reference(qq, cc))
            cases.append({"dtypes": dtypes, "shape": shape,
                          "Q": qq.shape[0], "N": cc.shape[0], "D": DIM,
                          "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
            print(f"kernel {dtypes:10s} {shape:6s} Q={qq.shape[0]:5d} "
                  f"N={cc.shape[0]}: max|err| {err:.3g}  kernel {ms:.3f} ms  "
                  f"plain {plain_ms:.3f} ms", flush=True)
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


def _bf16_ulps(x: float, n: int) -> float:
    return n * 2.0 ** (math.floor(math.log2(x)) - 7)


def _attention_inputs(B, S, dtype, seed, H=12, D=64):
    """q, k, v ~ N(0, 1) [B, S, H, D] on the card; a mask of random
    lengths with row 0 fully masked (an all-padding MaxP chunk)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(B, S, H, D, generator=g, device="cuda").to(dtype)
               for _ in range(3))
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
    from ance_tpu_torch.ops.attention import multi_head_attention
    from ance_tpu_torch.ops.flash_attention import (flash_attention,
                                                    flash_attention_reference)
    from ance_tpu_torch.ops.fused_attention import (fused_attention,
                                                    fused_attention_reference)

    pairs = {"fused_attention": (fused_attention, fused_attention_reference),
             "flash_attention": (flash_attention, flash_attention_reference)}
    bf16, f32 = torch.bfloat16, torch.float32
    shapes = [("fused_attention", bf16, 128, 512),   # one MaxP encode batch
              ("fused_attention", bf16, 128, 256),
              ("fused_attention", bf16, 32, 1024),
              ("fused_attention", f32, 32, 512),
              ("flash_attention", bf16, 128, 512),
              ("flash_attention", f32, 128, 512),
              ("flash_attention", bf16, 8, 2048),
              ("flash_attention", f32, 8, 2048)]
    cases = []
    for i, (name, dtype, B, S) in enumerate(shapes):
        kernel, plain = pairs[name]
        q, k, v, mask = _attention_inputs(B, S, dtype, seed=i)
        got = kernel(q, k, v, mask)
        want = plain(q, k, v, mask).float()
        torch.cuda.synchronize()
        check(got.shape == q.shape and got.dtype == dtype
              and bool(torch.isfinite(got).all()),
              f"{name} {dtype} B={B} S={S}: output not finite {tuple(q.shape)}")
        err = (got.float() - want).abs().max().item()
        # fp32: the two sum in other orders and exp differs by an ulp or
        # two; bf16: either can round a value (fused: a probability) to
        # the neighbouring bf16, so 2 ulps of the largest output
        tol = 1e-4 if dtype == f32 else _bf16_ulps(want.abs().max().item(), 2)
        check(err <= tol, f"{name} {dtype} B={B} S={S}: max |kernel - "
              f"plain| {err} > {tol}")
        del got, want
        ms = cuda_ms(lambda: kernel(q, k, v, mask))
        plain_ms = cuda_ms(lambda: plain(q, k, v, mask))
        dt = "bf16" if dtype == bf16 else "f32"
        cases.append({"name": name, "dtype": dt, "B": B, "S": S, "H": 12,
                      "D": 64, "max_abs_err": err, "tolerance": tol,
                      "ms": ms, "plain_ms": plain_ms})
        print(f"{name} {dt:4s} B={B:3d} S={S:4d}: max|err| {err:.3g} "
              f"(tol {tol:.3g})  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms",
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
    build_s = phase_build()
    cases, max_err, searches = phase_kernel()
    ties = phase_ties()
    attn_cases, crossover = phase_attention()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        serve = phase_serve(work)
        maxp = phase_maxp(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    headline = next(c for c in cases
                    if c["dtypes"] == "bf16xbf16" and c["shape"] == "dev")

    def attention_entry(kernel, replaces, B, S, launches):
        own = [c for c in attn_cases if c["name"] == kernel]
        head = next(c for c in own if c["dtype"] == "bf16" and c["B"] == B
                    and c["S"] == S)
        return {"name": kernel, "route": "cuda",
                "source": f"ance_tpu_torch/csrc/{kernel}.cu",
                "replaces": replaces, "launches": launches,
                "max_abs_err": head["max_abs_err"],
                "tolerance": head["tolerance"], "ms": head["ms"],
                "plain_ms": head["plain_ms"],
                "shape": f"bf16 B={B} S={S} H=12 D=64",
                "build_s": build_s[kernel], "cases": own}

    # launches: the MaxP path's own runs (its HTTP searches; its corpus
    # encode; the encode of its first batches with --attention flash)
    print(json.dumps({"kernels": [
        {"name": "blockmax_scores", "route": "cuda",
         "source": "ance_tpu_torch/csrc/blockmax.cu",
         "replaces": "ance_tpu/ops/topk.py:90",
         "launches": maxp["blockmax_launches"], "max_abs_err": max_err,
         "ms": headline["ms"], "plain_ms": headline["plain_ms"],
         "shape": "bf16 Q=2048 x N=1000448 x D=768, block 16",
         "build_s": build_s["blockmax"], "cases": cases},
        attention_entry("fused_attention", "ance_tpu/ops/fused_attention.py:40",
                        128, 512, maxp["fused_launches"]),
        attention_entry("flash_attention", "ance_tpu/ops/flash_attention.py:34",
                        8, 2048, maxp["flash_launches"])],
        "index_search": searches, "ties": ties, "crossover": crossover,
        "serve": serve, "maxp": maxp}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
