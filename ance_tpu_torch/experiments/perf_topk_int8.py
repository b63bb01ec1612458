"""The int8 phase-1 study: does a reduced-precision phase 1 pay over the
``dims`` (per-dimension int8) index?

Port of ``docs/perf_topk_int8_r4.py``. Over one dims-quantized corpus
(1,000,000 × 768 normalised randn, :func:`quantize_dims_int8`; the dim
scales folded into the queries) it times the exact block-max search with
three phase-1 query dtypes, and the unquantized index beside them:

  * ``bf16_corpus`` — bf16 queries over the bf16 corpus (the unquantized
    index; phase 1 on ``blockmax_bf16``);
  * ``int8_fp32``   — ``topk_blockmax(qs, c8)``: fp32 queries over the int8
    codes, what a ``dims`` index searches with (``blockmax_pieces_int8``);
  * ``int8_bf16``   — ``phase1_dtype=torch.bfloat16``
    (``blockmax_bf16_int8``);
  * ``int8_int8``   — ``phase1_dtype=torch.int8``: each query row
    quantized to int8, an exact int32 phase 1 (``blockmax_int8``);

each with its ids' agreement with the exact scan over the same int8
corpus (``topk_inner_product``): phase 3 rescores exactly, so a
disagreement is a true block missed by the reduced phase 1. At the dev
shape it also times phase 1 alone (``blockmax_scores``) on the operands
``bf16_bf16``, ``fp32_int8``, ``bf16_int8``, ``int8_int8`` and, with
``block_size=32``, ``bf16_bf16_bs32``.

The TPU script's ``chunk_rows`` / ``q_block`` variants are TPU schedule
knobs with no counterpart here: ``q_block`` tiles the query axis of the
Pallas grid (the kernels here tile queries themselves), and ``chunk_rows``
only pads the corpus (the kernels walk 128-row tiles whatever it is).

    python -m ance_tpu_torch.experiments.perf_topk_int8 --device cuda

prints one JSON line for the device, one per shape (``dev`` Q=2048 k=10,
``mine`` Q=512 k=200) and the phase-1 lines, timed with CUDA events in
turns (``utils/timing.py``: the host's enqueue out of the window). Every
function takes its tensors, a ``torch.Generator`` and a device; on CPU
tensors they run the plain versions (the tests use them so).
"""

from __future__ import annotations

import argparse
import collections
import json

import torch

from ance_tpu_torch.index.flat import quantize_dims_int8, topk_inner_product
from ance_tpu_torch.ops.topk import (_pad_rows, blockmax_kernel_for,
                                     blockmax_scores,
                                     quantize_query_rows_int8, topk_blockmax)

N, D = 1_000_000, 768
SHAPES = (("dev", 2048, 10), ("mine", 512, 200))
REPS = 5
CHUNK_ROWS = 1024  # topk_blockmax's default: phase 1's corpus is padded to it
# name -> phase1_dtype of topk_blockmax over the int8 corpus
INT8_SEARCHES = {"int8_fp32": None, "int8_bf16": torch.bfloat16,
                 "int8_int8": torch.int8}


def make_corpus(n: int, dim: int, generator: torch.Generator,
                device) -> dict:
    """The study's corpus: ``n`` × ``dim`` randn rows of unit norm, as int8
    codes ``c8`` with per-dimension ``scales`` (``quantize_dims_int8``) and
    as bf16 ``c16``."""
    c = torch.randn(n, dim, generator=generator, device=device)
    c /= torch.linalg.vector_norm(c, dim=1, keepdim=True)
    c8, scales = quantize_dims_int8(c)
    return {"c8": c8, "scales": scales, "c16": c.to(torch.bfloat16)}


def make_queries(n_q: int, scales: torch.Tensor,
                 generator: torch.Generator) -> tuple:
    """(q, qs): ``n_q`` randn queries and the same with the dim scales
    folded in (what a ``dims`` index searches the codes with)."""
    q = torch.randn(n_q, scales.shape[0], generator=generator,
                    device=scales.device)
    return q, q * scales


def search_fns(q: torch.Tensor, qs: torch.Tensor, corpus: dict,
               k: int) -> dict:
    """Each search variant (``bf16_corpus`` and ``INT8_SEARCHES``) as a
    call returning (scores, ids)."""
    q16 = q.to(torch.bfloat16)
    fns = {"bf16_corpus": lambda: topk_blockmax(q16, corpus["c16"], k=k)}
    for name, p1 in INT8_SEARCHES.items():
        fns[name] = lambda p1=p1: topk_blockmax(qs, corpus["c8"], k=k,
                                                phase1_dtype=p1)
    return fns


def phase1_operands(qs: torch.Tensor, corpus: dict) -> dict:
    """Each phase-1 variant as (queries, corpus, block_size),
    the corpus padded to ``CHUNK_ROWS`` rows with zeros as
    ``topk_blockmax`` pads it."""
    c16 = _pad_rows(corpus["c16"], CHUNK_ROWS)
    c8 = _pad_rows(corpus["c8"], CHUNK_ROWS)
    q16 = qs.to(torch.bfloat16)
    q8 = quantize_query_rows_int8(qs)
    return {"bf16_bf16": (q16, c16, 16), "fp32_int8": (qs, c8, 16),
            "bf16_int8": (q16, c8, 16), "int8_int8": (q8, c8, 16),
            "bf16_bf16_bs32": (q16, c16, 32)}


def phase1_fns(operands: dict) -> dict:
    """``blockmax_scores`` on each variant's operands."""
    return {name: (lambda q=q, c=c, bs=bs: blockmax_scores(
        q, c, block_size=bs, chunk_rows=CHUNK_ROWS))
        for name, (q, c, bs) in operands.items()}


def search_kernels(q: torch.Tensor, qs: torch.Tensor, corpus: dict) -> dict:
    """The phase-1 kernel each search variant launches on the card."""
    c8 = corpus["c8"]
    return {"bf16_corpus": blockmax_kernel_for(q.to(torch.bfloat16),
                                               corpus["c16"]),
            "int8_fp32": blockmax_kernel_for(qs, c8),
            "int8_bf16": blockmax_kernel_for(qs.to(torch.bfloat16), c8),
            "int8_int8": blockmax_kernel_for(quantize_query_rows_int8(qs),
                                             c8)}


def agreement(ids: torch.Tensor, ids_ref: torch.Tensor) -> float:
    """The share of positions where the ids, each row sorted, equal the
    reference's (the TPU script's measure)."""
    return (torch.sort(ids, 1).values == torch.sort(ids_ref, 1).values
            ).double().mean().item()


def counted(fns: dict, runs: collections.Counter) -> dict:
    """``fns`` with each call counted in ``runs`` under its name."""
    def wrap(name, fn):
        def call():
            runs[name] += 1
            return fn()
        return call
    return {name: wrap(name, fn) for name, fn in fns.items()}


def study_shape(tag: str, q: torch.Tensor, qs: torch.Tensor, k: int,
                corpus: dict, reps: int = REPS) -> dict:
    """One shape's row for queries ``q`` (``qs`` with the dim scales): the
    scan's time, then each search variant's ms, queries/s, agreement with
    the scan and whether its ids equal the scan's, timed in turns. ``runs``
    counts the calls of each variant (ids, warm-up and timed runs)."""
    from ance_tpu_torch.utils.timing import cuda_ms, cuda_ms_turns
    n_q = q.shape[0]
    scan = lambda: topk_inner_product(qs, corpus["c8"], k=k)  # noqa: E731
    ids_ref = scan()[1]
    row = {"shape": tag, "Q": n_q, "k": k,
           "scan_int8_ms": cuda_ms(scan, reps=1)}
    runs = collections.Counter()
    fns = counted(search_fns(q, qs, corpus, k), runs)
    kernels = search_kernels(q, qs, corpus)
    for name, fn in fns.items():
        ids = fn()[1]
        row[f"{name}_agree"] = agreement(ids, ids_ref)
        row[f"{name}_equal"] = bool(torch.equal(ids, ids_ref))
    times = cuda_ms_turns(fns, reps=reps, warmup=1)
    for name in fns:
        row[f"{name}_ms"] = times[name]
        row[f"{name}_qps"] = n_q / times[name] * 1e3
        row[f"{name}_kernel"] = kernels[name]
    row["runs"] = dict(runs)
    return row


def study_phase1(qs: torch.Tensor, corpus: dict, reps: int = REPS) -> dict:
    """Phase 1 alone on each variant's operands, timed in turns: ms, the
    kernel, TFLOP/s (2 Q N D over the time) and the calls made."""
    from ance_tpu_torch.utils.timing import cuda_ms_turns
    operands = phase1_operands(qs, corpus)
    runs = collections.Counter()
    times = cuda_ms_turns(counted(phase1_fns(operands), runs), reps=reps,
                          warmup=1)
    out = {"phase1_shape": [qs.shape[0], *operands["bf16_bf16"][1].shape]}
    for name, (q, c, _) in operands.items():
        flops = 2.0 * q.shape[0] * c.shape[0] * c.shape[1]
        out[name] = {"ms": times[name], "tf_s": flops / times[name] / 1e9,
                     "kernel": blockmax_kernel_for(q, c),
                     "runs": runs[name]}
    return out


def main(argv=None) -> None:
    from ance_tpu_torch.utils.device import resolve_device
    p = argparse.ArgumentParser(prog="perf_topk_int8")
    p.add_argument("--device", default="cuda")
    p.add_argument("--reps", type=int, default=REPS)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type != "cuda":
        raise SystemExit("perf_topk_int8 times the card: --device cuda")
    print(json.dumps({"device": torch.cuda.get_device_name(dev), "N": N,
                      "D": D}), flush=True)
    g = torch.Generator(device=dev).manual_seed(0)
    corpus = make_corpus(N, D, g, dev)
    for tag, n_q, k in SHAPES:
        q, qs = make_queries(n_q, corpus["scales"], g)
        print(json.dumps(study_shape(tag, q, qs, k, corpus, args.reps)),
              flush=True)
        if tag == "dev":
            print(json.dumps(study_phase1(qs, corpus, args.reps)),
                  flush=True)


if __name__ == "__main__":
    main()
