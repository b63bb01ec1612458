"""IVF (union probe) against exact search on the card: qps and recall@10.

The port's counterpart of ``docs/perf_ivf.py``. Corpus: unit centres with
per-dimension noise scaled so that its norm is about 0.5 (the geometry of
LayerNorm'd encoder embeddings; unit-scale noise at D = 768 would leave no
clusters), made on the card from a seed; queries are corpus rows plus
noise of norm ~0.3. Over it:

  * the exact ``FlatIPIndex`` in fp32 (kernel #1's ``blockmax_pieces_f32``;
    the ground truth), bf16 (``blockmax_bf16``) and ``dims``
    (``blockmax_pieces_int8``);
  * ``IVFIPIndex`` with bf16 and ``dims`` bins at ``--nlist`` clusters,
    slack 1.3, 10 k-means iterations, its build split into k-means,
    assignment, host packing and upload;
  * for each batch B and nprobe: recall@10 against the ground truth, over
    the first ``RECALL_QUERIES`` queries searched B at a time, and the
    search times of the exact bf16 and ``dims`` indexes and of IVF, in
    turns (``utils/timing.py``: CUDA events after a ~1 ms spacer, so the
    host's enqueue is out of the window while it is shorter than the
    spacer), with each call's host enqueue and its host wall time to a
    synchronise beside them.

Probing saves work only while the batch's probe union (≤ B·nprobe) is
below nlist, so IVF should win at small batches and lose at large ones.

    python -m ance_tpu_torch.experiments.perf_ivf --device cuda

prints one JSON line for the card, one for each build and one for each
(B, nprobe). Every function takes its tensors, a ``torch.Generator`` and
a device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

N, D, NLIST = 1_000_000, 768, 4096
BATCHES = (1, 16, 64, 256)
NPROBES = (4, 8)
K = 10
RECALL_QUERIES = 256
REPS = 9


def make_corpus(n: int, dim: int, n_centres: int, g: torch.Generator,
                device) -> torch.Tensor:
    """[n, dim] fp32 rows: a random unit centre each, plus noise of norm
    ~0.5 (``docs/perf_ivf.py``'s mixture)."""
    centres = torch.randn(n_centres, dim, generator=g, device=device)
    centres /= centres.norm(dim=1, keepdim=True)
    pick = torch.randint(0, n_centres, (n,), generator=g, device=device)
    noise = torch.randn(n, dim, generator=g, device=device)
    return centres[pick] + (0.5 / dim ** 0.5) * noise


def make_queries(corpus: torch.Tensor, n: int, g: torch.Generator
                 ) -> torch.Tensor:
    """n distinct corpus rows plus noise of norm ~0.3."""
    rows = torch.randperm(corpus.shape[0], generator=g,
                          device=corpus.device)[:n]
    noise = torch.randn(n, corpus.shape[1], generator=g,
                        device=corpus.device)
    return corpus[rows] + (0.3 / corpus.shape[1] ** 0.5) * noise


def recall_at_k(ids: torch.Tensor, truth: torch.Tensor) -> float:
    """Mean over rows of |ids ∩ truth| / k (−1 never counts)."""
    ids, truth = ids.cpu().numpy(), truth.cpu().numpy()
    return float(np.mean([len(set(a[a >= 0].tolist()) & set(b.tolist()))
                          / truth.shape[1] for a, b in zip(ids, truth)]))


def batched_ids(index, queries: torch.Tensor, batch: int, **kw
                ) -> torch.Tensor:
    """ids of ``index.search`` over ``queries``, ``batch`` rows a call."""
    return torch.cat([index.search(queries[s:s + batch], K, **kw)[1]
                      for s in range(0, queries.shape[0], batch)])


def host_ms(fn, reps: int = REPS) -> tuple[float, float]:
    """Medians of (host enqueue ms, host ms to a synchronise) of ``fn()``,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    enq, wall = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        enq.append((t1 - t0) * 1e3)
        wall.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(enq), statistics.median(wall)


def build_ivf(corpus: torch.Tensor, nlist: int, dtype, quantize,
              seed: int = 0):
    from ance_tpu_torch.index.ivf import IVFIPIndex
    idx = IVFIPIndex(dim=corpus.shape[1], nlist=nlist, dtype=dtype,
                     quantize=quantize, device=corpus.device, seed=seed)
    t0 = time.perf_counter()
    idx.add(corpus)
    torch.cuda.synchronize()
    return idx, time.perf_counter() - t0


def sweep(exact: dict, ivf: dict, queries: torch.Tensor, truth: torch.Tensor,
          batches=BATCHES, nprobes=NPROBES, reps: int = REPS) -> list:
    """One row a (B, nprobe): recall@10 of each IVF index over
    ``queries`` searched B at a time, and the times of every exact index
    and every IVF index at B queries, in turns."""
    from ance_tpu_torch.utils.timing import cuda_ms_turns
    rows = []
    for b in batches:
        q = queries[:b]
        fns = {f"exact_{name}": (lambda ix=ix: ix.search(q, K))
               for name, ix in exact.items()}
        for nprobe in nprobes:
            fns.update({f"ivf_{name}_np{nprobe}":
                        (lambda ix=ix, p=nprobe: ix.search(q, K, nprobe=p))
                        for name, ix in ivf.items()})
        ms = cuda_ms_turns(fns, reps=reps)
        host = {name: host_ms(fn, reps) for name, fn in fns.items()}
        for nprobe in nprobes:
            row = {"batch": b, "nprobe": nprobe,
                   "union": min(b * nprobe, next(iter(ivf.values())).nlist)}
            for name in exact:
                row[f"exact_{name}_ms"] = ms[f"exact_{name}"]
                row[f"exact_{name}_qps"] = b / ms[f"exact_{name}"] * 1e3
            for name, ix in ivf.items():
                key = f"ivf_{name}_np{nprobe}"
                row[f"ivf_{name}_ms"] = ms[key]
                row[f"ivf_{name}_qps"] = b / ms[key] * 1e3
                row[f"ivf_{name}_enqueue_ms"], row[f"ivf_{name}_wall_ms"] = \
                    host[key]
                row[f"ivf_{name}_recall_at_10"] = recall_at_k(
                    batched_ids(ix, queries, b, nprobe=nprobe), truth)
                row[f"ivf_{name}_speedup_vs_exact_bf16"] = \
                    ms["exact_bf16"] / ms[key]
            rows.append(row)
    return rows


def main(argv=None) -> None:
    from ance_tpu_torch.index.flat import FlatIPIndex
    from ance_tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--nlist", type=int, default=NLIST)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type != "cuda":
        raise SystemExit("perf_ivf times the card: --device cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "torch": torch.__version__}),
          flush=True)
    g = torch.Generator(device=dev).manual_seed(0)
    corpus = make_corpus(args.n, D, max(16, args.n // 256), g, dev)
    queries = make_queries(corpus, max(BATCHES + (RECALL_QUERIES,)), g)
    exact = {}
    for name, dtype, quantize in (("fp32", torch.float32, False),
                                  ("bf16", torch.bfloat16, False),
                                  ("dims", torch.float32, "dims")):
        exact[name] = FlatIPIndex(dim=D, device=dev, dtype=dtype,
                                  quantize=quantize)
        exact[name].add_chunked(corpus)
    truth = exact.pop("fp32").search(queries[:RECALL_QUERIES], K)[1]
    ivf = {}
    for name, dtype, quantize in (("bf16", torch.bfloat16, False),
                                  ("dims", torch.float32, "dims")):
        ivf[name], seconds = build_ivf(corpus, args.nlist, dtype, quantize)
        print(json.dumps({"index": f"ivf_{name}", "n": args.n,
                          "nlist": args.nlist,
                          "capacity": ivf[name].capacity,
                          "build_s": seconds,
                          "build_split_s": ivf[name].build_seconds}),
              flush=True)
    for row in sweep(exact, ivf, queries[:RECALL_QUERIES], truth):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
