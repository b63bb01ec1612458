"""What the design choices of kernel #1's pieces kernels
(``csrc/blockmax.cu``: ``blockmax_bf16_int8``, ``blockmax_pieces_f32``,
``blockmax_pieces_int8``) are worth, on one CUDA card.

Each variant is the source (``csrc/blockmax.cu`` and ``hopper.cuh``)
with one choice undone by a text substitution:

  * ``as built``      — the source as it is;
  * ``tile a block``  — a block for every 128 x 128 tile in place of one
                        persistent block an SM walking its tiles (whose
                        producer fills the next tile's ring while the
                        consumers take the last one's block maxima);
  * ``4 buffers``,
    ``2 buffers``     — ``blockmax_bf16_int8`` cycling its A fragments
                        through four or two buffers (waiting for a k-step's
                        products before reusing its buffer) in place of
                        eight, a whole 128-column stage's.

Every variant is built with nvcc (one process each, in parallel) into
``ance_tpu_torch/build/variants/blockmax/<variant>/``, run through the
port's wrapper (``ops/topk.py::blockmax_scores``) with its library in
place of the package's, held to the plain version (``FLOAT_ATOL``, 2e-3,
at block_size 16 and, on 64 queries, 2), and timed with CUDA events
(``utils/timing.py``) in turns with the other variants and, for bf16 x
int8, cuBLAS's bf16 product of the widened codes (median of ``--reps``
rounds) at 1,000,448 × 768, Q = 2048 and 512.

    python -m ance_tpu_torch.experiments.blockmax_variants [--reps 9]

prints one line per route and Q, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
from concurrent.futures import ThreadPoolExecutor

import torch

from ance_tpu_torch.experiments.fused_variants import build, through
from ance_tpu_torch.ops import topk
from ance_tpu_torch.utils.timing import cuda_ms_turns

FLOAT_ATOL = 2e-3
N_ROWS, DIM = 1_000_448, 768
_BUFFERS = "static constexpr int kBuffers = QP == 3 ? 2 : 8;"
VARIANTS = {
    "as built": [],
    "tile a block": [
        ("const long long blocks = n_tiles < sms ? n_tiles : sms;",
         "const long long blocks = n_tiles;")],
    "4 buffers": [(_BUFFERS, _BUFFERS.replace(": 8;", ": 4;"))],
    "2 buffers": [(_BUFFERS, _BUFFERS.replace(": 8;", ": 2;"))],
}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=9)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("blockmax_variants: needs a CUDA device")
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(
            lambda n: build("blockmax", n, VARIANTS[n], topk.bind,
                            ("blockmax_bf16_int8", "blockmax_pieces")),
            VARIANTS)))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    c8 = torch.randint(-127, 128, (N_ROWS, DIM), generator=g,
                       device=dev).to(torch.int8)
    corpora = {"bf16xint8": c8, "f32xint8": c8,
               "f32xf32": torch.randn(N_ROWS, DIM, generator=g, device=dev)}
    result = {"device": torch.cuda.get_device_name(0),
              "ptxas": {n: report for n, (_, report) in built.items()},
              "ms": {}, "bad": []}
    for route, c in corpora.items():
        for n_q in (2048, 512):
            q = torch.randn(n_q, DIM, generator=g, device=dev) / 30
            fns = {}
            if route == "bf16xint8":
                q = q.to(torch.bfloat16)
                c16 = c.to(torch.bfloat16)
                fns["cublas_bf16"] = lambda q=q, c16=c16: torch.mm(
                    q, c16.T, out_dtype=torch.float32)
            for name, (lib, _) in built.items():
                for bs, rows in ((16, n_q), (2, 64)):
                    got = through(topk, lib, lambda: topk.blockmax_scores(
                        q[:rows], c, block_size=bs))
                    want = topk.blockmax_scores_reference(q[:rows], c,
                                                          block_size=bs)
                    err = (got - want).abs().max().item()
                    if err > FLOAT_ATOL:
                        result["bad"].append([route, n_q, bs, name, err])
                    del got, want
                fns[name] = (lambda lib=lib, q=q, c=c: through(
                    topk, lib, lambda: topk.blockmax_scores(q, c)))
            ms = cuda_ms_turns(fns, args.reps)
            result["ms"][f"{route} Q={n_q}"] = ms
            print(f"{route} Q={n_q}: " + "  ".join(
                f"{name} {t:.3f} ms" for name, t in ms.items()), flush=True)
    print(json.dumps(result))
    return 1 if result["bad"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
