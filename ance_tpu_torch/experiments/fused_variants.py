"""What each design choice of the bf16 fused-attention kernels (#2 and #3,
``csrc/fused_attention.cu``) is worth, on one CUDA card.

Each variant is the source with one choice undone by a text substitution:

  * ``as built``   — the source as it is;
  * ``fdiv``       — p = e / l by the division instruction (``__fdiv_rn``)
                     in place of a multiply by 1/l and Markstein's two FMAs
                     (the same correctly rounded quotient; the instruction
                     takes a slow path for every zero numerator);
  * ``expf``       — exp by ``__expf`` (ex2.approx without .ftz, which adds
                     three instructions an exp to keep subnormal results)
                     in place of ex2.approx.ftz;
  * ``one block``  — the forward at one block an SM (``__launch_bounds__``
                     minimum 1, so up to 120 registers a thread) in place of
                     two.

Every variant is built with nvcc (one process each, in parallel) into
``ance_tpu_torch/build/variants/``, run through the port's own wrappers
(``fused_attention_forward`` / ``fused_attention_backward``) with its
library in place of the package's, held to the plain version per element
(2 bf16 ulps of |plain| + 2 of its (batch row, head) slice's max), and
timed with CUDA events in turns with the other variants and SDPA (one run
of each per round; median of ``--reps`` rounds) at the MaxP shapes: the
forward at B=128 S=512, the backward at B=64 S=512, H=12 D=64, a mask of
random lengths with row 0 all padding.

    python -m ance_tpu_torch.experiments.fused_variants [--reps 9]

prints one line per variant and direction, then one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.nn.functional as F

from ance_tpu_torch.ops import _build
from ance_tpu_torch.ops import fused_attention as fa
from ance_tpu_torch.ops.attention import mask_to_bias

VARIANTS = {
    "as built": [],
    "fdiv": [("return __fmaf_rn(__fmaf_rn(-q0, l, e), inv_l, q0);",
              "return __fdiv_rn(e, l);")],
    "expf": [("""  float y;
  asm("ex2.approx.ftz.f32 %0, %1;"
      : "=f"(y)
      : "f"(__fmul_rn(__fsub_rn(s, m), 1.44269504088896341f)));
  return y;""", "  return __expf(__fsub_rn(s, m));")],
    "one block": [("__launch_bounds__(kBf16Threads, 2)\n    fused_fwd_bf16(",
                   "__launch_bounds__(kBf16Threads, 1)\n    fused_fwd_bf16(")],
}


def build(name: str, source: str) -> tuple[ctypes.CDLL, str]:
    """The variant's library (bound as the package binds its own) and
    ptxas's report of the three bf16 kernels."""
    src = source
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name!r}: its substitution no longer "
                               "matches csrc/fused_attention.cu")
        src = src.replace(old, new)
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = name.replace(" ", "_")
    cu = out_dir / f"{tag}.cu"
    cu.write_text(src)
    for header in _build.sources("fused_attention")[1:]:
        shutil.copy(header, out_dir / header.name)
    lib = out_dir / f"lib{tag}.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {name!r}:\n{proc.stderr}")
    lines = proc.stderr.splitlines()
    report = [lines[i + 2].strip() + " " + lines[i + 3].strip()
              for i, line in enumerate(lines)
              if "Compiling entry" in line and "bf16E" in line]
    return fa.bind(ctypes.CDLL(str(lib))), " | ".join(report)


def inputs(B: int, S: int, seed: int, H: int = 12, D: int = 64):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(B, S, H, D, generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    lengths = torch.randint(1, S + 1, (B,), generator=g, device="cuda")
    mask = (torch.arange(S, device="cuda")[None] < lengths[:, None]).long()
    mask[0] = 0
    return q, k, v, do, mask


def slice_excess(got: torch.Tensor, want: torch.Tensor) -> int:
    """Elements beyond 2 bf16 ulps of |plain| + 2 of their slice's max."""
    def ulp(x):
        _, e = torch.frexp(x)
        return torch.where(x > 0, torch.ldexp(torch.ones_like(x), e - 8),
                           torch.zeros_like(x))
    w = want.float()
    err = (got.float() - w).abs()
    bound = 2 * ulp(w.abs()) + 2 * ulp(w.abs().amax(dim=(1, 3), keepdim=True))
    return int((err > bound).sum())


def turns(fns: dict, reps: int, warmup: int = 10) -> dict:
    for _ in range(warmup):
        for fn in fns.values():
            fn()
    times = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end))
    return {name: statistics.median(t) for name, t in times.items()}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=9)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("fused_variants: needs a CUDA device")
    source = (_build.CSRC_DIR / "fused_attention.cu").read_text()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(lambda n: build(n, source),
                                            VARIANTS)))
    package_library = fa._kernel_library

    def through(lib, fn):
        fa._kernel_library = lambda: lib
        try:
            return fn()
        finally:
            fa._kernel_library = package_library

    result = {"device": torch.cuda.get_device_name(0), "variants": {}}
    q, k, v, _, mask = inputs(128, 512, seed=0)
    want = fa.fused_attention_reference(q, k, v, mask)
    fwd = {}
    for name, (lib, report) in built.items():
        bad = slice_excess(
            through(lib, lambda: fa.fused_attention_forward(q, k, v, mask)),
            want)
        result["variants"][name] = {"ptxas": report, "forward_bad": bad}
        fwd[name] = (lambda lib=lib: through(
            lib, lambda: fa.fused_attention_forward(q, k, v, mask)))
    del want
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    bias4 = mask_to_bias(mask, q.dtype)
    fwd["sdpa"] = lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                         attn_mask=bias4)
    fwd_ms = turns(fwd, args.reps)
    del q, k, v, qt, kt, vt, mask, bias4
    q, k, v, do, mask = inputs(64, 512, seed=1)
    want = fa.fused_attention_backward_reference(q, k, v, mask, do)
    bwd = {}
    for name, (lib, _) in built.items():
        got = through(lib, lambda: fa.fused_attention_backward(q, k, v, mask,
                                                               do))
        result["variants"][name]["backward_bad"] = sum(
            slice_excess(g, w) for g, w in zip(got, want))
        bwd[name] = (lambda lib=lib: through(
            lib, lambda: fa.fused_attention_backward(q, k, v, mask, do)))
    del want, got
    leaves = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves,
                                         attn_mask=mask_to_bias(mask, q.dtype))
    bwd["sdpa"] = lambda: torch.autograd.grad(out, leaves, do.transpose(1, 2),
                                              retain_graph=True)
    bwd_ms = turns(bwd, args.reps)
    for name in list(built) + ["sdpa"]:
        row = result["variants"].setdefault(name, {})
        row.update(forward_ms=fwd_ms[name], backward_ms=bwd_ms[name])
        print(f"{name:10s} forward B=128 S=512 {fwd_ms[name]:.3f} ms"
              f"  backward B=64 S=512 {bwd_ms[name]:.3f} ms"
              + (f"  beyond the bound: {row['forward_bad']} / "
                 f"{row['backward_bad']}  ptxas: {row['ptxas']}"
                 if name in built else ""), flush=True)
    print(json.dumps(result))
    bad = [n for n in built if result["variants"][n]["forward_bad"]
           or result["variants"][n]["backward_bad"]]
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
