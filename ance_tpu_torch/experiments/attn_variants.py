"""What the design choices of the kernels rebuilt on wgmma + TMA after the
fused pair are worth, on one CUDA card: kernel #4's bf16 route (the flash
forward, ``csrc/flash_attention.cu``), kernel #5 (``fused128``) and kernel
#6 (``fused_block``, both ``csrc/attn128.cu``).

Each variant is the source with one choice undone or changed by a text
substitution (``fused_variants.substituted``):

  * flash, ``as built``     — two blocks an SM (96 registers a thread), a
                              ring of four 64-key K / V stages;
  * flash, ``one block``    — one block an SM (no register cap below 227);
  * flash, ``two stages``   — a ring of two stages;
  * flash and fused128, ``256-byte L2 promotion`` — the TMA loads' L2
                              promotion at 256 bytes in place of 128;
  * fused128, ``as built``  — one persistent block an SM, the heads dealt
                              to the blocks round-robin, a ring of three
                              heads, the context stored by TMA;
  * fused128, ``two heads`` — a ring of two heads;
  * fused128, ``four heads``— a ring of four heads;
  * fused128, ``two blocks``— two blocks an SM with a ring of two heads
                              each (112 registers a thread);
  * fused128, ``contiguous runs`` — a contiguous run of heads a block;
  * fused_block, ``#6 four stages`` — a ring of four 64-deep stages in
                              place of three (231 KB of shared memory);
  * fused_block, ``#6 heads slowest`` — the blocks of one head adjacent in
                              the grid, in place of those of one pair of
                              batch rows (which share their x rows).

Every variant is built with nvcc (one process each, in parallel), run
through the port's own wrapper with its library in place of the
package's, held to the plain version per element (2 bf16 ulps of |plain|
+ 2 of its (batch row, head) slice's max), and timed with CUDA events
(``utils/timing.py``) in turns with the other variants and the kernel's
yardstick: SDPA on fp32 operands for flash (its function is fp32) at
B=8 S=2048 and B=128 S=512, SDPA with the same additive bias for
``fused128`` at B=128 and 512, S=128 H=768 (the larger batch gives the
time a head beyond the fixed start and tail), the unfused composition
(four ``torch.matmul`` and SDPA) for ``fused_block`` at B=128 S=128 H=768,
H = 12 heads of 64, row 0 all padding. Every ``attn128`` variant runs
every ``attn128`` case (a #5 variant leaves #6 as built, and the reverse).

    python -m ance_tpu_torch.experiments.attn_variants [--reps 9]

prints one line per variant and shape, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.nn.functional as F

from ance_tpu_torch.experiments.fused_variants import (build, inputs,
                                                       slice_excess, through)
from ance_tpu_torch.ops import attn128 as a128
from ance_tpu_torch.ops import flash_attention as fl
from ance_tpu_torch.ops.attention import mask_to_bias
from ance_tpu_torch.utils.timing import clocks_text, timed_in_turns

# fused128's heads as a contiguous run a block, in place of dealt to the
# blocks round-robin
ROUND_ROBIN = """  const int first = blockIdx.x;
  const int last = n_heads;
  const int step = gridDim.x;"""
CONTIGUOUS = """  const int first = static_cast<int>(
      static_cast<long long>(blockIdx.x) * n_heads / gridDim.x);
  const int last = static_cast<int>(
      static_cast<long long>(blockIdx.x + 1) * n_heads / gridDim.x);
  const int step = 1;"""
# fused_block's qkv_attend blocks with the heads of one pair of batch rows
# adjacent (as built) or the pairs of one head
PAIRS_FASTEST = ("  const int b0 = kBlockBatch * (blockIdx.x / heads), "
                 "h = blockIdx.x % heads;")
HEADS_FASTEST = ("  const int pairs = gridDim.x / heads;\n"
                 "  const int b0 = kBlockBatch * (blockIdx.x % pairs), "
                 "h = blockIdx.x / pairs;")
# the TMA loads' L2 promotion (hopper.cuh's tensor maps) at 256 bytes in
# place of 128: a row's neighbouring 128 bytes (fused128: the next head's)
# come into L2 with the box
PROMOTE_256 = ("CU_TENSOR_MAP_L2_PROMOTION_L2_128B",
               "CU_TENSOR_MAP_L2_PROMOTION_L2_256B")
VARIANTS = {
    "flash_attention": {
        "as built": [],
        "one block": [
            ("__launch_bounds__(kBf16Threads, 2)\n    flash_fwd_bf16(",
             "__launch_bounds__(kBf16Threads, 1)\n    flash_fwd_bf16(")],
        "two stages": [("constexpr int kStages = 4;",
                        "constexpr int kStages = 2;")],
        "256-byte L2 promotion": [PROMOTE_256],
    },
    "attn128": {
        "as built": [],
        "two heads": [("constexpr int kRing = 3;",
                       "constexpr int kRing = 2;")],
        "four heads": [("constexpr int kRing = 3;",
                        "constexpr int kRing = 4;")],
        "two blocks": [("constexpr int kRing = 3;",
                        "constexpr int kRing = 2;"),
                       ("constexpr int k5BlocksPerSm = 1;",
                        "constexpr int k5BlocksPerSm = 2;")],
        "contiguous runs": [(ROUND_ROBIN, CONTIGUOUS)],
        "256-byte L2 promotion": [PROMOTE_256],
        "#6 four stages": [
            ("constexpr int kProjStages = 3;", "constexpr int kProjStages = 4;"),
            ("static_assert(kProjStages == kProjWgs,",
             "static_assert(kProjStages >= kProjWgs,")],
        "#6 heads slowest": [(PAIRS_FASTEST, HEADS_FASTEST)],
    },
}
# the kernels whose ptxas report each source's variants print
MODULES = {"flash_attention": (fl, ("flash_fwd_bf16",)),
           "attn128": (a128, ("attn128_kernel", "qkv_attend_kernel",
                              "out_proj_kernel"))}


def cases():
    """(source, shape label, {name: call through the package wrapper with
    a variant's library}, the plain output [B, S, H, 64], the yardstick's
    name and call) for each timed shape."""
    for B, S in ((8, 2048), (128, 512)):
        q, k, v, _, mask = inputs(B, S, seed=S)
        qt, kt, vt = (t.transpose(1, 2).float() for t in (q, k, v))
        bias = mask_to_bias(mask, torch.float32)
        yield ("flash_attention", f"bf16 B={B} S={S}",
               lambda: fl.flash_attention_forward(q, k, v, mask),
               fl.flash_attention_reference(q, k, v, mask),
               "sdpa_fp32", lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, attn_mask=bias).to(torch.bfloat16))
    S = 128
    for B in (128, 512):  # the encode batch; 4x, for the cost a head
        q, k, v, _, mask = inputs(B, S, seed=B)
        mask[:, 100:] = 0  # the seq-128 experiment's padding tail
        flat = [t.reshape(B, S, 768) for t in (q, k, v)]
        bias = mask_to_bias(mask, torch.bfloat16)
        yield ("attn128", f"bf16 B={B} S={S} H=768",
               lambda: a128.fused128(*flat, mask).view(B, S, 12, 64),
               a128.fused128_reference(*flat, mask).view(B, S, 12, 64),
               "sdpa", lambda: F.scaled_dot_product_attention(
                   *(t.transpose(1, 2) for t in (q, k, v)),
                   attn_mask=bias))
    B, H = 128, 768  # fused_block at the encode batch
    g = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn(B, S, H, generator=g, device="cuda").to(torch.bfloat16)
    ws = [(torch.randn(H, H, generator=g, device="cuda") * H ** -0.5)
          .to(torch.bfloat16) for _ in range(4)]
    mask = torch.ones(B, S, dtype=torch.int64, device="cuda")
    mask[:, 100:] = 0
    mask[0] = 0
    bias = mask_to_bias(mask, torch.bfloat16)
    heads = lambda t: t.view(B, S, 12, 64).transpose(1, 2)  # noqa: E731

    def unfused():
        q, k, v = (x @ w for w in ws[:3])
        ctx = F.scaled_dot_product_attention(heads(q), heads(k), heads(v),
                                             attn_mask=bias)
        return ctx.transpose(1, 2).reshape(B, S, H) @ ws[3]
    yield ("attn128", f"#6 bf16 B={B} S={S} H={H}",
           lambda: a128.fused_block(x, *ws, mask).view(B, S, 12, 64),
           a128.fused_block_reference(x, *ws, mask).view(B, S, 12, 64),
           "unfused", unfused)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=9)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("attn_variants: needs a CUDA device")
    jobs = [(source, name) for source, vs in VARIANTS.items() for name in vs]
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(lambda j: build(
            j[0], j[1], VARIANTS[j[0]][j[1]], MODULES[j[0]][0].bind,
            MODULES[j[0]][1]), jobs)))
    result = {"device": torch.cuda.get_device_name(0), "cases": []}
    bad = []
    for source, shape, call, want, yard_name, yard in cases():
        module = MODULES[source][0]
        fns, rows = {}, {}
        for name in VARIANTS[source]:
            lib, report = built[(source, name)]
            n_bad = slice_excess(through(module, lib, call), want)
            if n_bad:
                bad.append(f"{source} {name} {shape}")
            rows[name] = {"ptxas": report, "beyond_the_bound": n_bad}
            fns[name] = (lambda lib=lib: through(module, lib, call))
        fns[yard_name] = yard
        times, sampled = timed_in_turns(fns, args.reps)
        for name, ms in times.items():
            rows.setdefault(name, {})["ms"] = ms
            print(f"{source} {shape} {name:10s} {ms:.4f} ms"
                  + (f"  beyond the bound: {rows[name]['beyond_the_bound']}"
                     f"  ptxas: {rows[name]['ptxas']}"
                     if name in VARIANTS[source] else ""), flush=True)
        print(f"{source} {shape}: {clocks_text(sampled)}", flush=True)
        result["cases"].append({"source": source, "shape": shape,
                                "variants": rows, "clocks": sampled})
    print(json.dumps(result))
    if bad:
        raise SystemExit(f"variants beyond the bound: {bad}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
