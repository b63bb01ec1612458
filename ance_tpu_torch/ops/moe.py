"""A mixture-of-experts layer: routing, the grouped expert products and the
combine (DeepSeek-V2's MoE; ``models/deepseek_v2.py``).

:func:`moe_forward` computes, for each token t of x [T, H],

    base_t + S(x_t) + Σ_{e ∈ top-k(p_t)} scaling · p_{t,e} · E_e(x_t),
    p_t = softmax(W_g x_t)

with the router in fp32, greedy top-k, no renormalisation and no capacity
(no token is dropped), S the shared experts' SwiGLU and each E_e a routed
SwiGLU. A pad token (``real`` false) is not routed: it takes base + S(x)
alone. Nothing is read back to the host, so the layer never waits for the
device:

1. route (span ``encoder.moe.route``): the router's probabilities and
   top-k; pad tokens' choices set to a sentinel expert E, past the real
   ones; the T·k (token, expert) pairs sorted by expert (stable), so a pad
   token's pairs sort last; per expert its count, and the offsets of its
   rows and row tiles (``ops/grouped_gemm.py::schedule``); each sorted
   pair's token and gate weight, and each token's k positions in the
   sorted order (:func:`sort_pairs`);
2. the weights cast to the compute dtype (span ``encoder.moe.cast``), as
   ``models/transformer.py::_dense`` casts per call;
3. the experts (span ``encoder.moe.experts``): the shared SwiGLU over
   every row (cuBLAS), then the routed experts as two grouped launches of
   kernel #7 (``csrc/grouped_gemm.cu``: ``grouped_swiglu`` over the gate
   and up projections, ``grouped_down`` scaled by the gate weights) over
   the real pairs only;
4. the combine (span ``encoder.moe.route`` again): each token's base,
   shared output and routed rows summed in fp32.

Counters, recorded as the spans are, only while a ``torch.profiler``
records (otherwise they cost one check), kept on the device until
:func:`reset_moe_counters` and read by :func:`moe_counters`:
``routed_pairs`` (token-expert pairs computed), ``routed_tokens`` (real
tokens routed) and ``expert_tokens_max`` (the busiest expert's pairs in a
call, summed over calls).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ance_tpu_torch.ops import grouped_gemm
from ance_tpu_torch.utils.observability import span

_COUNTER_NAMES = ("routed_pairs", "routed_tokens", "expert_tokens_max")
_counts: dict[str, torch.Tensor] = {}  # device → int64 [3], summed


def route(x: torch.Tensor, gate_weight: torch.Tensor, top_k: int,
          scaling: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """(weights [T, k] fp32, experts [T, k] int64): the fp32 softmax over
    ``gate_weight`` [E, H] and its greedy top-k (largest first), times
    ``scaling``."""
    wide = torch.promote_types(x.dtype, torch.float32)
    probs = torch.softmax(F.linear(x.to(wide), gate_weight.to(wide)), dim=-1)
    weights, experts = torch.topk(probs, top_k, dim=-1)
    return (weights * scaling if scaling != 1.0 else weights), experts


def moe_forward(x: torch.Tensor, real: torch.Tensor,
                gate_weight: torch.Tensor, w_gate: torch.Tensor,
                w_up: torch.Tensor, w_down: torch.Tensor,
                shared: tuple[torch.Tensor, torch.Tensor, torch.Tensor], *,
                top_k: int, dtype: torch.dtype, base: torch.Tensor,
                scaling: float = 1.0) -> torch.Tensor:
    """``base`` + the MoE output for x [T, H] (module docstring): fp32
    [T, H]. ``real`` [T] bool; ``gate_weight`` [E, H]; the routed experts
    stacked, ``w_gate`` and ``w_up`` [E, I, H], ``w_down`` [E, H, I];
    ``shared`` its (gate, up, down) weights; ``dtype`` the products'."""
    E = w_gate.shape[0]
    dev = x.device
    with span("encoder.moe.route", dev):
        weights, experts = route(x, gate_weight, top_k, scaling)
        pairs = sort_pairs(experts, weights, real, E)
        _count(dev, pairs.counts, real)
        xc = x.to(dtype)
    with span("encoder.moe.cast"):
        wg, wu, wd = (w.to(dtype) for w in (w_gate, w_up, w_down))
        sg, su, sd = (w.to(dtype) for w in shared)
    with span("encoder.moe.experts", dev):
        shared_out = F.linear(F.silu(F.linear(xc, sg)) * F.linear(xc, su),
                              sd)
        h = grouped_gemm.grouped_swiglu(xc, pairs.rows, wg, wu,
                                        pairs.pair_off, pairs.tile_off,
                                        pairs.slots)
        y = grouped_gemm.grouped_down(h, wd, pairs.gate, pairs.pair_off,
                                      pairs.tile_off, pairs.slots)
    with span("encoder.moe.route", dev):
        return grouped_gemm.combine(base, shared_out, y, pairs.pos, real)


class Pairs(NamedTuple):
    """The (token, expert) pairs sorted by expert (:func:`sort_pairs`)."""
    rows: torch.Tensor      # [T·k] int32: each sorted pair's token
    gate: torch.Tensor      # [T·k] fp32: its gate weight
    pos: torch.Tensor       # [T, k] int32: each token's pairs' positions
    counts: torch.Tensor    # [E] int64: the real pairs of each expert
    pair_off: torch.Tensor  # [E + 1] int32 (grouped_gemm.schedule)
    tile_off: torch.Tensor  # [E + 1] int32
    slots: int              # row-tile slots of the grouped launches


def sort_pairs(experts: torch.Tensor, weights: torch.Tensor,
               real: torch.Tensor, E: int) -> Pairs:
    """The T·k pairs of ``experts`` [T, k] (ids < E) and ``weights`` [T, k]
    sorted by expert (stable), a pad token's (``real`` false) set to a
    sentinel expert E so they sort last and no expert counts them; on the
    device, nothing read back."""
    T, top_k = experts.shape
    dev = experts.device
    flat = experts.masked_fill(~real[:, None], E).reshape(-1)
    order = torch.argsort(flat, stable=True)
    # (CUDA's bincount reads the largest id back to the host)
    counts = torch.zeros(E + 1, dtype=torch.int64, device=dev) \
        .index_add_(0, flat, torch.ones_like(flat))[:E]
    pair_off, tile_off, slots = grouped_gemm.schedule(counts, T * top_k)
    rows = torch.div(order, top_k, rounding_mode="floor").to(torch.int32)
    gate = weights.reshape(-1).index_select(0, order).float()
    pos = torch.empty(T * top_k, dtype=torch.int32, device=dev).scatter_(
        0, order, torch.arange(T * top_k, dtype=torch.int32, device=dev))
    return Pairs(rows, gate, pos.view(T, top_k), counts, pair_off, tile_off,
                 slots)


def _count(dev, counts: torch.Tensor, real: torch.Tensor) -> None:
    if not torch.autograd._profiler_enabled():
        return
    # always in inference mode, so a call inside it and one outside it
    # update the same (inference) tensor
    with torch.inference_mode():
        step = torch.stack([counts.sum(), real.sum(), counts.max()]) \
            .to(torch.int64)
        key = str(dev)
        if key in _counts:
            _counts[key].add_(step)
        else:
            _counts[key] = step


def moe_counters() -> dict[str, int]:
    """The counters (module docstring), summed over the devices; a read
    waits for the device."""
    total = [0, 0, 0]
    for t in _counts.values():
        total = [a + int(b) for a, b in zip(total, t.tolist())]
    return dict(zip(_COUNTER_NAMES, total))


def reset_moe_counters() -> None:
    _counts.clear()
