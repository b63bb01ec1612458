"""The seq-128 attention A/B: does a seq-128 attention kernel beat the
plain path at the FirstP encode shape (B = 128 × S = 128 × 768, 12
layers)?

Port of ``docs/perf_attn128_r3.py``. Its mirror encoder (bf16 weights of
RoBERTa-base's shapes, no biases in the attention projections, LayerNorm
in fp32 rounded to bf16, tanh gelu, CLS row through a head) takes one of
four attention variants:

  * ``xla``      — the script's own math: a bf16 einsum, its scores
                   rounded to bf16 and then divided by √64 in fp32 (the
                   script divides by a numpy float64, which promotes them),
                   the fp32 bias, an fp32 softmax, p·v in fp32, the context
                   rounded to bf16;
  * ``fold``     — the port's fused whole-sequence attention (kernel #2,
                   :func:`ance_tpu_torch.ops.fused_attention.fused_attention`)
                   on [B, S, 12, 64] views;
  * ``fused128`` — :func:`ance_tpu_torch.ops.attn128.fused128` (kernel #5)
                   on the projections' [B, S, 768];
  * ``block``    — :func:`ance_tpu_torch.ops.attn128.fused_block` (kernel
                   #6): projections, attention and output projection.

On a CUDA tensor the kernel variants launch their kernels; on a CPU tensor
they run the plain versions. The TPU script's ``group`` knob (x rows per
VMEM tile) has no counterpart.

    python -m ance_tpu_torch.experiments.perf_attn128 --device cuda

prints one JSON line per variant (ms per batch, passages/s) and a summary,
timed with CUDA events: one warm-up, then the median of 5 runs.
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch

from ance_tpu_torch.ops.attention import NEG_INF
from ance_tpu_torch.utils.timing import cuda_ms

VOCAB = 50265
BATCH, SEQ, LAYERS = 128, 128, 12  # the script's B, S and L
VARIANTS = ("xla", "fold", "fused128", "block")


def make_params(rs: np.random.RandomState, *, layers: int = 12,
                hidden: int = 768, intermediate: int = 3072,
                seq: int = 128, device="cpu") -> dict:
    """The script's ``make_params``: N(0, 0.02) bf16 weights drawn from
    ``rs`` in its order (per layer q, k, v, o, up, down; then the token and
    position embeddings and the head), LayerNorms at (1, 0) in fp32.
    Matrices are [in, out] (x @ W), as in the script."""
    def w(*shape):
        return torch.from_numpy(rs.randn(*shape) * 0.02).to(
            device, torch.bfloat16)

    def ln():
        return (torch.ones(hidden, device=device),
                torch.zeros(hidden, device=device))

    out_layers = []
    for _ in range(layers):
        out_layers.append({
            "q": w(hidden, hidden), "k": w(hidden, hidden),
            "v": w(hidden, hidden), "o": w(hidden, hidden),
            "up": w(hidden, intermediate), "down": w(intermediate, hidden),
            "ln1": ln(), "ln2": ln()})
    return {"emb": w(VOCAB, hidden), "pos": w(seq + 2, hidden), "ln0": ln(),
            "head": w(hidden, hidden), "layers": out_layers}


def _tensor(a) -> torch.Tensor:
    """A numpy array (bf16 through its 16-bit view) → a tensor of its
    dtype."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_jax(tree: dict) -> dict:
    """The JAX script's params (its arrays as numpy) → :func:`make_params`'s
    layout, value for value."""
    def ln(pair):
        return tuple(_tensor(a) for a in pair)

    return {"emb": _tensor(tree["emb"]), "pos": _tensor(tree["pos"]),
            "ln0": ln(tree["ln0"]), "head": _tensor(tree["head"]),
            "layers": [{**{k: _tensor(lp[k]) for k in
                           ("q", "k", "v", "o", "up", "down")},
                        "ln1": ln(lp["ln1"]), "ln2": ln(lp["ln2"])}
                       for lp in tree["layers"]]}


def layer_norm(x: torch.Tensor, scale_bias) -> torch.Tensor:
    """``jax.nn.standardize`` in fp32 (variance as E[x²] − E[x]², clipped
    at 0; eps 1e-5), then scale and bias, rounded to bf16."""
    scale, bias = scale_bias
    x32 = x.to(torch.float32)
    mean = x32.mean(-1, keepdim=True)
    var = ((x32 * x32).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    y = (x32 - mean) * torch.rsqrt(var + 1e-5)
    return (y * scale + bias).to(torch.bfloat16)


def _xla_attention(q, k, v, mask, heads: int) -> torch.Tensor:
    """The script's ``xla`` path: the bf16 einsum's scores divided by √64
    in fp32, the fp32 bias, an fp32 softmax, an fp32 einsum with v, the
    context rounded to bf16."""
    B, S, H = q.shape
    split = lambda t: t.reshape(B, S, heads, H // heads)  # noqa: E731
    s = torch.einsum("bqhd,bkhd->bhqk", split(q), split(k)).float()
    s = s / math.sqrt(H // heads)
    bias = torch.where(mask[:, None, None, :] > 0, 0.0, NEG_INF)
    p = torch.softmax(s + bias, dim=-1)
    ctx = torch.einsum("bhqk,bkhd->bqhd", p, split(v).float())
    return ctx.to(torch.bfloat16).reshape(B, S, H)


def encoder(params: dict, ids: torch.Tensor, mask: torch.Tensor, *,
            attn: str, heads: int = 12) -> torch.Tensor:
    """The mirror encoder over token ids [B, S] and a {0,1} mask [B, S] →
    [B, H] bf16 (the CLS row through the head)."""
    from ance_tpu_torch.ops.attn128 import fused128, fused_block
    from ance_tpu_torch.ops.fused_attention import fused_attention

    if attn not in VARIANTS:
        raise ValueError(f"attn must be one of {VARIANTS}, got {attn!r}")
    B, S = ids.shape
    H = params["emb"].shape[1]
    with torch.inference_mode():
        x = params["emb"][ids] + params["pos"][:S][None, :, :]
        x = layer_norm(x, params["ln0"])
        for lp in params["layers"]:
            if attn == "block":
                attn_out = fused_block(x, lp["q"], lp["k"], lp["v"], lp["o"],
                                       mask)
            else:
                x2 = x.reshape(B * S, H)
                qf, kf, vf = ((x2 @ lp[w]).reshape(B, S, H)
                              for w in ("q", "k", "v"))
                if attn == "fused128":
                    ctx = fused128(qf, kf, vf, mask)
                elif attn == "fold":
                    split = lambda t: t.reshape(B, S, heads, H // heads)  # noqa: E731
                    ctx = fused_attention(split(qf), split(kf), split(vf),
                                          mask).reshape(B, S, H)
                else:
                    ctx = _xla_attention(qf, kf, vf, mask, heads)
                attn_out = (ctx.reshape(B * S, H) @ lp["o"]).reshape(B, S, H)
            x = layer_norm(x + attn_out, lp["ln1"])
            h = torch.nn.functional.gelu(x.reshape(B * S, H) @ lp["up"],
                                         approximate="tanh")
            h = (h @ lp["down"]).reshape(B, S, H)
            x = layer_norm(x + h, lp["ln2"])
        return x[:, 0, :] @ params["head"]


def inputs(rs: np.random.RandomState, batch: int, seq: int, device,
           pad_from: int = 100):
    """The script's token ids (uniform in [4, 50000)) and mask (a padding
    tail from ``pad_from``)."""
    ids = torch.as_tensor(rs.randint(4, 50000, (batch, seq)),
                          dtype=torch.int64, device=device)
    mask = torch.ones((batch, seq), dtype=torch.int64, device=device)
    mask[:, pad_from:] = 0
    return ids, mask


def main(argv=None) -> None:
    from ance_tpu_torch.utils.device import resolve_device
    p = argparse.ArgumentParser(prog="perf_attn128")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type != "cuda":
        raise SystemExit("perf_attn128 times the card: --device cuda")
    rs = np.random.RandomState(0)
    params = make_params(rs, layers=LAYERS, seq=SEQ, device=dev)
    ids, mask = inputs(rs, BATCH, SEQ, dev)
    results = {}
    for name in VARIANTS:
        ms = cuda_ms(lambda: encoder(params, ids, mask, attn=name))
        results[name] = {"ms": ms, "passages_per_s": BATCH / ms * 1e3}
        print(json.dumps({name: results[name]}), flush=True)
    print(json.dumps({"summary": results, "batch": BATCH, "seq": SEQ,
                      "layers": LAYERS,
                      "device": torch.cuda.get_device_name(dev)}))


if __name__ == "__main__":
    main()
