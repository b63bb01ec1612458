"""RoBERTa-dot (ANCE's ``RobertaDot_NLL_LN``) forward in plain PyTorch.

The published model: post-LN RoBERTa (HF ``RobertaModel``), erf GELU,
position ids counted over non-pad tokens from ``pad_token_id + 1``, the
additive mask bias ``finfo(float32).min``, the CLS row through
``embeddingHead`` (Linear) and ``norm`` (LayerNorm). MaxP encodes each
512-token chunk of a document as its own sequence.

``precision`` sets the arithmetic of every matrix product: ``"fp32"``
(TF32 off), ``"fp8"`` (the control one step below the configuration's
bf16: each operand rounded to float8 e4m3 under a per-tensor scale and
accumulated in fp32), or ``"tf32"``.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale (its largest
    magnitude maps to 448), back in ``t``'s dtype."""
    scale = t.abs().amax().clamp_min(1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


@contextlib.contextmanager
def matmul_precision(precision: str):
    """TF32 on for ``"tf32"``, off otherwise, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    on = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp8":
        return torch.matmul(fp8_round(a), fp8_round(b))
    return torch.matmul(a, b)


def linear(x, w, b, precision: str):
    return _mm(x, w.t(), precision) + b


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def encode(w: dict, ids: torch.Tensor, mask: torch.Tensor, cfg: dict,
           precision: str = "fp32") -> torch.Tensor:
    """[B, S] ids and {0, 1} mask → [B, out_dim] fp32 embeddings (the
    CLS row through the head)."""
    B, S = ids.shape
    H, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    hd = H // nh
    eps = cfg["layer_norm_eps"]
    pad = cfg["pad_token_id"]
    e = "roberta.embeddings."
    keep = (ids != pad).to(torch.int64)
    pos = torch.cumsum(keep, 1) * keep + pad
    x = (w[e + "word_embeddings.weight"][ids]
         + w[e + "position_embeddings.weight"][pos]
         + w[e + "token_type_embeddings.weight"][0])
    x = F.layer_norm(x, (H,), w[e + "LayerNorm.weight"],
                     w[e + "LayerNorm.bias"], eps)
    bias = (1.0 - mask.to(torch.float32))[:, None, None, :] \
        * torch.finfo(torch.float32).min
    for i in range(cfg["num_hidden_layers"]):
        p = f"roberta.encoder.layer.{i}."

        def lin(name, t):
            return linear(t, w[p + name + ".weight"], w[p + name + ".bias"],
                          precision)

        def heads(t):
            return t.view(B, S, nh, hd).transpose(1, 2)
        q = heads(lin("attention.self.query", x))
        k = heads(lin("attention.self.key", x))
        v = heads(lin("attention.self.value", x))
        scores = _mm(q, k.transpose(-1, -2), precision) / math.sqrt(hd)
        probs = torch.softmax(scores + bias, dim=-1)
        ctx = _mm(probs, v, precision).transpose(1, 2).reshape(B, S, H)
        a = lin("attention.output.dense", ctx)
        x = F.layer_norm(x + a, (H,), w[p + "attention.output.LayerNorm.weight"],
                         w[p + "attention.output.LayerNorm.bias"], eps)
        h = gelu(lin("intermediate.dense", x))
        o = lin("output.dense", h)
        x = F.layer_norm(x + o, (H,), w[p + "output.LayerNorm.weight"],
                         w[p + "output.LayerNorm.bias"], eps)
    head = linear(x[:, 0], w["embeddingHead.weight"], w["embeddingHead.bias"],
                  precision)
    return F.layer_norm(head, (head.shape[-1],), w["norm.weight"],
                        w["norm.bias"], cfg["embedding_head"]["layer_norm_eps"])


def encode_rows(w: dict, ids, mask, cfg: dict, device, precision="fp32",
                block: int = 64) -> torch.Tensor:
    """Inference over many rows in blocks, without autograd: [N, out_dim]
    fp32 on ``device``."""
    outs = []
    with torch.no_grad(), matmul_precision(precision):
        for s in range(0, len(ids), block):
            i = torch.as_tensor(ids[s:s + block]).to(device, torch.int64)
            m = torch.as_tensor(mask[s:s + block]).to(device, torch.int64)
            outs.append(encode(w, i, m, cfg, precision))
    return torch.cat(outs)


def mask_from_lengths(lengths, width: int):
    """[N, width] {0, 1} mask from real lengths."""
    lengths = torch.as_tensor(lengths, dtype=torch.int64)
    return (torch.arange(width)[None, :] < lengths[:, None]).to(torch.int64)
