"""Post-LN transformer encoder (RoBERTa/BERT family) as torch modules.

Counterpart of ``ance_tpu/models/transformer.py``. Same function, same
config fields; parameters stay fp32 and each projection runs in the
config's compute ``dtype`` (bf16 on the card), with the embedding sum and
the residual LayerNorms in fp32, as in the JAX package.

Submodule names follow the HF BERT/RoBERTa state dict, not the flax tree,
so a reference or HF ``pytorch_model.bin`` loads with ``load_state_dict``
as it is. The flax ``Mlp`` is split the HF way: :class:`Intermediate`
(Dense + gelu) and :class:`Output` (Dense + residual LayerNorm).

Training: a module in ``train()`` mode applies the JAX package's dropout
(embedding output, attention probabilities, attention output and MLP
output; ``ance_tpu/models/transformer.py:135, 198-203, 212, 231``) with
uniforms drawn from the ``torch.Generator`` its caller passes, and
``remat`` recomputes each layer in the backward
(``torch.utils.checkpoint``). In ``eval()`` mode nothing is dropped.
SEED's two training features, dormant in every shipped config, run in
``train()`` mode only: LayerDrop (``layerdrop_rate``: each layer skipped
for the whole batch with that probability, no rescale of the others;
``ance_tpu/models/transformer.py:274-286``) and Quant-Noise
(``quant_noise_p``: block DropConnect on the Q/K/V and output projection
weights, ``ops/quant_noise.py``; ``:169-209``). Rate 0 or ``eval()``
leaves the forward as it is.

Tensor parallelism (``core/tp.py``): once ``shard_params_tp`` has cut a
rank's slices, :class:`SelfAttention`, :class:`Intermediate` and
:class:`Output` hold the model axis in ``tp_axis`` and run its local heads
and width, with Megatron's *f* in front of each column-parallel block and
*g* between each row-parallel product and its bias.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ance_tpu_torch.core.tp import copy_to_model, reduce_from_model
from ance_tpu_torch.ops.attention import multi_head_attention
from ance_tpu_torch.ops.quant_noise import quant_noise
from ance_tpu_torch.utils.observability import span


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 50265
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    pad_token_id: int = 1
    layer_norm_eps: float = 1e-5
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    initializer_range: float = 0.02
    position_style: str = "roberta"   # "roberta" | "bert"
    dtype: torch.dtype = torch.float32  # compute dtype
    attention_impl: str = "auto"      # see ops.attention.multi_head_attention
    use_type_embeddings: bool = True
    embed_zero_pad: bool = False
    remat: bool = False
    fp32_layernorm: bool = True
    fused_qkv: bool = False
    layerdrop_rate: float = 0.0       # LayerDrop: see the module docstring
    quant_noise_p: float = 0.0        # Quant-Noise on the attention
    quant_noise_block: int = 8        # projections (ops/quant_noise.py)
    # None = AUTO: tanh gelu iff the compute dtype is bf16 (the JAX rule,
    # ance_tpu/models/transformer.py:226-228), so both packages compute
    # the same function; re-choosing it on the H100 is open (PERF.md)
    gelu_approx: Optional[bool] = None

    @staticmethod
    def bert_base(**kw) -> "EncoderConfig":
        """BERT-base (DPR's towers): BERT's vocabulary, two token types,
        pad id 0, LayerNorm eps 1e-12 and positions 0..S−1, the defaults of
        ``ance_tpu/models/transformer.py:88-93``; ``kw`` overrides any."""
        defaults = dict(vocab_size=30522, max_position_embeddings=512,
                        type_vocab_size=2, pad_token_id=0,
                        layer_norm_eps=1e-12, position_style="bert")
        defaults.update(kw)
        return EncoderConfig(**defaults)

    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def roberta_position_ids(input_ids: torch.Tensor,
                         pad_token_id: int) -> torch.Tensor:
    """Cumulative count of non-pad tokens, offset by the pad id (HF
    ``create_position_ids_from_input_ids``)."""
    mask = (input_ids != pad_token_id).to(torch.int64)
    return torch.cumsum(mask, dim=1) * mask + pad_token_id


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout (flax ``nn.Dropout``): keep with probability
    1 − rate, kept entries divided by 1 − rate. ``generator=None`` (eval)
    or rate 0 is the identity."""
    if generator is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype):
    """flax ``nn.Dense(dtype=...)``: input, kernel and bias in ``dtype``."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def _row_parallel(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  axis, dtype: torch.dtype) -> torch.Tensor:
    """A row-parallel Dense: this rank's partial product, summed over the
    model axis in fp32 (*g*), then the bias in ``dtype`` (as
    :func:`_dense` takes it), added once."""
    partial = F.linear(x.to(dtype), weight.to(dtype))
    return (reduce_from_model(partial, axis) + bias.to(dtype)).to(dtype)


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm, cfg: EncoderConfig):
    """Residual LayerNorm: fp32 (fp64 for an fp64 model) in and out-cast
    to the compute dtype, or entirely in the compute dtype when
    ``fp32_layernorm`` is off."""
    if cfg.fp32_layernorm:
        wide = torch.promote_types(cfg.dtype, torch.float32)
        return ln(x.to(wide)).to(cfg.dtype)
    return F.layer_norm(x, ln.normalized_shape, ln.weight.to(cfg.dtype),
                        ln.bias.to(cfg.dtype), ln.eps)


class _Holder(nn.Module):
    """Plain container, so parameter names match the HF key paths."""

    def __init__(self, **modules: nn.Module):
        super().__init__()
        for name, m in modules.items():
            self.add_module(name, m)


class Embeddings(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size)
        if cfg.use_type_embeddings:
            self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                      cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                generator=None):
        cfg = self.cfg
        if position_ids is None:
            if cfg.position_style == "roberta":
                position_ids = roberta_position_ids(input_ids,
                                                    cfg.pad_token_id)
            else:
                position_ids = torch.arange(input_ids.shape[1],
                                            device=input_ids.device)[None]
        x = self.word_embeddings(input_ids) + \
            self.position_embeddings(position_ids)
        if cfg.use_type_embeddings:
            if token_type_ids is None:
                token_type_ids = torch.zeros_like(input_ids)
            x = x + self.token_type_embeddings(token_type_ids)
        x = self.LayerNorm(x)  # fp32, then cast (transformer.py:134-138)
        x = dropout(x, cfg.hidden_dropout, generator)
        if cfg.embed_zero_pad:
            x = x * (input_ids != cfg.pad_token_id)[:, :, None].to(x.dtype)
        return x.to(cfg.dtype)


class SelfAttention(nn.Module):
    """Q/K/V projections (``self.*``), attention and the output projection
    (``output.dense``). ``output.LayerNorm`` is applied by the layer."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        H = cfg.hidden_size
        self.self = _Holder(query=nn.Linear(H, H), key=nn.Linear(H, H),
                            value=nn.Linear(H, H))
        self.output = _Holder(dense=nn.Linear(H, H),
                              LayerNorm=nn.LayerNorm(H,
                                                     eps=cfg.layer_norm_eps))
        self.tp_axis = None  # the model axis under tensor parallelism

    def forward(self, x, attention_mask, generator=None):
        cfg = self.cfg
        B, S, _ = x.shape
        tp = self.tp_axis
        # under tensor parallelism this rank's heads only
        H, D = cfg.num_heads // (tp.world if tp else 1), cfg.head_dim()
        lins = (self.self.query, self.self.key, self.self.value,
                self.output.dense)
        w = [lin.weight for lin in lins]
        if generator is not None and cfg.quant_noise_p > 0.0:
            # training only: the noised weights, drawn q, k, v, out
            w = [quant_noise(wi, cfg.quant_noise_p, cfg.quant_noise_block,
                             generator) for wi in w]
        w = [wi.to(cfg.dtype) for wi in w]
        b = [lin.bias.to(cfg.dtype) for lin in lins]
        x = x.to(cfg.dtype)
        if tp is not None:
            x = copy_to_model(x, tp)
        if cfg.fused_qkv:
            # one [H, 3H] GEMM: the activations are read once, not three times
            qkv = F.linear(x, torch.cat(w[:3]), torch.cat(b[:3]))
            q, k, v = (y.reshape(B, S, H, D) for y in qkv.chunk(3, dim=-1))
        else:
            q, k, v = (F.linear(x, wi, bi).reshape(B, S, H, D)
                       for wi, bi in zip(w[:3], b[:3]))
        ctx = multi_head_attention(
            q, k, v, attention_mask, impl=cfg.attention_impl,
            dropout_rate=0.0 if generator is None else cfg.attention_dropout,
            generator=generator)
        ctx = ctx.reshape(B, S, H * D).to(cfg.dtype)
        if tp is None:
            out = F.linear(ctx, w[3], b[3])
        else:
            out = _row_parallel(ctx, w[3], b[3], tp, cfg.dtype)
        return dropout(out, cfg.hidden_dropout, generator)


def gelu_approximate(cfg: EncoderConfig) -> bool:
    """The AUTO rule: tanh gelu iff the compute dtype is bf16."""
    if cfg.gelu_approx is None:
        return cfg.dtype == torch.bfloat16
    return cfg.gelu_approx


class Intermediate(nn.Module):
    """First half of the JAX ``Mlp``: Dense(H → I) + gelu."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.tp_axis = None  # the model axis under tensor parallelism

    def forward(self, x):
        if self.tp_axis is not None:
            x = copy_to_model(x, self.tp_axis)
        h = _dense(x, self.dense, self.cfg.dtype)
        return F.gelu(h, approximate="tanh" if gelu_approximate(self.cfg)
                      else "none")


class Output(nn.Module):
    """Second half of the JAX ``Mlp`` (Dense(I → H)) and the layer's
    output LayerNorm."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.tp_axis = None  # the model axis under tensor parallelism

    def forward(self, h, generator=None):
        if self.tp_axis is None:
            out = _dense(h, self.dense, self.cfg.dtype)
        else:
            out = _row_parallel(h, self.dense.weight, self.dense.bias,
                                self.tp_axis, self.cfg.dtype)
        return dropout(out, self.cfg.hidden_dropout, generator)


class EncoderLayer(nn.Module):
    """Post-LN block: x = LN(x + attn(x)); x = LN(x + mlp(x))."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.attention = SelfAttention(cfg)
        self.intermediate = Intermediate(cfg)
        self.output = Output(cfg)

    def forward(self, x, attention_mask, generator=None):
        attn = self.attention(x, attention_mask, generator)
        x = _layer_norm(x + attn, self.attention.output.LayerNorm, self.cfg)
        mlp = self.output(self.intermediate(x), generator)
        return _layer_norm(x + mlp, self.output.LayerNorm, self.cfg)


class TransformerEncoder(nn.Module):
    """Token ids → contextual hidden states [B, S, hidden]. In ``train()``
    mode ``generator`` (on the input's device) feeds the dropout; in
    ``eval()`` mode it is ignored. The embeddings and each layer are the
    spans ``encoder.embeddings`` and ``encoder.layer``."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.config = cfg
        self.embeddings = Embeddings(cfg)
        self.encoder = _Holder(layer=nn.ModuleList(
            EncoderLayer(cfg) for _ in range(cfg.num_layers)))

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                generator=None):
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        if not self.training:
            generator = None
        with span("encoder.embeddings"):
            x = self.embeddings(input_ids, token_type_ids,
                                generator=generator)
        rate = self.config.layerdrop_rate
        for layer in self.encoder.layer:
            with span("encoder.layer"):
                if self.config.remat and self.training:
                    y = _remat(layer, x, attention_mask, generator)
                else:
                    y = layer(x, attention_mask, generator)
                if generator is not None and rate > 0.0:
                    # LayerDrop: the layer is computed and its output
                    # dropped for the whole batch, as in the JAX package
                    # (no host read of the draw, so no device synchronize)
                    x = torch.where(layer_dropped(rate, generator), x, y)
                else:
                    x = y
        return x


def layer_dropped(rate: float, generator: torch.Generator) -> torch.Tensor:
    """One LayerDrop draw: a bool scalar, True with probability ``rate``."""
    return torch.rand((), generator=generator, device=generator.device) \
        < rate


def _remat(layer: nn.Module, x: torch.Tensor, attention_mask: torch.Tensor,
           generator: Optional[torch.Generator]) -> torch.Tensor:
    """One layer under ``torch.utils.checkpoint``: its activations are
    recomputed in the backward. The recompute must draw the same dropout
    masks, so the layer runs on a copy of the generator's state, and the
    caller's generator then moves on to where the copy ended."""
    if generator is None:
        return checkpoint(layer, x, attention_mask, None, use_reentrant=False)
    start = generator.get_state()
    end = []

    def run(x):
        g = torch.Generator(device=generator.device)
        g.set_state(start)
        y = layer(x, attention_mask, g)
        end[:] = [g.get_state()]
        return y

    y = checkpoint(run, x, use_reentrant=False)
    generator.set_state(end[0])
    return y


def pool(hidden: torch.Tensor, attention_mask: torch.Tensor,
         use_mean: bool) -> torch.Tensor:
    """CLS-token or masked-mean pooling."""
    if not use_mean:
        return hidden[:, 0]
    mask = attention_mask.to(hidden.dtype)[:, :, None]
    return (hidden * mask).sum(1) / attention_mask.to(hidden.dtype).sum(
        1, keepdim=True)


def init_weights(module: nn.Module, cfg: EncoderConfig,
                 generator: torch.Generator) -> None:
    """Seeded init with the JAX package's scheme: N(0, initializer_range)
    for every kernel and embedding table, zero biases, unit LayerNorm."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Embedding)):
                m.weight.copy_(torch.randn(m.weight.shape,
                                           generator=generator)
                               * cfg.initializer_range)
                if isinstance(m, nn.Linear):
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
