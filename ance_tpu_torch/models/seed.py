"""SEED-Encoder model family as torch modules (counterpart of
``ance_tpu/models/seed.py``).

  * encoder: fairseq's TransformerSentenceEncoder, which is this package's
    :class:`TransformerEncoder` without type embeddings and with the
    embeddings zeroed at pad positions (:func:`seed_encoder_config`);
  * ``seeddot_nll`` (SEEDEncoderDot_NLL_LN): :class:`RobertaDot` over that
    encoder (:func:`seed_dot_model`);
  * pretraining (SEEDEncoderForMaskedLM): :class:`SeedForMaskedLM`, the
    encoder with a tied-embedding MLM head and a weak pre-LN decoder that
    sees the encoder only through a one-token cross-attention to CLS,
    under a windowed causal mask (span ``attention_window``, column 0
    always visible).

The decoder and the LM head run in fp32 whatever the encoder's compute
dtype, as in the JAX package (the encoder's hidden states are cast to
fp32 before them). The decoder's attention is plain torch: an einsum with
the [S, S] windowed bias; the fused kernel takes only a per-key bias.

State-dict names. The encoder is ``roberta.*`` in both models, so the
encoder of a pretraining checkpoint is a ``seeddot_nll`` state dict
without its head. The decoder and LM head take the fairseq names the
reference's checkpoints use (``modeling_seed_encoder.py:136-183``):
``decoder.layers.{i}.{self_attn,encoder_attn}.{q,k,v,out}_proj``,
``decoder.layers.{i}.{self_attn,encoder_attn,final}_layer_norm``,
``decoder.layers.{i}.fc1`` / ``fc2``, ``decoder.embed_positions``,
``decoder.layernorm_embedding``, ``decoder.layer_norm``,
``lm_head.dense``, ``lm_head.layer_norm`` and ``lm_head.bias``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ance_tpu_torch.models.dot_models import RobertaDot
from ance_tpu_torch.models.transformer import (EncoderConfig,
                                               TransformerEncoder, _Holder,
                                               dropout)
from ance_tpu_torch.ops.attention import NEG_INF


@dataclasses.dataclass(frozen=True)
class SeedDecoderConfig:
    num_layers: int = 3            # config_decoder_3_attn_2 default
    attention_window: int = 2      # decoder_atten_window (2 or 8)
    hidden_size: int = 768
    num_heads: int = 12
    intermediate_size: int = 3072
    max_positions: int = 512
    dropout: float = 0.1
    layer_norm_eps: float = 1e-5
    learned_pos: bool = True       # False: fairseq's sinusoidal table


def seed_encoder_config(vocab_size: int = 32769, **kw) -> EncoderConfig:
    """SEEDEncoderConfig defaults (``ance_tpu/models/seed.py:48-57``)."""
    defaults = dict(vocab_size=vocab_size, hidden_size=768, num_layers=12,
                    num_heads=12, intermediate_size=3072,
                    max_position_embeddings=516,  # 512 + pad offset headroom
                    type_vocab_size=1, pad_token_id=1,
                    position_style="roberta", use_type_embeddings=False,
                    embed_zero_pad=True)
    defaults.update(kw)
    return EncoderConfig(**defaults)


def seed_dot_model(vocab_size: int = 32769, out_dim: int = 768,
                   config_overrides=None, **kw) -> RobertaDot:
    """The ``seeddot_nll`` retrieval model (reference models.py:201-221);
    ``config_overrides`` may carry ``vocab_size``."""
    kw.update(config_overrides or {})
    vocab_size = kw.pop("vocab_size", vocab_size)
    return RobertaDot(seed_encoder_config(vocab_size, **kw), use_mean=False,
                      out_dim=out_dim)


def sinusoidal_positions(num_embeddings: int, dim: int,
                         padding_idx: Optional[int] = None) -> torch.Tensor:
    """Fairseq's sinusoidal position table [num, dim] (reference
    modules.py:184-275): geometric frequencies, sines then cosines, an odd
    dim padded with a zero column, the pad row zeroed. ``max(half-1, 1)``
    keeps dims ≤ 3 finite."""
    half = dim // 2
    freq = torch.exp(torch.arange(half, dtype=torch.float32)
                     * -(math.log(10000.0) / max(half - 1, 1)))
    ang = torch.arange(num_embeddings, dtype=torch.float32)[:, None] \
        * freq[None, :]
    table = torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)
    if dim % 2 == 1:
        table = torch.cat([table, torch.zeros(num_embeddings, 1)], dim=1)
    if padding_idx is not None:
        table[padding_idx] = 0.0
    return table


class AdaptiveSoftmax(nn.Module):
    """Adaptive softmax (Grave et al. 2016; reference modules.py:1082-1247),
    with static shapes as in the JAX package: the head scores the first
    ``cutoffs[0]`` words and one logit a tail cluster; tail cluster i
    factorizes through a rank ``input_dim / factor^(i+1)`` projection.
    Dormant in shipped SEED configs."""

    def __init__(self, vocab_size: int, input_dim: int, cutoffs,
                 factor: float = 4.0):
        super().__init__()
        cut = list(cutoffs)
        if vocab_size > cut[-1]:
            cut = cut + [vocab_size]
        if cut[-1] != vocab_size:
            raise ValueError("cutoff larger than vocab size")
        self.cut = tuple(cut)
        n_tail = len(self.cut) - 1
        self.head = nn.Linear(input_dim, self.cut[0] + n_tail, bias=False)
        self.tail_proj = nn.ModuleList(
            nn.Linear(input_dim, max(1, int(input_dim // factor ** (i + 1))),
                      bias=False) for i in range(n_tail))
        self.tail_out = nn.ModuleList(
            nn.Linear(proj.out_features, self.cut[i + 1] - self.cut[i],
                      bias=False) for i, proj in enumerate(self.tail_proj))
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.xavier_uniform_(m.weight)

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        """[..., d] → full-vocabulary log-probabilities [..., V]."""
        head_lp = torch.log_softmax(self.head(x), dim=-1)
        parts = [head_lp[..., :self.cut[0]]]
        for i, (proj, out) in enumerate(zip(self.tail_proj, self.tail_out)):
            tail_lp = torch.log_softmax(out(proj(x)), dim=-1)
            parts.append(tail_lp + head_lp[..., self.cut[0] + i, None])
        return torch.cat(parts, dim=-1)

    def nll(self, x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """Mean NLL of ``target`` without materialising [..., V]: the head
        term plus the target's own cluster's term."""
        c0 = self.cut[0]
        bounds = torch.tensor(self.cut, device=target.device)
        cluster = torch.clamp(
            torch.searchsorted(bounds, target, right=True) - 1, min=0)
        in_head = target < c0
        head_lp = torch.log_softmax(self.head(x), dim=-1)
        mapped = torch.where(in_head, torch.clamp(target, max=c0 - 1),
                             c0 + cluster)
        lp = head_lp.gather(-1, mapped[..., None])[..., 0]
        for i, (proj, out) in enumerate(zip(self.tail_proj, self.tail_out)):
            tail_lp = torch.log_softmax(out(proj(x)), dim=-1)
            size = self.cut[i + 1] - self.cut[i]
            within = torch.clamp(target - self.cut[i], 0, size - 1)
            t = tail_lp.gather(-1, within[..., None])[..., 0]
            lp = lp + torch.where(~in_head & (cluster == i), t,
                                  torch.zeros_like(t))
        return -lp.mean()


def windowed_causal_bias(seq_len: int, window: int,
                         device=None) -> torch.Tensor:
    """Decoder self-attention bias [S, S]: position i sees (i-window, i]
    and column 0, the CLS bottleneck token (reference
    transformer_sentence_encoder.py:585-616)."""
    i = torch.arange(seq_len, device=device)[:, None]
    j = torch.arange(seq_len, device=device)[None, :]
    allowed = ((j <= i) & (j > i - window)) | (j == 0)
    return torch.where(allowed, 0.0, NEG_INF)


def _attention(q_proj: nn.Linear, k_proj: nn.Linear, v_proj: nn.Linear,
               out_proj: nn.Linear, num_heads: int, q_in, kv_in,
               bias=None) -> torch.Tensor:
    """fp32 multi-head attention of ``q_in`` [B, Sq, C] over ``kv_in``
    [B, Sk, C] with an optional additive bias on the logits."""
    B, Sq, C = q_in.shape
    D = C // num_heads
    q = q_proj(q_in).reshape(B, Sq, num_heads, D)
    k = k_proj(kv_in).reshape(B, kv_in.shape[1], num_heads, D)
    v = v_proj(kv_in).reshape(B, kv_in.shape[1], num_heads, D)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(D)
    if bias is not None:
        logits = logits + bias
    w = torch.softmax(logits, dim=-1)
    return out_proj(torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, Sq, C))


def _attention_block(C: int) -> _Holder:
    return _Holder(q_proj=nn.Linear(C, C), k_proj=nn.Linear(C, C),
                   v_proj=nn.Linear(C, C), out_proj=nn.Linear(C, C))


class SeedDecoderLayer(nn.Module):
    """Pre-LN decoder layer (``decoder_normalize_before``): windowed
    self-attention, then cross-attention to the memory, then the FFN, each
    with a pre-LayerNorm and a residual; fp32."""

    def __init__(self, cfg: SeedDecoderConfig):
        super().__init__()
        self.cfg = cfg
        C = cfg.hidden_size
        self.self_attn = _attention_block(C)
        self.self_attn_layer_norm = nn.LayerNorm(C, eps=cfg.layer_norm_eps)
        self.encoder_attn = _attention_block(C)
        self.encoder_attn_layer_norm = nn.LayerNorm(C, eps=cfg.layer_norm_eps)
        self.fc1 = nn.Linear(C, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, C)
        self.final_layer_norm = nn.LayerNorm(C, eps=cfg.layer_norm_eps)

    def _mha(self, block: _Holder, q_in, kv_in, bias=None):
        return _attention(block.q_proj, block.k_proj, block.v_proj,
                          block.out_proj, self.cfg.num_heads, q_in, kv_in,
                          bias)

    def _ffn(self, x):
        return self.fc2(F.gelu(self.fc1(self.final_layer_norm(x))))

    def forward(self, x, memory, self_bias, generator=None):
        rate = self.cfg.dropout
        h = self.self_attn_layer_norm(x)
        x = x + dropout(self._mha(self.self_attn, h, h, self_bias), rate,
                        generator)
        h = self.encoder_attn_layer_norm(x)
        x = x + dropout(self._mha(self.encoder_attn, h, memory), rate,
                        generator)
        return x + dropout(self._ffn(x), rate, generator)

    def step(self, x_t, memory, cache: dict, layer: int, pos: int):
        """One incremental token ``x_t`` [B, 1, C] at position ``pos`` with
        this layer's K/V slots in ``cache`` (:class:`DecodeCache`, updated
        in place). Inference only, as the reference's incremental state."""
        cfg = self.cfg
        H = cfg.num_heads
        D = cfg.hidden_size // H
        B = x_t.shape[0]
        a = self.self_attn
        h = self.self_attn_layer_norm(x_t)
        q = a.q_proj(h).reshape(B, H, D)
        DecodeCache.update(cache, layer, pos, a.k_proj(h).reshape(B, H, D),
                           a.v_proj(h).reshape(B, H, D))
        k, v = cache["k"][layer], cache["v"][layer]       # [B, W+1, H, D]
        logits = torch.einsum("bhd,bshd->bhs", q, k) / math.sqrt(D)
        logits = logits + DecodeCache.attend_bias(
            cache["k"].shape[2] - 1, pos, x_t.device)[None, None, :]
        w = torch.softmax(logits, dim=-1)
        x = x_t + a.out_proj(
            torch.einsum("bhs,bshd->bhd", w, v).reshape(B, 1, -1))
        x = x + self._mha(self.encoder_attn, self.encoder_attn_layer_norm(x),
                          memory)
        return x + self._ffn(x)


class DecodeCache:
    """Fixed-size K/V cache for incremental decoding: under the windowed
    mask step t sees position 0 and the last W positions only, so a layer
    keeps W + 1 slots: slot 0 holds position 0, slots 1..W a ring over the
    positions ≥ 1 (position p in slot 1 + (p − 1) % W)."""

    @staticmethod
    def init(num_layers: int, batch: int, window: int, heads: int,
             head_dim: int, device=None, dtype=torch.float32) -> dict:
        shape = (num_layers, batch, window + 1, heads, head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    @staticmethod
    def update(cache: dict, layer: int, pos: int, k_t: torch.Tensor,
               v_t: torch.Tensor) -> dict:
        """Write step ``pos``'s K/V ([B, H, D]) into layer ``layer``'s slot."""
        slot = 0 if pos == 0 else 1 + (pos - 1) % (cache["k"].shape[2] - 1)
        cache["k"][layer, :, slot] = k_t
        cache["v"][layer, :, slot] = v_t
        return cache

    @staticmethod
    def attend_bias(window: int, pos: int, device=None) -> torch.Tensor:
        """[window + 1] bias: slot 0 always visible, ring slot s once it
        holds a position, i.e. s ≤ pos."""
        s = torch.arange(window + 1, device=device)
        return torch.where((s == 0) | (s <= pos), 0.0, NEG_INF)


class SeedForMaskedLM(nn.Module):
    """SEED pretraining model: the MLM head over the encoder and an
    autoregressive decoder conditioned only on the CLS bottleneck. In
    ``train()`` mode ``generator`` feeds the encoder's and the decoder's
    dropout."""

    def __init__(self, encoder_config: EncoderConfig,
                 decoder_config: SeedDecoderConfig):
        super().__init__()
        self.encoder_config = ecfg = encoder_config
        self.decoder_config = dcfg = decoder_config
        C = ecfg.hidden_size
        self.roberta = TransformerEncoder(ecfg)
        n_pos = dcfg.max_positions + ecfg.pad_token_id + 1
        decoder = dict(
            layers=nn.ModuleList(SeedDecoderLayer(dcfg)
                                 for _ in range(dcfg.num_layers)),
            layernorm_embedding=nn.LayerNorm(C, eps=dcfg.layer_norm_eps),
            layer_norm=nn.LayerNorm(C, eps=dcfg.layer_norm_eps))
        if dcfg.learned_pos:
            decoder["embed_positions"] = nn.Embedding(n_pos, C)
        self.decoder = _Holder(**decoder)
        if not dcfg.learned_pos:
            self.register_buffer("sinusoidal", sinusoidal_positions(
                n_pos, C, padding_idx=ecfg.pad_token_id), persistent=False)
        self.lm_head = _Holder(dense=nn.Linear(C, C),
                               layer_norm=nn.LayerNorm(C, eps=1e-5))
        self.lm_head.bias = nn.Parameter(torch.zeros(ecfg.vocab_size))

    @property
    def _table(self) -> torch.Tensor:
        return self.roberta.embeddings.word_embeddings.weight

    def _positions(self, ids: torch.Tensor) -> torch.Tensor:
        if self.decoder_config.learned_pos:
            return self.decoder.embed_positions(ids)
        return self.sinusoidal[ids]

    def lm_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """RobertaLMHead: dense → gelu → LayerNorm → the tied embedding
        table, plus ``lm_head.bias``."""
        h = self.lm_head.layer_norm(F.gelu(self.lm_head.dense(hidden)))
        return h @ self._table.T + self.lm_head.bias

    def _decode(self, x, memory, generator=None):
        """Decoder stack from the embedded tokens to the bias-free tied
        output projection (share_decoder_input_output_embed)."""
        dcfg = self.decoder_config
        x = dropout(self.decoder.layernorm_embedding(x), dcfg.dropout,
                    generator)
        bias = windowed_causal_bias(x.shape[1], dcfg.attention_window,
                                    x.device)
        for layer in self.decoder.layers:
            x = layer(x, memory, bias, generator)
        return self.decoder.layer_norm(x) @ self._table.T

    def forward(self, src_tokens, attention_mask, prev_tokens,
                generator=None):
        """(mlm_logits [B, S, V], decoder_logits [B, T, V]), fp32."""
        if not self.training:
            generator = None
        hidden = self.roberta(src_tokens, attention_mask,
                              generator=generator).to(torch.float32)
        mlm_logits = self.lm_logits(hidden)
        memory = hidden[:, 0:1]  # the CLS bottleneck
        pad = self.encoder_config.pad_token_id
        mask = (prev_tokens != pad).to(torch.int64)
        positions = torch.cumsum(mask, dim=1) * mask + pad
        x = self._table[prev_tokens] + self._positions(positions)
        return mlm_logits, self._decode(x, memory, generator)

    def encode_memory(self, src_tokens, attention_mask) -> torch.Tensor:
        """The encoder's CLS state [B, 1, C] in fp32 (no dropout)."""
        hidden = self.roberta(src_tokens, attention_mask)
        return hidden[:, 0:1].to(torch.float32)

    def decode_step(self, token, pos: int, memory, cache: dict):
        """Next-token logits [B, V] for token ids ``token`` [B] at 0-based
        position ``pos``: column ``pos`` of the teacher-forced decoder
        logits, provided the decoded prefix holds no pad id (positions
        here count ``pos + 1 + pad`` unconditionally)."""
        pad = self.encoder_config.pad_token_id
        positions = torch.full((token.shape[0], 1), pos + 1 + pad,
                               device=token.device)
        x = self._table[token][:, None, :] + self._positions(positions)
        x = self.decoder.layernorm_embedding(x)
        for i, layer in enumerate(self.decoder.layers):
            x = layer.step(x, memory, cache, i, pos)
        return self.decoder.layer_norm(x)[:, 0] @ self._table.T


@torch.no_grad()
def greedy_decode(model: SeedForMaskedLM, src_tokens: torch.Tensor,
                  attention_mask: torch.Tensor, steps: int,
                  bos_token: int = 0) -> torch.Tensor:
    """Greedy generation from the CLS bottleneck: [B, steps] token ids,
    one :meth:`SeedForMaskedLM.decode_step` a position over the O(window)
    cache. Runs the model in ``eval()`` mode."""
    model.eval()
    dcfg = model.decoder_config
    memory = model.encode_memory(src_tokens, attention_mask)
    B = src_tokens.shape[0]
    cache = DecodeCache.init(dcfg.num_layers, B, dcfg.attention_window,
                             dcfg.num_heads, dcfg.hidden_size // dcfg.num_heads,
                             device=src_tokens.device)
    tok = torch.full((B,), bos_token, dtype=torch.int64,
                     device=src_tokens.device)
    out = []
    for pos in range(steps):
        tok = torch.argmax(model.decode_step(tok, pos, memory, cache), dim=-1)
        out.append(tok)
    return torch.stack(out, dim=1)

