"""Dual-encoder models (counterpart of ``ance_tpu/models/dot_models.py``).

:class:`RobertaDot` serves both ``rdot_nll`` (FirstP) and
``rdot_nll_multi_chunk`` (MaxP, :meth:`RobertaDot.body_emb_multichunk`);
:class:`BiEncoder` is DPR's two BERT towers (``dpr``).
"""

from __future__ import annotations

import torch
from torch import nn

from ance_tpu_torch.models.transformer import (EncoderConfig,
                                               TransformerEncoder, pool)


def _head_dtype(x: torch.Tensor) -> torch.dtype:
    """The heads' dtype: fp32, or fp64 for an fp64 model (a yardstick)."""
    return torch.promote_types(x.dtype, torch.float32)


class RobertaDot(nn.Module):
    """Shared-tower dual encoder: RoBERTa → CLS (or masked-mean) pooling →
    Dense(out_dim) → LayerNorm, the head in fp32.

    Attribute names are the reference ``RobertaDot_NLL_LN`` state-dict
    prefixes (``roberta.*``, ``embeddingHead``, ``norm``). ``base_len`` is
    the MaxP chunk length. Each method takes an optional ``generator``
    for the encoder's dropout in ``train()`` mode."""

    def __init__(self, config: EncoderConfig, use_mean: bool = False,
                 out_dim: int = 768, base_len: int = 512):
        super().__init__()
        self.config = config
        self.use_mean = use_mean
        self.base_len = base_len
        self.roberta = TransformerEncoder(config)
        self.embeddingHead = nn.Linear(config.hidden_size, out_dim)
        self.norm = nn.LayerNorm(out_dim, eps=1e-5)

    def _embed(self, input_ids, attention_mask, generator=None):
        hidden = self.roberta(input_ids, attention_mask, generator=generator)
        pooled = pool(hidden, attention_mask, self.use_mean)
        return self.norm(self.embeddingHead(pooled.to(_head_dtype(pooled))))

    def query_emb(self, input_ids, attention_mask, generator=None):
        return self._embed(input_ids, attention_mask, generator)

    def body_emb(self, input_ids, attention_mask, generator=None):
        return self._embed(input_ids, attention_mask, generator)

    def body_emb_multichunk(self, input_ids, attention_mask, generator=None):
        """MaxP: [B, C·base_len] → per-chunk embeddings [B, C, out_dim].
        The chunks are independent encoder passes folded into the batch
        ([B·C, base_len]); each is pooled at its first token (CLS), as the
        reference MaxP model always does."""
        B, full_len = input_ids.shape
        if full_len % self.base_len:
            raise ValueError(f"MaxP body length {full_len} is not a multiple "
                             f"of the chunk length {self.base_len}")
        C = full_len // self.base_len
        ids = input_ids.reshape(B * C, self.base_len)
        mask = attention_mask.reshape(B * C, self.base_len)
        hidden = self.roberta(ids, mask, generator=generator)
        cls = hidden[:, 0]
        emb = self.norm(self.embeddingHead(cls.to(_head_dtype(cls))))
        return emb.reshape(B, C, -1)

    def forward(self, input_ids, attention_mask, generator=None):
        return self._embed(input_ids, attention_mask, generator)


class BertTower(TransformerEncoder):
    """One BERT tower pooled at CLS, in fp32 (the reference HFBertEncoder,
    models.py:223-244, returns ``sequence_output[:, 0]``). A
    :class:`TransformerEncoder`, so its parameters carry the bare
    ``BertModel`` key names (``embeddings.*``, ``encoder.layer.N.*``)."""

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                generator=None):
        hidden = super().forward(input_ids, attention_mask, token_type_ids,
                                 generator)
        return hidden[:, 0].to(_head_dtype(hidden))


class BiEncoder(nn.Module):
    """DPR's two-tower encoder with independent parameters (reference
    models.py:247-271): ``question_model`` encodes queries,
    ``ctx_model`` passages. Each state-dict key is a reference
    ``CheckpointState`` ``model_dict`` key (``question_model.embeddings.*``,
    ``ctx_model.encoder.layer.N.*``) but for the towers' poolers, which the
    reference computes and discards."""

    def __init__(self, config: EncoderConfig):
        super().__init__()
        self.config = config
        self.question_model = BertTower(config)
        self.ctx_model = BertTower(config)

    def query_emb(self, input_ids, attention_mask, generator=None):
        return self.question_model(input_ids, attention_mask,
                                   generator=generator)

    def body_emb(self, input_ids, attention_mask, generator=None):
        return self.ctx_model(input_ids, attention_mask, generator=generator)

    def forward(self, query_ids, query_mask, ctx_ids, ctx_mask,
                generator=None):
        """(query embeddings, context embeddings), as the reference
        ``BiEncoder.forward`` returns them (models.py:260-264)."""
        return (self.query_emb(query_ids, query_mask, generator),
                self.body_emb(ctx_ids, ctx_mask, generator))
