"""Dual-encoder models (counterpart of ``ance_tpu/models/dot_models.py``).

Only :class:`RobertaDot` (``rdot_nll``) is ported; MaxP
(``body_emb_multichunk``) waits for the fused attention kernel and DPR's
``BiEncoder`` for its own slice (ROADMAP Queue 1).
"""

from __future__ import annotations

import torch
from torch import nn

from ance_tpu_torch.models.transformer import (EncoderConfig,
                                               TransformerEncoder, pool)


class RobertaDot(nn.Module):
    """Shared-tower dual encoder: RoBERTa → CLS (or masked-mean) pooling →
    Dense(out_dim) → LayerNorm, the head in fp32.

    Attribute names are the reference ``RobertaDot_NLL_LN`` state-dict
    prefixes (``roberta.*``, ``embeddingHead``, ``norm``)."""

    def __init__(self, config: EncoderConfig, use_mean: bool = False,
                 out_dim: int = 768):
        super().__init__()
        self.config = config
        self.use_mean = use_mean
        self.roberta = TransformerEncoder(config)
        self.embeddingHead = nn.Linear(config.hidden_size, out_dim)
        self.norm = nn.LayerNorm(out_dim, eps=1e-5)

    def _embed(self, input_ids, attention_mask):
        hidden = self.roberta(input_ids, attention_mask)
        pooled = pool(hidden, attention_mask, self.use_mean)
        return self.norm(self.embeddingHead(pooled.to(torch.float32)))

    def query_emb(self, input_ids, attention_mask):
        return self._embed(input_ids, attention_mask)

    def body_emb(self, input_ids, attention_mask):
        return self._embed(input_ids, attention_mask)

    def forward(self, input_ids, attention_mask):
        return self._embed(input_ids, attention_mask)
