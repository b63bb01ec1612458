"""Dual-encoder models (counterpart of ``ance_tpu/models/dot_models.py``).

:class:`RobertaDot` serves both ``rdot_nll`` (FirstP) and
``rdot_nll_multi_chunk`` (MaxP, :meth:`RobertaDot.body_emb_multichunk`).
DPR's ``BiEncoder`` waits for its own slice (ROADMAP Queue 1).
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
    prefixes (``roberta.*``, ``embeddingHead``, ``norm``). ``base_len`` is
    the MaxP chunk length."""

    def __init__(self, config: EncoderConfig, use_mean: bool = False,
                 out_dim: int = 768, base_len: int = 512):
        super().__init__()
        self.config = config
        self.use_mean = use_mean
        self.base_len = base_len
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

    def body_emb_multichunk(self, input_ids, attention_mask):
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
        hidden = self.roberta(ids, mask)
        emb = self.norm(self.embeddingHead(hidden[:, 0].to(torch.float32)))
        return emb.reshape(B, C, -1)

    def forward(self, input_ids, attention_mask):
        return self._embed(input_ids, attention_mask)
