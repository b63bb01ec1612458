"""Retrieval losses (counterpart of ``ance_tpu/models/losses.py``).

* :func:`nll_triplet_loss` — the reference NLL head (FirstP).
* :func:`multichunk_scores` / :func:`nll_multichunk_loss` — NLL_MultiChunk
  (MaxP): the max over chunk dot products, empty chunks biased by −9999.
* :func:`dpr_inbatch_loss` / :func:`dpr_inbatch_multichunk_loss` — DPR's
  in-batch softmax over every query × context score of the batch.
* :func:`masked_lm_loss` / :func:`seed_pretrain_loss` — SEED pretraining:
  the MLM term and the CLS-bottleneck decoder's LM term, weighted.

All in fp32 whatever the encoder's compute dtype (in fp64 for fp64
embeddings, a yardstick's). The JAX losses pin their
matmuls to HIGHEST precision; here TF32 is off at package import, so fp32
products are full fp32 on the card too.
"""

from __future__ import annotations

import torch

EMPTY_CHUNK_BIAS = -9999.0  # reference models.py:109


def _wide(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, torch.float32))


def nll_triplet_loss(q_embs: torch.Tensor, pos_embs: torch.Tensor,
                     neg_embs: torch.Tensor) -> torch.Tensor:
    """Mean over the batch of −log softmax([q·pos, q·neg])[0]."""
    q = _wide(q_embs)
    s_pos = (q * _wide(pos_embs)).sum(-1)
    s_neg = (q * _wide(neg_embs)).sum(-1)
    logits = torch.stack([s_pos, s_neg], dim=1)          # [B, 2]
    return -torch.log_softmax(logits, dim=1)[:, 0].mean()


def multichunk_scores(q_embs: torch.Tensor, chunk_embs: torch.Tensor,
                      attention_mask: torch.Tensor) -> torch.Tensor:
    """MaxP score [B]: the max over chunk dot products, a chunk whose first
    token is padding biased by −9999. ``chunk_embs`` [B, C, D];
    ``attention_mask`` [B, C·L]. ``amax`` shares the gradient among tied
    chunks, as ``jnp.max`` does."""
    B, C, _ = chunk_embs.shape
    alive = attention_mask.reshape(B, C, -1)[:, :, 0]
    bias = (1.0 - alive.to(torch.float32)) * EMPTY_CHUNK_BIAS
    scores = torch.einsum("bd,bcd->bc", _wide(q_embs), _wide(chunk_embs))
    return torch.amax(scores + bias, dim=-1)


def nll_multichunk_loss(q_embs: torch.Tensor, pos_chunk_embs: torch.Tensor,
                        pos_mask: torch.Tensor, neg_chunk_embs: torch.Tensor,
                        neg_mask: torch.Tensor) -> torch.Tensor:
    logits = torch.stack(
        [multichunk_scores(q_embs, pos_chunk_embs, pos_mask),
         multichunk_scores(q_embs, neg_chunk_embs, neg_mask)], dim=1)
    return -torch.log_softmax(logits, dim=1)[:, 0].mean()


def _inbatch_nll(scores: torch.Tensor, positive_idx: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean −log softmax of each row's positive column, and the number of
    rows whose argmax is their positive. ``torch.argmax`` takes the first
    of equal maxima, on the CPU and on CUDA, as ``jnp.argmax`` does."""
    lsm = torch.log_softmax(scores, dim=1)
    loss = -lsm.gather(1, positive_idx[:, None]).mean()
    correct = (torch.argmax(scores, dim=1) == positive_idx).sum()
    return loss, correct


def dpr_inbatch_loss(q_embs: torch.Tensor, ctx_embs: torch.Tensor,
                     positive_idx: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """In-batch softmax NLL over the [Q, C] score matrix: ``ctx_embs``
    holds positives and hard negatives interleaved, ``positive_idx`` [Q]
    each query's positive row (2i in the reference layout,
    run_ann_dpr.py:356-363). Returns (mean loss, correct count)."""
    scores = _wide(q_embs) @ _wide(ctx_embs).T
    return _inbatch_nll(scores, positive_idx)


def dpr_inbatch_multichunk_loss(q_embs: torch.Tensor,
                                ctx_chunk_embs: torch.Tensor,
                                ctx_mask: torch.Tensor,
                                positive_idx: torch.Tensor
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`dpr_inbatch_loss` over MaxP documents: score(q, doc) is the
    max over the doc's chunk dot products, a chunk whose first token is
    padding biased by −9999. ``ctx_chunk_embs`` [C, Cn, D]; ``ctx_mask``
    [C, Cn·L]. ``train/dpr_trainer.py``'s step trains with it under
    ``multichunk`` (the MaxP demo's loop, ``experiments/demo_maxp.py``)."""
    C, Cn, _ = ctx_chunk_embs.shape
    alive = ctx_mask.reshape(C, Cn, -1)[:, :, 0]
    bias = (1.0 - alive.to(torch.float32)) * EMPTY_CHUNK_BIAS
    s = torch.einsum("qd,jcd->qjc", _wide(q_embs),
                     _wide(ctx_chunk_embs)) + bias[None]
    return _inbatch_nll(torch.amax(s, dim=-1), positive_idx)


def masked_lm_loss(logits: torch.Tensor, targets: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the positions where ``mask`` is 1 (0 when
    none is), in fp32."""
    lsm = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -lsm.gather(-1, targets.to(torch.int64)[..., None])[..., 0]
    m = mask.to(torch.float32)
    return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)


def seed_pretrain_loss(mlm_logits: torch.Tensor, mlm_targets: torch.Tensor,
                       mlm_mask: torch.Tensor, dec_logits: torch.Tensor,
                       dec_targets: torch.Tensor, dec_mask: torch.Tensor,
                       train_ratio: tuple[float, float] = (0.5, 0.5)
                       ) -> tuple[torch.Tensor, dict]:
    """``train_ratio``-weighted MLM + decoder LM loss (reference
    configuration_seed_encoder.py:92, '0.5:0.5'). Returns (total,
    {"mlm_loss", "decoder_loss"})."""
    mlm = masked_lm_loss(mlm_logits, mlm_targets, mlm_mask)
    dec = masked_lm_loss(dec_logits, dec_targets, dec_mask)
    total = train_ratio[0] * mlm + train_ratio[1] * dec
    return total, {"mlm_loss": mlm, "decoder_loss": dec}
