"""SEED-Encoder pretraining: MLM + CLS-bottleneck decoder reconstruction
(counterpart of ``ance_tpu/train/seed_pretrain.py``; the reference ships
pretrained SEED checkpoints but no pretraining code).

  * BERT-style dynamic masking of the encoder input (80% ``<mask>``, 10%
    a random regular token, 10% kept) → the MLM loss on the masked
    positions;
  * a weak windowed decoder that sees the encoder only through CLS,
    teacher-forced to rebuild the row → the LM loss;
  * the two weighted by ``train_ratio`` ('0.5:0.5').

Batches come from a token cache (the ``passages`` cache ``preprocess``
writes). :func:`mask_tokens` and :func:`seed_pretrain_batches` draw from
the JAX package's ``np.random.RandomState`` seeds, so their batches are
byte-identical to its, host by host. The step is ``train/trainer.py``'s
(global-norm clip, LAMB or AdamW under a schedule) over
:class:`~ance_tpu_torch.models.seed.SeedForMaskedLM`, on one device or
data-parallel over the ranks of a mesh.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch

from ance_tpu_torch.data.cache import TokenCache
from ance_tpu_torch.models import losses
from ance_tpu_torch.train.trainer import make_train_step, split_generator

logger = logging.getLogger(__name__)


def mask_tokens(tokens: np.ndarray, lengths: np.ndarray, *,
                mask_token_id: int, vocab_size: int,
                special_ids: Sequence[int], rs: np.random.RandomState,
                mask_prob: float = 0.15,
                first_regular_id: int = 5
                ) -> tuple[np.ndarray, np.ndarray]:
    """BERT-style dynamic masking: select ``mask_prob`` of the non-special
    in-length positions; of those 80% → ``mask_token_id``, 10% → a random
    regular token, 10% unchanged. Returns (masked tokens, mlm_mask), the
    mask 1 at the selected (loss-bearing) positions."""
    B, L = tokens.shape
    in_len = np.arange(L)[None, :] < lengths[:, None]
    special = np.isin(tokens, np.asarray(list(special_ids)))
    candidates = in_len & ~special
    sel = candidates & (rs.random_sample((B, L)) < mask_prob)
    roll = rs.random_sample((B, L))
    masked = tokens.copy()
    masked[sel & (roll < 0.8)] = mask_token_id
    rand_pos = sel & (roll >= 0.8) & (roll < 0.9)
    masked[rand_pos] = rs.randint(first_regular_id, vocab_size,
                                  int(rand_pos.sum()))
    return masked, sel.astype(np.int32)


def seed_pretrain_batches(cache: TokenCache, batch_size: int, *,
                          mask_token_id: int, vocab_size: int,
                          special_ids: Sequence[int], pad_token_id: int = 1,
                          mask_prob: float = 0.15, seed: int = 0,
                          epoch: int = 0, host_id: int = 0,
                          num_hosts: int = 1) -> Iterator[dict]:
    """One epoch of pretraining batches: ``src_tokens`` (masked),
    ``attention_mask``, ``mlm_targets`` / ``mlm_mask``, and the
    teacher-forced decoder stream (``prev_tokens``, the row shifted right
    from its CLS; ``dec_targets``, the row; ``dec_mask``, its real
    positions after the first). As the JAX package's
    (``ance_tpu/train/seed_pretrain.py:62-116``): the shuffle is seeded
    from (seed, epoch) alone, so every host stripes one permutation
    (record ``host_id``, ``host_id + num_hosts``, ...), and only the
    masking draws per host (``seed + 7919·epoch + 104729·host_id``); each
    stripe is cut to ``n // num_hosts`` records, so every host yields the
    same number of batches and none waits at the tail."""
    shuffle_rs = np.random.RandomState(seed + 7919 * epoch)
    rs = np.random.RandomState(seed + 7919 * epoch + 104729 * host_id)
    n = len(cache)
    order = np.arange(n)
    shuffle_rs.shuffle(order)
    order = order[host_id::num_hosts][:n // num_hosts]
    L = cache.embedding_size
    for s in range(0, len(order) - batch_size + 1, batch_size):
        keys = order[s:s + batch_size]
        lengths, tokens = cache.batch(keys)
        tokens = tokens.astype(np.int32)
        in_len = np.arange(L)[None, :] < lengths[:, None]
        tokens = np.where(in_len, tokens, pad_token_id)
        masked, mlm_mask = mask_tokens(
            tokens, lengths, mask_token_id=mask_token_id,
            vocab_size=vocab_size, special_ids=special_ids, rs=rs,
            mask_prob=mask_prob)
        prev = np.roll(tokens, 1, axis=1)
        prev[:, 0] = tokens[:, 0]            # CLS starts the decode
        prev = np.where(in_len, prev, pad_token_id)
        dec_mask = (in_len & (np.arange(L)[None, :] > 0)).astype(np.int32)
        yield {"src_tokens": masked,
               "attention_mask": in_len.astype(np.int32),
               "mlm_targets": tokens, "mlm_mask": mlm_mask,
               "prev_tokens": prev, "dec_targets": tokens,
               "dec_mask": dec_mask}


def _global_share(loss: torch.Tensor, mask: torch.Tensor, mesh
                  ) -> torch.Tensor:
    """``loss``, a mean over this rank's masked positions, rescaled so the
    ranks' mean of it is the mean over every rank's positions (the JAX
    step's loss over its global batch): times world · n_rank / n_all."""
    n = mask.to(torch.float32).sum()
    n_all = mesh.all_reduce_(n.clone(), "sum")
    return loss * (mesh.world * n.clamp_min(1.0) / n_all.clamp_min(1.0))


def make_seed_pretrain_step(train_ratio: tuple[float, float] = (0.5, 0.5),
                            mesh=None) -> Callable:
    """(state, batch, generator) → (state, {"loss", "mlm_loss",
    "decoder_loss", "grad_norm"}): ``train/trainer.py``'s step, whose
    loss is the weighted sum; the model's dropout draws from one device
    generator split from the host ``generator``. The step reports the two
    terms of its batch beside the trainer's metrics. On a ``mesh`` both
    terms are means over the masked positions of every rank's rows, as
    the JAX step takes them over its global batch."""
    terms = {}

    def loss_fn(model, batch, generator):
        (gen,) = split_generator(generator, 1, batch["src_tokens"].device)
        mlm_logits, dec_logits = model(batch["src_tokens"],
                                       batch["attention_mask"],
                                       batch["prev_tokens"], gen)
        mlm = losses.masked_lm_loss(mlm_logits, batch["mlm_targets"],
                                    batch["mlm_mask"])
        dec = losses.masked_lm_loss(dec_logits, batch["dec_targets"],
                                    batch["dec_mask"])
        if mesh is not None:
            mlm = _global_share(mlm, batch["mlm_mask"], mesh)
            dec = _global_share(dec, batch["dec_mask"], mesh)
        terms.update(mlm_loss=mlm.detach(), decoder_loss=dec.detach())
        return train_ratio[0] * mlm + train_ratio[1] * dec

    train_step = make_train_step(loss_fn, mesh=mesh)

    def step(state, batch, generator):
        state, metrics = train_step(state, batch, generator)
        reported = dict(terms)
        if mesh is not None:
            reported = {k: mesh.all_reduce_(v.clone(), "mean")
                        for k, v in reported.items()}
        return state, {**metrics, **reported}

    return step


@dataclasses.dataclass
class SeedPretrainConfig:
    num_epochs: int = 1
    batch_size: int = 32
    mask_prob: float = 0.15
    max_steps: int = -1
    save_steps: int = 0
    log_every: int = 100
    checkpoint_dir: Optional[str] = None
    seed: int = 42
    host_id: int = 0    # this rank's stripe and masking seed (a mesh's
    num_hosts: int = 1  # rank and world; the train step holds the mesh)


def run_seed_pretrain(cfg: SeedPretrainConfig, *, state,
                      train_step: Callable, cache: TokenCache,
                      generator: torch.Generator, mask_token_id: int,
                      vocab_size: int, special_ids: Sequence[int],
                      pad_token_id: int = 1):
    """Epoch loop over the cache with dynamic re-masking; a checkpoint
    every ``save_steps`` and at the end. Returns (state, history of
    {step, loss, mlm_loss, decoder_loss} at step 1 and every
    ``log_every``). With ``cfg.num_hosts`` ranks each draws its stripe
    (:func:`seed_pretrain_batches`) and rank 0 alone writes the
    checkpoints."""
    from ance_tpu_torch.train import checkpoint as ckpt
    history = []
    global_step = 0
    for epoch in range(cfg.num_epochs):
        for batch in seed_pretrain_batches(
                cache, cfg.batch_size, mask_token_id=mask_token_id,
                vocab_size=vocab_size, special_ids=special_ids,
                pad_token_id=pad_token_id, mask_prob=cfg.mask_prob,
                seed=cfg.seed, epoch=epoch, host_id=cfg.host_id,
                num_hosts=cfg.num_hosts):
            state, metrics = train_step(state, batch, generator)
            global_step += 1
            if global_step % cfg.log_every == 0 or global_step == 1:
                entry = {"step": global_step,
                         **{k: float(metrics[k]) for k in
                            ("loss", "mlm_loss", "decoder_loss")}}
                history.append(entry)
                logger.info("seed-pretrain %s", entry)
            if cfg.save_steps and cfg.checkpoint_dir and cfg.host_id == 0 \
                    and global_step % cfg.save_steps == 0:
                ckpt.save_checkpoint(cfg.checkpoint_dir, global_step,
                                     state.model,
                                     state.optimizer.state_dict(),
                                     extra={"epoch": epoch})
            if 0 < cfg.max_steps <= global_step:
                break
        else:
            continue
        break
    if cfg.checkpoint_dir and cfg.host_id == 0:
        ckpt.save_checkpoint(cfg.checkpoint_dir, global_step, state.model,
                             state.optimizer.state_dict(),
                             extra={"final": True})
    return state, history
