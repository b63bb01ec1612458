"""BM25 warmup trainer: epochs straight off the raw triples TSV.

Counterpart of ``ance_tpu/train/warmup.py`` (reference
drivers/run_warmup.py:44-281): each epoch re-opens the triples file and
tokenizes it on the fly (:func:`ance_tpu_torch.data.process_fn.
triple_batches`); checkpoints with the optimizer state every
``save_steps`` and once more, marked final, when the epochs run out; LAMB
trust ratios and an eval every ``eval_every`` steps. A resumed run skips
the batches its checkpoint has trained (reference run_warmup.py:144-163).
With ``num_hosts`` ranks, rank ``host_id`` trains on lines ``host_id``,
``host_id + num_hosts``, ... of the file (the JAX config's striping,
``data/process_fn.py``) through a mesh's train step, every rank takes as
many batches an epoch as the shortest stripe holds, and rank 0 alone
writes the checkpoints. (The JAX CLI's warmup stripes but never assembles
the ranks' rows into one global batch: ROADMAP Queue 3.)

Dropout on resume: the JAX loop splits its key for every batch before the
skip check, so a resumed run draws the masks the uninterrupted one drew.
Here the host generator of the step that brings the count to ``s`` is
:func:`step_generator` of ``(seed, s)``, so a run resumed at step ``s``
trains steps ``s + 1``... with the uninterrupted run's masks.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
from typing import Callable, Optional

import numpy as np
import torch

from ance_tpu_torch.data.process_fn import triple_batches
from ance_tpu_torch.optim.lamb import trust_ratio_summary
from ance_tpu_torch.train import checkpoint as ckpt

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class WarmupConfig:
    num_epochs: int = 1
    batch_size: int = 32
    max_seq_length: int = 128
    max_steps: int = -1              # >0 stops early
    save_steps: int = 0              # 0 = no periodic checkpoints
    eval_every: int = 0              # steps between eval_fn calls; 0 = never
    checkpoint_dir: Optional[str] = None
    host_id: int = 0                 # this rank's stripe of the lines (the
    num_hosts: int = 1               # mesh's rank and world)
    log_trust_ratios: bool = False   # LAMB trust-ratio stats at eval points
                                     # (reference lamb.py:11-22 log_lamb_rs)


def step_generator(seed: int, step: int) -> torch.Generator:
    """The host generator the train step that reaches count ``step``
    draws its dropout from: a function of ``(seed, step)`` alone."""
    state = np.random.SeedSequence((seed, step)).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(state[0]))


def run_warmup(cfg: WarmupConfig, *, state, train_step: Callable,
               tokenizer, triples_path: str, seed: int,
               eval_fn: Optional[Callable] = None, start_step: int = 0):
    """Train over the triples file for ``cfg.num_epochs``; ``train_step``
    is ``train/trainer.py::make_train_step``'s and ``eval_fn(model)``
    returns (reranking MRR, full-ranking MRR). Returns (state, history):
    ``{"step", "loss"}`` a step, ``{"step", "trust_ratio_min", ...}`` and
    ``{"step", "reranking_mrr", "full_ranking_mrr"}`` at eval points."""
    history = []
    global_step = start_step
    if 0 < cfg.max_steps <= start_step:
        # a checkpoint written at max_steps: the run is complete, and one
        # more batch would change the finished model
        return state, history
    skip = start_step
    per_epoch = None  # every batch of one rank's stripe
    if cfg.num_hosts > 1:
        with open(triples_path, encoding="utf-8") as f:
            per_epoch = sum(1 for _ in f) // cfg.num_hosts // cfg.batch_size
    for epoch in range(cfg.num_epochs):
        with open(triples_path, encoding="utf-8") as f:
            for batch in itertools.islice(
                    triple_batches(tokenizer, f, cfg.batch_size,
                                   cfg.max_seq_length, host_id=cfg.host_id,
                                   num_hosts=cfg.num_hosts), per_epoch):
                if skip > 0:
                    skip -= 1
                    continue
                state, metrics = train_step(
                    state, batch, step_generator(seed, global_step + 1))
                global_step += 1
                history.append({"step": global_step,
                                "loss": float(metrics["loss"])})
                if cfg.save_steps and cfg.checkpoint_dir and \
                        cfg.host_id == 0 and \
                        global_step % cfg.save_steps == 0:
                    ckpt.save_checkpoint(cfg.checkpoint_dir, global_step,
                                         state.model,
                                         state.optimizer.state_dict(),
                                         extra={"epoch": epoch})
                at_eval = cfg.eval_every and \
                    global_step % cfg.eval_every == 0
                if cfg.log_trust_ratios and at_eval:
                    summary = trust_ratio_summary(
                        state.optimizer, state.model.named_parameters())
                    if summary:
                        history.append({"step": global_step, **summary})
                if at_eval and eval_fn is not None:
                    rerank_mrr, full_mrr = eval_fn(state.model)
                    logger.info("step %s reranking/full mrr: %s/%s",
                                global_step, rerank_mrr, full_mrr)
                    history.append({"step": global_step,
                                    "reranking_mrr": rerank_mrr,
                                    "full_ranking_mrr": full_mrr})
                if 0 < cfg.max_steps <= global_step:
                    return state, history
    if cfg.checkpoint_dir and cfg.host_id == 0:
        ckpt.save_checkpoint(cfg.checkpoint_dir, global_step, state.model,
                             state.optimizer.state_dict(),
                             extra={"final": True})
    return state, history
