"""DPR BiEncoder training: the in-batch loss over the whole batch
(counterpart of ``ance_tpu/train/dpr_trainer.py``; the reference's
drivers/run_ann_dpr.py:309-374).

Every query's softmax runs over all 2B contexts of the batch (its own
positive and hard negative and every other query's), positives at even
context rows and hard negatives at odd ones (run_ann_dpr.py:356-363). The
reference gathers the batch over ranks (dpr_utils.py:95-160), and so does
the step on a mesh: the ranks' embeddings, gathered in rank order, make the
global batch, whose one softmax every rank computes.

:func:`make_dpr_train_step` accumulates gradients the GradCache way, so an
accumulated step keeps the global softmax: embeddings of every
micro-batch first (no autograd), one loss over all of them, then each
micro-batch re-encoded with autograd and its rows of the loss's gradient
pulled back into the parameters. The reference's own accumulation
averages per-micro-batch softmaxes, which shrinks the negatives each
query sees.

On a mesh that decomposition is what splits the work over the ranks: each
rank encodes its own rows, the gathered (detached) embeddings give the
global loss, each rank pulls its own rows of the loss's gradient back
through its encode, and the partial gradients are SUMMED over the ranks:
each holds its rows' share of the gradient of the one global loss.
Averaging them, or a backward through an autograd gather, would be off by a
factor of the rank count.
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional

import numpy as np
import torch

from ance_tpu_torch.data.cache import TokenCache
from ance_tpu_torch.data.feed import gather_padded, parse_triple_line
from ance_tpu_torch.models import losses
from ance_tpu_torch.train.trainer import (TrainState, batch_to_device,
                                          split_generator)


def encode_towers(model, batch: dict,
                  generator: Optional[torch.Generator] = None,
                  multichunk: bool = False):
    """Both towers over one batch → (q [B, D], ctx, ctx_mask): ctx[2i] is
    query i's positive, ctx[2i + 1] its negative (run_ann_dpr.py:356-363),
    and ``ctx_mask`` [2B, S] their attention masks in the same order. ctx
    is [2B, D], or with ``multichunk`` the MaxP chunk embeddings [2B, C, D]
    (``body_emb_multichunk``). With ``generator`` (a host generator) each
    tower draws its dropout from a device generator split from it, as the
    JAX function splits its key in two; without one (or in ``eval()``
    mode) nothing is dropped."""
    device = batch["query_ids"].device
    q_gen = ctx_gen = None
    if generator is not None:
        q_gen, ctx_gen = split_generator(generator, 2, device)
    q = model.query_emb(batch["query_ids"], batch["query_mask"], q_gen)
    B = batch["pos_ids"].shape[0]
    ctx_ids = torch.stack([batch["pos_ids"], batch["neg_ids"]],
                          dim=1).reshape(2 * B, -1)
    ctx_mask = torch.stack([batch["pos_mask"], batch["neg_mask"]],
                           dim=1).reshape(2 * B, -1)
    body = model.body_emb_multichunk if multichunk else model.body_emb
    return q, body(ctx_ids, ctx_mask, ctx_gen), ctx_mask


def inbatch_loss_from_embs(q, ctx, ctx_mask=None, multichunk: bool = False):
    """The in-batch loss over gathered embeddings, positives at even
    context rows → (loss, correct count); with ``multichunk`` over MaxP
    chunk embeddings, each document scored by its best live chunk
    (``losses.dpr_inbatch_multichunk_loss``, which reads ``ctx_mask``)."""
    positive_idx = torch.arange(q.shape[0], device=q.device) * 2
    if multichunk:
        return losses.dpr_inbatch_multichunk_loss(q, ctx, ctx_mask,
                                                  positive_idx)
    return losses.dpr_inbatch_loss(q, ctx, positive_idx)


def micro_batch_seeds(generator: torch.Generator, n: int) -> list[int]:
    """One seed a micro-batch, drawn from the step's host generator: the
    accumulated step seeds micro-batch i's dropout generator with
    ``seeds[i]`` in both of its encodes, so the re-encode draws the masks
    of the first."""
    return [int(s) for s in torch.randint(0, 2 ** 62, (n,),
                                          generator=generator)]


def _micro_generator(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def make_dpr_train_step(accum_steps: int = 1, mesh=None,
                        multichunk: bool = False,
                        deterministic: bool = False) -> Callable:
    """(state, batch, generator) → (state, metrics {"loss", "correct",
    "correct_ratio", "grad_norm"}; device scalars): the in-batch loss,
    backward, then the state's optimizer (global-norm clip, LAMB or AdamW).

    ``multichunk`` trains MaxP documents: contexts through
    ``body_emb_multichunk`` and the in-batch loss over each document's best
    live chunk (the JAX step's ``multichunk``). ``deterministic`` drops
    nothing: the encodes get no dropout generator (the JAX step's
    ``deterministic``, its eval path); ``generator`` is then unused (it
    may be None) and no draw is taken from it.

    ``accum_steps > 1`` is the GradCache step
    (``make_dpr_accum_train_step`` in the JAX package), in three phases:

      1. each micro-batch encoded without autograd, its embeddings and its
         context mask kept;
      2. one loss over the gathered embeddings ([B, D] queries and [2B, D]
         contexts, or [2B, C, D] chunk embeddings with the gathered masks),
         and its gradients with respect to the embeddings
         (``torch.autograd.grad`` on leaves);
      3. each micro-batch encoded again with autograd, and its rows of
         those gradients (``dctx[2im:2(i+1)m]``, chunks and all) pulled
         back (``torch.autograd.backward``), accumulating into ``.grad``.

    Its loss, correct count and gradients are the unaccumulated step's on
    the same batch (without dropout, up to fp32 rounding); the activations
    held are one micro-batch's. Micro-batch i draws its dropout from a
    generator seeded with :func:`micro_batch_seeds`' i-th seed in phases 1
    and 3, so the dropout stream differs from the unaccumulated step's.

    On a ``mesh`` the batch is this rank's rows and phase 2 runs on the
    embeddings and masks of every rank's rows, gathered in rank order (the
    JAX step's global batch); with ``accum_steps`` 1 the rank's one encode
    keeps its graph and is pulled back without a re-encode. The gradients
    are summed over the ranks (module docstring); loss, correct count and
    ratio are the global batch's."""

    def encode(model, batch, generator):
        return encode_towers(model, batch,
                             None if deterministic else generator,
                             multichunk)

    def step(state: TrainState, batch: dict, generator: torch.Generator):
        model = state.model
        device = next(model.parameters()).device
        batch = batch_to_device(batch, device)
        model.train()
        for p in model.parameters():
            p.grad = None
        B = batch["query_ids"].shape[0]
        if mesh is not None and mesh.world > 1 and not deterministic:
            generator = mesh.rank_generator(generator)
        if accum_steps <= 1 and mesh is None:
            q, ctx, mask = encode(model, batch, generator)
            loss, correct = inbatch_loss_from_embs(q, ctx, mask, multichunk)
            loss.backward()
        elif accum_steps <= 1:
            q, ctx, mask = encode(model, batch, generator)
            loss, correct, dq, dctx = _global_loss_grads(
                q.detach(), ctx.detach(), mask, mesh, multichunk)
            torch.autograd.backward((q, ctx), grad_tensors=(dq, dctx))
        else:
            if B % accum_steps:
                raise ValueError(f"batch {B} does not split into "
                                 f"{accum_steps} micro-batches")
            m = B // accum_steps
            micro = [{k: v[i * m:(i + 1) * m] for k, v in batch.items()}
                     for i in range(accum_steps)]
            seeds = [0] * accum_steps if deterministic \
                else micro_batch_seeds(generator, accum_steps)
            with torch.no_grad():  # 1. embeddings and masks only
                encoded = [encode(model, mb, _micro_generator(s))
                           for mb, s in zip(micro, seeds)]
            q_all, ctx_all, mask_all = (torch.cat([e[j] for e in encoded])
                                        for j in range(3))
            del encoded
            # 2. one global-softmax loss and its embedding gradients
            loss, correct, dq, dctx = _global_loss_grads(
                q_all, ctx_all, mask_all, mesh, multichunk)
            for i, (mb, s) in enumerate(zip(micro, seeds)):  # 3. pull back
                q, ctx, _ = encode(model, mb, _micro_generator(s))
                torch.autograd.backward(
                    (q, ctx), grad_tensors=(dq[i * m:(i + 1) * m],
                                            dctx[2 * i * m:2 * (i + 1) * m]))
        if mesh is not None:
            mesh.all_reduce_grads_(
                [p.grad for p in model.parameters() if p.grad is not None],
                "sum")
            B *= mesh.world
        grad_norm = state.optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach(), "correct": correct,
                       "correct_ratio": correct / B, "grad_norm": grad_norm}

    return step


def _global_loss_grads(q: torch.Tensor, ctx: torch.Tensor,
                       ctx_mask: torch.Tensor, mesh, multichunk: bool):
    """Phase 2: the in-batch loss over the batch's embeddings (every
    rank's, and every rank's context masks, gathered in rank order, on a
    mesh) and its gradients with respect to THIS rank's rows of them →
    (loss, correct, dq, dctx)."""
    q_all, ctx_all, mask_all = q, ctx, ctx_mask
    if mesh is not None:
        q_all, ctx_all = mesh.gather_rows(q), mesh.gather_rows(ctx)
        mask_all = mesh.gather_rows(ctx_mask)
    q_all = q_all.detach().requires_grad_()
    ctx_all = ctx_all.detach().requires_grad_()
    loss, correct = inbatch_loss_from_embs(q_all, ctx_all, mask_all,
                                           multichunk)
    dq, dctx = torch.autograd.grad(loss, (q_all, ctx_all))
    if mesh is not None:
        B = q.shape[0]
        dq = dq[mesh.rank * B:(mesh.rank + 1) * B]
        dctx = dctx[2 * mesh.rank * B:2 * (mesh.rank + 1) * B]
    return loss.detach(), correct, dq, dctx


def dpr_dev_batches(query_cache: TokenCache, passage_cache: TokenCache,
                    dev_data_path: str, batch_size: int) -> Iterator[dict]:
    """Dev triples in batches, the incomplete tail dropped. Each line's
    FIRST hard negative: the reference dev loader does not shuffle
    (run_ann_dpr.py:276-281)."""
    rows = []
    with open(dev_data_path, encoding="utf-8") as f:
        for line in f:
            if not line.strip():
                continue
            qid, pos, negs = parse_triple_line(line)
            rows.append((qid, pos, negs[0]))
    rows = np.asarray(rows, dtype=np.int64).reshape(-1, 3)
    for s in range(0, rows.shape[0] - batch_size + 1, batch_size):
        r = rows[s:s + batch_size]
        q_ids, q_mask = gather_padded(query_cache, r[:, 0])
        p_ids, p_mask = gather_padded(passage_cache, r[:, 1])
        n_ids, n_mask = gather_padded(passage_cache, r[:, 2])
        yield {"query_ids": q_ids, "query_mask": q_mask,
               "pos_ids": p_ids, "pos_mask": p_mask,
               "neg_ids": n_ids, "neg_mask": n_mask}


def evaluate_dev(model, query_cache: TokenCache, passage_cache: TokenCache,
                 dev_data_path: str, batch_size: int = 32
                 ) -> tuple[float, float]:
    """Dev in-batch NLL (the mean over batches) and correct ratio, dropout
    off (reference run_ann_dpr.py:266-306 under ``model.eval()``). Leaves
    the model in ``eval()`` mode."""
    device = next(model.parameters()).device
    model.eval()
    total_loss, total_correct, n_batches, n_q = 0.0, 0, 0, 0
    with torch.inference_mode():
        for batch in dpr_dev_batches(query_cache, passage_cache,
                                     dev_data_path, batch_size):
            q, ctx, _ = encode_towers(model, batch_to_device(batch, device))
            loss, correct = inbatch_loss_from_embs(q, ctx)
            total_loss += float(loss)
            total_correct += int(correct)
            n_batches += 1
            n_q += batch["query_ids"].shape[0]
    if n_batches == 0:
        return 0.0, 0.0
    return total_loss / n_batches, total_correct / n_q


def run_dpr_epochs(*, state: TrainState, train_step: Callable,
                   generator: torch.Generator, query_cache: TokenCache,
                   passage_cache: TokenCache, train_data_path: str,
                   num_epochs: int, batch_size: int, shuffle_seed: int = 42,
                   dev_eval_fn: Optional[Callable] = None,
                   checkpoint_dir: Optional[str] = None, mesh=None):
    """Fixed-epoch DPR training, the reference's ``--num_epoch`` mode
    (run_ann_dpr.py:179-211): each epoch draws one hard negative a line
    afresh (``sample_one_neg_triples``, seed ``shuffle_seed + epoch``) and
    reshuffles the triples, trains on every whole batch, then evaluates
    ``dev_eval_fn(model)`` → (dev NLL, correct ratio) and saves a
    checkpoint (parameters and optimizer). The train steps draw their
    dropout from ``generator``. Returns (state, history).

    On a ``mesh`` (``train_step`` the mesh's step) rank r trains on its
    stripe of each epoch's triples, every rank takes as many batches as
    the shortest stripe holds (one more on some rank would wait forever in
    the step's collectives), and rank 0 alone writes the checkpoints."""
    import itertools

    from ance_tpu_torch.data.feed import TripletBatches, sample_one_neg_triples
    from ance_tpu_torch.train import checkpoint as ckpt

    host_id, num_hosts = (mesh.rank, mesh.world) if mesh else (0, 1)
    with open(train_data_path, encoding="utf-8") as f:
        lines = f.read().splitlines()
    history = []
    for epoch in range(num_epochs):
        triples = sample_one_neg_triples(lines, seed=shuffle_seed + epoch)
        feed = TripletBatches(query_cache, passage_cache, triples,
                              batch_size, seed=shuffle_seed,
                              host_id=host_id, num_hosts=num_hosts)
        n_batches = len(triples) // num_hosts // batch_size
        last_loss = None
        for batch in itertools.islice(feed.epoch_prefetched(epoch),
                                      n_batches):
            state, metrics = train_step(state, batch, generator)
            last_loss = metrics["loss"]
        entry = {"epoch": epoch, "step": state.step}
        if last_loss is not None:
            entry["loss"] = float(last_loss)
        if dev_eval_fn is not None:
            entry["dev_nll"], entry["dev_correct_ratio"] = dev_eval_fn(
                state.model)
        history.append(entry)
        if checkpoint_dir and host_id == 0:
            ckpt.save_checkpoint(checkpoint_dir, state.step, state.model,
                                 state.optimizer.state_dict(),
                                 extra={"epoch": epoch})
    return state, history
