"""The training step of the dual-encoder NLL objectives (counterpart of
``ance_tpu/train/trainer.py``; the reference trainer's inner loop,
drivers/run_ann.py:240-334):

  * three encoder passes (query, positive, negative; or positive and
    negative as one pass with ``fused_body``) and the NLL triplet loss, or
    the MaxP multi-chunk loss;
  * gradient accumulation over micro-batches: losses and gradients summed,
    then divided by their number;
  * global-norm gradient clipping, then LAMB or AdamW under a schedule.

Parameters live in the model and update in place; the step makes no host
round trip but the loss it hands back. Dropout draws from one device
``torch.Generator`` per encoder pass, each seeded from the step's host
generator, as the JAX step splits its key three ways. The TPU's
hardware-RNG switch (``fast_dropout_key``) has no counterpart here.

On a mesh (:class:`ance_tpu_torch.core.mesh.DataMesh`) each rank steps on
its own rows of the global batch, and the gradients are all-reduced to
their mean over the ranks before the clip (which reads the global norm) and
the optimizer, so every rank applies the same update and the parameters
stay bit-equal; the loss reported is the global mean. Each rank draws its
dropout from a generator of its own (``DataMesh.rank_generator``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch
from torch import nn

from ance_tpu_torch.models import losses
from ance_tpu_torch.optim.lamb import (ReferenceLamb,
                                       bias_layernorm_no_decay_mask)
from ance_tpu_torch.optim.schedules import RewarmupSchedule, constant

Schedule = Callable[[int], float]


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every entry (``optax.global_norm``)."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


class Optimizer:
    """Global-norm clipping, then LAMB or AdamW at the schedule's rate for
    the current step count (counted before the increment)."""

    def __init__(self, inner: torch.optim.Optimizer, schedule: Schedule,
                 max_grad_norm: float):
        self.inner = inner
        self.schedule = schedule
        self.max_grad_norm = max_grad_norm
        self.count = 0

    @property
    def params(self) -> list[torch.Tensor]:
        return [p for g in self.inner.param_groups for p in g["params"]]

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Apply the gradients in ``p.grad``; returns their global norm
        before clipping. ``optax.clip_by_global_norm``: g / norm · max where
        the norm exceeds max."""
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = global_norm(grads)
        if self.max_grad_norm and self.max_grad_norm > 0:
            clip = norm >= self.max_grad_norm
            for g in grads:
                g.copy_(torch.where(clip, g / norm * self.max_grad_norm, g))
        lr = self.schedule(self.count)
        for group in self.inner.param_groups:
            group["lr"] = lr
        self.inner.step()
        self.count += 1
        return norm

    def state_dict(self) -> dict:
        state = {"inner": self.inner.state_dict(), "count": self.count}
        if isinstance(self.schedule, RewarmupSchedule):
            state["rewarmup"] = {"anchor": self.schedule.anchor,
                                 "horizon": self.schedule.horizon}
        return state

    def load_state_dict(self, state: dict) -> None:
        self.inner.load_state_dict(state["inner"])
        self.count = int(state["count"])
        if "rewarmup" in state:
            self.schedule.anchor = int(state["rewarmup"]["anchor"])
            self.schedule.horizon = float(state["rewarmup"]["horizon"])


def make_optimizer(model: nn.Module, name: str = "lamb",
                   learning_rate: Union[float, Schedule] = 1e-4,
                   eps: float = 1e-8, weight_decay: float = 0.0,
                   max_grad_norm: float = 1.0,
                   no_decay_bias_ln: bool = True,
                   rewarmup: Optional[tuple] = None) -> Optimizer:
    """The reference optimizer menu (run_ann.py:79-93), ``lamb`` or
    ``adamw``, after global-norm clipping. With weight decay, biases and
    LayerNorms skip it (the no-decay grouping). ``rewarmup=(warmup_steps,
    initial_horizon)`` takes a float base ``learning_rate`` and builds the
    per-dataset :class:`RewarmupSchedule`."""
    named = list(model.named_parameters())
    decays = bias_layernorm_no_decay_mask(named) \
        if (no_decay_bias_ln and weight_decay) else {n: True for n, _ in named}
    groups = [{"params": [p for n, p in named if decays[n]],
               "weight_decay": weight_decay},
              {"params": [p for n, p in named if not decays[n]],
               "weight_decay": 0.0}]
    groups = [g for g in groups if g["params"]]
    if rewarmup is not None:
        if callable(learning_rate):
            raise ValueError("rewarmup needs a float base learning_rate "
                             "(the schedule is RewarmupSchedule's)")
        warmup_steps, initial_horizon = rewarmup
        schedule = RewarmupSchedule(learning_rate, warmup_steps,
                                    float(initial_horizon))
    elif callable(learning_rate):
        schedule = learning_rate
    else:
        schedule = constant(learning_rate)
    if name.lower() == "lamb":
        inner = ReferenceLamb(groups, lr=0.0, eps=eps)
    elif name.lower() == "adamw":
        inner = torch.optim.AdamW(groups, lr=0.0, eps=eps)
    else:
        raise ValueError(f"optimizer {name} not recognized! lamb or adamw")
    return Optimizer(inner, schedule, max_grad_norm)


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: Optimizer


def init_train_state(model: nn.Module, optimizer: Optimizer) -> TrainState:
    return TrainState(step=0, model=model, optimizer=optimizer)


def split_generator(generator: torch.Generator, n: int,
                    device: torch.device) -> list[torch.Generator]:
    """``n`` fresh generators on ``device``, seeded from draws of the host
    generator ``generator`` (``jax.random.split``'s place)."""
    seeds = torch.randint(0, 2 ** 62, (n,), generator=generator)
    return [torch.Generator(device=device).manual_seed(int(s))
            for s in seeds]


def triplet_loss_fn(multichunk: bool = False,
                    fused_body: bool = False) -> Callable:
    """loss(model, batch, generator) for FirstP (NLL) or MaxP
    (NLL_MultiChunk) training; ``batch`` holds tensors on the model's
    device, ``generator`` is the host generator the passes' generators
    are split from.

    ``fused_body`` encodes positives and negatives as one [2B, S] pass:
    every encoder op is row-independent, so it equals two passes without
    dropout, and with dropout each entry still draws its own mask."""

    def loss_fn(model, batch, generator):
        device = batch["query_ids"].device
        q_gen, pos_gen, neg_gen = split_generator(generator, 3, device)
        q = model.query_emb(batch["query_ids"], batch["query_mask"], q_gen)
        body = model.body_emb_multichunk if multichunk else model.body_emb
        if fused_body:
            B = batch["pos_ids"].shape[0]
            both = body(torch.cat([batch["pos_ids"], batch["neg_ids"]]),
                        torch.cat([batch["pos_mask"], batch["neg_mask"]]),
                        pos_gen)
            pos, neg = both[:B], both[B:]
        else:
            pos = body(batch["pos_ids"], batch["pos_mask"], pos_gen)
            neg = body(batch["neg_ids"], batch["neg_mask"], neg_gen)
        if multichunk:
            return losses.nll_multichunk_loss(q, pos, batch["pos_mask"],
                                              neg, batch["neg_mask"])
        return losses.nll_triplet_loss(q, pos, neg)

    return loss_fn


def batch_to_device(batch: dict, device: torch.device) -> dict:
    """numpy token arrays → int64 tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device, torch.int64, non_blocking=True)
            for k, v in batch.items()}


def make_train_step(loss_fn: Callable, accum_steps: int = 1,
                    mesh=None) -> Callable:
    """(state, batch, generator) → (state, metrics {"loss", "grad_norm"}
    as device scalars). With ``accum_steps > 1`` the batch's leading dim
    splits into that many micro-batches run one after another; losses and
    gradients are summed and divided by ``accum_steps`` (the reference's
    loss / accum, run_ann.py:263-268). On a ``mesh`` the batch is this
    rank's rows, and the gradients and the loss are averaged over the
    ranks (module docstring)."""

    def step(state: TrainState, batch: dict, generator: torch.Generator):
        model = state.model
        device = next(model.parameters()).device
        batch = batch_to_device(batch, device)
        model.train()
        for p in model.parameters():
            p.grad = None
        if mesh is not None and mesh.world > 1:
            generator = mesh.rank_generator(generator)
        n = next(iter(batch.values())).shape[0]
        if n % accum_steps:
            raise ValueError(f"batch {n} does not split into {accum_steps} "
                             "micro-batches")
        m = n // accum_steps
        loss = torch.zeros((), dtype=torch.float32, device=device)
        for i in range(accum_steps):
            micro = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            micro_loss = loss_fn(model, micro, generator)
            micro_loss.backward()
            loss = loss + micro_loss.detach()
        if accum_steps > 1:
            loss = loss / accum_steps
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.div_(accum_steps)
        if mesh is not None:
            mesh.all_reduce_grads_(
                [p.grad for p in model.parameters() if p.grad is not None],
                "mean")
            loss = mesh.all_reduce_(loss, "mean")
        grad_norm = state.optimizer.step()
        state.step += 1
        return state, {"loss": loss, "grad_norm": grad_norm}

    return step
