"""The ANCE loop (counterpart of ``ance_tpu/train/ance_loop.py``; the
reference's run_ann.py and run_ann_data_gen.py), on one device.

  1. :func:`run_trainer_job` / :func:`run_generator_job` — the two jobs of
     the reference, talking through the file system: the generator writes
     ``ann_training_data_<n>`` and then ``ann_ndcg_<n>`` (the ready signal);
     the trainer polls for the newest ready file, trains on its triples and
     writes ``checkpoint-<step>/`` directories, which the generator polls
     for. Both file formats are the JAX package's, so either package's
     generator and trainer can pair.
  2. :func:`run_ance_cycles` — one program alternating generate → train →
     checkpoint, the generator always encoding with the freshest weights.

The pipelined refresh waits for ROADMAP Queue 1 #5.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Mapping, Optional

import numpy as np
import torch

from ance_tpu_torch.data.cache import TokenCache
from ance_tpu_torch.data.feed import (TripletBatches, expand_triples,
                                      infinite_batches)
from ance_tpu_torch.optim.schedules import reset_rewarmup
from ance_tpu_torch.train import checkpoint as ckpt
from ance_tpu_torch.train.ann_gen import (  # noqa: F401  (re-exported)
    ANN_DATA_PREFIX, ANN_NDCG_PREFIX, AnnGenConfig, generate_new_ann,
    get_latest_ann_data)

logger = logging.getLogger(__name__)


def load_offset_qrels(path: str) -> dict[int, dict[int, int]]:
    """Offset-space qrels ``qoffset\\tpoffset\\trel`` written by
    preprocessing (reference data/msmarco_data.py:101-123)."""
    out: dict[int, dict[int, int]] = {}
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            q, p, rel = line.rstrip("\n").split("\t")
            out.setdefault(int(q), {})[int(p)] = int(rel)
    return out


def positives_from_qrels(qrels: Mapping[int, Mapping[int, int]]
                         ) -> dict[int, int]:
    """qid → its single positive pid (the reference keeps one positive per
    train query, run_ann_data_gen.py:74-101)."""
    return {qid: next(iter(rels)) for qid, rels in qrels.items() if rels}


@dataclasses.dataclass
class AnceCycleConfig:
    steps_per_cycle: int = 100
    batch_size: int = 32
    num_cycles: int = 3
    shuffle_seed: int = 42
    checkpoint_dir: Optional[str] = None
    feed_workers: int = 8  # gather threads; 0 = serial gathers


def run_ance_cycles(cycle_cfg: AnceCycleConfig, gen_cfg: AnnGenConfig, *,
                    state, train_step: Callable,
                    generator: torch.Generator,
                    query_encode_fn, body_encode_fn,
                    dev_query_cache: TokenCache, passage_cache: TokenCache,
                    train_query_cache: TokenCache,
                    train_qrels: Mapping[int, Mapping[int, int]],
                    dev_qrels: Mapping[int, Mapping[int, int]],
                    output_dir: str, device) -> tuple[object, list[dict]]:
    """Generate → train alternation in one program, ``num_cycles`` times.
    Returns (state, history).

    The encode functions close over ``state.model``, which the steps train
    in place, so every generation encodes with the freshest weights (the
    JAX function's ``params_of(state)``); the train steps draw their
    dropout from ``generator``. With ``checkpoint_dir`` the model is saved
    after each cycle."""
    training_positive = positives_from_qrels(train_qrels)
    history = []
    for cycle in range(cycle_cfg.num_cycles):
        state.model.eval()
        result = generate_new_ann(
            gen_cfg, output_num=cycle, checkpoint_path=f"cycle-{cycle}",
            query_encode_fn=query_encode_fn, body_encode_fn=body_encode_fn,
            dev_query_cache=dev_query_cache, passage_cache=passage_cache,
            train_query_cache=train_query_cache,
            training_query_positive_id=training_positive,
            dev_query_positive_id=dev_qrels, output_dir=output_dir,
            device=device)
        with open(result["data_path"]) as f:
            lines = f.read().splitlines()
        feed = TripletBatches(train_query_cache, passage_cache,
                              expand_triples(lines),
                              batch_size=cycle_cfg.batch_size,
                              seed=cycle_cfg.shuffle_seed + cycle)
        it = infinite_batches(feed, workers=cycle_cfg.feed_workers)
        losses = []
        for _ in range(cycle_cfg.steps_per_cycle):
            state, metrics = train_step(state, next(it), generator)
            losses.append(float(metrics["loss"]))
        entry = {"cycle": cycle, "dev_ndcg": result["dev_ndcg"],
                 "ann_mrr": result["ann_mrr"],
                 "mean_loss": float(np.mean(losses)),
                 "data_path": result["data_path"]}
        logger.info("ANCE cycle %s: %s", cycle, entry)
        history.append(entry)
        if cycle_cfg.checkpoint_dir:
            ckpt.save_checkpoint(cycle_cfg.checkpoint_dir, state.step,
                                 state.model, extra={"cycle": cycle})
    return state, history


def run_generator_job(gen_cfg: AnnGenConfig, *, training_dir: str,
                      load_params: Callable[[str], object],
                      query_encode_fn, body_encode_fn,
                      dev_query_cache: TokenCache, passage_cache: TokenCache,
                      train_query_cache: TokenCache,
                      train_qrels: Mapping[int, Mapping[int, int]],
                      dev_qrels: Mapping[int, Mapping[int, int]],
                      output_dir: str, device,
                      poll_interval: float = 60.0,
                      max_iterations: Optional[int] = None) -> list[dict]:
    """Poll ``training_dir`` for new complete checkpoints and generate on
    each (reference run_ann_data_gen.py:663-702, its 60 s sleep loop).

    The first pass always generates: from the newest checkpoint, or, when
    there is none, with the weights the encoders' model holds (the JAX
    function's ``init_params``, the reference's init_model_dir).
    ``load_params(path)`` loads a checkpoint into that model in place.
    Outputs are numbered on from the newest ann data in ``output_dir``."""
    training_positive = positives_from_qrels(train_qrels)
    last_checkpoint = object()  # sentinel: the first pass always generates
    output_num, _, _ = get_latest_ann_data(output_dir)
    output_num += 1
    history = []
    iteration = 0
    while max_iterations is None or iteration < max_iterations:
        iteration += 1
        ckpt_path, _ = ckpt.get_latest_checkpoint(training_dir)
        if ckpt_path == last_checkpoint:
            time.sleep(poll_interval)
            continue
        if ckpt_path is not None:
            load_params(ckpt_path)
        result = generate_new_ann(
            gen_cfg, output_num=output_num,
            checkpoint_path=ckpt_path or "<init>",
            query_encode_fn=query_encode_fn, body_encode_fn=body_encode_fn,
            dev_query_cache=dev_query_cache, passage_cache=passage_cache,
            train_query_cache=train_query_cache,
            training_query_positive_id=training_positive,
            dev_query_positive_id=dev_qrels, output_dir=output_dir,
            device=device)
        for key in ("index", "passage_embedding2id", "train_query_embedding",
                    "train_neighbor_ids"):
            result.pop(key, None)
        result["checkpoint"] = ckpt_path
        history.append(result)
        last_checkpoint = ckpt_path
        output_num += 1
    return history


def run_trainer_job(cycle_cfg: AnceCycleConfig, *, state,
                    train_step: Callable, generator: torch.Generator,
                    query_cache: TokenCache, passage_cache: TokenCache,
                    ann_dir: str, training_dir: str, max_steps: int,
                    poll_every: int = 100, save_every: int = 500,
                    poll_interval: float = 5.0,
                    rewarmup_per_dataset: bool = False,
                    on_step: Optional[Callable] = None):
    """Train until ``max_steps``, polling ``ann_dir`` for newer data every
    ``poll_every`` steps and writing a checkpoint (parameters and
    optimizer state) every ``save_every`` steps and at the end.

    ``rewarmup_per_dataset`` re-anchors the optimizer's
    :class:`RewarmupSchedule` at every data swap, with the new file's line
    count as the decay horizon (the reference's default without
    ``--single_warmup``). ``on_step(step, metrics)`` sees every step's
    metrics. Returns the state."""
    last_data_no = -1
    it = None
    while state.step < max_steps:
        if it is None or state.step % poll_every == 0:
            data_no, data_path, _ = get_latest_ann_data(ann_dir)
            if data_no > last_data_no and data_path:
                with open(data_path) as f:
                    lines = f.read().splitlines()
                feed = TripletBatches(query_cache, passage_cache,
                                      expand_triples(lines),
                                      batch_size=cycle_cfg.batch_size,
                                      seed=cycle_cfg.shuffle_seed + data_no)
                it = infinite_batches(feed, workers=cycle_cfg.feed_workers)
                last_data_no = data_no
                if rewarmup_per_dataset:
                    reset_rewarmup(state.optimizer.schedule,
                                   state.optimizer.count, len(lines))
                logger.info("trainer: switched to ann data %s", data_no)
            elif it is None:
                time.sleep(poll_interval)
                continue
        state, metrics = train_step(state, next(it), generator)
        if on_step is not None:
            on_step(state.step, metrics)
        if state.step % save_every == 0 or state.step >= max_steps:
            ckpt.save_checkpoint(training_dir, state.step, state.model,
                                 state.optimizer.state_dict())
    return state
