"""The ANCE trainer job (counterpart of ``ance_tpu/train/ance_loop.py``'s
``run_trainer_job``; the reference's run_ann.py:180-334).

The trainer and the negative generator are two jobs that talk through the
file system: the generator writes ``ann_training_data_<n>`` and then
``ann_ndcg_<n>`` (the ready signal) into the ann directory; the trainer
polls for the newest ready file, trains on its triples, and writes
``checkpoint-<step>/`` directories, which the generator reads. Both file
formats are the JAX package's, so either package's generator and trainer
can pair. The generator job, ``run_ance_cycles`` and the pipelined loop
wait for ROADMAP Queue 1 #4-#5.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Callable, Mapping, Optional

import torch

from ance_tpu_torch.data.cache import TokenCache
from ance_tpu_torch.data.feed import (TripletBatches, expand_triples,
                                      infinite_batches)
from ance_tpu_torch.optim.schedules import reset_rewarmup
from ance_tpu_torch.train import checkpoint as ckpt

logger = logging.getLogger(__name__)

ANN_DATA_PREFIX = "ann_training_data_"
ANN_NDCG_PREFIX = "ann_ndcg_"


def get_latest_ann_data(ann_dir: str
                        ) -> tuple[int, Optional[str], Optional[dict]]:
    """Newest (data_no, training_data_path, ndcg_json), or (−1, None, None)
    (reference utils/util.py:229-243: the ndcg file is the ready signal)."""
    if not os.path.isdir(ann_dir):
        return -1, None, None
    nums = []
    for name in next(os.walk(ann_dir))[2]:
        if name.startswith(ANN_NDCG_PREFIX):
            try:
                nums.append(int(name[len(ANN_NDCG_PREFIX):]))
            except ValueError:
                continue
    if not nums:
        return -1, None, None
    n = max(nums)
    with open(os.path.join(ann_dir, ANN_NDCG_PREFIX + str(n))) as f:
        ndcg_json = json.load(f)
    return n, os.path.join(ann_dir, ANN_DATA_PREFIX + str(n)), ndcg_json


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
    batch_size: int = 32
    shuffle_seed: int = 42
    feed_workers: int = 8  # gather threads; 0 = serial gathers


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
