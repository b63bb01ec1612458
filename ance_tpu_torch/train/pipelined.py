"""Pipelined ANCE: index refresh overlapped with training on one schedule,
on one device or over the ranks of a mesh (counterpart of
``ance_tpu/train/pipelined.py``).

Trainer and index builder are one program:

  * the train steps update ``state.model`` in place every step;
  * all generator work — corpus re-encode, dev-query encode, dev search,
    train-query encode, mining search — is cut into fixed-size work items,
    one item run between every ``train_steps_per_slice`` train steps, so
    the gap between two train steps is about one item, not a whole
    generation;
  * each encoded corpus slice stays on the device and is copied into the
    index buffer in place (``FlatIPIndex.update_slice``);
  * one buffer: every search item of refresh k runs after its last corpus
    slice and before refresh k+1's first, so searches see a complete index.

Work-item tags in ``schedule_trace`` (T = a train step):
  E corpus encode slice → index write        D dev-query encode
  S dev search chunk                          V dev metrics (host)
  Q train-query chunk encode                  M mining search + select
  F finalize: triples, feed swap, new snapshot, seed next cycle

Negatives used at any step come from the previous completed refresh, with
``train_steps_per_slice`` as the staleness/throughput knob.

Where the port differs from the JAX module:

  * **The snapshot is a module.** E, D and Q items (and a
    :class:`ance_tpu_torch.serve.LoopRetriever`) encode with ``snapshot``,
    a deep copy of the model in eval mode without gradients, taken at
    construction and at every F (and on resume), never with the model the
    steps train in place. F replaces it by reference under ``index_lock``;
    nothing is ever copied into a snapshot a server thread may be reading.
    The encode functions ``qfn`` / ``bfn`` are rebuilt over each snapshot
    from the unbound methods the loop is given.
  * **The lock guards Python references.** ``update_slice`` copies into one
    buffer in place, ``set_scales`` rebinds the scales; every device
    operation of the loop and of a server runs on the device's default
    stream, whose order puts each slice write before or after each search.
    ``index_lock`` covers the writes' and the snapshot swap's host side
    against a server's read of ``index`` and ``qfn``.
  * **No sync a step.** Each step's loss stays a device tensor; they are
    stacked once at F. On the card an item's time (``item_times``) is read
    after a device synchronize before and after it, so it is the item's own
    device time, not its enqueue.

On a mesh (:class:`ance_tpu_torch.core.mesh.DataMesh`, one process a card)
the loop is replicated, as the JAX package's multi-host loop: every rank
runs every work item in the same order, encoding its block of each encode
batch (``encode_batch_size`` is the global batch) and gathering the rest,
so the row-sharded index, the dev search and the mining give the same
answer on every rank; each rank trains on its stripe of the mined triples
(``batch_size`` rows a rank) through the mesh's train step; rank 0 alone
writes checkpoints.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import functools
import json
import logging
import os
import random
import threading
import time
from typing import Callable, Mapping, Optional

import numpy as np
import torch

from ance_tpu_torch.data.cache import TokenCache
from ance_tpu_torch.data.feed import TripletBatches, infinite_batches
from ance_tpu_torch.evaluation.metrics import (dedup_ranking, eval_dev_ndcg,
                                               recall_at_k)
from ance_tpu_torch.index.flat import FlatIPIndex
from ance_tpu_torch.optim.schedules import reset_rewarmup
from ance_tpu_torch.train import checkpoint as ckpt
from ance_tpu_torch.train.ann_gen import mine_negatives, query_chunk_range
from ance_tpu_torch.train.encode import (encode_cache_to_device,
                                         make_encode_fn, synced_clock)

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class PipelineConfig:
    train_steps_per_slice: int = 8     # staleness/throughput knob
    encode_slice_size: int = 4096      # corpus records per encode slice
    encode_batch_size: int = 128
    batch_size: int = 32
    topk_training: int = 500
    negative_sample: int = 5
    ann_chunk_factor: int = 5
    ann_measure_topk_mrr: bool = False
    dev_search_depth: int = 100
    search_chunk_queries: int = 4096   # queries per search work item
    multichunk: bool = False
    index_quantize: Optional[str] = None  # 'dims': an int8 index whose
                                          # per-dim scales are taken from
                                          # each cycle's first slice
    int8_clip_guard: float = 0.01      # mid-cycle guard: a slice write that
                                       # clips more than this fraction of
                                       # its entries widens the cycle's
                                       # scales at once
    rewarmup_per_dataset: bool = False  # reset the LR schedule at every
                                        # feed swap (reference
                                        # run_ann.py:210-215); needs
                                        # make_optimizer(..., rewarmup=...)
    shuffle_seed: int = 42
    feed_workers: int = 8              # gather threads; 0 = serial gathers
    log_trust_ratios: bool = False     # LAMB trust-ratio stats per refresh
    checkpoint_dir: Optional[str] = None
    save_every: int = 0                # steps between mid-run checkpoints
                                       # (0 = refresh boundaries only)
    host_id: int = 0                   # this rank's stripe of the
    num_hosts: int = 1                 # triples (the mesh's rank, world)


class PipelinedAnce:
    """Single-program ANCE with slice-pipelined index refresh.

    ``train_step(state, batch, generator)`` is
    :func:`ance_tpu_torch.train.trainer.make_train_step`'s step (dropout
    drawn from ``generator``); ``query_method`` / ``body_method`` are
    unbound encoder methods ``(model, ids, mask) → embeddings``
    (``RobertaDot.query_emb``, ``RobertaDot.body_emb`` or
    ``body_emb_multichunk``)."""

    def __init__(self, cfg: PipelineConfig, *, state, train_step: Callable,
                 generator: torch.Generator,
                 query_method: Callable, body_method: Callable,
                 passage_cache: TokenCache,
                 train_query_cache: TokenCache,
                 dev_query_cache: TokenCache,
                 train_qrels: Mapping[int, Mapping[int, int]],
                 dev_qrels: Mapping[int, Mapping[int, int]],
                 device=None, mesh=None, metrics_logger=None):
        if cfg.num_hosts > 1 and mesh is None:
            raise ValueError("multi-host pipelined mode requires a mesh")
        if mesh is not None and (cfg.host_id, cfg.num_hosts) != (
                mesh.rank, mesh.world):
            raise ValueError(f"host_id/num_hosts {cfg.host_id}/"
                             f"{cfg.num_hosts} are not the mesh's rank/world "
                             f"{mesh.rank}/{mesh.world}")
        self.cfg = cfg
        self.mesh = mesh
        self.state = state
        self.train_step = train_step
        self.generator = generator
        self.query_method, self.body_method = query_method, body_method
        self.device = torch.device(device if device is not None
                                   else mesh.device)
        self.passage_cache = passage_cache
        self.train_query_cache = train_query_cache
        self.dev_query_cache = dev_query_cache
        self.train_positive = {q: next(iter(r))
                               for q, r in train_qrels.items() if r}
        self.dev_qrels = dev_qrels
        self.metrics_logger = metrics_logger
        self._async_ckptr: Optional[ckpt.AsyncCheckpointer] = None
        self._now = synced_clock(self.device)
        self.index: Optional[FlatIPIndex] = None
        # guards the index's buffer and scale references and the snapshot
        # (with its encode functions) against live-serving readers
        # (serve.LoopRetriever); the loop's own searches run on this thread
        # and need no lock
        self.index_lock = threading.Lock()
        self.refresh_no = 0
        self._refresh_t0 = time.perf_counter()
        self.snapshot = self.qfn = self.bfn = None
        self._take_snapshot()
        self._batches = None
        self.history: list[dict] = []
        self.schedule_trace: list[str] = []
        self.item_times: dict[str, list[float]] = collections.defaultdict(list)
        self._losses_since_refresh: list[torch.Tensor] = []
        self._work: collections.deque = collections.deque()
        self._cyc: dict = {}  # per-cycle accumulators
        self._passage_ids: Optional[np.ndarray] = None
        self._rows_per_record: Optional[int] = None
        self._seed_cycle()

    def _take_snapshot(self) -> None:
        """A frozen copy of the live model (eval mode, no gradients) and
        the encode functions over it, swapped in by reference under the
        index lock: the steps train ``state.model`` in place, so the
        refresh must not encode with it. A second copy of the weights
        (~0.5 GB for RoBERTa-base in fp32)."""
        snap = copy.deepcopy(self.state.model).eval().requires_grad_(False)
        qfn = make_encode_fn(snap, self.query_method, self.device)
        bfn = make_encode_fn(snap, self.body_method, self.device)
        with self.index_lock:
            self.snapshot, self.qfn, self.bfn = snap, qfn, bfn

    # -- work items ----------------------------------------------------------
    def _encode_corpus_slice(self, start: int, stop: int) -> None:
        """Encode corpus records [start, stop) with the snapshot and write
        them into the device-resident index buffer."""
        emb, _ = encode_cache_to_device(
            self.bfn, self.passage_cache, self.cfg.encode_batch_size,
            multichunk=self.cfg.multichunk, start=start, stop=stop,
            mesh=self.mesh)
        scales = None
        if self.cfg.index_quantize == "dims" and start == 0:
            # this cycle's per-dim scales from its first slice (every slice
            # of a cycle is encoded with one snapshot; 1.5x margin for
            # slice-to-slice variation). Rows of the previous cycle decode
            # against them until rewritten: a one-cycle mis-scaling that
            # shows in int8_clip_frac.
            scales = self._int8_scales(emb)
        if self.index is None or self.index._slice_rows is None:
            n = len(self.passage_cache)
            self._rows_per_record = emb.shape[0] // (stop - start)
            self._passage_ids = np.repeat(
                np.arange(n, dtype=np.int64), self._rows_per_record)
            index = self.index if self.index is not None else FlatIPIndex(
                dim=emb.shape[1], device=self.device, mesh=self.mesh,
                quantize=self.cfg.index_quantize or False)
            with self.index_lock:
                index.allocate(
                    n * self._rows_per_record, emb.shape[1],
                    slice_rows=(self.cfg.encode_slice_size
                                * self._rows_per_record),
                    scales=scales)
                self.index = index
        elif scales is not None:
            with self.index_lock:
                self.index.set_scales(scales)
        if self.cfg.index_quantize == "dims":
            # the share of entries the int8 write clips this cycle
            # (row-weighted), and the mid-cycle guard: a slice that clips
            # beyond the threshold widens the scales (never narrows them)
            # before it is written; rows written earlier this cycle then
            # decode slightly shrunk, a bounded mis-scaling where the
            # unguarded index would saturate
            clipped = self._clip_count(emb)
            if self.cfg.int8_clip_guard and float(clipped) \
                    > self.cfg.int8_clip_guard * emb.numel():
                widened = torch.maximum(self._int8_scales(emb),
                                        self.index._scales)
                with self.index_lock:
                    self.index.set_scales(widened)
                self._cyc["scale_widenings"] = \
                    self._cyc.get("scale_widenings", 0) + 1
                logger.warning(
                    "int8 clip guard: slice at row %s clipped >%.1f%% of "
                    "entries; widened per-dim scales mid-cycle (widening "
                    "#%s this cycle)", start,
                    100.0 * self.cfg.int8_clip_guard,
                    self._cyc["scale_widenings"])
                clipped = self._clip_count(emb)
            self._cyc.setdefault("clip_counts", []).append(
                (clipped, emb.numel()))
        with self.index_lock:
            self.index.update_slice(start * self._rows_per_record, emb)

    @staticmethod
    def _int8_scales(emb: torch.Tensor) -> torch.Tensor:
        amax = emb.to(torch.float32).abs().amax(0)
        return torch.clamp_min(amax * 1.5 / 127.0, 1e-8)

    def _clip_count(self, emb: torch.Tensor) -> torch.Tensor:
        """Entries beyond the int8 range at the current scales (a device
        scalar)."""
        return (emb.to(torch.float32).abs()
                > self.index._scales[None, :] * 127.0).sum()

    def _encode_dev(self) -> None:
        self._cyc["dev_emb"], self._cyc["dev_ids"] = encode_cache_to_device(
            self.qfn, self.dev_query_cache, self.cfg.encode_batch_size,
            mesh=self.mesh)

    def _search_dev(self, qs: int, qe: int) -> None:
        k = min(self.cfg.dev_search_depth, self.index.ntotal)
        _, nb = self.index.search(self._cyc["dev_emb"][qs:qe], k)
        self._cyc.setdefault("dev_nb", []).append(nb.cpu().numpy())

    def _dev_metrics(self) -> None:
        parts = self._cyc.pop("dev_nb", [])
        dev_ids = self._cyc.pop("dev_ids", np.zeros((0,), np.int64))
        if not parts or len(dev_ids) == 0:
            # no dev search ran: zeros, not a crash at the first refresh
            # boundary, and one loud warning (a broken dev feed must not
            # read as a bad model in the metrics stream)
            if not getattr(self, "_warned_empty_dev", False):
                self._warned_empty_dev = True
                logger.warning(
                    "dev metrics: ZERO dev queries reached the search items "
                    "(dev-query cache empty or dev search produced nothing); "
                    "dev_ndcg/dev_recall will report 0.0 — this is a broken "
                    "dev feed, not a model score")
            self._cyc["dev_ndcg"] = self._cyc["dev_recall"] = 0.0
            self._cyc.pop("dev_emb", None)
            return
        dev_nb = np.concatenate(parts, axis=0)
        k = min(self.cfg.dev_search_depth, self.index.ntotal)
        dev_ndcg, _ = eval_dev_ndcg(dev_nb, dev_ids, self._passage_ids,
                                    self.dev_qrels)
        # recall at the search depth: an earlier-moving signal than NDCG@10
        dev_recall = recall_at_k(
            self.dev_qrels,
            dedup_ranking(dev_nb, dev_ids, self._passage_ids), k=k)
        self._cyc["dev_ndcg"], self._cyc["dev_recall"] = dev_ndcg, dev_recall
        self._cyc.pop("dev_emb", None)

    def _encode_train_queries(self, q_start: int, q_end: int) -> None:
        self._cyc["tq_emb"], self._cyc["tq_ids"] = encode_cache_to_device(
            self.qfn, self.train_query_cache, self.cfg.encode_batch_size,
            start=q_start, stop=q_end, mesh=self.mesh)

    def _mine_chunk(self, qs: int, qe: int, chunk_no: int) -> None:
        cfg = self.cfg
        k = min(cfg.topk_training, self.index.ntotal)
        tq_ids = self._cyc["tq_ids"][qs:qe]
        _, nb = self.index.search(self._cyc["tq_emb"][qs:qe], k)
        # the JAX loop's shuffle seeds: the triples file is a shared format
        negs, mrr = mine_negatives(
            tq_ids, self._passage_ids, self.train_positive,
            nb.cpu().numpy(), cfg.negative_sample,
            select_topk=cfg.ann_measure_topk_mrr,
            rng=random.Random(cfg.shuffle_seed
                              + 7919 * self.refresh_no + chunk_no))
        self._cyc.setdefault("negatives", {}).update(negs)
        n_q = sum(1 for q in tq_ids if int(q) in self.train_positive)
        self._cyc.setdefault("mrr_parts", []).append((mrr, n_q))

    def _finalize_refresh(self) -> dict:
        """Build the triples, switch the training feed, record the metrics,
        take a new snapshot and seed the next cycle's work."""
        cfg = self.cfg
        negatives = self._cyc.pop("negatives", {})
        parts = self._cyc.pop("mrr_parts", [(0.0, 0)])
        total_q = sum(w for _, w in parts)
        ann_mrr = (sum(m * w for m, w in parts) / total_q) if total_q else 0.0

        triples = []
        for qid, negs in negatives.items():
            pos = self.train_positive.get(qid)
            if pos is None:
                continue
            for neg in negs:
                triples.append((qid, pos, neg))
        if triples:
            # mining is replicated, so every rank builds this triple list
            # and trains on its stripe of it
            feed = TripletBatches(
                self.train_query_cache, self.passage_cache,
                np.asarray(triples, np.int64), cfg.batch_size,
                seed=cfg.shuffle_seed + self.refresh_no,
                host_id=cfg.host_id, num_hosts=cfg.num_hosts)
            # the replaced feed is closed here, not left to the garbage
            # collector: its gather threads end now
            old, self._batches = self._batches, infinite_batches(
                feed, workers=cfg.feed_workers)
            if old is not None:
                old.close()
            if cfg.rewarmup_per_dataset:
                # a fresh LR warmup for the new dataset, its size the
                # horizon (reference run_ann.py:210-215)
                opt = self.state.optimizer
                reset_rewarmup(opt.schedule, opt.count, len(triples))

        entry = {"refresh": self.refresh_no,
                 "dev_ndcg": self._cyc.pop("dev_ndcg", 0.0),
                 "dev_recall": self._cyc.pop("dev_recall", 0.0),
                 "ann_mrr": ann_mrr, "num_triples": len(triples),
                 "step": int(self.state.step)}
        if self._losses_since_refresh:
            entry["mean_loss"] = float(np.mean(
                torch.stack(self._losses_since_refresh).cpu().numpy()))
            self._losses_since_refresh = []
        clip_counts = self._cyc.pop("clip_counts", None)
        if clip_counts:
            clipped = int(torch.stack([c for c, _ in clip_counts]).sum())
            entry["int8_clip_frac"] = clipped / sum(n for _, n in clip_counts)
            entry["int8_scale_widenings"] = self._cyc.pop(
                "scale_widenings", 0)
        if cfg.log_trust_ratios:
            from ance_tpu_torch.optim.lamb import trust_ratio_summary
            summary = trust_ratio_summary(
                self.state.optimizer, self.state.model.named_parameters())
            if summary:
                entry.update(summary)
        entry["refresh_sec"] = round(
            time.perf_counter() - self._refresh_t0, 2)
        self._refresh_t0 = time.perf_counter()
        logger.info("pipelined refresh %s", entry)
        if self.metrics_logger is not None:
            self.metrics_logger.log(entry["step"], **{
                k: v for k, v in entry.items()
                if k != "step" and isinstance(v, (int, float))})
        self.history.append(entry)
        if cfg.checkpoint_dir:
            self._save_checkpoint()
        self.refresh_no += 1
        self._cyc.pop("tq_emb", None)
        self._cyc.pop("tq_ids", None)
        self._take_snapshot()
        self._seed_cycle()
        return entry

    # -- cycle scheduling ------------------------------------------------------
    def _seed_cycle(self) -> None:
        """Queue one full refresh cycle as ordered work items; the search
        items come after the last corpus slice."""
        cfg = self.cfg
        work = self._work
        n = len(self.passage_cache)
        for s in range(0, n, cfg.encode_slice_size):
            work.append(("E", functools.partial(
                self._encode_corpus_slice, s,
                min(s + cfg.encode_slice_size, n))))
        work.append(("D", self._encode_dev))
        n_dev = len(self.dev_query_cache)
        for qs in range(0, n_dev, cfg.search_chunk_queries):
            work.append(("S", functools.partial(
                self._search_dev, qs, min(qs + cfg.search_chunk_queries,
                                          n_dev))))
        work.append(("V", self._dev_metrics))
        q_start, q_end = query_chunk_range(
            len(self.train_query_cache), cfg.ann_chunk_factor,
            self.refresh_no)
        work.append(("Q", functools.partial(
            self._encode_train_queries, q_start, q_end)))
        n_tq = q_end - q_start
        for i, qs in enumerate(range(0, n_tq, cfg.search_chunk_queries)):
            work.append(("M", functools.partial(
                self._mine_chunk, qs, min(qs + cfg.search_chunk_queries,
                                          n_tq), i)))
        work.append(("F", self._finalize_refresh))

    def _save_checkpoint(self) -> None:
        """Parameters, optimizer state and the refresh counter: enough for
        a restart (resume() re-seeds the cycle from the restored weights).
        Only the copy to the host is synchronous; the files are written on
        the checkpointer's thread while the next steps run, and DONE is
        published at the next fence. Rank 0 alone saves (reference
        run_ann.py:307-334)."""
        if self.cfg.host_id != 0:
            return
        if self._async_ckptr is None:
            self._async_ckptr = ckpt.AsyncCheckpointer(self.cfg.checkpoint_dir)
        self._async_ckptr.wait()  # fence and publish the save in flight
        self._async_ckptr.save(self.state.step, self.state.model,
                               self.state.optimizer.state_dict(),
                               extra={"refresh_no": self.refresh_no})

    def flush_checkpoints(self) -> None:
        """Fence the last async save (publishes its DONE marker). Call
        before shutdown or before reading the newest checkpoint."""
        if self._async_ckptr is not None:
            self._async_ckptr.wait()

    def close(self) -> None:
        """End the training feed (its gather threads) and fence the last
        checkpoint; the loop runs no further steps."""
        if self._batches is not None:
            self._batches.close()
        self.flush_checkpoints()

    def resume(self) -> int:
        """Restore the newest complete checkpoint of cfg.checkpoint_dir
        (parameters, optimizer, step, refresh rotation), the port's or the
        JAX loop's (orbax ``state/`` with ``refresh_no`` in its meta.json,
        or its final msgpack one). Returns the resumed step (0 = nothing
        to resume)."""
        self.state, step = ckpt.resume_train_state(self.cfg.checkpoint_dir,
                                                   self.state)
        if step == 0:
            return 0
        path, _ = ckpt.get_latest_checkpoint(self.cfg.checkpoint_dir)
        with open(os.path.join(path, "meta.json")) as f:
            self.refresh_no = int(json.load(f).get("refresh_no", 0))
        # regenerate the in-flight cycle from the restored weights
        self._take_snapshot()
        self._work.clear()
        self._cyc.clear()
        if self._batches is not None:
            self._batches.close()
        self._batches = None
        self._seed_cycle()
        logger.info("pipelined resume: step %s, refresh %s", step,
                    self.refresh_no)
        return step

    def _run_item(self) -> None:
        tag, fn = self._work.popleft()
        t0 = self._now()
        fn()
        self.item_times[tag].append(self._now() - t0)
        self.schedule_trace.append(tag)

    def bootstrap(self) -> dict:
        """Initial full refresh (all work items back to back) before
        training starts: the reference's initial ann data generation."""
        start_refresh = self.refresh_no
        while self._batches is None:
            if self.refresh_no > start_refresh:
                # a whole cycle produced no feed: another would re-encode
                # the corpus forever
                raise RuntimeError(
                    "bootstrap refresh produced zero training triples "
                    "(no train qrels, or mining found no usable negatives); "
                    "check train-qrel.tsv and the corpus/query caches")
            self._run_item()
        return self.history[-1]

    # -- the interleaved schedule -------------------------------------------
    def run(self, num_steps: int) -> None:
        """Run ``num_steps`` train steps with one work item every
        ``train_steps_per_slice`` steps."""
        if num_steps <= 0:
            return  # a finished job must not re-bootstrap
        if self._batches is None:
            self.bootstrap()
        for i in range(num_steps):
            batch = next(self._batches)
            self.state, metrics = self.train_step(self.state, batch,
                                                  self.generator)
            # the device scalar: reading it here would sync every step
            self._losses_since_refresh.append(metrics["loss"])
            self.schedule_trace.append("T")
            if self.cfg.checkpoint_dir and self.cfg.save_every and \
                    (i + 1) % self.cfg.save_every == 0:
                self._save_checkpoint()
            if (i + 1) % self.cfg.train_steps_per_slice == 0 and self._work:
                self._run_item()
        self.flush_checkpoints()
