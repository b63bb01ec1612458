"""One rank of a data-parallel job, for the multi-rank tests and the chip
smoke run: start one such process a rank.

    python -m ance_tpu_torch.experiments.mesh_worker JOB.json RANK

``JOB.json`` either names a command line of ``ance_tpu_torch.cli`` that
joins its group itself (``{"cli": [...], "out_dir": ...}``; the rank's
``--process_id`` is appended), or a group to join and cases to run in it::

    {"init_method": "file:///..." | "tcp://host:port", "world": 2,
     "device": "cpu" | "cuda", "backend": "gloo" | "nccl" | null,
     "timeout_s": 300, "out_dir": "...", "cases": [{"case": "flat", ...}]}

Each case writes ``<out_dir>/<name>_rank<r>.pt`` (``torch.save`` of a dict
of tensors and numbers), which the caller holds against the one-process
run and the JAX package. The cases:

  * ``flat`` / ``ivf``: the row-sharded ``FlatIPIndex`` and the
    cluster-sharded ``IVFIPIndex`` over ``data`` (an ``.npz`` of
    ``corpus`` and ``queries``): searches, the chunked build, save and
    load;
  * ``replicated``: the check that ranks hold the same parameters;
  * ``step``: train steps of a pickled model (``triplet``, ``dpr`` or
    ``seed``) on this rank's rows of global batches;
  * ``warmup``: ``run_warmup`` over a triples file with a word-hash
    tokenizer;
  * ``index_1m``: the chip smoke's sharded exact index over a corpus made
    on the card from a seed (kernel #1 a shard, timed, launches counted);
  * ``dpr_full``: DPR GradCache steps of seeded BERT-base towers;
  * ``tp``: the tensor-parallel encode and one SGD step of a pickled model
    on a (data, model) grid of the ranks (``core/tp.py``);
  * ``dryrun``: ``graft_entry.dryrun_multichip``'s contents on this rank.

A command line runs under probes that record what it did: the pipelined
loop's bootstrap entry, its mined triples and step losses; a generator's
ranked ids, metrics and index rows; the parameter shapes tensor
parallelism left on the rank; kernel #1's launches and the card's peak
memory (``<out_dir>/cli_rank<r>.pt``).
"""

from __future__ import annotations

import contextlib
import datetime
import hashlib
import json
import os
import sys
import time
import zlib
from pathlib import Path

import numpy as np
import torch

from ance_tpu_torch.core.mesh import start_group


def _save(out_dir: str, name: str, rank: int, result: dict) -> None:
    torch.save(result, os.path.join(out_dir, f"{name}_rank{rank}.pt"))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# -- indexes ------------------------------------------------------------------

FLAT_MODES = {"none": dict(dtype=torch.float32),
              "bf16": dict(dtype=torch.bfloat16),
              "dims": dict(quantize="dims"), "rows": dict(quantize="rows")}


def case_flat(mesh, spec: dict) -> dict:
    from ance_tpu_torch.index.flat import FlatIPIndex
    with np.load(spec["data"]) as z:
        corpus, queries = z["corpus"], z["queries"]
    out = {}
    for mode in spec["modes"]:
        idx = FlatIPIndex(corpus.shape[1], mesh=mesh, **FLAT_MODES[mode])
        idx.add(corpus)
        out[f"{mode}/rows_per_shard"] = idx.rows_per_shard
        for k in spec["ks"]:
            out[f"{mode}/k{k}"] = idx.search(queries, k)
        if mode in ("none", "dims"):  # allocate + update_slice
            chunked = FlatIPIndex(corpus.shape[1], mesh=mesh,
                                  **FLAT_MODES[mode])
            chunked.add_chunked(corpus, slice_rows=spec["slice_rows"])
            for k in spec["ks"]:
                out[f"{mode}/chunked/k{k}"] = chunked.search(queries, k)
            try:
                chunked.update_slice(chunked.rows_per_shard * mesh.world,
                                     corpus[:1])
            except ValueError:
                out[f"{mode}/out_of_range_raises"] = True
        if spec.get("save_dir"):
            idx.save(os.path.join(spec["save_dir"], f"{mode}.npz"))
        if spec.get("load_dir"):
            loaded = FlatIPIndex.load(
                os.path.join(spec["load_dir"], f"{mode}.npz"), mesh=mesh)
            for k in spec["ks"]:
                out[f"{mode}/loaded/k{k}"] = loaded.search(queries, k)
    return out


def case_ivf(mesh, spec: dict) -> dict:
    from ance_tpu_torch.index.ivf import IVFIPIndex
    with np.load(spec["data"]) as z:
        corpus, queries = z["corpus"], z["queries"]
    out = {}
    for quantize in spec["quantize"]:
        tag = quantize or "none"
        idx = IVFIPIndex(corpus.shape[1], nlist=spec["nlist"],
                         nprobe=spec["nprobes"][0], dtype=torch.float32,
                         mesh=mesh, quantize=quantize, seed=spec["seed"])
        idx.add(corpus)
        out[f"{tag}/centroids"] = idx.centroids
        out[f"{tag}/bins_ids"] = idx._bins_ids
        out[f"{tag}/bins_emb"] = idx._bins_emb
        for nprobe in spec["nprobes"]:
            out[f"{tag}/nprobe{nprobe}"] = idx.search(queries, spec["k"],
                                                      nprobe=nprobe)
        if spec.get("save_dir"):
            idx.save(os.path.join(spec["save_dir"], f"ivf_{tag}.npz"))
        if spec.get("load_dir"):
            loaded = IVFIPIndex.load(
                os.path.join(spec["load_dir"], f"ivf_{tag}.npz"), mesh=mesh)
            out[f"{tag}/loaded"] = loaded.search(
                queries, spec["k"], nprobe=spec["nprobes"][0])
    return out


def case_replicated(mesh, spec: dict) -> dict:
    """``DataMesh.check_replicated`` on equal tensors, then on a tensor
    that differs by rank: its error message (None if it did not raise)."""
    same = {"a": torch.arange(4.0), "b": torch.ones(2, dtype=torch.bfloat16)}
    mesh.check_replicated(same)
    try:
        mesh.check_replicated(dict(same, c=torch.tensor([mesh.rank * 1.0])))
    except RuntimeError as e:
        return {"error": str(e)}
    return {"error": None}


# -- train steps --------------------------------------------------------------

def _optimizer(model, opt: dict):
    """``opt``: name, lr (constant, or with ``warmup`` [steps, total] the
    warmup-linear schedule), weight_decay, max_grad_norm."""
    from ance_tpu_torch.optim.schedules import warmup_linear
    from ance_tpu_torch.train import trainer
    lr = warmup_linear(opt["lr"], *opt["warmup"]) if "warmup" in opt \
        else opt["lr"]
    return trainer.make_optimizer(model, opt.get("name", "lamb"),
                                  lr, eps=1e-8,
                                  weight_decay=opt.get("weight_decay", 0.01),
                                  max_grad_norm=opt.get("max_grad_norm", 1.0))


def _make_step(kind: str, accum: int, mesh):
    from ance_tpu_torch.train import trainer
    if kind in ("dpr", "maxp_inbatch"):
        from ance_tpu_torch.train.dpr_trainer import make_dpr_train_step
        return make_dpr_train_step(accum_steps=accum, mesh=mesh,
                                   multichunk=kind == "maxp_inbatch")
    if kind == "seed":
        from ance_tpu_torch.train.seed_pretrain import make_seed_pretrain_step
        return make_seed_pretrain_step(mesh=mesh)
    return trainer.make_train_step(trainer.triplet_loss_fn(),
                                   accum_steps=accum, mesh=mesh)


def _seed_batches(spec: dict, host_id: int, num_hosts: int) -> list:
    from ance_tpu_torch.data.cache import TokenCache
    from ance_tpu_torch.train.seed_pretrain import seed_pretrain_batches
    with TokenCache(spec["cache"]) as cache:
        return list(seed_pretrain_batches(
            cache, spec["batch"], mask_token_id=spec["mask_token_id"],
            vocab_size=spec["vocab_size"], special_ids=spec["special_ids"],
            pad_token_id=spec["pad_token_id"], mask_prob=spec["mask_prob"],
            seed=spec["seed"], host_id=host_id,
            num_hosts=num_hosts))[:spec["n_steps"]]


def case_step(mesh, spec: dict) -> dict:
    """``n_steps`` steps of a pickled model (written by the caller) on this
    rank's rows: the rank's block of each global batch of ``batches``, or
    for ``seed`` its own host stripe of ``cache``."""
    from ance_tpu_torch.train.trainer import init_train_state
    model = torch.load(spec["model"], weights_only=False)
    state = init_train_state(model, _optimizer(model, spec["opt"]))
    step = _make_step(spec["kind"], spec.get("accum", 1), mesh)
    if spec["kind"] == "seed":
        batches = _seed_batches(spec, mesh.rank, mesh.world)
    else:
        with np.load(spec["batches"]) as z:
            n = spec["n_steps"]
            batches = [{k[len(f"b{i}_"):]: z[k] for k in z.files
                        if k.startswith(f"b{i}_")} for i in range(n)]
        batches = [{k: v[mesh.block(v.shape[0])] for k, v in b.items()}
                   for b in batches]
    gen = torch.Generator().manual_seed(spec.get("seed", 0))
    out = {"loss": [], "grad_norm": [], "correct": []}
    for batch in batches:
        state, m = step(state, batch, gen)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["correct"].append(int(m.get("correct", -1)))
    out["params"] = {k: v.detach().clone()
                     for k, v in model.state_dict().items()}
    out["grads"] = {n: p.grad.clone() for n, p in model.named_parameters()
                    if p.grad is not None}
    return out


class HashWordTokenizer:
    """Whitespace words to ids by CRC-32 (``<s>`` 0, pad 1, ``</s>`` 2):
    a tokenizer that needs no files, for the warmup case."""

    pad_token_id = 1

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def encode(self, text, add_special_tokens=True, max_length=None):
        ids = [3 + zlib.crc32(w.encode()) % (self.vocab_size - 3)
               for w in text.split()]
        if add_special_tokens:
            ids = [0] + ids + [2]
        return ids[:max_length] if max_length else ids


def case_warmup(mesh, spec: dict) -> dict:
    from ance_tpu_torch.train.trainer import init_train_state
    from ance_tpu_torch.train.warmup import WarmupConfig, run_warmup
    model = torch.load(spec["model"], weights_only=False)
    state = init_train_state(model, _optimizer(model, spec["opt"]))
    world = mesh.world if mesh else 1
    cfg = WarmupConfig(batch_size=spec["batch"] // world,
                       max_seq_length=spec["seq"], max_steps=spec["n_steps"],
                       host_id=mesh.rank if mesh else 0, num_hosts=world)
    state, history = run_warmup(
        cfg, state=state, train_step=_make_step("triplet", 1, mesh),
        tokenizer=HashWordTokenizer(spec["vocab_size"]),
        triples_path=spec["triples"], seed=0)
    return {"loss": [h["loss"] for h in history],
            "params": {k: v.detach().clone()
                       for k, v in model.state_dict().items()}}


# -- the chip smoke's cases ---------------------------------------------------

def seeded_rows(n: int, dim: int, seed: int, device) -> torch.Tensor:
    """[n, dim] fp32 normal rows made on ``device`` from ``seed``: the
    same rows in every process on one kind of card."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((n, dim), generator=gen, device=device)


def blockmax_launches() -> dict:
    from ance_tpu_torch.ops.topk import blockmax_scores
    return dict(blockmax_scores.kernel_launches)


def reset_blockmax_launches() -> None:
    from ance_tpu_torch.ops.topk import blockmax_scores
    blockmax_scores.launches = 0
    blockmax_scores.kernel_launches.clear()


def _event_ms(fn, reps: int) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` calls after one."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def case_index_1m(mesh, spec: dict) -> dict:
    """The sharded exact index over ``n`` seeded rows for each mode: the
    merged answer of every search (rank 0 keeps it), kernel #1's launches
    by kernel over the searches, the shard's search ms (CUDA events; the
    ranks take turns, so ranks that share a card time their shards
    alone) and the ms of gathering its [Q, k] candidates (host clock,
    synchronized; all ranks at once, as a search gathers)."""
    from ance_tpu_torch.index.flat import FlatIPIndex
    dev = mesh.device
    corpus = seeded_rows(spec["n"], spec["dim"], spec["seed"], dev)
    out = {"rank": mesh.rank, "world": mesh.world, "backend": mesh.backend}
    torch.cuda.reset_peak_memory_stats(dev)
    for mode in spec["modes"]:
        idx = FlatIPIndex(spec["dim"], mesh=mesh, **FLAT_MODES[mode])
        idx.add(corpus)
        mesh.barrier()
        reset_blockmax_launches()
        for q_n, k in spec["searches"]:
            q = seeded_rows(q_n, spec["dim"], spec["seed"] + q_n, dev)
            s, i = idx.search(q, k)
            _sync(dev)
            key = f"{mode}/Q{q_n}k{k}"
            if mesh.rank == 0:
                out[key] = (s.cpu(), i.cpu())
        out[f"{mode}/launches"] = blockmax_launches()
        for q_n, k in spec["searches"]:
            q = seeded_rows(q_n, spec["dim"], spec["seed"] + q_n, dev)
            key = f"{mode}/Q{q_n}k{k}"
            for turn in range(mesh.world):
                mesh.barrier()
                if turn == mesh.rank:
                    out[key + "/shard_ms"] = _event_ms(
                        lambda: idx._search_shard(q, k), spec["reps"])
            s, i = idx._search_shard(q, k)
            gathers = []
            for _ in range(spec["reps"]):
                mesh.barrier()
                t0 = time.perf_counter()
                mesh.all_gather(s)
                mesh.all_gather(i)
                _sync(dev)
                gathers.append((time.perf_counter() - t0) * 1e3)
            out[key + "/gather_ms"] = float(np.median(gathers))
        del idx
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    return out


def case_dpr_full(mesh, spec: dict) -> dict:
    """DPR GradCache steps of the registry's BiEncoder (seeded, at
    ``spec['dtype']``) over seeded global batches, this rank's rows each;
    kernel #2 / #3 launches counted over the steps."""
    from ance_tpu_torch.models.registry import get_model_spec
    from ance_tpu_torch.ops import fused_attention as fa
    from ance_tpu_torch.train.trainer import init_train_state
    dev = mesh.device
    dtype = getattr(torch, spec["dtype"])
    model = get_model_spec("dpr").build(
        dtype=dtype, config_overrides=spec["overrides"],
        seed=spec["seed"]).to(dev)
    batches = dpr_batches(spec)
    state = init_train_state(model, _optimizer(model, spec["opt"]))
    step = _make_step("dpr", spec["accum"], mesh)
    gen = torch.Generator().manual_seed(spec["seed"])
    torch.cuda.reset_peak_memory_stats(dev)
    for f in (fa.fused_attention, fa.fused_attention_backward):
        f.launches = 0
        f.kernel_launches.clear()
    out = {"loss": [], "grad_norm": [], "correct": []}
    t0 = time.perf_counter()
    for batch in batches:
        local = {k: v[mesh.block(v.shape[0])] for k, v in batch.items()}
        state, m = step(state, local, gen)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["correct"].append(int(m["correct"]))
    _sync(dev)
    out["seconds"] = time.perf_counter() - t0
    out["fused_forward"] = dict(fa.fused_attention.kernel_launches)
    out["fused_backward"] = dict(fa.fused_attention_backward.kernel_launches)
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    mesh.check_replicated(dict(model.named_parameters()))
    if mesh.rank == 0:
        torch.save({k: v.cpu() for k, v in model.state_dict().items()},
                   spec["params_out"])
    return out


def dpr_batches(spec: dict) -> list[dict]:
    """``n_steps`` global DPR batches of BERT-style rows from a seed:
    [CLS] words [SEP], zero padding past each row's length."""
    rs = np.random.RandomState(spec["seed"])
    B, seq = spec["batch"], spec["seq"]

    def rows():
        lengths = rs.randint(seq // 2, seq + 1, B)
        ids = rs.randint(1000, 30000, (B, seq))
        ids[:, 0] = 101
        ids[np.arange(B), lengths - 1] = 102
        mask = (np.arange(seq)[None] < lengths[:, None]).astype(np.int64)
        return np.where(mask == 1, ids, 0), mask

    out = []
    for _ in range(spec["n_steps"]):
        b = {}
        for side in ("query", "pos", "neg"):
            b[f"{side}_ids"], b[f"{side}_mask"] = rows()
        out.append(b)
    return out


def _full(t: torch.Tensor, spec: tuple, model_axis) -> torch.Tensor:
    """A parameter (or its gradient) whole again: the model ranks' slices
    gathered and joined along the dimension ``spec`` splits."""
    from ance_tpu_torch.core.tp import MODEL_AXIS
    if MODEL_AXIS not in spec:
        return t.detach().clone()
    return torch.cat(model_axis.all_gather(t.detach()).unbind(0),
                     dim=spec.index(MODEL_AXIS))


def case_tp(mesh, spec: dict) -> dict:
    """A pickled model sharded over a grid of ``spec['tp']`` model ranks
    (``core/tp.py``): the encode of every global batch of ``batches`` (this
    rank's data block, gathered over the data axis), then one SGD step
    (lr ``spec['lr']``) on the loss sum(emb²) over the first batch, its
    gradients summed over the data axis. Returns the embeddings, the
    loss, every parameter and gradient whole, and each parameter's shape
    on this rank."""
    from ance_tpu_torch.core.tp import (encoder_param_shardings,
                                        make_mesh_2d, shard_params_tp,
                                        validate_tp)
    data_axis, model_axis = make_mesh_2d(spec["tp"], device=mesh.device)
    model = torch.load(spec["model"], weights_only=False).to(mesh.device)
    validate_tp(model.config, model_axis)
    shard_params_tp(model, model_axis)
    specs = encoder_param_shardings(model)
    method = getattr(type(model), spec.get("method", "body_emb"))
    with np.load(spec["batches"]) as z:
        ids, mask = (torch.as_tensor(z[k], device=mesh.device)
                     for k in ("ids", "mask"))
    own = data_axis.block(ids.shape[0])
    out = {"rank": mesh.rank, "data": data_axis.rank,
           "model": model_axis.rank,
           "local_shapes": {n: tuple(p.shape)
                            for n, p in model.named_parameters()}}
    with torch.no_grad():
        out["emb"] = data_axis.gather_rows(method(model, ids[own],
                                                  mask[own])).cpu()
    model.zero_grad()
    loss = (method(model, ids[own], mask[own]) ** 2).sum()
    loss.backward()
    params = dict(model.named_parameters())
    data_axis.all_reduce_grads_([p.grad for p in params.values()],
                                op="sum")
    out["loss"] = float(data_axis.all_reduce_(loss.detach().clone()))
    out["grads"] = {n: _full(p.grad, specs[n], model_axis).cpu()
                    for n, p in params.items()}
    with torch.no_grad():
        for p in params.values():
            p.sub_(spec["lr"] * p.grad)
    out["params"] = {n: _full(p, specs[n], model_axis).cpu()
                     for n, p in params.items()}
    return out


def case_dryrun(mesh, spec: dict) -> dict:
    from ance_tpu_torch.graft_entry import dryrun_rank
    return dryrun_rank(mesh, spec)


CASES = {"flat": case_flat, "ivf": case_ivf, "replicated": case_replicated,
         "step": case_step,
         "warmup": case_warmup, "index_1m": case_index_1m,
         "dpr_full": case_dpr_full, "tp": case_tp, "dryrun": case_dryrun}


# -- command lines under probes -----------------------------------------------

@contextlib.contextmanager
def loop_probes():
    """Record what ``cli ance-loop`` did: the loops it built, the triples
    of every feed they made (a SHA-256 of the array, in order), and kernel
    #1's launches from here on. Yields the record; read it after the
    command returns."""
    from ance_tpu_torch.train import pipelined
    record = {"loops": [], "triples": []}
    init, feed = pipelined.PipelinedAnce.__init__, pipelined.TripletBatches

    def tracked_init(self, *args, **kw):
        init(self, *args, **kw)
        record["loops"].append(self)

    def recorded_feed(*args, **kw):
        batches = feed(*args, **kw)
        record["triples"].append(hashlib.sha256(
            np.ascontiguousarray(batches.triples).tobytes()).hexdigest())
        return batches

    pipelined.PipelinedAnce.__init__ = tracked_init
    pipelined.TripletBatches = recorded_feed
    reset_blockmax_launches()
    try:
        yield record
    finally:
        pipelined.PipelinedAnce.__init__ = init
        pipelined.TripletBatches = feed


def loop_summary(record: dict) -> dict:
    """The last loop's bootstrap entry, its step losses since its last
    refresh, its feeds' triple digests and kernel #1's launches."""
    loop = record["loops"][-1]
    return {"bootstrap": loop.history[0], "history": loop.history,
            "losses": [float(x) for x in loop._losses_since_refresh],
            "triples": record["triples"], "launches": blockmax_launches()}


@contextlib.contextmanager
def generator_probes():
    """Record what ``cli generate`` / ``infer`` / ``generate-dpr`` did:
    their pass's result (metrics, ranked ids, and the index's rows, every
    rank's shard gathered) under ``"generate"`` or ``"generate_dpr"``, and
    the parameter shapes ``shard_params_tp`` left on this rank under
    ``"local_shapes"``. Yields the record."""
    from ance_tpu_torch.core import tp
    from ance_tpu_torch.train import ann_gen, dpr_gen
    record = {}
    real = {"gen": ann_gen.generate_new_ann,
            "dpr": dpr_gen.generate_new_ann_dpr,
            "shard": tp.shard_params_tp}

    def index_rows(result):
        index = result["index"]
        return index._global_rows(index._emb).float().cpu()

    def gen(*args, **kw):
        result = real["gen"](*args, **kw)
        record["generate"] = {
            k: result[k] for k in ("dev_ndcg", "train_neighbor_ids",
                                   "passage_embedding2id") if k in result}
        record["generate"]["passage_emb"] = index_rows(result)
        if "train_query_embedding" in result:
            record["generate"]["train_query_embedding"] = \
                result["train_query_embedding"].float().cpu()
        return result

    def dpr(*args, **kw):
        result = real["dpr"](*args, **kw)
        record["generate_dpr"] = {
            k: result[k] for k in ("top20", "top100", "top_k_hits",
                                   "top_k_hits_trivia", "test_neighbor_ids",
                                   "train_neighbor_ids")}
        record["generate_dpr"].update(
            passage_emb=index_rows(result),
            **{k: result[k].float().cpu() for k in (
                "test_query_embedding", "train_query_embedding")})
        return result

    def shard(model, axis):
        out = real["shard"](model, axis)
        record["local_shapes"] = {n: tuple(p.shape)
                                  for n, p in model.named_parameters()}
        return out

    ann_gen.generate_new_ann, dpr_gen.generate_new_ann_dpr = gen, dpr
    tp.shard_params_tp = shard
    try:
        yield record
    finally:
        ann_gen.generate_new_ann = real["gen"]
        dpr_gen.generate_new_ann_dpr = real["dpr"]
        tp.shard_params_tp = real["shard"]


def run_cli(job: dict, rank: int) -> None:
    """The command line as rank ``rank``; saves what the probes recorded
    (an ``ance-loop``'s summary, a generator's results, kernel #1's
    launches) and the card's peak GiB."""
    from ance_tpu_torch.cli import main
    argv = list(job["cli"]) + ["--process_id", str(rank)]
    with loop_probes() as record, generator_probes() as generated:
        main(argv)
    result = loop_summary(record) if record["loops"] else {
        "launches": blockmax_launches()}
    result.update(generated)
    if torch.cuda.is_available():
        result["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    _save(job["out_dir"], "cli", rank, result)


def main(argv=None) -> int:
    job_path, rank = (argv or sys.argv[1:])[:2]
    rank = int(rank)
    job = json.loads(Path(job_path).read_text())
    torch.set_num_threads(job.get("threads", 1))
    if "cli" in job:
        run_cli(job, rank)
        return 0
    mesh = start_group(job["init_method"], job["world"], rank,
                       device=job.get("device", "cpu"),
                       backend=job.get("backend"),
                       timeout=datetime.timedelta(
                           seconds=job.get("timeout_s", 300)))
    try:
        for spec in job["cases"]:
            result = CASES[spec["case"]](mesh, spec)
            _save(job["out_dir"], spec.get("name", spec["case"]), rank,
                  result)
    finally:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
