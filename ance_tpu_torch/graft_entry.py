"""Entry points of the torch port: the counterpart of ``__graft_entry__.py``.

``entry(device="cuda")``  — (fn, example_args): the FirstP query forward
                            (``RobertaDot.query_emb``) at RoBERTa-base
                            width, bf16 compute, seq 128, B = 8, on the card
                            unless ``device="cpu"``; ``fn(params, ids,
                            mask)`` takes the model's state dict as
                            ``params``, as the JAX ``fn`` takes its tree.
``dryrun_multichip(n)``   — the JAX file's multichip dryrun over
                            ``core/mesh.py``: ``n`` ranks, each a process of
                            ``experiments/mesh_worker.py`` (one rank a card,
                            or ``device="cpu"`` for gloo ranks on the CPU),
                            each running :func:`dryrun_rank` on tiny shapes:
                            the data-parallel LAMB step with accumulation 2;
                            the row-sharded index refreshed slice by slice
                            and searched, exact against numpy; the ``dims``
                            index's self-retrieval; for n ≥ 4 (even), the
                            dp n/2 x tp 2 encode (``core/tp.py``) equal to
                            the replicated one; and the mini pipelined
                            refresh with a ``LoopRetriever`` search.

    python -m ance_tpu_torch.graft_entry [N] [--device cpu]
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
RANK_TIMEOUT_S = 600

# the JAX dryrun's tiny encoder (``__graft_entry__.py::_flagship``)
TINY = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_position_embeddings=40,
            hidden_dropout=0.0, attention_dropout=0.0)


def entry(device: str = "cuda"):
    """(fn, (params, ids, mask)): the FirstP query forward at RoBERTa-base
    geometry in bf16 (seeded weights), on ``device``."""
    from torch.func import functional_call
    from ance_tpu_torch.models.registry import get_model_spec
    from ance_tpu_torch.utils.device import resolve_device
    device = resolve_device(device)
    model = get_model_spec("rdot_nll").build(dtype=torch.bfloat16).to(device)
    B, seq = 8, 128
    ids = torch.ones((B, seq), dtype=torch.int64, device=device)
    mask = torch.ones((B, seq), dtype=torch.int64, device=device)
    params = dict(model.state_dict())

    def fn(params, ids, mask):
        with torch.inference_mode():
            return functional_call(model, params, (ids, mask),
                                   strict=True)

    return fn, (params, ids, mask)


def _tiny_model(attention_impl: str = "auto"):
    from ance_tpu_torch.models.registry import get_model_spec
    return get_model_spec("rdot_nll").build(
        attention_impl=attention_impl, config_overrides=TINY, seed=0)


def _tiny_caches(root: Path, n: int, rs) -> dict:
    """The JAX dryrun's token caches: 4n passages at seq 16, 8 train and 4
    dev queries at seq 12."""
    from ance_tpu_torch.data.cache import TokenCacheWriter
    sizes = {"passages": (4 * n, 16), "train-query": (8, 12),
             "dev-query": (4, 12)}
    for name, (count, length) in sizes.items():
        with TokenCacheWriter(str(root / name), length) as w:
            for _ in range(count):
                w.write(length, rs.randint(4, 250, length).astype(np.int32))
    return {name: count for name, (count, _) in sizes.items()}


def dryrun_rank(mesh, spec: dict) -> dict:
    """:func:`dryrun_multichip`'s contents as one rank of ``mesh``; raises
    where a check fails. ``spec['work_dir']`` holds the rank's caches."""
    from ance_tpu_torch.index.flat import FlatIPIndex
    from ance_tpu_torch.optim.schedules import warmup_linear
    from ance_tpu_torch.train import trainer
    n, dev = mesh.world, mesh.device
    rs = np.random.RandomState(0)

    # the data-parallel LAMB step, accumulation 2, over a global batch of
    # 2n triples (this rank's block of it)
    model = _tiny_model().to(dev).train()
    QLEN = PLEN = 16
    B = 2 * n
    batch = {f"{side}_{kind}": (rs.randint(4, 250, (B, L)) if kind == "ids"
                                else np.ones((B, L), np.int64))
             for side, L in (("query", QLEN), ("pos", PLEN), ("neg", PLEN))
             for kind in ("ids", "mask")}
    state = trainer.init_train_state(model, trainer.make_optimizer(
        model, "lamb", warmup_linear(1e-4, 10, 100)))
    step = trainer.make_train_step(trainer.triplet_loss_fn(), accum_steps=2,
                                   mesh=mesh)
    own = {k: torch.as_tensor(v[mesh.block(B)], device=dev)
           for k, v in batch.items()}
    state, metrics = step(state, own, torch.Generator().manual_seed(1))
    loss = float(metrics["loss"])
    assert np.isfinite(loss), f"non-finite loss {loss}"
    mesh.check_replicated(dict(model.named_parameters()))

    # the sharded index: allocated, refreshed slice by slice, searched
    D, ROWS, SLICE, K = 32, 8 * n, 8, 4
    index = FlatIPIndex(dim=D, mesh=mesh)
    index.allocate(ROWS, D, slice_rows=SLICE)
    corpus = rs.randn(ROWS, D).astype(np.float32)
    for s in range(0, ROWS, SLICE):
        index.update_slice(s, corpus[s:s + SLICE])
    queries = rs.randn(4, D).astype(np.float32)
    _, ids = index.search(queries, K)
    expect = np.argsort(-(queries @ corpus.T), axis=1)[:, :K]
    assert np.array_equal(np.sort(ids.cpu().numpy(), 1),
                          np.sort(expect, 1)), \
        "sharded index search != numpy exact top-k"

    # its int8 form (quantize='dims', the scales re-set as a refresh
    # does): top-1 survives quantization on this well-separated corpus
    qidx = FlatIPIndex(dim=D, mesh=mesh, quantize="dims")
    scales = np.abs(corpus).max(axis=0) * 1.5 / 127.0
    qidx.allocate(ROWS, D, slice_rows=SLICE, scales=scales)
    for s in range(0, ROWS, SLICE):
        qidx.update_slice(s, corpus[s:s + SLICE])
    qidx.set_scales(scales)
    _, qids = qidx.search(corpus[:4], 1)
    assert np.array_equal(qids.cpu().numpy()[:, 0], np.arange(4)), \
        "int8 sharded index failed self-retrieval"

    out = {"loss": loss, "rows": ROWS, "tp": None}
    if n >= 4 and n % 2 == 0:
        out["tp"] = _tp_encode(mesh, model, batch)
    out.update(_pipelined(mesh, model, Path(spec["work_dir"]), rs))
    return out


def _tp_encode(mesh, trained, batch) -> float:
    """The dp n/2 x tp 2 encode of the trained weights (explicit 'xla'
    attention) against the replicated encode on this rank; returns the
    largest difference."""
    from ance_tpu_torch.core.tp import (make_mesh_2d, shard_params_tp,
                                        validate_tp)
    data_axis, model_axis = make_mesh_2d(2, mesh.world // 2,
                                         device=mesh.device)
    weights = {k: v.detach().clone() for k, v in trained.state_dict().items()}
    models = []
    for _ in range(2):
        m = _tiny_model("xla")
        m.load_state_dict(weights)
        models.append(m.to(mesh.device))
    validate_tp(models[0].config, model_axis)
    shard_params_tp(models[0], model_axis)
    ids = torch.as_tensor(batch["pos_ids"], device=mesh.device)
    mask = torch.as_tensor(batch["pos_mask"], device=mesh.device)
    own = data_axis.block(ids.shape[0])
    with torch.inference_mode():
        tp_out = data_axis.gather_rows(models[0].body_emb(ids[own],
                                                          mask[own]))
        dp_out = models[1].body_emb(ids, mask)
    diff = float((tp_out - dp_out).abs().max())
    assert diff <= 1e-4, f"tensor-parallel encode != replicated ({diff})"
    return diff


def _pipelined(mesh, model, root: Path, rs) -> dict:
    """The mini pipelined refresh on the mesh: bootstrap and one whole
    interleaved cycle (train steps, the sliced corpus re-encode into the
    sharded index, dev search, mining, the feed swap), then a live
    search through ``LoopRetriever``."""
    from ance_tpu_torch.data.cache import TokenCache
    from ance_tpu_torch.models.dot_models import RobertaDot
    from ance_tpu_torch.optim.schedules import warmup_linear
    from ance_tpu_torch.serve import LoopRetriever
    from ance_tpu_torch.train import trainer
    from ance_tpu_torch.train.pipelined import PipelineConfig, PipelinedAnce
    n = mesh.world
    counts = _tiny_caches(root, n, rs)
    caches = {name: TokenCache(str(root / name)).open() for name in counts}
    try:
        cfg = PipelineConfig(
            train_steps_per_slice=1, encode_slice_size=n,
            encode_batch_size=n, batch_size=1, topk_training=8,
            negative_sample=2, ann_chunk_factor=1, dev_search_depth=4,
            search_chunk_queries=16, feed_workers=0, host_id=mesh.rank,
            num_hosts=n)
        state = trainer.init_train_state(model, trainer.make_optimizer(
            model, "lamb", warmup_linear(1e-4, 4, 100)))
        n_p = counts["passages"]
        loop = PipelinedAnce(
            cfg, state=state,
            train_step=trainer.make_train_step(trainer.triplet_loss_fn(),
                                               mesh=mesh),
            generator=torch.Generator().manual_seed(5),
            query_method=RobertaDot.query_emb,
            body_method=RobertaDot.body_emb,
            passage_cache=caches["passages"],
            train_query_cache=caches["train-query"],
            dev_query_cache=caches["dev-query"],
            train_qrels={q: {q % n_p: 1} for q in range(counts["train-query"])},
            dev_qrels={q: {q % n_p: 1} for q in range(counts["dev-query"])},
            mesh=mesh)
        loop.bootstrap()
        # a cycle: n_p / n E items, then D, S, V, Q, M, F: one item a step
        loop.run(n_p // n + 6 + 2)
        assert loop.refresh_no == 2, loop.schedule_trace
        triples = loop.history[-1]["num_triples"]
        assert triples > 0
        live = LoopRetriever(loop)
        s_ids = rs.randint(4, 250, (n, 12))
        _, pids = live.search_tokens(s_ids, np.ones_like(s_ids), k=3)
        assert pids.shape == (n, 3) and (pids >= 0).all()
        return {"refresh_no": loop.refresh_no, "num_triples": triples}
    finally:
        for c in caches.values():
            c.close()


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     backend: str | None = None) -> list[dict]:
    """Run :func:`dryrun_rank` on ``n_devices`` ranks, each a process of
    ``experiments/mesh_worker.py`` with a time limit: one rank a card on
    ``cuda`` (NCCL unless ``backend`` says gloo), or gloo ranks with
    ``device="cpu"``. Raises unless every rank passes; prints a summary
    and returns each rank's result."""
    with tempfile.TemporaryDirectory() as td:
        td = Path(td)
        job = {"init_method": f"file://{td / 'rendezvous'}",
               "world": n_devices, "device": device, "backend": backend,
               "timeout_s": RANK_TIMEOUT_S, "out_dir": str(td), "cases": []}
        for r in range(n_devices):
            (td / f"work{r}").mkdir()
        env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
        procs = []
        for r in range(n_devices):
            rank_job = dict(job, cases=[{"case": "dryrun",
                                         "work_dir": str(td / f"work{r}")}])
            (td / f"job{r}.json").write_text(json.dumps(rank_job))
            procs.append(subprocess.Popen(
                [sys.executable, "-m",
                 "ance_tpu_torch.experiments.mesh_worker",
                 str(td / f"job{r}.json"), str(r)], cwd=ROOT, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        errs = []
        try:
            for p in procs:
                errs.append(p.communicate(timeout=RANK_TIMEOUT_S)[1])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for r, (p, err) in enumerate(zip(procs, errs)):
            if p.returncode:
                raise RuntimeError(f"dryrun_multichip rank {r} exited "
                                   f"{p.returncode}: {err[-3000:]}")
        results = [torch.load(td / f"dryrun_rank{r}.pt", weights_only=False)
                   for r in range(n_devices)]
    head = results[0]
    print(f"dryrun_multichip({n_devices}): step ok, loss={head['loss']:.4f};"
          f" sharded index refresh+search exact over {head['rows']} rows"
          + ("" if head["tp"] is None else
             f"; tp encode matches replicated (dp{n_devices // 2} x tp2, "
             f"max |diff| {head['tp']:.2e})")
          + f"; pipelined mini refresh cycle completed on the mesh "
          f"(refreshes={head['refresh_no']}, "
          f"triples={head['num_triples']}; live-serving search ok)")
    return results


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(prog="ance_tpu_torch.graft_entry")
    p.add_argument("n", type=int, nargs="?", default=None,
                   help="ranks (default: the cards there are)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--dist_backend", default=None, choices=["nccl", "gloo"])
    args = p.parse_args(argv)
    n = args.n or (torch.cuda.device_count() if args.device == "cuda"
                   else 1)
    dryrun_multichip(n, args.device, args.dist_backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
