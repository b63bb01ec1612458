"""Command line of the torch port: ``python -m ance_tpu_torch.cli
{preprocess,preprocess-dpr,warmup,train,generate,generate-dpr,infer,
ance-loop,seed-pretrain,serve,export-hf,eval,eval-full}``: the JAX CLI's
13 subcommands.

Counterpart of the same subcommands of ``ance_tpu/cli.py``, with the same
flags plus ``--device`` where a command computes on a device (default
``cuda``; asking for CUDA where none exists exits, it never carries on on
the CPU). ``serve --index ivf`` builds the approximate IVF index
(``--nlist`` clusters, ``--nprobe`` searched a query) on the device.

``train``, ``warmup``, ``ance-loop`` and ``seed-pretrain`` run
data-parallel over ``--num_processes`` ranks, one process a card (the JAX
CLI's processes are hosts): start one process a rank with
``--coordinator_address host:port`` (rank 0's) and ``--process_id r``;
rank r runs on ``cuda:(r % device_count)``. ``--dist_backend`` (only
here) picks NCCL (the default on CUDA) or gloo (the CPU's, and that of
ranks that share a card); each rank prints ``{"dist": ...}`` naming it
first. ``generate``, ``infer`` and ``generate-dpr`` take the same rank
flags and run over a (data, model) grid of the ranks, as the JAX CLI runs
them over its chips: the encode is sharded over the data axis and, with
``--tensor_parallel`` tp > 1 (which must divide the ranks; attention
``xla`` or ``xla_bf16``), the encoder's weights Megatron-style over tp
model ranks (``core/tp.py``); the index is row-sharded over the data axis
and replicated over the model axis, and global rank 0 alone writes. One
process runs on one device whatever tp says (the JAX CLI on one chip).

``preprocess`` turns raw MS MARCO TSVs into token caches, id maps and
offset-space qrels over ``--num_processes`` spawned workers and prints the
map sizes. ``warmup`` is the BM25-triples trainer: it trains off
``--train_file``, checkpoints into ``--output_dir`` (resuming from its
newest complete checkpoint), evaluates dev MRR with
``--evaluate_during_training`` and prints the last three history entries.
``export-hf`` writes the newest complete checkpoint of ``--training_dir``
(or ``--init_model_dir``) as an HF ``pytorch_model.bin`` + ``config.json``
directory, or with ``--model_type dpr`` as a DPR ``CheckpointState`` file.
Every command that loads weights reads the port's checkpoints and the JAX
package's, msgpack or orbax (a DPR model also a ``CheckpointState``); the
commands that resume (``warmup``, ``ance-loop``) restore a JAX
checkpoint's optimizer state too.

SEED (``--model_type seeddot_nll``, RobertaDot over the SEED encoder, and
the ``seed-wordpiece`` tokenizer over ``--model_name_or_path``'s
``vocab.txt``): ``seed-pretrain`` trains SeedForMaskedLM (MLM + the
CLS-bottleneck decoder) over ``{data_dir}/passages`` and prints the last
three history entries; ``train``, ``generate``, ``infer`` and ``serve``
warm-start ``seeddot_nll`` from a ``seed-pretrain`` checkpoint (the
port's or the JAX package's: its encoder, the head keeping its seeded
init) or from a fairseq SEED ``pytorch_model.bin``; ``export-hf`` writes
either kind of checkpoint in the reference's fairseq names.

DPR (``--model_type dpr``, the BiEncoder): ``preprocess-dpr`` turns
``psgs_w100.tsv`` and the NQ / TriviaQA files into caches, ``-ann`` /
``-data`` files and ``pid2offset``; ``train`` trains with the in-batch
loss (``--gradient_accumulation_steps`` keeps the global softmax), from
``--ann_dir`` or for ``--num_epoch`` epochs over ``train-data`` with a
dev evaluation a epoch (``--dev_data``); ``generate-dpr`` is one pass of
its generator (answer-validated test searches, answer-filtered mining).

``serve`` batch mode writes ``qid\\tpid\\trank[\\tscore]`` lines in real id
space, as the JAX CLI does; ``--http HOST:PORT`` serves the JSON API of
:mod:`ance_tpu_torch.serve_http` instead. ``train`` is the ANCE trainer
job: it polls ``--ann_dir`` for ann data (or, for DPR, trains
``--num_epoch`` epochs) and writes ``checkpoint-<step>`` directories to
``--output_dir``, then prints one JSON line of its per-step losses,
gradient norms and step times. ``generate`` is one pass
of the generator job (encode, index, dev NDCG, mining, then
``ann_training_data_<n>`` and ``ann_ndcg_<n>``) with the newest complete
checkpoint under ``--training_dir``; ``infer`` stops after the encode and
dumps embedding shards, which ``eval-full`` scores; ``eval`` is the
official MS MARCO scorer. ``ance-loop`` is the single-program pipelined
refresh (:mod:`ance_tpu_torch.train.pipelined`): it trains, re-encodes the
index slice by slice between steps, mines, writes ``refresh.jsonl`` and
checkpoints to ``--output_dir``, and with ``--http HOST:PORT`` serves the
live index while it trains; it prints the last three refresh entries.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys


def _load_tokenizer(name: str, model_dir: str | None):
    """The port's WordPiece over ``model_dir``'s ``vocab.txt`` for
    ``seed-wordpiece`` (``ance_tpu/cli.py:40-45``); else the HF tokenizer
    from ``model_dir``, else the registry's ``name`` (a weights-only
    directory carries no tokenizer files)."""
    if name == "seed-wordpiece":
        from ance_tpu_torch.data.wordpiece import WordPieceTokenizer
        if not model_dir:
            raise SystemExit("seed tokenizer requires --model_name_or_path "
                             "pointing at a vocab.txt directory")
        return WordPieceTokenizer.from_vocab_file(model_dir)
    from transformers import AutoTokenizer
    if model_dir:
        try:
            return AutoTokenizer.from_pretrained(model_dir)
        except Exception:
            print(f"note: no tokenizer files in {model_dir}; falling back "
                  f"to {name!r}", file=sys.stderr)
    return AutoTokenizer.from_pretrained(name)


class TokenizerFactory:
    """``factory()`` loads the tokenizer :func:`_load_tokenizer` gives for
    (``name``, ``model_dir``). A picklable class, not a closure:
    ``preprocess`` hands it to spawned worker processes."""

    def __init__(self, name: str, model_dir: str | None = None):
        self.name = name
        self.model_dir = model_dir

    def __call__(self):
        return _load_tokenizer(self.name, self.model_dir)


def _parse_host_port(spec: str) -> tuple[str, int]:
    """``--http HOST:PORT`` → (host, port); a usage error exits. IPv6
    literals must be bracketed (``[::1]:8080``)."""
    host, sep, port = spec.rpartition(":")
    if not sep or not port.isdigit():
        raise SystemExit(f"--http expects HOST:PORT (got {spec!r}), "
                         "e.g. 127.0.0.1:8080 or [::1]:8080")
    if ":" in host and not (host.startswith("[") and host.endswith("]")):
        raise SystemExit(f"--http IPv6 hosts must be bracketed (got "
                         f"{spec!r}), e.g. [::1]:8080")
    port_num = int(port)
    if not 0 <= port_num <= 65535:
        raise SystemExit(f"--http port {port_num} out of range [0, 65535]")
    return host.strip("[]") or "127.0.0.1", port_num


def _offset2id_lookup(data_dir, stem):
    """offset → real-id array from ``<stem>.pickle`` (MS MARCO
    preprocessing: a pickled {id: offset} dict) or the text ``<stem>``
    (DPR: ``id\\toffset`` lines); None when no map exists. Offsets are
    0..N−1, so an array is exact."""
    import numpy as np
    if not data_dir:
        return None
    pkl = os.path.join(data_dir, stem + ".pickle")
    txt = os.path.join(data_dir, stem)
    if os.path.exists(pkl):
        with open(pkl, "rb") as f:
            mapping = pickle.load(f)
    elif os.path.exists(txt):
        mapping = {}
        with open(txt) as f:
            for line in f:
                a, b = line.split("\t")
                mapping[int(a)] = int(b)
    else:
        return None
    if not mapping:
        return None
    offs = np.fromiter(mapping.values(), np.int64, len(mapping))
    reals = np.fromiter(mapping.keys(), np.int64, len(mapping))
    arr = np.full(offs.max() + 1, -1, np.int64)
    arr[offs] = reals
    return arr


def _write_ranking(out, qids, pids, scores, with_scores: bool,
                   fmt: str = "msmarco", id_prefix: str = "",
                   run_tag: str = "ance_tpu") -> None:
    """``msmarco``: ``qid\\tpid\\trank[\\tscore]``; ``trec``: ``qid Q0
    <id_prefix>pid rank score tag``. A −1 pid ends a query's list."""
    for qid, prow, srow in zip(qids, pids, scores):
        for rank, (pid, sc) in enumerate(zip(prow, srow), start=1):
            if pid < 0:
                break
            if fmt == "trec":
                out.write(f"{int(qid)} Q0 {id_prefix}{int(pid)} {rank} "
                          f"{float(sc):.6f} {run_tag}\n")
                continue
            line = f"{int(qid)}\t{id_prefix}{int(pid)}\t{rank}"
            if with_scores:
                line += f"\t{float(sc):.6f}"
            out.write(line + "\n")


def _model_spec(model_type: str):
    from ance_tpu_torch.models.registry import get_model_spec
    try:
        return get_model_spec(model_type)
    except KeyError as e:
        raise SystemExit(str(e))


def _training_spec(args):
    """The model type's registry entry for a command that trains; exits
    for one that does not train."""
    spec = _model_spec(args.model_type)
    if not spec.trainable:
        raise SystemExit(f"--model_type {spec.name} encodes, searches and "
                         f"mines only: training it is out of scope")
    return spec


def _body_method(model, spec):
    """The unbound method that encodes passages: MaxP's chunked encode, or
    the model's ``body_emb`` (the BiEncoder's context tower)."""
    return type(model).body_emb_multichunk if spec.multichunk \
        else type(model).body_emb


def _build_model(args, device, seed: int = 0, warn_random: bool = True):
    """Registry model at the requested dtype (seeded init), moved to
    ``device``. Weights come from the newest complete checkpoint under
    ``--training_dir`` / ``--init_model_dir`` where the command has them,
    else from ``--model_name_or_path``: an HF-layout directory, a
    checkpoint directory, or a training directory (its newest complete
    checkpoint, as the JAX CLI warm-starts); else they stay random (serve
    warns). A checkpoint is the port's or the JAX package's, msgpack or
    orbax (``train/checkpoint.py::load_params``). Returns (spec, model,
    params_source, checkpoint): ``checkpoint`` is the checkpoint directory
    loaded, or None when the weights came from elsewhere."""
    import torch
    from ance_tpu_torch.train import checkpoint as ckpt
    spec = _model_spec(args.model_type)
    overrides = json.loads(args.encoder_overrides) \
        if args.encoder_overrides else None
    model = spec.build(dtype=torch.bfloat16 if args.bf16 else torch.float32,
                       attention_impl=args.attention,
                       config_overrides=overrides, seed=seed)
    path, _ = ckpt.get_latest_checkpoint(
        getattr(args, "training_dir", None),
        getattr(args, "init_model_dir", None))
    src = args.model_name_or_path
    holds_weights = bool(src) and ckpt.holds_weights(src)
    if not (path and ckpt.is_complete(path)) and src and os.path.isdir(src) \
            and not holds_weights:
        path, _ = ckpt.get_latest_checkpoint(src)  # a training directory
    if not (path and ckpt.is_complete(path)):
        path = None
    if path:
        params_source = ckpt.load_params(path, model, spec.adapt_weights)
    elif holds_weights:
        params_source = ckpt.load_params(src, model, spec.adapt_weights)
    else:
        params_source = "<random-init>"
        if warn_random:
            print("WARNING: serve found no torch checkpoint under "
                  "--training_dir/--init_model_dir/--model_name_or_path — "
                  "serving RANDOM encoder weights; rankings will be garbage "
                  "unless this is a smoke test", file=sys.stderr)
    return spec, model.to(device), params_source, path


def cmd_serve(args):
    import numpy as np
    import torch
    from ance_tpu_torch.data.cache import TokenCache
    from ance_tpu_torch.index.flat import FlatIPIndex
    from ance_tpu_torch.index.ivf import IVFIPIndex
    from ance_tpu_torch.train.encode import encode_cache, make_encode_fn
    from ance_tpu_torch.utils.device import resolve_device

    if not args.queries and not args.query_cache and not args.http:
        raise SystemExit("serve needs a query source: --queries (raw TSV), "
                         "--query_cache (tokenized cache), or --http "
                         "(online mode)")
    if not args.emb_prefix and not args.data_dir and not args.load_index:
        raise SystemExit("serve needs a corpus source: --emb_prefix (infer "
                         "dump), --data_dir (token cache to encode), or "
                         "--load_index (saved index)")
    if args.index != "ivf" and (args.nlist is not None or args.nprobe != 8):
        raise SystemExit("--nlist/--nprobe apply to --index ivf only")
    if args.index == "ivf" and args.quantize == "rows":
        raise SystemExit("--quantize rows applies to the flat index only "
                         "(per-row scales cannot fold into the query); use "
                         "--quantize dims with ivf")

    device = resolve_device(args.device)
    spec, model, params_source, _ = _build_model(args, device)

    if args.load_index:
        # the file carries its own kind (flat: 'emb', ivf: 'bins_emb')
        lp = args.load_index if args.load_index.endswith(".npz") \
            else args.load_index + ".npz"
        with np.load(lp, allow_pickle=False) as z:
            is_ivf = "bins_emb" in z.files
        if is_ivf:
            index = IVFIPIndex.load(
                args.load_index, device=device,
                nprobe=args.nprobe if args.nprobe != 8 else None)
        else:
            index = FlatIPIndex.load(args.load_index, device=device)
        e2id = np.load(args.load_index + ".ids.npy").astype(np.int64)
        if len(e2id) != index.ntotal:
            raise SystemExit("saved index and its .ids.npy sidecar disagree")
        return _serve_with_index(args, spec, model, params_source, index,
                                 e2id, "real", device)
    if args.emb_prefix:
        from ance_tpu_torch.evaluation.offline import load_embedding_shards
        emb = load_embedding_shards(args.emb_prefix)
        e2id = load_embedding_shards(args.emb_id_prefix) \
            if args.emb_id_prefix else None
        if emb is None or e2id is None:
            raise SystemExit("missing embedding shards under --emb_prefix/"
                             "--emb_id_prefix")
        e2id = e2id.astype(np.int64)
    else:
        bfn = make_encode_fn(model, _body_method(model, spec), device)
        with TokenCache(args.data_dir + "/passages") as pc:
            emb, e2id = encode_cache(bfn, pc, args.per_device_eval_batch_size,
                                     multichunk=spec.multichunk)

    # embedding rows carry cache OFFSETS; the scorer needs real passage ids
    off2pid = _offset2id_lookup(args.data_dir, "pid2offset")
    pid_space = "real"
    if off2pid is not None:
        e2id = np.asarray(e2id, np.int64)
        if e2id.size and (e2id.min() < 0 or e2id.max() >= len(off2pid)):
            raise SystemExit("embedding ids not covered by pid2offset — "
                             "emb dump and --data_dir disagree")
        e2id = off2pid[e2id]
        if (e2id < 0).any():
            raise SystemExit("embedding ids not covered by pid2offset — "
                             "emb dump and --data_dir disagree")
    else:
        pid_space = "offset"
        print("WARNING: no pid2offset map found under --data_dir; emitted "
              "pids are cache offsets (equal to real pids only when the "
              "collection ids are already 0..N-1 in file order)",
              file=sys.stderr)

    dtype = torch.bfloat16 if args.bf16 else torch.float32
    quantize = False if args.quantize == "none" else args.quantize
    if args.index == "ivf":
        index = IVFIPIndex(dim=emb.shape[1], nlist=args.nlist,
                           nprobe=args.nprobe, dtype=dtype, device=device,
                           quantize=quantize)
        index.add(emb)  # streams the corpus in chunks
    else:
        index = FlatIPIndex(dim=emb.shape[1], device=device, dtype=dtype,
                            quantize=quantize)
        if args.quantize == "rows":
            index.add(emb)  # per-row scales need the corpus-global pass
        else:
            index.add_chunked(emb)  # never stages the whole fp32 corpus
    if args.save_index:
        index.save(args.save_index)
        np.save(args.save_index + ".ids.npy", np.asarray(e2id, np.int64))
        print(f"saved index ({index.ntotal} rows) to "
              f"{args.save_index}.npz", file=sys.stderr)
    return _serve_with_index(args, spec, model, params_source, index, e2id,
                             pid_space, device)


def _serve_with_index(args, spec, model, params_source, index, e2id,
                      pid_space, device):
    from ance_tpu_torch.serve import Retriever
    from ance_tpu_torch.train.encode import make_encode_fn

    tokenizer = None
    if not args.query_cache:
        try:
            tokenizer = _load_tokenizer(spec.tokenizer_name,
                                        args.model_name_or_path)
        # BaseException: a tokenizer that cannot load may raise SystemExit;
        # HTTP mode still serves token arrays without one
        except BaseException as e:
            if not args.http or isinstance(e, KeyboardInterrupt):
                raise
            print(f"WARNING: no tokenizer ({e}); HTTP mode will accept "
                  "token arrays (ids/mask) only", file=sys.stderr)
    retriever = Retriever(make_encode_fn(model, type(model).query_emb,
                                         device),
                          index, embedding2id=e2id, tokenizer=tokenizer,
                          max_query_length=args.max_query_length)

    if args.http:
        from ance_tpu_torch.serve_http import RetrieverHTTPServer
        host, port = _parse_host_port(args.http)
        server = RetrieverHTTPServer(retriever, host=host, port=port,
                                     pid_space=pid_space,
                                     default_k=args.topk,
                                     pad_token_id=model.config.pad_token_id,
                                     allow_reload=args.allow_reload)
        addr = server.address
        print(json.dumps({"serving": f"http://{addr[0]}:{addr[1]}",
                          "params": params_source,
                          "ntotal": int(index.ntotal),
                          "pid_space": pid_space}), flush=True)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            server.shutdown()
        return

    out = open(args.output, "w", encoding="utf-8") if args.output \
        else sys.stdout
    B = args.per_device_eval_batch_size
    n_q = 0
    try:
        if args.query_cache:
            n_q = _rank_query_cache(args, retriever, out, B)
        else:
            n_q = _rank_query_tsv(args, retriever, out, B)
    finally:
        if args.output:
            out.close()
    if args.output:
        print(json.dumps({"queries": n_q, "topk": args.topk,
                          "corpus_rows": int(index.ntotal),
                          "params": params_source, "pid_space": pid_space,
                          "output": args.output}))


def _rank_query_cache(args, retriever, out, B) -> int:
    from ance_tpu_torch.data.cache import TokenCache
    from ance_tpu_torch.train.encode import iter_cache_batches

    # cache keys are offsets; this split's real qids come from the
    # per-split map (qid2offset.pickle is overwritten per split)
    qdir = os.path.dirname(args.query_cache) or "."
    qstem = os.path.basename(args.query_cache)
    off2qid = (_offset2id_lookup(qdir, f"{qstem}_qid2offset")
               if qstem else None)
    fallback = off2qid is None
    if fallback:
        off2qid = _offset2id_lookup(qdir, "qid2offset")
    n_q = 0
    with TokenCache(args.query_cache) as qc:
        if off2qid is not None and (len(qc) > len(off2qid)
                                    or (off2qid[:len(qc)] < 0).any()):
            print("WARNING: qid2offset map does not cover "
                  f"{args.query_cache} ({len(qc)} rows) — it likely "
                  "belongs to another split; emitting cache offsets",
                  file=sys.stderr)
            off2qid = None
        elif off2qid is not None and fallback:
            print("note: using generic qid2offset.pickle for "
                  f"{args.query_cache} (no per-split map found); verify it "
                  "matches this split", file=sys.stderr)
        if off2qid is None:
            print("WARNING: no usable qid2offset map next to --query_cache; "
                  "emitted qids are cache offsets", file=sys.stderr)
        for keys, ids, mask in iter_cache_batches(qc, B):
            scores, pids = retriever.search_tokens(ids[:len(keys)],
                                                   mask[:len(keys)],
                                                   args.topk)
            qids = keys if off2qid is None else \
                [int(off2qid[k]) for k in keys]
            _write_ranking(out, qids, pids, scores, args.with_scores,
                           args.format, args.id_prefix, args.run_tag)
            n_q += len(keys)
    return n_q


def _rank_query_tsv(args, retriever, out, B) -> int:
    rows = []
    # utf-8-sig: a BOM would make the first qid fail the digit test
    with open(args.queries, encoding="utf-8-sig") as f:
        for lineno, line in enumerate(f, 1):
            if not line.strip():
                continue
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 2 or not parts[0].lstrip("-").isdigit():
                if lineno == 1 and parts and parts[0].strip().lower() in (
                        "qid", "query_id", "id", "queryid"):
                    print(f"note: skipping header line in {args.queries}",
                          file=sys.stderr)
                    continue
                raise SystemExit(f"{args.queries}:{lineno}: expected "
                                 f"'qid\\ttext', got {line.rstrip()!r}")
            rows.append(parts)
    for s in range(0, len(rows), B):
        chunk = rows[s:s + B]
        scores, pids = retriever.search([r[1] for r in chunk], args.topk)
        _write_ranking(out, [int(r[0]) for r in chunk], pids, scores,
                       args.with_scores, args.format, args.id_prefix,
                       args.run_tag)
    return len(rows)


def _distributed(args):
    """(device, mesh) for a training command: one device, or this rank's
    card and the mesh of ``--num_processes`` ranks (module docstring).
    Prints ``{"dist": ...}`` when a group starts."""
    from ance_tpu_torch.core.mesh import initialize_distributed, make_mesh
    from ance_tpu_torch.utils.device import resolve_device
    device = resolve_device(args.device)
    if (args.num_processes or 1) > 1 and not args.data_parallel:
        # without the mesh's collectives each rank would silently train
        # its own diverging replica
        raise SystemExit(f"multi-host {args.command} requires data "
                         "parallelism (drop --no_data_parallel)")
    initialize_distributed(args.coordinator_address, args.num_processes,
                           args.process_id, device=device,
                           backend=args.dist_backend)
    mesh = make_mesh(device)
    if mesh is None:
        return device, None
    print(json.dumps({"dist": {"backend": mesh.backend, "rank": mesh.rank,
                               "world": mesh.world,
                               "device": str(mesh.device)}}), flush=True)
    return mesh.device, mesh


def _ranks_agree(mesh, model) -> None:
    """At a multi-rank command's end: raise unless every rank holds the
    same parameters, and return once rank 0's last checkpoint is whole."""
    if mesh is not None:
        mesh.check_replicated(dict(model.named_parameters()))
        mesh.barrier()


def _eval_grid(args):
    """(device, data axis, model axis) of a generator command
    (``ance_tpu/cli.py``'s ``_eval_mesh``): one device, with no axes, for
    one process; else this rank's card and its place in a (data, model)
    grid of ``--num_processes`` ranks, tp = ``--tensor_parallel`` model
    ranks a data rank (model axis None at tp 1). An eval batch that does
    not split over the data ranks runs whole and unsharded on every rank
    (a data axis of one rank each, no model axis), as the JAX CLI falls
    back to one device. Prints ``{"dist": ...}`` when a group starts."""
    import dataclasses
    from ance_tpu_torch.core.mesh import initialize_distributed, make_mesh
    from ance_tpu_torch.core.tp import make_mesh_2d
    from ance_tpu_torch.utils.device import resolve_device
    device = resolve_device(args.device)
    world, tp = args.num_processes or 1, max(1, args.tensor_parallel)
    if world > 1 and world % tp:
        raise SystemExit(f"--tensor_parallel {tp} does not divide "
                         f"{world} devices")
    initialize_distributed(args.coordinator_address, args.num_processes,
                           args.process_id, device=device,
                           backend=args.dist_backend)
    mesh = make_mesh(device)
    if mesh is None:
        return device, None, None
    dp = world // tp
    model_axis = None
    if args.per_device_eval_batch_size % dp:
        print(f"WARNING: eval batch {args.per_device_eval_batch_size} not "
              f"divisible by {dp} data-parallel ranks; every rank encodes "
              "it whole, and rank 0 writes", file=sys.stderr, flush=True)
        data_axis = dataclasses.replace(mesh, rank=0, world=1,
                                        global_rank=mesh.rank)
    elif tp > 1:
        data_axis, model_axis = make_mesh_2d(tp, dp, device=device)
    else:
        data_axis = mesh
    print(json.dumps({"dist": {
        "backend": mesh.backend, "rank": mesh.rank, "world": mesh.world,
        "device": str(mesh.device), "data": data_axis.rank,
        "model": model_axis.rank if model_axis else 0,
        "tp": model_axis.world if model_axis else 1}}), flush=True)
    return mesh.device, data_axis, model_axis


def _build_eval_model(args, device, model_axis):
    """:func:`_build_model` for a generator command, the encoder's weights
    sharded over ``model_axis`` (``core/tp.py``) when there is one."""
    spec, model, _, ckpt_path = _build_model(args, device, warn_random=False)
    if model_axis is not None:
        from ance_tpu_torch.core.tp import shard_params_tp, validate_tp
        validate_tp(model.config, model_axis)
        shard_params_tp(model, model_axis)
    return spec, model, ckpt_path


def _make_training(args, model, spec, mesh=None):
    """(state, train step) for ``train``, as ``ance_tpu/cli.py``'s
    ``_make_training`` builds them, on one device or ``mesh``."""
    from ance_tpu_torch.optim.schedules import warmup_cosine, warmup_linear
    from ance_tpu_torch.train.dpr_trainer import make_dpr_train_step
    from ance_tpu_torch.train.trainer import (init_train_state,
                                              make_optimizer,
                                              make_train_step,
                                              triplet_loss_fn)
    if args.rewarmup_per_dataset:
        # the reference's default scheduler (a fresh warmup per ann-data
        # file, run_ann.py:210-215); ours is its --single_warmup
        if args.single_warmup:
            raise SystemExit("--single_warmup and --rewarmup_per_dataset "
                             "are mutually exclusive")
        if args.lr_style != "linear":
            raise SystemExit("--rewarmup_per_dataset implies the linear "
                             "schedule (the reference rebuilds "
                             "get_linear_schedule_with_warmup)")
        opt = make_optimizer(model, args.optimizer, args.learning_rate,
                             eps=args.adam_epsilon,
                             weight_decay=args.weight_decay,
                             max_grad_norm=args.max_grad_norm,
                             rewarmup=(args.warmup_steps, args.max_steps))
    else:
        sched_fn = warmup_cosine if args.lr_style == "cosine" \
            else warmup_linear
        opt = make_optimizer(model, args.optimizer,
                             sched_fn(args.learning_rate, args.warmup_steps,
                                      args.max_steps),
                             eps=args.adam_epsilon,
                             weight_decay=args.weight_decay,
                             max_grad_norm=args.max_grad_norm)
    if spec.loss == "dpr_inbatch":
        # accumulation keeps the global softmax (the GradCache step), so
        # the published DPR configs' large batches fit in micro-batch
        # memory (reference run_ann_dpr.py:65, 226)
        step = make_dpr_train_step(
            accum_steps=args.gradient_accumulation_steps, mesh=mesh,
            multichunk=spec.multichunk)
    else:
        step = make_train_step(
            triplet_loss_fn(multichunk=spec.multichunk,
                            fused_body=args.fused_body),
            accum_steps=args.gradient_accumulation_steps, mesh=mesh)
    return init_train_state(model, opt), step


def cmd_preprocess(args):
    """Raw MS MARCO TSVs → token caches, id maps and offset-space qrels
    (``ance preprocess``); prints the size of each id map."""
    from ance_tpu_torch.data.preprocess import PreprocessConfig, preprocess
    spec = _model_spec(args.model_type)
    cfg = PreprocessConfig(
        data_dir=args.data_dir, out_data_dir=args.out_data_dir,
        data_type=args.data_type, max_seq_length=args.max_seq_length,
        max_query_length=args.max_query_length,
        max_doc_character=args.max_doc_character,
        num_processes=args.num_processes)
    result = preprocess(cfg, TokenizerFactory(spec.tokenizer_name,
                                              args.model_name_or_path))
    print(json.dumps({k: len(v) if isinstance(v, dict) else v
                      for k, v in result.items()}))


def cmd_warmup(args):
    """The BM25-triples warmup (``ance warmup``, the reference's
    run_warmup.py) on one device or a rank's stripe of the lines: resume
    from the newest complete checkpoint in ``--output_dir``, skipping the
    batches it trained, train off ``--train_file``, and evaluate dev MRR
    every ``--eval_steps`` with ``--evaluate_during_training``."""
    from ance_tpu_torch.train import checkpoint as ckpt
    from ance_tpu_torch.train.warmup import WarmupConfig, run_warmup

    if args.evaluate_during_training and not args.data_dir:
        raise SystemExit("--evaluate_during_training needs --data_dir (with "
                         "collection.tsv, queries.dev.small.tsv, top1000.dev "
                         "and qrels.dev.small.tsv)")
    _training_spec(args)
    device, mesh = _distributed(args)
    spec, model, _, _ = _build_model(args, device, seed=args.seed,
                                     warn_random=False)
    state, step = _make_training(args, model, spec, mesh)
    tokenizer = TokenizerFactory(spec.tokenizer_name,
                                 args.model_name_or_path)()

    eval_fn = None
    if args.evaluate_during_training:
        from ance_tpu_torch.evaluation.mrr_eval import passage_dist_eval
        from ance_tpu_torch.train.encode import make_encode_fn
        d = args.data_dir

        def eval_fn(model):
            model.eval()
            return passage_dist_eval(
                query_encode_fn=make_encode_fn(model, type(model).query_emb,
                                               device),
                body_encode_fn=make_encode_fn(model, type(model).body_emb,
                                              device),
                tokenizer=tokenizer,
                queries_path=os.path.join(d, "queries.dev.small.tsv"),
                collection_path=os.path.join(d, "collection.tsv"),
                top1000_path=os.path.join(d, "top1000.dev"),
                qrels_path=os.path.join(d, "qrels.dev.small.tsv"),
                max_query_length=args.max_query_length,
                max_seq_length=args.max_seq_length, device=device)

    cfg = WarmupConfig(num_epochs=args.num_train_epochs,
                       batch_size=args.per_device_train_batch_size,
                       max_seq_length=args.max_seq_length,
                       max_steps=args.max_steps, save_steps=args.save_steps,
                       eval_every=args.eval_steps,
                       checkpoint_dir=args.output_dir,
                       host_id=mesh.rank if mesh else 0,
                       num_hosts=mesh.world if mesh else 1,
                       log_trust_ratios=args.log_trust_ratios)
    # a preempted warmup resumes instead of restarting (reference
    # run_warmup.py:144-163)
    state, start_step = ckpt.resume_train_state(args.output_dir, state)
    if start_step:
        print(f"warmup: resuming from step {start_step}", file=sys.stderr)
    state, history = run_warmup(cfg, state=state, train_step=step,
                                tokenizer=tokenizer,
                                triples_path=args.train_file, seed=args.seed,
                                eval_fn=eval_fn, start_step=start_step)
    _ranks_agree(mesh, state.model)
    print(json.dumps(history[-3:]))


def cmd_train(args):
    """The trainer job (``ance train``, the reference's run_ann.py and, for
    DPR, run_ann_dpr.py): poll ``--ann_dir``, or train ``--num_epoch``
    epochs over ``{data_dir}/train-data`` (DPR), and checkpoint into
    ``--output_dir``; on one device or data-parallel over the ranks (the
    summary then names the backend, and rank 0 writes the checkpoints)."""
    import time

    import torch
    from ance_tpu_torch.data.cache import TokenCache
    from ance_tpu_torch.data.feed import expand_triples, sample_one_neg_triples
    from ance_tpu_torch.train.ance_loop import AnceCycleConfig, run_trainer_job

    dpr = _training_spec(args).loss == "dpr_inbatch"
    if args.num_epoch > 0 and not dpr:
        raise SystemExit("--num_epoch is the DPR trainer's fixed-epoch mode; "
                         "use --model_type dpr")
    if args.num_epoch <= 0 and not args.ann_dir:
        raise SystemExit("--ann_dir is required unless --num_epoch > 0")
    device, mesh = _distributed(args)
    spec, model, params_source, _ = _build_model(args, device,
                                                 seed=args.seed,
                                                 warn_random=False)
    state, step = _make_training(args, model, spec, mesh)
    record = {"loss": [], "grad_norm": [], "step_ms": []}
    last = [time.perf_counter()]

    def recorded(state, batch, generator):
        state, metrics = step(state, batch, generator)
        # reading the loss waits for the step, as the JAX job's per-step
        # read of its step counter does
        record["loss"].append(float(metrics["loss"]))
        record["grad_norm"].append(float(metrics["grad_norm"]))
        now = time.perf_counter()
        record["step_ms"].append((now - last[0]) * 1000.0)
        last[0] = now
        return state, metrics

    generator = torch.Generator().manual_seed(args.seed)
    history = None
    with TokenCache(args.data_dir + "/train-query") as qc, \
            TokenCache(args.data_dir + "/passages") as pc:
        if args.num_epoch > 0:
            # the fixed-epoch alternative to polling (reference
            # run_ann_dpr.py:179-211)
            from ance_tpu_torch.train.dpr_trainer import (evaluate_dev,
                                                          run_dpr_epochs)
            dev_eval_fn = None
            if args.dev_data:
                # the dev triples' qids are offsets into dev-query (the
                # reference's evaluate_dev opens it); the JAX CLI passes
                # train-query here (ROADMAP Queue 3)
                def dev_eval_fn(model):
                    with TokenCache(args.data_dir + "/dev-query") as dc:
                        return evaluate_dev(
                            model, dc, pc, args.dev_data,
                            batch_size=args.per_device_train_batch_size)
            state, history = run_dpr_epochs(
                state=state, train_step=recorded, generator=generator,
                query_cache=qc, passage_cache=pc,
                train_data_path=args.data_dir + "/train-data",
                num_epochs=args.num_epoch,
                batch_size=args.per_device_train_batch_size,
                shuffle_seed=args.seed, dev_eval_fn=dev_eval_fn,
                checkpoint_dir=args.output_dir, mesh=mesh)
        else:
            cycle_cfg = AnceCycleConfig(
                batch_size=args.per_device_train_batch_size,
                shuffle_seed=args.seed, feed_workers=args.feed_workers)
            state = run_trainer_job(
                cycle_cfg, state=state, train_step=recorded,
                generator=generator, query_cache=qc, passage_cache=pc,
                ann_dir=args.ann_dir, training_dir=args.output_dir,
                max_steps=args.max_steps, save_every=args.save_steps,
                rewarmup_per_dataset=args.rewarmup_per_dataset,
                triples_fn=sample_one_neg_triples if dpr else expand_triples,
                mesh=mesh)
    summary = {"steps": state.step, "params": params_source,
               "checkpoint": os.path.join(args.output_dir,
                                          f"checkpoint-{state.step}"),
               **record}
    if history is not None:
        summary["history"] = history
    _ranks_agree(mesh, state.model)
    if mesh is not None:
        summary["dist"] = {"backend": mesh.backend, "rank": mesh.rank,
                           "world": mesh.world, "params_replicated": True}
    print(json.dumps(summary))


def cmd_generate(args, inference_only: bool = False):
    """One generator pass (``ance generate``; ``infer`` with
    ``inference_only``) with the weights :func:`_build_model` loads, on
    one device or over a grid of ranks (:func:`_eval_grid`). The handoff
    files cite the checkpoint directory they came from, or ``<init>`` when
    they came from no checkpoint."""
    import numpy as np
    from ance_tpu_torch.data.cache import TokenCache
    from ance_tpu_torch.train.ance_loop import (load_offset_qrels,
                                                positives_from_qrels)
    from ance_tpu_torch.train.ann_gen import AnnGenConfig, generate_new_ann
    from ance_tpu_torch.train.encode import make_encode_fn

    device, mesh, model_axis = _eval_grid(args)
    spec, model, ckpt_path = _build_eval_model(args, device, model_axis)
    qfn = make_encode_fn(model, type(model).query_emb, device)
    bfn = make_encode_fn(model, _body_method(model, spec), device)
    gen_cfg = AnnGenConfig(topk_training=args.topk_training,
                           negative_sample=args.negative_sample,
                           ann_chunk_factor=args.ann_chunk_factor,
                           ann_measure_topk_mrr=args.ann_measure_topk_mrr,
                           multichunk=spec.multichunk,
                           index_quantize=args.index_quantize,
                           encode_batch_size=args.per_device_eval_batch_size)
    train_qrels = load_offset_qrels(args.data_dir + "/train-qrel.tsv")
    dev_qrels = load_offset_qrels(args.data_dir + "/dev-qrel.tsv")
    with TokenCache(args.data_dir + "/dev-query") as dev_c, \
            TokenCache(args.data_dir + "/passages") as pass_c, \
            TokenCache(args.data_dir + "/train-query") as train_c:
        result = generate_new_ann(
            gen_cfg, output_num=args.output_num,
            checkpoint_path=ckpt_path or "<init>",
            query_encode_fn=qfn, body_encode_fn=bfn,
            dev_query_cache=dev_c, passage_cache=pass_c,
            train_query_cache=train_c,
            training_query_positive_id=positives_from_qrels(train_qrels),
            dev_query_positive_id=dev_qrels, output_dir=args.output_dir,
            device=device, inference_only=inference_only, mesh=mesh)
    if not inference_only:
        print(json.dumps({"dev_ndcg": result["dev_ndcg"],
                          "ann_mrr": result["ann_mrr"],
                          "data_path": result["data_path"],
                          "checkpoint": ckpt_path or "<init>",
                          "seconds": result["seconds"]}))
        return
    # the embeddings in the reference's shard layout (its --inference mode
    # stops after the encode, run_ann_data_gen.py:256-257): the passages as
    # the index holds them, as ``ance infer`` writes them
    from ance_tpu_torch.evaluation.offline import save_embedding_shard
    index = result["index"]
    # the index's rows, gathered from every data rank's shard
    passages = index._global_rows(index._emb).cpu().numpy()
    prefix = os.path.join(args.output_dir, f"step{args.output_num}")
    arrays = {
        "passages": ("_passage_emb_p_", passages),
        "passage_ids": ("_passage_embid_p_",
                        np.asarray(result["passage_embedding2id"])),
        "dev_query": ("_dev_query_emb_p_", result["dev_query_embedding"]),
        "dev_query_ids": ("_dev_query_embid_p_",
                          result["dev_query_embedding2id"])}
    if mesh is None or mesh.writer:
        os.makedirs(args.output_dir, exist_ok=True)
        for suffix, a in arrays.values():
            save_embedding_shard(prefix + suffix, a)
    if mesh is not None:
        mesh.barrier()  # the shards are whole before any rank goes on
    print(json.dumps({k: f"{prefix}{suffix}_data_obj_0.npy"
                      for k, (suffix, _) in arrays.items()}))


def cmd_preprocess_dpr(args):
    """psgs_w100.tsv and the NQ / TriviaQA files → caches, ``-ann`` /
    ``-data`` files and ``pid2offset`` (``ance preprocess-dpr``); prints
    the count of each split."""
    from ance_tpu_torch.data.dpr import DprPreprocessConfig, preprocess_dpr
    spec = _model_spec(args.model_type)
    cfg = DprPreprocessConfig(
        wiki_dir=args.wiki_dir, question_dir=args.question_dir,
        answer_dir=args.answer_dir, out_data_dir=args.out_data_dir,
        data_type=args.data_type, max_seq_length=args.max_seq_length,
        num_processes=args.num_processes)
    result = preprocess_dpr(cfg, TokenizerFactory(spec.tokenizer_name,
                                                  args.model_name_or_path))
    print(json.dumps({k: len(v) if isinstance(v, dict) else v
                      for k, v in result.items()}))


def cmd_generate_dpr(args):
    """One DPR generator pass (``ance generate-dpr``) with the weights
    :func:`_build_model` loads: the test questions' top-k hit curves, the
    train questions' answer-filtered negatives, then
    ``ann_training_data_<n>`` and ``ann_ndcg_<n>``, on one device or over
    a grid of ranks (:func:`_eval_grid`). The test answers come from
    ``{data_dir}/test-ann`` where it exists, else ``--test_qas``."""
    from ance_tpu_torch.data.cache import TokenCache
    from ance_tpu_torch.data.dpr import (load_answers, load_mapping,
                                         load_passage_texts,
                                         load_positive_ids, load_qas_answers)
    from ance_tpu_torch.train.dpr_gen import generate_new_ann_dpr
    from ance_tpu_torch.train.encode import make_encode_fn

    device, mesh, model_axis = _eval_grid(args)
    spec, model, ckpt_path = _build_eval_model(args, device, model_axis)
    pid2offset, _ = load_mapping(args.data_dir, "pid2offset")
    raw = load_passage_texts(args.wiki_path)
    passage_texts = {pid2offset[p]: t for p, t in raw.items()
                     if p in pid2offset}
    test_ann = args.data_dir + "/test-ann"
    test_answers = load_answers(test_ann) if os.path.exists(test_ann) \
        else load_qas_answers(args.test_qas)
    with TokenCache(args.data_dir + "/train-query") as tq, \
            TokenCache(args.data_dir + "/test-query") as te, \
            TokenCache(args.data_dir + "/trivia-test-query") as tr, \
            TokenCache(args.data_dir + "/passages") as pc:
        result = generate_new_ann_dpr(
            output_num=args.output_num,
            checkpoint_path=ckpt_path or "<init>",
            query_encode_fn=make_encode_fn(model, type(model).query_emb,
                                           device),
            body_encode_fn=make_encode_fn(model, _body_method(model, spec),
                                          device),
            train_query_cache=tq, test_query_cache=te,
            trivia_test_query_cache=tr, passage_cache=pc,
            passage_texts=passage_texts,
            train_answers=load_answers(args.data_dir + "/train-ann"),
            test_answers=test_answers,
            trivia_test_answers=load_qas_answers(args.trivia_qas),
            training_query_positive_id=load_positive_ids(
                args.data_dir + "/train-data"),
            output_dir=args.output_dir, device=device,
            topk_training=args.topk_training,
            negative_sample=args.negative_sample,
            encode_batch_size=args.per_device_eval_batch_size,
            index_quantize=args.index_quantize, mesh=mesh)
    print(json.dumps({k: result[k] for k in (
        "top20", "top100", "top20_trivia", "top100_trivia", "data_path",
        "ndcg_path", "seconds")} | {"checkpoint": ckpt_path or "<init>"}))


def cmd_ance_loop(args):
    """The single-program pipelined refresh (``ance ance-loop``) on one
    device or replicated over the ranks: resume from ``--output_dir`` where
    a checkpoint is complete (the port's, or the JAX ``ance-loop``'s orbax
    or msgpack one: parameters, optimizer, step and refresh), bootstrap, train ``--max_steps`` with a
    refresh work item every ``--train_steps_per_slice`` steps, optionally
    serve the live index over HTTP (one rank only), then save a final
    checkpoint (rank 0)."""
    import numpy as np
    import torch
    from ance_tpu_torch.data.cache import TokenCache
    from ance_tpu_torch.train import checkpoint as ckpt
    from ance_tpu_torch.train.ance_loop import load_offset_qrels
    from ance_tpu_torch.train.pipelined import PipelineConfig, PipelinedAnce
    from ance_tpu_torch.utils.observability import MetricsLogger

    if args.http and (args.num_processes or 1) > 1:
        # a search from one rank's server thread would start collectives
        # the other ranks never join: the whole job would hang
        raise SystemExit("ance-loop --http is single-host only; on a "
                         "multi-host mesh run `serve` against exported "
                         "checkpoints/index instead")
    _training_spec(args)
    device, mesh = _distributed(args)
    spec, model, _, _ = _build_model(args, device, seed=args.seed,
                                     warn_random=False)
    state, step = _make_training(args, model, spec, mesh)
    cfg = PipelineConfig(
        train_steps_per_slice=args.train_steps_per_slice,
        encode_slice_size=args.encode_slice_size,
        encode_batch_size=args.per_device_eval_batch_size,
        batch_size=args.per_device_train_batch_size,
        topk_training=args.topk_training,
        negative_sample=args.negative_sample,
        ann_chunk_factor=args.ann_chunk_factor,
        search_chunk_queries=args.search_chunk_queries,
        multichunk=spec.multichunk, shuffle_seed=args.seed,
        feed_workers=args.feed_workers,
        index_quantize=args.index_quantize,
        rewarmup_per_dataset=args.rewarmup_per_dataset,
        checkpoint_dir=args.output_dir, save_every=args.save_steps,
        log_trust_ratios=args.log_trust_ratios,
        host_id=mesh.rank if mesh else 0,
        num_hosts=mesh.world if mesh else 1)
    train_qrels = load_offset_qrels(args.data_dir + "/train-qrel.tsv")
    dev_qrels = load_offset_qrels(args.data_dir + "/dev-qrel.tsv")
    metrics = None
    if cfg.host_id == 0:
        metrics = MetricsLogger(os.path.join(args.output_dir,
                                             "refresh.jsonl"))
    with TokenCache(args.data_dir + "/passages") as pc, \
            TokenCache(args.data_dir + "/train-query") as tq, \
            TokenCache(args.data_dir + "/dev-query") as dq:
        loop = PipelinedAnce(
            cfg, state=state, train_step=step,
            generator=torch.Generator().manual_seed(args.seed),
            query_method=type(model).query_emb,
            body_method=_body_method(model, spec),
            passage_cache=pc, train_query_cache=tq, dev_query_cache=dq,
            train_qrels=train_qrels, dev_qrels=dev_qrels, device=device,
            mesh=mesh, metrics_logger=metrics)
        resumed = loop.resume()
        remaining = max(0, args.max_steps - resumed)
        server = None
        if args.http and remaining <= 0:
            raise SystemExit(
                "ance-loop --http: training is already complete (resumed "
                f"step {resumed} >= max_steps {args.max_steps}) — the "
                "server would bootstrap a full refresh and then exit "
                "immediately; use `serve` for the final checkpoint")
        if args.http:
            # train and serve in one program: queries answer against the
            # live refreshing index with the loop's own snapshot
            from ance_tpu_torch.serve import LoopRetriever
            from ance_tpu_torch.serve_http import RetrieverHTTPServer
            if loop.index is None:
                loop.bootstrap()  # serving needs the initial refresh
            off2pid = _offset2id_lookup(args.data_dir, "pid2offset")
            if off2pid is not None:
                # a stale pid2offset must fail loudly, not IndexError or
                # serve unretrievable -1 pids
                if len(off2pid) < len(pc) or \
                        (off2pid[:len(pc)] < 0).any():
                    raise SystemExit("pid2offset does not cover the "
                                     "passages cache — stale preprocess "
                                     "artifacts under --data_dir?")
                base = off2pid[np.arange(len(pc))]
            else:
                base = np.arange(len(pc))
            tokenizer = None
            try:
                tokenizer = _load_tokenizer(spec.tokenizer_name,
                                            args.model_name_or_path)
            except BaseException as e:
                if isinstance(e, KeyboardInterrupt):
                    raise
                print(f"WARNING: no tokenizer ({e}); live serving accepts "
                      "token arrays only", file=sys.stderr)
            retriever = LoopRetriever(
                loop, tokenizer=tokenizer,
                max_query_length=args.max_query_length,
                embedding2id=np.repeat(base.astype(np.int64),
                                       loop._rows_per_record or 1))
            host, port = _parse_host_port(args.http)
            server = RetrieverHTTPServer(
                retriever, host=host, port=port,
                pid_space="real" if off2pid is not None else "offset",
                pad_token_id=model.config.pad_token_id).start()
            addr = server.address
            print(json.dumps({"live_serving": f"http://{addr[0]}:{addr[1]}",
                              "ntotal": int(loop.index.ntotal)}), flush=True)
        try:
            loop.run(remaining)
        finally:
            if server is not None:
                server.shutdown()
        loop.flush_checkpoints()
        if cfg.host_id == 0:
            ckpt.save_checkpoint(args.output_dir, loop.state.step,
                                 loop.state.model,
                                 loop.state.optimizer.state_dict())
        _ranks_agree(mesh, loop.state.model)
    if metrics is not None:
        metrics.close()
    print(json.dumps(loop.history[-3:]))


def cmd_seed_pretrain(args):
    """SEED-Encoder pretraining (``ance seed-pretrain``): MLM + the
    CLS-bottleneck decoder over ``{data_dir}/passages`` on one device or
    data-parallel over the ranks, checkpoints into ``--output_dir`` (rank
    0); prints the last three history entries. The tokenizer's pad id is
    the model's, as in the JAX CLI."""
    import torch
    from ance_tpu_torch.data.cache import TokenCache
    from ance_tpu_torch.data.wordpiece import SeedTokenizer
    from ance_tpu_torch.models.seed import (SeedDecoderConfig,
                                            SeedForMaskedLM,
                                            seed_encoder_config)
    from ance_tpu_torch.models.transformer import init_weights
    from ance_tpu_torch.optim.schedules import warmup_cosine, warmup_linear
    from ance_tpu_torch.train.seed_pretrain import (SeedPretrainConfig,
                                                    make_seed_pretrain_step,
                                                    run_seed_pretrain)
    from ance_tpu_torch.train.trainer import init_train_state, make_optimizer

    if not args.model_name_or_path:
        raise SystemExit("seed-pretrain needs --model_name_or_path: the "
                         "directory of its vocab.txt")
    if args.rewarmup_per_dataset or args.gradient_accumulation_steps != 1:
        raise SystemExit("seed-pretrain takes one schedule and one step a "
                         "batch (no --rewarmup_per_dataset or "
                         "--gradient_accumulation_steps), as `ance "
                         "seed-pretrain`")
    device, mesh = _distributed(args)
    tok = SeedTokenizer.from_vocab_file(args.model_name_or_path)
    vocab_size = len(tok.vocab)
    overrides = json.loads(args.encoder_overrides) \
        if args.encoder_overrides else {}
    ecfg = seed_encoder_config(
        vocab_size, dtype=torch.bfloat16 if args.bf16 else torch.float32,
        attention_impl=args.attention, pad_token_id=tok.pad_token_id,
        **overrides)
    dcfg = SeedDecoderConfig(
        num_layers=args.decoder_layers,
        attention_window=args.decoder_atten_window,
        hidden_size=ecfg.hidden_size, num_heads=ecfg.num_heads,
        intermediate_size=ecfg.intermediate_size)
    model = SeedForMaskedLM(ecfg, dcfg)
    init_weights(model, ecfg, torch.Generator().manual_seed(args.seed))
    model = model.to(device)
    sched_fn = warmup_cosine if args.lr_style == "cosine" else warmup_linear
    opt = make_optimizer(model, args.optimizer,
                         sched_fn(args.learning_rate, args.warmup_steps,
                                  args.max_steps),
                         eps=args.adam_epsilon,
                         weight_decay=args.weight_decay,
                         max_grad_norm=args.max_grad_norm)
    ratio = tuple(float(x) for x in args.train_ratio.split(":"))
    cfg = SeedPretrainConfig(
        num_epochs=args.num_train_epochs,
        batch_size=args.per_device_train_batch_size,
        mask_prob=args.mask_prob, max_steps=args.max_steps,
        save_steps=args.save_steps, log_every=args.log_every,
        checkpoint_dir=args.output_dir, seed=args.seed,
        host_id=mesh.rank if mesh else 0,
        num_hosts=mesh.world if mesh else 1)
    special_ids = [tok.cls_token_id, tok.sep_token_id, tok.pad_token_id,
                   tok.unk_token_id, tok.mask_token_id]
    with TokenCache(args.data_dir + "/passages") as cache:
        state, history = run_seed_pretrain(
            cfg, state=init_train_state(model, opt),
            train_step=make_seed_pretrain_step(ratio, mesh), cache=cache,
            generator=torch.Generator().manual_seed(args.seed),
            mask_token_id=tok.mask_token_id, vocab_size=vocab_size,
            special_ids=special_ids, pad_token_id=tok.pad_token_id)
    _ranks_agree(mesh, state.model)
    print(json.dumps(history[-3:]))


def cmd_export_hf(args):
    """Export the newest complete checkpoint under ``--training_dir`` (or
    the ``--init_model_dir`` checkpoint), the port's or the JAX package's,
    as ``ance export-hf`` does: an HF ``from_pretrained`` directory
    (``rdot_nll*``); for ``dpr``, a ``CheckpointState`` file
    ``<out_dir>/checkpoint-<step>`` whose ``offset`` is the step; for
    ``seeddot_nll``, ``<out_dir>/pytorch_model.bin`` in the reference's
    fairseq names, of a ``seeddot_nll`` checkpoint or of a
    ``seed-pretrain`` one (then with its decoder and LM head). Prints what
    was exported, from where, at which step."""
    from ance_tpu_torch.train import checkpoint as ckpt
    spec = _model_spec(args.model_type)
    path, step = ckpt.get_latest_checkpoint(args.training_dir or "",
                                            args.init_model_dir)
    if path is None or not ckpt.is_complete(path):
        raise SystemExit(
            "export-hf: no complete checkpoint under --training_dir/"
            "--init_model_dir — refusing to export a random init")
    if step == 0:
        # --init_model_dir reports step 0: the real one is in meta.json,
        # else in the directory's name
        meta_path = os.path.join(path, "meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                step = int(json.load(f).get("step", 0))
        else:
            step = ckpt.checkpoint_no(path)
    sd, _ = ckpt.state_dict(path)
    try:
        out = spec.export(args.out_dir, sd, step,
                          json.loads(args.encoder_overrides or "{}"))
    except (KeyError, ValueError) as e:
        raise SystemExit(f"export-hf: {path}: {e}")
    print(json.dumps({"exported": out, "from": path, "step": step,
                      "model_type": args.model_type}))


def cmd_eval(args):
    from ance_tpu_torch.evaluation.msmarco_eval import \
        compute_metrics_from_files
    metrics = compute_metrics_from_files(args.reference, args.candidate)
    for k in sorted(metrics):
        print(f"{k}: {metrics[k]}")


def _load_id_map(path: str) -> dict:
    """A preprocess ``*2offset.pickle`` map ({real id: cache offset})."""
    with open(path, "rb") as f:
        return pickle.load(f)


def cmd_eval_full(args):
    """Offline eval over dumped embedding shards: full ranking, or with
    ``--candidates`` the BM25-candidate rerank (notebook cell 11)."""
    from ance_tpu_torch.evaluation.offline import (full_ranking_eval,
                                                   load_embedding_shards,
                                                   rerank_eval)
    from ance_tpu_torch.train.ance_loop import load_offset_qrels
    from ance_tpu_torch.utils.device import resolve_device
    device = resolve_device(args.device)
    q = load_embedding_shards(args.query_prefix)
    q_ids = load_embedding_shards(args.query_id_prefix)
    p = load_embedding_shards(args.passage_prefix)
    p_ids = load_embedding_shards(args.passage_id_prefix)
    if any(x is None for x in (q, q_ids, p, p_ids)):
        raise SystemExit("missing embedding shards")
    qrels = load_offset_qrels(args.qrels)
    if not args.candidates:
        print(json.dumps(full_ranking_eval(q, q_ids, p, p_ids, qrels,
                                           topn=args.topn, device=device)))
        return
    # candidate files carry REAL ids, embeddings cache offsets: map through
    # the preprocess pickles with --data_dir, else the candidates must be
    # offset-space already
    from ance_tpu_torch.evaluation.mrr_eval import parse_top_dev
    cand = parse_top_dev(args.candidates)
    if args.data_dir:
        pid2off = _load_id_map(os.path.join(args.data_dir,
                                            "pid2offset.pickle"))
        qmap_path = os.path.join(args.data_dir,
                                 f"{args.query_split}_qid2offset.pickle")
        if not os.path.exists(qmap_path):  # pre-per-split-map layouts
            qmap_path = os.path.join(args.data_dir, "qid2offset.pickle")
        qid2off = _load_id_map(qmap_path)
        cand = {qid2off[qid]: [pid2off[p] for p in pids if p in pid2off]
                for qid, pids in cand.items() if qid in qid2off}
    print(json.dumps(rerank_eval(q, q_ids, p, p_ids, cand, qrels,
                                 k=args.rerank_depth, device=device)))


def _add_common_model_flags(p, device: bool = True):
    if device:
        p.add_argument("--device", default="cuda",
                       help="cuda[:N] (default) or cpu (CPU tests only)")
    p.add_argument("--model_type", default="rdot_nll",
                   help="registry key (rdot_nll | rdot_nll_multi_chunk | "
                        "dpr | seeddot_nll)")
    p.add_argument("--model_name_or_path", default=None,
                   help="weights: an HF-layout dir (pytorch_model.bin), a "
                        "checkpoint dir or a training dir (the port's or "
                        "the JAX package's msgpack); and the tokenizer "
                        "source")
    p.add_argument("--max_seq_length", type=int, default=128)
    p.add_argument("--max_query_length", type=int, default=64)
    p.add_argument("--bf16", action="store_true",
                   help="bf16 encoder compute (and, for serve, a bf16 index)")
    p.add_argument("--attention", default="auto",
                   choices=["auto", "xla", "xla_bf16", "fused", "flash"],
                   help="auto: on a CUDA device xla (bf16 softmax under "
                        "--bf16) below seq 256, the fused kernel for 256-1024, "
                        "the flash kernel beyond; on the CPU always xla. "
                        "Attention dropout > 0 in training takes xla")
    p.add_argument("--encoder_overrides", default=None,
                   help="JSON overriding encoder-config fields, e.g. "
                        "'{\"num_layers\": 2, \"hidden_size\": 64}' or "
                        "'{\"attention_dropout\": 0.0}' (MaxP training "
                        "through the fused kernels)")


def _add_train_flags(p):
    p.add_argument("--optimizer", default="lamb", choices=["lamb", "adamw"])
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--adam_epsilon", type=float, default=1e-8)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--warmup_steps", type=int, default=1000)
    p.add_argument("--max_steps", type=int, default=100000)
    p.add_argument("--rewarmup_per_dataset", action="store_true",
                   help="reset the LR warmup at every ann-data swap with "
                        "the new file's size as decay horizon — the "
                        "reference's default scheduler (run_ann.py:210-215)")
    p.add_argument("--single_warmup", action="store_true",
                   help="one global schedule for the whole run (reference "
                        "--single_warmup); already the default, rejected "
                        "with --rewarmup_per_dataset")
    p.add_argument("--lr_style", default="linear", choices=["linear", "cosine"])
    p.add_argument("--per_device_train_batch_size", type=int, default=32)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--feed_workers", type=int, default=8,
                   help="gather threads for the triple feed (order-identical "
                        "to serial; 0 = serial gathers)")
    p.add_argument("--fused_body", action="store_true",
                   help="encode pos+neg as ONE [2B, S] pass (equal without "
                        "dropout; wider GEMMs)")
    p.add_argument("--data_parallel", action="store_true", default=True)
    p.add_argument("--no_data_parallel", dest="data_parallel",
                   action="store_false")
    _add_dist_flags(p)


def _add_dist_flags(p):
    # one process a rank, a rank one card (the reference's per-GPU
    # torch.distributed.launch, run_ann.py:603-646)
    p.add_argument("--coordinator_address", default=None,
                   help="host:port of rank 0 (with --num_processes > 1)")
    p.add_argument("--num_processes", type=int, default=None,
                   help="ranks in the job, one process and one card each")
    p.add_argument("--process_id", type=int, default=None,
                   help="this process's rank")
    p.add_argument("--dist_backend", default=None, choices=["nccl", "gloo"],
                   help="collectives: nccl (the default on CUDA; one rank "
                        "a card) or gloo (the CPU's default; ranks that "
                        "share a card)")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="ance_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("preprocess", help="MS MARCO raw TSV → binary caches")
    _add_common_model_flags(p, device=False)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--out_data_dir", required=True)
    p.add_argument("--data_type", type=int, default=1,
                   help="0 = doc, 1 = passage (reference flag)")
    p.add_argument("--max_doc_character", type=int, default=10000)
    p.add_argument("--num_processes", type=int, default=32,
                   help="spawned tokenizer workers (1: in this process)")
    p.set_defaults(fn=cmd_preprocess)

    p = sub.add_parser("preprocess-dpr",
                       help="DPR wiki / question files → binary caches")
    _add_common_model_flags(p, device=False)
    p.add_argument("--wiki_dir", required=True, help="holds psgs_w100.tsv")
    p.add_argument("--question_dir", required=True,
                   help="holds {nq,trivia}-{train,dev}.json")
    p.add_argument("--answer_dir", required=True,
                   help="holds nq-test.csv and trivia-test.csv")
    p.add_argument("--out_data_dir", required=True)
    p.add_argument("--data_type", type=int, default=0,
                   help="0 = NQ, 1 = TriviaQA, 2 = both")
    p.add_argument("--num_processes", type=int, default=16,
                   help="spawned tokenizer workers (1: in this process)")
    p.set_defaults(fn=cmd_preprocess_dpr)

    p = sub.add_parser("warmup", help="BM25-triples warmup training")
    _add_common_model_flags(p)
    _add_train_flags(p)
    p.add_argument("--train_file", required=True,
                   help="triples.train.small.tsv")
    p.add_argument("--num_train_epochs", type=int, default=1)
    p.add_argument("--save_steps", type=int, default=5000)
    p.add_argument("--output_dir", required=True,
                   help="checkpoint-<step>/ directories; a rerun resumes "
                        "from the newest complete one")
    p.add_argument("--evaluate_during_training", action="store_true")
    p.add_argument("--eval_steps", type=int, default=0,
                   help="steps between in-train MRR evals")
    p.add_argument("--log_trust_ratios", action="store_true",
                   help="LAMB trust-ratio stats every --eval_steps")
    p.add_argument("--data_dir", default=None,
                   help="dir with collection.tsv/queries.dev.small.tsv/"
                        "top1000.dev/qrels.dev.small.tsv for eval")
    p.set_defaults(fn=cmd_warmup)

    p = sub.add_parser("train", help="ANCE trainer (polls ann_dir)")
    _add_common_model_flags(p)
    _add_train_flags(p)
    p.add_argument("--data_dir", required=True,
                   help="token caches: {data_dir}/train-query and "
                        "{data_dir}/passages")
    p.add_argument("--ann_dir", default=None,
                   help="where ann_training_data_<n> / ann_ndcg_<n> appear")
    p.add_argument("--output_dir", required=True,
                   help="checkpoint-<step>/ directories go here")
    p.add_argument("--save_steps", type=int, default=10000)
    p.add_argument("--num_epoch", type=int, default=0,
                   help="DPR fixed-epoch mode: train this many epochs over "
                        "{data_dir}/train-data instead of polling ann_dir "
                        "(reference run_ann_dpr.py:179-191)")
    p.add_argument("--dev_data", default=None,
                   help="dev triples file for a dev NLL / accuracy "
                        "evaluation after each epoch, its qids offsets "
                        "into {data_dir}/dev-query (reference "
                        "run_ann_dpr.py:196-211)")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("serve", help="batch retrieval serving: encoder + "
                                     "exact index → qid\\tpid\\trank rankings")
    _add_common_model_flags(p)
    p.add_argument("--training_dir", default=None,
                   help="serve the newest complete checkpoint-<step> "
                        "(the port's or the JAX package's) under this "
                        "directory")
    p.add_argument("--init_model_dir", default=None,
                   help="checkpoint directory used when --training_dir "
                        "holds no complete checkpoint")
    p.add_argument("--data_dir", default=None,
                   help="token-cache dir; encodes {data_dir}/passages when "
                        "no --emb_prefix is given")
    p.add_argument("--emb_prefix", default=None,
                   help="corpus embedding shard prefix from `ance infer`")
    p.add_argument("--emb_id_prefix", default=None)
    p.add_argument("--queries", default=None,
                   help="raw TSV (qid\\ttext); tokenized on the fly")
    p.add_argument("--query_cache", default=None,
                   help="pre-tokenized query cache (offsets become qids)")
    p.add_argument("--topk", type=int, default=10)
    p.add_argument("--index", default="flat", choices=["flat", "ivf"],
                   help="flat = exact search; ivf = approximate (clustered) "
                        "search over the probed clusters")
    p.add_argument("--nlist", type=int, default=None,
                   help="IVF cluster count (default √N)")
    p.add_argument("--nprobe", type=int, default=8,
                   help="IVF clusters searched per query (recall/speed knob)")
    p.add_argument("--quantize", default="none",
                   choices=["none", "dims", "rows"],
                   help="int8 corpus storage (dims folds scales into the "
                        "query; rows searches by scan)")
    p.add_argument("--save_index", default=None,
                   help="persist the built index (+ .ids.npy sidecar)")
    p.add_argument("--load_index", default=None,
                   help="serve from a saved index (either package's)")
    p.add_argument("--with_scores", action="store_true")
    p.add_argument("--format", default="msmarco", choices=["msmarco", "trec"])
    p.add_argument("--id_prefix", default="")
    p.add_argument("--run_tag", default="ance_tpu")
    p.add_argument("--output", default=None, help="ranking TSV (else stdout)")
    p.add_argument("--per_device_eval_batch_size", type=int, default=128)
    p.add_argument("--http", default=None, metavar="HOST:PORT",
                   help="serve online over HTTP instead of ranking a batch")
    p.add_argument("--allow_reload", action="store_true",
                   help="enable POST /reload (trusted networks only)")
    p.set_defaults(fn=cmd_serve)

    for name, inference in (("generate", False), ("infer", True)):
        p = sub.add_parser(name, help="ANN data generation (one pass)"
                           if not inference else "encode and dump "
                           "embedding shards")
        _add_common_model_flags(p)
        p.add_argument("--data_dir", required=True,
                       help="token caches passages, train-query, dev-query "
                            "and train-qrel.tsv / dev-qrel.tsv")
        p.add_argument("--training_dir", required=True,
                       help="encode with the newest complete "
                            "checkpoint-<step> here")
        p.add_argument("--init_model_dir", default=None)
        p.add_argument("--output_dir", required=True)
        p.add_argument("--output_num", type=int, default=0)
        p.add_argument("--topk_training", type=int, default=500)
        p.add_argument("--negative_sample", type=int, default=5)
        p.add_argument("--ann_chunk_factor", type=int, default=5)
        p.add_argument("--ann_measure_topk_mrr", action="store_true")
        p.add_argument("--index_quantize", default=None, choices=["dims"],
                       help="an int8 corpus index (per-dimension scales)")
        p.add_argument("--per_device_eval_batch_size", type=int, default=128)
        p.add_argument("--tensor_parallel", type=int, default=1,
                       help="shard the encoder weights Megatron-style over "
                            "this many ranks (core/tp.py); requires "
                            "--attention xla and divisible head counts")
        _add_dist_flags(p)
        p.set_defaults(fn=lambda a, inf=inference: cmd_generate(a, inf))

    p = sub.add_parser("generate-dpr",
                       help="DPR ANN generation (answer-filtered mining)")
    _add_common_model_flags(p)
    p.add_argument("--data_dir", required=True,
                   help="preprocess-dpr's output: caches, train-ann, "
                        "train-data, pid2offset")
    p.add_argument("--wiki_path", required=True, help="psgs_w100.tsv")
    p.add_argument("--test_qas", default=None,
                   help="nq-test.csv: the test answers where "
                        "{data_dir}/test-ann does not exist")
    p.add_argument("--trivia_qas", default=None, help="trivia-test.csv")
    p.add_argument("--training_dir", required=True,
                   help="encode with the newest complete "
                        "checkpoint-<step> here")
    p.add_argument("--init_model_dir", default=None)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--output_num", type=int, default=0)
    p.add_argument("--topk_training", type=int, default=100)
    p.add_argument("--negative_sample", type=int, default=20)
    p.add_argument("--index_quantize", default=None, choices=["dims"],
                   help="an int8 corpus index (per-dimension scales): a "
                        "quarter of the fp32 index's bytes")
    p.add_argument("--per_device_eval_batch_size", type=int, default=128)
    p.add_argument("--tensor_parallel", type=int, default=1,
                   help="shard the encoder weights Megatron-style over "
                        "this many ranks (core/tp.py)")
    _add_dist_flags(p)
    p.set_defaults(fn=cmd_generate_dpr)

    p = sub.add_parser("ance-loop",
                       help="single-program pipelined refresh: train, "
                            "refresh the index slice by slice, mine, serve")
    _add_common_model_flags(p)
    _add_train_flags(p)
    p.add_argument("--data_dir", required=True,
                   help="token caches passages, train-query, dev-query "
                        "and train-qrel.tsv / dev-qrel.tsv")
    p.add_argument("--output_dir", required=True,
                   help="checkpoint-<step>/ directories and refresh.jsonl")
    p.add_argument("--train_steps_per_slice", type=int, default=8)
    p.add_argument("--encode_slice_size", type=int, default=65536)
    p.add_argument("--topk_training", type=int, default=500)
    p.add_argument("--negative_sample", type=int, default=5)
    p.add_argument("--ann_chunk_factor", type=int, default=5)
    p.add_argument("--search_chunk_queries", type=int, default=4096,
                   help="queries per search work item (bounds the gap a "
                        "search item inserts between train steps)")
    p.add_argument("--per_device_eval_batch_size", type=int, default=128)
    p.add_argument("--save_steps", type=int, default=0,
                   help="mid-run checkpoint cadence (0 = at refresh "
                        "boundaries only); restarts resume automatically")
    p.add_argument("--log_trust_ratios", action="store_true",
                   help="LAMB trust-ratio stats in each refresh entry")
    p.add_argument("--index_quantize", default=None, choices=["dims"],
                   help="an int8 index (a quarter of fp32's bytes); its "
                        "per-dim scales are taken from each cycle's first "
                        "slice")
    p.add_argument("--http", default=None, metavar="HOST:PORT",
                   help="train and serve in one program: answer /search "
                        "against the live refreshing index with the loop's "
                        "snapshot weights")
    p.set_defaults(fn=cmd_ance_loop)

    p = sub.add_parser("seed-pretrain",
                       help="SEED-Encoder pretraining: MLM + CLS-bottleneck "
                            "decoder over {data_dir}/passages")
    _add_common_model_flags(p)
    _add_train_flags(p)
    p.add_argument("--data_dir", required=True,
                   help="preprocessed dir whose passages cache is the "
                        "pretraining corpus")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--num_train_epochs", type=int, default=1)
    p.add_argument("--save_steps", type=int, default=10000)
    p.add_argument("--mask_prob", type=float, default=0.15)
    p.add_argument("--train_ratio", default="0.5:0.5",
                   help="MLM:decoder loss weights "
                        "(configuration_seed_encoder.py:92)")
    p.add_argument("--decoder_layers", type=int, default=3,
                   help="1 or 3 (shipped SEED configs)")
    p.add_argument("--decoder_atten_window", type=int, default=2,
                   help="decoder local-attention span (2 or 8)")
    p.add_argument("--log_every", type=int, default=100)
    p.set_defaults(fn=cmd_seed_pretrain)

    p = sub.add_parser("export-hf",
                       help="export a checkpoint (the port's or the JAX "
                            "package's) as an HF from_pretrained directory; "
                            "for dpr a CheckpointState file; for seeddot_nll "
                            "a fairseq-named pytorch_model.bin")
    _add_common_model_flags(p, device=False)
    p.add_argument("--training_dir", default=None,
                   help="trainer output dir — exports the LATEST complete "
                        "checkpoint")
    p.add_argument("--init_model_dir", default=None,
                   help="a specific checkpoint dir to export")
    p.add_argument("--out_dir", required=True)
    p.set_defaults(fn=cmd_export_hf)

    p = sub.add_parser("eval", help="official MS MARCO MRR scorer")
    p.add_argument("reference")
    p.add_argument("candidate")
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("eval-full", help="offline eval over dumped "
                                         "embedding shards")
    p.add_argument("--device", default="cuda",
                   help="cuda[:N] (default) or cpu (CPU tests only)")
    p.add_argument("--query_prefix", required=True)
    p.add_argument("--query_id_prefix", required=True)
    p.add_argument("--passage_prefix", required=True)
    p.add_argument("--passage_id_prefix", required=True)
    p.add_argument("--qrels", required=True,
                   help="offset-space qrels tsv (train/dev-qrel.tsv)")
    p.add_argument("--topn", type=int, default=1000)
    p.add_argument("--candidates", default=None,
                   help="BM25 candidate file (top1000.dev) → rerank mode")
    p.add_argument("--data_dir", default=None,
                   help="preprocess output dir whose pid2offset/qid2offset "
                        "pickles map the candidates' real ids to offsets")
    p.add_argument("--query_split", default="dev-query",
                   help="query cache stem whose qid map applies to "
                        "--candidates")
    p.add_argument("--rerank_depth", type=int, default=10)
    p.set_defaults(fn=cmd_eval_full)
    return parser


def main(argv=None):
    from ance_tpu_torch.train.checkpoint import UnreadableCheckpoint
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except UnreadableCheckpoint as e:
        raise SystemExit(str(e))
    finally:
        dist = sys.modules.get("torch.distributed")
        if dist is not None and dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
