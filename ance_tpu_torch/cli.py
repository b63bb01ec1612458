"""Command line of the torch port: ``python -m ance_tpu_torch.cli
{serve,train}``.

Counterpart of ``ance_tpu/cli.py``'s ``serve`` and ``train`` subcommands,
with the same flags plus ``--device`` (default ``cuda``; asking for CUDA
where none exists exits, it never carries on on the CPU). The other
subcommands wait for later PRs (ROADMAP Queue 1 #6).

``serve`` batch mode writes ``qid\\tpid\\trank[\\tscore]`` lines in real id
space, as the JAX CLI does; ``--http HOST:PORT`` serves the JSON API of
:mod:`ance_tpu_torch.serve_http` instead. ``train`` is the ANCE trainer
job: it polls ``--ann_dir`` for ann data and writes ``checkpoint-<step>``
directories to ``--output_dir``, then prints one JSON line of its
per-step losses, gradient norms and step times.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys


def _load_tokenizer(name: str, model_dir: str | None):
    """HF tokenizer from ``model_dir``, else the registry's ``name``
    (a weights-only directory carries no tokenizer files)."""
    from transformers import AutoTokenizer
    if model_dir:
        try:
            return AutoTokenizer.from_pretrained(model_dir)
        except Exception:
            print(f"note: no tokenizer files in {model_dir}; falling back "
                  f"to {name!r}", file=sys.stderr)
    return AutoTokenizer.from_pretrained(name)


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


def _has_torch_checkpoint(model_dir: str) -> bool:
    return any(f.endswith((".bin", ".pt")) and f != "training_args.bin"
               for f in os.listdir(model_dir))


def _has_native_checkpoint(model_dir: str) -> bool:
    return (os.path.exists(os.path.join(model_dir, "params.msgpack"))
            or os.path.isdir(os.path.join(model_dir, "state"))
            or any(f.startswith("checkpoint-") for f in os.listdir(model_dir)))


def _build_model(args, device, seed: int = 0, warn_random: bool = True):
    """Registry model at the requested dtype (seeded init), moved to
    ``device``. Weights come from the newest complete port checkpoint under
    ``--training_dir`` / ``--init_model_dir`` where the command has them,
    else from an HF-layout ``--model_name_or_path`` directory (or the
    newest complete checkpoint of a training directory there, as the JAX
    CLI warm-starts), else stay random (serve warns). Returns (spec,
    model, params_source)."""
    import torch
    from ance_tpu_torch.models.registry import get_model_spec
    from ance_tpu_torch.models.weights import load_pretrained
    from ance_tpu_torch.train import checkpoint as ckpt
    try:
        spec = get_model_spec(args.model_type)
    except KeyError as e:
        raise SystemExit(str(e))
    overrides = json.loads(args.encoder_overrides) \
        if args.encoder_overrides else None
    model = spec.build(dtype=torch.bfloat16 if args.bf16 else torch.float32,
                       attention_impl=args.attention,
                       config_overrides=overrides, seed=seed)
    path, _ = ckpt.get_latest_checkpoint(
        getattr(args, "training_dir", None),
        getattr(args, "init_model_dir", None))
    src = args.model_name_or_path
    if not (path and ckpt.is_complete(path)) and src and os.path.isdir(src) \
            and not _has_torch_checkpoint(src):
        path, _ = ckpt.get_latest_checkpoint(src)  # a training directory
    if path and ckpt.is_complete(path):
        if not os.path.exists(os.path.join(path, ckpt.MODEL_FILE)):
            raise SystemExit(f"{path} holds no {ckpt.MODEL_FILE}: a native "
                             "(msgpack/orbax) checkpoint, which the torch "
                             "port does not read — export it with `ance "
                             "export-hf`")
        params_source = load_pretrained(model, path)
    elif src and os.path.isdir(src) and _has_torch_checkpoint(src):
        params_source = load_pretrained(model, src)
    elif src and os.path.isdir(src) and _has_native_checkpoint(src):
        raise SystemExit(f"{src} holds a native (msgpack/orbax) checkpoint; "
                         "the torch port loads HF-layout pytorch_model.bin "
                         "directories only — export it with `ance export-hf` "
                         "(native checkpoints: ROADMAP Queue 1 #4)")
    else:
        params_source = "<random-init>"
        if warn_random:
            print("WARNING: serve found no torch checkpoint under "
                  "--training_dir/--init_model_dir/--model_name_or_path — "
                  "serving RANDOM encoder weights; rankings will be garbage "
                  "unless this is a smoke test", file=sys.stderr)
    return spec, model.to(device), params_source


def cmd_serve(args):
    import numpy as np
    import torch
    from ance_tpu_torch.data.cache import TokenCache
    from ance_tpu_torch.index.flat import FlatIPIndex
    from ance_tpu_torch.models.dot_models import RobertaDot
    from ance_tpu_torch.train.encode import encode_cache, make_encode_fn
    from ance_tpu_torch.utils.device import resolve_device

    if args.index == "ivf":
        raise SystemExit("--index ivf is not yet ported to torch (ROADMAP "
                         "Queue 1 #10); use --index flat")
    if not args.queries and not args.query_cache and not args.http:
        raise SystemExit("serve needs a query source: --queries (raw TSV), "
                         "--query_cache (tokenized cache), or --http "
                         "(online mode)")
    if not args.emb_prefix and not args.data_dir and not args.load_index:
        raise SystemExit("serve needs a corpus source: --emb_prefix (infer "
                         "dump), --data_dir (token cache to encode), or "
                         "--load_index (saved index)")

    device = resolve_device(args.device)
    spec, model, params_source = _build_model(args, device)

    if args.load_index:
        lp = args.load_index if args.load_index.endswith(".npz") \
            else args.load_index + ".npz"
        with np.load(lp, allow_pickle=False) as z:
            if "bins_emb" in z.files:
                raise SystemExit(f"{lp} is an IVF index, not yet ported to "
                                 "torch (ROADMAP Queue 1 #10)")
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
        body = RobertaDot.body_emb_multichunk if spec.multichunk \
            else RobertaDot.body_emb
        bfn = make_encode_fn(model, body, device)
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

    index = FlatIPIndex(
        dim=emb.shape[1], device=device,
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
        quantize=False if args.quantize == "none" else args.quantize)
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
    from ance_tpu_torch.models.dot_models import RobertaDot
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
    retriever = Retriever(make_encode_fn(model, RobertaDot.query_emb, device),
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


def _make_training(args, model, spec):
    """(state, train step) for ``train``, as ``ance_tpu/cli.py``'s
    ``_make_training`` builds them on one device."""
    from ance_tpu_torch.optim.schedules import warmup_cosine, warmup_linear
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
    step = make_train_step(
        triplet_loss_fn(multichunk=spec.multichunk,
                        fused_body=args.fused_body),
        accum_steps=args.gradient_accumulation_steps)
    return init_train_state(model, opt), step


def cmd_train(args):
    """The ANCE trainer job (``ance train``, the reference's run_ann.py):
    poll ``--ann_dir``, train, checkpoint into ``--output_dir``."""
    import time

    import torch
    from ance_tpu_torch.data.cache import TokenCache
    from ance_tpu_torch.train.ance_loop import AnceCycleConfig, run_trainer_job
    from ance_tpu_torch.utils.device import resolve_device

    if args.num_epoch > 0:
        raise SystemExit("--num_epoch is the DPR trainer's fixed-epoch mode; "
                         "DPR is not ported to torch yet (ROADMAP Queue 1 #8)")
    if not args.ann_dir:
        raise SystemExit("--ann_dir is required unless --num_epoch > 0")
    device = resolve_device(args.device)
    spec, model, params_source = _build_model(args, device, seed=args.seed,
                                              warn_random=False)
    state, step = _make_training(args, model, spec)
    history = {"loss": [], "grad_norm": [], "step_ms": []}
    last = [time.perf_counter()]

    def on_step(n, metrics):
        # reading the loss waits for the step, as the JAX job's per-step
        # read of its step counter does
        history["loss"].append(float(metrics["loss"]))
        history["grad_norm"].append(float(metrics["grad_norm"]))
        now = time.perf_counter()
        history["step_ms"].append((now - last[0]) * 1000.0)
        last[0] = now

    cycle_cfg = AnceCycleConfig(batch_size=args.per_device_train_batch_size,
                                shuffle_seed=args.seed,
                                feed_workers=args.feed_workers)
    with TokenCache(args.data_dir + "/train-query") as qc, \
            TokenCache(args.data_dir + "/passages") as pc:
        state = run_trainer_job(
            cycle_cfg, state=state, train_step=step,
            generator=torch.Generator().manual_seed(args.seed),
            query_cache=qc, passage_cache=pc, ann_dir=args.ann_dir,
            training_dir=args.output_dir, max_steps=args.max_steps,
            save_every=args.save_steps,
            rewarmup_per_dataset=args.rewarmup_per_dataset, on_step=on_step)
    print(json.dumps({"steps": state.step, "params": params_source,
                      "checkpoint": os.path.join(
                          args.output_dir, f"checkpoint-{state.step}"),
                      **history}))


def _add_common_model_flags(p):
    p.add_argument("--device", default="cuda",
                   help="cuda[:N] (default) or cpu (CPU tests only)")
    p.add_argument("--model_type", default="rdot_nll",
                   help="registry key (rdot_nll | rdot_nll_multi_chunk)")
    p.add_argument("--model_name_or_path", default=None,
                   help="HF-layout checkpoint dir (pytorch_model.bin) / "
                        "tokenizer source")
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


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="ance_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
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
                   help="the DPR trainer's fixed-epoch mode: not ported "
                        "(exits)")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("serve", help="batch retrieval serving: encoder + "
                                     "exact index → qid\\tpid\\trank rankings")
    _add_common_model_flags(p)
    p.add_argument("--training_dir", default=None,
                   help="serve the newest complete checkpoint-<step> "
                        "(pytorch_model.bin) under this directory")
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
                   help="flat = exact search (ivf is not ported yet)")
    p.add_argument("--quantize", default="none",
                   choices=["none", "dims", "rows"],
                   help="int8 corpus storage (dims folds scales into the "
                        "query; rows searches by scan)")
    p.add_argument("--save_index", default=None,
                   help="persist the built flat index (+ .ids.npy sidecar)")
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
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
