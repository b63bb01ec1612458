"""The torch port never imports jax, flax, msgpack or regex, nor any module
of the JAX package, while it preprocesses, warms up, exports, serves,
trains, generates, serves through IVF (``serve --index ivf``) and HNSW,
runs the pipelined refresh (``ance-loop``), the DPR
commands (``preprocess-dpr``, ``train --num_epoch``, ``generate-dpr``,
``export-hf --model_type dpr``), SEED's (the seed-wordpiece tokenizer,
``preprocess --model_type seeddot_nll``, ``seed-pretrain``, ``export-hf
--model_type seeddot_nll``) and data parallelism (``core/mesh.py``, a
one-rank group through ``experiments/mesh_worker.py``), nor while the
learning demos (``experiments/demo*.py``) run. Checked in a fresh
interpreter, because
this test process already has jax (tests/conftest.py imports it)."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib, json, os, pkgutil, sys, tempfile
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import ance_tpu_torch
    mods = [m.name for m in pkgutil.walk_packages(ance_tpu_torch.__path__,
                                                  "ance_tpu_torch.")]
    for name in mods:
        importlib.import_module(name)
    assert "jax" not in sys.modules, "import pulled in jax"
    # tensor parallelism, the entry points and the demos are among them
    assert {"ance_tpu_torch.core.tp", "ance_tpu_torch.graft_entry",
            "ance_tpu_torch.experiments.demo",
            "ance_tpu_torch.experiments.demo_maxp",
            "ance_tpu_torch.experiments.demo_dpr"} <= set(mods)

    from ance_tpu_torch.data.cache import TokenCacheWriter
    from ance_tpu_torch.cli import main
    from ance_tpu_torch.models.registry import get_model_spec
    tiny = {"num_layers": 1, "hidden_size": 16, "num_heads": 2,
            "intermediate_size": 32, "vocab_size": 50,
            "max_position_embeddings": 20}
    d = tempfile.mkdtemp()
    rs = np.random.RandomState(0)
    for name, n, seq in (("passages", 40, 12), ("dev-query", 5, 6)):
        with TokenCacheWriter(f"{d}/{name}", seq) as w:
            for _ in range(n):
                toks = np.ones(seq, np.int32)
                toks[0] = 0
                toks[1:seq - 1] = rs.randint(3, 50, seq - 2)
                w.write(seq - 1, toks)
    model = get_model_spec("rdot_nll").build(config_overrides=tiny)
    torch.save(model.state_dict(), f"{d}/pytorch_model.bin")
    main(["serve", "--device", "cpu", "--model_name_or_path", d,
          "--encoder_overrides", json.dumps(tiny), "--data_dir", d,
          "--query_cache", f"{d}/dev-query", "--topk", "3",
          "--max_seq_length", "12", "--max_query_length", "6",
          "--output", f"{d}/rank.tsv"])
    assert len(open(f"{d}/rank.tsv").read().splitlines()) == 15
    # the approximate indexes: serve --index ivf (saved, then loaded), and
    # the HNSW indexer on the port's C++ core
    main(["serve", "--device", "cpu", "--model_name_or_path", d,
          "--encoder_overrides", json.dumps(tiny), "--data_dir", d,
          "--query_cache", f"{d}/dev-query", "--topk", "3",
          "--max_seq_length", "12", "--max_query_length", "6",
          "--index", "ivf", "--nlist", "4", "--nprobe", "2",
          "--save_index", f"{d}/ivf", "--output", f"{d}/ivf_rank.tsv"])
    assert len(open(f"{d}/ivf_rank.tsv").read().splitlines()) == 15
    assert "ance_tpu_torch.index.hnsw" in mods
    from ance_tpu_torch.index.hnsw import DenseHnswIndexer
    hnsw = DenseHnswIndexer(vector_sz=8, store_n=64)
    hnsw.index_data(list(range(30)), rs.randn(30, 8).astype(np.float32))
    assert len(hnsw.search_knn(rs.randn(2, 8).astype(np.float32), 3)[0][0]) \
        == 3

    # MaxP: documents of two 512-token chunks, one embedding row per chunk
    maxp = dict(tiny, max_position_embeddings=514)
    m = f"{d}/maxp"
    os.mkdir(m)
    with TokenCacheWriter(f"{m}/passages", 1024) as w:
        for n in (100, 700, 1024):
            toks = np.ones(1024, np.int32)
            toks[0] = 0
            toks[1:n] = rs.randint(3, 50, n - 1)
            w.write(n, toks)
    model = get_model_spec("rdot_nll_multi_chunk").build(
        config_overrides=maxp)
    torch.save(model.state_dict(), f"{m}/pytorch_model.bin")
    main(["serve", "--device", "cpu", "--model_type", "rdot_nll_multi_chunk",
          "--model_name_or_path", m, "--encoder_overrides", json.dumps(maxp),
          "--data_dir", m, "--query_cache", f"{d}/dev-query", "--topk", "3",
          "--max_query_length", "6", "--output", f"{m}/rank.tsv",
          "--save_index", f"{m}/index"])
    assert len(open(f"{m}/rank.tsv").read().splitlines()) == 15
    assert np.load(f"{m}/index.ids.npy").tolist() == [0, 0, 1, 1, 2, 2]

    # the trainer job: 2 steps over an ann file, then a checkpoint
    import shutil
    for suffix in ("", "_meta"):
        shutil.copy(f"{d}/dev-query{suffix}", f"{d}/train-query{suffix}")
    os.mkdir(f"{d}/ann")
    with open(f"{d}/ann/ann_training_data_0", "w") as f:
        f.writelines(f"{q}\\t{q}\\t{q + 10},{q + 20}\\n" for q in range(5))
    with open(f"{d}/ann/ann_ndcg_0", "w") as f:
        json.dump({"ndcg": 0.0}, f)
    main(["train", "--device", "cpu", "--encoder_overrides", json.dumps(tiny),
          "--data_dir", d, "--ann_dir", f"{d}/ann", "--output_dir",
          f"{d}/ckpt", "--max_steps", "2", "--per_device_train_batch_size",
          "4", "--max_query_length", "6"])
    assert os.path.exists(f"{d}/ckpt/checkpoint-2/DONE")

    # the generator job on that checkpoint, then the seq-128 mirror encoder
    for split in ("train", "dev"):
        with open(f"{d}/{split}-qrel.tsv", "w") as f:
            f.writelines(f"{q}\\t{q + 3}\\t1\\n" for q in range(5))
    main(["generate", "--device", "cpu", "--encoder_overrides",
          json.dumps(tiny), "--data_dir", d, "--training_dir", f"{d}/ckpt",
          "--output_dir", f"{d}/gen", "--output_num", "1",
          "--topk_training", "8", "--negative_sample", "2",
          "--ann_chunk_factor", "1", "--max_seq_length", "12",
          "--max_query_length", "6"])
    assert len(open(f"{d}/gen/ann_training_data_1").read().splitlines()) == 5
    assert json.load(open(f"{d}/gen/ann_ndcg_1"))["checkpoint"].endswith(
        "checkpoint-2")

    # the pipelined refresh: bootstrap, 4 steps with an item after each
    main(["ance-loop", "--device", "cpu", "--encoder_overrides",
          json.dumps(tiny), "--data_dir", d, "--output_dir", f"{d}/loop",
          "--max_steps", "4", "--per_device_train_batch_size", "4",
          "--max_query_length", "6", "--train_steps_per_slice", "1",
          "--encode_slice_size", "16", "--per_device_eval_batch_size", "8",
          "--topk_training", "8", "--negative_sample", "2",
          "--ann_chunk_factor", "1", "--feed_workers", "0"])
    assert len(open(f"{d}/loop/refresh.jsonl").read().splitlines()) == 1
    assert os.path.exists(f"{d}/loop/checkpoint-4/DONE")
    from ance_tpu_torch.experiments import perf_attn128 as exp
    params = exp.make_params(rs, layers=1, hidden=128, intermediate=64,
                             seq=8)
    ids, mask = exp.inputs(rs, 2, 8, "cpu", pad_from=6)
    for attn in exp.VARIANTS:
        assert exp.encoder(params, ids, mask, attn=attn,
                           heads=2).shape == (2, 128)
    from ance_tpu_torch.experiments import perf_topk_int8 as study
    g = torch.Generator().manual_seed(0)
    corpus = study.make_corpus(256, 16, g, "cpu")
    q, qs = study.make_queries(3, corpus["scales"], g)
    for fn in study.search_fns(q, qs, corpus, 4).values():
        assert fn()[1].shape == (3, 4)

    # SEED: the seed-wordpiece tokenizer (its C++ core), preprocess with
    # seeddot_nll, a tiny seed-pretrain and its fairseq export
    from ance_tpu_torch.data.wordpiece import SeedTokenizer
    s = f"{d}/seed"
    os.makedirs(f"{s}/raw")
    words = [f"s{i}" for i in range(20)]
    with open(f"{s}/vocab.txt", "w") as f:
        f.write("\\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
                           + words) + "\\n")
    tok = SeedTokenizer.from_vocab_file(s)
    assert tok.core == "native"
    assert tok.encode("S1 s2 zz") == [2, 6, 7, 1, 3]
    with open(f"{s}/raw/collection.tsv", "w") as f:
        f.writelines(f"{i}\\t" + " ".join(words[(i + j) % 20]
                                           for j in range(6)) + "\\n"
                     for i in range(20))
    for qf, rf in (("queries.train.tsv", "qrels.train.tsv"),
                   ("queries.dev.small.tsv", "qrels.dev.small.tsv")):
        with open(f"{s}/raw/{qf}", "w") as f, open(f"{s}/raw/{rf}", "w") as r:
            for q in range(4):
                f.write(f"{q}\\t{words[q]} {words[q + 1]}\\n")
                r.write(f"{q}\\t0\\t{q}\\t1\\n")
    main(["preprocess", "--model_type", "seeddot_nll", "--model_name_or_path",
          s, "--data_dir", f"{s}/raw", "--out_data_dir", f"{s}/data",
          "--max_seq_length", "12", "--max_query_length", "6",
          "--num_processes", "1"])
    main(["seed-pretrain", "--device", "cpu", "--model_name_or_path", s,
          "--encoder_overrides", json.dumps({
              "num_layers": 1, "hidden_size": 16, "num_heads": 2,
              "intermediate_size": 32, "max_position_embeddings": 20}),
          "--data_dir", f"{s}/data", "--output_dir", f"{s}/pre",
          "--max_steps", "2", "--per_device_train_batch_size", "4",
          "--decoder_layers", "1"])
    assert os.path.exists(f"{s}/pre/checkpoint-2/DONE")
    main(["export-hf", "--model_type", "seeddot_nll", "--training_dir",
          f"{s}/pre", "--out_dir", f"{s}/hf"])
    assert "lm_head.bias" in torch.load(f"{s}/hf/pytorch_model.bin",
                                        weights_only=True)

    # the front of the pipeline: preprocess raw TSVs (a word tokenizer in
    # place of the HF one), warmup with an eval, export-hf, a msgpack read
    import zlib
    from ance_tpu_torch import cli
    from ance_tpu_torch.train.flax_msgpack import msgpack_restore

    class Words:
        pad_token_id, sep_token = 1, "</s>"

        def encode(self, text, add_special_tokens=True, max_length=None):
            ids = [0] + [3 + zlib.crc32(w.encode()) % 40
                         for w in text.split()] + [2]
            return ids[:max_length]

    cli._load_tokenizer = lambda name, model_dir: Words()
    raw = f"{d}/raw"
    os.mkdir(raw)
    texts = [" ".join(f"w{(7 * i + j) % 13}" for j in range(2 + i % 5))
             for i in range(10)]
    with open(f"{raw}/collection.tsv", "w") as f:
        f.writelines(f"{i}\\t{t}\\n" for i, t in enumerate(texts))
    for split, qf, rf in (("train", "queries.train.tsv", "qrels.train.tsv"),
                          ("dev", "queries.dev.small.tsv",
                           "qrels.dev.small.tsv")):
        with open(f"{raw}/{qf}", "w") as f, open(f"{raw}/{rf}", "w") as r:
            for q in range(4):
                f.write(f"{q}\\t{texts[q][:5]}\\n")
                r.write(f"{q}\\t0\\t{q}\\t1\\n")
    with open(f"{raw}/top1000.dev", "w") as f:
        f.writelines(f"{q}\\t{p}\\tq\\tp\\n" for q in range(4)
                     for p in range(6))
    with open(f"{raw}/triples.tsv", "w") as f:
        f.writelines(f"{texts[i][:5]}\\t{texts[i]}\\t{texts[i + 1]}\\n"
                     for i in range(8))
    main(["preprocess", "--data_dir", raw, "--out_data_dir", f"{d}/pre",
          "--max_seq_length", "12", "--max_query_length", "6",
          "--num_processes", "1"])
    assert os.path.exists(f"{d}/pre/dev-qrel.tsv")
    main(["warmup", "--device", "cpu", "--encoder_overrides",
          json.dumps(tiny), "--train_file", f"{raw}/triples.tsv",
          "--output_dir", f"{d}/warm", "--max_steps", "2", "--save_steps",
          "2", "--per_device_train_batch_size", "4", "--max_seq_length",
          "12", "--max_query_length", "6", "--evaluate_during_training",
          "--eval_steps", "2", "--data_dir", raw])
    main(["export-hf", "--encoder_overrides", json.dumps(tiny),
          "--training_dir", f"{d}/warm", "--out_dir", f"{d}/hf"])
    assert os.path.exists(f"{d}/hf/config.json")
    assert msgpack_restore(b"\\x81\\xa1a\\x01") == {"a": 1}

    # DPR: preprocess-dpr (a BERT-style word tokenizer), train --num_epoch
    # with a dev evaluation and GradCache accumulation, generate-dpr and
    # export-hf --model_type dpr
    class BertWords:
        pad_token_id, sep_token_id = 0, 3

        def encode(self, text, text_pair=None, add_special_tokens=True,
                   max_length=None):
            ids = [2] + [4 + zlib.crc32(w.encode()) % 40
                         for w in text.split()] + [3]
            if text_pair is not None:
                ids += [4 + zlib.crc32(w.encode()) % 40
                        for w in text_pair.split()] + [3]
            return ids

    cli._load_tokenizer = lambda name, model_dir: BertWords()
    w = f"{d}/dpr_raw"
    os.mkdir(w)
    with open(f"{w}/psgs_w100.tsv", "w") as f:
        f.write("id\\ttext\\ttitle\\n")
        f.writelines(f"{i + 1}\\t{texts[i]}\\tT{i}\\n" for i in range(10))
    def sample(i, key):
        return {"question": texts[i][:5] + "?", "answers": [texts[i][:2]],
                "positive_ctxs": [{key: str(i + 1)}],
                "hard_negative_ctxs": [{key: str((i + 3) % 10 + 1)}]}
    for name, key, n in (("nq-train", "passage_id", 8),
                         ("nq-dev", "passage_id", 4),
                         ("trivia-dev", "psg_id", 2)):
        with open(f"{w}/{name}.json", "w") as f:
            json.dump([sample(i, key) for i in range(n)], f)
    for name in ("nq-test", "trivia-test"):
        with open(f"{w}/{name}.csv", "w") as f:
            f.writelines(f"{texts[i][:5]}?\\t['{texts[i][:2]}']\\n"
                         for i in range(3))
    main(["preprocess-dpr", "--model_type", "dpr", "--wiki_dir", w,
          "--question_dir", w, "--answer_dir", w, "--out_data_dir",
          f"{d}/dpr", "--max_seq_length", "12", "--num_processes", "1"])
    dpr_tiny = json.dumps(dict(tiny, hidden_dropout=0.0,
                               attention_dropout=0.0))
    flags = ["--device", "cpu", "--model_type", "dpr", "--encoder_overrides",
             dpr_tiny, "--data_dir", f"{d}/dpr"]
    main(["train", *flags, "--output_dir", f"{d}/dpr_ckpt", "--num_epoch",
          "1", "--dev_data", f"{d}/dpr/dev-data",
          "--per_device_train_batch_size", "4",
          "--gradient_accumulation_steps", "2"])
    assert os.path.exists(f"{d}/dpr_ckpt/checkpoint-2/DONE")
    main(["generate-dpr", *flags, "--wiki_path", f"{w}/psgs_w100.tsv",
          "--test_qas", f"{w}/nq-test.csv", "--trivia_qas",
          f"{w}/trivia-test.csv", "--training_dir", f"{d}/dpr_ckpt",
          "--output_dir", f"{d}/dpr_ann", "--topk_training", "5",
          "--negative_sample", "2"])
    assert "top20" in json.load(open(f"{d}/dpr_ann/ann_ndcg_0"))
    main(["export-hf", "--model_type", "dpr", "--training_dir",
          f"{d}/dpr_ckpt", "--out_dir", f"{d}/dpr_export"])
    assert "model_dict" in torch.load(f"{d}/dpr_export/checkpoint-2",
                                      weights_only=True)
    # data parallelism: a one-rank gloo group through the rank worker, its
    # row-sharded index searched and saved
    from ance_tpu_torch.experiments import mesh_worker
    np.savez(f"{d}/mesh.npz", corpus=rs.randn(11, 4).astype(np.float32),
             queries=rs.randn(2, 4).astype(np.float32))
    os.mkdir(f"{d}/mesh_out")
    # and core/tp.py's 1 x 1 grid of that rank: the tp case's encode and
    # step
    torch.save(get_model_spec("rdot_nll").build(
        attention_impl="xla", config_overrides=tiny), f"{d}/tp_model.pt")
    np.savez(f"{d}/tp_batch.npz", ids=rs.randint(3, 50, (2, 6)),
             mask=np.ones((2, 6), np.int64))
    json.dump({"init_method": f"file://{d}/rendezvous", "world": 1,
               "out_dir": f"{d}/mesh_out", "cases": [
                   {"case": "flat", "data": f"{d}/mesh.npz",
                    "modes": ["none", "dims"], "ks": [3], "slice_rows": 4,
                    "save_dir": d},
                   {"case": "tp", "tp": 1, "lr": 0.1,
                    "model": f"{d}/tp_model.pt",
                    "batches": f"{d}/tp_batch.npz"}]},
              open(f"{d}/job.json", "w"))
    assert mesh_worker.main([f"{d}/job.json", "0"]) == 0
    assert os.path.exists(f"{d}/mesh_out/flat_rank0.pt")
    assert torch.load(f"{d}/mesh_out/tp_rank0.pt",
                      weights_only=False)["emb"].shape == (2, 768)
    assert os.path.exists(f"{d}/dims.npz")
    assert "jax" not in sys.modules, "the port pulled in jax"
    assert "flax" not in sys.modules
    assert "msgpack" not in sys.modules
    assert "regex" not in sys.modules
    old = sorted(m for m in sys.modules
                 if m == "ance_tpu" or m.startswith("ance_tpu."))
    assert not old, f"the port imported the JAX package: {old}"
    print("modules", len(mods))
""")


DEMOS = textwrap.dedent("""
    import sys
    import torch
    torch.set_num_threads(1)
    from ance_tpu_torch.experiments import demo, demo_dpr, demo_maxp
    demo.SHAPE = dict(hidden_size=16, num_layers=1, num_heads=2,
                      intermediate_size=32)
    cpu = ["--device", "cpu", "--dtype", "fp32"]
    demo.main(["--passages", "1030", "--train_q", "8", "--dev_q", "4",
               "--warm", "2", "--steps", "8", "--batch", "2"] + cpu)
    demo.main(["--model", "seeddot", "--passages", "1030", "--train_q",
               "8", "--dev_q", "4", "--warm", "2", "--steps", "8",
               "--batch", "2"] + cpu)
    demo_maxp.main(["--docs", "32", "--train_q", "8", "--dev_q", "4",
                    "--warm", "2", "--steps", "8", "--batch", "2"] + cpu)
    demo_dpr.main(["--passages", "64", "--train_q", "8", "--test_q", "4",
                   "--trivia_q", "4", "--cycles", "1", "--steps", "2",
                   "--batch", "2"] + cpu)
    assert "jax" not in sys.modules, "a demo pulled in jax"
    old = sorted(m for m in sys.modules
                 if m == "ance_tpu" or m.startswith("ance_tpu."))
    assert not old, f"a demo imported the JAX package: {old}"
    print("demos ok")
""")


def test_demos_never_import_jax():
    """The three learning demos (``experiments/demo.py`` with both models,
    ``demo_maxp.py``, ``demo_dpr.py``) run end to end at a tiny size on
    the CPU without jax or the JAX package."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", DEMOS], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.rstrip().endswith("demos ok")


def test_port_never_imports_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    n = int(proc.stdout.split("modules")[-1])
    assert n >= 15  # every module of the package was imported
