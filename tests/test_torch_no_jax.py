"""The torch port never imports jax, nor any module of the JAX package.
Checked in a fresh interpreter, because this test process already has jax
(tests/conftest.py imports it)."""

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
    from ance_tpu_torch.experiments import perf_attn128 as exp
    params = exp.make_params(rs, layers=1, hidden=128, intermediate=64,
                             seq=8)
    ids, mask = exp.inputs(rs, 2, 8, "cpu", pad_from=6)
    for attn in exp.VARIANTS:
        assert exp.encoder(params, ids, mask, attn=attn,
                           heads=2).shape == (2, 128)
    assert "jax" not in sys.modules, "the port pulled in jax"
    assert "flax" not in sys.modules
    old = sorted(m for m in sys.modules
                 if m == "ance_tpu" or m.startswith("ance_tpu."))
    assert not old, f"the port imported the JAX package: {old}"
    print("modules", len(mods))
""")


def test_port_never_imports_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    n = int(proc.stdout.split("modules")[-1])
    assert n >= 15  # every module of the package was imported
