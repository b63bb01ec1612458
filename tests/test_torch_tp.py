"""Tensor parallelism of the port (``ance_tpu_torch/core/tp.py``) against the
JAX package's (``ance_tpu/core/tp.py``) on the CPU, on the JAX test's tiny
encoder (2 layers, hidden 32, 4 heads, intermediate 64;
``tests/test_tp.py``) with its parameters carried across by
``state_dict_from_flax``:

  (i)   the port's shard map is JAX's ``param_spec``, key for key, through
        that key map (the torch layout the flax kernel's transpose);
  (ii)  the dp 2 x tp 2 encode (4 gloo ranks) and the dp 1 x tp 2 encode
        (2 ranks) equal JAX's sharded encode on ``make_mesh_2d(model=2,
        data=2)`` of conftest's 8 virtual CPU devices, jitted, and its
        replicated encode, at atol / rtol 1e-5; each rank holds half of
        every column-parallel weight's rows;
  (iii) one SGD step at tp 2 equals the replicated step (``jax.grad`` and
        ``optax.sgd``): loss rtol 1e-5, parameters atol 2e-5 / rtol 1e-4,
        and every gradient tensor against JAX's at the same bound, so a
        gradient off by tp (a reduction that reduces again in its
        backward) fails;
  (iv)  ``validate_tp`` refuses what the JAX one refuses, with the same
        message fragments;
  (v)   ``cli generate`` at 2 ranks with ``--tensor_parallel 2`` and at tp
        1 on a tiny cache (init std 0.5, so rankings do not tie) writes the
        one-process hand-off files byte for byte, and ``cli infer`` at tp 1
        (the index row-sharded, its rows gathered for the dump) the
        one-process embedding shards;
  (vi)  ``cli generate-dpr`` (``generate_new_ann_dpr`` with its ``mesh``)
        at 2 ranks, tp 1 (the index row-sharded over both) and tp 2 (the
        BERT towers sharded), writes the one-process files byte for byte.

The ranks are processes of ``ance_tpu_torch.experiments.mesh_worker``, all
spawned once for the module."""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from ance_tpu.core import tp as jax_tp
from ance_tpu.models.dot_models import RobertaDot as JaxDot
from ance_tpu.models.transformer import EncoderConfig as JaxConfig
from ance_tpu_torch.core import tp
from ance_tpu_torch.core.mesh import DataMesh
from ance_tpu_torch.models.dot_models import RobertaDot
from ance_tpu_torch.models.transformer import EncoderConfig
from ance_tpu_torch.models.weights import state_dict_from_flax
from test_torch_mesh import REPO, RANK_TIMEOUT_S

torch.set_num_threads(1)

GEOMETRY = dict(num_layers=2, hidden_size=32, num_heads=4,
                intermediate_size=64, vocab_size=100,
                max_position_embeddings=40)
B, S, LR = 8, 16, 1e-2
GRIDS = {"dp2_tp2": 4, "dp1_tp2": 2}  # name: world (tp 2 in both)


def _jax_model(heads=4, impl="xla"):
    cfg = JaxConfig(**dict(GEOMETRY, num_heads=heads), attention_impl=impl)
    return JaxDot(cfg, out_dim=32)


def _inputs():
    """The JAX test's parameters (PRNGKey 0) and a batch with ragged
    lengths (RoBERTa pad id 1 past each)."""
    model = _jax_model()
    rs = np.random.RandomState(0)
    ids = rs.randint(4, 90, (B, S)).astype(np.int32)
    lengths = rs.randint(4, S + 1, B)
    mask = (np.arange(S)[None] < lengths[:, None]).astype(np.int32)
    ids = np.where(mask == 1, ids, 1).astype(np.int32)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(ids[:2]),
                                 jnp.asarray(mask[:2]))["params"]
    return model, jax.tree.map(np.asarray, params), ids, mask


def _port_model(params):
    model = RobertaDot(EncoderConfig(**GEOMETRY, attention_impl="xla"),
                       out_dim=32)
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    return model


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(job_path, world):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, "-m", "ance_tpu_torch.experiments.mesh_worker",
         str(job_path), str(r)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]


def _wait(procs) -> list:
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    return [o for o, _ in outs]


# -- (v)'s data: tiny caches and a port checkpoint at init std 0.5 ----------

CLI_TINY = dict(GEOMETRY, initializer_range=0.5)
N_PASSAGES, N_TRAIN_Q, N_DEV_Q = 96, 16, 8


def _write_cache(path, n, seq, rs):
    from ance_tpu_torch.data.cache import TokenCacheWriter
    lengths = rs.randint(3, seq + 1, n)
    with TokenCacheWriter(str(path), seq) as w:
        for length in lengths:
            row = np.ones(seq, np.int32)
            row[0] = 0
            row[1:length] = rs.randint(3, GEOMETRY["vocab_size"], length - 1)
            w.write(int(length), row)


def _cli_data(root):
    from ance_tpu_torch.models.registry import get_model_spec
    from ance_tpu_torch.train import checkpoint as ckpt
    data = root / "data"
    data.mkdir()
    rs = np.random.RandomState(1)
    _write_cache(data / "passages", N_PASSAGES, 16, rs)
    _write_cache(data / "train-query", N_TRAIN_Q, 8, rs)
    _write_cache(data / "dev-query", N_DEV_Q, 8, rs)
    with open(data / "train-qrel.tsv", "w") as f:
        for q in range(N_TRAIN_Q):
            f.write(f"{q}\t{rs.randint(N_PASSAGES)}\t1\n")
    with open(data / "dev-qrel.tsv", "w") as f:
        for q in range(N_DEV_Q):
            for p in rs.choice(N_PASSAGES, 3, replace=False):
                f.write(f"{q}\t{p}\t{rs.randint(1, 3)}\n")
    model = get_model_spec("rdot_nll").build(config_overrides=CLI_TINY,
                                             seed=3)
    ckpt.save_checkpoint(str(root / "train"), 2, model)
    return data


DPR_TINY = {"vocab_size": 520, "hidden_size": 64, "num_layers": 2,
            "num_heads": 4, "intermediate_size": 128,
            "max_position_embeddings": 32, "initializer_range": 0.5}


def _dpr_data(root):
    """``preprocess-dpr`` of ``test_torch_dpr_data``'s raw files (its
    fake BERT tokenizer) and a seeded BiEncoder checkpoint."""
    from ance_tpu_torch import cli as port_cli
    from ance_tpu_torch.models.registry import get_model_spec
    from ance_tpu_torch.train import checkpoint as ckpt
    from test_torch_dpr_data import FakeBertFactory, _write_raw
    raw = root / "dpr_raw"
    raw.mkdir()
    wiki, qd, ad = _write_raw(raw, np.random.RandomState(11))
    factory = port_cli.TokenizerFactory
    port_cli.TokenizerFactory = lambda name, model_dir: FakeBertFactory()
    try:
        port_cli.main(["preprocess-dpr", "--model_type", "dpr",
                       "--wiki_dir", str(wiki), "--question_dir", str(qd),
                       "--answer_dir", str(ad), "--out_data_dir",
                       str(root / "dpr_data"), "--max_seq_length", "24",
                       "--num_processes", "1"])
    finally:
        port_cli.TokenizerFactory = factory
    model = get_model_spec("dpr").build(config_overrides=DPR_TINY, seed=3)
    ckpt.save_checkpoint(str(root / "dpr_train"), 1, model)


def _cli_argv(root, data, command, out):
    common = ["--device", "cpu", "--attention", "xla", "--output_dir",
              str(root / out), "--per_device_eval_batch_size", "8"]
    if command == "generate-dpr":
        raw = root / "dpr_raw"
        return [command, *common, "--model_type", "dpr",
                "--encoder_overrides", json.dumps(DPR_TINY),
                "--max_seq_length", "24", "--data_dir",
                str(root / "dpr_data"), "--wiki_path",
                str(raw / "wiki" / "psgs_w100.tsv"), "--test_qas",
                str(raw / "answers" / "nq-test.csv"), "--trivia_qas",
                str(raw / "answers" / "trivia-test.csv"), "--training_dir",
                str(root / "dpr_train"), "--topk_training", "8",
                "--negative_sample", "3"]
    return [command, *common, "--model_type", "rdot_nll",
            "--encoder_overrides", json.dumps(CLI_TINY), "--data_dir",
            str(data), "--training_dir", str(root / "train"),
            "--max_seq_length", "16", "--max_query_length", "8",
            "--topk_training", "12", "--negative_sample", "3",
            "--ann_chunk_factor", "1"]


# what the spawned ranks run: (ii)/(iii) at both grids, (v)'s and (vi)'s
# commands
CLI_RUNS = {"gen_tp2": ("generate", 2), "gen_tp1": ("generate", 1),
            "infer_tp1": ("infer", 1), "dpr_tp1": ("generate-dpr", 1),
            "dpr_tp2": ("generate-dpr", 2)}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp")
    _, params, ids, mask = _inputs()
    torch.save(_port_model(params), root / "model.pt")
    np.savez(root / "batch.npz", ids=ids, mask=mask)
    data = _cli_data(root)
    _dpr_data(root)
    procs = {}
    for name, world in GRIDS.items():
        out = root / name
        out.mkdir()
        job = {"init_method": f"file://{root / (name + '_rendezvous')}",
               "world": world, "device": "cpu", "backend": "gloo",
               "timeout_s": 120, "out_dir": str(out),
               "cases": [{"case": "tp", "tp": 2, "lr": LR,
                          "model": str(root / "model.pt"),
                          "batches": str(root / "batch.npz")}]}
        (root / f"{name}.json").write_text(json.dumps(job))
        procs[name] = _start(root / f"{name}.json", world)
    for name, (command, tp_) in CLI_RUNS.items():
        argv = _cli_argv(root, data, command, name) + [
            "--tensor_parallel", str(tp_), "--num_processes", "2",
            "--coordinator_address", f"127.0.0.1:{_free_port()}",
            "--dist_backend", "gloo"]
        (root / f"{name}_probes").mkdir()
        (root / f"{name}.json").write_text(json.dumps(
            {"cli": argv, "out_dir": str(root / f"{name}_probes")}))
        procs[name] = _start(root / f"{name}.json", 2)
    stdout = {name: _wait(p) for name, p in procs.items()}
    results = {name: [torch.load(root / name / f"tp_rank{r}.pt",
                                 weights_only=False) for r in range(world)]
               for name, world in GRIDS.items()}
    return root, data, results, stdout


# -- (i) the shard map ------------------------------------------------------

def test_shard_map_is_jax_param_spec_key_for_key():
    """Each flax leaf marked with its index goes through
    ``state_dict_from_flax``; the port key that carries it must shard as
    JAX shards the leaf, the torch spec being the flax spec reversed (a
    Linear weight is the flax kernel transposed)."""
    _, params, _, _ = _inputs()
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    marked = jax.tree_util.tree_unflatten(
        treedef, [np.full(np.shape(leaf), i, np.float32)
                  for i, (_, leaf) in enumerate(flat)])
    sd = state_dict_from_flax(marked)
    port = tp.encoder_param_shardings(_port_model(params))
    assert set(port) == set(sd)
    assert len(sd) == len(flat)
    sharded = 0
    for key, value in sd.items():
        path = flat[int(value.reshape(-1)[0])][0]
        want = tuple(jax_tp.param_spec(path))
        if len(want) == 2:
            want = want[::-1]
        assert port[key] == want, (key, port[key], want)
        sharded += bool(port[key])
    # q, k, v, intermediate (weights and biases), out and output (weights)
    assert sharded == GEOMETRY["num_layers"] * 10


def test_param_spec_rules_and_axes():
    """The JAX test's path rules in the port's names, the DPR towers' and
    SEED's keys, and the writer of a grid: global rank 0 only."""
    assert tp.param_spec("roberta.encoder.layer.0.attention.self.value."
                         "weight") == ("model", None)
    assert tp.param_spec("ctx_model.encoder.layer.3.output.dense.weight") \
        == (None, "model")
    assert tp.param_spec("roberta.encoder.layer.0.output.dense.bias") == ()
    assert tp.param_spec("question_model.encoder.layer.1.intermediate."
                         "dense.bias") == ("model",)
    for name in ("roberta.embeddings.word_embeddings.weight",
                 "roberta.encoder.layer.0.attention.output.LayerNorm.weight",
                 "embeddingHead.weight", "norm.bias", "lm_head.dense.weight",
                 "decoder.layers.0.fc2.weight"):
        assert tp.param_spec(name) == (), name
    cpu = torch.device("cpu")
    axis = DataMesh(rank=0, world=2, device=cpu, backend="gloo",
                    global_rank=1)
    assert not axis.writer
    assert DataMesh(rank=0, world=2, device=cpu, backend="gloo").writer


# -- (ii) the encode, (iii) the step ----------------------------------------

def _jax_sharded_encode(model, params, ids, mask):
    mesh = jax_tp.make_mesh_2d(model=2, data=2)
    jax_tp.validate_tp(model.config, mesh)

    @jax.jit
    def encode(p, i, m):
        return model.apply({"params": p}, i, m, method=model.body_emb)

    data = NamedSharding(mesh, P("data"))
    return np.asarray(encode(jax_tp.shard_params_tp(params, mesh),
                             jax.device_put(jnp.asarray(ids), data),
                             jax.device_put(jnp.asarray(mask), data)))


@pytest.mark.parametrize("grid", list(GRIDS))
def test_tp_encode_matches_jax(spawned, grid):
    _, _, results, _ = spawned
    model, params, ids, mask = _inputs()
    replicated = np.asarray(jax.jit(
        lambda p, i, m: model.apply({"params": p}, i, m,
                                    method=model.body_emb))(
        params, jnp.asarray(ids), jnp.asarray(mask)))
    sharded = _jax_sharded_encode(model, params, ids, mask)
    ranks = results[grid]
    for r in ranks:
        got = r["emb"].numpy()
        np.testing.assert_allclose(got, sharded, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got, replicated, atol=1e-5, rtol=1e-5)
        assert np.array_equal(got, ranks[0]["emb"].numpy())
        # the weights are distributed: half the rows of a column-parallel
        # weight, half the columns of a row-parallel one
        shapes = r["local_shapes"]
        layer = "roberta.encoder.layer.1."
        assert shapes[layer + "attention.self.query.weight"] == (16, 32)
        assert shapes[layer + "intermediate.dense.bias"] == (32,)
        assert shapes[layer + "output.dense.weight"] == (32, 32)
        assert shapes[layer + "attention.output.dense.bias"] == (32,)
    assert sorted((r["data"], r["model"]) for r in ranks) == sorted(
        (d, m) for d in range(len(ranks) // 2) for m in range(2))
    assert [r["model"] for r in ranks] == [r["rank"] % 2 for r in ranks]


def _jax_sgd_step(model, params, ids, mask):
    import optax
    opt = optax.sgd(LR)

    def loss_fn(p):
        emb = model.apply({"params": p}, jnp.asarray(ids), jnp.asarray(mask),
                          method=model.body_emb)
        return jnp.sum(emb ** 2)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    updates, _ = opt.update(grads, opt.init(params), params)
    return float(loss), state_dict_from_flax(
        jax.tree.map(np.asarray, grads)), state_dict_from_flax(
        jax.tree.map(np.asarray, optax.apply_updates(params, updates)))


def _port_replicated_grads(params, ids, mask):
    model = _port_model(params)
    loss = (model.body_emb(torch.as_tensor(ids).long(),
                           torch.as_tensor(mask).long()) ** 2).sum()
    loss.backward()
    return {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("grid", list(GRIDS))
def test_tp_sgd_step_matches_replicated(spawned, grid):
    """The loss and every parameter after one step, whole again on every
    rank, against JAX's replicated step; every gradient tensor's norm
    against JAX's (rtol 1e-3: a tensor whose gradient was reduced twice
    over the model ranks is off by 100%), and each gradient element
    against the port's own one-process step at the parameters' bound.
    Against JAX the gradients differ more even on one process (up to 1.1x
    that element bound, 1.0e-4 of a norm): the loss, a sum of squared
    LayerNorm outputs, is nearly flat, so its gradients cancel. The norms
    take 1e-6 absolute for the attention key bias, whose true gradient is
    0 (the softmax is invariant to it)."""
    _, _, results, _ = spawned
    model, params, ids, mask = _inputs()
    loss, grads, new = _jax_sgd_step(model, params, ids, mask)
    port = _port_replicated_grads(params, ids, mask)
    for r in results[grid]:
        np.testing.assert_allclose(r["loss"], loss, rtol=1e-5)
        assert set(r["grads"]) == set(grads) == set(r["params"])
        for name, want in new.items():
            np.testing.assert_allclose(r["params"][name].numpy(),
                                       want.numpy(), atol=2e-5, rtol=1e-4,
                                       err_msg=name)
        for name, want in grads.items():
            got = r["grads"][name]
            np.testing.assert_allclose(float(got.double().norm()),
                                       float(want.double().norm()),
                                       rtol=1e-3, atol=1e-6, err_msg=name)
            np.testing.assert_allclose(got.numpy(), port[name].numpy(),
                                       atol=2e-5, rtol=1e-4, err_msg=name)


# -- (iv) the refusals ------------------------------------------------------

def test_validate_tp_refuses_as_jax():
    mesh = jax_tp.make_mesh_2d(model=4, data=2)
    for heads, impl, match in ((6, "xla", "num_heads"),
                               (4, "auto", "Pallas"),
                               (4, "fused", "explicit 'xla' or 'xla_bf16'")):
        jax_cfg = _jax_model(heads, impl).config
        port_cfg = EncoderConfig(**dict(GEOMETRY, num_heads=heads),
                                 attention_impl=impl)
        with pytest.raises(ValueError, match=match):
            jax_tp.validate_tp(jax_cfg, mesh)
        with pytest.raises(ValueError, match=match):
            tp.validate_tp(port_cfg, 4)
    odd = EncoderConfig(**dict(GEOMETRY, intermediate_size=66),
                        attention_impl="xla")
    with pytest.raises(ValueError, match="intermediate_size 66 not "
                                         "divisible by tp 4"):
        tp.validate_tp(odd, 4)
    for impl in ("xla", "xla_bf16"):
        tp.validate_tp(EncoderConfig(**GEOMETRY, attention_impl=impl), 4)
    # tp 1 validates anything, as the JAX package's tp=1 mesh does
    jax_tp.validate_tp(_jax_model(6, "auto").config,
                       jax_tp.make_mesh_2d(model=1, data=8))
    tp.validate_tp(EncoderConfig(**dict(GEOMETRY, num_heads=6)), 1)


def test_make_mesh_2d_needs_the_job_s_group():
    """A grid is cut from the job's process group; without one it is
    refused. (tp that does not divide the ranks exits in the CLI before
    any group starts: ``test_torch_mesh.py::test_cli_refusals``.)"""
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="process group"):
        tp.make_mesh_2d(2, device="cpu")


# -- (v) the generator commands over the grid -------------------------------

def test_cli_generate_over_the_grid_writes_one_process_files(spawned,
                                                             capsys):
    from ance_tpu_torch.cli import main
    root, data, _, stdout = spawned
    main(_cli_argv(root, data, "generate", "one"))
    one = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    main(_cli_argv(root, data, "infer", "one_infer"))
    capsys.readouterr()
    for name in ("ann_training_data_0", "ann_ndcg_0"):
        want = (root / "one" / name).read_bytes()
        for run in ("gen_tp2", "gen_tp1"):
            assert (root / run / name).read_bytes() == want, (run, name)
    for run, (_, tp_) in CLI_RUNS.items():
        for r, out in enumerate(stdout[run]):
            lines = [json.loads(x) for x in out.strip().splitlines()]
            assert lines[0]["dist"] == {
                "backend": "gloo", "rank": r, "world": 2, "device": "cpu",
                "data": r // tp_, "model": r % tp_, "tp": tp_}
            if run.startswith("gen"):
                assert lines[-1]["dev_ndcg"] == one["dev_ndcg"]
    for suffix in ("passage_emb_p_", "passage_embid_p_", "dev_query_emb_p_",
                   "dev_query_embid_p_"):
        name = f"step0_{suffix}_data_obj_0.npy"
        got = np.load(root / "infer_tp1" / name)
        want = np.load(root / "one_infer" / name)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_cli_generate_dpr_over_the_grid_writes_one_process_files(spawned,
                                                                 capsys):
    from ance_tpu_torch.cli import main
    root, data, _, stdout = spawned
    main(_cli_argv(root, data, "generate-dpr", "dpr_one"))
    one = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for name in ("ann_training_data_0", "ann_ndcg_0"):
        want = (root / "dpr_one" / name).read_bytes()
        assert want
        for run in ("dpr_tp1", "dpr_tp2"):
            assert (root / run / name).read_bytes() == want, (run, name)
    for run in ("dpr_tp1", "dpr_tp2"):
        for out in stdout[run]:
            got = json.loads(out.strip().splitlines()[-1])
            assert all(got[k] == one[k] for k in (
                "top20", "top100", "top20_trivia", "top100_trivia"))
