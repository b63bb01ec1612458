"""The JAX package's native checkpoints in the port: the standard-library
msgpack reader (``train/flax_msgpack.py``) against
``flax.serialization.msgpack_restore`` on what
``ance_tpu.train.checkpoint.save_checkpoint`` writes (fp32 and bf16 trees,
numpy scalars, chunked leaves), ``serve`` / ``infer`` / ``generate`` from
a JAX ``checkpoint-<n>`` against the JAX encoder, a resume from one (the
optimizer restored, from the msgpack and the orbax layout), and the
refusal of what the port cannot read."""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from ance_tpu.train import checkpoint as jax_ckpt
from ance_tpu_torch.train import checkpoint as ckpt
from ance_tpu_torch.train.flax_msgpack import read_msgpack

torch.set_num_threads(1)

TINY = {"num_layers": 2, "hidden_size": 32, "num_heads": 2,
        "intermediate_size": 64, "vocab_size": 100,
        "max_position_embeddings": 40}


def _jax_model_and_params(init=0.5, seed=7):
    """A tiny JAX RobertaDot (a wide init, so rankings have no near-ties)
    and its numpy parameters."""
    from ance_tpu.models.registry import get_model_spec as jax_spec
    model = jax_spec("rdot_nll").build(
        config_overrides=dict(TINY, initializer_range=init))
    ids = jnp.ones((2, 8), jnp.int32)
    params = jax.jit(model.init)(jax.random.PRNGKey(seed), ids, ids)["params"]
    return model, jax.tree.map(np.asarray, params)


def _assert_same_tree(got, want, path="/"):
    """Equal keys and containers, array leaves of the same dtype, shape
    and bytes (bf16: a torch.bfloat16 tensor against flax's ml_dtypes
    array), other leaves equal and of the same type."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for key in want:
            _assert_same_tree(got[key], want[key], f"{path}{key}/")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_tree(g, w, f"{path}{i}/")
    elif isinstance(want, (np.ndarray, np.generic)) and \
            want.dtype.name == "bfloat16":
        assert isinstance(got, torch.Tensor), path
        assert got.dtype == torch.bfloat16, path
        assert tuple(got.shape) == np.shape(want), path
        assert got.view(torch.int16).numpy().tobytes() == \
            np.asarray(want).view(np.int16).tobytes(), path
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert got.tobytes() == want.tobytes(), path
    else:
        assert type(got) is type(want) and got == want, path


def _jax_checkpoint(directory, step, tree, opt_state=None):
    return jax_ckpt.save_checkpoint(str(directory), step, tree,
                                    opt_state=opt_state,
                                    extra={"epoch": 0})


@pytest.mark.parametrize("case", ["fp32", "bf16", "chunked"])
def test_reader_matches_flax(tmp_path, monkeypatch, case):
    """params.msgpack (and opt_state.msgpack) of a JAX checkpoint: the
    port's reader returns flax's tree, keys equal and leaves bit-equal;
    the bf16 parameters load into the port's model as their fp32 values."""
    from ance_tpu.train.trainer import make_optimizer
    from ance_tpu_torch.models.weights import state_dict_from_flax
    _, params = _jax_model_and_params()
    tree, opt_state = params, None
    if case == "fp32":
        opt_state = make_optimizer("lamb", 1e-3).init(
            jax.tree.map(jnp.asarray, params))
    elif case == "bf16":
        tree = jax.tree.map(lambda x: np.asarray(x.astype(jnp.bfloat16)),
                            params)
    else:
        # flax splits leaves above MAX_CHUNK_SIZE (1 GiB) into chunks: made
        # small here, the word embeddings (12.8 KB fp32) and a bf16 leaf
        # are written in chunks
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 1000)
        tree = {"params": params,
                "bf16": np.asarray(jnp.arange(900, dtype=jnp.bfloat16))}
    tree = {**tree, "scale": np.float32(0.25), "count": np.int64(7),
            "rate": 2.5, "name": "tiny", "flag": True}
    path = _jax_checkpoint(tmp_path, 3, tree, opt_state)
    for name in ("params.msgpack", "opt_state.msgpack"):
        if not os.path.exists(os.path.join(path, name)):
            continue
        raw = open(os.path.join(path, name), "rb").read()
        if case == "chunked" and name == "params.msgpack":
            assert b"__msgpack_chunked_array__" in raw
        _assert_same_tree(read_msgpack(os.path.join(path, name)),
                          serialization.msgpack_restore(raw))
    params_tree = {k: v for k, v in tree.items() if isinstance(v, dict)}
    if case == "chunked":
        params_tree = params_tree["params"]
    want = state_dict_from_flax(
        jax.tree.map(lambda x: np.asarray(x, np.float32), params_tree))
    got = state_dict_from_flax(ckpt.load_raw_params(path) if case != "chunked"
                               else ckpt.load_raw_params(path)["params"])
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == torch.float32
        assert torch.equal(got[key], want[key]), key


def _write_cache(path, n, seq, rs):
    from ance_tpu_torch.data.cache import TokenCacheWriter
    with TokenCacheWriter(str(path), seq) as w:
        for _ in range(n):
            length = int(rs.randint(3, seq + 1))
            toks = np.ones(seq, np.int32)  # RoBERTa pad id 1
            toks[0] = 0
            toks[1:length] = rs.randint(3, TINY["vocab_size"], length - 1)
            w.write(length, toks)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """Caches (40 passages at seq 16, 8 dev and 8 train queries at seq 8,
    qrels) and a JAX training directory whose newest complete checkpoint
    is checkpoint-5 (a checkpoint-9 without DONE beside it)."""
    root = tmp_path_factory.mktemp("native")
    rs = np.random.RandomState(0)
    data = root / "data"
    data.mkdir()
    _write_cache(data / "passages", 40, 16, rs)
    for split in ("dev", "train"):
        _write_cache(data / f"{split}-query", 8, 8, rs)
        with open(data / f"{split}-qrel.tsv", "w") as f:
            f.writelines(f"{q}\t{rs.randint(40)}\t1\n" for q in range(8))
    model, params = _jax_model_and_params()
    run = root / "jax_run"
    _jax_checkpoint(run, 5, params)
    os.makedirs(run / "checkpoint-9")
    return root, str(data), str(run), model, params


def _jax_embeddings(model, params, cache_path, method):
    from ance_tpu.data.cache import TokenCache
    with TokenCache(cache_path) as c:
        lengths, tokens = c.batch(np.arange(len(c)))
    mask = (np.arange(tokens.shape[1])[None] < lengths[:, None])
    return np.asarray(model.apply(
        {"params": jax.tree.map(jnp.asarray, params)}, jnp.asarray(tokens),
        jnp.asarray(mask.astype(np.int32)), method=method), np.float32)


def test_serve_infer_and_generate_read_a_jax_checkpoint(jax_run, tmp_path,
                                                        capsys):
    """``infer`` and ``serve --save_index`` from the JAX training
    directory: passage and query embeddings equal the JAX encoder's on the
    same caches within the fp32 forward-parity tolerance (atol 1e-4,
    ``tests/test_torch_models.py``); ``serve --model_name_or_path
    <checkpoint-5>`` ranks as ``serve --training_dir``; ``generate`` cites
    checkpoint-5; each notes on stderr that it read a JAX-package
    checkpoint."""
    from ance_tpu_torch.cli import main
    root, data, run, model, params = jax_run
    want_p = _jax_embeddings(model, params, os.path.join(data, "passages"),
                             type(model).body_emb)
    want_q = _jax_embeddings(model, params, os.path.join(data, "dev-query"),
                             type(model).query_emb)
    flags = ["--device", "cpu", "--encoder_overrides", json.dumps(TINY),
             "--data_dir", data, "--max_seq_length", "16",
             "--max_query_length", "8"]
    main(["infer", *flags, "--training_dir", run, "--output_dir",
          str(tmp_path / "emb")])
    shards = json.loads(capsys.readouterr().out.splitlines()[-1])
    p = np.load(shards["passages"], allow_pickle=True)
    p_ids = np.load(shards["passage_ids"], allow_pickle=True)
    q = np.load(shards["dev_query"], allow_pickle=True)
    np.testing.assert_allclose(p, want_p[p_ids], atol=1e-4, rtol=0)
    np.testing.assert_allclose(q, want_q, atol=1e-4, rtol=0)

    serve = ["serve", *flags, "--query_cache", data + "/dev-query",
             "--topk", "5", "--with_scores"]
    main(serve + ["--training_dir", run, "--save_index",
                  str(tmp_path / "idx"), "--output", str(tmp_path / "a.tsv")])
    out = capsys.readouterr()
    assert json.loads(out.out.splitlines()[-1])["params"] == os.path.join(
        run, "checkpoint-5", "params.msgpack")
    assert "JAX-package checkpoint" in out.err
    with np.load(str(tmp_path / "idx.npz")) as z:
        np.testing.assert_allclose(z["emb"], want_p, atol=1e-4, rtol=0)
    main(serve + ["--model_name_or_path", os.path.join(run, "checkpoint-5"),
                  "--output", str(tmp_path / "b.tsv")])
    a = (tmp_path / "a.tsv").read_text()
    assert len(a.splitlines()) == 40 and a == (tmp_path / "b.tsv").read_text()

    main(["generate", *flags, "--training_dir", run, "--output_dir",
          str(tmp_path / "ann"), "--topk_training", "8", "--negative_sample",
          "2", "--ann_chunk_factor", "1"])
    summary = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert summary["checkpoint"] == os.path.join(run, "checkpoint-5")
    meta = json.loads((tmp_path / "ann" / "ann_ndcg_0").read_text())
    assert meta["checkpoint"] == summary["checkpoint"]
    assert len((tmp_path / "ann" / "ann_training_data_0").read_text()
               .splitlines()) == 8


def _jax_optimizer_state(params, name):
    """The JAX optimizer state after one update of seeded gradients (so
    the moments are not zero), the rewarmup schedule re-anchored at that
    step with horizon 7."""
    from ance_tpu.optim.schedules import reset_rewarmup
    from ance_tpu.train.trainer import make_optimizer
    params = jax.tree.map(jnp.asarray, params)
    if name == "lamb_rewarmup":
        opt = make_optimizer("lamb", 1e-3, rewarmup=(2, 10))
    else:
        opt = make_optimizer("adamw", lambda s: 1e-3, weight_decay=0.01)
    state = opt.init(params)
    grads = jax.tree.map(lambda p: jnp.cos(p * 5.0) * 0.01, params)
    _, state = opt.update(grads, state, params)
    if name == "lamb_rewarmup":
        state = reset_rewarmup(state, horizon=7.0)
    return state


@pytest.mark.parametrize("opt", ["lamb_rewarmup", "adamw"])
@pytest.mark.parametrize("layout", ["msgpack", "orbax"])
def test_resume_from_a_jax_checkpoint_restores_the_optimizer(
        jax_run, tmp_path, capsys, layout, opt):
    """``resume_train_state`` over a JAX training directory whose
    checkpoint-5 holds the parameters and the optimizer state (msgpack's
    ``opt_state.msgpack``, or the orbax ``state/`` of the JAX
    ``AsyncCheckpointer``): the parameters loaded strictly, the step 5,
    and the optimizer restored bit for bit: each parameter's moments as
    ``state_dict_from_flax`` maps the JAX ones, the count (AdamW's step
    too), LAMB's rewarmup anchor and horizon; a note on stderr names
    them. A JAX state of the other optimizer is refused naming its
    path."""
    from ance_tpu.optim.lamb import find_lamb_state
    from ance_tpu_torch.models.registry import get_model_spec
    from ance_tpu_torch.models.weights import state_dict_from_flax
    from ance_tpu_torch.train import trainer
    _, _, _, _, params = jax_run
    jstate = _jax_optimizer_state(params, opt)
    run = tmp_path / "run"
    if layout == "msgpack":
        _jax_checkpoint(run, 5, params, jstate)
    else:
        writer = jax_ckpt.AsyncCheckpointer(str(run))
        writer.save(5, jax.tree.map(jnp.asarray, params), opt_state=jstate)
        writer.wait()
        assert os.path.isdir(run / "checkpoint-5" / "state")
    moments = find_lamb_state(jstate) if opt == "lamb_rewarmup" \
        else jstate[1][0]
    mu = state_dict_from_flax(jax.tree.map(np.asarray, moments.mu))
    nu = state_dict_from_flax(jax.tree.map(np.asarray, moments.nu))

    def port_state(name):
        model = get_model_spec("rdot_nll").build(config_overrides=TINY,
                                                 seed=3)
        return trainer.init_train_state(model, trainer.make_optimizer(
            model, "lamb" if name == "lamb_rewarmup" else "adamw", 1e-3,
            weight_decay=0.01 if name == "adamw" else 0.0,
            rewarmup=(2, 10) if name == "lamb_rewarmup" else None))

    state, step = ckpt.resume_train_state(str(run), port_state(opt))
    assert step == state.step == 5 and state.optimizer.count == 1
    want = state_dict_from_flax(params)
    for key, value in state.model.state_dict().items():
        assert torch.equal(value, want[key]), key
    for name, p in state.model.named_parameters():
        restored = state.optimizer.inner.state[p]
        assert torch.equal(restored["exp_avg"], mu[name]), name
        assert torch.equal(restored["exp_avg_sq"], nu[name]), name
        if opt == "adamw":
            assert float(restored["step"]) == 1.0
    note = "count 1"
    if opt == "lamb_rewarmup":
        sched = state.optimizer.schedule
        assert (sched.anchor, sched.horizon) == (1, 7.0)
        note += ", anchor 1, horizon 7.0"
    assert f"optimizer state ({note}) are restored" in \
        capsys.readouterr().err
    other = "adamw" if opt == "lamb_rewarmup" else "lamb_rewarmup"
    with pytest.raises(ckpt.UnreadableCheckpoint,
                       match="opt_state.*the port's optimizer is"):
        ckpt.resume_train_state(str(run), port_state(other))


def _orbax_checkpoint(directory, params):
    writer = jax_ckpt.AsyncCheckpointer(str(directory))
    writer.save(2, jax.tree.map(jnp.asarray, params))
    writer.wait()
    return os.path.join(str(directory), "checkpoint-2", "state")


def test_unreadable_checkpoints_exit_naming_the_file(jax_run, tmp_path):
    """An empty orbax ``state/`` (no ``manifest.ocdbt``), an orbax one with
    a crc32c mismatch in its manifest, a truncated B-tree node, zarr v3
    arrays or a chunk compressor other than zstd, and an empty, a
    truncated and a non-RobertaDot ``params.msgpack``: each exits with a
    message naming the file."""
    import tensorstore as ts
    from ance_tpu_torch.cli import main
    root, data, run, _, params = jax_run
    base = ["serve", "--device", "cpu", "--encoder_overrides",
            json.dumps(TINY), "--data_dir", data, "--query_cache",
            data + "/dev-query", "--max_query_length", "8"]
    good = open(os.path.join(run, "checkpoint-5", "params.msgpack"),
                "rb").read()
    orbax_state = _orbax_checkpoint(tmp_path / "orbax_source", params)

    def corrupt(name, state):
        if name == "crc32c":
            path = os.path.join(state, "manifest.ocdbt")
            raw = bytearray(open(path, "rb").read())
            raw[len(raw) // 2] ^= 1
            open(path, "wb").write(bytes(raw))
            return path
        if name == "truncated_node":
            node = os.path.join(state, "d", os.listdir(
                os.path.join(state, "d"))[0])
            raw = open(node, "rb").read()
            open(node, "wb").write(raw[:len(raw) // 2])
            return node
        if name == "zarr3":
            path = os.path.join(state, "_METADATA")
            meta = json.load(open(path))
            meta["use_zarr3"] = True
            json.dump(meta, open(path, "w"))
            return path
        kv = ts.KvStore.open({"driver": "ocdbt",
                              "base": f"file://{state}/"}).result()
        key = "params.embedding_head.kernel/.zarray"
        zarray = json.loads(kv.read(key).result().value)
        zarray["compressor"] = {"id": "blosc", "cname": "lz4"}
        kv.write(key, json.dumps(zarray).encode()).result()
        return os.path.join(state, key)

    cases = {"orbax": None, "crc32c": "orbax", "truncated_node": "orbax",
             "zarr3": "orbax", "compressor": "orbax", "empty": b"",
             "truncated": good[:-7],
             "other_tree": serialization.to_bytes({"w": np.ones(3)})}
    for name, payload in cases.items():
        d = tmp_path / name / "checkpoint-2"
        os.makedirs(d)
        (d / "meta.json").write_text('{"step": 2}')
        if payload is None:
            os.makedirs(d / "state")
            target = str(d / "state" / "manifest.ocdbt")
        elif payload == "orbax":
            shutil.copytree(orbax_state, d / "state")
            target = corrupt(name, str(d / "state"))
        else:
            (d / "params.msgpack").write_bytes(payload)
            target = str(d / "params.msgpack")
        (d / "DONE").write_text("2")
        with pytest.raises(SystemExit) as info:
            main(base + ["--training_dir", str(tmp_path / name)])
        assert str(info.value).startswith(target + ":"), (name, info.value)
