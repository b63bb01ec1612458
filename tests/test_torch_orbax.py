"""The port's readers of the JAX package's orbax checkpoints, each held
against the library that wrote the bytes:

  * the zstd decoder (``native/zstd.cpp`` through ``utils/zstd.py``)
    against ``zstandard``, byte for byte, and its refusal of corrupt
    frames;
  * the OCDBT store (``train/ocdbt.py``) against tensorstore on stores that
    tensorstore writes with small inline-value and node limits;
  * ``load_raw_params`` / ``load_raw_opt_state`` against the JAX package's
    own readers on orbax ``state/``, legacy ``params/``, plain-file zarr
    and msgpack checkpoints, leaf for leaf;
  * a JAX run resumed in the port, from either layout: the optimizer bit
    for bit, then the parameters after more steps within the whole-step
    tolerance of ``tests/test_torch_train.py``;
  * the committed fixture ``tests/data/jax_loop_orbax`` (a JAX
    ``PipelinedAnce`` checkpoint; :func:`write_jax_loop_fixture` writes
    it: ``python tests/test_torch_orbax.py`` rewrites it), and the CLIs
    over a JAX ``ance ance-loop`` training directory.
"""

import hashlib
import json
import os
import pathlib
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import zstandard
from hypothesis import given, settings
from hypothesis import strategies as st

from ance_tpu.train import checkpoint as jax_ckpt
from ance_tpu_torch.models.weights import state_dict_from_flax
from ance_tpu_torch.train import checkpoint as ckpt
from ance_tpu_torch.train.ocdbt import OcdbtError, OcdbtStore
from ance_tpu_torch.train.orbax_reader import read_item
from ance_tpu_torch.utils import zstd

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_ann_loop import PLEN, QLEN, VOCAB  # noqa: E402
from test_torch_native_checkpoint import _assert_same_tree  # noqa: E402
from test_torch_pipelined import loop_data  # noqa: E402,F401
from test_torch_train import _assert_params_close  # noqa: E402

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "jax_loop_orbax")


# -- zstd ----------------------------------------------------------------


def _payloads(size: int) -> dict:
    """Zeros, random bytes, fp32 and bf16 weights and text of ``size``
    bytes, from seed 0."""
    rs = np.random.RandomState(0)
    n4, n2 = -(-size // 4), -(-size // 2)
    words = [b"query", b"passage", b"relevance", b"the", b"of", b"a",
             b"dense", b"retrieval", b"negative", b"index"]
    text = b" ".join(words[i] for i in rs.randint(0, len(words),
                                                  size // 4 + 1))
    bf16 = torch.from_numpy(rs.randn(n2).astype(np.float32)).to(
        torch.bfloat16).view(torch.int16).numpy().tobytes()
    return {"zeros": bytes(size), "random": rs.bytes(size),
            "fp32": (rs.randn(n4) * 0.02).astype(np.float32).tobytes()[:size],
            "bf16": bf16[:size], "text": text[:size]}


FLAGS = [(c, s) for c in (False, True) for s in (False, True)]


@pytest.mark.parametrize("level", list(range(-5, 0)) + list(range(1, 20)))
def test_zstd_matches_zstandard(level):
    """Every kind of payload at 0 B, 1 B, 777 B, 64 KiB + 13 and 300 KB
    (several 128 KiB blocks), at each level: the decoder's bytes equal
    the input, each flag combination (content checksum, content size)
    once a size, and all four at 64 KiB + 13."""
    for size in (0, 1, 777, 65549, 300_000):
        for kind, data in _payloads(size).items():
            combos = FLAGS if size == 65549 else \
                [FLAGS[(size + len(kind)) % 4]]
            for checksum, content_size in combos:
                frame = zstandard.ZstdCompressor(
                    level=level, write_checksum=checksum,
                    write_content_size=content_size).compress(data)
                got = zstd.decompress(frame)
                assert bytes(got) == data, (level, size, kind, checksum)


@pytest.mark.parametrize("level", [-5, 1, 3, 9, 19])
def test_zstd_matches_zstandard_at_4_mib(level):
    """4 MiB of every kind, with a checksum, the content size declared
    and not (then the output buffer grows until it fits)."""
    for kind, data in _payloads(4 << 20).items():
        for content_size in (True, False):
            frame = zstandard.ZstdCompressor(
                level=level, write_checksum=True,
                write_content_size=content_size).compress(data)
            assert zstd.content_size(frame) == \
                (len(data) if content_size else None)
            assert bytes(zstd.decompress(frame)) == data, (kind,
                                                           content_size)


def _skippable(payload: bytes, nibble: int) -> bytes:
    return (0x184D2A50 + nibble).to_bytes(4, "little") + \
        len(payload).to_bytes(4, "little") + payload


def test_zstd_frames_in_a_row_and_skippable_frames():
    """Frames of mixed levels and flags, one of them empty, with skippable
    frames between and around them: the frames' contents, joined."""
    parts = list(_payloads(5000).values()) + [b"", b"tail"]
    stream = _skippable(b"lead", 0)
    for i, data in enumerate(parts):
        stream += zstandard.ZstdCompressor(
            level=[1, 19, -3][i % 3], write_checksum=bool(i % 2),
            write_content_size=i % 3 != 1).compress(data)
        stream += _skippable(bytes(i * 3), i % 16)
    assert bytes(zstd.decompress(stream)) == b"".join(parts)
    assert zstd.content_size(_skippable(b"x", 3)) == 0


@settings(max_examples=60, deadline=None)
@given(data=st.binary(max_size=5000), alphabet=st.integers(1, 256),
       level=st.integers(-5, 19), checksum=st.booleans(),
       content_size=st.booleans())
def test_zstd_hypothesis(data, alphabet, level, checksum, content_size):
    """Any bytes, folded onto a small alphabet so that they compress."""
    data = bytes(b % alphabet for b in data)
    frame = zstandard.ZstdCompressor(
        level=level, write_checksum=checksum,
        write_content_size=content_size).compress(data)
    assert bytes(zstd.decompress(frame)) == data


def test_zstd_corrupt_frames_raise():
    """A frame with a checksum never decodes to other bytes: every flipped
    byte of its blocks and checksum raises ``ValueError`` naming a byte
    offset, or (a bit no decoder reads) leaves the content as it was.
    Every truncation raises, and so do a bad magic number, a dictionary
    id, a reserved block type and a wrong checksum (named as such)."""
    data = _payloads(40000)["text"] + _payloads(20000)["fp32"]
    for level in (1, 19):
        frame = zstandard.ZstdCompressor(level=level,
                                         write_checksum=True).compress(data)
        for pos in range(_frame_header_size(frame), len(frame), 7):
            bad = bytearray(frame)
            bad[pos] ^= 0x5A
            try:
                out = zstd.decompress(bytes(bad))
            except ValueError as e:
                assert "byte " in str(e), e
                continue
            assert bytes(out) == data, (level, pos)
        for cut in range(1, len(frame), max(1, len(frame) // 97)):
            with pytest.raises(ValueError):
                zstd.decompress(frame[:cut])
        bad = bytearray(frame)
        bad[-1] ^= 1
        with pytest.raises(ValueError, match="checksum"):
            zstd.decompress(bytes(bad))
    with pytest.raises(ValueError, match="magic"):
        zstd.decompress(b"\x00" * 16)
    plain = zstandard.ZstdCompressor(write_content_size=False).compress(b"x")
    assert plain[4] & 0x23 == 0  # a window byte, no dictionary id
    with_dict = plain[:4] + bytes([plain[4] | 1]) + plain[5:6] + b"\x07" + \
        plain[6:]
    with pytest.raises(ValueError, match="dictionary"):
        zstd.decompress(with_dict)
    reserved = bytearray(plain)
    reserved[6] |= 0b110  # the first block header's type bits: 3
    with pytest.raises(ValueError, match="block type"):
        zstd.decompress(bytes(reserved))


def _frame_header_size(frame: bytes) -> int:
    """Magic, descriptor, window byte, dictionary id and content size."""
    d = frame[4]
    single = (d >> 5) & 1
    fcs = [single, 2, 4, 8][d >> 6]
    return 5 + (0 if single else 1) + [0, 1, 2, 4][d & 3] + fcs


def test_crc32c_vectors():
    """crc32c's check value (RFC 3720's "123456789"), continued across two
    calls."""
    assert zstd.crc32c(b"123456789") == 0xE3069283
    assert zstd.crc32c(b"56789", zstd.crc32c(b"1234")) == 0xE3069283
    assert zstd.crc32c(b"") == 0


# -- OCDBT ------------------------------------------------------------------


def _write_store(root, compression, inline, node_bytes, rs):
    """Three commits through tensorstore: 200 keys with shared prefixes
    and values of 0 B to 3 KB, then overwrites, deletes and new keys in
    one transaction, then one more key. Returns {key: value}."""
    import tensorstore as ts
    config = {"max_inline_value_bytes": inline,
              "max_decoded_node_bytes": node_bytes,
              "compression": compression}
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/",
                          "config": config}).result()
    want = {}

    def put(txn, key, value):
        (kv.with_transaction(txn) if txn else kv).write(key, value).result()
        want[key] = value

    txn = ts.Transaction()
    for i in range(200):
        key = f"params.layer_{i % 7}.w{i:03d}/{'.zarray' if i % 2 else '0.0'}"
        put(txn, key.encode(), rs.bytes(int(rs.choice([0, 5, 40, 900,
                                                       3000]))))
    txn.commit_async().result()
    txn = ts.Transaction()
    for key in sorted(want)[::5]:
        put(txn, key, rs.bytes(int(rs.randint(0, 100))))
    for key in sorted(want)[1::9]:
        kv.with_transaction(txn).delete_range(ts.KvStore.KeyRange(
            inclusive_min=key, exclusive_max=key + b"\0")).result()
        del want[key]
    for i in range(30):
        put(txn, f"opt_state.1.mu.x{i}/0".encode(), rs.bytes(int(
            rs.randint(0, 2000))))
    txn.commit_async().result()
    put(None, b"zz", b"last")
    return want


@pytest.mark.parametrize("compression", [None, {"id": "zstd", "level": 3}])
@pytest.mark.parametrize("inline,node_bytes", [(0, 256), (16, 400),
                                               (1024, 100_000_000)])
def test_ocdbt_reader_matches_tensorstore(tmp_path, compression, inline,
                                          node_bytes):
    """Every key tensorstore lists, and every value it reads, of the
    newest version: equal. The small limits make interior nodes (several
    levels) and indirect values."""
    import tensorstore as ts
    rs = np.random.RandomState(inline + node_bytes % 1000)
    want = _write_store(tmp_path, compression, inline, node_bytes, rs)
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{tmp_path}/"}).result()
    listed = sorted(kv.list().result())
    assert listed == sorted(want)
    with OcdbtStore(str(tmp_path)) as store:
        assert store.keys() == listed
        values = store.read_many(listed)
        for key, value in zip(listed, values):
            assert value == kv.read(key).result().value == want[key], key
        assert store.read(listed[3]) == want[listed[3]]
        dump = ts.ocdbt.dump(ts.KvStore.open(
            {"driver": "file", "path": f"{tmp_path}/"}).result()).result()
        assert store.generation == dump["versions"][-1]["generation_number"]
        if node_bytes < 1000:
            assert dump["versions"][-1]["root_height"] >= 1
        with pytest.raises(KeyError):
            store.read(b"no such key")


def test_ocdbt_refuses_corrupt_files(tmp_path):
    """A flipped payload byte (crc32c), a truncated manifest, a manifest
    of another format version: each raises naming the file."""
    rs = np.random.RandomState(1)
    _write_store(tmp_path, {"id": "zstd"}, 16, 400, rs)
    manifest = tmp_path / "manifest.ocdbt"
    good = manifest.read_bytes()
    cases = {"crc32c mismatch": good[:20] + bytes([good[20] ^ 1]) + good[21:],
             "length field": good[:-3]}
    for what, payload in cases.items():
        manifest.write_bytes(payload)
        with pytest.raises(OcdbtError, match=what) as info:
            OcdbtStore(str(tmp_path))
        assert str(info.value).startswith(str(manifest) + ":")
    manifest.write_bytes(good)
    assert OcdbtStore(str(tmp_path)).keys()


# -- the readers against the JAX package's ------------------------------------


def _jax_rdot(init=0.2, seed=1, geometry=None):
    from ance_tpu.models.registry import get_model_spec as jax_spec
    model = jax_spec("rdot_nll").build(
        config_overrides=dict(geometry or GEOMETRY, initializer_range=init))
    ids = jnp.ones((2, QLEN), jnp.int32)
    params = jax.jit(model.init)(jax.random.PRNGKey(seed), ids, ids)["params"]
    return model, params


GEOMETRY = {"num_layers": 2, "hidden_size": 32, "num_heads": 4,
            "intermediate_size": 64, "vocab_size": VOCAB,
            "max_position_embeddings": 32, "hidden_dropout": 0.0,
            "attention_dropout": 0.0}


def _as_dicts(tree):
    """orbax's restore, as the port's readers return trees: sequences as
    dicts keyed "0", "1", ...; arrays as numpy (bf16 stays ml_dtypes)."""
    if isinstance(tree, (list, tuple)):
        return {str(i): _as_dicts(x) for i, x in enumerate(tree)}
    if isinstance(tree, dict):
        return {k: _as_dicts(v) for k, v in tree.items()}
    if tree is None:
        return None
    return np.asarray(tree)


def _assert_tree(got, want, path="/"):
    """``_assert_same_tree``, with None leaves (an empty optax state)."""
    if want is None:
        assert got is None, path
    elif isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            _assert_tree(got[k], want[k], f"{path}{k}/")
    else:
        _assert_same_tree(got, want, path)


def _orbax_restore(item):
    import orbax.checkpoint as ocp
    with ocp.StandardCheckpointer() as c:
        return c.restore(os.path.abspath(item))


def _optimizers():
    from ance_tpu.train.trainer import make_optimizer
    return {"lamb_rewarmup": make_optimizer(
                "lamb", 2e-3, eps=1e-8, weight_decay=0.01,
                max_grad_norm=1.0, rewarmup=(2, 10)),
            "adamw": make_optimizer(
                "adamw", lambda s: 1e-3, eps=1e-8, weight_decay=0.01,
                max_grad_norm=1.0)}


@pytest.mark.parametrize("opt", ["lamb_rewarmup", "adamw"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_readers_match_the_jax_package(tmp_path, opt, dtype):
    """One tree saved four ways: orbax ``state/`` (the JAX
    ``AsyncCheckpointer``), the legacy orbax ``params/``, orbax with plain
    zarr files (``use_ocdbt`` false) and msgpack. ``load_raw_params`` and
    ``load_raw_opt_state`` equal the JAX package's readers (orbax's
    restore, ``flax.serialization.msgpack_restore``) leaf for leaf:
    dtype, shape and bytes, bf16 included; ``None`` where the JAX state is
    empty. The moments are made non-zero by one real update."""
    import orbax.checkpoint as ocp
    from flax import serialization
    _, params = _jax_rdot()
    optimizer = _optimizers()[opt]
    state = optimizer.init(params)
    grads = jax.tree.map(lambda p: jnp.sin(p * 3.0) * 0.1, params)
    _, state = optimizer.update(grads, state, params)
    if dtype == "bf16":
        params = jax.tree.map(lambda x: x.astype(jnp.bfloat16), params)
        state = jax.tree.map(lambda x: x.astype(jnp.bfloat16)
                             if x.dtype == jnp.float32 and x.ndim else x,
                             state)
    asyncer = jax_ckpt.AsyncCheckpointer(str(tmp_path / "async"))
    asyncer.save(3, params, opt_state=state)
    asyncer.wait()
    orbax_dir = str(tmp_path / "async" / "checkpoint-3")
    legacy = tmp_path / "legacy" / "checkpoint-3"
    with ocp.StandardCheckpointer() as c:
        c.save(os.path.abspath(legacy / "params"), params)
    files = tmp_path / "files" / "checkpoint-3"
    ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_ocdbt=False)).save(
        os.path.abspath(files / "state"),
        args=ocp.args.PyTreeSave({"params": params, "opt_state": state}))
    msgpack_dir = jax_ckpt.save_checkpoint(str(tmp_path / "msgpack"), 3,
                                           params, opt_state=state)
    assert json.load(open(os.path.join(orbax_dir, "meta.json")))["format"] \
        == "orbax"

    want_params = _as_dicts(jax_ckpt.load_raw_params(orbax_dir))
    want_opt = _as_dicts(_orbax_restore(os.path.join(orbax_dir, "state"))
                         ["opt_state"])
    _assert_tree(ckpt.load_raw_params(orbax_dir), want_params)
    _assert_tree(ckpt.load_raw_opt_state(orbax_dir), want_opt)
    _assert_tree(ckpt.load_raw_params(str(legacy)),
                 _as_dicts(jax_ckpt.load_raw_params(str(legacy))))
    assert ckpt.load_raw_opt_state(str(legacy)) is None
    _assert_tree(read_item(str(files / "state")),
                 _as_dicts(_orbax_restore(files / "state")))
    _assert_tree(ckpt.load_raw_params(msgpack_dir),
                 jax_ckpt.load_raw_params(msgpack_dir))
    raw = open(os.path.join(msgpack_dir, "opt_state.msgpack"), "rb").read()
    _assert_same_tree(ckpt.load_raw_opt_state(msgpack_dir),
                      serialization.msgpack_restore(raw))
    # the four layouts hold one tree
    _assert_tree(ckpt.load_raw_params(msgpack_dir), want_params)


@pytest.mark.parametrize("use_ocdbt", [True, False])
def test_read_item_value_types_and_missing_chunks(tmp_path, use_ocdbt):
    """orbax's other leaf types, as its restore returns them: a numpy
    array, Python int and float scalars, an int64 and a float64 array
    split into several chunks (the edge ones partial). Then, from the
    plain-file layout, one chunk taken away: its region reads as the
    fill value (zarr's ``null``: zeros), the rest as written."""
    import orbax.checkpoint as ocp
    rs = np.random.RandomState(4)
    tree = {"np": rs.randn(5, 3).astype(np.float32), "int": 3, "float": 2.5,
            "i8": rs.randint(-9, 9, (300, 7)).astype(np.int64),
            "f8": rs.randn(1000).astype(np.float64), "u4": np.arange(
                7, dtype=np.uint32)}
    item = tmp_path / "item"
    ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_ocdbt=use_ocdbt)).save(
        os.path.abspath(item), args=ocp.args.PyTreeSave(
            tree, save_args=jax.tree.map(
                lambda _: ocp.SaveArgs(chunk_byte_size=1024), tree)))
    want = _as_dicts(_orbax_restore(item))
    for key in ("int", "float"):
        want[key] = _orbax_restore(item)[key]
    got = read_item(str(item))
    _assert_tree(got, want)
    assert type(got["int"]) is int and type(got["float"]) is float
    if use_ocdbt:
        return
    chunks = sorted(os.listdir(item / "f8"))
    assert len([c for c in chunks if c != ".zarray"]) > 1
    zarray = json.load(open(item / "f8" / ".zarray"))
    os.remove(item / "f8" / "0")
    got = read_item(str(item))["f8"]
    n = zarray["chunks"][0]
    assert (got[:n] == 0).all()
    np.testing.assert_array_equal(got[n:], tree["f8"][n:])


# -- resume parity -------------------------------------------------------------


def _seeded_batches(n, B, seed, vocab=VOCAB, q_len=QLEN, p_len=PLEN):
    """Triple batches of RoBERTa-style rows ([CLS]=0 words, pad 1)."""
    rs = np.random.RandomState(seed)

    def tokens(seq):
        lengths = rs.randint(3, seq + 1, B)
        ids = rs.randint(3, vocab, (B, seq)).astype(np.int32)
        ids[:, 0] = 0
        mask = (np.arange(seq)[None] < lengths[:, None]).astype(np.int32)
        return np.where(mask == 1, ids, 1).astype(np.int32), mask

    out = []
    for _ in range(n):
        b = {}
        b["query_ids"], b["query_mask"] = tokens(q_len)
        for side in ("pos", "neg"):
            b[f"{side}_ids"], b[f"{side}_mask"] = tokens(p_len)
        out.append(b)
    return out


def _save_both(tmp_path, step, params, opt_state, extra=None):
    """The JAX state saved in both layouts, each its own training dir."""
    orbax_run = str(tmp_path / "orbax")
    asyncer = jax_ckpt.AsyncCheckpointer(orbax_run)
    asyncer.save(step, params, opt_state=opt_state, extra=extra)
    asyncer.wait()
    assert os.path.isdir(os.path.join(orbax_run, f"checkpoint-{step}",
                                      "state"))
    msgpack_run = str(tmp_path / "msgpack")
    jax_ckpt.save_checkpoint(msgpack_run, step, params, opt_state=opt_state,
                             extra=extra)
    return {"orbax": orbax_run, "msgpack": msgpack_run}


def _assert_restored(optimizer, model, jax_moments, count, rewarmup=None):
    """The port optimizer's moments equal the JAX ones mapped by
    ``state_dict_from_flax`` bit for bit; its count (and AdamW's per
    parameter step), anchor and horizon equal."""
    mu = state_dict_from_flax(jax.tree.map(np.asarray, jax_moments.mu))
    nu = state_dict_from_flax(jax.tree.map(np.asarray, jax_moments.nu))
    assert optimizer.count == count
    for name, p in model.named_parameters():
        st_ = optimizer.inner.state[p]
        assert torch.equal(st_["exp_avg"], mu[name]), name
        assert torch.equal(st_["exp_avg_sq"], nu[name]), name
        if "step" in st_:
            assert float(st_["step"]) == count
    if rewarmup is not None:
        assert (optimizer.schedule.anchor, optimizer.schedule.horizon) == \
            rewarmup


@pytest.mark.parametrize("layout", ["orbax", "msgpack"])
def test_resume_continues_the_jax_run_lamb_rewarmup(tmp_path, layout):
    """The JAX RobertaDot trains 3 steps under LAMB with rewarmup (the
    schedule re-anchored after step 1, horizon 7) and dropout off, saves,
    and trains 3 more. The port resumes from the checkpoint: moments,
    count 3, anchor 1 and horizon 7.0 bit-equal; after the same 3
    batches its parameters are within the whole-step tolerance
    (``_assert_params_close``: 2e-6 but the key biases, Adam's bound over
    the summed rates)."""
    from ance_tpu.optim.lamb import find_lamb_state
    from ance_tpu.optim.schedules import (find_rewarmup_state,
                                          reset_rewarmup)
    from ance_tpu.train import trainer as jax_trainer
    from ance_tpu_torch.models.registry import get_model_spec
    from ance_tpu_torch.optim.schedules import RewarmupSchedule
    from ance_tpu_torch.train import trainer
    jm, params = _jax_rdot()
    jopt = _optimizers()["lamb_rewarmup"]
    jstep = jax_trainer.make_train_step(jax_trainer.triplet_loss_fn(jm), jopt)
    jstate = jax_trainer.init_train_state(params, jopt)
    batches = _seeded_batches(6, 8, seed=2)
    for i, batch in enumerate(batches[:3]):
        jstate, _ = jstep(jstate, batch, jax.random.PRNGKey(i))
        if i == 0:
            jstate = jax_trainer.TrainState(
                step=jstate.step, params=jstate.params,
                opt_state=reset_rewarmup(jstate.opt_state, horizon=7.0))
    run = _save_both(tmp_path, 3, jstate.params, jstate.opt_state)[layout]
    saved_moments = jax.tree.map(np.asarray,
                                 find_lamb_state(jstate.opt_state))
    rw = find_rewarmup_state(jstate.opt_state)
    assert (int(rw.anchor), float(rw.horizon)) == (1, 7.0)
    for i, batch in enumerate(batches[3:]):
        jstate, _ = jstep(jstate, batch, jax.random.PRNGKey(3 + i))

    model = get_model_spec("rdot_nll").build(config_overrides=GEOMETRY,
                                             seed=9)
    state = trainer.init_train_state(model, trainer.make_optimizer(
        model, "lamb", 2e-3, eps=1e-8, weight_decay=0.01, max_grad_norm=1.0,
        rewarmup=(2, 10)))
    state, step = ckpt.resume_train_state(run, state)
    assert step == state.step == 3
    assert isinstance(state.optimizer.schedule, RewarmupSchedule)
    _assert_restored(state.optimizer, model, saved_moments, 3, (1, 7.0))
    pstep = trainer.make_train_step(trainer.triplet_loss_fn())
    model.train()
    gen = torch.Generator().manual_seed(0)
    for batch in batches[3:]:
        state, _ = pstep(state, batch, gen)
    assert state.optimizer.count == 6
    want = state_dict_from_flax(jax.tree.map(np.asarray, jstate.params))
    lr_sum = sum(state.optimizer.schedule(s) for s in range(3, 6))
    _assert_params_close(model.state_dict(), want, lr_sum)


@pytest.mark.parametrize("layout", ["orbax", "msgpack"])
def test_resume_continues_the_jax_run_adamw_dpr(tmp_path, layout):
    """The same for AdamW (clip 1.0, weight decay 0.01 off biases and
    LayerNorms, a schedule) through the DPR step: the JAX BiEncoder trains
    2 steps, saves, trains 2 more; the port resumes (moments, count and
    every parameter's step bit-equal) and trains the same 2 batches,
    within ``test_torch_dpr._params_close``."""
    from ance_tpu.train import dpr_trainer as jdpr
    from ance_tpu.train import trainer as jax_trainer
    from ance_tpu_torch.train import trainer
    from ance_tpu_torch.train.dpr_trainer import make_dpr_train_step
    from test_torch_dpr import _batches, _models, _params_close
    jm, params, pm = _models()
    jopt = jax_trainer.make_optimizer("adamw", lambda s: 1e-3, eps=1e-8,
                                      weight_decay=0.01, max_grad_norm=1.0)
    jstate = jax_trainer.init_train_state(jax.tree.map(jnp.asarray, params),
                                          jopt)
    jstep = jdpr.make_dpr_train_step(
        jdpr.biencoder_loss_fn(jm, deterministic=True), jopt)
    batches = _batches(4, 4, 16, 32, seed=1)
    for i, batch in enumerate(batches[:2]):
        jstate, _ = jstep(jstate, batch, jax.random.PRNGKey(i))
    run = _save_both(tmp_path, 2, jstate.params, jstate.opt_state)[layout]
    saved = jax.tree.map(np.asarray, jstate.opt_state[1][0])
    for i, batch in enumerate(batches[2:]):
        jstate, _ = jstep(jstate, batch, jax.random.PRNGKey(2 + i))

    state = trainer.init_train_state(pm, trainer.make_optimizer(
        pm, "adamw", lambda s: 1e-3, eps=1e-8, weight_decay=0.01,
        max_grad_norm=1.0))
    state, step = ckpt.resume_train_state(run, state)
    assert step == 2
    _assert_restored(state.optimizer, pm, saved, 2)
    pstep = make_dpr_train_step()
    gen = torch.Generator().manual_seed(0)
    for batch in batches[2:]:
        state, _ = pstep(state, batch, gen)
    want = state_dict_from_flax(jax.tree.map(np.asarray, jstate.params))
    _params_close(pm.state_dict(), want, lr_sum=1e-3 * 2)


def test_seed_pretrain_optimizer_state_maps_bit_for_bit(tmp_path):
    """``seed-pretrain``'s optimizer (LAMB under a schedule, clip 1.0) over
    a SeedForMaskedLM, whose tree holds the decoder and the LM head
    beside the encoder: saved by the JAX ``AsyncCheckpointer`` after one
    update, read back and mapped, every moment equals the JAX one mapped
    by ``state_dict_from_flax`` bit for bit."""
    from ance_tpu.train.trainer import make_optimizer
    from ance_tpu_torch.optim.optax_state import optimizer_state_from_jax
    from ance_tpu_torch.train import trainer
    from test_torch_seed import _mlm_pair
    _, params, pm = _mlm_pair()
    jopt = make_optimizer("lamb", lambda s: 1e-3, weight_decay=0.01)
    jparams = jax.tree.map(jnp.asarray, params)
    state = jopt.init(jparams)
    _, state = jopt.update(jax.tree.map(lambda p: jnp.sin(p) * 0.1, jparams),
                           state, jparams)
    writer = jax_ckpt.AsyncCheckpointer(str(tmp_path))
    writer.save(1, jparams, opt_state=state)
    writer.wait()
    opt = trainer.make_optimizer(pm, "lamb", lambda s: 1e-3,
                                 weight_decay=0.01)
    opt.load_state_dict(optimizer_state_from_jax(
        ckpt.load_raw_opt_state(str(tmp_path / "checkpoint-1")), opt, pm))
    _assert_restored(opt, pm, jax.tree.map(np.asarray, state[1]), 1)


def test_optimizer_state_mapping_refuses_what_it_cannot_map():
    """Counts that disagree, a moment tree without one of the model's
    layers, LAMB state for an AdamW optimizer and a rewarmup chain for an
    optimizer without the schedule: each raises naming the path."""
    from ance_tpu.train.trainer import make_optimizer
    from ance_tpu_torch.models.registry import get_model_spec
    from ance_tpu_torch.optim.optax_state import optimizer_state_from_jax
    from ance_tpu_torch.train import trainer
    from flax import serialization
    _, params = _jax_rdot()
    model = get_model_spec("rdot_nll").build(config_overrides=GEOMETRY)
    jstate = make_optimizer("lamb", 1e-3, rewarmup=(2, 10)).init(params)
    tree = serialization.msgpack_restore(serialization.to_bytes(jstate))
    lamb = trainer.make_optimizer(model, "lamb", 1e-3, rewarmup=(2, 10))
    assert optimizer_state_from_jax(tree, lamb, model)["rewarmup"] == \
        {"anchor": 0, "horizon": 10.0}
    bad = jax.tree.map(lambda x: x, tree)
    bad["2"]["count"] = np.int32(3)
    with pytest.raises(ValueError, match="counts disagree.*1/count = 0, "
                       "2/count = 3"):
        optimizer_state_from_jax(bad, lamb, model)
    bad = jax.tree.map(lambda x: x, tree)
    del bad["1"]["mu"]["encoder"]["layer_1"]
    with pytest.raises(ValueError, match="opt_state/1/mu: the moment "
                       "tree's keys are not the model's"):
        optimizer_state_from_jax(bad, lamb, model)
    adamw = trainer.make_optimizer(model, "adamw", 1e-3, rewarmup=(2, 10))
    with pytest.raises(ValueError, match="opt_state/1: .*the port's "
                       "optimizer is AdamW"):
        optimizer_state_from_jax(tree, adamw, model)
    plain = trainer.make_optimizer(model, "lamb", 1e-3)
    with pytest.raises(ValueError, match="a chain of 3 states"):
        optimizer_state_from_jax(tree, plain, model)


# -- the committed fixture --------------------------------------------------

LOOP = dict(train_steps_per_slice=1, encode_slice_size=32,
            encode_batch_size=32, batch_size=16, topk_training=32,
            negative_sample=8, ann_chunk_factor=2, dev_search_depth=32,
            feed_workers=0, rewarmup_per_dataset=True)
OPTIMIZER = {"name": "lamb", "learning_rate": 5e-3, "eps": 1e-8,
             "weight_decay": 0.01, "max_grad_norm": 1.0, "warmup_steps": 4,
             "initial_horizon": 1000}
SAVE_AT, STEPS_AFTER, BATCH_SEED = 10, 3, 11


def _leaf_records(tree, prefix=""):
    """{"params/encoder/...": {"dtype", "shape", "sha256"}} of every array
    leaf of an orbax-restored tree (sequences keyed by index)."""
    out = {}
    for key, value in (tree.items() if isinstance(tree, dict)
                       else enumerate(tree)):
        path = f"{prefix}{key}"
        if isinstance(value, (dict, list, tuple)):
            out.update(_leaf_records(value, path + "/"))
        elif value is not None:
            a = np.asarray(value)
            out[path] = {"dtype": a.dtype.name, "shape": list(a.shape),
                         "sha256": hashlib.sha256(a.tobytes()).hexdigest()}
    return out


def write_jax_loop_fixture(out_dir, work_dir) -> dict:
    """The JAX ``PipelinedAnce`` over ``tests/test_ann_loop.py``'s task
    (the registry RobertaDot at ``GEOMETRY``, init std 0.2 from key 1;
    LAMB with per-dataset rewarmup, ``OPTIMIZER``) runs ``SAVE_AT`` steps,
    one work item a step, and checkpoints them through orbax
    (``checkpoint-<SAVE_AT>/state``); then trains ``STEPS_AFTER`` more on
    batches from seed ``BATCH_SEED``. Writes into ``out_dir`` the
    checkpoint, ``fixture.json`` (the settings, each leaf's dtype, shape
    and sha256) and ``after_steps.npz`` (the batches, ``batch<i>/<key>``,
    and the parameters after them in the port's names, ``param/<name>``).
    Returns the JSON."""
    from ance_tpu.data.cache import TokenCache as JaxCache
    from ance_tpu.optim.schedules import find_rewarmup_state
    from ance_tpu.train import pipelined as jp
    from ance_tpu.train import trainer as jt
    from ance_tpu.train.encode import make_encode_fn
    from test_ann_loop import _build_corpus
    os.makedirs(work_dir, exist_ok=True)
    paths, train_qrels, dev_qrels = _build_corpus(pathlib.Path(work_dir))
    jm, params = _jax_rdot()
    o = OPTIMIZER
    opt = jt.make_optimizer(o["name"], o["learning_rate"], eps=o["eps"],
                            weight_decay=o["weight_decay"],
                            max_grad_norm=o["max_grad_norm"],
                            rewarmup=(o["warmup_steps"],
                                      o["initial_horizon"]))
    step = jt.make_train_step(jt.triplet_loss_fn(jm), opt)
    run = os.path.join(work_dir, "run")
    caches = {n: JaxCache(paths[n]).open() for n in
              ("passages", "train-query", "dev-query")}
    loop = jp.PipelinedAnce(
        jp.PipelineConfig(**LOOP, checkpoint_dir=run, save_every=SAVE_AT),
        state=jt.init_train_state(params, opt), train_step=step,
        rng=jax.random.PRNGKey(3), params_of=lambda s: s.params,
        query_encode_fn=make_encode_fn(jm, type(jm).query_emb),
        body_encode_fn=make_encode_fn(jm, type(jm).body_emb),
        passage_cache=caches["passages"],
        train_query_cache=caches["train-query"],
        dev_query_cache=caches["dev-query"], train_qrels=train_qrels,
        dev_qrels=dev_qrels)
    loop.run(SAVE_AT)
    loop.flush_checkpoints()
    src = os.path.join(run, f"checkpoint-{SAVE_AT}")
    meta = json.load(open(os.path.join(src, "meta.json")))
    assert meta["format"] == "orbax" and meta["has_opt_state"]
    state = loop.state
    rw = find_rewarmup_state(state.opt_state)
    anchor, horizon = int(rw.anchor), float(rw.horizon)
    batches = _seeded_batches(STEPS_AFTER, 8, BATCH_SEED)
    for i, batch in enumerate(batches):
        state, _ = step(state, batch, jax.random.PRNGKey(100 + i))
    for c in caches.values():
        c.close()
    os.makedirs(out_dir, exist_ok=True)
    dst = os.path.join(out_dir, f"checkpoint-{SAVE_AT}")
    if os.path.exists(dst):
        shutil.rmtree(dst)
    shutil.copytree(src, dst)
    after = state_dict_from_flax(jax.tree.map(np.asarray, state.params))
    arrays = {f"batch{i}/{k}": v for i, b in enumerate(batches)
              for k, v in b.items()}
    arrays.update({f"param/{k}": v.numpy() for k, v in after.items()})
    np.savez_compressed(os.path.join(out_dir, "after_steps.npz"), **arrays)
    spec = {"model_type": "rdot_nll", "geometry": GEOMETRY,
            "optimizer": OPTIMIZER, "step": SAVE_AT,
            "refresh_no": meta["refresh_no"],
            "anchor": anchor, "horizon": horizon,
            "steps_after": STEPS_AFTER, "batch_size": 8,
            "leaves": _leaf_records(_orbax_restore(os.path.join(dst,
                                                                "state")))}
    with open(os.path.join(out_dir, "fixture.json"), "w") as f:
        json.dump(spec, f, indent=1, sort_keys=True)
    return spec


@pytest.fixture(scope="module")
def fresh_fixture(tmp_path_factory):
    root = tmp_path_factory.mktemp("fixture")
    spec = write_jax_loop_fixture(str(root / "out"), str(root / "work"))
    return str(root / "out"), spec


def test_committed_fixture_is_what_the_function_writes(fresh_fixture):
    """orbax reads the committed checkpoint to the values the JAX loop
    makes now: the same leaves, int32 leaves (counts, anchor) equal, the
    float leaves within 1e-5 relative + 1e-7 (the CPU may round another
    way than the one that wrote it); the same settings, and the
    parameters after the further steps within the same bound. The
    committed ``fixture.json`` names each committed leaf's sha256, and
    the checkpoint stays under 1 MB."""
    out, spec = fresh_fixture
    committed = json.load(open(os.path.join(FIXTURE, "fixture.json")))
    for key in ("model_type", "geometry", "optimizer", "step", "refresh_no",
                "anchor", "horizon", "steps_after", "batch_size"):
        assert committed[key] == spec[key], key
    state = f"checkpoint-{spec['step']}/state"
    want = _as_dicts(_orbax_restore(os.path.join(out, state)))
    got = _as_dicts(_orbax_restore(os.path.join(FIXTURE, state)))
    assert _leaf_records(got) == committed["leaves"]
    assert sorted(_leaf_records(got)) == sorted(spec["leaves"])

    def close(g, w, path="/"):
        if isinstance(w, dict):
            for k in w:
                close(g[k], w[k], f"{path}{k}/")
        elif w is not None:
            assert g.dtype == w.dtype and g.shape == w.shape, path
            if w.dtype.kind == "f":
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7,
                                           err_msg=path)
            else:
                np.testing.assert_array_equal(g, w, err_msg=path)
    close(got, want)
    with np.load(os.path.join(FIXTURE, "after_steps.npz")) as z, \
            np.load(os.path.join(out, "after_steps.npz")) as fresh:
        assert sorted(z.files) == sorted(fresh.files)
        for k in z.files:
            if k.startswith("batch"):
                np.testing.assert_array_equal(z[k], fresh[k], err_msg=k)
            else:
                np.testing.assert_allclose(z[k], fresh[k], rtol=1e-5,
                                           atol=1e-7, err_msg=k)
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(os.path.join(
                   FIXTURE, f"checkpoint-{spec['step']}")) for f in fs)
    assert size < 1_000_000


def _fixture_state(spec, device="cpu"):
    from ance_tpu_torch.models.registry import get_model_spec
    from ance_tpu_torch.train import trainer
    o = spec["optimizer"]
    model = get_model_spec(spec["model_type"]).build(
        config_overrides=spec["geometry"], seed=5).to(device)
    return trainer.init_train_state(model, trainer.make_optimizer(
        model, o["name"], o["learning_rate"], eps=o["eps"],
        weight_decay=o["weight_decay"], max_grad_norm=o["max_grad_norm"],
        rewarmup=(o["warmup_steps"], o["initial_horizon"])))


def test_port_resumes_the_committed_fixture(capsys):
    """The port's reader gives every committed leaf's sha256; the port
    resumes the fixture's training directory (step, count, anchor and
    horizon as the JAX loop left them, a stderr note naming them) and,
    after the committed batches, holds the JAX package's parameters
    within the whole-step tolerance."""
    from ance_tpu_torch.train import trainer
    spec = json.load(open(os.path.join(FIXTURE, "fixture.json")))
    path = os.path.join(FIXTURE, f"checkpoint-{spec['step']}")
    tree = {"params": ckpt.load_raw_params(path),
            "opt_state": ckpt.load_raw_opt_state(path)}

    def records(node, prefix=""):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out.update(records(v, f"{prefix}{k}/"))
            elif v is not None:
                raw = v.view(torch.int16).numpy() \
                    if isinstance(v, torch.Tensor) else v
                out[f"{prefix}{k}"] = hashlib.sha256(raw.tobytes()) \
                    .hexdigest()
        return out
    assert records(tree) == {k: v["sha256"]
                             for k, v in spec["leaves"].items()}
    state = _fixture_state(spec)
    state, step = ckpt.resume_train_state(FIXTURE, state)
    assert step == spec["step"] == state.optimizer.count
    sched = state.optimizer.schedule
    assert (sched.anchor, sched.horizon) == (spec["anchor"], spec["horizon"])
    err = capsys.readouterr().err
    assert f"count {spec['step']}, anchor {spec['anchor']}, horizon " \
        f"{spec['horizon']}" in err
    pstep = trainer.make_train_step(trainer.triplet_loss_fn())
    state.model.train()
    gen = torch.Generator().manual_seed(0)
    lr_sum = 0.0
    with np.load(os.path.join(FIXTURE, "after_steps.npz")) as z:
        for i in range(spec["steps_after"]):
            lr_sum += sched(state.optimizer.count)
            batch = {k.split("/")[1]: z[k] for k in z.files
                     if k.startswith(f"batch{i}/")}
            state, _ = pstep(state, batch, gen)
        want = {k[len("param/"):]: torch.from_numpy(z[k]) for k in z.files
                if k.startswith("param/")}
    _assert_params_close(state.model.state_dict(), want, lr_sum)


# -- the CLIs over a JAX ance-loop training directory ----------------------


@pytest.fixture(scope="module")
def jax_loop_dir(loop_data, tmp_path_factory):
    """``ance ance-loop`` (``--rewarmup_per_dataset``, saves every 4
    steps) over ``tests/test_torch_pipelined.py``'s data to step 8, with
    checkpoint-8 (its final msgpack one) then dropped, as a run stopped
    after it saved checkpoint-4 through orbax would leave it."""
    from ance_tpu.cli import main as jax_main
    from test_torch_pipelined import _loop_flags
    data, weights = loop_data
    run = tmp_path_factory.mktemp("jax_loop") / "run"
    jax_main(_loop_flags(data, weights, run, "--max_steps", "8",
                         "--save_steps", "4", "--rewarmup_per_dataset",
                         "--no_data_parallel"))
    assert os.path.isdir(run / "checkpoint-4" / "state")
    shutil.rmtree(run / "checkpoint-8")
    return data, weights, run


def test_cli_ance_loop_resumes_a_jax_ance_loop(jax_loop_dir, tmp_path,
                                               capsys):
    """The port's ``cli ance-loop`` and ``ance ance-loop`` each resume a
    copy of the JAX training directory (checkpoint-4, orbax) and run to
    step 8: the port resumes at step 4 and the refresh number the JAX
    run saved, with its optimizer (count 4, the anchor and horizon, named
    on stderr), and prints the JAX run's history (``_close_numbers``)."""
    from ance_tpu.cli import main as jax_main
    from ance_tpu_torch.cli import main as port_main
    from test_torch_pipelined import _close_numbers, _loop_flags
    data, weights, run = jax_loop_dir
    meta = json.load(open(run / "checkpoint-4" / "meta.json"))
    assert meta["format"] == "orbax" and meta["refresh_no"] >= 1
    opt = ckpt.load_raw_opt_state(str(run / "checkpoint-4"))
    anchor, horizon = int(opt["2"]["anchor"]), float(opt["2"]["horizon"])
    printed = {}
    for who, main, extra in (("jax", jax_main, ["--no_data_parallel"]),
                             ("port", port_main, ["--device", "cpu"])):
        out = tmp_path / who
        shutil.copytree(run, out)
        main(_loop_flags(data, weights, out, "--max_steps", "8",
                         "--save_steps", "4", "--rewarmup_per_dataset",
                         *extra))
        captured = capsys.readouterr()
        printed[who] = json.loads(captured.out.strip().splitlines()[-1])
        if who == "port":
            assert f"count 4, anchor {anchor}, horizon {horizon}" in \
                captured.err
    assert printed["port"] and len(printed["port"]) == len(printed["jax"])
    for got, want in zip(printed["port"], printed["jax"]):
        _close_numbers(got, want)
    path, step = ckpt.get_latest_checkpoint(str(tmp_path / "port"))
    assert step == 8 and ckpt.is_complete(path)
    saved = torch.load(os.path.join(path, ckpt.OPTIMIZER_FILE),
                       weights_only=True)
    assert saved["count"] == 8


def test_cli_reads_a_jax_ance_loop_directory(jax_loop_dir, tmp_path,
                                             capsys):
    """``infer``, ``serve``, ``generate`` and ``export-hf`` from the JAX
    training directory (its newest checkpoint is orbax): the embeddings
    within 1e-4 of the JAX encoder's (the fp32 forward-parity tolerance),
    ``generate`` cites checkpoint-4, and the export loads into a fresh
    model to the same weights."""
    from ance_tpu.models.registry import get_model_spec as jax_spec
    from ance_tpu_torch.cli import main
    from ance_tpu_torch.models.registry import get_model_spec
    from ance_tpu_torch.models.weights import load_pretrained
    from test_torch_native_checkpoint import _jax_embeddings
    data, _, run = jax_loop_dir
    jparams = jax_ckpt.load_raw_params(str(run / "checkpoint-4"))
    jm = jax_spec("rdot_nll").build(config_overrides=GEOMETRY)
    want_p = _jax_embeddings(jm, jparams, str(data / "passages"),
                             type(jm).body_emb)
    want_q = _jax_embeddings(jm, jparams, str(data / "dev-query"),
                             type(jm).query_emb)
    flags = ["--device", "cpu", "--encoder_overrides", json.dumps(GEOMETRY),
             "--data_dir", str(data), "--max_seq_length", str(PLEN),
             "--max_query_length", str(QLEN)]
    main(["infer", *flags, "--training_dir", str(run), "--output_dir",
          str(tmp_path / "emb")])
    shards = json.loads(capsys.readouterr().out.splitlines()[-1])
    p = np.load(shards["passages"], allow_pickle=True)
    p_ids = np.load(shards["passage_ids"], allow_pickle=True)
    np.testing.assert_allclose(p, want_p[p_ids], atol=1e-4, rtol=0)
    np.testing.assert_allclose(np.load(shards["dev_query"],
                                       allow_pickle=True), want_q,
                               atol=1e-4, rtol=0)
    main(["serve", *flags, "--training_dir", str(run), "--query_cache",
          str(data / "dev-query"), "--topk", "5", "--save_index",
          str(tmp_path / "idx"), "--output", str(tmp_path / "rank.tsv")])
    out = capsys.readouterr()
    assert json.loads(out.out.splitlines()[-1])["params"] == str(
        run / "checkpoint-4" / "state")
    with np.load(str(tmp_path / "idx.npz")) as z:
        np.testing.assert_allclose(z["emb"], want_p, atol=1e-4, rtol=0)
    main(["generate", *flags, "--training_dir", str(run), "--output_dir",
          str(tmp_path / "ann"), "--topk_training", "8",
          "--negative_sample", "2", "--ann_chunk_factor", "1"])
    summary = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert summary["checkpoint"] == str(run / "checkpoint-4")
    main(["export-hf", "--training_dir", str(run), "--out_dir",
          str(tmp_path / "hf"), "--encoder_overrides", json.dumps(GEOMETRY)])
    exported = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert exported["step"] == 4
    fresh = get_model_spec("rdot_nll").build(config_overrides=GEOMETRY)
    load_pretrained(fresh, str(tmp_path / "hf"))
    want = state_dict_from_flax(jax.tree.map(np.asarray, jparams))
    for key, value in fresh.state_dict().items():
        assert torch.equal(value, want[key]), key


if __name__ == "__main__":
    import tempfile
    with tempfile.TemporaryDirectory() as work:
        spec = write_jax_loop_fixture(FIXTURE, work)
    print(json.dumps({k: v for k, v in spec.items() if k != "leaves"}))
