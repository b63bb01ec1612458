"""The port's own host I/O (token caches, masks, tokenization padding, the
serve CLI's id maps and ranking writer) against the JAX package's, on the
same inputs: the port imports nothing of ``ance_tpu``, so these copies must
stay byte- and value-identical to the originals."""

import io
import pickle

import numpy as np
import pytest
import torch

from ance_tpu import cli as jax_cli
from ance_tpu.data.cache import TokenCache as JaxCache
from ance_tpu.data.cache import TokenCacheWriter as JaxWriter
from ance_tpu.data.feed import mask_from_lengths as jax_mask
from ance_tpu.data.process_fn import encode_padded as jax_encode_padded
from ance_tpu_torch import cli as port_cli
from ance_tpu_torch.data.cache import TokenCache, TokenCacheWriter
from ance_tpu_torch.data.process_fn import encode_padded
from ance_tpu_torch.train.encode import mask_from_lengths

torch.set_num_threads(1)


def _records(seed, n=23, seq=11):
    rs = np.random.RandomState(seed)
    return rs.randint(1, seq + 1, n), rs.randint(0, 50265, (n, seq))


def _write(writer_cls, base, lengths, tokens, dtype):
    with writer_cls(str(base), tokens.shape[1], dtype) as w:
        offsets = [w.write(int(n), row) for n, row in zip(lengths, tokens)]
    return offsets


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_token_cache_writer_is_byte_identical(tmp_path, dtype):
    lengths, tokens = _records(0)
    assert _write(TokenCacheWriter, tmp_path / "port", lengths, tokens,
                  dtype) == list(range(len(lengths)))
    _write(JaxWriter, tmp_path / "jax", lengths, tokens, dtype)
    for suffix in ("", "_meta"):
        assert (tmp_path / f"port{suffix}").read_bytes() == \
            (tmp_path / f"jax{suffix}").read_bytes()


@pytest.mark.parametrize("keys", [[0, 5, 22, 5], list(range(23))])
def test_token_cache_reads_jax_caches(tmp_path, keys):
    lengths, tokens = _records(1)
    _write(JaxWriter, tmp_path / "c", lengths, tokens, "int32")
    with TokenCache(tmp_path / "c") as pc, JaxCache(tmp_path / "c") as jc:
        assert len(pc) == len(jc) == 23
        assert pc.embedding_size == jc.embedding_size == 11
        pl, pt = pc.batch(keys)
        jl, jt = jc.batch(keys)
    np.testing.assert_array_equal(pl, jl)
    np.testing.assert_array_equal(pt, jt)
    assert pt.dtype == jt.dtype == np.int32


def test_token_cache_writer_rejects_wrong_width(tmp_path):
    with TokenCacheWriter(tmp_path / "c", 4) as w:
        with pytest.raises(ValueError, match="shape"):
            w.write(2, [1, 2, 3])


def test_mask_from_lengths_matches_jax():
    lengths = np.array([0, 1, 5, 8])
    got = mask_from_lengths(lengths, 8)
    np.testing.assert_array_equal(got, jax_mask(lengths, 8))
    assert got.dtype == np.int32


class _Tok:
    """Whitespace tokenizer with HF's encode signature; pad id 1."""
    pad_token_id = 1

    def encode(self, text, add_special_tokens=True, max_length=None):
        return [0] + [len(w) + 3 for w in text.split()] + [2]


@pytest.mark.parametrize("text,max_len", [("a bb ccc", 8), (" x y ", 3),
                                          ("", 4)])
def test_encode_padded_matches_jax(text, max_len):
    got = encode_padded(_Tok(), text, max_len)
    want = jax_encode_padded(_Tok(), text, max_len)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


@pytest.mark.parametrize("spec", ["127.0.0.1:8080", "[::1]:0", ":9000",
                                  "host", "h:x", "::1:80", "h:70000"])
def test_parse_host_port_matches_jax(spec):
    def outcome(fn):
        try:
            return fn(spec)
        except SystemExit as e:
            return ("exit", str(e))
    assert outcome(port_cli._parse_host_port) == \
        outcome(jax_cli._parse_host_port)


@pytest.mark.parametrize("form", ["pickle", "text", "missing"])
def test_offset2id_lookup_matches_jax(tmp_path, form):
    mapping = {1007: 2, 5: 0, 42: 3}  # offset 1 unmapped → −1
    if form == "pickle":
        with open(tmp_path / "pid2offset.pickle", "wb") as f:
            pickle.dump(mapping, f)
    elif form == "text":
        (tmp_path / "pid2offset").write_text(
            "".join(f"{a}\t{b}\n" for a, b in mapping.items()))
    got = port_cli._offset2id_lookup(str(tmp_path), "pid2offset")
    want = jax_cli._offset2id_lookup(str(tmp_path), "pid2offset")
    if form == "missing":
        assert got is None and want is None
    else:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, [5, -1, 1007, 42])


@pytest.mark.parametrize("fmt,with_scores", [("msmarco", False),
                                             ("msmarco", True),
                                             ("trec", False)])
def test_write_ranking_matches_jax(fmt, with_scores):
    qids = [3, 9]
    pids = np.array([[10, 11, 12], [20, -1, -1]])
    scores = np.array([[3.5, 2.25, -1.0], [0.125, -np.inf, -np.inf]],
                      np.float32)
    outs = []
    for fn in (port_cli._write_ranking, jax_cli._write_ranking):
        buf = io.StringIO()
        fn(buf, qids, pids, scores, with_scores, fmt, "D", "tag")
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert len(outs[0].splitlines()) == 4
