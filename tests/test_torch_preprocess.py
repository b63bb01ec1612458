"""The port's preprocessing (``data/preprocess.py``, ``data/cache.py::
merge_split_files``, ``data/process_fn.py``, ``cli preprocess``) against
the JAX package's on the same tiny TSVs and tokenizer: the same files byte
for byte in passage and document mode, in this process and over two
spawned workers, and the same batches from the raw-text streams.

Spawned workers unpickle the tokenizer factory by importing this module,
so it imports nothing heavy at its top."""

import json
import os
import pickle
import zlib

import numpy as np
import pytest


class WordTokenizer:
    """Deterministic word → id tokenizer with HF's ``encode`` signature:
    ``<s>`` 0, pad 1, ``</s>`` 2, words by crc32 (stable across
    processes, unlike ``hash``), truncated to ``max_length``."""
    pad_token_id = 1
    sep_token = "</s>"

    def encode(self, text, add_special_tokens=True, max_length=None):
        ids = [3 + zlib.crc32(w.encode()) % 97 for w in text.split()]
        if add_special_tokens:
            ids = [0] + ids + [2]
        return ids[:max_length] if max_length is not None else ids


def make_tokenizer():
    return WordTokenizer()


def _words(rs, n):
    return " ".join(f"w{rs.randint(60)}" for _ in range(n))


def _write_raw(root, data_type, seed=0):
    """A tiny MS MARCO layout: 13 passages or documents (one longer than
    the sequence and, in document mode, than ``max_doc_character``), train
    queries with one that has no qrel (dropped), dev queries."""
    rs = np.random.RandomState(seed)
    raw = root / "raw"
    raw.mkdir()
    pids = rs.permutation(np.arange(100, 113))
    if data_type == 1:
        with open(raw / "collection.tsv", "w") as f:
            for i, pid in enumerate(pids):
                f.write(f"{pid}\t{_words(rs, 30 if i == 4 else 3 + i)} \n")
        files = {"train": ("queries.train.tsv", "qrels.train.tsv"),
                 "dev": ("queries.dev.small.tsv", "qrels.dev.small.tsv")}
        qrel = "{q}\t0\t{p}\t1\n"
    else:
        with open(raw / "msmarco-docs.tsv", "w") as f:
            for i, pid in enumerate(pids):
                body = _words(rs, 60 if i == 4 else 4 + i)
                f.write(f"D{pid}\thttp://x/{pid} \t{_words(rs, 2)}\t{body}\n")
        files = {"train": ("msmarco-doctrain-queries.tsv",
                           "msmarco-doctrain-qrels.tsv"),
                 "dev": ("msmarco-test2019-queries.tsv",
                         "2019qrels-docs.txt")}
        qrel = "{q} 0 D{p} 1\n"
    for split, (qfile, relfile) in files.items():
        qids = rs.choice(np.arange(1000, 1100), 7, replace=False)
        with open(raw / qfile, "w") as f:
            f.writelines(f"{q}\t{_words(rs, 2 + q % 5)}\n" for q in qids)
        with open(raw / relfile, "w") as f:
            for q in qids[:-1]:  # the last query has no qrel
                f.write(qrel.format(q=q, p=rs.choice(pids)))
    return str(raw)


def _tree_bytes(path):
    return {name: open(os.path.join(path, name), "rb").read()
            for name in sorted(os.listdir(path))}


@pytest.mark.parametrize("num_processes", [1, 2])
@pytest.mark.parametrize("data_type", [1, 0])
def test_preprocess_writes_the_jax_files(tmp_path, data_type, num_processes):
    """Caches, their meta files, the id-map pickles (the per-split copies
    included) and the offset-space qrels: byte-identical; the returned
    maps equal; the unjudged query dropped; a second call skips."""
    from ance_tpu.data import preprocess as jax_pre
    from ance_tpu_torch.data import preprocess as pre

    raw = _write_raw(tmp_path, data_type)
    out = {}
    for name, mod in (("port", pre), ("jax", jax_pre)):
        cfg = mod.PreprocessConfig(
            data_dir=raw, out_data_dir=str(tmp_path / name),
            data_type=data_type, max_seq_length=12, max_query_length=6,
            max_doc_character=80, num_processes=num_processes)
        out[name] = (mod.preprocess(cfg, make_tokenizer), cfg)
    (port_maps, cfg), (jax_maps, _) = out["port"], out["jax"]
    assert port_maps == jax_maps
    assert len(port_maps["pid2offset"]) == 13
    assert len(port_maps["train_qid2offset"]) == 6  # one without a qrel
    got, want = _tree_bytes(tmp_path / "port"), _tree_bytes(tmp_path / "jax")
    assert sorted(got) == sorted(want) == sorted([
        "passages", "passages_meta", "pid2offset.pickle",
        "qid2offset.pickle", "train-query", "train-query_meta",
        "train-query_qid2offset.pickle", "train-qrel.tsv", "dev-query",
        "dev-query_meta", "dev-query_qid2offset.pickle", "dev-qrel.tsv"])
    for name in want:
        assert got[name] == want[name], name
    assert pre.load_id_map(str(tmp_path / "port" / "pid2offset.pickle")) == \
        port_maps["pid2offset"]
    assert pre.preprocess(cfg, make_tokenizer) == {"skipped": True}
    assert _tree_bytes(tmp_path / "port") == got


def test_records_hold_the_tokenizer_ids(tmp_path):
    """Each passage record is its line's ids, cut to the sequence; each
    qrel line points at its query's and passage's rows."""
    from ance_tpu_torch.data import preprocess as pre
    from ance_tpu_torch.data.cache import TokenCache
    raw = _write_raw(tmp_path, 1)
    cfg = pre.PreprocessConfig(data_dir=raw, out_data_dir=str(tmp_path / "o"),
                               max_seq_length=12, max_query_length=6,
                               num_processes=1)
    maps = pre.preprocess(cfg, make_tokenizer)
    tok = WordTokenizer()
    with open(os.path.join(raw, "collection.tsv")) as f:
        lines = [line.split("\t") for line in f]
    with TokenCache(str(tmp_path / "o" / "passages")) as pc:
        lengths, tokens = pc.batch([maps["pid2offset"][int(p)]
                                    for p, _ in lines])
    for (_, text), n, row in zip(lines, lengths, tokens):
        ids = tok.encode(text.rstrip(), max_length=12)
        assert n == len(ids) and row[:n].tolist() == ids
        assert (row[n:] == 1).all()
    real = {}
    with open(os.path.join(raw, "qrels.train.tsv")) as f:
        for line in f:
            q, _, p, _ = line.split("\t")
            real[int(q)] = int(p)
    with open(tmp_path / "o" / "train-qrel.tsv") as f:
        rows = [tuple(map(int, line.split("\t"))) for line in f]
    assert sorted((maps["train_qid2offset"][q], maps["pid2offset"][p], 1)
                  for q, p in real.items()) == sorted(rows)


def test_merge_split_files_matches_jax(tmp_path):
    """Split files of id-prefixed records merge split after split into the
    same cache bytes and id → offset map, ``keep_id`` dropping ids."""
    from ance_tpu.data.cache import merge_split_files as jax_merge
    from ance_tpu_torch.data.cache import (TokenCache, iter_split_records,
                                           merge_split_files)
    rs = np.random.RandomState(5)
    L = 5
    for i in range(3):
        split = b"".join(
            rid.to_bytes(8, "big") + int(rs.randint(1, L + 1)).to_bytes(
                4, "big") + rs.randint(0, 99, L).astype(np.int32).tobytes()
            for rid in range(i, 20, 3))
        for base in ("port", "jax"):
            (tmp_path / f"{base}_split{i}").write_bytes(split)
    records = list(iter_split_records(str(tmp_path / "port"), 3, 12 + 4 * L))
    assert [int.from_bytes(r[:8], "big") for r in records] == \
        [r for i in range(3) for r in range(i, 20, 3)]
    keep = lambda rid: rid % 4 != 1  # noqa: E731
    got = merge_split_files(str(tmp_path / "port"), 3, L, keep_id=keep)
    want = jax_merge(str(tmp_path / "jax"), 3, L, keep_id=keep)
    assert got == want and 1 not in got and len(got) == 15
    for suffix in ("", "_meta"):
        assert (tmp_path / f"port{suffix}").read_bytes() == \
            (tmp_path / f"jax{suffix}").read_bytes()
    with TokenCache(str(tmp_path / "port")) as c:
        assert len(c) == 15


@pytest.mark.parametrize("num_hosts,host_id", [(1, 0), (2, 0), (2, 1)])
def test_process_fns_match_jax(num_hosts, host_id):
    """``triple_batches`` / ``dual_batches`` / ``encode_padded``: the same
    arrays and dtypes, host striping included, and the same refusal of a
    line with the wrong number of cells."""
    from ance_tpu.data import process_fn as jax_fn
    from ance_tpu_torch.data import process_fn as fn
    rs = np.random.RandomState(num_hosts + host_id)
    tok = WordTokenizer()
    triples = [f"{_words(rs, 1 + i % 4)}\t{_words(rs, 5 + i % 9)}\t"
               f"{_words(rs, 2 + i % 11)}\n" for i in range(23)]
    duals = [f"{500 + i}\t {_words(rs, 1 + i % 13)} \n" for i in range(11)]
    for got_it, want_it in (
            (fn.triple_batches(tok, triples, 4, 8, host_id, num_hosts),
             jax_fn.triple_batches(tok, triples, 4, 8, host_id, num_hosts)),
            (fn.dual_batches(tok, duals, 4, 10, host_id, num_hosts),
             jax_fn.dual_batches(tok, duals, 4, 10, host_id, num_hosts))):
        n = 0
        for got, want in zip(got_it, want_it, strict=True):
            assert sorted(got) == sorted(want)
            for key in want:
                assert got[key].dtype == want[key].dtype, key
                np.testing.assert_array_equal(got[key], want[key])
            n += 1
        assert n >= 1
    for text in ("", "  w1 w2 ", _words(rs, 30)):
        for a, b in zip(fn.encode_padded(tok, text, 7),
                        jax_fn.encode_padded(tok, text, 7)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    for mod in (fn, jax_fn):
        with pytest.raises(ValueError, match="Expected 3"):
            list(mod.triple_batches(tok, ["a\tb\n"], 1, 4))
        with pytest.raises(ValueError, match="Expected 2"):
            list(mod.dual_batches(tok, ["a\tb\tc\n"], 1, 4))


def test_cli_preprocess_matches_ance_preprocess(tmp_path, capsys,
                                                monkeypatch):
    """``cli preprocess`` against ``ance preprocess`` with the tokenizer
    factory of each replaced by the word tokenizer: the same printed map
    sizes and the same files; the port's factory pickles (spawned workers
    rebuild it); and with ``--model_type seeddot_nll`` the port's
    seed-wordpiece tokenizer (its C++ core) writes ``ance preprocess``'s
    files byte for byte."""
    from ance_tpu import cli as jax_cli
    from ance_tpu_torch import cli as port_cli

    raw = _write_raw(tmp_path, 1)
    monkeypatch.setattr(jax_cli, "_tokenizer_factory",
                        lambda name, model_dir: make_tokenizer)
    monkeypatch.setattr(port_cli, "_load_tokenizer",
                        lambda name, model_dir: WordTokenizer())
    printed = {}
    for name, main in (("port", port_cli.main), ("jax", jax_cli.main)):
        main(["preprocess", "--data_dir", raw, "--out_data_dir",
              str(tmp_path / name), "--max_seq_length", "12",
              "--max_query_length", "6", "--num_processes", "1"])
        printed[name] = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert printed["port"] == printed["jax"] == {
        "pid2offset": 13, "train_qid2offset": 6, "dev_qid2offset": 6}
    assert _tree_bytes(tmp_path / "port") == _tree_bytes(tmp_path / "jax")
    factory = pickle.loads(pickle.dumps(
        port_cli.TokenizerFactory("roberta-base", None)))
    assert isinstance(factory(), WordTokenizer)
    # SEED: the seed-wordpiece tokenizer over a vocab.txt (the factory
    # pickles, so spawned workers rebuild it: chip_smoke.py runs four),
    # the same files as ``ance preprocess``'s
    monkeypatch.undo()
    vocab = tmp_path / "vocab"
    vocab.mkdir()
    (vocab / "vocab.txt").write_text("\n".join(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
        + [f"w{i}" for i in range(50)] + ["w", "##5", "##7"]) + "\n")
    with pytest.raises(SystemExit, match="pointing at a vocab.txt"):
        port_cli.TokenizerFactory("seed-wordpiece", None)()
    seed_tok = pickle.loads(pickle.dumps(
        port_cli.TokenizerFactory("seed-wordpiece", str(vocab))))()
    assert seed_tok.core == "native" and seed_tok.pad_token_id == 0
    for name, main in (("seed_port", port_cli.main),
                       ("seed_jax", jax_cli.main)):
        main(["preprocess", "--model_type", "seeddot_nll",
              "--model_name_or_path", str(vocab), "--data_dir", raw,
              "--out_data_dir", str(tmp_path / name), "--max_seq_length",
              "12", "--max_query_length", "6", "--num_processes", "1"])
        printed[name] = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert printed["seed_port"] == printed["seed_jax"] == printed["jax"]
    assert _tree_bytes(tmp_path / "seed_port") == \
        _tree_bytes(tmp_path / "seed_jax")
