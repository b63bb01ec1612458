"""The port's DPR preprocessing (``data/dpr.py``) and DPR feed
(``data/feed.py::sample_one_neg_triples``, ``train/dpr_trainer.py::
dpr_dev_batches``) against the JAX package's on the same raw files and
tokenizer (``tests/test_dpr.py``'s fake BERT tokenizer): every output file
byte for byte in NQ, TriviaQA and merged mode, in this process and over
two spawned workers, and the same triples and batches.

Spawned workers unpickle the tokenizer factory by importing this module,
so it imports nothing heavy at its top."""

import json
import os

import numpy as np
import pytest


class FakeBertFactory:
    """``tests/test_dpr.py``'s fake BERT tokenizer, imported when called:
    a module-level class, so spawned workers unpickle it."""

    def __call__(self):
        from test_dpr import FakeBertTokenizer
        return FakeBertTokenizer()


def _write_raw(root, rs, n_passages=40):
    """psgs_w100.tsv (a header row, sparse ids, the text fields quoted as
    the real file's are, inner quotes doubled, and a passage longer than
    the sequence), NQ / TriviaQA train and dev
    JSON (questions without positives or hard negatives, which are
    dropped; TriviaQA's ``psg_id`` key), and the two qas CSVs."""
    wiki, qd, ad = root / "wiki", root / "questions", root / "answers"
    for d in (wiki, qd, ad):
        d.mkdir()
    words = [f"w{i}" for i in range(80)] + ['"quoted', "it's", "café"]
    pids = rs.choice(10_000, n_passages, replace=False)
    texts = {}
    with open(wiki / "psgs_w100.tsv", "w", encoding="utf-8") as f:
        f.write("id\ttext\ttitle\n")
        for i, pid in enumerate(pids):
            n = 60 if i == 3 else rs.randint(3, 15)
            texts[int(pid)] = " ".join(rs.choice(words, n))
            quoted = texts[int(pid)].replace('"', '""')
            f.write(f'{pid}\t"{quoted}"\tTitle {i}\n')

    def sample(key, n_neg):
        pos = int(rs.choice(pids))
        return {"question": " ".join(rs.choice(words, rs.randint(2, 6)))
                + ("?" if rs.rand() < 0.5 else ""),
                "answers": [texts[pos].split()[0]],
                "positive_ctxs": [{key: str(pos)}],
                "hard_negative_ctxs": [{key: str(int(p))} for p in
                                       rs.choice(pids, n_neg, False)]}

    for name, key, n in (("nq-train", "passage_id", 9),
                         ("nq-dev", "passage_id", 4),
                         ("trivia-train", "psg_id", 7),
                         ("trivia-dev", "psg_id", 3)):
        data = [sample(key, rs.randint(1, 4)) for _ in range(n)]
        data[1]["positive_ctxs"] = []
        data[2]["hard_negative_ctxs"] = []
        (qd / f"{name}.json").write_text(json.dumps(data))
    for name in ("nq-test", "trivia-test"):
        with open(ad / f"{name}.csv", "w", encoding="utf-8") as f:
            for _ in range(5):
                q = " ".join(rs.choice(words, 4))
                f.write(f"{q}?\t['{rs.choice(words)}', 'x y']\n")
    return wiki, qd, ad


def _tree_bytes(root):
    return {name: open(os.path.join(root, name), "rb").read()
            for name in sorted(os.listdir(root))}


@pytest.mark.parametrize("data_type,workers", [(0, 1), (1, 1), (2, 1),
                                               (0, 2)])
def test_preprocess_dpr_matches_jax_byte_for_byte(tmp_path, data_type,
                                                  workers):
    from ance_tpu.data import dpr as jax_dpr
    from ance_tpu_torch.data import dpr
    wiki, qd, ad = _write_raw(tmp_path, np.random.RandomState(data_type))
    counts = {}
    for name, mod in (("jax", jax_dpr), ("port", dpr)):
        cfg = mod.DprPreprocessConfig(
            wiki_dir=str(wiki), question_dir=str(qd), answer_dir=str(ad),
            out_data_dir=str(tmp_path / name), data_type=data_type,
            max_seq_length=24, num_processes=workers)
        counts[name] = mod.preprocess_dpr(cfg, FakeBertFactory())
    assert counts["port"] == counts["jax"]
    assert counts["port"]["dev"] == 2 and counts["port"]["test"] == 5
    got, want = _tree_bytes(tmp_path / "port"), _tree_bytes(tmp_path / "jax")
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    expected = {"passages", "pid2offset", "train-query", "train-ann",
                "dev-data", "test-query", "trivia-test-query"}
    if data_type == 2:
        expected |= {"train-query-nq", "train-ann-trivia"}
    else:
        expected.add("train-data")
    assert expected <= set(got)
    # the loaders agree, and a rerun is skipped
    out = str(tmp_path / "port")
    assert dpr.load_mapping(out, "pid2offset") == \
        jax_dpr.load_mapping(out, "pid2offset")
    for fn in ("load_answers", "load_positive_ids"):
        assert getattr(dpr, fn)(out + "/train-ann") == \
            getattr(jax_dpr, fn)(out + "/train-ann")
    assert dpr.load_passage_texts(str(wiki / "psgs_w100.tsv")) == \
        jax_dpr.load_passage_texts(str(wiki / "psgs_w100.tsv"))
    assert dpr.preprocess_dpr(cfg, FakeBertFactory()) == {"skipped": True}


def test_encode_fixed_and_questions_match_jax():
    """SEP restored on a cut pair, padding with the pad id, the untruncated
    length reported; a trailing '?' dropped."""
    from ance_tpu.data import dpr as jax_dpr
    from ance_tpu_torch.data import dpr
    from test_dpr import FakeBertTokenizer
    tok = FakeBertTokenizer()
    for text, pair, n in (("a b", None, 6), ("a b c d e f g", "h i j", 6),
                          ("a", "b", 5), ("", None, 3)):
        got = dpr._encode_fixed(tok, n, text, pair)
        assert got == jax_dpr._encode_fixed(tok, n, text, pair)
        assert len(got[1]) == n
    assert dpr._encode_fixed(tok, 6, "a b c d e f g", "h")[1][-1] == 3
    for q in ("why?", "why", "?", "a?b?"):
        assert dpr.normalize_question(q) == jax_dpr.normalize_question(q)


def test_sample_one_neg_triples_and_dev_batches_match_jax(tmp_path):
    """One negative a line by the same ``RandomState`` draws, blank lines
    skipped; the dev batches (first negative, tail dropped) equal."""
    from ance_tpu.data import feed as jax_feed
    from ance_tpu.train import dpr_trainer as jax_dpr_trainer
    from ance_tpu_torch.data.cache import TokenCache, TokenCacheWriter
    from ance_tpu_torch.data import feed
    from ance_tpu_torch.train import dpr_trainer
    rs = np.random.RandomState(0)
    lines = [f"{q}\t{rs.randint(30)}\t"
             + ",".join(str(x) for x in rs.randint(0, 30, rs.randint(1, 6)))
             for q in range(20)]
    lines.insert(7, "")
    for seed in (0, 3, 42):
        got = feed.sample_one_neg_triples(lines, seed=seed)
        np.testing.assert_array_equal(
            got, jax_feed.sample_one_neg_triples(lines, seed=seed))
        assert got.shape == (20, 3) and got.dtype == np.int64
    for name, n, seq in (("q", 20, 8), ("p", 30, 12)):
        with TokenCacheWriter(tmp_path / name, seq) as w:
            for _ in range(n):
                length = rs.randint(2, seq + 1)
                toks = np.zeros(seq, np.int32)
                toks[:length] = rs.randint(1, 99, length)
                w.write(length, toks)
    (tmp_path / "dev").write_text("\n".join(lines) + "\n")
    with TokenCache(tmp_path / "q") as qc, TokenCache(tmp_path / "p") as pc:
        got = list(dpr_trainer.dpr_dev_batches(qc, pc, str(tmp_path / "dev"),
                                               6))
        want = list(jax_dpr_trainer.dpr_dev_batches(
            qc, pc, str(tmp_path / "dev"), 6))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for k in b:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
