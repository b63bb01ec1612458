"""The port's answer validation (``evaluation/qa_validation.py``, on
``unicodedata`` only) against the JAX package's (the ``regex`` package's
classes): the JAX test's cases, seeded strings, and every code point one
at a time between two letters, so a character is caught whether it
joins a word, stands alone as a token or splits the words. The two differ
only on code points the interpreter's Unicode tables leave unassigned
(``Cn``) and the installed ``regex`` assigns."""

import sys
import unicodedata

import numpy as np

from ance_tpu.evaluation import qa_validation as ref
from ance_tpu_torch.evaluation import qa_validation as port


def test_the_jax_cases():
    assert port.tokenize_words("Hello, World!") == \
        ref.tokenize_words("Hello, World!") == ["hello", ",", "world", "!"]
    assert port.has_answer(["the cat"], "I saw The CAT on the mat")
    assert not port.has_answer(["the dog"], "I saw the cat on the mat")
    assert not port.has_answer(["cat"], None)
    assert port.has_answer(["café"], "we met at the café yesterday")
    assert not port.has_answer(["", "  "], "anything")
    hits = [[False, True, False], [False] * 3, [True]]
    assert port.coverage_at_k(hits, ks=(1, 2)) == \
        ref.coverage_at_k(hits, ks=(1, 2))
    assert port.coverage_at_k([], ks=(20,)) == {20: 0.0}
    texts = ["paris, france", None, "Paris!"]
    assert port.check_answer(texts, ["PARIS"]) == \
        ref.check_answer(texts, ["PARIS"]) == [True, False, True]


def test_seeded_strings_match_jax():
    """Strings over letters, digits, marks, punctuation, symbols, spaces,
    controls and other scripts: the same tokens, cased and uncased, and the
    same hits for answers cut from them."""
    pool = list("aZé9٣_-,.'\"()$€+ \t\n ​́　") + \
        ["日本", "Ωμέγα", "ß", "İ", "ẍ", "\U0001f600", "﻿"]
    rs = np.random.RandomState(0)
    for _ in range(500):
        text = "".join(rs.choice(pool, rs.randint(0, 30)))
        for uncased in (True, False):
            assert port.tokenize_words(text, uncased) == \
                ref.tokenize_words(text, uncased), repr(text)
        words = text.split()
        answer = " ".join(words[:rs.randint(0, 3)])
        for candidate in (text, text[::-1]):
            assert port.has_answer([answer], candidate) == \
                ref.has_answer([answer], candidate), (answer, candidate)


def test_every_code_point_matches_jax_but_the_unassigned():
    """Each code point c in "a" + c + "b": the tokens agree everywhere but
    on a set of code points that ``unicodedata`` (Unicode
    ``unidata_version``) leaves unassigned (``Cn``) and ``regex`` classes
    outside separators and others; that set is exactly the ``Cn`` code
    points ``regex`` gives such a class."""
    import regex  # the JAX module's dependency (not the port's)
    other = regex.compile(r"[\p{Z}\p{C}]")
    differ, cn_assigned = set(), set()
    for cp in range(sys.maxunicode + 1):
        c = chr(cp)
        s = "a" + c + "b"
        if port.tokenize_words(s) != ref.tokenize_words(s):
            differ.add(cp)
        if unicodedata.category(c) == "Cn" and not other.match(c):
            cn_assigned.add(cp)
    assert differ == cn_assigned
    assert all(unicodedata.category(chr(cp)) == "Cn" for cp in differ)
