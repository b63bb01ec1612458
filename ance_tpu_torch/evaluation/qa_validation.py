"""Open-QA answer validation (DPR), on the standard library only.

Counterpart of ``ance_tpu/evaluation/qa_validation.py`` (the reference's
utils/dpr_utils.py:232-340): an answer hits a passage when its uncased
token sequence appears contiguously in the passage's, both NFD-normalised.
Used for the top-k hit curve and for answer-filtered negative mining.

The reference tokenizes with the ``regex`` package's classes,
``([\\p{L}\\p{N}\\p{M}]+)|([^\\p{Z}\\p{C}])``. The port reads the same
classes from :func:`unicodedata.category`: a token is a run of letters,
numbers and marks, or any one character that is neither a separator nor
an "other" (control, format, surrogate, private use, unassigned). The two
agree on every code point but those the interpreter's Unicode tables
leave unassigned (``Cn``) and a newer ``regex`` assigns; such a character
splits tokens here (ROADMAP Queue 3). The classes become one compiled
``re`` pattern, built on first use.
"""

from __future__ import annotations

import functools
import re
import sys
import unicodedata
from typing import Iterable, Sequence


def _ranges(codes: list[int]) -> str:
    """A regular-expression class body that lists ``codes`` (ascending) as
    runs ``\\Ua-\\Ub``."""
    out, start = [], codes[0]
    for a, b in zip(codes, codes[1:] + [None]):
        if b != a + 1:  # a closes the run that began at start
            out.append(f"\\U{start:08x}-\\U{a:08x}")
            start = b
    return "".join(out)


@functools.cache
def _token_re() -> re.Pattern:
    """The reference's ``([\\p{L}\\p{N}\\p{M}]+)|([^\\p{Z}\\p{C}])`` with the
    classes read from :func:`unicodedata.category`, built once, on first
    use. ``re`` tests a character outside the Basic Multilingual Plane's
    bitmap against a class's ranges one by one, so each class is split in
    two and the astral ranges are tried only for an astral character: 4x
    faster on text that is nearly all BMP."""
    word, skip = [], []
    for cp in range(sys.maxunicode + 1):
        major = unicodedata.category(chr(cp))[0]
        if major in "LNM":
            word.append(cp)
        elif major in "ZC":
            skip.append(cp)

    def cls(codes: list[int]) -> str:
        bmp = [c for c in codes if c < 0x10000]
        astral = [c for c in codes if c >= 0x10000]
        return (f"[{_ranges(bmp)}]|(?=[\\U00010000-\\U0010ffff])"
                f"[{_ranges(astral)}]")

    return re.compile(f"(?:{cls(word)})+|(?!{cls(skip)}).", re.DOTALL)


def tokenize_words(text: str, uncased: bool = True) -> list[str]:
    """``SimpleTokenizer.tokenize(text).words(uncased)``: the tokens left to
    right, each run of letters, numbers and marks whole."""
    words = _token_re().findall(text)
    return [w.lower() for w in words] if uncased else words


@functools.lru_cache(maxsize=1 << 16)
def _normalized_words(text: str) -> tuple[str, ...]:
    """The uncased tokens of ``text`` after NFD. Cached: validation and
    mining test the same passages and answers for many questions."""
    return tuple(tokenize_words(unicodedata.normalize("NFD", text)))


def has_answer(answers: Iterable[str], text: str | None) -> bool:
    """True iff any answer's token sequence occurs in the text."""
    if text is None:
        return False
    words = _normalized_words(text)
    for answer in answers:
        ans = _normalized_words(answer)
        if not ans:
            continue
        for i in range(0, len(words) - len(ans) + 1):
            if ans == words[i:i + len(ans)]:
                return True
    return False


def check_answer(passage_texts: Sequence[str | None],
                 answers: Iterable[str]) -> list[bool]:
    """Per-passage hit flags for one question's retrieved list (reference
    dpr_utils.py:232-238)."""
    return [has_answer(answers, t) for t in passage_texts]


def coverage_at_k(hit_lists: Sequence[Sequence[bool]],
                  ks: Sequence[int] = (20, 100)) -> dict[int, float]:
    """Fraction of questions with an answer-bearing passage in their top k
    (reference run_ann_data_gen_dpr.py:312-340, the top-k hit curve)."""
    n = max(len(hit_lists), 1)
    return {k: sum(1 for hits in hit_lists if any(hits[:k])) / n
            for k in ks}
