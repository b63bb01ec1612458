"""WordPiece tokenizer: a C++ core with a pure-Python reference
(counterpart of ``ance_tpu/data/wordpiece.py``, which the port does not
import).

Replaces the HF Rust ``BertWordPieceTokenizer`` the reference leans on for
SEED tokenization (reference model/SEED_Encoder/tokenization_seed_encoder.py:
25, 292). Semantics are BERT's: basic tokenization (lowercase, accent
strip, punctuation split, CJK isolation) followed by greedy
longest-match-first WordPiece with ``##`` continuations.

The C++ core (``ance_tpu_torch/native/wordpiece.cpp``, built by
``utils/native_build.py``, loaded through ctypes) takes ASCII text;
non-ASCII text goes through the Python path, as in the JAX package. Where
the JAX package falls back to Python on any failure, a failed build
raises here. ``core`` says which core a tokenizer runs: ``"native"``, or
``"python"`` when asked for (``native=False``) or when the vocabulary's
ids are not contiguous (a ``vocab.txt`` with a repeated line), which the C
core cannot hold.
"""

from __future__ import annotations

import os
import unicodedata
from typing import Optional, Sequence

_PUNCT_RANGES = ((33, 47), (58, 64), (91, 96), (123, 126))


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if any(lo <= cp <= hi for lo, hi in _PUNCT_RANGES):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF) or
            (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F) or
            (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF) or
            (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def basic_tokenize(text: str, lowercase: bool = True) -> list[str]:
    """BERT BasicTokenizer: clean, CJK-isolate, whitespace-split, lowercase +
    strip accents, punctuation-split."""
    cleaned = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        if _is_cjk(cp):
            cleaned.append(f" {ch} ")
        elif unicodedata.category(ch) == "Zs" or ch in " \t\n\r":
            cleaned.append(" ")
        else:
            cleaned.append(ch)
    tokens = "".join(cleaned).split()
    out: list[str] = []
    for tok in tokens:
        if lowercase:
            tok = tok.lower()
            tok = "".join(c for c in unicodedata.normalize("NFD", tok)
                          if unicodedata.category(c) != "Mn")
        # split on punctuation
        cur: list[str] = []
        for ch in tok:
            if _is_punctuation(ch):
                if cur:
                    out.append("".join(cur))
                    cur = []
                out.append(ch)
            else:
                cur.append(ch)
        if cur:
            out.append("".join(cur))
    return out


def wordpiece(token: str, vocab: dict[str, int], unk_token: str = "[UNK]",
              max_chars: int = 100) -> list[str]:
    """Greedy longest-match-first subword split."""
    if len(token) > max_chars:
        return [unk_token]
    pieces: list[str] = []
    start = 0
    while start < len(token):
        end = len(token)
        cur = None
        while start < end:
            sub = token[start:end]
            if start > 0:
                sub = "##" + sub
            if sub in vocab:
                cur = sub
                break
            end -= 1
        if cur is None:
            return [unk_token]
        pieces.append(cur)
        start = end
    return pieces


class WordPieceTokenizer:
    """BERT-style tokenizer over a ``vocab.txt`` (one token per line)."""

    def __init__(self, vocab: dict[str, int], lowercase: bool = True,
                 cls_token: str = "[CLS]", sep_token: str = "[SEP]",
                 pad_token: str = "[PAD]", unk_token: str = "[UNK]",
                 native: bool = True):
        self.vocab = vocab
        self.lowercase = lowercase
        self.cls_token, self.sep_token = cls_token, sep_token
        self.pad_token, self.unk_token = pad_token, unk_token
        self.cls_token_id = vocab[cls_token]
        self.sep_token_id = vocab[sep_token]
        self.pad_token_id = vocab[pad_token]
        self.unk_token_id = vocab[unk_token]
        # special-token literals in raw text are never split (HF
        # BasicTokenizer never_split / tokenizers added-tokens semantics)
        specials = [cls_token, sep_token, pad_token, unk_token, "[MASK]",
                    "<mask>"]
        self._specials = {s for s in specials if s in vocab}
        import re as _re
        self._special_re = _re.compile(
            "(" + "|".join(_re.escape(s) for s in
                           sorted(self._specials, key=len, reverse=True)) +
            ")") if self._specials else None
        self._native = _load_native(vocab, unk_token, lowercase) \
            if native else None
        self.core = "python" if self._native is None else "native"

    @classmethod
    def from_vocab_file(cls, path: str | os.PathLike, **kw
                        ) -> "WordPieceTokenizer":
        return cls(read_vocab(path), **kw)

    def tokenize(self, text: str) -> list[str]:
        out: list[str] = []
        for is_special, seg in self._segments(text):
            if is_special:
                out.append(seg)
                continue
            for tok in basic_tokenize(seg, self.lowercase):
                out.extend(wordpiece(tok, self.vocab, self.unk_token))
        return out

    def _segments(self, text: str):
        """Split text on special-token literals (kept atomic)."""
        if self._special_re is None:
            yield False, text
            return
        for part in self._special_re.split(text):
            if not part:
                continue
            yield part in self._specials, part

    def _token_ids(self, text: str) -> list[int]:
        out: list[int] = []
        for is_special, seg in self._segments(text):
            if is_special:
                out.append(self.vocab[seg])
            # C++ core handles the ASCII fast path; non-ASCII goes through
            # the Python reference (accent strip / CJK / unicode categories)
            elif self._native is not None and seg.isascii():
                out.extend(self._native.encode(seg))
            else:
                for tok in basic_tokenize(seg, self.lowercase):
                    out.extend(self.vocab.get(p, self.unk_token_id)
                               for p in wordpiece(tok, self.vocab,
                                                  self.unk_token))
        return out

    def encode(self, text: str, text_pair: Optional[str] = None,
               add_special_tokens: bool = True,
               max_length: Optional[int] = None) -> list[int]:
        ids = self._token_ids(text)
        if add_special_tokens:
            ids = [self.cls_token_id] + ids + [self.sep_token_id]
        if text_pair is not None:
            pair = self._token_ids(text_pair)
            ids = ids + pair + ([self.sep_token_id] if add_special_tokens
                                else [])
        if max_length is not None:
            ids = ids[:max_length]
        return ids


class SeedTokenizer(WordPieceTokenizer):
    """SEED-Encoder tokenizer (reference tokenization_seed_encoder.py:49-258).

    WordPiece over the SEED ``vocab.txt`` with NO case-folding or accent
    stripping at the tokenizer level (BertWordPieceTokenizer(lowercase=False,
    strip_accents=False), reference :292) plus ``<mask>`` appended; the
    ``do_lower_case`` flag instead lowercases the raw TEXT around special
    tokens before encoding (reference :252-257).
    """

    SPECIALS = ("[CLS]", "[PAD]", "[UNK]", "[SEP]")

    def __init__(self, vocab: dict[str, int], do_lower_case: bool = True,
                 native: bool = True):
        if "<mask>" not in vocab:
            vocab = dict(vocab)
            vocab["<mask>"] = len(vocab)
        super().__init__(vocab, lowercase=False, native=native)
        self.do_lower_case = do_lower_case
        self.mask_token_id = vocab["<mask>"]

    @classmethod
    def from_vocab_file(cls, path, do_lower_case: bool = True,
                        native: bool = True) -> "SeedTokenizer":
        return cls(read_vocab(path), do_lower_case, native)

    def _lower_preserving_specials(self, text: str) -> str:
        import re
        escaped = [re.escape(t) for t in self.SPECIALS]
        pattern = r"(" + r"|".join(escaped) + r")|(.+?)"
        return re.sub(pattern,
                      lambda m: m.groups()[0] or m.groups()[1].lower(), text)

    def encode(self, text, text_pair=None, add_special_tokens=True,
               max_length=None):
        if self.do_lower_case:
            text = self._lower_preserving_specials(text)
            if text_pair is not None:
                text_pair = self._lower_preserving_specials(text_pair)
        return super().encode(text, text_pair,
                              add_special_tokens=add_special_tokens,
                              max_length=max_length)


def read_vocab(path: str | os.PathLike) -> dict[str, int]:
    """``vocab.txt`` (or a directory holding one) → {token: line number}; a
    repeated line keeps its last number, as the JAX reader does."""
    path = str(path)
    if os.path.isdir(path):
        path = os.path.join(path, "vocab.txt")
    vocab: dict[str, int] = {}
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            vocab[line.rstrip("\n")] = i
    return vocab


def _load_native(vocab: dict[str, int], unk_token: str, lowercase: bool):
    """The C++ core for ``vocab``, or None where its ids are not contiguous.
    A failed build raises."""
    from ance_tpu_torch.data import wordpiece_native
    if not wordpiece_native.contiguous(vocab):
        return None
    return wordpiece_native.NativeWordPiece(vocab, unk_token, lowercase)
