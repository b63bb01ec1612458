"""The port's WordPiece tokenizer (``ance_tpu_torch/data/wordpiece.py``, its
C++ core built from ``ance_tpu_torch/native/wordpiece.cpp``) against the
JAX package's on ``tests/test_wordpiece.py``'s vocabulary, texts and fuzz
set, ASCII and not: token ids equal exactly, on both of the port's cores."""

import random

import pytest

from ance_tpu.data import wordpiece as jwp
from ance_tpu_torch.data import wordpiece as pwp
from test_wordpiece import VOCAB_TOKENS

TEXTS = ["The Quick, brown FOX jumped over the lazy dog!",
         "unbelievable!!! hello world 2023", "a b c ' , . !", "", "    ",
         "x" * 150, "unbelievable hello world", "Café au lait!",
         "don't stop 2023", "tab\tand\nnewline", "THE QUICK [SEP] FOX",
         "[CLS]the[MASK] quick<mask>", "naïve façade — 東京 fox",
         "Ünïcödé spaces　and​zero width", "café"]


@pytest.fixture(scope="module")
def vocab_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    p.write_text("\n".join(VOCAB_TOKENS) + "\n")
    return str(p)


def _fuzz(alphabet, n, seed):
    rnd = random.Random(seed)
    return ["".join(rnd.choice(alphabet) for _ in range(rnd.randint(0, 60)))
            for _ in range(n)]


ASCII_FUZZ = _fuzz(list("abcdefghijklmnopqrstuvwxyzABCDE !,.'\"-[]{}\t\n"
                        "0123456789"), 300, 0)
UNICODE_FUZZ = _fuzz(list("abcXYZ éüçÉ東京—・！　 ,.'[]") + ["[SEP]", "<mask>"],
                     100, 1)


def test_basic_tokenize_and_wordpiece_match_jax():
    vocab = {t: i for i, t in enumerate(VOCAB_TOKENS)}
    for text in TEXTS + UNICODE_FUZZ:
        for lower in (True, False):
            words = pwp.basic_tokenize(text, lower)
            assert words == jwp.basic_tokenize(text, lower), text
            for w in words:
                assert pwp.wordpiece(w, vocab) == jwp.wordpiece(w, vocab), w


@pytest.mark.parametrize("native", [True, False])
def test_wordpiece_tokenizer_matches_jax(vocab_file, native):
    """Single texts, pairs and truncation; the port's native core (ASCII
    segments in C++, the rest in Python, as in JAX) and its Python path
    alone give JAX's ids."""
    port = pwp.WordPieceTokenizer.from_vocab_file(vocab_file, native=native)
    ref = jwp.WordPieceTokenizer.from_vocab_file(vocab_file)
    assert port.core == ("native" if native else "python")
    assert (port.pad_token_id, port.sep_token, port.cls_token_id) == \
        (ref.pad_token_id, ref.sep_token, ref.cls_token_id)
    for text in TEXTS + ASCII_FUZZ + UNICODE_FUZZ:
        assert port.encode(text) == ref.encode(text), repr(text)
        assert port.encode(text, add_special_tokens=False, max_length=5) \
            == ref.encode(text, add_special_tokens=False, max_length=5)
    assert port.encode("hello", text_pair="world brown") == \
        ref.encode("hello", text_pair="world brown")


@pytest.mark.parametrize("native", [True, False])
def test_seed_tokenizer_matches_jax(vocab_file, native):
    """``<mask>`` appended; lowercasing around the specials; no accent
    stripping in the WordPiece (a 'café' not in the vocabulary is UNK)."""
    port = pwp.SeedTokenizer.from_vocab_file(vocab_file, native=native)
    ref = jwp.SeedTokenizer.from_vocab_file(vocab_file)
    assert port.mask_token_id == ref.mask_token_id == len(VOCAB_TOKENS)
    assert port.vocab == ref.vocab
    for text in TEXTS + ASCII_FUZZ[:100] + UNICODE_FUZZ:
        for special in (True, False):
            assert port.encode(text, add_special_tokens=special) == \
                ref.encode(text, add_special_tokens=special), repr(text)
    assert port.encode("café", add_special_tokens=False) == \
        [port.unk_token_id]


def test_native_core_matches_python(vocab_file):
    """The port's own build: the C++ core equals the Python path on every
    ASCII text of the fuzz set, through ``_native.encode`` directly."""
    from ance_tpu_torch.utils import native_build
    tok = pwp.WordPieceTokenizer.from_vocab_file(vocab_file)
    assert tok.core == "native"
    assert native_build.library_path("wordpiece").exists()
    assert native_build.library_path("wordpiece").parent == \
        native_build.PACKAGE_DIR / "build"
    for text in TEXTS[:6] + ASCII_FUZZ:
        python = [tok.vocab.get(p, tok.unk_token_id)
                  for w in pwp.basic_tokenize(text, tok.lowercase)
                  for p in pwp.wordpiece(w, tok.vocab, tok.unk_token)]
        assert tok._native.encode(text) == python, repr(text)


def test_failed_build_raises(tmp_path, monkeypatch, vocab_file):
    """A source g++ refuses raises with its stderr; nothing falls back to
    the Python path. A vocabulary with a repeated line (ids not
    contiguous) runs the Python core and says so."""
    from ance_tpu_torch.utils import native_build
    (tmp_path / "native").mkdir()
    (tmp_path / "native" / "wordpiece.cpp").write_text("not c++ at all\n")
    monkeypatch.setattr(native_build, "NATIVE_DIR", tmp_path / "native")
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_build, "_cache", {})
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        pwp.WordPieceTokenizer.from_vocab_file(vocab_file)
    assert not list((tmp_path / "build").glob("*.so"))
    monkeypatch.undo()
    dup = tmp_path / "dup.txt"
    dup.write_text("\n".join(VOCAB_TOKENS + ["the"]) + "\n")
    tok = pwp.WordPieceTokenizer.from_vocab_file(str(dup))
    assert tok.core == "python"
    assert tok.encode("the quick fox") == \
        jwp.WordPieceTokenizer.from_vocab_file(str(dup)).encode(
            "the quick fox")


CONTROL_TEXTS = ["del\x7fin the middle", "nul\x00in the middle",
                 "\x00leading nul", "trailing del\x7f", "a\x00\x7f\x01b c",
                 "x\x00" * 30, "bell\x07 and escape\x1b[1m"]


def test_native_core_drops_del_and_nul_as_python(vocab_file):
    """DEL (127, category Cc) and NUL are dropped by the Python path; the
    C++ core now drops them too (DEL as a control byte, NUL no longer the
    end of the text, whose byte count is passed in), on its own and
    through the tokenizer, which routes such ASCII text to it."""
    native = pwp.WordPieceTokenizer.from_vocab_file(vocab_file)
    python = pwp.WordPieceTokenizer.from_vocab_file(vocab_file,
                                                    native=False)
    assert native.core == "native"
    rnd = random.Random(2)
    fuzz = ["".join(rnd.choice("ab c,\x00\x7f\x1f") for _ in range(40))
            for _ in range(100)]
    for text in CONTROL_TEXTS + fuzz:
        want = [python.vocab.get(p, python.unk_token_id)
                for w in pwp.basic_tokenize(text, python.lowercase)
                for p in pwp.wordpiece(w, python.vocab, python.unk_token)]
        assert native._native.encode(text) == want, repr(text)
        assert native.encode(text) == python.encode(text), repr(text)
