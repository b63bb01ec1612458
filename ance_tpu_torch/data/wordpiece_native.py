"""ctypes bridge to the port's C++ WordPiece core
(``ance_tpu_torch/native/wordpiece.cpp``; counterpart of
``ance_tpu/data/wordpiece_native.py``).

Built by :mod:`ance_tpu_torch.utils.native_build`, which raises when the
library cannot be built: the port never falls back to the Python path
because a build failed.
"""

from __future__ import annotations

import ctypes

from ance_tpu_torch.utils.native_build import load_native


def _lib() -> ctypes.CDLL:
    lib = load_native("wordpiece")
    if lib.wp_create.restype is not ctypes.c_void_p:
        lib.wp_create.restype = ctypes.c_void_p
        lib.wp_create.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                  ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.wp_encode.restype = ctypes.c_int
        lib.wp_encode.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                                  ctypes.c_int]
        lib.wp_free.argtypes = [ctypes.c_void_p]
    return lib


def contiguous(vocab: dict[str, int]) -> bool:
    """True when the ids are 0..len−1, the only vocabularies the C core
    holds (a ``vocab.txt`` with a repeated line is not one)."""
    return sorted(vocab.values()) == list(range(len(vocab)))


class NativeWordPiece:
    """Vocab-bound encoder. ASCII only: the caller routes non-ASCII text to
    the Python reference implementation."""

    def __init__(self, vocab: dict[str, int], unk_token: str,
                 lowercase: bool):
        if not contiguous(vocab):
            raise ValueError("vocab ids must be contiguous from 0")
        self._lib = _lib()
        ordered = sorted(vocab.items(), key=lambda kv: kv[1])
        arr = (ctypes.c_char_p * len(ordered))(
            *[t.encode("utf-8") for t, _ in ordered])
        self._handle = self._lib.wp_create(arr, len(ordered),
                                           vocab[unk_token],
                                           1 if lowercase else 0)
        self._buf = (ctypes.c_int * 65536)()

    def encode(self, text: str) -> list[int]:
        raw = text.encode("utf-8")  # its length passed: NUL may be inside
        n = self._lib.wp_encode(self._handle, raw, len(raw), self._buf,
                                len(self._buf))
        if n < 0:
            raise ValueError("text produced too many tokens")
        return list(self._buf[:n])

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle is not None:
            self._lib.wp_free(handle)
