"""Zstandard decompression and crc32c on the port's own C++ core.

The JAX package's orbax checkpoints store their OCDBT nodes and zarr
chunks as zstd frames (RFC 8878), and OCDBT ends each manifest and node
with a crc32c. Nothing on the card's host reads zstd (no ``zstandard``,
no system ``libzstd`` is bound), so ``ance_tpu_torch/native/zstd.cpp``
decodes it; :mod:`ance_tpu_torch.utils.native_build` builds it with g++ at
first use. The calls go through ctypes, which releases the GIL, so
threads decode chunks in parallel.

A corrupt frame raises ``ValueError`` naming the byte offset and the check
that failed (a bad xxh64 content checksum among them); no call returns
fewer bytes than the frames declare.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ance_tpu_torch.utils.native_build import load_native

_ERR_BYTES = 512
_lib = None


def _native() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load_native("zstd")
        u8p, size = ctypes.c_void_p, ctypes.c_size_t
        lib.zstd_content_size.argtypes = [u8p, size, ctypes.c_char_p, size]
        lib.zstd_content_size.restype = ctypes.c_int64
        lib.zstd_decompress.argtypes = [u8p, size, u8p, size,
                                        ctypes.c_char_p, size]
        lib.zstd_decompress.restype = ctypes.c_int64
        lib.zstd_crc32c.argtypes = [u8p, size, ctypes.c_uint32]
        lib.zstd_crc32c.restype = ctypes.c_uint32
        _lib = lib
    return _lib


def _address(buf) -> tuple[int, int, object]:
    """(address, length, keep-alive) of a bytes-like object's bytes; no
    copy, read-only buffers included."""
    arr = np.frombuffer(buf, np.uint8) if len(memoryview(buf)) \
        else np.zeros(1, np.uint8)[:0]
    return arr.ctypes.data, arr.size, arr


def content_size(data) -> int | None:
    """Sum of the frames' declared content sizes; None when a frame does
    not declare its own."""
    lib = _native()
    src, n, keep = _address(data)
    err = ctypes.create_string_buffer(_ERR_BYTES)
    size = lib.zstd_content_size(src, n, err, _ERR_BYTES)
    del keep
    if size == -3:
        raise ValueError(f"corrupt zstd data: {err.value.decode()}")
    return None if size < 0 else size


def decompress(data, size: int | None = None) -> bytearray:
    """Every frame of ``data`` decoded, in order, skippable frames passed
    over. ``size``: the decoded length when the caller knows it; else the
    frames' declared sizes, else a guess that doubles until it fits."""
    lib = _native()
    src, n, keep = _address(data)
    if size is None:
        size = content_size(data)
    exact = size is not None
    cap = size if exact else max(4 * n, 1 << 16)
    err = ctypes.create_string_buffer(_ERR_BYTES)
    while True:
        out = bytearray(cap)
        dst = (ctypes.c_char * max(cap, 1)).from_buffer(out) if cap \
            else ctypes.create_string_buffer(1)
        got = lib.zstd_decompress(src, n, ctypes.addressof(dst), cap, err,
                                  _ERR_BYTES)
        del dst
        if got == -1:
            raise ValueError(f"corrupt zstd data: {err.value.decode()}")
        if got == -2:
            if exact:
                raise ValueError(f"corrupt zstd data: decodes to more than "
                                 f"the {cap} bytes expected")
            cap *= 2
            continue
        del keep
        if exact and got != cap:
            raise ValueError(f"corrupt zstd data: decodes to {got} bytes, "
                             f"{cap} expected")
        del out[got:]
        return out


def crc32c(data, crc: int = 0) -> int:
    """CRC-32C (Castagnoli) of ``data``, continuing from ``crc``."""
    src, n, keep = _address(data)
    value = _native().zstd_crc32c(src, n, crc)
    del keep
    return value
