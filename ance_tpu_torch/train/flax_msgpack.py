"""Reader of flax's msgpack checkpoints on the standard library and numpy.

``flax.serialization.to_bytes`` (the JAX trainer's ``params.msgpack``,
``ance_tpu/train/checkpoint.py:48``) writes a msgpack map of maps whose
leaves are ext records. This module decodes the subset it writes, without
the ``msgpack`` package, into the tree ``flax.serialization.msgpack_restore``
returns:

  * maps, arrays (as lists), str / bin, ints, floats, nil and bool;
  * ext 1, an ndarray: a msgpack ``(shape, dtype name, C-order bytes)``
    triple; a ``bfloat16`` array becomes a ``torch.bfloat16`` tensor, since
    numpy has no such dtype, and any other a read-only numpy array;
  * ext 3, a numpy scalar, the same triple with shape ``()``;
  * a ``{"__msgpack_chunked_array__": True, "shape", "chunks"}`` map (flax
    splits leaves above ``MAX_CHUNK_SIZE``, 1 GiB) joined back into one
    array.

Anything else (other ext codes, extra or missing bytes) raises
``ValueError`` naming the file.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Decoder:
    def __init__(self, data, name: str):
        self.data = memoryview(data)
        self.pos = 0
        self.name = name

    def fail(self, what: str):
        raise ValueError(f"{self.name}: not a flax msgpack checkpoint "
                         f"({what} at byte {self.pos})")

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            self.fail(f"truncated: {n} more bytes needed")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.unpack(">B")
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self.array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return self.str(b & 0x1f)
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if b in simple:
            return simple[b]
        sized = {0xc4: (">B", bytes), 0xc5: (">H", bytes), 0xc6: (">I", bytes),
                 0xd9: (">B", self.str), 0xda: (">H", self.str),
                 0xdb: (">I", self.str),
                 0xdc: (">H", self.array), 0xdd: (">I", self.array),
                 0xde: (">H", self.map), 0xdf: (">I", self.map)}
        if b in sized:
            fmt, read = sized[b]
            n = self.unpack(fmt)
            return bytes(self.take(n)) if read is bytes else read(n)
        numbers = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H",
                   0xce: ">I", 0xcf: ">Q", 0xd0: ">b", 0xd1: ">h",
                   0xd2: ">i", 0xd3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        fixext = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        if b in (0xc7, 0xc8, 0xc9):
            return self.ext(self.unpack({0xc7: ">B", 0xc8: ">H",
                                         0xc9: ">I"}[b]))
        self.pos -= 1
        self.fail(f"type byte 0x{b:02x}")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            if isinstance(key, (list, dict)):
                self.fail("a map key that is an array or a map")
            out[key] = self.value()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        start = self.pos
        payload = self.take(n)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            self.pos = start
            self.fail(f"ext type {code}")
        inner = _Decoder(payload, self.name)
        triple = inner.value()
        if inner.pos != len(payload) or not (
                isinstance(triple, list) and len(triple) == 3):
            self.pos = start
            self.fail("an ndarray record that is not (shape, dtype, bytes)")
        shape, dtype, buffer = triple
        if isinstance(dtype, bytes):
            dtype = dtype.decode()
        try:
            out = _array(shape, dtype, buffer)
        except (TypeError, ValueError) as e:
            self.pos = start
            self.fail(f"ndarray record: {e}")
        if code == _EXT_NPSCALAR and isinstance(out, np.ndarray):
            return out[()]
        return out


def _array(shape, dtype: str, buffer: bytes):
    if dtype == "bfloat16":
        bits = np.frombuffer(buffer, np.int16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(buffer, np.dtype(dtype)).reshape(shape)


def _unchunk(tree):
    """Join every chunked leaf back into one array (flax's ``_unchunk``)."""
    if not isinstance(tree, dict):
        return tree
    if tree.get(_CHUNKED) is True:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
        return np.concatenate([np.asarray(c).reshape(-1)
                               for c in chunks]).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes, name: str = "<bytes>"):
    """Decode ``flax.serialization.to_bytes`` output into its tree of
    dicts, lists and array leaves; ``name`` is the file a ``ValueError``
    names."""
    if not data:
        raise ValueError(f"{name}: not a flax msgpack checkpoint (empty)")
    decoder = _Decoder(data, name)
    tree = decoder.value()
    if decoder.pos != len(decoder.data):
        decoder.fail(f"{len(decoder.data) - decoder.pos} bytes after the "
                     "tree")
    try:
        return _unchunk(tree)
    except (KeyError, TypeError, ValueError, RuntimeError) as e:
        raise ValueError(f"{name}: a chunked array that does not join "
                         f"({e})") from None


def read_msgpack(path: str):
    """:func:`msgpack_restore` of the file ``path``."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read(), path)
