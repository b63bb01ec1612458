"""A read-only OCDBT key-value store (tensorstore's "optionally cooperative
distributed B+tree"), the layout orbax writes the JAX package's
checkpoints in (``use_ocdbt``), read without tensorstore.

A store is a directory. ``manifest.ocdbt`` holds the configuration and the
newest versions of the tree; B+tree nodes and large values live in data
files (``d/<id>``, and under orbax's per-process databases
``ocdbt.process_<i>/d/<id>``, which the top-level manifest's tree joins by
path). Every manifest and node is an envelope::

    magic        u32 big-endian (0x0cdb3a2a manifest, 0x0cdb20de node)
    length       u64: the envelope's bytes, header and trailer included
    version      varint (0)
    compression  u8: 0 none, 1 zstd
    payload      (a zstd frame when compressed)
    crc32c       u32 of every byte before it

and every table in a payload is stored column by column. The manifest
payload is the config (uuid, manifest kind, ``max_inline_value_bytes``,
``max_decoded_node_bytes``, version-tree arity, compression), a data-file
table, the inline versions (generation, root height, root location and
statistics, commit time) and references to version-tree nodes; the newest
version is the inline one of the highest generation. A node is its height,
a data-file table and its entries, keys prefix-compressed against the
previous key: a leaf's entries carry values, inline or as references into
a data file; an interior node's entries carry child nodes, whose keys are
stored without the child's common prefix.

:class:`OcdbtStore` offers ``keys()``, ``read(key)`` and
``read_many(keys)``; an indirect value is one ``pread``. A malformed or
corrupt file (a crc32c mismatch, a truncated node, an unknown version or
compression) raises :class:`OcdbtError` naming the file and the field.
"""

from __future__ import annotations

import os
import struct
from typing import Iterable, Optional

from ance_tpu_torch.utils import zstd

MANIFEST = "manifest.ocdbt"
MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_HEADER = 13  # magic + length + the smallest version varint


class OcdbtError(ValueError):
    """A store this reader cannot read; the message names the file and the
    field."""


class _Reader:
    """Sequential reads over one decoded payload."""

    def __init__(self, data: bytes, name: str):
        self.data = data
        self.pos = 0
        self.name = name

    def fail(self, what: str):
        raise OcdbtError(f"{self.name}: {what} (payload byte {self.pos})")

    def take(self, n: int, what: str) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            self.fail(f"truncated {what}")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self, what: str) -> int:
        return self.take(1, what)[0]

    def varint(self, what: str) -> int:
        value = shift = 0
        while True:
            if self.pos >= len(self.data):
                self.fail(f"truncated {what}")
            b = self.data[self.pos]
            self.pos += 1
            value |= (b & 0x7F) << shift
            if not b & 0x80:
                return value
            shift += 7
            if shift > 63:
                self.fail(f"{what}: varint longer than 64 bits")

    def varints(self, n: int, what: str) -> list[int]:
        return [self.varint(what) for _ in range(n)]

    def done(self) -> None:
        if self.pos != len(self.data):
            self.fail(f"{len(self.data) - self.pos} bytes after the end")


def decode_envelope(buf: bytes, magic: int, name: str,
                    max_decoded: Optional[int] = None) -> bytes:
    """The payload of a manifest or node envelope, its header, length and
    crc32c checked and its zstd frame decoded."""
    kind = "manifest" if magic == MANIFEST_MAGIC else "B-tree node"
    if len(buf) < _HEADER + 1 + 4:
        raise OcdbtError(f"{name}: truncated {kind} ({len(buf)} bytes)")
    got_magic, length = struct.unpack_from(">I", buf)[0], \
        struct.unpack_from("<Q", buf, 4)[0]
    if got_magic != magic:
        raise OcdbtError(f"{name}: magic {got_magic:#010x}, not a {kind} "
                         f"({magic:#010x})")
    if length != len(buf):
        raise OcdbtError(f"{name}: {kind} length field says {length} "
                         f"bytes, {len(buf)} read (truncated?)")
    want = struct.unpack_from("<I", buf, len(buf) - 4)[0]
    got = zstd.crc32c(memoryview(buf)[:len(buf) - 4])
    if got != want:
        raise OcdbtError(f"{name}: crc32c mismatch in the {kind} trailer "
                         f"(computed {got:#010x}, stored {want:#010x})")
    head = _Reader(buf[12:len(buf) - 4], name)
    version = head.varint("format version")
    if version != 0:
        raise OcdbtError(f"{name}: {kind} format version {version} "
                         "(only 0 is read)")
    compression = head.u8("compression")
    body = memoryview(buf)[12 + head.pos:len(buf) - 4]
    if compression == 0:
        payload = bytes(body)
    elif compression == 1:
        try:
            payload = bytes(zstd.decompress(body))
        except ValueError as e:
            raise OcdbtError(f"{name}: {kind} payload: {e}") from None
    else:
        raise OcdbtError(f"{name}: {kind} compression {compression} "
                         "(0 none and 1 zstd are read)")
    if max_decoded is not None and len(payload) > max_decoded:
        raise OcdbtError(f"{name}: {kind} decodes to {len(payload)} bytes, "
                         f"above max_decoded_node_bytes {max_decoded}")
    return payload


def _data_file_table(r: _Reader) -> list[str]:
    """Paths relative to the store's root: each path shares a prefix with
    the one before it; a base path (a per-process database) is its head."""
    n = r.varint("data file count")
    prefix = [0] + r.varints(max(n - 1, 0), "data file path prefix")
    suffix = r.varints(n, "data file path suffix length")
    r.varints(n, "data file base path length")
    paths, prev = [], ""
    for i in range(n):
        if prefix[i] > len(prev):
            r.fail("data file path prefix longer than the path before it")
        path = prev[:prefix[i]] + r.take(suffix[i], "data file path").decode()
        if path.startswith("/") or ".." in path.split("/"):
            r.fail(f"data file path {path!r} leaves the store")
        paths.append(path)
        prev = path
    return paths


def _keys(r: _Reader, n: int, interior: bool) -> tuple[list[bytes], list]:
    """The entries' keys, each prefix-compressed against the one before,
    and for an interior node each child's common-prefix length."""
    prefix = [0] + r.varints(max(n - 1, 0), "key prefix length")
    suffix = r.varints(n, "key suffix length")
    common = r.varints(n, "subtree common prefix length") if interior \
        else None
    keys, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            r.fail("key prefix longer than the key before it")
        prev = prev[:prefix[i]] + r.take(suffix[i], "key bytes")
        keys.append(prev)
    return keys, common


class OcdbtStore:
    """The newest version of an OCDBT store under ``root``, read-only.
    Every node is read and checked once, on first use."""

    def __init__(self, root: str):
        self.root = root
        self._fds: dict[str, int] = {}
        self._index: Optional[dict[bytes, tuple]] = None
        path = os.path.join(root, MANIFEST)
        if not os.path.exists(path):
            raise OcdbtError(f"{path}: missing (an OCDBT store's manifest)")
        with open(path, "rb") as f:
            buf = f.read()
        r = _Reader(decode_envelope(buf, MANIFEST_MAGIC, path), path)
        self.config = self._config(r)
        files = _data_file_table(r)
        n = r.varint("version count")
        generation = r.varints(n, "generation number")
        height = [r.u8("root height") for _ in range(n)]
        loc = [r.varints(n, f"root {f}") for f in ("file id", "offset",
                                                     "length")]
        for f in ("num_keys", "num_tree_bytes", "num_indirect_value_bytes"):
            r.varints(n, f"root {f}")
        r.take(8 * n, "commit time")
        m = r.varint("version tree node count")
        r.varints(m, "version node generation")
        node_loc = [r.varints(m, f"version node {f}")
                    for f in ("file id", "offset", "length")]
        r.varints(m, "version node generation count")
        r.take(8 * m, "version node commit time")
        r.take(m, "version node height")
        r.done()
        for fid in loc[0] + node_loc[0]:
            if fid >= len(files):
                r.fail(f"data file id {fid} outside the table of "
                       f"{len(files)}")
        self.generation = 0
        self.root_node = None
        if n:
            i = max(range(n), key=generation.__getitem__)
            self.generation = generation[i]
            if loc[2][i]:
                self.root_node = (files[loc[0][i]], loc[1][i], loc[2][i],
                                  height[i])

    def _config(self, r: _Reader) -> dict:
        cfg = {"uuid": r.take(16, "config uuid").hex(),
               "manifest_kind": r.varint("config manifest_kind"),
               "max_inline_value_bytes":
                   r.varint("config max_inline_value_bytes"),
               "max_decoded_node_bytes":
                   r.varint("config max_decoded_node_bytes"),
               "version_tree_arity_log2":
                   r.u8("config version_tree_arity_log2")}
        method = r.varint("config compression")
        if method == 0:
            cfg["compression"] = None
        elif method == 1:
            cfg["compression"] = {"id": "zstd", "level": struct.unpack(
                "<i", r.take(4, "config zstd level"))[0]}
        else:
            r.fail(f"config compression {method} (0 none, 1 zstd)")
        if cfg["manifest_kind"] != 0:
            r.fail(f"config manifest_kind {cfg['manifest_kind']} (only 0, "
                   "a single manifest file, is read)")
        return cfg

    # -- files --------------------------------------------------------------
    def _pread(self, rel: str, offset: int, length: int) -> bytes:
        fd = self._fds.get(rel)
        if fd is None:
            path = os.path.join(self.root, rel)
            try:
                fd = os.open(path, os.O_RDONLY)
            except OSError as e:
                raise OcdbtError(f"{path}: {e.strerror} (a data file the "
                                 "tree references)") from None
            self._fds[rel] = fd
        buf = os.pread(fd, length, offset)
        if len(buf) != length:
            raise OcdbtError(
                f"{os.path.join(self.root, rel)}: truncated: {length} bytes "
                f"at offset {offset} referenced, {len(buf)} there")
        return buf

    def close(self) -> None:
        for fd in self._fds.values():
            os.close(fd)
        self._fds.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # -- the tree -----------------------------------------------------------
    def _walk(self, rel: str, offset: int, length: int, height: int,
              prefix: bytes, index: dict) -> None:
        name = f"{os.path.join(self.root, rel)}: node at byte {offset}"
        buf = self._pread(rel, offset, length)
        r = _Reader(decode_envelope(
            buf, NODE_MAGIC, name, self.config["max_decoded_node_bytes"]),
            name)
        got = r.u8("node height")
        if got != height:
            r.fail(f"node height {got}, its parent says {height}")
        files = _data_file_table(r)
        n = r.varint("entry count")
        keys, common = _keys(r, n, interior=height > 0)
        if height == 0:
            lengths = r.varints(n, "value length")
            kinds = [r.u8("value kind") for _ in range(n)]
            indirect = [i for i, k in enumerate(kinds) if k == 1]
            if any(k > 1 for k in kinds):
                r.fail(f"value kind {max(kinds)} (0 inline, 1 indirect)")
            fids = r.varints(len(indirect), "value file id")
            offs = r.varints(len(indirect), "value offset")
            refs = dict(zip(indirect, zip(fids, offs)))
            for i, key in enumerate(keys):
                if i in refs:
                    fid, off = refs[i]
                    if fid >= len(files):
                        r.fail(f"value file id {fid} outside the table")
                    index[prefix + key] = (files[fid], off, lengths[i])
                else:
                    index[prefix + key] = r.take(lengths[i], "inline value")
            r.done()
            return
        loc = [r.varints(n, f"child {f}") for f in ("file id", "offset",
                                                    "length")]
        for f in ("num_keys", "num_tree_bytes", "num_indirect_value_bytes"):
            r.varints(n, f"child {f}")
        r.done()
        for i, key in enumerate(keys):
            if common[i] > len(key):
                r.fail("subtree common prefix longer than its key")
            if loc[0][i] >= len(files):
                r.fail(f"child file id {loc[0][i]} outside the table")
            self._walk(files[loc[0][i]], loc[1][i], loc[2][i], height - 1,
                       prefix + key[:common[i]], index)

    def _entries(self) -> dict:
        if self._index is None:
            index: dict[bytes, tuple] = {}
            if self.root_node is not None:
                rel, offset, length, height = self.root_node
                self._walk(rel, offset, length, height, b"", index)
            self._index = index
        return self._index

    # -- the store's interface --------------------------------------------
    def keys(self) -> list[bytes]:
        """Every key of the newest version, in order."""
        return sorted(self._entries())

    def __contains__(self, key) -> bool:
        return _key(key) in self._entries()

    def read(self, key) -> bytes:
        """One value; ``KeyError`` when the store has no such key."""
        return self.read_many([key])[0]

    def read_many(self, keys: Iterable) -> list[bytes]:
        """Values in the order of ``keys``; indirect ones read by data file
        and offset, one ``pread`` each."""
        entries = self._entries()
        keys = [_key(k) for k in keys]
        out: list = [None] * len(keys)
        pending = []
        for i, k in enumerate(keys):
            ref = entries.get(k)
            if ref is None:
                raise KeyError(f"{self.root}: no key {k.decode(errors='replace')!r}")
            if isinstance(ref, bytes):
                out[i] = ref
            else:
                pending.append((ref, i))
        for (rel, offset, length), i in sorted(pending):
            out[i] = self._pread(rel, offset, length)
        return out


def _key(key) -> bytes:
    return key.encode() if isinstance(key, str) else bytes(key)
