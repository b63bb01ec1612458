"""Reader of the orbax checkpoints the JAX package writes, without orbax,
tensorstore or a zstd library.

``ance_tpu/train/checkpoint.py::AsyncCheckpointer`` saves
``checkpoint-<n>/state/`` (``{"params", "opt_state"}``) through orbax's
``StandardCheckpointHandler``; older runs saved the parameters alone as
``checkpoint-<n>/params/``. Either directory is one orbax item:

  * ``_METADATA`` (JSON) names every leaf by its key path
    (``tree_metadata``: a dict key is ``key_type`` 2, a sequence index,
    namedtuple fields' tuple included, is ``key_type`` 1) with its
    ``value_type``; ``"None"`` is an empty leaf (optax's ``EmptyState``).
    It also says whether the arrays sit in an OCDBT store (``use_ocdbt``)
    and whether they are zarr v3 (``use_zarr3``);
  * each array is a zarr v2 array named by its key path joined with dots
    (``opt_state.1.mu.encoder.layer_0.kernel``): a ``.zarray`` JSON and a
    chunk grid (``0.0``, ...), each chunk C-order bytes compressed by
    zstd. With ``use_ocdbt`` they are keys of the OCDBT store in the item's
    directory (:mod:`ance_tpu_torch.train.ocdbt`), else files.

:func:`read_item` returns the nested tree that the JAX package's
``ckptr.restore(item)`` gives, as :mod:`ance_tpu_torch.train.flax_msgpack`
returns trees: dicts (a sequence as a dict keyed ``"0"``, ``"1"``, ...),
numpy arrays, ``torch.bfloat16`` tensors for bfloat16 (numpy has no such
dtype), Python numbers for orbax's ``scalar`` leaves, ``None`` for empty
leaves. Chunks decode on a thread pool (the
decoder releases the GIL). Anything this reader does not know (zarr v3,
another compressor or filter, Fortran order, an unknown dtype, value type
or key type) raises ``UnreadableCheckpoint`` naming the file and the field.
"""

from __future__ import annotations

import itertools
import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from ance_tpu_torch.train.checkpoint import UnreadableCheckpoint
from ance_tpu_torch.train.ocdbt import MANIFEST, OcdbtError, OcdbtStore
from ance_tpu_torch.utils import zstd

METADATA = "_METADATA"
DTYPES = {"<f4": np.float32, "<f8": np.float64, "<i4": np.int32,
          "<i8": np.int64, "<u4": np.uint32, "bfloat16": np.uint16}
ARRAY_TYPES = ("jax.Array", "np.ndarray", "scalar")


def _metadata(item_dir: str) -> dict:
    path = os.path.join(item_dir, METADATA)
    if not os.path.exists(path):
        manifest = os.path.join(item_dir, MANIFEST)
        if not os.path.exists(manifest):
            raise UnreadableCheckpoint(
                f"{manifest}: missing, and {METADATA} too: {item_dir} is "
                "not an orbax item")
        raise UnreadableCheckpoint(f"{path}: missing (an orbax item's "
                                   "tree metadata)")
    with open(path) as f:
        try:
            meta = json.load(f)
        except ValueError as e:
            raise UnreadableCheckpoint(f"{path}: not JSON ({e})") from None
    if not isinstance(meta, dict) or \
            not isinstance(meta.get("tree_metadata"), dict):
        raise UnreadableCheckpoint(f"{path}: no tree_metadata (an orbax "
                                   "layout this reader does not know)")
    if meta.get("use_zarr3"):
        raise UnreadableCheckpoint(f"{path}: use_zarr3 is true (zarr v3 "
                                   "arrays are not read; zarr v2 are)")
    return meta


class _Arrays:
    """The item's array keys, from its OCDBT store or its files."""

    def __init__(self, item_dir: str, use_ocdbt: bool):
        self.item_dir = item_dir
        try:
            self.store = OcdbtStore(item_dir) if use_ocdbt else None
        except OcdbtError as e:
            raise UnreadableCheckpoint(str(e)) from None

    def name(self, key: str) -> str:
        return os.path.join(self.item_dir, key)

    def read_many(self, keys: list[str], missing_ok: bool = False
                  ) -> list[Optional[bytes]]:
        try:
            if self.store is not None:
                have = [k for k in keys if k in self.store]
                if len(have) < len(keys) and not missing_ok:
                    lost = next(k for k in keys if k not in self.store)
                    raise UnreadableCheckpoint(
                        f"{self.name(lost)}: missing from the OCDBT store")
                values = dict(zip(have, self.store.read_many(have)))
                return [values.get(k) for k in keys]
            out = []
            for k in keys:
                path = self.name(k)
                if not os.path.exists(path):
                    if not missing_ok:
                        raise UnreadableCheckpoint(f"{path}: missing")
                    out.append(None)
                    continue
                with open(path, "rb") as f:
                    out.append(f.read())
            return out
        except OcdbtError as e:
            raise UnreadableCheckpoint(str(e)) from None

    def close(self) -> None:
        if self.store is not None:
            self.store.close()


def _zarray(raw: bytes, where: str) -> dict:
    try:
        z = json.loads(raw)
    except ValueError as e:
        raise UnreadableCheckpoint(f"{where}: not JSON ({e})") from None
    if z.get("zarr_format") != 2:
        raise UnreadableCheckpoint(f"{where}: zarr_format "
                                   f"{z.get('zarr_format')} (2 is read)")
    comp = z.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise UnreadableCheckpoint(f"{where}: compressor {comp.get('id')!r} "
                                   "(zstd or none are read)")
    if z.get("filters"):
        raise UnreadableCheckpoint(f"{where}: filters {z['filters']} (none "
                                   "are read)")
    if z.get("order", "C") != "C":
        raise UnreadableCheckpoint(f"{where}: order {z.get('order')!r} (C "
                                   "order is read)")
    if z.get("dtype") not in DTYPES:
        raise UnreadableCheckpoint(f"{where}: dtype {z.get('dtype')!r} (one "
                                   f"of {', '.join(DTYPES)} is read)")
    if z.get("dimension_separator", ".") != ".":
        raise UnreadableCheckpoint(f"{where}: dimension_separator "
                                   f"{z['dimension_separator']!r} (. is "
                                   "read)")
    if len(z.get("chunks", ())) != len(z.get("shape", ())):
        raise UnreadableCheckpoint(f"{where}: chunks {z.get('chunks')} do "
                                   f"not match shape {z.get('shape')}")
    return z


def _fill(z: dict, dtype) -> np.generic:
    value = z.get("fill_value")
    if value is None:
        return dtype(0)
    if isinstance(value, str):  # zarr's JSON for non-finite floats
        value = {"NaN": np.nan, "Infinity": np.inf,
                 "-Infinity": -np.inf}.get(value, value)
    if z["dtype"] == "bfloat16":
        return np.uint16(torch.tensor(float(value), dtype=torch.bfloat16)
                         .view(torch.int16).item() & 0xFFFF)
    return dtype(value)


def _read_array(arrays: _Arrays, name: str, z: dict, pool):
    """One zarr v2 array as a numpy array (bfloat16 as a torch tensor)."""
    dtype = DTYPES[z["dtype"]]
    shape, chunks = tuple(z["shape"]), tuple(z["chunks"])
    grid = [range(-(-s // c)) if c else range(0)
            for s, c in zip(shape, chunks)]
    indices = list(itertools.product(*grid))
    keys = [f"{name}/" + (".".join(map(str, idx)) if idx else "0")
            for idx in indices]
    raws = arrays.read_many(keys, missing_ok=True)
    chunk_bytes = int(np.prod(chunks, dtype=np.int64)) * \
        np.dtype(dtype).itemsize
    compressed = z.get("compressor") is not None

    def decode(i):
        raw = raws[i]
        if raw is None:
            return None
        try:
            data = zstd.decompress(raw, chunk_bytes) if compressed else raw
        except ValueError as e:
            raise UnreadableCheckpoint(
                f"{arrays.name(keys[i])}: {e}") from None
        if len(data) != chunk_bytes:
            raise UnreadableCheckpoint(
                f"{arrays.name(keys[i])}: {len(data)} bytes, a chunk of "
                f"{chunks} {z['dtype']} is {chunk_bytes}")
        return np.frombuffer(data, dtype).reshape(chunks)

    decoded = list(pool.map(decode, range(len(indices))))
    out = np.empty(shape, dtype)
    fill = _fill(z, dtype)
    for idx, chunk in zip(indices, decoded):
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(idx, chunks, shape))
        if chunk is None:
            out[region] = fill
        else:
            out[region] = chunk[tuple(slice(0, r.stop - r.start)
                                      for r in region)]
    if z["dtype"] == "bfloat16":
        return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    return out


def read_item(item_dir: str, subtree: Optional[str] = None):
    """The tree of the orbax item at ``item_dir``; with ``subtree``, only
    the part under that top-level key (``None`` when the item has no such
    key)."""
    meta = _metadata(item_dir)
    where = os.path.join(item_dir, METADATA)
    leaves = []
    for keystr, entry in meta["tree_metadata"].items():
        try:
            path = [(k["key"], k["key_type"]) for k in entry["key_metadata"]]
            value_type = entry["value_metadata"]["value_type"]
        except (KeyError, TypeError):
            raise UnreadableCheckpoint(
                f"{where}: {keystr}: no key_metadata / value_type (an orbax "
                "layout this reader does not know)") from None
        for key, key_type in path:
            if key_type not in (1, 2):
                raise UnreadableCheckpoint(
                    f"{where}: {keystr}: key_type {key_type} (1, a "
                    "sequence index, and 2, a dict key, are read)")
        if value_type != "None" and value_type not in ARRAY_TYPES:
            raise UnreadableCheckpoint(f"{where}: {keystr}: value_type "
                                       f"{value_type!r}")
        if subtree is not None:
            if not path or str(path[0][0]) != subtree:
                continue
        leaves.append(([str(k) for k, _ in path], value_type))
    if subtree is not None and not leaves:
        return None
    arrays = _Arrays(item_dir, bool(meta.get("use_ocdbt")))
    try:
        names = [".".join(keys) for keys, vt in leaves if vt != "None"]
        zarrays = dict(zip(names, arrays.read_many(
            [f"{n}/.zarray" for n in names])))
        values = {}
        with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
            for n in names:
                z = _zarray(zarrays[n], arrays.name(f"{n}/.zarray"))
                values[n] = _read_array(arrays, n, z, pool)
    finally:
        arrays.close()
    tree: dict = {}
    for keys, value_type in leaves:
        value = None if value_type == "None" else values[".".join(keys)]
        if value_type == "scalar":  # orbax restores a Python int or float
            value = value.item()
        if subtree is not None:
            keys = keys[1:]
        if not keys:
            return value
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value
    return tree
