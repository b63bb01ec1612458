"""Build-and-load helper for the package's host C++ sources.

Counterpart of ``ance_tpu/utils/native_build.py``: compiles
``ance_tpu_torch/native/<name>.cpp`` with g++ into
``ance_tpu_torch/build/lib<name>_<hash>.so`` (git-ignored) at first use and
loads it with ctypes. The file name carries a hash of the source and the
flags, so an edited source rebuilds and a stale library is never loaded;
the library is renamed into place, so processes that build at once (the
spawned workers of ``preprocess``) each see a whole file. A failed build
raises ``RuntimeError`` with g++'s stderr: nothing falls back quietly.
The flags name no host CPU (no ``-march=native``), so a library built on
one machine runs on another that shares the checkout.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
NATIVE_DIR = PACKAGE_DIR / "native"
BUILD_DIR = PACKAGE_DIR / "build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_cache: dict[str, ctypes.CDLL] = {}


def library_path(name: str) -> Path:
    digest = hashlib.sha256((NATIVE_DIR / f"{name}.cpp").read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def load_native(name: str) -> ctypes.CDLL:
    """``native/<name>.cpp``'s library, built first unless current."""
    with _lock:
        if name in _cache:
            return _cache[name]
        out = library_path(name)
        if not out.exists():
            build(NATIVE_DIR / f"{name}.cpp", out)
        _cache[name] = ctypes.CDLL(str(out))
        return _cache[name]


def build(source: Path, out: Path) -> None:
    """Compile ``source`` with ``CXX_FLAGS`` into the library ``out``,
    renamed into place once whole; raises ``RuntimeError`` with g++'s
    stderr on failure."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(source), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:  # no g++ at all
        raise RuntimeError(f"building {source.name}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}) building "
                           f"{source.name}:\n{proc.stderr}")
    os.replace(tmp, out)
