"""The kernel build's cache key (``ance_tpu_torch/ops/_build.py``): a
library's file name hashes its ``.cu`` source, every ``csrc`` header that
source includes (through other headers too) and the nvcc flags, so an
edited header rebuilds. No compiler is needed: only the paths are
computed."""

import pytest

from ance_tpu_torch.ops import _build


def _csrc(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    (tmp_path / "k.cu").write_text('#include <cstdint>\n#include "a.cuh"\n'
                                   "int f() { return g(); }\n")
    (tmp_path / "a.cuh").write_text('#pragma once\n  # include "b.cuh"\n'
                                    "inline int g() { return h(); }\n")
    (tmp_path / "b.cuh").write_text("#pragma once\ninline int h() { return 1; }\n")
    (tmp_path / "unused.cuh").write_text("#pragma once\n")
    return tmp_path


def test_sources_follow_local_includes_through_headers(tmp_path, monkeypatch):
    csrc = _csrc(tmp_path, monkeypatch)
    assert _build.sources("k") == [csrc / "k.cu", csrc / "a.cuh",
                                   csrc / "b.cuh"]


def test_editing_an_included_header_changes_the_library_path(tmp_path,
                                                             monkeypatch):
    csrc = _csrc(tmp_path, monkeypatch)
    before = _build.library_path("k")
    assert before == _build.library_path("k")  # stable
    (csrc / "unused.cuh").write_text("#pragma once\n// edited\n")
    assert _build.library_path("k") == before  # not included
    (csrc / "b.cuh").write_text("#pragma once\ninline int h() { return 2; }\n")
    after = _build.library_path("k")
    assert after != before and after.name.startswith("libk_")
    (csrc / "a.cuh").write_text((csrc / "a.cuh").read_text() + "// edit\n")
    assert _build.library_path("k") not in (before, after)


def test_the_package_sources_and_their_headers():
    """Every kernel source includes the Hopper building blocks (block-max
    for its bf16 route's TMA maps and wgmma); the two attention sources,
    whose fp32 routes split their operands, also the split kernel's
    header, which the others do not build."""
    for name in ("fused_attention", "flash_attention"):
        assert [p.name for p in _build.sources(name)] == [
            f"{name}.cu", "hopper.cuh", "split_pieces.cuh"]
    for name in ("attn128", "blockmax"):
        assert [p.name for p in _build.sources(name)] == [f"{name}.cu",
                                                          "hopper.cuh"]


@pytest.mark.parametrize("experiment,source", [
    ("fused_variants", "fused_attention"), ("attn_variants", "flash_attention"),
    ("attn_variants", "attn128"), ("blockmax_variants", "blockmax")])
def test_fused_variants_undo_one_choice_each_in_the_source(experiment,
                                                          source):
    """``experiments/fused_variants.py`` (kernels #2 and #3),
    ``experiments/attn_variants.py`` (#4 and #5) and
    ``experiments/blockmax_variants.py`` (#1's pieces kernels) rebuild a kernel source
    with one design choice changed a variant: each substitution must still
    match the source's files (the ``.cu`` and the headers it includes)
    exactly once (else it fails on the card)."""
    import importlib
    from ance_tpu_torch.experiments import fused_variants
    variants = importlib.import_module(
        f"ance_tpu_torch.experiments.{experiment}").VARIANTS
    if experiment == "attn_variants":
        variants = variants[source]
    paths = _build.sources(source)
    texts = [p.read_text() for p in paths]
    assert variants["as built"] == []
    for name, subs in variants.items():
        for old, new in subs:
            assert sum(text.count(old) for text in texts) == 1, name
            assert old != new
        changed = fused_variants.substituted(source, subs)
        holders = {p.name for p, text in zip(paths, texts)
                   for old, _ in subs if old in text}
        assert {p.name for p, text in zip(paths, texts)
                if changed[p.name] != text} == holders


def test_package_data_ships_every_source_the_build_reads():
    """A non-editable install builds the kernels from the installed
    package: every file ``_build.sources`` follows for each kernel (the
    ``.cu`` and every header it includes) must match one of
    ``pyproject.toml``'s package-data globs for ``ance_tpu_torch``."""
    import fnmatch
    import tomllib
    from pathlib import Path
    root = Path(_build.__file__).resolve().parents[2]
    with open(root / "pyproject.toml", "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"][
            "ance_tpu_torch"]
    package = root / "ance_tpu_torch"
    kernels = sorted(p.stem for p in (package / "csrc").glob("*.cu"))
    assert kernels == ["attn128", "blockmax", "flash_attention",
                       "fused_attention", "grouped_gemm"]
    followed = {p for name in kernels for p in _build.sources(name)}
    assert {p.suffix for p in followed} == {".cu", ".cuh"}
    for path in followed:
        rel = path.relative_to(package).as_posix()
        assert any(fnmatch.fnmatch(rel, g) for g in globs), rel
