"""The kernel build's cache key (``ance_tpu_torch/ops/_build.py``): a
library's file name hashes its ``.cu`` source, every ``csrc`` header that
source includes (through other headers too) and the nvcc flags, so an
edited header rebuilds. No compiler is needed: only the paths are
computed."""

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
    """fused_attention.cu includes the Hopper building blocks; the other
    kernels are single files."""
    names = [p.name for p in _build.sources("fused_attention")]
    assert names == ["fused_attention.cu", "hopper.cuh"]
    for name in ("blockmax", "flash_attention", "attn128"):
        assert [p.name for p in _build.sources(name)] == [f"{name}.cu"]


def test_fused_variants_undo_one_choice_each_in_the_source():
    """``experiments/fused_variants.py`` rebuilds ``fused_attention.cu``
    with one design choice undone a variant: each of its substitutions
    must still match the source exactly once (else it fails on the card)."""
    from ance_tpu_torch.experiments import fused_variants
    source = (_build.CSRC_DIR / "fused_attention.cu").read_text()
    assert fused_variants.VARIANTS["as built"] == []
    for name, subs in fused_variants.VARIANTS.items():
        for old, new in subs:
            assert source.count(old) == 1, name
            assert old != new
