"""`ops._build` of the PyTorch port on the CPU: a library's name hashes its
source, every header under csrc/ and the flags, so an edited header
builds anew and an untouched tree reuses the library. Nothing is
compiled here (no nvcc): the tests only name libraries."""

import os

import pytest

from cloud_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "kern.cu").write_text('#include "prims.cuh"\n')
    (tmp_path / "other.cu").write_text("// no headers\n")
    (tmp_path / "prims.cuh").write_text("// primitives v1\n")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    return tmp_path


def test_untouched_tree_keeps_the_library(csrc):
    first = {n: _build.library_path(n) for n in _build.sources()}
    assert sorted(first) == ["kern", "other"]
    assert _build.headers() == ["prims.cuh"]
    assert {n: _build.library_path(n) for n in _build.sources()} == first
    for name, path in first.items():
        assert os.path.dirname(path) == _build.BUILD_DIR
        assert os.path.basename(path).startswith(name + "-")


@pytest.mark.parametrize("edit", ["header", "new_header", "source"])
def test_edit_names_a_new_library(csrc, edit):
    before = _build.library_path("kern")
    if edit == "header":
        (csrc / "prims.cuh").write_text("// primitives v2\n")
    elif edit == "new_header":
        (csrc / "more.cuh").write_text("// more\n")
    else:
        (csrc / "kern.cu").write_text('#include "prims.cuh"\n// edited\n')
    assert _build.library_path("kern") != before


def test_header_edit_reaches_every_source(csrc):
    before = [_build.library_path(n) for n in ("kern", "other")]
    (csrc / "prims.cuh").write_text("// primitives v2\n")
    after = [_build.library_path(n) for n in ("kern", "other")]
    assert all(a != b for a, b in zip(after, before))
    (csrc / "prims.cuh").write_text("// primitives v1\n")
    assert [_build.library_path(n) for n in ("kern", "other")] == before


def test_the_port_has_the_hopper_header():
    assert "sm90.cuh" in _build.headers()
    assert "fused_mlp" in _build.sources()
