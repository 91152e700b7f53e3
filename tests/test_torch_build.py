"""The port's kernel build (``ray_tpu_torch/ops/_build.py``) on the CPU.

The library's file name carries a hash of the kernel sources and headers,
so an edited source is rebuilt and never served from a stale library.
These tests need no ``nvcc`` and no card.
"""

import shutil

import pytest

from ray_tpu_torch.ops import _build

_FILES = sorted(p.name for p in _build._CSRC.iterdir()
                if p.suffix in (".cu", ".cuh"))


def test_the_build_names_sources_and_headers_that_exist():
    listed = _build._SOURCES + _build._HEADERS
    assert all(p.exists() for p in listed)
    assert all(p.suffix == ".cu" for p in _build._SOURCES)
    assert all(p.suffix == ".cuh" for p in _build._HEADERS)
    assert len({p.name for p in listed}) == len(listed)


@pytest.mark.parametrize("name", _FILES)
def test_every_kernel_source_is_in_the_build_hash(name):
    listed = {p.name for p in _build._SOURCES + _build._HEADERS}
    assert name in listed, f"csrc/{name} is not in _build._SOURCES/_HEADERS"


@pytest.mark.parametrize("name", _FILES)
def test_editing_any_kernel_source_names_a_new_library(name, tmp_path,
                                                       monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_build._CSRC, copy)
    monkeypatch.setattr(_build, "_SOURCES",
                        tuple(copy / p.name for p in _build._SOURCES))
    monkeypatch.setattr(_build, "_HEADERS",
                        tuple(copy / p.name for p in _build._HEADERS))
    before = _build.library_path()
    (copy / name).write_text((copy / name).read_text() + "\n// edited\n")
    assert _build.library_path() != before
    assert _build.library_path().parent == _build.BUILD_DIR
