"""The port's kernel build (``ray_tpu_torch/ops/_build.py``) on the CPU.

The library's file name carries a hash of the kernel sources and headers,
so an edited source is rebuilt and never served from a stale library.
Every wgmma kernel defined in the sources is named in ``chip_smoke.py``'s
SASS and ptxas check. These tests need no ``nvcc`` and no card.
"""

import ast
import pathlib
import re
import shutil

import pytest

from ray_tpu_torch.ops import _build

_FILES = sorted(p.name for p in _build._CSRC.iterdir()
                if p.suffix in (".cu", ".cuh"))
_CHIP_SMOKE = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
# A kernel definition: __global__ void [__launch_bounds__(...)] name(
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                     r"(\w+)\s*\(")


def _defined_wgmma_kernels():
    return sorted({name for p in _build._CSRC.iterdir()
                   if p.suffix in (".cu", ".cuh")
                   for name in _GLOBAL.findall(p.read_text())
                   if name.endswith("_wgmma_kernel")})


def _sass_checked_kernels():
    """The literal tuple ``WGMMA_KERNELS`` of chip_smoke.py, read as text."""
    for node in ast.parse(_CHIP_SMOKE.read_text()).body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) == "WGMMA_KERNELS"):
            return ast.literal_eval(node.value)
    raise AssertionError("chip_smoke.py defines no WGMMA_KERNELS")


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


@pytest.mark.parametrize("name", _defined_wgmma_kernels())
def test_every_wgmma_kernel_is_in_the_chip_smoke_sass_check(name):
    assert name in _sass_checked_kernels(), (
        f"{name} is defined under ops/csrc/ but not named in chip_smoke.py's "
        f"WGMMA_KERNELS, so its SASS and ptxas report go unchecked")


def test_the_scan_finds_k1_to_k3_and_the_sass_check_names_no_other():
    defined = set(_defined_wgmma_kernels())
    assert {"flash_fwd_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
            "flash_bwd_dkv_wgmma_kernel"} <= defined
    assert set(_sass_checked_kernels()) <= defined
