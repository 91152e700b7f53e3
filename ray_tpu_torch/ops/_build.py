"""Build and bind the port's CUDA kernels.

The sources under ``ops/csrc/`` are compiled with ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, loaded with
``ctypes``. The build happens at first use, into ``build/ray_tpu_torch/``
at the root of the checkout, under a name keyed by a hash of the sources
and flags, so a changed source is rebuilt and an unchanged one is
reused. Nothing here runs when the module is imported: hosts without
``nvcc`` (the CPU test runs) import the port freely.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCES = (_CSRC / "flash_fwd.cu",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ray_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")  # the toolkit's default prefix
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the port's CUDA kernels")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libray_tpu_torch_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists.
    The compiler's resource report (``-Xptxas -v``) is kept beside the
    library as ``<library>.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)  # atomic: a loader never sees a partial file
    return out


def load() -> ctypes.CDLL:
    """The kernels' library, built on first use and bound once."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.ray_tpu_flash_fwd.argtypes = [
                p, p, p, p, p,          # q, k, v, out, lse
                i, i, i, i, i,          # B, S, H, KVH, D
                i, i, ctypes.c_float,   # dtype code, causal, scale
                p]                      # cudaStream_t
            lib.ray_tpu_flash_fwd.restype = i
            lib.ray_tpu_cuda_error_string.argtypes = [i]
            lib.ray_tpu_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def error_string(code: int) -> str:
    return load().ray_tpu_cuda_error_string(code).decode()
