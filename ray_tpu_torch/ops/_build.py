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
_SOURCES = (_CSRC / "flash_fwd.cu", _CSRC / "flash_bwd.cu")
_HEADERS = (_CSRC / "flash_common.cuh", _CSRC / "hopper.cuh")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ray_tpu_torch"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

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
    for src in _SOURCES + _HEADERS:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libray_tpu_torch_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists:
    one ``nvcc -c`` per source, all started together, then one link. The
    compiler's resource report (``-Xptxas -v``) is kept beside the library
    as ``<library>.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _SOURCES]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        procs = [subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(_SOURCES, objs)]
        logs = [proc.communicate()[0] for proc in procs]
        failed = [(src.name, proc.returncode, log) for src, proc, log
                  in zip(_SOURCES, procs, logs) if proc.returncode]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{name} ({rc}):\n{log}" for name, rc, log in failed))
        link = subprocess.run(
            [_nvcc(), *ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}{link.stderr}")
        out.with_suffix(".log").write_text("".join(logs))
        os.replace(tmp, out)  # atomic: a loader never sees a partial file
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out


def load() -> ctypes.CDLL:
    """The kernels' library, built on first use and bound once."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.ray_tpu_flash_fwd.argtypes = [
                p, p, p, p, p,          # q, k, v, out, lse
                i, i, i, i, i,          # B, S, H, KVH, D
                i, i, f,                # dtype code, causal, scale
                p]                      # cudaStream_t
            lib.ray_tpu_flash_bwd_dq.argtypes = [
                p, p, p, p, p, p, p,    # q, k, v, dO, lse, delta, dq
                i, i, i, i, i,          # B, S, H, KVH, D
                i, i, f, p]             # dtype code, causal, scale, stream
            lib.ray_tpu_flash_bwd_dkv.argtypes = [
                p, p, p, p, p, p, p, p,  # q, k, v, dO, lse, delta, dk, dv
                i, i, i, i, i,
                i, i, f, p]
            for fn in (lib.ray_tpu_flash_fwd, lib.ray_tpu_flash_bwd_dq,
                       lib.ray_tpu_flash_bwd_dkv):
                fn.restype = i
            lib.ray_tpu_cuda_error_string.argtypes = [i]
            lib.ray_tpu_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def error_string(code: int) -> str:
    return load().ray_tpu_cuda_error_string(code).decode()
