"""Build and load the hand-written Hopper kernels under ``csrc/``.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with :mod:`ctypes`.
The build happens at first use, into ``build/kernels/`` at the root of the
checkout; every source gets its own ``nvcc`` process and all of them run
at once. A library's file name carries a hash of its sources and flags,
so an edited source is rebuilt and a stale library is never loaded.

Nothing here runs on import, and nothing here is reached for tensors on
the CPU: the kernel wrappers call :func:`library` only on the CUDA path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

from .base import MXNetError

__all__ = ["SOURCES", "build_all", "library", "check"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
# kernel library name -> source file
SOURCES = {
    "int8_gemv": "int8_gemv.cu",
    "fused_block_decode": "fused_block_decode.cu",
    "lm_head_sample": "lm_head_sample.cu",
}
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise MXNetError("nvcc not found: the CUDA kernels are built from "
                     "source at first use and need the CUDA toolkit")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh"):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all() -> Dict[str, float]:
    """Compile every kernel library that is not built yet, one ``nvcc``
    per source, all started together. Returns {name: seconds} for the
    libraries this call compiled (ptxas register/spill reports go to
    ``build/kernels/<name>.log``)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in SOURCES.items():
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(BUILD_DIR / f"{name}.log", "w")
        cmd = [_nvcc(), *_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / src)]
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT),
                       log, tmp, out, time.perf_counter())
    took, failed = {}, []
    for name, (proc, log, tmp, out, t0) in procs.items():
        rc = proc.wait()
        log.close()
        took[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(f"{name} (nvcc exit {rc}): "
                          + (BUILD_DIR / f"{name}.log").read_text()[-4000:])
        else:
            os.replace(tmp, out)
    if failed:
        raise MXNetError("kernel build failed:\n" + "\n".join(failed))
    return took


def _declare(name: str, lib: ctypes.CDLL):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "int8_gemv":
        lib.mx_int8_gemv.argtypes = [p, p, p, p, i, i, i, p]
        lib.mx_int8_gemv.restype = i
    elif name == "fused_block_decode":
        lib.mx_fused_block_decode.argtypes = [p] * 22 + [i, i, i, i, f, p]
        lib.mx_fused_block_decode.restype = i
        lib.mx_fused_block_smem.argtypes = [i, i, i]
        lib.mx_fused_block_smem.restype = ctypes.c_longlong
    elif name == "lm_head_sample":
        lib.mx_lm_head_sample.argtypes = [p] * 8 + [i, i, i, i, p]
        lib.mx_lm_head_sample.restype = i
        lib.mx_head_tiles.argtypes = [i]
        lib.mx_head_tiles.restype = i


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built on first use)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(str(_target(name)))
            _declare(name, lib)
            _LIBS[name] = lib
        return lib


def check(rc: int, what: str):
    """Raise if a kernel's C entry point returned a CUDA error code."""
    if rc != 0:
        raise MXNetError(f"{what}: CUDA error {rc} at launch")
