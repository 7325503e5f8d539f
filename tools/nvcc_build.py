"""Build kernel sources of any checkout with this checkout's nvcc flags.

The compare tools (``tools/gemv_warp_compare.py``,
``tools/head_block_compare.py``) use it for builds that
``mxnet_tpu_torch._build`` does not make: altered copies of ``csrc/`` for
probes, and another checkout's sources.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def build(jobs):
    """nvcc every (source directory, output directory, name) of ``jobs``
    at once, ``name.cu`` into ``lib<name>.so``; returns the loaded
    libraries in the order of ``jobs``. Stops with nvcc's log if one
    fails."""
    from mxnet_tpu_torch import _build
    procs = []
    for src, out, name in jobs:
        out.mkdir(parents=True, exist_ok=True)
        log = open(out / f"{name}.log", "w")
        procs.append((subprocess.Popen(
            [_build._nvcc(), *_build._FLAGS, "-I", str(src), "-o", str(out / f"lib{name}.so"),
             str(src / f"{name}.cu")], stdout=log, stderr=subprocess.STDOUT), log))
    libs = []
    for (src, out, name), (proc, log) in zip(jobs, procs):
        rc = proc.wait()
        log.close()
        if rc:
            raise SystemExit(f"building {src / name}.cu failed:\n"
                             + (out / f"{name}.log").read_text()[-3000:])
        libs.append(ctypes.CDLL(str(out / f"lib{name}.so")))
    return libs
