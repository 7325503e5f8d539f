#!/usr/bin/env python3
"""Compare the warp route of K3/K4 (decode rows) with another build of the
same kernels, on one CUDA card.

    python3 tools/gemv_warp_compare.py --other DIR [--out FILE] [--probes]

DIR is the root of another checkout of this repository (for example an
earlier commit unpacked with ``git archive``). Its
``mxnet_tpu_torch/csrc/int8_gemv.cu`` and ``int4_gemv.cu`` are built with
this checkout's nvcc flags into ``DIR/build/compare/`` and called through
their C entry points ``mx_int8_gemv`` / ``mx_int4_gemv``, whose arguments
must be this checkout's.

1. Bits: at every (N, K) of ``chip_smoke.GEMV_SHAPES``, and at widths that
   leave a short last channel group, for M = 1..8 and 70 rows, f32 and
   bf16 x, int8 and int4 tables, this checkout's output must equal the
   other build's bit for bit.
2. Times at 1 and 8 rows: the other build and this one in turns (other,
   this, this, other), and ``torch.matmul`` on the dequantized weight in
   x's dtype, by ``chip_smoke.Timer`` (L2 flushed, card held busy while
   the host enqueues); and each build's kernel time on the device by
   ``torch.profiler``.

With ``--probes`` it also builds three altered copies of this checkout's
warp route, to split its time: ``copy_only`` (the weight copies and
waits, no dot products), ``compute_only`` (dot products over whatever the
ring holds, no copies or waits) and ``compute_no_x`` (that, without
staging x). Their outputs are garbage by design; only their device time
at the tied head and at one block GEMV is printed.

Prints one JSON line per result (also written to ``--out``) and exits
non-zero if any output differs.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# widths with a short last group of the 4-, 2- and 1-channel groups, a deep
# row count past gemv_max_m() (row tiles of 8)
EXTRA_SHAPES = ((770, 768), (1026, 3072), (3, 256))
BIT_ROWS = tuple(range(1, 9)) + (70,)

# --probes: text substitutions in csrc/gemv_warp.cuh per probe build
_NO_COPY = (
    ("        mxh::mbar_wait(bars + st, static_cast<uint32_t>((s / ring.stages) & 1));\n", ""),
    ("          L::template copy<G>(stage, t, n_first + ((s + ring.stages) % nring) * n_step, "
     "bars + st);\n", ""),
    ("      L::template copy<G>(ringp + static_cast<size_t>(s) * ring.stage_bytes, t,\n"
     "                          n_first + (s % nring) * n_step, bars + s);\n", ""))
PROBES = {
    "copy_only": (("  for (int c = lane; c < nchunk; c += 32) {",
                   "  for (int c = lane; c < 0; c += 32) {"),),
    "compute_only": _NO_COPY,
    "compute_no_x": _NO_COPY + (("    stage_x(xs, x, r0, nr, R, K);\n", ""),),
}


def build(src: Path, out: Path, names=("int8_gemv", "int4_gemv")):
    """nvcc each of ``names`` from ``src`` into ``out`` at once; returns the
    loaded libraries with their GEMV entry points declared."""
    from nvcc_build import build as build_jobs
    libs = dict(zip(names, build_jobs([(src, out, name) for name in names])))
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, lib in libs.items():
        if name == "int8_gemv":
            lib.mx_int8_gemv.argtypes = [p, p, p, p, i, i, i, i, p]
        else:
            lib.mx_int4_gemv.argtypes = [p, p, p, p, i, i, i, i, i, p]
    return libs


def probe_sources(root: Path):
    """Copies of this checkout's csrc/ with each probe's substitutions."""
    import shutil
    csrc = ROOT / "mxnet_tpu_torch" / "csrc"
    dirs = {}
    for name, subs in PROBES.items():
        d = root / name / "csrc"
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(csrc, d)
        text = (d / "gemv_warp.cuh").read_text()
        for a, b in subs:
            if a not in text:
                raise SystemExit(f"probe {name}: gemv_warp.cuh no longer holds {a!r}")
            text = text.replace(a, b)
        (d / "gemv_warp.cuh").write_text(text)
        dirs[name] = d
    return dirs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, required=True)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--probes", action="store_true")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the comparison runs the kernels on the card")
    from chip_smoke import BF16_FLOP_PER_S, GEMV_SHAPES, Timer, bound, dequant, table_bytes
    from mxnet_tpu_torch import _build
    from mxnet_tpu_torch.contrib.quantization import _quantize_int4
    from mxnet_tpu_torch.ops import int8_gemv as ig
    from torch.profiler import ProfilerActivity, profile
    torch.backends.cuda.matmul.allow_tf32 = False
    out = open(args.out, "w") if args.out else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if out:
            out.write(line + "\n")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    emit({"card": smi})
    _build.build_all()
    other = build(args.other / "mxnet_tpu_torch" / "csrc", args.other / "build" / "compare")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    def operands(bits, N, K):
        if bits == 8:
            w = torch.randint(-127, 128, (N, K), device="cuda", generator=gen, dtype=torch.int8)
            return w, torch.rand(N, device="cuda", generator=gen) * 0.02 + 1e-3
        return _quantize_int4(torch.randn(N, K, device="cuda", generator=gen))

    def call(libs, bits, x, w, s):
        M, K = x.shape
        N = w.shape[0]
        y = torch.empty(M, N, device="cuda")
        st = torch.cuda.current_stream().cuda_stream
        xb = int(x.dtype == torch.bfloat16)
        if bits == 8:
            rc = libs["int8_gemv"].mx_int8_gemv(x.data_ptr(), w.data_ptr(), s.data_ptr(),
                                                y.data_ptr(), M, N, K, xb, st)
        else:
            rc = libs["int4_gemv"].mx_int4_gemv(x.data_ptr(), w.data_ptr(), s.data_ptr(),
                                                y.data_ptr(), M, N, K, K // s.shape[1], xb, st)
        _build.check(rc, "a compared build")
        return y

    def call_other(bits, x, w, s):
        return call(other, bits, x, w, s)

    timer = Timer(torch)

    def device_us(fn, n=10):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                timer.flush.zero_()
                fn()
            torch.cuda.synchronize()
        return sum(e.device_time_total for e in prof.key_averages() if "gemv" in e.key) / n

    fn8 = ig.int8_weight_matmul
    differ = []
    for bits in (8, 4):
        fn = ig.int8_weight_matmul if bits == 8 else ig.int4_weight_matmul
        for N, K in tuple(GEMV_SHAPES) + EXTRA_SHAPES:
            w, s = operands(bits, N, K)
            x80 = torch.randn(max(BIT_ROWS), K, device="cuda", generator=gen)
            for xd in (torch.float32, torch.bfloat16):
                for M in BIT_ROWS:
                    x = x80[:M].to(xd).contiguous()
                    got, ref = fn(x, w, s), call_other(bits, x, w, s)
                    torch.cuda.synchronize()
                    if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
                        differ.append({"bits": bits, "N": N, "K": K, "M": M, "x": str(xd),
                                       "max_abs": (got - ref).abs().max().item()})
    emit({"bits_equal_other": not differ, "differ": differ[:20]})

    for bits in (8, 4):
        fn = ig.int8_weight_matmul if bits == 8 else ig.int4_weight_matmul
        for N, K in GEMV_SHAPES:
            w, s = operands(bits, N, K)
            wd = dequant(torch, w, s)
            for xd in (torch.float32, torch.bfloat16):
                wl = wd.to(xd)
                for M in (1, 8):
                    x = torch.randn(M, K, device="cuda", generator=gen).to(xd)
                    t = [timer(lambda: call_other(bits, x, w, s)), timer(lambda: fn(x, w, s)),
                         timer(lambda: fn(x, w, s)), timer(lambda: call_other(bits, x, w, s))]
                    xsize = x.element_size()
                    b_ms, b_by = bound(xsize * M * K + table_bytes(w, s) + 4 * M * N,
                                       2 * M * N * K, BF16_FLOP_PER_S)
                    emit({"bits": bits, "N": N, "K": K, "M": M, "x": str(xd).split(".")[-1],
                          "other_ms": [t[0], t[3]], "this_ms": [t[1], t[2]],
                          "library_ms": timer(lambda: torch.matmul(x, wl.T)),
                          "other_device_us": device_us(lambda: call_other(bits, x, w, s)),
                          "this_device_us": device_us(lambda: fn(x, w, s)),
                          "bound_ms": b_ms, "bound_by": b_by})
    if args.probes:
        probes = {name: build(d, d.parent / "build", ("int8_gemv",))
                  for name, d in probe_sources(args.other / "build" / "probes").items()}
        for N, K in ((50304, 768), (2304, 768)):
            w, s = operands(8, N, K)
            for xd in (torch.float32, torch.bfloat16):
                for M in (1, 8):
                    x = torch.randn(M, K, device="cuda", generator=gen).to(xd)
                    row = {"probe_device_us": {"this": device_us(lambda: fn8(x, w, s))},
                           "N": N, "K": K, "M": M, "x": str(xd).split(".")[-1]}
                    for name, libs in probes.items():
                        row["probe_device_us"][name] = device_us(
                            lambda: call(libs, 8, x, w, s))
                    emit(row)
    if out:
        out.close()
    if differ:
        raise SystemExit(f"{len(differ)} outputs differ from the other build's")


if __name__ == "__main__":
    main()
