#!/usr/bin/env python3
"""Compare K8 (fused head + token selection) and the block decode kernels
K5, K6 and K7 with another checkout's build of them, on one CUDA card.

    python3 tools/head_block_compare.py --other DIR [--out FILE] [--probes]

DIR is the root of another checkout of this repository (for example the
parent commit unpacked with ``git archive``). Its ``mxnet_tpu_torch`` is
imported under another name and builds its own kernels into
``DIR/build/kernels/``; every call to it goes through that checkout's own
wrappers (``fused_lm_head_sample``, ``fused_block_decode``,
``fused_block_decode_paged``), so the tool runs against any checkout whose
wrappers take these arguments.

1. Bits. K8: tokens at B 1, 3, 8, 9 and 16 for int8 and int4 tables, f32
   and bf16 h, logits rounded through bf16 or not, with and without a
   grammar mask (one row all forbidden, the last vocab lane forbidden),
   greedy and T 0.8 rows, over GPT-2's padded head (50304 x 768), a table
   whose last channel group is short (50258 rows, vocab 50257), a small
   one (1027 rows, vocab 1000) and a table of repeated rows (ties
   everywhere). K5, K6 and K7: the output and both caches or pools at
   ``chip_smoke``'s shapes (K5: B 8, L 1024, positions [1000, 3, 517, 64,
   999, 250, 0, 777], and every row at 64; K6: B 16, L 256, and its first 7
   rows + an inactive one at B 8; K7: B 8, L 1024, positions [1023, 517,
   64, 999, 250, 777, 3, 0]), K7 at L 256, K5 at B 1 (position L - 1), 9
   and 16 and with every row long, K6 at B 1 and 9. Each for int8 and int4
   packs of one GPT-2 small block, of an f32 model (f32 x and caches) and
   of a bf16 model (bf16 caches, bf16 x and f32 x). Any difference fails.
2. Times, by ``chip_smoke.Timer`` (L2 flushed, card held busy while the
   host enqueues), the other build and this one in turns (other, this,
   this, other), each through its own wrapper: K8 at B 8 (4 greedy, 4
   T 0.8 rows) in every lane, beside the warp-route head GEMV + ``argmax``
   and ``torch.matmul`` + ``argmax`` on the dequantized table; K5, K6 and
   K7 at the timed shapes of 1. in each (weights, model dtype) lane, also
   with this wrapper's kept operands dropped before every call
   (``this_reformed_ms``: the per-call bias and LayerNorm conversions a
   bf16 model's pack needed before), and each build's kernel alone on the
   device (``torch.profiler``).

With ``--probes`` it also builds altered copies of this checkout's K5, K6,
K7 and K8 and prints their device times at the timed shapes (f32, bf16 and
int4 lanes): each block kernel without attention (``no_attention``),
without the weight phases (``no_weights``), attention's copies alone
(``attention_copies``: no weights, no dots, no P.V) and the four grid
barriers alone (``barriers_only``); K7 also pass 1 alone (``pass1_only``)
and its copies alone (``pass1_copies``); K8 with the per-CTA pairs reduced
by a second launch instead of the last CTA (``k8_two_launches``, also
timed in turns with this build). The block probes' outputs are garbage by
design; the two-launch probe's tokens are checked. Each substitution names
exact source lines; the tool stops if one is gone.

Prints one JSON line per result (also written to ``--out``) and exits
non-zero if any output differs.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import importlib.util
import json
import shutil
import subprocess
import sys
from pathlib import Path

from nvcc_build import build

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

K8_ROWS = (1, 3, 8, 9, 16)
# (rows of the table, vocab): GPT-2's padded head, a short last channel
# group, a small table
K8_TABLES = ((50304, 50257), (50258, 50257), (1027, 1000))
K5_POS = [1000, 3, 517, 64, 999, 250, 0, 777]
K5_POS64 = [64] * 8
K5_LONG = [1023, 1000, 999, 960, 1023, 900, 1010, 1023]
K7_POS = [1023, 517, 64, 999, 250, 777, 3, 0]
POOL, PS = 600, 16
# kernel name in a profiler trace, per block kernel
DEVICE_KEYS = {"K5": "fused_block_decode_kernel", "K6": "fused_block_decode_paged_kernel",
               "K7": "fused_block_decode_paged_dma_kernel"}
# the libraries the other checkout builds
OTHER_SOURCES = ("lm_head_sample", "fused_block_decode", "fused_block_decode_paged",
                 "fused_block_decode_paged_dma")

_COMMON = "block_decode_common.cuh"
_K8 = "lm_head_sample.cu"
# Probe substitutions. The block kernels share their weight phases and
# their attention code (block_decode_common.cuh), so each substitution
# below alters whichever kernel's library is built from the copy.
# the weight phases' staging and GEMVs (their grid barriers stay)
_NO_WEIGHTS = ((_COMMON, (("    for (int r0 = 0; r0 < a.B; r0 += R) {\n",
                           "    for (int r0 = 0; r0 < 0; r0 += R) {\n"),)),)
# the attention phase (its two grid barriers stay)
_NO_ATTENTION = ((_COMMON, (("      attention();\n", ""),)),)
# pass 1 alone: neither V copies nor P.V
_K_ONLY = ((_COMMON, (("    const int ntile = src.tiles(pa), loads = 2 * ntile;\n",
                       "    const int ntile = src.tiles(pa), loads = ntile;\n"),
                      ("    const int nn = nk < 0 ? 0 : src.tiles(npa), nloads = 2 * nn;\n",
                       "    const int nn = nk < 0 ? 0 : src.tiles(npa), nloads = nn;\n"))),)
# the score dots, and the P.V FMAs
_NO_DOT = ((_COMMON, (("          sc[j] = s * scale;\n", "          sc[j] = scale;\n"),)),)
_NO_PV = ((_COMMON, (("          fma4(part, sc[j] / sum, load4(slot + static_cast<size_t>(j - j0) "
                      "* hd, d4));\n", ""),)),)
# K8 before its reduction was folded into the last CTA: every CTA leaves
# after writing its pairs, and a second launch (one CTA, a warp a row)
# reduces them
_TWO_LAUNCHES = ((_K8, (
    ("  mx::warp::gemv_warp<G, R, L, X>(smem, h, t, epi, M, N, K, ring);\n",
     "  mx::warp::gemv_warp<G, R, L, X>(smem, h, t, epi, M, N, K, ring);\n  return;\n"),
    ("template <class L, class X>\nusing HeadKernel",
     "__global__ void head_reduce_kernel(HeadArgs a, int B, int ctas) {\n"
     "  reduce_rows(a, B, ctas);\n}\n\ntemplate <class L, class X>\nusing HeadKernel"),
    ("                                                            Vp, D, p.ring);\n"
     "  return static_cast<int>(cudaGetLastError());\n",
     "                                                            Vp, D, p.ring);\n"
     "  err = cudaGetLastError();\n"
     "  if (err != cudaSuccess) return static_cast<int>(err);\n"
     "  head_reduce_kernel<<<1, mx::kThreads, 0, st>>>(a, B, p.grid);\n"
     "  return static_cast<int>(cudaGetLastError());\n"))),)
_LIB = {"K5": "fused_block_decode", "K6": "fused_block_decode_paged",
        "K7": "fused_block_decode_paged_dma", "K8": "lm_head_sample"}
# probe name: (kernel, ((source file, substitutions), ...)); each probe
# builds the kernel's library from a copy of csrc/ with them applied
PROBES = {
    f"{k.lower()}:{name}": (k, subs) for k in ("K5", "K6", "K7") for name, subs in (
        ("no_attention", _NO_ATTENTION), ("no_weights", _NO_WEIGHTS),
        ("attention_copies", _NO_WEIGHTS + _NO_DOT + _NO_PV),
        ("barriers_only", _NO_WEIGHTS + _NO_ATTENTION))}
# the weight phases in row tiles of 8 at every B (two passes at B 16)
_ROWS_OF_8 = ((_COMMON, (("  return B > kRowTile && block_tile_bytes(kWideRowTile, D) <= kSmemLimit",
                          "  return false && block_tile_bytes(kWideRowTile, D) <= kSmemLimit"),)),)
PROBES.update({"k6:rows_of_8": ("K6", _ROWS_OF_8),
               "k7:pass1_only": ("K7", _NO_WEIGHTS + _K_ONLY),
               "k7:pass1_copies": ("K7", _NO_WEIGHTS + _K_ONLY + _NO_DOT),
               "k8:two_launches": ("K8", _TWO_LAUNCHES)})


def other_package(root: Path, name="other_mxnet_tpu_torch"):
    """``root``'s ``mxnet_tpu_torch`` imported as ``name`` (its relative
    imports resolve inside it; its ``_build`` builds into
    ``root/build/kernels/``, only the libraries of OTHER_SOURCES).
    Returns (its ``ops.fused_block_gemv``, its ``_build``)."""
    pkg = root / "mxnet_tpu_torch"
    spec = importlib.util.spec_from_file_location(name, pkg / "__init__.py",
                                                  submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    obuild = importlib.import_module(name + "._build")
    for lib in list(obuild.SOURCES):
        if lib not in OTHER_SOURCES:
            del obuild.SOURCES[lib]
    return importlib.import_module(name + ".ops.fused_block_gemv"), obuild


def probe_sources(root: Path):
    """Copies of this checkout's csrc/, one per probe, with its
    substitutions applied: {probe: (csrc copy, library name)}."""
    csrc = ROOT / "mxnet_tpu_torch" / "csrc"
    dirs = {}
    for name, (kernel, files) in PROBES.items():
        d = root / name.replace(":", "_") / "csrc"
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(csrc, d)
        for fname, subs in files:
            text = (d / fname).read_text()
            for a, b in subs:
                if a not in text:
                    raise SystemExit(f"probe {name}: {fname} no longer holds {a!r}")
                text = text.replace(a, b)
            (d / fname).write_text(text)
        dirs[name] = (d, _LIB[kernel])
    return dirs


@contextlib.contextmanager
def this_wrapper_on(lib_name, lib):
    """This checkout's wrappers launch ``lib`` (a probe build) in place of
    their library ``lib_name`` while the block runs."""
    from mxnet_tpu_torch import _build
    saved = _build.library
    _build.library = lambda name: lib if name == lib_name else saved(name)
    try:
        yield
    finally:
        _build.library = saved


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, required=True)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--probes", action="store_true")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the comparison runs the kernels on the card")
    from chip_smoke import Timer, dequant, paged_inputs
    from mxnet_tpu_torch import _build
    from mxnet_tpu_torch.contrib.quantization import _quantize_int4, quantize_net
    from mxnet_tpu_torch.models import GPT2_SMALL, GPTModel
    from mxnet_tpu_torch.models.generation import _key_bits
    from mxnet_tpu_torch.ops import fused_block_gemv as fb
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
    ofb, obuild = other_package(args.other.resolve())
    _build.build_all()
    obuild.build_all()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    timer = Timer(torch)

    def device_us(fn, key, n=10):
        """Mean device time per call of the kernels whose name holds
        ``key``, by torch.profiler, L2 flushed before each call (a trace
        that holds no such kernel is taken again, up to twice)."""
        fn()
        torch.cuda.synchronize()
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    timer.flush.zero_()
                    fn()
                torch.cuda.synchronize()
            us = sum(e.device_time_total for e in prof.key_averages() if key in e.key) / n
            if us > 0:
                break
        return us

    def turns(fa, fb_):
        return [timer(fa), timer(fb_), timer(fb_), timer(fa)]

    # ---- K8 --------------------------------------------------------------
    def k8(mod, h, w, s, vocab, keys, temps, mask, rounded):
        return mod.fused_lm_head_sample(h, w, s, vocab, keys, temps, mask=mask,
                                        out_dtype=torch.bfloat16 if rounded else None)

    def head_table(bits, N, tied=False):
        if bits == 8:
            w = torch.randint(-127, 128, (N, 768), device="cuda", generator=gen,
                              dtype=torch.int8)
            s = torch.rand(N, device="cuda", generator=gen) * 0.02 + 1e-3
            if tied:   # row v repeats row v % 1009: equal logits everywhere
                idx = torch.arange(N, device="cuda") % 1009
                w, s = w[idx].contiguous(), s[idx].contiguous()
            return w, s
        return _quantize_int4(torch.randn(N, 768, device="cuda", generator=gen))

    def k8_case(B, vocab, temp):
        h = torch.randn(B, 768, device="cuda", generator=gen) * 2
        keys = torch.from_numpy(np.stack(
            [_key_bits(np.arange(B) + 300, np.arange(B)), np.arange(B) * 7919], -1)).cuda()
        temps = torch.tensor([0.0 if r % 2 == 0 else temp for r in range(B)], device="cuda")
        mask = torch.rand(B, vocab, device="cuda", generator=gen) < 0.3
        mask[:, vocab - 1] = False
        mask[B // 2] = False                      # a row with every lane forbidden
        return h, keys, temps, mask

    differ = []
    cases = [(b, N, v, False) for b in (8, 4) for N, v in K8_TABLES] + [(8, 50304, 50257, True)]
    for bits, N, vocab, tied in cases:
        w, s = head_table(bits, N, tied)
        for B in K8_ROWS:
            h, keys, temps, mask = k8_case(B, vocab, 0.8)
            for hd in (torch.float32, torch.bfloat16):
                hh = h.to(hd).contiguous()
                for rounded in (False, True):
                    for m in (None, mask):
                        for t in (temps, torch.zeros(B, device="cuda")):
                            # [B, 2] keys, or (odd B) their [B] key bits
                            kk = keys[:, 0] ^ keys[:, 1] if B % 2 else keys
                            got = k8(fb, hh, w, s, vocab, kk, t, m, rounded)
                            ref = k8(ofb, hh, w, s, vocab, kk, t, m, rounded)
                            torch.cuda.synchronize()
                            if not torch.equal(got, ref):
                                differ.append({"k8": True, "bits": bits, "N": N, "B": B,
                                               "tied": tied, "h": str(hd),
                                               "rounded": rounded, "mask": m is not None,
                                               "T": float(t.max()), "this": got.tolist(),
                                               "other": ref.tolist()})
    emit({"k8_tokens_equal_other": not differ, "differ": differ[:10]})

    # ---- K5, K6, K7 --------------------------------------------------------
    packs = {}
    for bits in (8, 4):
        for dt in (torch.float32, torch.bfloat16):
            with torch.no_grad():
                net = GPTModel(dataclasses.replace(GPT2_SMALL, num_layers=1, dtype=dt,
                                                   dropout=0.0),
                               device="cuda").init_weights(args.seed)
            quantize_net(net, fused_decode=True, bits=bits)
            packs[bits, dt] = fb.pack_gpt_block(net.blocks[0], eps=net.cfg.layer_norm_eps)
            del net

    def k5_inputs(dt, pos):
        B, D, H, L = len(pos), 768, 12, 1024
        x = torch.randn(B, 1, D, device="cuda", generator=gen).to(dt)
        kc = (torch.randn(B, H, L, D // H, device="cuda", generator=gen) * 0.1).to(dt)
        vc = (torch.randn(B, H, L, D // H, device="cuda", generator=gen) * 0.1).to(dt)
        return x, torch.tensor(pos, dtype=torch.int32, device="cuda"), kc, vc

    rng = np.random.RandomState(args.seed + 6)
    pos256 = [200, 255, 33] + rng.randint(0, 256, 12).tolist() + [0]
    # K6 at B 8: the B 16 case's first 7 rows and its inactive last row
    pos256_b8 = pos256[:7] + [0]
    # (kernel, maxp, positions), timed: K5's shape and every row at
    # position 64; K6's shape and its first rows at B 8; K7's shape
    timed_shapes = (("K5", 64, K5_POS), ("K5", 64, K5_POS64), ("K6", 16, pos256),
                    ("K6", 16, pos256_b8), ("K7", 64, K7_POS))
    # held bit for bit as well: K7 at L 256; K5 and K6 at B 1, 9 and 16,
    # K5 with every row long and at positions 0 and L - 1
    bit_shapes = timed_shapes + (
        ("K7", 16, pos256), ("K5", 64, [1023]), ("K5", 64, K5_POS + [511]),
        ("K5", 64, K5_POS + [1023, 0, 1, 700, 64, 65, 128, 900]),
        ("K5", 64, K5_LONG), ("K6", 16, [255]), ("K6", 16, pos256[:8] + [0]))

    def block_call(mod, kernel, inputs, pack):
        if kernel == "K5":
            x, pos, kc, vc = inputs
            return mod.fused_block_decode(x, pos, kc, vc, pack)
        x, posv, table, kp, vp = inputs
        return mod.fused_block_decode_paged(x, posv, table, kp, vp, pack)

    def with_x(inputs, x):
        return (x,) + tuple(inputs[1:])

    def same_step(kernel, inputs, pack):
        """Both builds on copies of the caches or pools: equal bits?"""
        kc, vc = inputs[-2:]
        a = tuple(inputs[:-2]) + (kc.clone(), vc.clone())
        b = tuple(inputs[:-2]) + (kc.clone(), vc.clone())
        o1 = block_call(fb, kernel, a, pack)[0]
        o2 = block_call(ofb, kernel, b, pack)[0]
        torch.cuda.synchronize()
        return (torch.equal(o1, o2) and torch.equal(a[-2], b[-2])
                and torch.equal(a[-1], b[-1])), (o1 - o2).abs().max().item()

    def block_inputs(kernel, maxp, pos, dt):
        if kernel == "K5":
            return k5_inputs(dt, pos)
        if len(pos) == 1:   # paged_inputs makes two active rows and an inactive one
            x, posv, table, kp, vp = paged_inputs(torch, gen, 768, 12, 3, PS, maxp, POOL,
                                                  pos * 2 + [0], dt)
            return x[:1], posv[:1], table[:1].contiguous(), kp, vp
        return paged_inputs(torch, gen, 768, 12, len(pos), PS, maxp, POOL, pos, dt)

    block_differ = []
    for (bits, dt), pack in packs.items():
        for kernel, maxp, pos in bit_shapes:
            inputs = block_inputs(kernel, maxp, pos, dt)
            for x in ((inputs[0], inputs[0].float()) if dt == torch.bfloat16
                      else (inputs[0],)):
                ok, err = same_step(kernel, with_x(inputs, x), pack)
                if not ok:
                    block_differ.append({"kernel": kernel, "bits": bits, "model": str(dt),
                                         "x": str(x.dtype), "L": maxp * PS, "pos": pos,
                                         "max_abs": err})
    emit({"k5_k6_k7_bits_equal_other": not block_differ, "differ": block_differ[:10]})

    # ---- times -----------------------------------------------------------
    w8, s8 = head_table(8, 50304)
    w4, s4 = head_table(4, 50304)
    B, vocab = 8, 50257
    h, keys, _, mask = k8_case(B, vocab, 0.8)
    mask[B // 2] = True
    temps = torch.tensor([0.0] * 4 + [0.8] * 4, device="cuda")
    hb = h.bfloat16()
    k8_lanes = (("f32", w8, s8, h, None, False), ("int4", w4, s4, h, None, False),
                ("mask", w8, s8, h, mask, False), ("int4_mask", w4, s4, h, mask, False),
                ("bf16", w8, s8, hb, None, True), ("int4_bf16", w4, s4, hb, None, True))
    for lane_name, w, s, hh, m, rounded in k8_lanes:
        t = turns(lambda: k8(ofb, hh, w, s, vocab, keys, temps, m, rounded),
                  lambda: k8(fb, hh, w, s, vocab, keys, temps, m, rounded))
        wd = dequant(torch, w, s).to(hh.dtype)
        emit({"k8": lane_name, "B": B, "other_ms": [t[0], t[3]], "this_ms": [t[1], t[2]],
              "warp_head_argmax_ms": timer(
                  lambda: torch.argmax(ig.weight_matmul(hh, w, s)[:, :vocab], -1)),
              "matmul_argmax_ms": timer(lambda: torch.argmax(torch.matmul(hh, wd.T), -1))})

    for (bits, dt), pack in packs.items():
        for kernel, maxp, pos in timed_shapes:
            inputs = block_inputs(kernel, maxp, pos, dt)

            def reformed(inputs=inputs, kernel=kernel, pack=pack):
                pack.pop("_kernel_operands", None)
                return block_call(fb, kernel, inputs, pack)

            t = turns(lambda: block_call(ofb, kernel, inputs, pack),
                      lambda: block_call(fb, kernel, inputs, pack))
            key = DEVICE_KEYS[kernel]
            emit({"block": kernel, "bits": bits, "model": str(dt), "L": maxp * PS,
                  "pos": pos, "other_ms": [t[0], t[3]], "this_ms": [t[1], t[2]],
                  "this_reformed_ms": timer(reformed),
                  "other_device_us": device_us(lambda: block_call(ofb, kernel, inputs, pack),
                                               key),
                  "this_device_us": device_us(lambda: block_call(fb, kernel, inputs, pack),
                                              key)})

    if args.probes:
        dirs = probe_sources(args.other / "build" / "probes")
        probes = dict(zip(dirs, build([(d, d.parent / "build", lib)
                                       for d, lib in dirs.values()])))
        for name, lib in probes.items():
            _build._declare(dirs[name][1], lib)
        for kernel, maxp, pos in timed_shapes:
            for bits, dt in ((8, torch.float32), (8, torch.bfloat16), (4, torch.float32)):
                inputs = block_inputs(kernel, maxp, pos, dt)
                pack = packs[bits, dt]
                key = DEVICE_KEYS[kernel]
                step = lambda: block_call(fb, kernel, inputs, pack)  # noqa: E731
                row = {"this": device_us(step, key),
                       "other": device_us(lambda: block_call(ofb, kernel, inputs, pack), key)}
                for pname, lib in probes.items():
                    if PROBES[pname][0] == kernel:
                        with this_wrapper_on(_LIB[kernel], lib):
                            row[pname.split(":")[1]] = device_us(step, key)
                emit({"probe": kernel, "lane": "int4" if bits == 4 else str(dt).split(".")[1],
                      "B": len(pos), "L": maxp * PS, "pos": pos, "probe_device_us": row})
        two = probes["k8:two_launches"]
        for lane_name, w, s, hh, m, rounded in k8_lanes[:2]:
            this = lambda: k8(fb, hh, w, s, vocab, keys, temps, m, rounded)  # noqa: E731
            with this_wrapper_on("lm_head_sample", two):
                got = this()
            want = this()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                differ.append({"probe": "k8_two_launches", "lane": lane_name})

            def two_launches():
                with this_wrapper_on("lm_head_sample", two):
                    return this()

            t = turns(two_launches, this)
            emit({"k8": lane_name, "two_launches_ms": [t[0], t[3]], "folded_ms": [t[1], t[2]],
                  "two_launches_device_us": device_us(two_launches, "head_"),
                  "folded_device_us": device_us(this, "head_")})
    if out:
        out.close()
    if differ or block_differ:
        raise SystemExit(f"{len(differ) + len(block_differ)} outputs differ from the other "
                         "build's")


if __name__ == "__main__":
    main()
