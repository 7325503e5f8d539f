#!/usr/bin/env python3
"""Run the PyTorch / H100 port once on the card, end to end.

    python3 chip_smoke.py [--seed N]

1. Builds the hand-written CUDA kernels from ``mxnet_tpu_torch/csrc``.
2. Holds each kernel of the serving path (K3 int8 GEMV, K5 one-launch block
   decode, K8 fused LM-head sampler) against its plain PyTorch version at
   GPT-2-small shapes and times kernel, plain version and a library
   yardstick with CUDA events (L2 flushed before every timed launch).
3. Serves 12 concurrent requests with ``InferenceEngine`` over int8 GPT-2
   small (12 layers, D 768, vocab 50257, random weights from ``--seed``)
   and checks the tokens against ``generate()`` on the card and against
   the plain path on the CPU, and that every kernel of the path launched.
   The 8 greedy requests are then served once more under
   ``torch.profiler`` to split the window into device time per kernel
   and idle time.

Informational JSON lines come first; the last line is
``{"ok": true, "device": {...}}``. Any failed check raises and the script
exits non-zero without that line. It needs one CUDA card and refuses to
run without one. It imports neither jax nor the JAX package.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
F32_FLOP_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
LAYERS = 12


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def emit(obj):
    print(json.dumps(obj), flush=True)


def bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of the byte time at HBM rate and
    the f32 FMA time at the CUDA-core peak (the kernels run f32 FMAs)."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = flops / F32_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


class Timer:
    """Median CUDA-event time of one call, with the 50 MB L2 flushed
    before every timed launch (decode streams each weight once per step,
    so the real caller finds it cold)."""

    def __init__(self, torch, iters=15, warmup=3):
        self.torch = torch
        self.iters, self.warmup = iters, warmup
        self.flush = torch.empty(64 * 1024 * 1024, device="cuda")  # 256 MB

    def __call__(self, fn):
        torch = self.torch
        for _ in range(self.warmup):
            fn()
        times = []
        for _ in range(self.iters):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def kernel_k3(torch, timer, gen):
    """K3 at every (M, N, K) the serving path gives it; returns the row
    of the tied-head shape and the per-shape table."""
    from mxnet_tpu_torch.ops import int8_gemv
    rows = []
    for M in (1, 8, 64):
        for N, K in ((2304, 768), (768, 768), (3072, 768), (768, 3072),
                     (50304, 768)):
            x = torch.randn(M, K, device="cuda", generator=gen)
            w = torch.randint(-127, 128, (N, K), device="cuda", generator=gen,
                              dtype=torch.int8)
            s = torch.rand(N, device="cuda", generator=gen) * 0.02 + 1e-3
            got = int8_gemv.int8_weight_matmul(x, w, s)
            plain = int8_gemv._reference_int8_matmul(x, w, s)
            torch.cuda.synchronize()
            err = (got - plain).abs().max().item()
            tol = 1e-4 * max(1.0, plain.abs().max().item())
            check(err <= tol, f"K3 M={M} N={N} K={K}: max abs err {err} > {tol}")
            wdeq = w.float() * s[:, None]
            b_ms, b_by = bound(4 * M * K + N * K + 4 * N + 4 * M * N, 2 * M * N * K)
            rows.append({
                "M": M, "N": N, "K": K, "max_abs_err": err, "tol": tol,
                "ms": timer(lambda: int8_gemv.int8_weight_matmul(x, w, s)),
                "plain_ms": timer(lambda: int8_gemv._reference_int8_matmul(x, w, s)),
                "library_ms": timer(lambda: torch.matmul(x, wdeq.T)),
                "bound_ms": b_ms, "bound_by": b_by})
    emit({"k3_shapes": rows})
    # the serving path's K3 work: one layer's four block GEMVs at the
    # largest prefill bucket (64 rows)
    layer = [r for r in rows if r["M"] == 64 and r["N"] != 50304]
    out = {k: sum(r[k] for r in layer)
           for k in ("ms", "plain_ms", "library_ms")}
    out["max_abs_err"] = max(r["max_abs_err"] for r in layer)
    nbytes = sum(4 * 64 * r["K"] + r["N"] * r["K"] + 4 * r["N"] + 4 * 64 * r["N"]
                 for r in layer)
    out["bound_ms"], out["bound_by"] = bound(
        nbytes, sum(2 * 64 * r["N"] * r["K"] for r in layer))
    return out


def kernel_k5(torch, timer, gen, pack):
    """K5 at B=8, D=768, H=12, L=1024 with mixed per-row positions."""
    from mxnet_tpu_torch.ops import fused_block_gemv as fb
    B, D, H, L = 8, 768, 12, 1024
    hd = D // H
    pos = torch.tensor([1000, 3, 517, 64, 999, 250, 0, 777], dtype=torch.int32,
                       device="cuda")
    x = torch.randn(B, 1, D, device="cuda", generator=gen)
    kc = torch.randn(B, H, L, hd, device="cuda", generator=gen) * 0.1
    vc = torch.randn(B, H, L, hd, device="cuda", generator=gen) * 0.1
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    out, _, _ = fb.fused_block_decode(x, pos, k1, v1, pack)
    plain, _, _ = fb._reference_block_decode(x, pos, k2, v2, pack)
    torch.cuda.synchronize()
    written = torch.zeros(B, H, L, dtype=torch.bool, device="cuda")
    written[torch.arange(B, device="cuda"), :, pos.long()] = True
    for new, ref, old in ((k1, k2, kc), (v1, v2, vc)):
        check(torch.equal(new[~written], old[~written])
              and torch.equal(ref[~written], old[~written]),
              "K5 touched cache rows other than pos")
    tol = 1e-4 * max(1.0, plain.abs().max().item())
    err = max((out - plain).abs().max().item(),
              (k1 - k2).abs().max().item(), (v1 - v2).abs().max().item())
    check(err <= tol, f"K5: max abs err {err} > {tol}")
    attended = int((pos.long() + 1).sum().item()) * H
    nbytes = (12 * D * D + 4 * 2 * 9 * D + 4 * 4 * D      # weights, scales, LN
              + 4 * B * D * 2 + 4 * B                      # x, out, pos
              + attended * hd * 4 * 2                      # K/V rows read
              + B * H * hd * 4 * 2)                        # new rows written
    flops = 2 * B * 12 * D * D + attended * hd * 4
    b_ms, b_by = bound(nbytes, flops)
    # every row at position 64, the smoke traffic's range: the step is
    # then almost all weight GEMVs, which splits K5's time into its phases
    pos64 = torch.full((B,), 64, dtype=torch.int32, device="cuda")
    return {"max_abs_err": err, "tol": tol,
            "ms_pos64": timer(lambda: fb.fused_block_decode(x, pos64, k1, v1, pack)),
            "ms": timer(lambda: fb.fused_block_decode(x, pos, k1, v1, pack)),
            "plain_ms": timer(lambda: fb._reference_block_decode(x, pos, k2, v2, pack)),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "shape": {"B": B, "D": D, "H": H, "L": L, "pos": pos.tolist()}}


def kernel_k8(torch, timer, gen, head):
    """K8 at B=8 over the padded GPT-2 table, 4 greedy and 4 T=0.8 rows."""
    import numpy as np

    from mxnet_tpu_torch.models.generation import _key_bits
    from mxnet_tpu_torch.ops import fused_block_gemv as fb
    w_q, scale, vocab = head
    B, D = 8, w_q.shape[1]
    Vp = w_q.shape[0]
    h = torch.randn(B, D, device="cuda", generator=gen)
    temps = torch.tensor([0.0] * 4 + [0.8] * 4, device="cuda")
    kb = torch.from_numpy(_key_bits(np.arange(B) + 100, np.arange(B))).cuda()
    got = fb.fused_lm_head_sample(h, w_q, scale, vocab, kb, temps)
    plain = fb._reference_head_sample(h, w_q, scale, vocab, temps, kb)
    torch.cuda.synchronize()
    check(torch.equal(got, plain), f"K8 tokens {got.tolist()} != {plain.tolist()}")
    wdeq = w_q.float() * scale[:, None]
    b_ms, b_by = bound(Vp * D + 4 * Vp + 4 * B * D + 12 * B, 2 * B * Vp * D)
    return {"max_abs_err": 0.0, "tokens": got.tolist(),
            "ms": timer(lambda: fb.fused_lm_head_sample(h, w_q, scale, vocab, kb, temps)),
            "plain_ms": timer(lambda: fb._reference_head_sample(h, w_q, scale, vocab,
                                                                temps, kb)),
            "library_ms": timer(lambda: torch.argmax(torch.matmul(h, wdeq.T), -1)),
            "bound_ms": b_ms, "bound_by": b_by}


def first_divergence(a, b):
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None


def top2_gap(torch, net, tokens):
    """Top-1 minus top-2 logit of ``net`` after ``tokens`` (plain path)."""
    ids = torch.tensor([tokens], dtype=torch.int32, device=net.device)
    caches = net.new_caches(1, len(tokens))
    with torch.no_grad():
        logits = net.forward_cached(ids, 0, *caches)[0][0, -1]
    top = torch.topk(logits, 2).values
    return (top[0] - top[1]).item()


def device_share(torch, eng, prompts, new):
    """Serve ``prompts`` (greedy) once more under ``torch.profiler`` and
    split the window's host wall time into device kernel time per kernel
    and idle time. Returns None where the trace holds no device kernel."""
    from mxnet_tpu_torch import _build
    from torch.profiler import ProfilerActivity, profile
    path = _build.BUILD_DIR.parent / "profile" / "decode_trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    before = eng.stats()
    # device activity only: recording every host op would stretch the
    # host-bound window that is being measured
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        handles = [eng.submit(p, new) for p in prompts]
        results = [h.result(timeout=600) for h in handles]
        wall = time.perf_counter() - t0
    after = eng.stats()
    for i, r in enumerate(results):
        check(r.ok, f"profiled request {i}: {r.status} {r.error}")
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") in
                   ("kernel", "gpu_memcpy", "gpu_memset"))
    if not spans:
        return None
    busy, end = 0.0, float("-inf")          # union of the device intervals
    for a, b, _ in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    by_kernel = {}
    for a, b, name in spans:
        key = next((k for k in ("fused_block_decode", "head_tiles", "head_reduce",
                                "int8_gemv") if k in name), "other")
        by_kernel[key] = by_kernel.get(key, 0.0) + (b - a) / 1e3
    substeps = after["decode_substeps"] - before["decode_substeps"]
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / 1e3 / (wall * 1e3),
            "kernel_ms": by_kernel, "device_ops": len(spans),
            "decode_substeps": substeps,
            "ms_per_decode_step": (after["decode_s"] - before["decode_s"])
            / substeps * 1e3}


def serve(torch, args, net, cpu_net):
    import numpy as np

    from mxnet_tpu_torch.models import generate
    from mxnet_tpu_torch.ops.int8_gemv import launches, reset_launches
    from mxnet_tpu_torch.serve import InferenceEngine
    rng = np.random.RandomState(args.seed)
    vocab = net.cfg.vocab_size
    prompts = [rng.randint(0, vocab, int(n)).tolist()
               for n in rng.randint(8, 49, 12)]
    temps = [0.0] * 8 + [0.8] * 4
    new = 64
    eng = InferenceEngine(net, max_batch_size=8, max_len=512, multi_token=4,
                          fused=True).start()
    try:
        warm = eng.generate(prompts[0][:8], 8, timeout=600)
        check(warm.ok, f"warm-up request failed: {warm.error}")
        before = eng.stats()
        reset_launches()
        t0 = time.perf_counter()
        handles = [eng.submit(p, new, temperature=t, seed=1000 + i)
                   for i, (p, t) in enumerate(zip(prompts, temps))]
        results = [h.result(timeout=600) for h in handles]
        wall = time.perf_counter() - t0
        counts = launches()
        after = eng.stats()
        again = [eng.submit(prompts[i], new, temperature=0.8, seed=1000 + i)
                 for i in range(8, 12)]
        again = [h.result(timeout=600) for h in again]
        profiled = device_share(torch, eng, prompts[:8], new)
    finally:
        eng.shutdown(drain=True, timeout=600)
    for i, r in enumerate(results):
        check(r.ok and len(r.generated_ids) == new, f"request {i}: {r.status} "
              f"{len(r.generated_ids)} tokens {r.error}")
    substeps = after["decode_substeps"] - before["decode_substeps"]
    check(counts.get("fused_block", 0) == LAYERS * substeps,
          f"K5 launches {counts.get('fused_block')} != 12 x {substeps} decode steps")
    check(counts.get("fused_head", 0) > 0, "K8 never launched on the serving path")
    check(counts.get("gemv", 0) > 0, "K3 never launched on the serving path")
    for i in range(8, 12):
        toks = results[i].generated_ids
        check(all(0 <= t < vocab for t in toks), f"request {i}: token outside vocab")
        check(again[i - 8].generated_ids == toks,
              f"request {i}: same seed gave another sample")
    gen_match = []
    for i in range(8):
        p = torch.tensor([prompts[i]], dtype=torch.int32)
        for mt in (4, 1):
            ref = generate(net, p, new, multi_token=mt)[0, len(prompts[i]):].tolist()
            check(ref == results[i].generated_ids,
                  f"request {i}: engine tokens != generate(multi_token={mt}) on the card "
                  f"(first divergence {first_divergence(ref, results[i].generated_ids)})")
        gen_match.append(i)
    cpu_rows = []
    t_cpu = time.perf_counter()
    for i in range(2):
        p = torch.tensor([prompts[i]], dtype=torch.int32)
        ref = generate(cpu_net, p, new)[0, len(prompts[i]):].tolist()
        got = results[i].generated_ids
        d = first_divergence(ref, got)
        row = {"request": i, "equal": d is None, "first_divergence": d}
        if d is not None:
            row["top2_gap"] = top2_gap(torch, cpu_net, prompts[i] + ref[:d])
            check(row["top2_gap"] < 1e-3,
                  f"request {i}: card and CPU diverge at {d} with top-2 gap "
                  f"{row['top2_gap']}")
        cpu_rows.append(row)
    emit({"cpu_compare": cpu_rows, "cpu_s": time.perf_counter() - t_cpu})
    tokens = sum(len(r.generated_ids) for r in results)
    dsteps = after["decode_substeps"] - before["decode_substeps"]
    dsec = after["decode_s"] - before["decode_s"]
    emit({"engine": {"requests": len(results), "greedy": 8, "sampled": 4,
                     "new_tokens_each": new, "wall_s": wall,
                     "tokens_per_s": tokens / wall,
                     "decode_substeps": dsteps,
                     "decode_dispatches": after["decode_dispatches"]
                     - before["decode_dispatches"],
                     "ms_per_decode_step": dsec / dsteps * 1e3,
                     "prefills": after["prefills"] - before["prefills"],
                     "prefill_s": after["prefill_s"] - before["prefill_s"],
                     "launches": counts,
                     "greedy_equal_generate_mt4_and_mt1": gen_match}})
    # the 8 greedy requests again, traced: device time against host wall
    emit({"profiled_window": profiled if profiled is not None else "not measured"})
    return counts


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device: chip_smoke.py runs the port on an "
                           "NVIDIA GPU only")
    from mxnet_tpu_torch import _build
    from mxnet_tpu_torch.contrib.quantization import quantize_net
    from mxnet_tpu_torch.models import GPT2_SMALL, GPTModel
    from mxnet_tpu_torch.ops.fused_block_gemv import pack_gpt_block
    torch.backends.cuda.matmul.allow_tf32 = False   # plain/library in full f32
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    per_source = _build.build_all()
    logs = {n: [ln.strip() for ln in (_build.BUILD_DIR / f"{n}.log").read_text()
                .splitlines() if "registers" in ln or "spill" in ln]
            for n in per_source}
    emit({"build_s": time.perf_counter() - t0, "per_source_s": per_source,
          "ptxas": logs})

    net = GPTModel(GPT2_SMALL, device="cuda").init_weights(args.seed)
    quantize_net(net, fused_decode=True)
    cpu_net = GPTModel(GPT2_SMALL, device="cpu").init_weights(args.seed)
    quantize_net(cpu_net, fused_decode=True)

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    timer = Timer(torch)
    k3 = kernel_k3(torch, timer, gen)
    k5 = kernel_k5(torch, timer, gen,
                   pack_gpt_block(net.blocks[0], eps=net.cfg.layer_norm_eps))
    k8 = kernel_k8(torch, timer, gen, net.head_weights())
    emit({"k5": k5, "k8": k8})

    counts = serve(torch, args, net, cpu_net)

    rows = []
    for name, src, replaces, kind, r in (
            ("int8_gemv", "mxnet_tpu_torch/csrc/int8_gemv.cu",
             "mxnet_tpu/ops/int8_gemv.py:113", "gemv", k3),
            ("fused_block_decode", "mxnet_tpu_torch/csrc/fused_block_decode.cu",
             "mxnet_tpu/ops/fused_block_gemv.py:424", "fused_block", k5),
            ("lm_head_sample", "mxnet_tpu_torch/csrc/lm_head_sample.cu",
             "mxnet_tpu/ops/fused_block_gemv.py:1218", "fused_head", k8)):
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": counts.get(kind, 0),
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    emit({"kernels": rows})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
