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
4. Holds K1 (flash-attention forward) and K2 (its backward) against their
   plain versions, every output row to its own size, at the training
   shape and at ragged, end-aligned and padded-head-dim shapes, in bf16
   and f32; shows that three planted faults fail that check; and times
   the kernels beside the plain versions and
   ``scaled_dot_product_attention``.
5. Trains bf16 GPT-2 small (12 layers, D 768, B 16, T 1024, dropout 0,
   Adam at lr 1e-4) through ``TrainStep``: 1 warm-up step, then 10 timed
   steps on one fixed batch, each with 12 K1 and 12 K2 launches; 3 more
   steps under ``torch.profiler`` split the device time by kernel.
6. Trains the same model in f32 at B 2 for 2 SGD steps on the card and on
   the CPU (plain versions) from the same weights and batch, and compares
   losses, each step's gradients leaf by leaf and the parameters after;
   shows that a K2 with outputs 1% too large fails that gradient check; and
   holds the bf16 model's step-1 gradients against the f32 model's.

Informational JSON lines come first; the last line is
``{"ok": true, "device": {...}}``. Any failed check raises and the script
exits non-zero without that line. It needs one CUDA card and refuses to
run without one. It imports neither jax nor the JAX package.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
import warnings

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
F32_FLOP_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
BF16_FLOP_PER_S = 989e12       # H100 SXM bf16 tensor cores, dense
LAYERS = 12
TRAIN_B, TRAIN_T, TRAIN_STEPS, TRAIN_LR = 16, 1024, 10, 1e-4
# card against CPU (f32, SGD with momentum 0.9 at SGD_LR): each step's
# gradients leaf by leaf (relative L2) and the parameters after 2 steps
# (max abs), about 10x the H100's readings (3.1e-6 and 1.19e-7, one ulp
# of a LayerNorm gain); the bf16 model's step-1 gradients against the f32
# model's, about 2x the worst leaf read there (4.5e-2; a K2 whose outputs
# are all 1% too large moves the f32 gradients by 2.6e-2)
SGD_LR = 0.1
CARD_CPU_GRAD_TOL = 3e-5
CARD_CPU_PARAM_TOL = 1e-6
BF16_GRAD_TOL = 0.1


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def emit(obj):
    print(json.dumps(obj), flush=True)


def bound(nbytes, flops, flop_rate=F32_FLOP_PER_S):
    """(bound_ms, bound_by): the larger of the byte time at HBM rate and
    the operation time at ``flop_rate`` (default: the f32 CUDA-core peak,
    for kernels that run f32 FMAs)."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = flops / flop_rate * 1e3
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


def visible_pairs(T, S, causal):
    """(query, key) pairs attention computes: all T*S, or under the
    end-aligned causal mask sum_i min(S, i + S - T + 1)."""
    if not causal:
        return T * S
    return sum(min(S, max(0, i + S - T + 1)) for i in range(T))


# K1/K2 against their plain versions, per storage type: (max abs error
# over max(1, max |plain|), worst row error). A row is one (b, h, query or
# key) vector of o, dq, dk or dv, or one lse entry; see flash_errors. The
# H100 read at most 4.8e-3 in bf16; in f32 5.6e-5, at a causal query 0,
# whose dq is 0 in exact arithmetic and rounding noise in both versions,
# and 1.5e-6 elsewhere.
FLASH_TOL = {"float32": (1e-4, 3e-4), "bfloat16": (2e-2, 1e-2)}
ROW_FLOOR = 0.05
FLASH_TILE = 64


def flash_errors(got, want):
    """(max abs error, max abs error limit scale, worst row error) of
    ``got`` against ``want``. Row error: |got - want|_2 / (|want|_2 +
    ROW_FLOOR * rms), rms the root mean square of the rows' norms, so each
    row is held to its own size (the late rows and keys of a causal shape
    are an order of magnitude smaller than the first ones) and a row near 0
    to a small share of the typical one."""
    want = want.float()
    d = got.float() - want
    if want.dim() == 3:                      # lse (B, H, T): rows are entries
        d, want = d[..., None], want[..., None]
    size = want.norm(dim=-1)
    floor = ROW_FLOOR * size.pow(2).mean().sqrt()
    row = (d.norm(dim=-1) / (size + floor)).max().item()
    return d.abs().max().item(), max(1.0, want.abs().max().item()), row


def flash_within(got, want, dtype_name):
    err, scale, row = flash_errors(got, want)
    abs_tol, row_tol = FLASH_TOL[dtype_name]
    return err <= abs_tol * scale and row <= row_tol


def plain_forward_without(torch, fa, q, k, v, causal, scale, lo, hi):
    """The plain K1 with keys [lo, hi) masked for every query: what a K1
    that skipped that key tile would compute."""
    s, valid = fa._scores(q, k, causal, scale)
    s[..., lo:hi] = torch.finfo(torch.float32).min
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), v)


def planted_faults(torch, fa, f, o, lse, causal, scale, want, dtype):
    """Three kernels with a planted fault, emulated from the plain versions
    on the same inputs and rounded to the storage type: K1 skipping one key
    tile, K2's dk/dv kernel skipping the last query tile, K2 leaving the
    scale out of ds. Each must fail the check; returns, for each, its row
    errors and whether the max-abs limit alone would have caught it."""
    q, k, v, do = f
    T, S = q.shape[2], k.shape[2]
    name = str(dtype).replace("torch.", "")
    lo = (S // 2) // FLASH_TILE * FLASH_TILE
    faults = {"k1_key_tile_skipped": {"o": plain_forward_without(
        torch, fa, q, k, v, causal, scale, lo, lo + FLASH_TILE)}}
    cut = do.clone()
    cut[:, :, (T - 1) // FLASH_TILE * FLASH_TILE:] = 0
    _, fdk, fdv = fa._reference_flash_backward(q, k, v, o.float(), lse, cut, causal, scale)
    faults["k2_last_query_tile_skipped"] = {"dk": fdk, "dv": fdv}
    faults["k2_ds_unscaled"] = {"dq": want["dq"] / scale, "dk": want["dk"] / scale}
    out = {}
    abs_tol = FLASH_TOL[name][0]
    for fault, outs in faults.items():
        rows, caught, by_abs = {}, False, False
        for key, bad in outs.items():
            bad = bad.to(dtype)
            err, size, rows[key] = flash_errors(bad, want[key])
            caught = caught or not flash_within(bad, want[key], name)
            by_abs = by_abs or err > abs_tol * size
        check(caught, f"planted fault {fault} passes the {name} check: {rows}")
        out[fault] = {"row_err": rows, "max_abs_alone_catches": by_abs}
    return out


def flash_case(torch, timer, gen, B, H, T, S, D, causal, dtype, timed, faults=False):
    """K1 and K2 at one shape against their plain versions (run in f32 on
    the same inputs; K2's plain version gets K1's own o and lse, so each
    kernel is held alone). Returns the case row."""
    from mxnet_tpu_torch.ops import attention as fa
    q, do = (torch.randn(B, H, T, D, device="cuda", generator=gen).to(dtype) for _ in range(2))
    k, v = (torch.randn(B, H, S, D, device="cuda", generator=gen).to(dtype) for _ in range(2))
    scale = D ** -0.5
    o, lse = fa.flash_forward(q, k, v, causal, scale)
    dq, dk, dv = fa.flash_backward(q, k, v, o, lse, do, causal, scale)
    torch.cuda.synchronize()
    f = [t.float() for t in (q, k, v, do)]
    po, plse = fa._reference_flash_forward(f[0], f[1], f[2], causal, scale)
    pdq, pdk, pdv = fa._reference_flash_backward(f[0], f[1], f[2], o.float(), lse, f[3],
                                                 causal, scale)
    name = str(dtype).replace("torch.", "")
    abs_tol, row_tol = FLASH_TOL[name]
    want = {"o": po, "lse": plse, "dq": pdq, "dk": pdk, "dv": pdv}
    errs, row_errs = {}, {}
    for key, got in (("o", o), ("lse", lse), ("dq", dq), ("dk", dk), ("dv", dv)):
        where = f"flash {key} at {(B, H, T, S, D, causal, name)}"
        check(bool(torch.isfinite(got).all()), f"{where} not finite")
        err, size, row = flash_errors(got, want[key])
        check(err <= abs_tol * size, f"{where}: max abs err {err} > {abs_tol * size}")
        check(row <= row_tol, f"{where}: row error {row} > {row_tol}")
        errs[key], row_errs[key] = err, row
    row = {"B": B, "H": H, "T": T, "S": S, "D": D, "causal": causal,
           "dtype": name, "max_abs_err": errs, "row_err": row_errs,
           "tol": {"max_abs_over_max_plain": abs_tol, "row": row_tol},
           "k1_max_abs_err": max(errs["o"], errs["lse"]),
           "k2_max_abs_err": max(errs["dq"], errs["dk"], errs["dv"])}
    if faults:
        row["planted_faults_row_err"] = planted_faults(torch, fa, f, o, lse, causal, scale,
                                                       want, dtype)
    del po, plse, pdq, pdk, pdv, f, want
    if not timed:
        return row
    isz = q.element_size()
    pairs = B * H * visible_pairs(T, S, causal)
    rate = F32_FLOP_PER_S if dtype == torch.float32 else BF16_FLOP_PER_S
    qo = B * H * T * D * isz
    kv = B * H * S * D * isz
    row["k1_bound_ms"], row["k1_bound_by"] = bound(2 * qo + 2 * kv + 4 * B * H * T,
                                                   4 * D * pairs, rate)
    row["k2_bound_ms"], row["k2_bound_by"] = bound(4 * qo + 4 * kv + 4 * B * H * T,
                                                   10 * D * pairs, rate)
    row["k1_ms"] = timer(lambda: fa.flash_forward(q, k, v, causal, scale))
    row["k1_plain_ms"] = timer(lambda: fa._reference_flash_forward(q, k, v, causal, scale))
    row["k2_ms"] = timer(lambda: fa.flash_backward(q, k, v, o, lse, do, causal, scale))
    row["k2_plain_ms"] = timer(lambda: fa._reference_flash_backward(q, k, v, o, lse, do,
                                                                    causal, scale))
    row["k1_library_ms"] = row["k2_library_ms"] = None
    if T == S:
        # yardstick only, never called by the port: PyTorch's SDPA, its
        # flash backend in bf16 and its memory-efficient one in f32 (the
        # flash backend takes 16-bit types only)
        from torch.nn.attention import SDPBackend, sdpa_kernel
        sdpa = torch.nn.functional.scaled_dot_product_attention
        backend = (SDPBackend.FLASH_ATTENTION if dtype == torch.bfloat16
                   else SDPBackend.EFFICIENT_ATTENTION)
        row["library"] = f"scaled_dot_product_attention ({backend.name})"
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]

        def fwd():
            with torch.no_grad():
                return sdpa(q, k, v, is_causal=causal, scale=scale)

        def fwd_bwd():
            out = sdpa(*leaves, is_causal=causal, scale=scale)
            out.backward(do)
        try:
            with sdpa_kernel(backend), warnings.catch_warnings():
                warnings.simplefilter("ignore")
                row["k1_library_ms"] = timer(fwd)
                row["k2_library_ms"] = timer(fwd_bwd) - row["k1_library_ms"]
        except RuntimeError as e:
            row["library_error"] = str(e)[:300]
    return row


def kernel_flash(torch, timer, gen):
    """K1/K2 at the training shape (timed) and at the edge shapes."""
    rows = [flash_case(torch, timer, gen, TRAIN_B, 12, TRAIN_T, TRAIN_T, 64, True,
                       torch.bfloat16, timed=True, faults=True),
            flash_case(torch, timer, gen, 2, 12, TRAIN_T, TRAIN_T, 64, True,
                       torch.float32, timed=True)]
    for dtype in (torch.bfloat16, torch.float32):
        for B, H, T, S, D, causal in ((2, 12, 1000, 1000, 64, True),   # ragged
                                      (2, 12, 256, 512, 64, True),     # end-aligned
                                      (2, 12, 1024, 1024, 40, False)):  # padded head dim
            rows.append(flash_case(torch, timer, gen, B, H, T, S, D, causal, dtype,
                                   timed=False))
    emit({"flash_cases": rows})
    main = rows[0]
    err1 = max(r["k1_max_abs_err"] for r in rows)
    err2 = max(r["k2_max_abs_err"] for r in rows)
    k1 = {"max_abs_err": err1, "ms": main["k1_ms"], "plain_ms": main["k1_plain_ms"],
          "bound_ms": main["k1_bound_ms"], "bound_by": main["k1_bound_by"],
          "library_ms": main["k1_library_ms"]}
    k2 = {"max_abs_err": err2, "ms": main["k2_ms"], "plain_ms": main["k2_plain_ms"],
          "bound_ms": main["k2_bound_ms"], "bound_by": main["k2_bound_by"],
          "library_ms": main["k2_library_ms"]}
    return k1, k2


def train_batch(args, vocab, B, T):
    import numpy as np
    rng = np.random.RandomState(args.seed)
    ids = rng.randint(0, vocab, (B, T)).astype(np.int32)
    labels = rng.randint(0, vocab, (B, T)).astype(np.int32)
    return ids, labels


def gpt2_train_config(dtype):
    from mxnet_tpu_torch.models import GPTConfig
    return GPTConfig(dropout=0.0, dtype=dtype)


def sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def train_profile(torch, step, ids, labels, device, steps=3):
    """``steps`` training steps under ``torch.profiler`` (device activity
    only): device busy time against host wall time, and device time by
    kernel (flash_fwd, flash_bwd, GEMM, other)."""
    from mxnet_tpu_torch import _build
    from torch.profiler import ProfilerActivity, profile
    path = _build.BUILD_DIR.parent / "profile" / "train_trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    sync(torch, device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(ids, labels)
        sync(torch, device)
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") in
                   ("kernel", "gpu_memcpy", "gpu_memset"))
    if not spans:
        return None
    busy, end = 0.0, float("-inf")
    for a, b, _ in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    by_kernel, by_name = {}, {}
    for a, b, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e3
        low = name.lower()
        if "flash_fwd_" in name:
            key = "flash_fwd"
        elif "flash_dkdv_" in name or "flash_dq_" in name:
            key = "flash_bwd"
        elif any(w in low for w in ("gemm", "nvjet", "cutlass", "xmma", "cublas")):
            key = "gemm"
        else:
            key = "other"
        by_kernel[key] = by_kernel.get(key, 0.0) + (b - a) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"steps": steps, "wall_ms": wall * 1e3, "device_busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / 1e3 / (wall * 1e3), "kernel_ms": by_kernel,
            "device_ops": len(spans),
            "top_kernels_ms": [[name[:120], ms] for name, ms in top]}


def train(torch, args, device="cuda"):
    """The training main path: bf16 GPT-2 small through ``TrainStep``
    (``device='cpu'`` rehearses it with the plain versions)."""
    from mxnet_tpu_torch import optimizer, parallel
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models import GPTModel
    from mxnet_tpu_torch.ops.int8_gemv import launches, reset_launches
    cfg = gpt2_train_config(torch.bfloat16)
    B, T = TRAIN_B, TRAIN_T
    net = GPTModel(cfg, device=device).init_weights(args.seed)
    ids, labels = train_batch(args, cfg.vocab_size, B, T)
    ids, labels = torch.from_numpy(ids).to(device), torch.from_numpy(labels).to(device)
    step = parallel.TrainStep(net, SoftmaxCrossEntropyLoss(),
                              optimizer.Adam(learning_rate=TRAIN_LR), example_inputs=[ids])
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first = step(ids, labels).float().item()           # warm-up step
    warm_s = time.perf_counter() - t0
    reset_launches()
    sync(torch, device)
    t0 = time.perf_counter()
    losses = [step(ids, labels) for _ in range(TRAIN_STEPS)]
    sync(torch, device)
    dt = time.perf_counter() - t0
    counts = launches()
    losses = [first] + [x.float().item() for x in losses]
    check(all(math.isfinite(x) for x in losses), f"non-finite training loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    for kind in ("flash_fwd", "flash_bwd"):
        check(counts.get(kind, 0) == LAYERS * TRAIN_STEPS,
              f"{kind} launches {counts.get(kind)} != {LAYERS} x {TRAIN_STEPS} steps")
    L, D, V = cfg.num_layers, cfg.hidden_size, cfg.vocab_size
    analytic = 3 * (L * (24 * B * T * D * D + 2 * B * T * T * D) + 2 * B * T * D * V)
    ms = dt / TRAIN_STEPS * 1e3
    profiled = train_profile(torch, step, ids, labels, device) if on_card else None
    emit({"train": {"model": "gpt2-small", "dtype": "bfloat16", "B": B, "T": T,
                    "optimizer": "adam", "lr": TRAIN_LR, "steps": TRAIN_STEPS,
                    "warmup_s": warm_s, "ms_per_step": ms,
                    "tokens_per_s": B * T * TRAIN_STEPS / dt,
                    "mfu_analytic": analytic / (dt / TRAIN_STEPS) / BF16_FLOP_PER_S,
                    "losses": losses, "launches": counts,
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9
                    if on_card else None}})
    emit({"train_profiled_window": profiled if profiled is not None else "not measured"})
    return counts


def named_grads(torch, net):
    """{name: f32 CPU copy of the gradient} of ``net``'s parameters."""
    return {n: p.grad.detach().float().cpu() for n, p in net.named_parameters()}


def leaf_errors(got, want):
    """{name: |got - want|_2 / |want|_2}, leaf by leaf."""
    return {n: float((got[n] - w).norm() / w.norm().clamp_min(1e-30)) for n, w in want.items()}


def worst(errs):
    name = max(errs, key=errs.get)
    return {"leaf": name, "rel_l2": errs[name]}


def sgd_steps(torch, args, device, dtype, steps, B, T):
    """``steps`` f32/bf16 GPT-2-small TrainSteps with SGD (momentum 0.9)
    from ``--seed``: (losses, gradients of each step, parameters after)."""
    from mxnet_tpu_torch import optimizer, parallel
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.interop import params_to_numpy
    from mxnet_tpu_torch.models import GPTModel
    cfg = gpt2_train_config(dtype)
    net = GPTModel(cfg, device=device).init_weights(args.seed)
    ids, labels = train_batch(args, cfg.vocab_size, B, T)
    step = parallel.TrainStep(net, SoftmaxCrossEntropyLoss(),
                              optimizer.SGD(learning_rate=SGD_LR, momentum=0.9),
                              example_inputs=[ids])
    losses, grads = [], []
    for _ in range(steps):
        losses.append(step(ids, labels).float().item())
        grads.append(named_grads(torch, net))   # a step leaves its gradients set
    return losses, grads, params_to_numpy(net)


def train_card_vs_cpu(torch, args, card="cuda"):
    """f32 GPT-2 small at B 2: 2 TrainSteps with SGD (momentum 0.9) on the
    card (kernels) and on the CPU (plain versions) from the same weights
    and batch, compared on losses, each step's gradients leaf by leaf and
    the parameters after; a K2 whose outputs are 1% too large must fail
    the gradient check. Then the bf16 and f32 models' step-1 gradients on
    the card, leaf by leaf. Prints the readings, then checks them."""
    from mxnet_tpu_torch.ops import attention as fa
    B, T, steps = 2, TRAIN_T, 2
    out, runs = {}, {}
    for dev in (card, "cpu"):
        t0 = time.perf_counter()
        runs[dev] = sgd_steps(torch, args, dev, torch.float32, steps, B, T)
        out[f"{dev}_s"] = time.perf_counter() - t0
    (lc, gc, pc), (lh, gh, ph) = runs[card], runs["cpu"]
    grad_errs = [worst(leaf_errors(a, b)) for a, b in zip(gc, gh)]
    pdiff = max(float(abs(pc[n] - ph[n]).max()) for n in ph)

    real = fa.flash_backward

    def too_large(*a):
        return tuple(t * 1.01 for t in real(*a))
    fa.flash_backward = too_large
    try:
        _, (fault,), _ = sgd_steps(torch, args, card, torch.float32, 1, B, T)
    finally:
        fa.flash_backward = real
    fault_err = worst(leaf_errors(fault, gh[0]))

    (l16,), (g16,), _ = sgd_steps(torch, args, card, torch.bfloat16, 1, B, T)
    bf16_err = leaf_errors(g16, gc[0])
    out.update({"B": B, "T": T, "steps": steps, "optimizer": "sgd", "lr": SGD_LR,
                "momentum": 0.9, "losses": {card: lc, "cpu": lh},
                "grad_rel_l2_worst_leaf": grad_errs, "grad_tol": CARD_CPU_GRAD_TOL,
                "max_param_diff": pdiff, "param_tol": CARD_CPU_PARAM_TOL,
                "planted_k2_1pct_grad_rel_l2": fault_err,
                "step1_loss_by_dtype": {"float32": lc[0], "bfloat16": l16},
                "bf16_vs_f32_grad_rel_l2": worst(bf16_err), "bf16_grad_tol": BF16_GRAD_TOL,
                "bf16_vs_f32_grad_rel_l2_median": statistics.median(bf16_err.values())})
    emit({"train_card_vs_cpu": out})
    for a, b in zip(lc, lh):
        check(abs(a - b) <= 1e-4 * abs(b), f"card/CPU f32 losses {lc} {lh}")
    for i, e in enumerate(grad_errs):
        check(e["rel_l2"] <= CARD_CPU_GRAD_TOL,
              f"card/CPU f32 step-{i + 1} gradients differ: {e} > {CARD_CPU_GRAD_TOL}")
    check(pdiff <= CARD_CPU_PARAM_TOL,
          f"card/CPU parameters after {steps} steps differ by {pdiff} > {CARD_CPU_PARAM_TOL}")
    check(fault_err["rel_l2"] > CARD_CPU_GRAD_TOL,
          f"a K2 with outputs 1% too large passes the card/CPU gradient check: {fault_err}")
    check(abs(l16 - lc[0]) <= 2e-2 * abs(lc[0]), f"bf16/f32 step-1 losses {l16} {lc[0]}")
    check(max(bf16_err.values()) <= BF16_GRAD_TOL,
          f"bf16/f32 step-1 gradients differ: {worst(bf16_err)} > {BF16_GRAD_TOL}")


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

    with torch.no_grad():
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

    serve_counts = serve(torch, args, net, cpu_net)
    del net, cpu_net
    torch.cuda.empty_cache()

    k1, k2 = kernel_flash(torch, timer, gen)
    torch.cuda.empty_cache()
    train_counts = train(torch, args)
    torch.cuda.empty_cache()
    train_card_vs_cpu(torch, args)

    rows = []
    for name, src, replaces, kind, counts, r in (
            ("int8_gemv", "mxnet_tpu_torch/csrc/int8_gemv.cu",
             "mxnet_tpu/ops/int8_gemv.py:113", "gemv", serve_counts, k3),
            ("fused_block_decode", "mxnet_tpu_torch/csrc/fused_block_decode.cu",
             "mxnet_tpu/ops/fused_block_gemv.py:424", "fused_block", serve_counts, k5),
            ("lm_head_sample", "mxnet_tpu_torch/csrc/lm_head_sample.cu",
             "mxnet_tpu/ops/fused_block_gemv.py:1218", "fused_head", serve_counts, k8),
            ("flash_attention_fwd", "mxnet_tpu_torch/csrc/flash_attention_fwd.cu",
             "mxnet_tpu/ops/attention.py:286", "flash_fwd", train_counts, k1),
            ("flash_attention_bwd", "mxnet_tpu_torch/csrc/flash_attention_bwd.cu",
             "mxnet_tpu/ops/attention.py:383", "flash_bwd", train_counts, k2)):
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
