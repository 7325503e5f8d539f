#!/usr/bin/env python3
"""Run the PyTorch / H100 port once on the card, end to end.

    python3 chip_smoke.py [--seed N]

1. Builds the hand-written CUDA kernels from ``mxnet_tpu_torch/csrc``.
2. Holds each kernel of the int8 serving paths (K3 int8 GEMV, K5 one-launch block
   decode, K8 fused LM-head sampler, K6 and K7 one-launch paged block
   decode, gathered and streamed) against its plain PyTorch version at
   GPT-2-small shapes and times kernel, plain version and a library
   yardstick with CUDA events (L2 flushed before every timed launch). K3
   (and K4 below) run at 1, 8, 9, 16 and 64 rows: the warp route up to 8
   rows, the tensor-core tile route above, whose rows must give the same
   bits at 9, 16 and 64 rows and on a second launch; the warp route is also
   held at every M from 1 to 8 (each row the same bits as in the 8-row call
   and on a second launch, bf16 x the f32 lane on x.float()), and its tied
   head (50304 x 768) at 1 and 8 rows is reported on its own. K8's
   grammar-mask and bf16 lanes (no JAX path reaches them: driven by direct
   calls) are held against the plain version and the head GEMV + argmax. K6
   and K7 run on scattered block tables of a 600-page pool; K7's copies
   started and waited are held against the ``record_dma`` ledger, and K5, K6
   and K7 must give one input the same bits.
2b. Draws JAX's sampling stream on the card (``_prng`` threefry bits, a
   split-chain ``categorical`` and keyed ``sample_tokens`` with greedy,
   plain, top-k and top-p rows over GPT-2's vocab) and on the same inputs
   on the CPU: the bits and the tokens must be equal.
3. Serves 12 concurrent requests with a contiguous ``InferenceEngine``
   over int8 GPT-2 small (12 layers, D 768, vocab 50257, random weights
   from ``--seed``) and checks the tokens against ``generate()`` on the
   card and against the plain path on the CPU, and that every kernel of
   the path launched (each GEMV route, warp and tile, counted by
   ``gemv_routes()`` over the serving phases). The 8 greedy requests are
   then served once more under ``torch.profiler`` to split the window into
   device time per kernel and idle time. Two top-k/top-p requests follow,
   twice with the same seeds: their tokens must repeat. The same 12
   requests then go through a ``multi_token=1`` engine (the engine's
   default): every substep's head and every token 0 on K3's warp route at
   B <= 8, greedy tokens equal to the multi_token=4 engine's and
   ``generate()``'s, sampled ones repeating per seed, and a traced window
   beside the K=4 one.
3b. Serves the same model from the paged KV pool
   (``InferenceEngine(paged=True)``): phase A, 16 requests sharing a
   system prompt on a 128-page pool at max_len 256, every decode substep
   through K6, with prefix hits and copy-on-write forks; phase B, 8
   requests of 300-700-token prompts at max_len 1024 on a pool small
   enough to preempt, every decode substep through K7. Greedy tokens are
   held against the engine's arithmetic on the contiguous layout and
   against ``generate()``; sampled ones (and phase A's two top-k/top-p
   requests) repeat per seed; the page ledger drains to zero.
3c. Serves int4 weight-only GPT-2 small (``quantize_net(bits=4,
   fused_decode=True)``, the same weights): K4 (int4 GEMV) and the int4
   weight lanes of K5, K6, K7 and K8 against their plain versions (K4 +
   argmax equal to K8's greedy rows, K5/K6/K7 the same bits), then the
   contiguous phase's 12 requests (held against ``generate()`` and, over
   32 tokens of two requests, the CPU), paged phase A (K6) and phase C (4
   requests of 300-700-token prompts at max_len 1024 without preemption,
   K7), with int4 launch kinds only; prints the weight bytes of both
   models and each int4 phase's peak device memory.
3d. Serves bf16 GPT-2 small, the configuration of ``bench.py``'s quantized
   decode headlines: int8 with ``calib_mode='naive'`` on two seeded [8, 32]
   batches, then int4. The bf16 lanes of K3, K4 (bf16 x: bit for bit the
   f32 lane on x.float(), on both routes) and of K5, K6, K7 (bf16 x and
   bf16 caches and pools, also f32 x; K5 = K6 = K7 bitwise) against their
   plain versions; ``generate()`` at B 8, P 32, 128 new tokens,
   ``multi_token=8``; the contiguous phase, its multi_token=1 engine, paged
   A (K6) and paged B (K7, preemption) over the int8 model, ``generate()``
   and the contiguous phase over the int4 one, with each element-type lane's launches
   (``dtype_lanes()``) and the KV bytes beside the f32 phases'.
3e. Every engine phase above calls ``warmup()`` after ``start()``: each
   decode step of its bucket ladder (batch bucket x substeps x sampling
   branch) and each paged prefill chunk bucket is captured as a CUDA graph,
   and serving, with decode lookahead on (the default), replays them; the
   phase fails if it captures anything after its warm-up. Each phase's
   gates hold under replay (launch counts are added per replay). After the
   phase one decode step per layout (and, paged, the full and the final
   chunk bucket) is replayed and run eagerly from the same random inputs
   and pool state: outputs, last tokens and whole pools must be equal bit
   for bit. The contiguous window and paged phase B are then served in
   three modes (eager dispatch, captured, captured with lookahead): ms per
   substep, tokens/s over 3 trials and the idle share of each; the
   contiguous window's tokens must be equal in all three.
3f. ``constrained_spec``: grammar-constrained and self-speculative
   serving of the f32 int8 model, ``bench.py``'s grammar and speculation
   duels over GPT-2's vocab (8 structured prompts, one in flight, a paged
   ``speculate=4`` engine): the pass-through grammar ``.*`` must give the
   free engine's tokens with an acceptance no lower, every completion
   under a JSON schema must replay through the automaton, ``speculate=4``
   greedy tokens must equal ``speculate=0``'s (K6) or diverge where the
   CPU twin's top-2 gap is below ``gap_limit``, and a contiguous grammar
   engine's free rows (K5, K=1) must equal a plain engine's; a grammar
   step and a verify step replay their eager runs bit for bit. Prints
   tokens/s per sweep, ``cost_pct``, ``speedup``, acceptance, the compile
   seconds at vocab 50257 and the idle share of a profiled sweep.
3g. ``http_serve``: the HTTP frontend (``serve.HTTPFrontend`` on 127.0.0.1,
   port 0) over the same f32 int8 model. (a) A paged fused engine
   (``max_batch_size=8, max_len=256, multi_token=4``: K6 and K8), after
   ``warmup()`` and ``warmup_score()``, takes 8 greedy prompts of 8-48
   tokens and 2 sampled ones from 8 client threads: tokens equal to the
   same engine's in-process ``generate()``, SSE streams equal to the JSON
   replies frame for frame, nothing captured; requests/s and tokens/s
   through HTTP against in-process (median [min, max] of 3 trials) and
   the idle share of a profiled HTTP window. (b) ``/score`` of 4
   sequences of 5-64 tokens: bit for bit the eager scores on the card,
   within 1e-3 of the CPU twin's, ``logprob`` their sum, K3 on both
   routes, the same bits when posted during (a)'s decode; ms per score
   bucket. (c) ``/metrics``: requests, tokens and each built step's
   launch sites; ``/healthz`` 200 with models ``{"default": 0}``. (d) An
   unfused int8 engine (``multi_token=1``) deploys net B's published
   weights by ``POST /weights`` while a request decodes: the request
   completes, later tokens equal a fresh engine on net B, nothing is
   captured, ``/healthz`` shows version 1, the swap's apply time; a swap
   on (a)'s fused engine raises the JAX refusal. (e) ``POST /drain``:
   ``/healthz`` 503 and draining, new requests 503, in-flight ones ok.
4. Holds K1 (flash-attention forward) and K2 (its backward) against their
   plain versions, every output row to its own size, at the training
   shape, at head dim 128 and at ragged, end-aligned and padded-head-dim
   shapes, in bf16 and f32; requires K2 to give the same bits on a second
   run at every shape; shows that three planted faults fail that check;
   and times the kernels beside the plain versions and
   ``scaled_dot_product_attention``.
5. Trains bf16 GPT-2 small (12 layers, D 768, B 16, T 1024) through
   ``TrainStep`` at ``GPTConfig()``'s dropout 0.1 (25 sites, masks from
   the counter-hash stream under step t's ``KeySupply(key(t))``), Adam at
   lr 1e-4 on a cosine schedule with linear warmup: 1 warm-up step, then
   10 timed steps on one fixed batch, each with 12 K1 and 12 K2 launches;
   3 more steps under ``torch.profiler`` split the device time by kernel,
   and one more attributes the dropout sites' device time (mask and
   scale, and their backward). Then the same at dropout 0 and a constant
   lr 1e-4.
6. Trains the same model in f32 at B 2 for 2 SGD steps on the card and on
   the CPU (plain versions) from the same weights, batch and step keys,
   at dropout 0.1 and at 0, and compares losses, each step's gradients
   leaf by leaf and the parameters after; shows that a K2 with outputs 1%
   too large, and at dropout 0.1 a key stream that hands site k the key of
   site k + 1, fail that gradient check; requires one site's keep mask
   (and the keep bits past 2**31, with and without the high word) to be
   the same bits on the card and the CPU; and holds the bf16 model's
   step-1 gradients against the f32 model's.
7. Resumes bf16 GPT-2 small at dropout 0.1 from checkpoints on the card:
   ``TrainStep`` with an asynchronous sharded ``CheckpointManager`` save,
   and the eager ``Trainer`` path through the local layout; the resumed
   steps' losses, parameters and optimizer states must be the same bits
   as the first run's. Prints the checkpoint bytes, the training thread's
   stall in ``save``, the background write's and the restore's seconds.
8. ``gluon_substrate``: (a) the README's first program at its own widths
   (``HybridSequential(Dense(128, relu), Dense(10))`` on 784-wide inputs,
   B 128, Xavier, softmax cross-entropy, Adam 1e-3, 20 steps) eagerly and
   hybridized with ``static_alloc=True`` on the card: losses and
   parameters the same bits; the same program on the CPU port from the
   same weights within 1e-5 relative; a hybridized predict call after
   warm-up adds no cache entry, counts a cache hit and replays its CUDA
   graph, with the eager call's bits. (b) A user ``HybridBlock`` at GPT-2
   small's width (LayerNorm, Dense 3x768, ``mx.ops.attention`` causal with
   12 heads of 64, Dense 768, residual) at B 4, T 1024 inside
   ``autograd.record()`` then ``backward()``, in f32 and bf16: K1 and K2
   launch from the tape, gradients within K1/K2's gates of the same block
   with the plain attention called directly (in bf16 the parameters'
   gradients; the input's passes the bf16 LayerNorm backward, which alone
   puts it about 0.17 in row error from f32 with either attention, so it
   is reported), and the f32 gradients at B 1 within 1e-4 of the CPU
   port's. Records ms per step of (a) eager and
   hybridized, predict ms eager and replayed, (b)'s forward + backward ms
   and K1/K2's share of its device time.

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
PROFILE_STEPS = 3
# GPTConfig()'s dropout: the training headline's
DEFAULT_DROPOUT = 0.1
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
# phase B's pool: about half of what its 8 requests need together (about
# 300 pages), so requests must be preempted
PAGED_B_PAGES = 160
# the int4 contiguous phase holds the first INT4_CPU_TOKENS tokens of two
# requests against the plain path on the CPU, which dequantizes every int4
# table on every call (about 0.3 s a token at GPT-2 small)
INT4_CPU_TOKENS = 32
# the bf16 stage's CPU comparisons (its int4 model's plain path is the
# slow one above)
BF16_CPU_TOKENS, BF16_INT4_CPU_TOKENS = 32, 16
# bench.py's calibration for its int8 decode headlines: calib_mode 'naive'
# on two batches of [8, 32] tokens
CALIB_BATCHES, CALIB_SHAPE = 2, (8, 32)
# clock cycles the card spins before each timed call (about 0.5 ms at the
# H100's 1.98 GHz): the host enqueues the call while the card is busy, so
# host time (a Python wrapper, a contended CPU) stays outside the events
TIMER_COVER_CYCLES = 1_000_000


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
    so the real caller finds it cold) and the card held busy for
    TIMER_COVER_CYCLES while the host enqueues the call."""

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
            torch.cuda._sleep(TIMER_COVER_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


GEMV_ROWS = (1, 8, 9, 16, 64)
# one block's four GEMVs (qkv, out, fc, proj) and the tied head
GEMV_SHAPES = ((2304, 768), (768, 768), (3072, 768), (768, 3072), (50304, 768))


def dequant(torch, w_q, w_scale):
    """The f32 weight a quantized table stands for (int8 or int4 lane)."""
    from mxnet_tpu_torch.ops.int8_gemv import dequantize_int4_table
    if w_q.dtype != torch.uint8:
        return w_q.float() * w_scale[:, None]
    return dequantize_int4_table(w_q, w_scale)


def table_bytes(*tables):
    return sum(t.numel() * t.element_size() for t in tables)


def kernel_gemv(torch, timer, gen, bits, bf16=False):
    """K3 (``bits`` 8) or K4 (4) at every (N, K) the serving path gives it,
    at each row count of GEMV_ROWS: the warp route at 1 and 8 rows, the tile
    route at 9, 16 and 64. Every call within 1e-4 x max(1, |plain|); the
    first 9 rows of the tile route give the same bits at M 9, 16 and 64,
    and two launches at 64 rows the same bits. ``bf16``: the bf16 x lane
    (block 0 of a bf16 model), which must also give the f32 lane's result
    on x.float() bit for bit on both routes; its library yardstick is
    ``torch.matmul`` of bf16 x on the dequantized bf16 weight. The bound of
    every call is the larger of its bytes and its operations at the bf16
    tensor rate, whichever route runs it. Returns {"warp": one layer's four
    GEMVs at 8 rows, summed, "mma": the same at 64 rows, with the 16-row
    sums under "m16"; the 1-row sums under "m1" of "warp"}."""
    from mxnet_tpu_torch.contrib.quantization import _quantize_int4
    from mxnet_tpu_torch.ops import int8_gemv
    name = ("K3" if bits == 8 else "K4") + ("_bf16" if bf16 else "")
    xsize = 2 if bf16 else 4
    fn = int8_gemv.int8_weight_matmul if bits == 8 else int8_gemv.int4_weight_matmul
    plain = int8_gemv._reference_int8_matmul if bits == 8 else int8_gemv._reference_int4_matmul
    rows, same_bits = [], []
    for N, K in GEMV_SHAPES:
        x64 = torch.randn(max(GEMV_ROWS), K, device="cuda", generator=gen)
        if bf16:
            x64 = x64.bfloat16()
        if bits == 8:
            w = torch.randint(-127, 128, (N, K), device="cuda", generator=gen, dtype=torch.int8)
            s = torch.rand(N, device="cuda", generator=gen) * 0.02 + 1e-3
        else:
            w, s = _quantize_int4(torch.randn(N, K, device="cuda", generator=gen))
        wdeq = dequant(torch, w, s)
        if bf16:
            wdeq = wdeq.bfloat16()
        outs = {}
        for M in GEMV_ROWS:
            x = x64[:M].contiguous()
            got = fn(x, w, s)
            want = plain(x, w, s)
            if bf16:
                wide = fn(x.float(), w, s)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            tol = 1e-4 * max(1.0, want.abs().max().item())
            check(err <= tol, f"{name} M={M} N={N} K={K}: max abs err {err} > {tol}")
            if bf16:
                check(torch.equal(got.view(torch.int32), wide.view(torch.int32)),
                      f"{name} M={M} N={N} K={K}: the bf16 lane is not the f32 lane on "
                      f"x.float() bit for bit (max abs {(got - wide).abs().max().item()})")
            outs[M] = got
            # the products, and for int4 one block-scale multiply per partial sum
            b_ms, b_by = bound(xsize * M * K + table_bytes(w, s) + 4 * M * N,
                               2 * M * N * K + (M * s.numel() if bits == 4 else 0),
                               BF16_FLOP_PER_S)
            rows.append({
                "M": M, "N": N, "K": K, "route": int8_gemv.gemv_route(M),
                "max_abs_err": err, "tol": tol,
                "ms": timer(lambda: fn(x, w, s)),
                "plain_ms": timer(lambda: plain(x, w, s)),
                "library_ms": timer(lambda: torch.matmul(x, wdeq.T)),
                "bound_ms": b_ms, "bound_by": b_by,
                "bytes": xsize * M * K + table_bytes(w, s) + 4 * M * N})
        tile = [M for M in GEMV_ROWS if int8_gemv.gemv_route(M) == "mma"]
        lo = min(tile)
        again = fn(x64, w, s)
        torch.cuda.synchronize()
        row = {"N": N, "K": K,
               "rows_equal_across_M": all(torch.equal(outs[M][:lo], outs[lo]) for M in tile),
               "repeat_equal": torch.equal(again, outs[max(tile)])}
        check(row["rows_equal_across_M"] and row["repeat_equal"],
              f"{name} tile route N={N} K={K}: bits differ across M {tile} or launches: {row}")
        row["warp_max_abs_err"] = warp_rows(torch, name, fn, plain, x64, w, s, outs[8], bf16)
        same_bits.append(row)
    emit({name.lower() + "_shapes": rows, name.lower() + "_tile_same_bits": same_bits})

    def layer_sums(M):
        # the serving path's work: one layer's four block GEMVs at M rows
        layer = [r for r in rows if r["M"] == M and r["N"] != 50304]
        out = {k: sum(r[k] for r in layer) for k in ("ms", "plain_ms", "library_ms")}
        out["bound_ms"], out["bound_by"] = bound(
            sum(r["bytes"] for r in layer),
            sum(2 * M * r["N"] * r["K"] + (M * r["N"] * r["K"] // 128 if bits == 4 else 0)
                for r in layer), BF16_FLOP_PER_S)
        return out

    warp = layer_sums(8)
    warp["max_abs_err"] = max(max(r["max_abs_err"] for r in rows if r["route"] == "warp"),
                              max(r["warp_max_abs_err"] for r in same_bits))
    warp["m1"] = layer_sums(1)
    mma = layer_sums(64)
    mma["max_abs_err"] = max(r["max_abs_err"] for r in rows if r["route"] == "mma")
    mma["m16"] = layer_sums(16)
    # the tied head on the warp route (token 0, and every decode substep of a
    # multi_token=1 engine)
    head = {f"m{M}": next(r for r in rows if r["N"] == 50304 and r["M"] == M) for M in (1, 8)}
    head["max_abs_err"] = max(head["m1"]["max_abs_err"], head["m8"]["max_abs_err"],
                              next(r["warp_max_abs_err"] for r in same_bits if r["N"] == 50304))
    return {"warp": warp, "mma": mma, "head": head}


def warp_rows(torch, name, fn, plain, x64, w, s, full, bf16):
    """The warp route at every decode row count M = 1..8: within 1e-4 x
    max(1, |plain|), row r the same bits as in the 8-row call ``full`` and
    on a second launch, and (``bf16``) the f32 lane's bits on x.float().
    Returns the largest error."""
    N, K = w.shape[0], x64.shape[1]
    worst = 0.0
    for M in range(1, 9):
        x = x64[:M].contiguous()
        got, again, want = fn(x, w, s), fn(x, w, s), plain(x, w, s)
        wide = fn(x.float(), w, s) if bf16 else got
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        tol = 1e-4 * max(1.0, want.abs().max().item())
        check(err <= tol, f"{name} warp route M={M} N={N} K={K}: max abs err {err} > {tol}")
        check(torch.equal(got.view(torch.int32), full[:M].view(torch.int32))
              and torch.equal(got.view(torch.int32), again.view(torch.int32)),
              f"{name} warp route N={N} K={K}: rows at M={M} differ from the 8-row call's "
              "or from a second launch")
        check(torch.equal(got.view(torch.int32), wide.view(torch.int32)),
              f"{name} warp route M={M} N={N} K={K}: the bf16 lane is not the f32 lane on "
              "x.float() bit for bit")
        worst = max(worst, err)
    return worst


def pack_bytes(pack):
    """Bytes of a block pack's weights, scales, biases and LayerNorms."""
    D = pack["ln1"][0].shape[0]
    return sum(table_bytes(*pack[k]) for k in ("qkv", "out", "fc", "proj")) + 4 * 4 * D


def pack_ops(pack, B):
    """Operations of a block step's four GEMVs at B rows: the products, and
    for an int4 pack one block-scale multiply per partial sum."""
    D = pack["ln1"][0].shape[0]
    scales = sum(pack[k][1].numel() for k in ("qkv", "out", "fc", "proj"))
    return 2 * B * 12 * D * D + (B * scales if pack["blocks"] else 0)


# bf16 lanes of K5-K7 against their plain versions: the output within one
# bf16 rounding of its scale (a LayerNorm value of a bf16 row one ulp apart,
# its statistics summed in another order, moves the output by about that),
# and written bf16 cache rows within one bf16 ulp of the plain version's
BF16_ROUND = 2.0 ** -8


def bf16_ulp(torch, t):
    """One bf16 ulp of each value of ``t`` (2**-7 of its binade)."""
    a = t.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def hold_block(torch, name, out, plain, news, refs, olds, written, compared=None):
    """A block kernel's step against its plain version: cache or pool rows
    outside ``written`` bitwise unchanged in both; the output and the
    ``compared`` rows (default: the written ones) within 1e-4 x max(1,
    |plain|) for f32 caches (f32 sums in another order). For bf16 caches
    the output within BF16_ROUND x max(1, |plain|), and each compared row,
    the f32 value of the kernel or the plain version rounded once to bf16,
    within that f32 rule plus one bf16 ulp of the plain row (two values
    that close round to neighbouring bf16 values at most). Returns (max
    abs error, output tolerance)."""
    compared = written if compared is None else compared
    bf16 = news[0].dtype == torch.bfloat16
    for new, ref, old in zip(news, refs, olds):
        check(torch.equal(new[~written], old[~written])
              and torch.equal(ref[~written], old[~written]),
              f"{name} touched cache rows other than the new rows")
    f32_tol = 1e-4 * max(1.0, plain.abs().max().item())
    tol = BF16_ROUND * max(1.0, plain.abs().max().item()) if bf16 else f32_tol
    out_err = (out - plain).abs().max().item()
    check(out_err <= tol, f"{name}: output max abs err {out_err} > {tol}")
    row_err = 0.0
    for new, ref in zip(news, refs):
        d = (new[compared].float() - ref[compared].float()).abs()
        row_err = max(row_err, d.max().item())
        lim = f32_tol + (bf16_ulp(torch, ref[compared]) if bf16 else 0.0)
        check(bool((d <= lim).all()),
              f"{name}: written rows differ from the plain ones by {row_err}")
    return max(out_err, row_err), tol


def kernel_k5(torch, timer, gen, pack, bf16=False):
    """K5 at B=8, D=768, H=12, L=1024 with mixed per-row positions. ``bf16``:
    bf16 caches, timed at bf16 x (block 0 of a bf16 model) and also checked
    at f32 x (every later block)."""
    from mxnet_tpu_torch.ops import fused_block_gemv as fb
    B, D, H, L = 8, 768, 12, 1024
    hd = D // H
    dt = torch.bfloat16 if bf16 else torch.float32
    name = "K5" + ("_bf16" if bf16 else "")
    pos = torch.tensor([1000, 3, 517, 64, 999, 250, 0, 777], dtype=torch.int32,
                       device="cuda")
    x = torch.randn(B, 1, D, device="cuda", generator=gen).to(dt)
    kc = (torch.randn(B, H, L, hd, device="cuda", generator=gen) * 0.1).to(dt)
    vc = (torch.randn(B, H, L, hd, device="cuda", generator=gen) * 0.1).to(dt)
    written = torch.zeros(B, H, L, dtype=torch.bool, device="cuda")
    written[torch.arange(B, device="cuda"), :, pos.long()] = True
    err, tol = 0.0, 0.0
    for xin in ((x, x.float()) if bf16 else (x,)):
        k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        out, _, _ = fb.fused_block_decode(xin, pos, k1, v1, pack)
        plain, _, _ = fb._reference_block_decode(xin, pos, k2, v2, pack)
        torch.cuda.synchronize()
        e, tol = hold_block(torch, f"{name} (x {xin.dtype})", out, plain, (k1, v1), (k2, v2),
                            (kc, vc), written)
        err = max(err, e)
    attended = int((pos.long() + 1).sum().item()) * H
    isz = 2 if bf16 else 4
    nbytes = (pack_bytes(pack)                             # weights, scales, biases, LN
              + isz * B * D + 4 * B * D + 4 * B            # x, out, pos
              + attended * hd * isz * 2                    # K/V rows read
              + B * H * hd * isz * 2)                      # new rows written
    flops = pack_ops(pack, B) + attended * hd * 4
    b_ms, b_by = bound(nbytes, flops)
    # every row at position 64, the smoke traffic's range: the step is
    # then almost all weight GEMVs, which splits K5's time into its phases
    pos64 = torch.full((B,), 64, dtype=torch.int32, device="cuda")
    return {"max_abs_err": err, "tol": tol,
            "ms_pos64": timer(lambda: fb.fused_block_decode(x, pos64, k1, v1, pack)),
            "ms": timer(lambda: fb.fused_block_decode(x, pos, k1, v1, pack)),
            "plain_ms": timer(lambda: fb._reference_block_decode(x, pos, k2, v2, pack)),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "shape": {"B": B, "D": D, "H": H, "L": L, "pos": pos.tolist(),
                      "x": str(x.dtype), "cache": str(kc.dtype)}}


def paged_inputs(torch, gen, D, H, B, ps, maxp, pool, pos, dtype=None):
    """Seeded paged decode inputs on the card: x, positions, block tables
    over a ``pool``-page pool + sink with scattered pages (each active row
    leases the pages that cover its position; rows 0 and 1 share their
    first two pages, below both positions; the last row is inactive: table
    all sink, position 0) and N(0, 0.1) pools; x and the pools in
    ``dtype`` (default f32)."""
    hd = D // H
    cpu = torch.Generator().manual_seed(int(gen.initial_seed()))
    perm = torch.randperm(pool, generator=cpu).tolist()
    table = torch.full((B, maxp), pool, dtype=torch.int32)
    for b in range(B - 1):
        need = min(pos[b], ps * maxp - 1) // ps + 1
        for i in range(need):
            table[b, i] = table[0, i] if b == 1 and i < 2 else perm.pop()
    assert pos[B - 1] == 0 and min(pos[0], pos[1]) >= 2 * ps
    dev = gen.device
    dt = torch.float32 if dtype is None else dtype
    x = torch.randn(B, 1, D, device=dev, generator=gen).to(dt)
    kp = (torch.randn(pool + 1, H, ps, hd, device=dev, generator=gen) * 0.1).to(dt)
    vp = (torch.randn(pool + 1, H, ps, hd, device=dev, generator=gen) * 0.1).to(dt)
    posv = torch.tensor(pos, dtype=torch.int32, device=dev)
    return x, posv, table.to(dev), kp, vp


def paged_written(torch, posv, table, pool, ps):
    """[pool + 1, ps] bool: the (page, row) each row's new K/V lands in,
    plus the whole sink page (written by inactive rows, never compared)."""
    L = table.shape[1] * ps
    mask = torch.zeros(pool + 1, ps, dtype=torch.bool, device=posv.device)
    for b, p in enumerate(posv.tolist()):
        if p < L:
            mask[table[b, p // ps], p % ps] = True
    mask[pool] = True
    return mask


def check_paged(torch, fb, name, inputs, pack, streamed, pool, ps):
    """Run K6 or K7 and its plain version on copies of ``inputs``: every
    pool entry outside the written rows and the sink page bitwise
    unchanged in both, written rows and the output by ``hold_block``'s rule
    for the pools' dtype. K7 also counts its copies into device counters,
    which must equal each other and the ``record_dma`` ledger. Returns the
    row."""
    from mxnet_tpu_torch.ops.int8_gemv import dma_ledger, launches, reset_launches
    x, posv, table, kp, vp = inputs
    k1, v1, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    counters = torch.zeros(2, dtype=torch.int32, device=x.device)
    reset_launches()
    out, _, _ = fb.fused_block_decode_paged(x, posv, table, k1, v1, pack,
                                            dma_counters=counters)
    kind = launches()
    ledger = dma_ledger()
    plain, _, _ = fb._reference_block_decode_paged(x, posv, table, k2, v2, pack)
    sync(torch, x.device)
    want = ("fused_block_paged_dma" if streamed else "fused_block_paged") + fb._kind_suffix(pack)
    check(kind == {want: 1}, f"{name}: routed to {kind}, expected {want}")
    written = paged_written(torch, posv, table, pool, ps)[:, None, :].expand(-1, kp.shape[1], -1)
    nonsink = written.clone()
    nonsink[pool] = False
    err, tol = hold_block(torch, name, out, plain, (k1, v1), (k2, v2), (kp, vp), written,
                          nonsink)
    row = {"max_abs_err": err, "tol": tol}
    H, hd = kp.shape[1], kp.shape[3]
    L = table.shape[1] * ps
    pages = sum(min(p, L - 1) // ps + 1 for p in posv.tolist())
    if streamed:
        # the plain version on the CPU counts no copies of its own
        got = counters.tolist() if x.is_cuda else [ledger["copies"]] * 2
        check(got[0] == got[1] == ledger["copies"] == ledger["waits"] == 2 * H * pages
              and ledger["bytes"] == ledger["copies"] * ps * hd * kp.element_size(),
              f"{name}: copies started/waited {got}, ledger {ledger}, "
              f"expected {2 * H * pages}")
        row["copies_started_waited"] = got
        row["dma_ledger"] = ledger
    else:
        check(counters.tolist() == [0, 0] and ledger["copies"] == 0,
              f"{name}: K6 recorded copies {ledger}")
    return row


def paged_bound(x, posv, table, kp, ps, pack):
    """(bound_ms, bound_by) of one paged block step: weights, scales,
    biases, LN, x, out, positions and table, the attended K/V rows, the new
    rows."""
    B, _, D = x.shape
    H, hd = kp.shape[1], kp.shape[3]
    L = table.shape[1] * ps
    isz = kp.element_size()
    attended = sum(min(p, L - 1) + 1 for p in posv.tolist()) * H
    nbytes = (pack_bytes(pack) + x.element_size() * B * D + 4 * B * D + 4 * B
              + 4 * table.numel() + attended * hd * isz * 2 + B * H * hd * isz * 2)
    return bound(nbytes, pack_ops(pack, B) + attended * hd * 4)


def kernel_k6_k7(torch, timer, gen, pack, pool=600, ps=16, dtype=None):
    """K6 at B 16, L 256 and K7 at B 8, L 1024, each against its plain
    version; K7 at L 256 against K6 (and K6 against K5 on the gathered
    contiguous view): same bits. K6 is also timed at B 8 (``ms_b8``: its
    first 7 positions and an inactive row). ``dtype`` bf16: x and pools
    bf16 (block 0 of a bf16 model), also checked at f32 x (its later
    blocks)."""
    from mxnet_tpu_torch.ops import fused_block_gemv as fb
    D, H = pack["ln1"][0].shape[0], pack["heads"]
    rng = __import__("numpy").random.RandomState(int(gen.initial_seed()) + 6)
    pos6 = [200, 255, 33] + rng.randint(0, 256, 12).tolist() + [0]
    pos7 = [1023, 517, 64, 999, 250, 777, 3, 0]
    out = {}
    for name, B, maxp, pos, streamed in (("K6", 16, 16, pos6, False),
                                         ("K7", 8, 64, pos7, True)):
        inputs = paged_inputs(torch, gen, D, H, B, ps, maxp, pool, pos, dtype)
        row = check_paged(torch, fb, name, inputs, pack, streamed, pool, ps)
        if dtype is not None and dtype != torch.float32:
            wide = (inputs[0].float(),) + inputs[1:]
            e = check_paged(torch, fb, name + " (x f32)", wide, pack, streamed, pool, ps)
            row["max_abs_err"] = max(row["max_abs_err"], e["max_abs_err"])
        x, posv, table, kp, vp = inputs
        row["bound_ms"], row["bound_by"] = paged_bound(x, posv, table, kp, ps, pack)
        row["ms"] = timer(lambda: fb.fused_block_decode_paged(x, posv, table, kp, vp, pack))
        k2, v2 = kp.clone(), vp.clone()
        row["plain_ms"] = timer(lambda: fb._reference_block_decode_paged(x, posv, table, k2,
                                                                         v2, pack))
        row["library_ms"] = None
        row["shape"] = {"B": B, "D": D, "H": H, "ps": ps, "L": maxp * ps,
                        "pool_pages": pool, "pos": pos}
        if name == "K6":
            # beside B 16: the first 7 rows and the inactive one, one row tile
            x8, p8, t8, kp8, vp8 = paged_inputs(torch, gen, D, H, 8, ps, maxp, pool,
                                                pos[:7] + [0], dtype)
            row["ms_b8"] = timer(lambda: fb.fused_block_decode_paged(x8, p8, t8, kp8, vp8,
                                                                     pack))
            row["bound_ms_b8"] = paged_bound(x8, p8, t8, kp8, ps, pack)[0]
        out[name] = row
    out["K7_vs_K6_L256"] = same_bits_k5_k6_k7(torch, fb, gen, pack, pool, ps, pos6,
                                              dtype=dtype)
    return out


def same_bits_k5_k6_k7(torch, fb, gen, pack, pool, ps, pos, maxp=16, dtype=None):
    """K6 and K7 on one input at L 256 give the same output and pools bit
    for bit, and K5 on the gathered contiguous view gives K6's output (x
    and pools in ``dtype``, default f32)."""
    D, H = pack["ln1"][0].shape[0], pack["heads"]
    x, posv, table, kp, vp = paged_inputs(torch, gen, D, H, len(pos), ps, maxp, pool, pos,
                                          dtype)
    B = len(pos)
    view = [p[table.long()].transpose(1, 2).reshape(B, H, maxp * ps, -1).contiguous()
            for p in (kp, vp)]
    k6, v6, k7, v7 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    # the kernels called directly: at L 256 both gates accept, routing takes K6
    o6, _, _ = fb._cuda_block_decode_paged(x, posv, table, k6, v6, pack, False, None)
    o7, _, _ = fb._cuda_block_decode_paged(x, posv, table, k7, v7, pack, True, None)
    o5, _, _ = fb.fused_block_decode(x, posv, view[0], view[1], pack)
    torch.cuda.synchronize()
    row = {"k7_equal_k6": bool(torch.equal(o6, o7) and torch.equal(k6, k7)
                               and torch.equal(v6, v7)),
           "k6_equal_k5": bool(torch.equal(o5, o6)),
           "max_abs_k7_k6": (o7 - o6).abs().max().item(),
           "max_abs_k6_k5": (o6 - o5).abs().max().item()}
    check(row["k7_equal_k6"] and row["k6_equal_k5"], f"K5/K6/K7 bits differ: {row}")
    return row


def kernel_k8(torch, timer, gen, head):
    """K8 at B=8 over the padded GPT-2 table (int8, or the int4 lane for a
    uint8 table), 4 greedy and 4 T=0.8 rows; then all 8 rows greedy against
    the argmax of the head GEMV (K3 or K4), bit for bit; and at B=16 (paged
    A's batch: two row tiles), [B, 2] keys, against the plain version. Times
    the warp-route head GEMV + ``argmax`` beside it (``warp_head_argmax_ms``:
    the selection K8 fuses, in two launches)."""
    import numpy as np

    from mxnet_tpu_torch.models.generation import _key_bits
    from mxnet_tpu_torch.ops import fused_block_gemv as fb
    from mxnet_tpu_torch.ops import int8_gemv
    w_q, scale, vocab = head
    int4 = w_q.dtype == torch.uint8
    B, D = 8, w_q.shape[1] * (2 if int4 else 1)
    Vp = w_q.shape[0]
    h = torch.randn(B, D, device="cuda", generator=gen)
    temps = torch.tensor([0.0] * 4 + [0.8] * 4, device="cuda")
    kb = torch.from_numpy(_key_bits(np.arange(B) + 100, np.arange(B))).cuda()
    got = fb.fused_lm_head_sample(h, w_q, scale, vocab, kb, temps)
    plain = fb._reference_head_sample(h, w_q, scale, vocab, temps, kb)
    greedy = fb.fused_lm_head_sample(h, w_q, scale, vocab, kb, torch.zeros(B, device="cuda"))
    argmax = int8_gemv.weight_matmul(h, w_q, scale)[:, :vocab].argmax(-1)
    torch.cuda.synchronize()
    check(torch.equal(got, plain), f"K8 tokens {got.tolist()} != {plain.tolist()}")
    check(torch.equal(greedy.long(), argmax),
          f"K8 greedy {greedy.tolist()} != head GEMV + argmax {argmax.tolist()}")
    h16 = torch.randn(16, D, device="cuda", generator=gen)
    keys16 = torch.from_numpy(np.stack(
        [np.arange(16) * 7919 + 1, _key_bits(np.arange(16) + 300, np.arange(16))], -1)).cuda()
    temps16 = torch.tensor([0.0, 0.8] * 8, device="cuda")
    got16 = fb.fused_lm_head_sample(h16, w_q, scale, vocab, keys16, temps16)
    plain16 = fb._reference_head_sample(h16, w_q, scale, vocab, temps16,
                                        keys16[:, 0] ^ keys16[:, 1])
    torch.cuda.synchronize()
    check(torch.equal(got16, plain16), f"K8 at 16 rows: tokens {got16.tolist()} != plain "
          f"{plain16.tolist()}")
    wdeq = dequant(torch, w_q, scale)
    b_ms, b_by = bound(table_bytes(w_q, scale) + 4 * B * D + 12 * B,
                       2 * B * Vp * D + (B * scale.numel() if int4 else 0))
    return {"max_abs_err": 0.0, "tokens": got.tolist(), "greedy_equal_gemv_argmax": True,
            "ms": timer(lambda: fb.fused_lm_head_sample(h, w_q, scale, vocab, kb, temps)),
            "plain_ms": timer(lambda: fb._reference_head_sample(h, w_q, scale, vocab,
                                                                temps, kb)),
            "library_ms": timer(lambda: torch.argmax(torch.matmul(h, wdeq.T), -1)),
            "warp_head_argmax_ms": timer(lambda: torch.argmax(
                int8_gemv.weight_matmul(h, w_q, scale)[:, :vocab], -1)),
            "bound_ms": b_ms, "bound_by": b_by}


# direct calls of K8's mask and bf16 lanes in their launch-counting phase
K8_LANE_CALLS = 16


def kernel_k8_lanes(torch, timer, gen, head):
    """K8's grammar-mask lane (f32 h) and bf16 lane (bf16 h, logits rounded
    through bf16) at B=8 over the padded GPT-2 table, 4 greedy and 4 T=0.8
    rows. No path of the JAX package hands K8 a mask or bf16 h, so the lanes
    are driven by K8_LANE_CALLS direct calls each, counted from 0 (the
    rows' launches). Then, outside the count: tokens equal the plain
    version's; masked tokens are allowed lanes and greedy ones the masked
    head GEMV + argmax; bf16 h gives h.float()'s tokens and greedy rows the
    argmax of the head GEMV's logits rounded to bf16; all bit for bit.
    Library yardsticks: ``matmul`` + masked ``argmax``; bf16 ``matmul`` +
    ``argmax``. Returns {"mask": row, "bf16": row}."""
    import numpy as np

    from mxnet_tpu_torch.models.generation import _key_bits
    from mxnet_tpu_torch.ops import fused_block_gemv as fb
    from mxnet_tpu_torch.ops import int8_gemv
    w_q, scale, vocab = head
    int4 = w_q.dtype == torch.uint8
    sfx = "_int4" if int4 else ""
    B, D = 8, w_q.shape[1] * (2 if int4 else 1)
    Vp = w_q.shape[0]
    bf16 = torch.bfloat16
    h = torch.randn(B, D, device="cuda", generator=gen)
    hb = h.to(bf16)
    temps = torch.tensor([0.0] * 4 + [0.8] * 4, device="cuda")
    zeros = torch.zeros(B, device="cuda")
    kb = torch.from_numpy(_key_bits(np.arange(B) + 200, np.arange(B))).cuda()
    masks = [torch.rand(B, vocab, device="cuda", generator=gen) < 0.3
             for _ in range(K8_LANE_CALLS)]
    int8_gemv.reset_launches()
    for m in masks:
        fb.fused_lm_head_sample(h, w_q, scale, vocab, kb, temps, mask=m)
    for _ in range(K8_LANE_CALLS):
        fb.fused_lm_head_sample(hb, w_q, scale, vocab, kb, temps, out_dtype=bf16)
    torch.cuda.synchronize()
    lanes = int8_gemv.dtype_lanes()
    n_mask = lanes.get(f"fused_head{sfx}:h_f32:mask", 0)
    n_bf16 = lanes.get(f"fused_head{sfx}:h_bf16:bf16_logits", 0)

    mask = masks[0]
    mask_p = torch.zeros(B, Vp, dtype=torch.bool, device="cuda")
    mask_p[:, :vocab] = mask
    got = fb.fused_lm_head_sample(h, w_q, scale, vocab, kb, temps, mask=mask)
    plain = fb._reference_head_sample(h, w_q, scale, vocab, temps, kb, mask=mask_p)
    greedy = fb.fused_lm_head_sample(h, w_q, scale, vocab, kb, zeros, mask=mask)
    logits = int8_gemv.weight_matmul(h, w_q, scale)[:, :vocab]
    masked_argmax = logits.masked_fill(~mask, float("-inf")).argmax(-1)
    gb = fb.fused_lm_head_sample(hb, w_q, scale, vocab, kb, temps, out_dtype=bf16)
    gw = fb.fused_lm_head_sample(hb.float(), w_q, scale, vocab, kb, temps, out_dtype=bf16)
    pb = fb._reference_head_sample(hb.float(), w_q, scale, vocab, temps, kb, out_dtype=bf16)
    greedy_b = fb.fused_lm_head_sample(hb, w_q, scale, vocab, kb, zeros, out_dtype=bf16)
    argmax_b = int8_gemv.weight_matmul(hb, w_q, scale)[:, :vocab].to(bf16).float().argmax(-1)
    torch.cuda.synchronize()
    check(torch.equal(got, plain), f"K8{sfx} mask lane: tokens {got.tolist()} != plain "
          f"{plain.tolist()}")
    check(bool(mask.gather(1, got.long()[:, None]).all())
          and bool(mask.gather(1, greedy.long()[:, None]).all()),
          f"K8{sfx} mask lane: a token on a forbidden lane")
    check(torch.equal(greedy.long(), masked_argmax),
          f"K8{sfx} mask lane: greedy {greedy.tolist()} != masked head GEMV + argmax "
          f"{masked_argmax.tolist()}")
    check(torch.equal(gb, pb) and torch.equal(gb, gw),
          f"K8{sfx} bf16 lane: tokens {gb.tolist()}, on h.float() {gw.tolist()}, plain "
          f"{pb.tolist()}")
    check(torch.equal(greedy_b.long(), argmax_b),
          f"K8{sfx} bf16 lane: greedy {greedy_b.tolist()} != head GEMV + bf16 + argmax "
          f"{argmax_b.tolist()}")
    wdeq = dequant(torch, w_q, scale)
    wdeq_b = wdeq.to(bf16)
    ops = 2 * B * Vp * D + (B * scale.numel() if int4 else 0)
    ninf = torch.tensor(float("-inf"), device="cuda")
    rows = {}
    for lane_name, n, xsize, extra, fn, plain_fn, lib in (
            ("mask", n_mask, 4, B * Vp,
             lambda: fb.fused_lm_head_sample(h, w_q, scale, vocab, kb, temps, mask=mask),
             lambda: fb._reference_head_sample(h, w_q, scale, vocab, temps, kb, mask=mask_p),
             lambda: torch.argmax(torch.where(mask, torch.matmul(h, wdeq.T)[:, :vocab], ninf),
                                  -1)),
            ("bf16", n_bf16, 2, 0,
             lambda: fb.fused_lm_head_sample(hb, w_q, scale, vocab, kb, temps, out_dtype=bf16),
             lambda: fb._reference_head_sample(hb.float(), w_q, scale, vocab, temps, kb,
                                               out_dtype=bf16),
             lambda: torch.argmax(torch.matmul(hb, wdeq_b.T), -1))):
        b_ms, b_by = bound(table_bytes(w_q, scale) + xsize * B * D + extra + 12 * B, ops)
        rows[lane_name] = {"launches": n, "max_abs_err": 0.0, "tokens_equal_plain": True,
                           "ms": timer(fn), "plain_ms": timer(plain_fn),
                           "library_ms": timer(lib), "bound_ms": b_ms, "bound_by": b_by}
    return rows


def nucleus_away_from_edges(np, logits, temps, topks, rows):
    """top_p per row: 1 outside ``rows``; in them halfway between two
    exclusive prefix sums (1e-4 or more apart) of the row's sorted,
    temperature-scaled, top-k-filtered probabilities, so that no cumsum
    rounding of either device moves the nucleus cut."""
    topps = np.ones(len(temps), np.float32)
    for b in rows:
        z = np.sort(logits[b].astype(np.float64) / (temps[b] if temps[b] > 0 else 1.0))[::-1]
        z = z[:topks[b]] if topks[b] > 0 else z
        pr = np.exp(z - z.max())
        excl = np.concatenate([[0.0], np.cumsum(pr / pr.sum())[:-1]])
        wide = [j for j in range(len(excl) - 1) if excl[j + 1] - excl[j] > 1e-4]
        j = wide[len(wide) // 2]
        topps[b] = (excl[j] + excl[j + 1]) / 2
    return topps


def sampling_card(torch, args, timer):
    """JAX's sampling stream on the card: ``_prng`` bits, a split-chain
    ``categorical`` and keyed ``sample_tokens`` (greedy, plain, top-k and
    top-p rows over GPT-2's vocab) on device logits, against the same calls
    on their CPU copies: bits equal, tokens equal."""
    import numpy as np

    from mxnet_tpu_torch import _prng
    from mxnet_tpu_torch.models.generation import sample_tokens
    rng = np.random.RandomState(args.seed + 7)
    B, V = 8, 50257
    logits = (rng.randn(B, V) * 3).astype(np.float32)
    temps = np.array([0.0, 0.8, 1.0, 0.7, 1.3, 0.0, 0.9, 1.1], np.float32)
    topks = np.array([0, 0, 40, 0, 200, 5, 0, 1000])
    topps = nucleus_away_from_edges(np, logits, temps, topks, (3, 4, 7))
    seeds, counters = np.arange(B) * 7919 + args.seed, np.arange(B) * 3
    kc = _prng.fold_keys(seeds, counters)
    kd = _prng.fold_keys(seeds, counters, "cuda")
    bits_equal = bool(torch.equal(_prng.random_bits(kd, (V,)).cpu(), _prng.random_bits(kc, (V,))))
    check(bits_equal, "threefry bits on the card differ from the CPU's")
    lc, ld = torch.from_numpy(logits), torch.from_numpy(logits).cuda()
    want = sample_tokens(lc, kc, temps, topks, topps)
    got = sample_tokens(ld, kd, temps, topks, topps).cpu()
    check(torch.equal(got, want), f"sample_tokens on the card {got.tolist()} != CPU "
          f"{want.tolist()}")
    key = _prng.split(_prng.key(args.seed))[1]
    one_c = _prng.categorical(key, lc)
    one_d = _prng.categorical(key.cuda(), ld).cpu()
    check(torch.equal(one_c, one_d), "split-chain categorical on the card differs from the CPU's")
    return {"B": B, "V": V, "bits_equal": bits_equal, "tokens": got.tolist(),
            "tokens_equal_cpu": True, "split_chain_equal_cpu": True,
            "sample_tokens_ms": timer(lambda: sample_tokens(ld, kd, temps, topks, topps))}


def first_divergence(a, b):
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None


def top2_gap(torch, net, tokens):
    """(top-1 minus top-2 logit, top-1 logit) of ``net`` after ``tokens``
    (plain path)."""
    ids = torch.tensor([tokens], dtype=torch.int32, device=net.device)
    caches = net.new_caches(1, len(tokens))
    with torch.no_grad():
        logits = net.forward_cached(ids, 0, *caches)[0][0, -1]
    top = torch.topk(logits.float(), 2).values
    return (top[0] - top[1]).item(), top[0].item()


def gap_limit(torch, net, top):
    """The top-2 gap below which the card and the CPU may pick different
    greedy tokens: 1e-3 for f32 models; for bf16 ones also two bf16
    roundings of the top logit (the kernels' bf16 LayerNorm of block 0
    sums its statistics in another order than the CPU, which can move a
    normalised value by one bf16 ulp)."""
    if net.cfg.dtype == torch.bfloat16:
        return max(1e-3, 2 * BF16_ROUND * abs(top))
    return 1e-3


# a chrome trace's categories of device work
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def device_spans(prof, trace=None):
    """The device's kernel, copy and memset intervals of a finished
    ``torch.profiler`` run (CUDA activity only, so every device event is
    one of them), sorted, as (start us, end us, name), read from the
    profiler's own events: a chrome trace of a paged window holds 300k
    device spans, which cost seconds to write and parse. With ``trace`` (a
    file name under build/profile/) the chrome trace is also written, and
    its DEVICE_CATEGORIES events must give the same names and the same
    busy time."""
    from torch._C._autograd import DeviceType
    ns = [(e.start_ns(), e.duration_ns(), e.name()) for e in prof.profiler.kineto_results.events()
          if e.device_type() == DeviceType.CUDA]
    t0 = min((a for a, _, _ in ns), default=0)      # us since the first, in float64
    spans = sorted(((a - t0) / 1e3, (a - t0 + d) / 1e3, name) for a, d, name in ns)
    if trace is not None:
        from mxnet_tpu_torch import _build
        path = _build.BUILD_DIR.parent / "profile" / trace
        path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
        traced = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES)
        check(sorted(n for _, _, n in traced) == sorted(n for _, _, n in spans)
              and abs(busy_us(traced) - busy_us(spans)) <= 1e-3 * (len(spans) + 1),
              f"profiler events ({len(spans)} device spans, {busy_us(spans)} us busy) "
              f"differ from the chrome trace ({len(traced)}, {busy_us(traced)} us)")
    return spans


def busy_us(spans):
    """The union of sorted device intervals, in us."""
    busy, end = 0.0, float("-inf")
    for a, b, _ in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def device_share(torch, eng, prompts, new, trace=None, run=None):
    """Serve ``prompts`` (greedy; or call ``run()``, which serves them its
    own way and returns their results) once more under ``torch.profiler`` and
    split the window's host wall time into device kernel time per kernel
    and idle time. Returns None where the trace holds no device kernel.
    The trace must hold one span per launch of a block kernel (K5/K6/K7)
    and of K8 that the window counted (``launches()``, which counts every
    graph replay's launches): where it holds fewer, the profiler dropped
    kernels (as it may inside replayed CUDA graphs), and the window's idle
    share is reported as not measured. ``trace``: see device_spans;
    ``trace_s`` is the time taken to read the spans."""
    from mxnet_tpu_torch.ops.int8_gemv import launches
    from torch.profiler import ProfilerActivity, profile
    before = eng.stats()
    counted0 = launches()
    # device activity only: recording every host op would stretch the
    # host-bound window that is being measured
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if run is None:
            handles = [eng.submit(p, new) for p in prompts]
            results = [h.result(timeout=600) for h in handles]
        else:
            results = run()
        wall = time.perf_counter() - t0
    after = eng.stats()
    counted = {k: n - counted0.get(k, 0) for k, n in launches().items()}
    for i, r in enumerate(results):
        check(r.ok, f"profiled request {i}: {r.status} {r.error}")
    t_trace = time.perf_counter()
    spans = device_spans(prof, trace)
    if not spans:
        return None
    busy = busy_us(spans)
    by_kernel = {}
    for a, b, name in spans:
        key = next((k for k in ("fused_block_decode_paged_dma", "fused_block_decode_paged",
                                "fused_block_decode", "head_kernel",
                                "int8_gemv_mma", "int4_gemv_mma", "int8_gemv", "int4_gemv")
                    if k in name), "other")
        by_kernel[key] = by_kernel.get(key, 0.0) + (b - a) / 1e3
    substeps = after["decode_substeps"] - before["decode_substeps"]
    launched = sum(n for k, n in counted.items() if k.startswith(("fused_block", "fused_head")))
    traced = sum(1 for _, _, name in spans if "fused_block_decode" in name or "head_kernel" in name)
    out = {"wall_ms": wall * 1e3, "device_busy_ms": busy / 1e3,
           "idle_share": 1.0 - busy / 1e3 / (wall * 1e3),
           "kernel_ms": by_kernel, "device_ops": len(spans),
           "decode_substeps": substeps, "block_and_head_launches": launched,
           "block_and_head_spans": traced,
           "ms_per_decode_step": (after["decode_s"] - before["decode_s"])
           / substeps * 1e3, "trace_s": time.perf_counter() - t_trace}
    if traced < launched:
        out.update(idle_share="not measured: the trace dropped kernels",
                   device_busy_ms="not measured")
    return out


def warm(eng):
    """``eng.warmup()``: every decode step (batch bucket x substeps x
    branch) and every paged prefill chunk of the ladder captured as a CUDA
    graph. Returns what the phase must leave unchanged, with the warm-up's
    seconds."""
    eng.warmup()
    st = eng.stats()
    built = st["compiled_buckets"]["decode"] or st["compiled_buckets"].get("spec")
    check(st["captures"] > 0 and built, f"warmup captured nothing: {st['compiled_buckets']}")
    return {"captures": st["captures"], "compiled_buckets": st["compiled_buckets"],
            "last_warmup_s": st["last_warmup_s"]}


def no_capture_since(eng, warmed, what):
    """Fail if the engine captured anything after its warm-up (the port's
    zero-recompile contract)."""
    st = eng.stats()
    check(st["captures"] == warmed["captures"]
          and st["compiled_buckets"] == warmed["compiled_buckets"],
          f"{what}: captured after warmup ({warmed['captures']} -> {st['captures']} "
          f"captures)")


def replay_equals_eager(torch, eng, gen, seed, sb=None, steps=None, branch=None, pb=None,
                        verify=False):
    """A captured step replayed against its function run eagerly, from the
    same inputs and the same pool (cache) state, both on the card: a
    decode step of bucket ``sb`` (``steps`` substeps, ``branch``), with
    ``pb`` the paged prefill chunk of that bucket, or with ``verify`` the
    speculative verify step of bucket ``sb`` and ``branch``. Inputs and the
    pools are random (rows on distinct pages, as the page ledger leases
    them; half the rows at T 0.8); a grammar engine's tables hold a real
    automaton and its rows random states of it. The replay's output, the
    last tokens (and automaton states) a decode step writes back into its
    inputs and the whole pools must equal the eager run's bit for bit.
    Returns the compared counts."""
    import numpy as np

    from mxnet_tpu_torch import _prng
    from mxnet_tpu_torch.serve.grammar import compile_grammar
    rng = np.random.RandomState(seed)
    K, vocab, paged = eng.K, eng._vocab, eng._paged
    span = pb or (eng.spec if verify else K)
    if pb:
        step, io = eng._get_chunk(pb), eng._chunk_io
    elif verify:
        step, io = eng._get_spec(sb, branch), eng._spec_io[sb]
    else:
        step, io = eng._get_step(sb, steps, branch), eng._io[sb]
    check(step.graph is not None, "replay_equals_eager: the step was not captured")
    if eng._grammar:
        g = compile_grammar(r"[a-z]{1,3}(?: [a-z]{1,3}){0,3}\.", vocab)
        eng._gcls[:], eng._gnxt[:], eng._gacc[:] = g.padded_tables(eng._gmax, eng._gmax)
        eng._gdirty = True
        eng._sync_gtab()
    h = io.host()
    h_rows = 1 if pb else sb
    if paged:
        ps = eng.page_size
        per_row = eng._pages.num_pages // h_rows
        top = per_row * ps - span
        pos = rng.randint(0, max(1, min(top, eng.L - span)), h_rows)
        pages = rng.permutation(eng._pages.num_pages)
        h["table"][:] = eng._pages.sink
        used = 0
        for r in range(h_rows):
            n = (int(pos[r]) + span - 1) // ps + 1
            h["table"][r, :n] = pages[used:used + n]
            used += n
    else:
        pos = rng.randint(0, eng.L - span, h_rows)
    if pb:
        h["ids"][:] = 0
        h["ids"][:pb] = rng.randint(0, vocab, pb)
        h["pos"][0] = pos[0]
    else:
        h["inputs" if verify else "tokens"][:] = rng.randint(0, vocab, (sb, span) if verify
                                                             else sb)
        h["pos"][:] = pos
        h["temps"][:] = np.where(np.arange(sb) % 2, 0.8, 0.0)
        h["topks"][:] = 40 if branch.startswith("filtered") else 0
        h["topps"][:] = 1.0
        if eng._grammar:
            states = rng.randint(0, g.n_states, (sb, span) if verify else sb)
            h["gstates" if verify else "gstate"][:] = states
            h["eos"][:] = 0
        keys = _prng.step_keys(rng.randint(0, 2**32, sb), rng.randint(0, 1000, sb), span)
        if verify:
            h["keys"][:] = keys.transpose(1, 0, 2)
        else:
            h["eos"][:] = 0 if eng._grammar else -1
            h["rem"][:] = K
            h["keys"][:] = keys
    io.upload(0, io.nbytes)
    with torch.no_grad():
        for pool in eng._pools:
            pool.copy_(torch.randn(pool.shape, generator=gen, device=pool.device))
        pools0 = [pool.clone() for pool in eng._pools]
        inputs0 = io.dev.clone()
        out_r = step().clone()
        inputs_r = io.dev.clone()
        pools_r = [pool.clone() for pool in eng._pools]
        for pool, p0 in zip(eng._pools, pools0):
            pool.copy_(p0)
        io.dev.copy_(inputs0)
        out_e = step.fn()
        torch.cuda.synchronize()
        same_out = torch.equal(out_r, out_e)
        # a decode step writes its last tokens (and automaton states) back
        same_last = torch.equal(inputs_r, io.dev)
        same_pools = all(torch.equal(a, b) for a, b in zip(pools_r, eng._pools))
        written = sum(int(not torch.equal(a, b)) for a, b in zip(pools_r, pools0))
    what = (f"chunk bucket {pb}" if pb else f"verify bucket {sb} ({branch})" if verify
            else f"decode bucket {sb} ({steps} substeps, {branch})")
    check(same_out and same_last and same_pools,
          f"{what}: replay != eager (output {same_out}, inputs written back {same_last}, "
          f"pools {same_pools})")
    check(written == len(eng._pools), f"{what}: {written} of {len(eng._pools)} pools written")
    return {"step": what, "pools_written": written, "equal": True,
            "grammar": eng._grammar}


# the engine phases' top-k / top-p requests: (temperature, top_k, top_p)
FILTERED = ((0.9, 40, 1.0), (0.7, 0, 0.9))


def filtered_requests(eng, prompts, vocab, new, seed):
    """Two top-k/top-p requests, submitted together and then once more with
    the same seeds: every decode batch they share takes ``sample_tokens`` on
    the head GEMV's logits. Their tokens must lie in the vocab and repeat."""
    runs = []
    for _ in range(2):
        hs = [eng.submit(prompts[i], new, temperature=t, top_k=k, top_p=p, seed=seed + i)
              for i, (t, k, p) in enumerate(FILTERED)]
        runs.append([h.result(timeout=600) for h in hs])
    for i, (a, b) in enumerate(zip(*runs)):
        check(a.ok and b.ok and len(a.generated_ids) == new,
              f"filtered request {i}: {a.status} {b.status} {a.error} {b.error}")
        check(all(0 <= t < vocab for t in a.generated_ids),
              f"filtered request {i}: token outside vocab")
        check(a.generated_ids == b.generated_ids, f"filtered request {i}: same seed, "
              "another sample")
    return {"requests": [list(r) for r in FILTERED], "new_tokens_each": new,
            "repeat_on_resubmit": True}


def lane(torch, net):
    """(tag, kinds, forbidden) of a quantized model: the tag of its lines
    ("", "int4_", "bf16_", "bf16_int4_"), the launch kinds its GEMV, block
    kernels and head record, and the int8 kinds that an int4 model must
    never record."""
    int4 = net.blocks[0].attn_qkv.w_q.dtype == torch.uint8
    bf16 = "bf16_" if net.cfg.dtype == torch.bfloat16 else ""
    sfx = "_int4" if int4 else ""
    kinds = {"gemv": "gemv" + sfx, "block": "fused_block" + sfx,
             "paged": "fused_block_paged" + sfx, "dma": "fused_block_paged_dma" + sfx,
             "head": "fused_head" + sfx}
    int8_kinds = ("gemv", "fused_block", "fused_block_paged", "fused_block_paged_dma",
                  "fused_head")
    return bf16 + ("int4_" if int4 else ""), kinds, (int8_kinds if int4 else ())


def serve(torch, args, net, cpu_net, cpu_tokens=64):
    """The contiguous serving phase: 12 requests (8 greedy, 4 at T 0.8, 64
    new tokens each) through ``InferenceEngine(max_batch_size=8, max_len=512,
    multi_token=4, paged=False)``, held against ``generate()`` on the card
    and, over the first ``cpu_tokens`` tokens of two requests, against the
    plain path on the CPU. A bf16 model's greedy request 7 is cut to 5
    tokens, so that one prefill takes the warp route with bf16 rows.
    Returns the launch counts of the window, with the requests' tokens and
    the generate() references under "k4" (for serve_k1)."""
    from mxnet_tpu_torch.models import generate
    from mxnet_tpu_torch.ops.int8_gemv import (dtype_lanes, gemv_routes, gemv_widths,
                                               launches, reset_launches)
    from mxnet_tpu_torch.serve import InferenceEngine
    tag, kinds, forbidden = lane(torch, net)
    vocab = net.cfg.vocab_size
    prompts, temps, new = contiguous_requests(torch, args, net)
    eng = InferenceEngine(net, max_batch_size=8, max_len=512, multi_token=4,
                          fused=True, paged=False).start()
    try:
        warmed = warm(eng)
        first = eng.generate(prompts[0][:8], 8, timeout=600)
        check(first.ok, f"warm-up request failed: {first.error}")
        before = eng.stats()
        reset_launches()
        t0 = time.perf_counter()
        handles = [eng.submit(p, new, temperature=t, seed=1000 + i)
                   for i, (p, t) in enumerate(zip(prompts, temps))]
        results = [h.result(timeout=600) for h in handles]
        wall = time.perf_counter() - t0
        counts = launches()
        counts["routes"] = gemv_routes()
        counts["widths"] = gemv_widths()
        counts["lanes"] = dtype_lanes()
        after = eng.stats()
        counts["kv_bytes"] = after["kv_bytes"]
        again = [eng.submit(prompts[i], new, temperature=0.8, seed=1000 + i)
                 for i in range(8, 12)]
        again = [h.result(timeout=600) for h in again]
        filtered = filtered_requests(eng, prompts, vocab, new, 1100)
        profiled = device_share(torch, eng, prompts[:8], new, trace=tag + "decode_trace.json")
        no_capture_since(eng, warmed, tag + "contiguous phase")
    finally:
        eng.shutdown(drain=True, timeout=600)
    replay = (replay_equals_eager(torch, eng, torch.Generator(device="cuda").manual_seed(
        args.seed), args.seed, sb=8, steps=4, branch="fused")
        if net.device.type == "cuda" else None)
    for i, r in enumerate(results):
        check(r.ok and len(r.generated_ids) == new, f"request {i}: {r.status} "
              f"{len(r.generated_ids)} tokens {r.error}")
    substeps = after["decode_substeps"] - before["decode_substeps"]
    prefills = after["prefills"] - before["prefills"]
    check(counts.get(kinds["block"], 0) == LAYERS * substeps,
          f"K5 launches {counts.get(kinds['block'])} != 12 x {substeps} decode steps")
    # one head launch per decode substep; each request's token 0 is drawn
    # from the head GEMV's logits of its last prompt row (K3/K4, warp route)
    check(counts.get(kinds["head"], 0) == substeps,
          f"K8 launches {counts.get(kinds['head'])} != {substeps} substeps")
    check(counts["routes"]["warp"] >= prefills,
          f"{counts['routes']['warp']} warp-route GEMVs < {prefills} prefills' token 0")
    check(counts.get(kinds["gemv"], 0) > 0, "the head/prefill GEMV never launched")
    check(not any(counts.get(k) for k in forbidden), f"an int8 kind launched: {counts}")
    for i in range(8, 12):
        toks = results[i].generated_ids
        check(all(0 <= t < vocab for t in toks), f"request {i}: token outside vocab")
        check(again[i - 8].generated_ids == toks,
              f"request {i}: same seed gave another sample")
    gen_match, gen_refs = [], {}
    for i in range(8):
        p = torch.tensor([prompts[i]], dtype=torch.int32)
        for mt in (4, 1):
            ref = generate(net, p, new, multi_token=mt)[0, len(prompts[i]):].tolist()
            check(ref == results[i].generated_ids,
                  f"request {i}: engine tokens != generate(multi_token={mt}) on the card "
                  f"(first divergence {first_divergence(ref, results[i].generated_ids)})")
            gen_refs[f"{i}:{mt}"] = ref
        gen_match.append(i)
    cpu_rows = []
    t_cpu = time.perf_counter()
    for i in range(2):
        p = torch.tensor([prompts[i]], dtype=torch.int32)
        ref = generate(cpu_net, p, cpu_tokens)[0, len(prompts[i]):].tolist()
        got = results[i].generated_ids[:cpu_tokens]
        d = first_divergence(ref, got)
        row = {"request": i, "equal": d is None, "first_divergence": d}
        if d is not None:
            row["top2_gap"], top = top2_gap(torch, cpu_net, prompts[i] + ref[:d])
            row["gap_limit"] = gap_limit(torch, cpu_net, top)
            check(row["top2_gap"] < row["gap_limit"],
                  f"request {i}: card and CPU diverge at {d} with top-2 gap "
                  f"{row['top2_gap']}")
        cpu_rows.append(row)
    emit({tag + "cpu_compare": cpu_rows, "cpu_tokens": cpu_tokens,
          "cpu_s": time.perf_counter() - t_cpu})
    tokens = sum(len(r.generated_ids) for r in results)
    dsteps = after["decode_substeps"] - before["decode_substeps"]
    dsec = after["decode_s"] - before["decode_s"]
    emit({tag + "engine": {"requests": len(results), "greedy": 8, "sampled": 4,
                     "filtered_requests": filtered,
                     "new_tokens_each": new, "wall_s": wall,
                     "tokens_per_s": tokens / wall,
                     "decode_substeps": dsteps,
                     "decode_dispatches": after["decode_dispatches"]
                     - before["decode_dispatches"],
                     "ms_per_decode_step": dsec / dsteps * 1e3,
                     "prefills": after["prefills"] - before["prefills"],
                     "prefill_s": after["prefill_s"] - before["prefill_s"],
                     "kv_bytes": after["kv_bytes"], "launches": counts,
                     "warmup": warmed, "replay_equals_eager": replay,
                     "greedy_equal_generate_mt4_and_mt1": gen_match}})
    # the 8 greedy requests again, traced: device time against host wall
    emit({tag + "profiled_window": profiled if profiled is not None else "not measured"})
    # for the multi_token=1 phase (serve_k1): this engine's tokens, the
    # generate() references and the window's numbers
    counts["k4"] = {"tokens": [r.generated_ids for r in results], "generate": gen_refs,
                    "ms_per_decode_step": dsec / dsteps * 1e3, "tokens_per_s": tokens / wall,
                    "profiled": profiled}
    return counts


def contiguous_requests(torch, args, net):
    """The contiguous phases' 12 requests: (prompts of 8-48 tokens from
    ``--seed``, temperatures: 8 greedy then 4 at T 0.8, new tokens each). A
    bf16 model's greedy request 7 is cut to 5 tokens, so that one prefill
    takes the warp route with bf16 rows."""
    import numpy as np
    rng = np.random.RandomState(args.seed)
    vocab = net.cfg.vocab_size
    prompts = [rng.randint(0, vocab, int(n)).tolist()
               for n in rng.randint(8, 49, 12)]
    if net.cfg.dtype == torch.bfloat16:
        prompts[7] = prompts[7][:5]
    return prompts, [0.0] * 8 + [0.8] * 4, 64


def serve_k1(torch, args, net, k4):
    """The contiguous phase's 12 requests through a ``multi_token=1``
    engine (the engine's default; ``InferenceEngine(max_batch_size=8,
    max_len=512, multi_token=1, paged=False)``): every decode substep
    computes the tied head's logits at B <= 8 rows on the warp route of K3
    (or K4) and selects with ``sample_tokens``, as JAX's K=1 step does, and
    so does every request's token 0. Greedy tokens must equal the
    multi_token=4 engine's (K8) and ``generate()``'s on the card (``k4``:
    serve()'s record of the same requests); sampled ones lie in the vocab
    and repeat per seed; the warp route launches at least once per substep
    and prefill, K8 never. The 8 greedy requests are then traced. Returns
    the launch counts of the window."""
    from mxnet_tpu_torch.ops.int8_gemv import (dtype_lanes, gemv_routes, gemv_widths,
                                               launches, reset_launches)
    from mxnet_tpu_torch.serve import InferenceEngine
    tag, kinds, forbidden = lane(torch, net)
    vocab = net.cfg.vocab_size
    prompts, temps, new = contiguous_requests(torch, args, net)
    eng = InferenceEngine(net, max_batch_size=8, max_len=512, multi_token=1,
                          fused=True, paged=False).start()
    try:
        warmed = warm(eng)
        first = eng.generate(prompts[0][:8], 8, timeout=600)
        check(first.ok, f"K=1 warm-up request failed: {first.error}")
        before = eng.stats()
        reset_launches()
        t0 = time.perf_counter()
        handles = [eng.submit(p, new, temperature=t, seed=1000 + i)
                   for i, (p, t) in enumerate(zip(prompts, temps))]
        results = [h.result(timeout=600) for h in handles]
        wall = time.perf_counter() - t0
        counts = launches()
        counts["routes"] = gemv_routes()
        counts["widths"] = gemv_widths()
        counts["lanes"] = dtype_lanes()
        after = eng.stats()
        again = [eng.submit(prompts[i], new, temperature=0.8, seed=1000 + i)
                 for i in range(8, 12)]
        again = [h.result(timeout=600) for h in again]
        profiled = device_share(torch, eng, prompts[:8], new)
        no_capture_since(eng, warmed, tag + "K=1 phase")
    finally:
        eng.shutdown(drain=True, timeout=600)
    for i, r in enumerate(results):
        check(r.ok and len(r.generated_ids) == new, f"K=1 request {i}: {r.status} "
              f"{len(r.generated_ids)} tokens {r.error}")
    substeps = after["decode_substeps"] - before["decode_substeps"]
    prefills = after["prefills"] - before["prefills"]
    check(counts.get(kinds["block"], 0) == LAYERS * substeps,
          f"K=1: K5 launches {counts.get(kinds['block'])} != 12 x {substeps} substeps")
    check(counts.get(kinds["head"], 0) == 0, f"K=1: the fused head launched: {counts}")
    check(counts["routes"]["warp"] >= substeps + prefills,
          f"K=1: {counts['routes']['warp']} warp-route GEMVs < {substeps} substeps + "
          f"{prefills} prefills")
    head = counts["widths"].get("warp:50304", 0)
    check(head >= substeps + prefills, f"K=1: {head} tied-head GEMVs on the warp route < "
          f"{substeps} substeps + {prefills} prefills")
    check(not any(counts.get(k) for k in forbidden), f"K=1: an int8 kind launched: {counts}")
    for i in range(8):
        got = results[i].generated_ids
        for what, ref in (("the multi_token=4 engine's", k4["tokens"][i]),
                          ("generate(multi_token=1)'s", k4["generate"][f"{i}:1"]),
                          ("generate(multi_token=4)'s", k4["generate"][f"{i}:4"])):
            check(got == ref, f"K=1 request {i}: greedy tokens != {what} (first divergence "
                  f"{first_divergence(got, ref)})")
    for i in range(8, 12):
        toks = results[i].generated_ids
        check(all(0 <= t < vocab for t in toks), f"K=1 request {i}: token outside vocab")
        check(again[i - 8].generated_ids == toks, f"K=1 request {i}: same seed gave "
              "another sample")
    tokens = sum(len(r.generated_ids) for r in results)
    dsec = after["decode_s"] - before["decode_s"]
    k4p = k4["profiled"] or {}
    emit({tag + "engine_k1": {
        "requests": len(results), "greedy": 8, "sampled": 4, "new_tokens_each": new,
        "wall_s": wall, "tokens_per_s": tokens / wall, "decode_substeps": substeps,
        "prefills": prefills, "ms_per_decode_step": dsec / substeps * 1e3,
        "head_gemvs_warp": head, "launches": counts, "warmup": warmed,
        "greedy_equal_k4_engine_and_generate": list(range(8)),
        "k4_window": {"ms_per_decode_step": k4["ms_per_decode_step"],
                      "tokens_per_s": k4["tokens_per_s"],
                      "idle_share": k4p.get("idle_share"),
                      "kernel_ms": k4p.get("kernel_ms")}}})
    emit({tag + "profiled_window_k1": profiled if profiled is not None else "not measured"})
    return counts


def prefill_chunks(torch, net, ids, chunk, caches):
    """Prefill ``ids`` into contiguous ``caches`` in ``chunk``-token chunks
    as the paged engine does (the final chunk zero-padded to the engine's
    prompt bucket); returns (hidden of the final chunk, row of the last
    token)."""
    import numpy as np

    from mxnet_tpu_torch.models import generation as gen
    from mxnet_tpu_torch.serve.bucketing import bucket_for
    cursor, P = 0, len(ids)
    while True:
        end = min(cursor + chunk, P)
        n = end - cursor
        pb = n if end < P else bucket_for(n, 8, chunk)
        x = np.zeros((1, pb), np.int32)
        x[0, :n] = ids[cursor:end]
        hidden, caches = gen.decode_step_hidden(net, torch.from_numpy(x).to(net.device),
                                                cursor, caches)
        if end == P:
            return hidden, n - 1
        cursor = end


def chunked_reference(torch, net, prompt, new, chunk, max_len, K=4):
    """Greedy tokens of the paged engine's arithmetic on the contiguous
    layout: ``prompt`` prefilled in ``chunk``-token chunks (K3), token 0
    from the fused head (K8), then K-token decode dispatches (K5, which
    gives a row K6's and K7's bits)."""
    from mxnet_tpu_torch.models import generation as gen
    from mxnet_tpu_torch.ops.fused_block_gemv import fused_lm_head_sample
    dev = net.device
    caches = net.new_caches(1, max_len)
    head = net.head_weights()
    with torch.no_grad():
        hidden, last = prefill_chunks(torch, net, prompt, chunk, caches)
        tok = fused_lm_head_sample(hidden[:, last], *head,
                                   torch.zeros(1, dtype=torch.int64, device=dev),
                                   torch.zeros(1, device=dev))
        out = [int(tok[0])]
        while len(out) < new:
            toks, tok, steps, _, caches = gen.decode_multi_tokens(
                net, tok, len(prompt) + len(out) - 1, caches, K, [0.0], [0], [len(out)],
                remaining=[new - len(out)], head=head)
            out += toks[0, :steps].tolist()
    return out[:new]


def chunked_gap(torch, net, tokens, chunk, max_len):
    """Top-1 minus top-2 logit after ``tokens``, prefilled in chunks as the
    paged engine prefills them (K3 head at the last row)."""
    with torch.no_grad():
        hidden, last = prefill_chunks(torch, net, tokens, chunk, net.new_caches(1, max_len))
        top = torch.topk(net._lm_head(hidden)[0, last].float(), 2).values
    return (top[0] - top[1]).item()


def greedy_rows(torch, net, prompts, results, new, chunk, max_len):
    """Each greedy request against the engine's arithmetic on the
    contiguous layout (``chunked_reference``) and against
    ``generate(multi_token=4)``: equal, or a first divergence at a top-2
    gap below 1e-3. ``generate()`` prefills a prompt in one forward, which
    past ``gemv_max_m()`` (64) rows takes the activation-quantized int8
    product instead of K3, so it is held to that rule only for prompts of
    at most 64 tokens and reported for the others."""
    from mxnet_tpu_torch.models import generate
    from mxnet_tpu_torch.ops.int8_gemv import gemv_max_m
    rows = []
    for i, (prompt, got) in enumerate(zip(prompts, results)):
        row = {"request": i, "prompt": len(prompt)}
        for name, ref in (
                ("chunked_reference", chunked_reference(torch, net, prompt, new, chunk,
                                                        max_len)),
                ("generate_mt4", generate(net, torch.tensor([prompt], dtype=torch.int32),
                                          new, multi_token=4)[0, len(prompt):].tolist())):
            d = first_divergence(ref, got)
            row[name] = {"equal": d is None, "first_divergence": d}
            held = name == "chunked_reference" or len(prompt) <= gemv_max_m()
            if d is not None:
                gap = chunked_gap(torch, net, prompt + ref[:d], chunk, max_len)
                row[name]["top2_gap"] = gap
                check(not held or gap < 1e-3,
                      f"request {i}: engine tokens != {name} at {d}, top-2 gap {gap}")
            row[name]["held"] = held
        rows.append(row)
    return rows


def serve_paged(torch, args, net, phase):
    """A paged serving phase of quantized GPT-2 small through
    ``InferenceEngine(paged=True, fused=True, multi_token=4)``.

    A (K6): 16 slots, max_len 256, a 128-page pool (the contiguous bytes of
    8 slots); 16 requests sharing a 40-token system prompt plus 8-40 own
    tokens, 64 new tokens each, 12 greedy and 4 at T 0.8; the first served
    alone publishes the prefix, the other 15 are submitted together.
    B (K7): 8 slots, max_len 1024, no prefix cache; 8 greedy requests of
    300-700-token prompts prefilled in 16-token chunks, 128 new tokens
    each, submitted together, on a pool of PAGED_B_PAGES, about half of
    what they need together, so requests are preempted and resumed.
    C (K7, no preemption): 4 slots, max_len 1024, no prefix cache; 4 greedy
    requests of 300-700-token prompts, 32 new tokens each, submitted
    together, on the default pool (the contiguous bytes of the 4 slots).
    Returns the launch counts of the concurrent window."""
    import numpy as np

    from mxnet_tpu_torch.ops.int8_gemv import (dma_ledger, dtype_lanes, gemv_routes,
                                               gemv_widths, launches, reset_launches)
    from mxnet_tpu_torch.serve import InferenceEngine
    from mxnet_tpu_torch.serve.paging import pages_for
    tag, kinds, forbidden = lane(torch, net)
    rng = np.random.RandomState(args.seed + {"A": 1, "B": 2, "C": 3}[phase])
    vocab = net.cfg.vocab_size
    if phase == "A":
        system = rng.randint(0, vocab, 40).tolist()
        prompts = [system + rng.randint(0, vocab, int(n)).tolist()
                   for n in rng.randint(8, 41, 16)]
        temps = [0.0] * 12 + [0.8] * 4
        new, kernel, other = 64, kinds["paged"], kinds["dma"]
        kw = dict(max_batch_size=16, max_len=256, num_pages=128)
    else:
        n_req = 8 if phase == "B" else 4
        prompts = [rng.randint(0, vocab, int(n)).tolist()
                   for n in rng.randint(300, 701, n_req)]
        temps = [0.0] * n_req
        new, kernel, other = (128 if phase == "B" else 32), kinds["dma"], kinds["paged"]
        kw = (dict(max_batch_size=8, max_len=1024, num_pages=PAGED_B_PAGES, prefix_cache=False)
              if phase == "B" else dict(max_batch_size=4, max_len=1024, prefix_cache=False))
    eng = InferenceEngine(net, multi_token=4, fused=True, paged=True, page_size=16,
                          **kw).start()
    try:
        warmed = warm(eng)
        first = []
        if phase == "A":
            r0 = eng.generate(prompts[0], new, timeout=600)
            check(r0.ok, f"phase A request 0: {r0.status} {r0.error}")
            first = [r0]
        before = eng.stats()
        reset_launches()
        t0 = time.perf_counter()
        handles = [eng.submit(p, new, temperature=t, seed=2000 + i)
                   for i, (p, t) in enumerate(zip(prompts, temps)) if i >= len(first)]
        results = first + [h.result(timeout=900) for h in handles]
        wall = time.perf_counter() - t0
        counts, ledger = launches(), dma_ledger()
        counts["routes"] = gemv_routes()
        counts["widths"] = gemv_widths()
        counts["lanes"] = dtype_lanes()
        after = eng.stats()
        counts["kv_bytes"] = after["kv_bytes"]
        sampled = [i for i, t in enumerate(temps) if t > 0]
        again = [eng.submit(prompts[i], new, temperature=0.8, seed=2000 + i) for i in sampled]
        again = [h.result(timeout=600) for h in again]
        filtered = (filtered_requests(eng, prompts, vocab, min(new, 64), 2100)
                    if phase == "A" else None)
        greedy = [i for i, t in enumerate(temps) if t == 0]
        profiled = (device_share(torch, eng, [prompts[i] for i in greedy], new)
                    if net.device.type == "cuda" else None)
        no_capture_since(eng, warmed, f"{tag}paged phase {phase}")
    finally:
        eng.shutdown(drain=True, timeout=900)
    replay = None
    if net.device.type == "cuda":
        g = torch.Generator(device="cuda").manual_seed(args.seed)
        replay = [replay_equals_eager(torch, eng, g, args.seed, sb=kw["max_batch_size"],
                                      steps=4, branch="fused")]
        replay += [replay_equals_eager(torch, eng, g, args.seed + pb, pb=pb) for pb in (16, 8)]
    for i, r in enumerate(results):
        check(r.ok and len(r.generated_ids) == new,
              f"phase {phase} request {i}: {r.status} {len(r.generated_ids)} tokens {r.error}")
    substeps = after["decode_substeps"] - before["decode_substeps"]
    check(counts.get(kernel, 0) == LAYERS * substeps,
          f"phase {phase}: {kernel} launches {counts.get(kernel)} != 12 x {substeps}")
    check(not counts.get(other) and not counts.get(kinds["block"]),
          f"phase {phase}: other block kernels launched: {counts}")
    check(not any(counts.get(k) for k in forbidden), f"phase {phase}: an int8 kind launched: "
          f"{counts}")
    check(ledger["copies"] == ledger["waits"], f"phase {phase}: DMA ledger {ledger}")
    pages = after["pages"]
    if phase == "A":
        check(after["max_active"] > 8, f"phase A: max_active {after['max_active']} <= 8")
        check(pages["prefix_hits"] >= 15 and pages["cow_forks"] > 0,
              f"phase A: prefix hits {pages['prefix_hits']}, forks {pages['cow_forks']}")
    elif phase == "B":
        check(after["preemptions"] > 0, "phase B: no preemption")
    else:
        check(after["preemptions"] == 0, f"phase C: {after['preemptions']} preemptions")
    for i, r in zip(sampled, again):
        toks = results[i].generated_ids
        check(all(0 <= t < vocab for t in toks), f"phase {phase} request {i}: token outside vocab")
        check(r.generated_ids == toks, f"phase {phase} request {i}: same seed, another sample")
    eng._pages.clear_prefix_cache()
    eng._pages.check_consistent()
    check(eng._pages.pages_in_use() == 0,
          f"phase {phase}: {eng._pages.pages_in_use()} pages held after the drain")
    t_ref = time.perf_counter()
    rows = greedy_rows(torch, net, [prompts[i] for i in greedy],
                       [results[i].generated_ids for i in greedy], new, 16, kw["max_len"])
    tokens = sum(len(r.generated_ids) for r in results[len(first):])
    dsec = after["decode_s"] - before["decode_s"]
    emit({f"{tag}paged_{phase}": {
        "kernel": kernel, "requests": len(prompts), "new_tokens_each": new,
        "prompt_tokens": [len(p) for p in prompts], **kw,
        "pages_needed": sum(pages_for(len(p) + new + 3, 16) for p in prompts),
        "concurrent_requests": len(handles), "wall_s": wall, "tokens_per_s": tokens / wall,
        "decode_substeps": substeps,
        "decode_dispatches": after["decode_dispatches"] - before["decode_dispatches"],
        "ms_per_decode_step": dsec / substeps * 1e3,
        "prefills": after["prefills"] - before["prefills"],
        "prefill_chunks": after["prefill_chunks"] - before["prefill_chunks"],
        "prefill_s": after["prefill_s"] - before["prefill_s"],
        "max_active": after["max_active"], "preemptions": after["preemptions"],
        "resumed_tokens": after["resumed_tokens"],
        "pages": pages, "kv_bytes": after["kv_bytes"], "launches": counts,
        "dma_ledger": ledger, "greedy": rows, "reference_s": time.perf_counter() - t_ref,
        "warmup": warmed, "replay_equals_eager": replay,
        "filtered_requests": filtered,
        "greedy_identical_chunked_reference": all(r["chunked_reference"]["equal"]
                                                  for r in rows),
        "greedy_identical_generate_mt4": all(r["generate_mt4"]["equal"] for r in rows),
        "profiled_window": profiled if profiled is not None else "not measured"}})
    return counts


def structured_prompts(n, vocab, seed=0, boiler_run=16, n_keys=3, max_tokens=None):
    """Templated JSON-like prompts: runs of one boilerplate token around a
    few key tokens with per-request values, the repetitive traffic that
    self-speculation drafts well (a copy of ``tools/serve_loadgen.py``'s
    ``structured_prompts``, the traffic of ``bench.py``'s speculation and
    grammar duels)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    boiler = int(rng.randint(1, vocab - 1))
    keys = rng.randint(1, vocab - 1, size=n_keys)
    prompts = []
    for _ in range(n):
        body = []
        for k in keys:
            body.extend([boiler] * boiler_run)
            body.append(int(k))
            body.append(int(rng.randint(1, vocab - 1)))
        if max_tokens is not None:
            body = body[:max_tokens]
        prompts.append(body)
    return prompts


# bench.py's conformance schema (bench_grammar_decode): bounded productions
CS_SCHEMA = {"type": "object", "properties": {
    "ok": {"type": "boolean"}, "mode": {"enum": ["fast", "safe", "off"]},
    "n": {"enum": [0, 1, 2]}}}
CS_EOS = 0
CS_TRIALS = 3                  # timed trials per sweep, after one warm discard
CS_SPEC = 4


def cs_sweep(torch, eng, run, name):
    """One sweep of the constrained_spec phase: a warm discard of ``run()``
    (the engine already warmed up), then CS_TRIALS timed trials with the
    launch counts set to 0 just before them and read just after. Each trial
    must give the discard's tokens. Returns (results of the last trial, the
    sweep's record)."""
    from mxnet_tpu_torch.ops.int8_gemv import gemv_routes, launches, reset_launches
    ref = run()
    for i, r in enumerate(ref):
        check(r.ok, f"constrained_spec {name}: request {i}: {r.status} {r.error}")
    before = eng.stats()
    reset_launches()
    rates = []
    for _ in range(CS_TRIALS):
        t0 = time.perf_counter()
        res = run()
        wall = time.perf_counter() - t0
        check([r.generated_ids for r in res] == [r.generated_ids for r in ref],
              f"constrained_spec {name}: a trial gave other tokens than the warm discard")
        rates.append(sum(len(r.generated_ids) for r in res) / wall)
    counts = launches()
    counts["routes"] = gemv_routes()
    after = eng.stats()
    check(all(counts["routes"].get(r, 0) > 0 for r in ("warp", "mma")),
          f"constrained_spec {name}: K3 routes {counts['routes']}")
    rec = {"tokens_per_s": {"median": statistics.median(rates), "min": min(rates),
                            "max": max(rates)},
           "decode_dispatches": after["decode_dispatches"] - before["decode_dispatches"],
           "decode_tokens": after["decode_tokens"] - before["decode_tokens"],
           "launches": counts}
    if "spec" in after:
        rec["spec"] = after["spec"]
        rec["rounds"] = after["spec"]["rounds"] - before["spec"]["rounds"]
    return res, rec


def constrained_spec(torch, args, net, cpu_net):
    """Grammar-constrained and self-speculative serving of int8 GPT-2 small,
    ``bench.py``'s grammar and speculation duels on GPT-2's vocab: 8
    structured prompts, one request in flight at a time, greedy, seed 0,
    EOS 0, through ``InferenceEngine(max_batch_size=2, max_len=128,
    paged=True, page_size=16, speculate=4)``; each sweep after ``warmup()``,
    a warm discard and CS_TRIALS timed trials (``cs_sweep``).

    (a) free against pass-through: a speculative engine without grammar and
        one with ``grammar=True`` serving ``grammar=".*"``, 64 new tokens:
        the same tokens, and the constrained acceptance no lower. One sweep
        of the constrained engine is profiled (idle share).
    (b) conformance: ``CS_SCHEMA`` on a grammar engine, seed i per prompt:
        every completion ends ok and replays through the automaton.
    (c) speculation against none: ``speculate=4`` against ``speculate=0``
        (K6), 80 new tokens on prompts cut to 40 tokens (``bench.py``'s
        speculation duel: 128 - 80 - 8): greedy tokens equal, or at the
        first divergence the CPU twin's top-2 gap below ``gap_limit``; then
        2 sampled requests (T 0.8, top-k 40) on each, equality reported.
    (d) contiguous grammar at K=1: ``InferenceEngine(max_batch_size=8,
        max_len=512, paged=False, grammar=True)`` (K5) with 8 requests at
        once, 4 under the schema: the 4 free rows equal a plain K=1
        contiguous engine's tokens, the 4 constrained ones replay.

    In every sweep nothing is captured after ``warmup()`` and K3 launches on
    both routes. Returns the launch counts of the sweeps by name."""
    from mxnet_tpu_torch.serve import InferenceEngine, compile_grammar
    from mxnet_tpu_torch.serve.grammar import clear_grammar_cache
    tag, kinds, _ = lane(torch, net)
    vocab = net.cfg.vocab_size
    t_phase = time.perf_counter()
    clear_grammar_cache()
    compile_s = {}
    for name, src in (("dotstar", ".*"), ("schema", CS_SCHEMA)):
        t0 = time.perf_counter()
        g = compile_grammar(src, vocab, cache=False)
        compile_s[name] = {"s": time.perf_counter() - t0, "states": g.n_states,
                           "classes": g.n_classes}
    schema = compile_grammar(CS_SCHEMA, vocab)
    prompts = structured_prompts(8, vocab, seed=0, max_tokens=56)
    short = structured_prompts(8, vocab, seed=0, max_tokens=128 - 80 - 8)
    paged_kw = dict(max_batch_size=2, max_len=128, paged=True, page_size=16, fused=True)
    out, counts = {"compile": compile_s}, {}

    def one_at_a_time(eng, ps, new, **kw):
        def run():
            return [eng.generate(p, new, timeout=600, **{k: (v(i) if callable(v) else v)
                                                        for k, v in kw.items()})
                    for i, p in enumerate(ps)]
        return run

    def engine(**kw):
        eng = InferenceEngine(net, **kw).start()
        return eng, warm(eng)

    cuda = net.device.type == "cuda"
    gen = torch.Generator(device=net.device).manual_seed(args.seed)

    # (a) free against pass-through
    sweeps = {}
    for name, gram in (("free", None), ("dotstar", ".*")):
        eng, warmed = engine(speculate=CS_SPEC, grammar=gram is not None, **paged_kw)
        try:
            extra = {"grammar": gram} if gram else {}
            run = one_at_a_time(eng, prompts, 64, seed=0, eos_token_id=CS_EOS, **extra)
            res, rec = cs_sweep(torch, eng, run, f"(a) {name}")
            if gram and cuda:
                rec["profiled_window"] = device_share(torch, eng, prompts, 64, run=run)
            no_capture_since(eng, warmed, f"constrained_spec (a) {name}")
        finally:
            eng.shutdown(drain=True, timeout=600)
        rec["warmup"] = warmed
        sweeps[name] = (res, rec)
        counts["a_" + name] = rec["launches"]
    free, cons = sweeps["free"], sweeps["dotstar"]
    check([r.generated_ids for r in free[0]] == [r.generated_ids for r in cons[0]],
          "constrained_spec (a): the pass-through grammar changed the tokens")
    acc_free = free[1]["spec"]["acceptance_rate"] or 0.0
    acc_cons = cons[1]["spec"]["acceptance_rate"] or 0.0
    check(acc_cons + 1e-9 >= acc_free, f"constrained_spec (a): acceptance {acc_cons} < the "
          f"free engine's {acc_free}")
    out["a"] = {"free": free[1], "dotstar": cons[1], "identical": True,
                "cost_pct": (1 - cons[1]["tokens_per_s"]["median"]
                             / free[1]["tokens_per_s"]["median"]) * 100}

    # (b) conformance under the schema
    eng, warmed = engine(speculate=CS_SPEC, grammar=True, **paged_kw)
    try:
        run = one_at_a_time(eng, prompts, 64, seed=lambda i: i, eos_token_id=CS_EOS,
                            grammar=schema)
        res, rec = cs_sweep(torch, eng, run, "(b)")
        no_capture_since(eng, warmed, "constrained_spec (b)")
    finally:
        eng.shutdown(drain=True, timeout=600)
    if cuda:        # a grammar engine's verify step: replay against eager
        rec["replay_equals_eager"] = [
            replay_equals_eager(torch, eng, gen, args.seed + i, sb=2, branch=branch,
                                verify=True)
            for i, branch in enumerate(("greedy", "sampled"))]
    bad = [i for i, r in enumerate(res)
           if not (r.ok and schema.matches(r.generated_ids, eos_token_id=CS_EOS))]
    check(not bad, f"constrained_spec (b): completions {bad} do not replay through the schema")
    rec.update(warmup=warmed, conformant=len(res),
               completion_0="".join(chr(t) for t in res[0].generated_ids[:-1]))
    out["b"] = rec
    counts["b"] = rec["launches"]

    # (c) speculation against none
    runs = {}
    for name, spec in (("spec", CS_SPEC), ("base", 0)):
        eng, warmed = engine(speculate=spec, **paged_kw)
        try:
            res, rec = cs_sweep(torch, eng, one_at_a_time(eng, short, 80, seed=0),
                                f"(c) {name}")
            sampled = [eng.generate(short[i], 80, temperature=0.8, top_k=40, seed=3000 + i,
                                    timeout=600) for i in range(2)]
            no_capture_since(eng, warmed, f"constrained_spec (c) {name}")
        finally:
            eng.shutdown(drain=True, timeout=600)
        check(all(r.ok for r in sampled), f"constrained_spec (c) {name}: sampled requests")
        rec["warmup"] = warmed
        runs[name] = (res, rec, sampled)
        counts["c_" + name] = rec["launches"]
    check(runs["base"][1]["launches"].get(kinds["paged"], 0) > 0,
          f"constrained_spec (c): K6 never launched in the baseline "
          f"{runs['base'][1]['launches']}")
    rows = []
    for i, (a, b) in enumerate(zip(runs["spec"][0], runs["base"][0])):
        d = first_divergence(a.generated_ids, b.generated_ids)
        row = {"request": i, "equal": d is None and len(a.generated_ids) == len(b.generated_ids),
               "first_divergence": d}
        if d is not None:
            row["top2_gap"], top = top2_gap(torch, cpu_net,
                                            short[i] + b.generated_ids[:d])
            row["gap_limit"] = gap_limit(torch, cpu_net, top)
            check(row["top2_gap"] < row["gap_limit"],
                  f"constrained_spec (c): request {i}: speculative and non-speculative "
                  f"greedy tokens diverge at {d} with top-2 gap {row['top2_gap']}")
        rows.append(row)
    out["c"] = {"spec": runs["spec"][1], "base": runs["base"][1], "greedy": rows,
                "identical": sum(r["equal"] for r in rows),
                "speedup": runs["spec"][1]["tokens_per_s"]["median"]
                / runs["base"][1]["tokens_per_s"]["median"],
                "sampled_equal": [a.generated_ids == b.generated_ids
                                  for a, b in zip(runs["spec"][2], runs["base"][2])]}

    # (d) contiguous grammar at K=1 against the plain K=1 engine
    toks = {}
    for name, gram in (("grammar", True), ("plain", False)):
        eng, warmed = engine(max_batch_size=8, max_len=512, paged=False, fused=True,
                             grammar=gram)

        def run(eng=eng, gram=gram):
            hs = [eng.submit(p, 64, seed=i, eos_token_id=CS_EOS,
                             **({"grammar": schema} if gram and i % 2 == 0 else {}))
                  for i, p in enumerate(prompts)]
            return [h.result(timeout=600) for h in hs]

        try:
            res, rec = cs_sweep(torch, eng, run, f"(d) {name}")
            no_capture_since(eng, warmed, f"constrained_spec (d) {name}")
        finally:
            eng.shutdown(drain=True, timeout=600)
        check(rec["launches"].get(kinds["block"], 0) > 0,
              f"constrained_spec (d) {name}: K5 never launched {rec['launches']}")
        rec["warmup"] = warmed
        if cuda and gram:   # a grammar T = 1 step: replay against eager
            rec["replay_equals_eager"] = [
                replay_equals_eager(torch, eng, gen, args.seed + 7, sb=8, steps=1,
                                    branch=branch) for branch in ("greedy", "sampled")]
        toks[name] = res
        out["d_" + name] = rec
        counts["d_" + name] = rec["launches"]
    for i in range(1, 8, 2):
        check(toks["grammar"][i].generated_ids == toks["plain"][i].generated_ids,
              f"constrained_spec (d): free request {i} on the grammar engine != the plain "
              f"engine's (first divergence "
              f"{first_divergence(toks['grammar'][i].generated_ids, toks['plain'][i].generated_ids)})")
    for i in range(0, 8, 2):
        check(schema.matches(toks["grammar"][i].generated_ids, eos_token_id=CS_EOS),
              f"constrained_spec (d): constrained request {i} does not replay")
    out["d"] = {"free_rows_equal_plain": 4, "constrained_rows_conformant": 4}
    out["phase_s"] = time.perf_counter() - t_phase
    emit({tag + "constrained_spec": out})
    return counts


HTTP_TRIALS = 3                # timed trials of (a), HTTP and in-process each
HTTP_NEW = 48                  # new tokens of each (a) request
# (a)'s 10 requests are served this many times a trial (and the profiled
# window's 8 greedy ones likewise), so that a window lasts over a second
HTTP_ROUNDS = 12
SCORE_TOL = 1e-3               # card score against the CPU twin's


class _Reply:
    """A /generate JSON document as a result ``device_share`` reads."""

    def __init__(self, doc):
        self.doc = doc
        self.status, self.error = doc["status"], doc.get("error")
        self.ok = self.status == "ok"
        self.generated_ids = doc["generated_ids"]


def http_json(url, path, doc=None, timeout=600):
    """(status, JSON body) of a GET (``doc`` None) or POST; an HTTP error
    status is an answer, not an exception."""
    import urllib.error
    import urllib.request
    data = None if doc is None else json.dumps(doc).encode()
    req = urllib.request.Request(url + path, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def http_sse(url, payload, timeout=600):
    """The token ids and the done document of one SSE /generate."""
    import urllib.request
    req = urllib.request.Request(url + "/generate", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    toks, done, kind = [], None, None
    with urllib.request.urlopen(req, timeout=timeout) as r:
        for line in r:
            line = line.rstrip(b"\n")
            if line.startswith(b"event: "):
                kind = line[7:].decode()
            elif line.startswith(b"data: ") and kind == "token":
                toks.append(json.loads(line[6:])["token"])
            elif line.startswith(b"data: ") and kind == "done":
                done = json.loads(line[6:])
                break
    return toks, done


def http_post_all(url, payloads, pool):
    """POST every payload to /generate from the client threads of ``pool``
    (a ThreadPoolExecutor); returns the (status, document) pairs in payload
    order."""
    return list(pool.map(lambda p: http_json(url, "/generate", p), payloads))


def metric_values(text, names):
    """{sample name with labels: value} of Prometheus text for the sample
    names (exposition names, labels included) starting with ``names``."""
    out = {}
    for ln in text.splitlines():
        if ln.startswith(names):
            key, val = ln.rsplit(" ", 1)
            out[key] = float(val)
    return out


def median_span(xs):
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs)}


def http_serve(torch, args, net, cpu_net):
    """Phase http_serve: the HTTP frontend over int8 GPT-2 small (f32,
    fused decode, the main model) on 127.0.0.1, port 0.

    (a) A paged engine (``max_batch_size=8, max_len=256, multi_token=4``:
    K6 and K8) after ``warmup()`` and ``warmup_score()``: 8 greedy prompts
    of 8-48 tokens and 2 at T 0.8 posted from 8 client threads (a pool
    made outside the timers), HTTP_ROUNDS times a trial, their tokens
    equal to the same engine's in-process ``generate()`` from the same
    threads in every round, their SSE streams equal to the JSON replies,
    nothing captured after the warm-up; requests/s and tokens/s through
    HTTP against in-process over HTTP_TRIALS trials each, and the idle
    share of a profiled HTTP window of the 8 greedy prompts HTTP_ROUNDS
    times. (b) ``/score`` of 4
    sequences of 5-64 tokens: bit for bit the same scores run eagerly on
    the card, within SCORE_TOL of the CPU twin, ``logprob`` their sum, K3
    launched on both routes by these scores alone, and the same bits when
    posted while (a)'s requests decode; ms per score bucket. (c)
    ``/metrics`` after (a): requests and generated tokens against the
    replies the smoke received, and the launch sites of the built steps;
    ``/healthz`` 200 with models ``{"default": 0}``.
    (d) An unfused int8 engine (``multi_token=1``, every layer on K3): net
    B's weights published with ``publish_weights`` and deployed by ``POST
    /weights`` while a request decodes; the request completes, later
    requests equal a fresh engine on net B, nothing is captured,
    ``/healthz`` shows version 1; a swap on (a)'s fused engine raises the
    JAX refusal. (e) ``POST /drain`` with requests in flight: ``/healthz``
    503 and draining, new requests 503, the in-flight ones finish ok.
    Returns the launch counts of the phase."""
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from mxnet_tpu_torch import metrics as tmetrics
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.ops.int8_gemv import gemv_routes, launches, reset_launches
    from mxnet_tpu_torch.serve import HTTPFrontend, InferenceEngine
    rng = np.random.RandomState(args.seed + 14)
    vocab = net.cfg.vocab_size
    tmetrics.enable()
    tmetrics.reset()
    prompts = [rng.randint(0, vocab, int(n)).tolist() for n in rng.randint(8, 49, 10)]
    payloads = [{"input_ids": p, "max_new_tokens": HTTP_NEW,
                 **({"temperature": 0.8, "seed": 1400 + i} if i >= 8 else {})}
                for i, p in enumerate(prompts)]

    rounds = payloads * HTTP_ROUNDS
    received = []           # (status, generated tokens) of each reply from eng

    def in_process(eng):
        # from the client pool, as HTTP posts them: each thread submits a
        # request and waits for its result before the next
        return list(client.map(lambda p: eng.submit(
            p["input_ids"], HTTP_NEW, temperature=p.get("temperature", 0.0),
            seed=p.get("seed", 0)).result(timeout=600), rounds))

    def post(batch):
        got = http_post_all(fe.url, batch, client)
        received.extend((d.get("status"), len(d.get("generated_ids", ()))) for _, d in got)
        return got

    eng = InferenceEngine(net, max_batch_size=8, max_len=256, multi_token=4, paged=True,
                          page_size=16).start()
    fe = HTTPFrontend(eng, host="127.0.0.1", port=0).start()
    client = ThreadPoolExecutor(8)
    out = {}
    try:
        t0 = time.perf_counter()
        warmed = warm(eng)
        eng.warmup_score()
        warmed = dict(warmed, **{k: eng.stats()[k] for k in ("captures", "compiled_buckets")})
        out["warmup_s"] = time.perf_counter() - t0
        reset_launches()
        # (a) through HTTP, and the same requests in-process, trial by trial
        seqs = [rng.randint(0, vocab, int(n)).tolist() for n in (5, 8, 23, 64)]
        # (b) K3's routes read around these scores alone: nothing else is
        # in flight, so every launch they count is a score's
        routes0 = gemv_routes()
        alone = [http_json(fe.url, "/score", {"input_ids": s}) for s in seqs]
        out["score_routes"] = {k: n - routes0.get(k, 0) for k, n in gemv_routes().items()}
        check(all(c == 200 for c, _ in alone), f"/score: {[c for c, _ in alone]}")
        check(out["score_routes"].get("warp", 0) > 0 and out["score_routes"].get("mma", 0) > 0,
              f"(b) /score of {[len(s) for s in seqs]} tokens: K3 routes "
              f"{out['score_routes']}")
        alone = [d for _, d in alone]
        trials = {"http": [], "in_process": []}
        replies = None
        for trial in range(HTTP_TRIALS):
            t0 = time.perf_counter()
            got = post(rounds)
            wall = time.perf_counter() - t0
            check(all(c == 200 and d["status"] == "ok" for c, d in got),
                  f"(a) trial {trial}: {[(c, d.get('status'), d.get('error')) for c, d in got]}")
            replies = replies or [d for _, d in got[:len(payloads)]]
            check([d["generated_ids"] for _, d in got]
                  == [d["generated_ids"] for d in replies] * HTTP_ROUNDS,
                  f"(a) trial {trial}: the tokens moved between rounds or trials")
            trials["http"].append((wall, sum(len(d["generated_ids"]) for _, d in got)))
            t0 = time.perf_counter()
            res = in_process(eng)
            wall = time.perf_counter() - t0
            received.extend((r.status, len(r.generated_ids)) for r in res)
            check(all(r.ok for r in res), f"(a) in-process trial {trial}")
            check([r.generated_ids for r in res]
                  == [d["generated_ids"] for d in replies] * HTTP_ROUNDS,
                  f"(a) trial {trial}: HTTP tokens differ from in-process generate()")
            trials["in_process"].append((wall, sum(len(r.generated_ids) for r in res)))
        for mode, rows in trials.items():
            out[mode] = {"requests_per_s": median_span([len(rounds) / w for w, _ in rows]),
                         "tokens_per_s": median_span([n / w for w, n in rows]),
                         "wall_s": [w for w, _ in rows]}
        # SSE: frame for frame the JSON replies
        for p, d in zip(payloads, replies):
            toks, done = http_sse(fe.url, dict(p, stream=True))
            check(toks == d["generated_ids"] and done is not None
                  and done["generated_ids"] == toks and done["status"] == "ok",
                  f"SSE stream differs from the JSON reply for prompt {p['input_ids'][:4]}")
            received.append((done["status"], len(toks)))
        # (b) scores posted while (a)'s requests decode: the same bits
        with ThreadPoolExecutor(1) as pool:
            busy = pool.submit(post, payloads)
            during = []
            while not busy.done() or not during:
                during.append([http_json(fe.url, "/score", {"input_ids": s})[1] for s in seqs])
            check(all(c == 200 for c, _ in busy.result()), "(b) decode window failed")
        check(all(d == alone for d in during),
              "(b) a score posted during decode differs from one posted alone")
        out["scores_during_decode"] = len(during)
        for s, d in zip(seqs, alone):
            check(d["tokens"] == len(s) - 1 and d["logprob"] == sum(d["token_logprobs"]),
                  f"(b) /score doc of {len(s)} tokens: tokens {d['tokens']}, logprob "
                  f"{d['logprob']} != the sum of its token_logprobs")
        # score ms per bucket, in-process through the graphs
        score_ms = {}
        for pb in warmed["compiled_buckets"]["score"]:
            ids = rng.randint(0, vocab, pb).tolist()
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                eng.score(ids)
                times.append((time.perf_counter() - t0) * 1e3)
            score_ms[pb] = statistics.median(times)
        out["score_ms_per_bucket"] = score_ms
        greedy = [{"input_ids": p["input_ids"], "max_new_tokens": HTTP_NEW}
                  for p in payloads[:8]] * HTTP_ROUNDS
        out["profiled_window"] = device_share(
            torch, eng, None, HTTP_NEW,
            run=lambda: [_Reply(d) for _, d in post(greedy)]) or "not measured"
        no_capture_since(eng, warmed, "http_serve (a)")
        # (c) /metrics: the counters the requests alone fix, against the
        # replies received, and the launch sites of every step the engine
        # built
        with urllib.request.urlopen(fe.url + "/metrics", timeout=60) as r:
            text = r.read().decode()
        vals = metric_values(text, ("mxnet_serve_requests_total", "mxnet_serve_tokens_total",
                                    "mxnet_decode_launches_total"))
        served = sum(1 for status, _ in received if status == "ok")
        tokens = sum(n for _, n in received)
        check(vals.get('mxnet_serve_requests_total{status="ok"}') == served,
              f"(c) requests_total ok {vals.get('mxnet_serve_requests_total{status=\"ok\"}')} "
              f"!= {served} replies received ok")
        check(vals.get("mxnet_serve_tokens_total") == tokens,
              f"(c) tokens_total {vals.get('mxnet_serve_tokens_total')} != {tokens} tokens "
              "received")
        sites = {}
        for step in (list(eng._steps.values()) + list(eng._chunks.values())
                     + list(eng._score_steps.values())):
            for kind, n in step.tally.kinds.items():
                sites[kind] = sites.get(kind, 0) + n
        got_sites = {k[len('mxnet_decode_launches_total{kind="'):-2]: v for k, v in vals.items()
                     if k.startswith("mxnet_decode_launches_total{")}
        check(got_sites == sites, f"(c) decode_launches_total {got_sites} != built {sites}")
        code, hz = http_json(fe.url, "/healthz")
        check(code == 200 and hz["models"] == {"default": 0} and hz["ok"],
              f"(c) /healthz {code} {hz}")
        out["metrics"] = {"requests_ok": served, "tokens": tokens,
                          "decode_launch_sites": sites}
        # (d) a swap on the fused engine raises the JAX refusal
        try:
            eng.swap_weights({})
            check(False, "(d) a swap on a fused engine did not raise")
        except MXNetError as e:
            check("serves fused int8 decode" in str(e), f"(d) refusal: {e}")
        out["swap"] = swap_deploy(torch, args, rng, net)
        # (e) drain with 4 long requests in flight
        long = [dict(p, max_new_tokens=200) for p in payloads[:4]]
        with ThreadPoolExecutor(4) as pool:
            inflight = [pool.submit(http_json, fe.url, "/generate", p) for p in long]
            deadline = time.monotonic() + 120
            while eng.stats()["slots_in_use"] < len(long):
                check(time.monotonic() < deadline, "(e) the requests were never admitted")
                time.sleep(0.001)
            code, doc = http_json(fe.url, "/drain", {})
            check(code == 200 and doc == {"ok": True, "draining": True}, f"(e) /drain {code}")
            code, hz = http_json(fe.url, "/healthz")
            check(code == 503 and hz["draining"] is True, f"(e) /healthz {code} {hz}")
            code, doc = http_json(fe.url, "/generate", payloads[0])
            check(code == 503, f"(e) /generate after /drain: {code} {doc}")
            finished = [f.result() for f in inflight]
        check(all(c == 200 and d["status"] == "ok" and len(d["generated_ids"]) == 200
                  for c, d in finished),
              f"(e) in-flight requests: {[(c, d.get('status')) for c, d in finished]}")
        out["drain"] = [d["status"] for _, d in finished]
        counts = launches()
        counts["routes"] = gemv_routes()
    finally:
        client.shutdown()
        fe.stop()
        eng.shutdown(drain=False, timeout=300)
        tmetrics.disable()
    for kind in ("fused_block_paged", "fused_head"):
        check(counts.get(kind, 0) > 0, f"http_serve: {kind} never launched")
    check(counts["routes"]["warp"] > 0 and counts["routes"]["mma"] > 0,
          f"http_serve: K3 routes {counts['routes']}")
    # (b) against eager scores on the card and the CPU twin's scores
    eager = InferenceEngine(net, max_batch_size=1, max_len=256, paged=False)
    eager._eager = True
    cpu = InferenceEngine(cpu_net, max_batch_size=1, max_len=256, paged=False)
    worst = 0.0
    for s, d in zip(seqs, alone):
        e = eager.score(s)
        check(d["token_logprobs"] == e["token_logprobs"],
              f"(b) graph score of {len(s)} tokens != the eager score on the card")
        c = cpu.score(s)["token_logprobs"]
        err = max(abs(a - b) for a, b in zip(d["token_logprobs"], c))
        worst = max(worst, err)
        check(err <= SCORE_TOL, f"(b) score of {len(s)} tokens: {err} from the CPU twin")
    out["score_vs_cpu_max_abs"] = worst
    out["launches"] = counts
    emit({"http_serve": out})
    return counts


def swap_deploy(torch, args, rng, net):
    """(d): an unfused int8 engine (``multi_token=1``) over two fresh
    models of ``net``'s config behind its own frontend; net B's weights
    published and deployed by ``POST /weights`` while a request decodes.
    Returns the deploy's numbers."""
    import shutil

    from mxnet_tpu_torch import _build
    from mxnet_tpu_torch.contrib.quantization import quantize_net
    from mxnet_tpu_torch.models import GPTModel
    from mxnet_tpu_torch.serve import (HTTPFrontend, InferenceEngine, publish_weights,
                                       snapshot_params)
    pub = _build.BUILD_DIR.parent / "http_serve_weights"
    shutil.rmtree(pub, ignore_errors=True)
    vocab = net.cfg.vocab_size
    net_a = quantize_net(GPTModel(net.cfg, device=net.device).init_weights(args.seed + 20))
    net_b = quantize_net(GPTModel(net.cfg, device=net.device).init_weights(args.seed + 21))
    publish_weights(str(pub), snapshot_params(net_b))
    prompts = [rng.randint(0, vocab, int(n)).tolist() for n in rng.randint(8, 33, 4)]
    kw = dict(max_batch_size=8, max_len=256, multi_token=1)
    eng = InferenceEngine(net_a, **kw).start()
    fe = HTTPFrontend(eng, host="127.0.0.1", port=0).start()
    applied = []
    copy = eng._copy_weights

    def timed_copy(staged):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        copy(staged)
        torch.cuda.synchronize()
        applied.append((time.perf_counter() - t0) * 1e3)

    eng._copy_weights = timed_copy
    try:
        warmed = warm(eng)
        before = [eng.generate(p, 16).generated_ids for p in prompts]
        eng._step_delay = 0.05      # the request outlasts the weights' read
        h = eng.submit(prompts[0], 200)
        while h.status == "queued":
            time.sleep(0.001)
        t0 = time.perf_counter()
        code, doc = http_json(fe.url, "/weights", {"dir": str(pub)})
        deploy_s = time.perf_counter() - t0
        check(code == 200 and doc == {"ok": True, "model": "default", "version": 1},
              f"(d) POST /weights: {code} {doc}")
        check(not h.done(), "(d) the request finished before the swap landed")
        r = h.result(timeout=600)
        eng._step_delay = 0.0
        check(r.ok and len(r.generated_ids) == 200,
              f"(d) the request in flight: {r.status} {len(r.generated_ids)} tokens")
        after = [eng.generate(p, 16).generated_ids for p in prompts]
        no_capture_since(eng, warmed, "http_serve (d) swap")
        code, hz = http_json(fe.url, "/healthz")
        check(code == 200 and hz["models"] == {"default": 1}, f"(d) /healthz {code} {hz}")
    finally:
        fe.stop()
        eng.shutdown(drain=False, timeout=300)
    ref = InferenceEngine(net_b, **kw).start()
    try:
        warm(ref)
        want = [ref.generate(p, 16).generated_ids for p in prompts]
    finally:
        ref.shutdown()
    check(after == want, "(d) after the swap the tokens differ from a fresh engine on net B")
    check(after != before, "(d) the swap changed no token")
    shutil.rmtree(pub, ignore_errors=True)
    return {"deploy_s": deploy_s, "apply_ms": applied, "swapped_request_tokens": 200,
            "captures": warmed["captures"]}


# the three dispatch modes of the capture comparison: (name, eager, lookahead)
DISPATCH_MODES = (("eager", True, False), ("captured", False, False),
                  ("captured+lookahead", False, True))
# trials per mode (tokens/s: median, min and max); paged B eager, several
# seconds a trial, takes one
MODE_TRIALS = 3
# the contiguous window's 12 requests are submitted this many times a trial,
# so that a trial lasts seconds and not a fraction of one
CONTIGUOUS_ROUNDS = 5


def dispatch_modes(torch, args, net, window):
    """One serving window three ways in one call: eager dispatch without
    lookahead (``engine._eager``, the port before graphs), captured graphs
    without lookahead, and captured graphs with lookahead (the default).
    ``window`` is ``"contiguous"`` (serve()'s 12 requests on its engine,
    CONTIGUOUS_ROUNDS times over) or ``"paged_B"`` (serve_paged's phase B:
    8 greedy long prompts, 160 pages, preemption). Per mode: ms per decode
    substep and tokens/s (median, min and max of MODE_TRIALS trials; one
    for paged B eager), and the greedy requests once more under the
    profiler (idle share, unless the trace dropped kernels). Every mode
    warms up first and captures nothing while serving; the contiguous
    window's tokens are equal in all modes (paged B's resumes re-prefill
    at other points when the timing moves, so its tokens are reported)."""
    import numpy as np

    from mxnet_tpu_torch.serve import InferenceEngine
    if window == "contiguous":
        prompts, temps, new = contiguous_requests(torch, args, net)
        seeds = [1000 + i for i in range(len(prompts))] * CONTIGUOUS_ROUNDS
        prompts, temps = prompts * CONTIGUOUS_ROUNDS, temps * CONTIGUOUS_ROUNDS
        kw = dict(max_batch_size=8, max_len=512, paged=False)
    else:
        rng = np.random.RandomState(args.seed + 2)
        prompts = [rng.randint(0, net.cfg.vocab_size, int(n)).tolist()
                   for n in rng.randint(300, 701, 8)]
        temps, new, seeds = [0.0] * 8, 128, list(range(2000, 2008))
        kw = dict(max_batch_size=8, max_len=1024, num_pages=PAGED_B_PAGES,
                  prefix_cache=False, paged=True, page_size=16)
    greedy = [p for p, t in zip(prompts, temps) if t == 0]
    rows, tokens = {}, {}
    for name, eager, lookahead in DISPATCH_MODES:
        t_mode = time.perf_counter()
        eng = InferenceEngine(net, multi_token=4, fused=True, lookahead=lookahead, **kw)
        eng._eager = eager
        eng.start()
        try:
            warmed = warm(eng)
            trials = []
            for _ in range(1 if window == "paged_B" and eager else MODE_TRIALS):
                before = eng.stats()
                t0 = time.perf_counter()
                hs = [eng.submit(p, new, temperature=t, seed=sd)
                      for p, t, sd in zip(prompts, temps, seeds)]
                res = [h.result(timeout=900) for h in hs]
                wall = time.perf_counter() - t0
                after = eng.stats()
                check(all(r.ok and len(r.generated_ids) == new for r in res),
                      f"{window} {name}: a request failed")
                subs = after["decode_substeps"] - before["decode_substeps"]
                trials.append({"tokens_per_s": sum(len(r.generated_ids) for r in res) / wall,
                               "ms_per_substep": (after["decode_s"] - before["decode_s"])
                               / subs * 1e3, "wall_s": wall,
                               "preemptions": after.get("preemptions", 0)
                               - before.get("preemptions", 0)})
                tokens.setdefault(name, [r.generated_ids for r in res])
            profiled = device_share(torch, eng, greedy, new)
            no_capture_since(eng, warmed, f"{window} {name}")
        finally:
            eng.shutdown(drain=True, timeout=900)
        tps = sorted(t["tokens_per_s"] for t in trials)
        rows[name] = {
            "tokens_per_s": statistics.median(tps), "tokens_per_s_min": tps[0],
            "tokens_per_s_max": tps[-1],
            "ms_per_substep": statistics.median(t["ms_per_substep"] for t in trials),
            "trials": trials, "warmup_s": warmed["last_warmup_s"],
            "captures": warmed["captures"],
            "idle_share": (profiled or {}).get("idle_share", "not measured"),
            "profiled": profiled, "mode_s": time.perf_counter() - t_mode}
    same = [tokens[name] == tokens["eager"] for name, _, _ in DISPATCH_MODES]
    if window == "contiguous":
        check(all(same), f"{window}: tokens differ between dispatch modes")
    emit({f"dispatch_modes_{window}": {"modes": rows, "tokens_equal_to_eager": same,
                                        "requests": len(prompts), "new_tokens_each": new,
                                        "trials": MODE_TRIALS, **kw}})
    return rows


def quant_bytes(torch, net):
    """Bytes of a quantized model's weight tables and scales: the blocks'
    QuantizedDense layers and the tied head."""
    from mxnet_tpu_torch.contrib.quantization import QuantizedDense
    blocks = sum(table_bytes(m.w_q, m.w_scale) for m in net.modules()
                 if isinstance(m, QuantizedDense))
    w, s, _ = net.head_weights()
    return {"blocks": blocks, "head": table_bytes(w, s), "total": blocks + table_bytes(w, s)}


def int4_stage(torch, args, timer, gen, int8_bytes):
    """The int4 serving path: GPT-2 small from the same ``--seed`` under
    ``quantize_net(bits=4, fused_decode=True)``. K4 and the int4 lanes of
    K5, K6, K7 and K8 against their plain versions, then the contiguous
    phase, paged phase A (K6) and paged phase C (K7), each with its peak
    device memory. Returns ({phase: launch counts}, {kernel: row})."""
    from mxnet_tpu_torch.contrib.quantization import quantize_net
    from mxnet_tpu_torch.models import GPT2_SMALL, GPTModel
    from mxnet_tpu_torch.ops.fused_block_gemv import pack_gpt_block
    with torch.no_grad():
        net = GPTModel(GPT2_SMALL, device="cuda").init_weights(args.seed)
        quantize_net(net, bits=4, fused_decode=True)
        check(all(blk._fused_pack is not None and blk._fused_pack["blocks"] == (128,) * 4
                  for blk in net.blocks), "int4 GPT-2 small: a block is not packed int4")
        pack = pack_gpt_block(net.blocks[0], eps=net.cfg.layer_norm_eps)
        rows = {"K4": kernel_gemv(torch, timer, gen, 4), "K5": kernel_k5(torch, timer, gen, pack),
                "K8": kernel_k8(torch, timer, gen, net.head_weights()),
                "K8_lanes": kernel_k8_lanes(torch, timer, gen, net.head_weights())}
        k67 = kernel_k6_k7(torch, timer, gen, pack)
        rows["K6"], rows["K7"] = k67["K6"], k67["K7"]
        cpu_net = GPTModel(GPT2_SMALL, device="cpu").init_weights(args.seed)
        quantize_net(cpu_net, bits=4, fused_decode=True)
    emit({"int4_kernels": {"k4": rows["K4"], "k5": rows["K5"], "k8": rows["K8"],
                           "k8_lanes": rows["K8_lanes"], "k6_k7": k67}})
    emit({"quantized_weight_bytes": {"int8": int8_bytes, "int4": quant_bytes(torch, net)}})
    counts, mem = {}, {}
    torch.cuda.reset_peak_memory_stats()
    counts["contiguous"] = serve(torch, args, net, cpu_net, cpu_tokens=INT4_CPU_TOKENS)
    mem["contiguous"] = torch.cuda.max_memory_allocated() / 1e9
    del cpu_net
    for phase in "AC":
        torch.cuda.reset_peak_memory_stats()
        counts[phase] = serve_paged(torch, args, net, phase)
        mem[phase] = torch.cuda.max_memory_allocated() / 1e9
    emit({"int4_peak_mem_gb": mem})
    return counts, rows


def gpt2_bf16(torch, args, device, bits):
    """bf16 GPT-2 small from ``--seed`` (dropout 0), quantized as
    ``bench.py``'s decode headlines quantize it: int8 with
    ``calib_mode='naive'`` on CALIB_BATCHES seeded batches of CALIB_SHAPE
    tokens, or (``bits`` 4) int4 with dynamic scales; fused decode."""
    import dataclasses

    import numpy as np

    from mxnet_tpu_torch.contrib.quantization import quantize_net
    from mxnet_tpu_torch.models import GPT2_SMALL, GPTModel
    cfg = dataclasses.replace(GPT2_SMALL, dtype=torch.bfloat16, dropout=0.0)
    with torch.no_grad():
        net = GPTModel(cfg, device=device).init_weights(args.seed)
    if bits == 4:
        return quantize_net(net, bits=4, fused_decode=True)
    rng = np.random.RandomState(args.seed + 11)
    calib = [rng.randint(0, cfg.vocab_size, CALIB_SHAPE).astype(np.int32)
             for _ in range(CALIB_BATCHES)]
    return quantize_net(net, calib_mode="naive", calib_data=calib, fused_decode=True)


def generate_headline(torch, args, net):
    """``bench.py``'s decode headline on the card: greedy ``generate()`` of
    8 prompts of 32 tokens, 128 new tokens, ``multi_token=8`` (the 256-row
    prefill takes the activation-quantized product at the calibrated
    scales for int8, the dequantized table for int4; every decode substep
    12 block launches and one fused head). Tokens in the vocab, the same
    on a second call, the launch counts of the path. Returns the counts."""
    import numpy as np

    from mxnet_tpu_torch.models import generate
    from mxnet_tpu_torch.ops.int8_gemv import dtype_lanes, launches, reset_launches
    tag, kinds, forbidden = lane(torch, net)
    B, P, new, K = 8, 32, 128, 8
    ids = torch.from_numpy(np.random.RandomState(args.seed + 12)
                           .randint(0, net.cfg.vocab_size, (B, P)).astype(np.int32))
    generate(net, ids[:, :8], 9, multi_token=K)               # warm-up
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = generate(net, ids, new, multi_token=K)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()
    counts["lanes"] = dtype_lanes()
    again = generate(net, ids, new, multi_token=K)
    substeps = -(-(new - 1) // K) * K
    check(tuple(out.shape) == (B, P + new), f"{tag}generate: shape {tuple(out.shape)}")
    check(bool(((out >= 0) & (out < net.cfg.vocab_size)).all()),
          f"{tag}generate: token outside the vocab")
    check(torch.equal(out, again), f"{tag}generate: a second call gave other tokens")
    check(counts.get(kinds["block"], 0) == LAYERS * substeps,
          f"{tag}generate: {counts.get(kinds['block'])} block launches != 12 x {substeps}")
    check(counts.get(kinds["head"], 0) == substeps + 1,
          f"{tag}generate: {counts.get(kinds['head'])} head launches != {substeps} + token 0")
    check(not any(counts.get(k) for k in forbidden), f"an int8 kind launched: {counts}")
    L = P + 1 + substeps
    kv = 2 * LAYERS * B * L * net.cfg.hidden_size * torch.finfo(net.cfg.dtype).bits // 8
    emit({tag + "generate": {"B": B, "prompt": P, "new_tokens": new, "multi_token": K,
                             "wall_s": wall, "tokens_per_s": B * new / wall,
                             "ms_per_substep": wall / (substeps + 1) * 1e3,
                             "kv_bytes": kv, "launches": counts}})
    return counts


def bf16_stage(torch, args, timer, gen):
    """The bf16 serving path of ``bench.py``'s decode headlines: bf16 GPT-2
    small from the same ``--seed``, int8 with naive calibration, then int4.
    The bf16 lanes of K3, K5, K6 and K7 (and of K4 and the int4 K5, K6, K7)
    against their plain versions (K3/K4's bf16 lane the f32 lane on
    x.float() bit for bit, K5 = K6 = K7 bitwise in bf16); then, int8: the
    ``generate()`` headline, the contiguous phase, paged A (K6) and paged B
    (K7 at L 1024 with preemption); int4: the ``generate()`` headline and
    the contiguous phase. Returns ({phase: launch counts}, {kernel: row})."""
    from mxnet_tpu_torch.ops.fused_block_gemv import pack_gpt_block
    bf16 = torch.bfloat16
    counts, rows = {}, {}
    net = gpt2_bf16(torch, args, "cuda", 8)
    eps = net.cfg.layer_norm_eps
    check(all(blk._fused_pack is not None for blk in net.blocks),
          "bf16 int8 GPT-2 small: a block is not packed")
    pack = pack_gpt_block(net.blocks[0], eps=eps)
    with torch.no_grad():
        rows["K3"] = kernel_gemv(torch, timer, gen, 8, bf16=True)
        rows["K5"] = kernel_k5(torch, timer, gen, pack, bf16=True)
        k67 = kernel_k6_k7(torch, timer, gen, pack, dtype=bf16)
    rows["K6"], rows["K7"] = k67["K6"], k67["K7"]
    emit({"bf16_kernels": {"k5": rows["K5"], "k6_k7": k67}})
    cpu_net = gpt2_bf16(torch, args, "cpu", 8)
    counts["generate"] = generate_headline(torch, args, net)
    counts["contiguous"] = serve(torch, args, net, cpu_net, cpu_tokens=BF16_CPU_TOKENS)
    del cpu_net
    counts["k1"] = serve_k1(torch, args, net, counts["contiguous"]["k4"])
    for phase in "AB":
        counts[phase] = serve_paged(torch, args, net, phase)
    del net
    torch.cuda.empty_cache()
    net = gpt2_bf16(torch, args, "cuda", 4)
    pack = pack_gpt_block(net.blocks[0], eps=eps)
    check(pack is not None and pack["blocks"] == (128,) * 4,
          "bf16 int4 GPT-2 small: block 0 is not packed int4")
    with torch.no_grad():
        rows["K4"] = kernel_gemv(torch, timer, gen, 4, bf16=True)
        rows["K5_int4"] = kernel_k5(torch, timer, gen, pack, bf16=True)
        k67 = kernel_k6_k7(torch, timer, gen, pack, dtype=bf16)
    emit({"bf16_int4_kernels": {"k5": rows["K5_int4"], "k6_k7": k67}})
    cpu_net = gpt2_bf16(torch, args, "cpu", 4)
    counts["int4_generate"] = generate_headline(torch, args, net)
    counts["int4_contiguous"] = serve(torch, args, net, cpu_net,
                                      cpu_tokens=BF16_INT4_CPU_TOKENS)
    del cpu_net, net
    torch.cuda.empty_cache()
    return counts, rows


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
    again = fa.flash_backward(q, k, v, o, lse, do, causal, scale)
    torch.cuda.synchronize()
    repeat = all(bool(torch.equal(a, b)) for a, b in zip((dq, dk, dv), again))
    check(repeat, f"K2 at {(B, H, T, S, D, causal, dtype)} gave other bits on a second run")
    del again
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
           "k2_repeat_bitwise": repeat,
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
    """K1/K2 at the training shape (timed), at head dim 128 (Llama's: 32
    heads, timed in bf16) and at the edge shapes; K2 must repeat bit for bit
    at every one."""
    rows = [flash_case(torch, timer, gen, TRAIN_B, 12, TRAIN_T, TRAIN_T, 64, True,
                       torch.bfloat16, timed=True, faults=True),
            flash_case(torch, timer, gen, 2, 12, TRAIN_T, TRAIN_T, 64, True,
                       torch.float32, timed=True),
            flash_case(torch, timer, gen, 4, 32, TRAIN_T, TRAIN_T, 128, True,
                       torch.bfloat16, timed=True)]
    for dtype in (torch.bfloat16, torch.float32):
        for B, H, T, S, D, causal in ((2, 12, 1000, 1000, 64, True),   # ragged
                                      (2, 12, 256, 512, 64, True),     # end-aligned
                                      (2, 12, 1024, 1024, 40, False),  # padded head dim
                                      (1, 8, 1024, 1024, 128, True)):  # head dim 128
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


def gpt2_train_config(dtype, dropout):
    """GPT-2 small in ``dtype`` at ``dropout`` (DEFAULT_DROPOUT is
    ``GPTConfig()``'s own)."""
    from mxnet_tpu_torch.models import GPTConfig
    return GPTConfig(dropout=dropout, dtype=dtype)


def headline_schedule():
    """The dropout-0.1 headline's learning rate: linear warmup from
    TRAIN_LR / 10 over 2 updates, then cosine down to TRAIN_LR / 10 at the
    last profiled step."""
    from mxnet_tpu_torch.lr_scheduler import CosineScheduler
    return CosineScheduler(max_update=1 + TRAIN_STEPS + PROFILE_STEPS, base_lr=TRAIN_LR,
                           warmup_steps=2, warmup_begin_lr=TRAIN_LR / 10,
                           final_lr=TRAIN_LR / 10)


def sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def dropout_device_ms(torch, step, ids, labels):
    """One more step under ``torch.profiler`` with host and device
    activity, every ``npx.dropout`` call inside a ``record_function``
    range: the device time of the kernels launched by the forward sites
    (mask and scale) and by their backward nodes (``_DropoutBackward``),
    in ms, or None when the profiler attributes no device time to them."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from mxnet_tpu_torch import numpy_extension as npx
    real = npx.dropout

    def ranged(*a, **k):
        with record_function("mx_dropout"):
            return real(*a, **k)
    torch.cuda.synchronize()
    npx.dropout = ranged
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step(ids, labels)
            torch.cuda.synchronize()
    finally:
        npx.dropout = real
    from torch.autograd import DeviceType
    fwd = bwd = 0.0
    nf = nb = 0
    # host-side ranges only: each range also shows as a device annotation
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        if e.name == "mx_dropout":
            fwd += e.device_time_total
            nf += 1
        elif e.name.startswith("autograd::engine::evaluate_function: _DropoutBackward"):
            bwd += e.device_time_total
            nb += 1
    if fwd + bwd <= 0:
        return None
    return {"sites": nf, "backward_nodes": nb, "forward_ms": fwd / 1e3,
            "backward_ms": bwd / 1e3, "total_ms": (fwd + bwd) / 1e3}


def train_profile(torch, step, ids, labels, device, steps=PROFILE_STEPS):
    """``steps`` training steps under ``torch.profiler`` (device activity
    only): device busy time against host wall time, and device time by
    kernel (flash_fwd, flash_bwd, GEMM, other)."""
    from torch.profiler import ProfilerActivity, profile
    sync(torch, device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(ids, labels)
        sync(torch, device)
        wall = time.perf_counter() - t0
    spans = device_spans(prof)
    if not spans:
        return None
    busy = busy_us(spans)
    by_kernel, by_name = {}, {}
    for a, b, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e3
        low = name.lower()
        if "flash_fwd_" in name:
            key = "flash_fwd"
        elif any(k in name for k in ("flash_dkdv_", "flash_dq_", "flash_bwd_", "bwd_prep",
                                     "bwd_cast")):
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


def train(torch, args, dropout, device="cuda"):
    """The training main path: bf16 GPT-2 small through ``TrainStep`` at
    ``dropout`` (``device='cpu'`` rehearses it with the plain versions).
    At dropout above 0 the rate follows ``headline_schedule()`` and the
    profile gets a ``dropout`` entry (the sites' device time in a step)."""
    from mxnet_tpu_torch import optimizer, parallel
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models import GPTModel
    from mxnet_tpu_torch.ops.int8_gemv import launches, reset_launches
    cfg = gpt2_train_config(torch.bfloat16, dropout)
    B, T = TRAIN_B, TRAIN_T
    net = GPTModel(cfg, device=device).init_weights(args.seed)
    ids, labels = train_batch(args, cfg.vocab_size, B, T)
    ids, labels = torch.from_numpy(ids).to(device), torch.from_numpy(labels).to(device)
    sched = headline_schedule() if dropout > 0 else None
    step = parallel.TrainStep(net, SoftmaxCrossEntropyLoss(),
                              optimizer.Adam(learning_rate=TRAIN_LR, lr_scheduler=sched),
                              example_inputs=[ids])
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
    lrs = [sched(n) for n in range(1, 2 + TRAIN_STEPS)] if sched else [TRAIN_LR]
    losses = [first] + [x.float().item() for x in losses]
    check(all(math.isfinite(x) for x in losses), f"non-finite training loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    for kind in ("flash_fwd", "flash_bwd"):
        check(counts.get(kind, 0) == LAYERS * TRAIN_STEPS,
              f"{kind} launches {counts.get(kind)} != {LAYERS} x {TRAIN_STEPS} steps")
    L, D, V = cfg.num_layers, cfg.hidden_size, cfg.vocab_size
    analytic = 3 * (L * (24 * B * T * D * D + 2 * B * T * T * D) + 2 * B * T * D * V)
    ms = dt / TRAIN_STEPS * 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    profiled = train_profile(torch, step, ids, labels, device) if on_card else None
    if profiled is not None and dropout > 0:
        profiled["dropout"] = dropout_device_ms(torch, step, ids, labels) or "not measured"
    emit({"train": {"model": "gpt2-small", "dtype": "bfloat16", "B": B, "T": T,
                    "dropout": dropout, "optimizer": "adam",
                    "lr_scheduler": "cosine, linear warmup" if sched else None,
                    "lr": lrs, "steps": TRAIN_STEPS,
                    "warmup_s": warm_s, "ms_per_step": ms,
                    "tokens_per_s": B * T * TRAIN_STEPS / dt,
                    "mfu_analytic": analytic / (dt / TRAIN_STEPS) / BF16_FLOP_PER_S,
                    "losses": losses, "launches": counts, "peak_mem_gb": peak}})
    emit({"train_profiled_window": {"rate": dropout, **profiled}
          if profiled is not None else "not measured"})
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


def sgd_steps(torch, args, device, dtype, steps, B, T, dropout):
    """``steps`` f32/bf16 GPT-2-small TrainSteps with SGD (momentum 0.9)
    from ``--seed`` at ``dropout`` (step t's masks from key(t) on
    ``device``): (losses, gradients of each step, parameters after)."""
    from mxnet_tpu_torch import optimizer, parallel
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.interop import params_to_numpy
    from mxnet_tpu_torch.models import GPTModel
    cfg = gpt2_train_config(dtype, dropout)
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


def mask_bits_card_vs_cpu(torch, card, B, T, D):
    """Keep masks drawn on the card and on the CPU: one GPT-2 site at
    [B, T, D] under step 1's key of site 3 (a device key and a host key),
    and ``_keep_bits_at`` over
    positions just past 2**31 and below 2**32 with and without a random
    high word. Returns the count of positions compared; raises on one
    differing bit."""
    from mxnet_tpu_torch import _prng
    from mxnet_tpu_torch import numpy_extension as npx
    key = _prng.fold_in(_prng.key(1), 3)
    want = npx._cheap_keep_mask(key, (B, T, D), 0.9)
    # the key on the card, and the host key's words as kernel scalars (TrainStep's)
    for k in (key.to(card), key):
        got = npx._cheap_keep_mask(k, (B, T, D), 0.9, device=card).cpu()
        check(torch.equal(got, want), f"site keep masks differ between {card} "
              f"(key on {k.device}) and the CPU")
    n = want.numel()
    g = torch.Generator().manual_seed(5)
    for lo in (2 ** 31, 2 ** 32 - 2 ** 20):
        idx = lo + torch.arange(2 ** 20, dtype=torch.int64)
        hi = torch.randint(0, 2 ** 32, idx.shape, generator=g, dtype=torch.int64)
        for h in (None, hi):
            got = npx._keep_bits_at(key.to(card), idx.to(card), 0.9,
                                    None if h is None else h.to(card)).cpu()
            check(torch.equal(got, npx._keep_bits_at(key, idx, 0.9, h)),
                  f"keep bits at {lo}+ (high word: {h is not None}) differ on {card}")
            n += idx.numel()
    return n


def shifted_stream(_prng):
    """A planted fault: ``KeySupply`` handing site k the key of site k + 1."""
    def next_key(self):
        k = _prng.fold_in(self.base_key, self.counter + 1)
        self.counter += 1
        return k
    return next_key


def train_card_vs_cpu(torch, args, dropout, card="cuda"):
    """f32 GPT-2 small at B 2 and ``dropout``: 2 TrainSteps with SGD
    (momentum 0.9) on the card (kernels) and on the CPU (plain versions)
    from the same weights, batch and step keys, compared on losses, each
    step's gradients leaf by leaf and the parameters after; a K2 whose
    outputs are 1% too large must fail the gradient check, and at dropout
    above 0 so must a key stream that hands site k the key of site k + 1,
    and the keep masks of one site (and at positions past 2**31) must be
    the same bits on both. Then the bf16 and f32 models' step-1 gradients
    on the card, leaf by leaf. Prints the readings, then checks them."""
    from mxnet_tpu_torch import _prng, _random
    from mxnet_tpu_torch.ops import attention as fa
    B, T, steps = 2, TRAIN_T, 2
    out, runs = {"dropout": dropout}, {}
    for dev in (card, "cpu"):
        t0 = time.perf_counter()
        runs[dev] = sgd_steps(torch, args, dev, torch.float32, steps, B, T, dropout)
        out[f"{dev}_s"] = time.perf_counter() - t0
    (lc, gc, pc), (lh, gh, ph) = runs[card], runs["cpu"]
    grad_errs = [worst(leaf_errors(a, b)) for a, b in zip(gc, gh)]
    pdiff = max(float(abs(pc[n] - ph[n]).max()) for n in ph)

    real = fa.flash_backward

    def too_large(*a):
        return tuple(t * 1.01 for t in real(*a))
    fa.flash_backward = too_large
    try:
        _, (fault,), _ = sgd_steps(torch, args, card, torch.float32, 1, B, T, dropout)
    finally:
        fa.flash_backward = real
    fault_err = worst(leaf_errors(fault, gh[0]))
    stream_err = None
    if dropout > 0:
        real_next = _random.KeySupply.next
        _random.KeySupply.next = shifted_stream(_prng)
        try:
            (ls,), (shifted,), _ = sgd_steps(torch, args, card, torch.float32, 1, B, T, dropout)
        finally:
            _random.KeySupply.next = real_next
        stream_err = worst(leaf_errors(shifted, gh[0]))
        out.update({"planted_shifted_stream_grad_rel_l2": stream_err,
                    "planted_shifted_stream_loss": ls,
                    "mask_positions_equal": mask_bits_card_vs_cpu(torch, card, TRAIN_B, T, 768)})

    (l16,), (g16,), _ = sgd_steps(torch, args, card, torch.bfloat16, 1, B, T, dropout)
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
    check(stream_err is None or stream_err["rel_l2"] > CARD_CPU_GRAD_TOL,
          f"a key stream shifted by one site passes the card/CPU gradient check: {stream_err}")
    check(abs(l16 - lc[0]) <= 2e-2 * abs(lc[0]), f"bf16/f32 step-1 losses {l16} {lc[0]}")
    check(max(bf16_err.values()) <= BF16_GRAD_TOL,
          f"bf16/f32 step-1 gradients differ: {worst(bf16_err)} > {BF16_GRAD_TOL}")


def timed_writes(mgr):
    """Wrap ``mgr``'s file writer (the background thread's work) to record
    each write's seconds in the returned list."""
    real, secs = mgr._write_snapshot, []

    def write(*a, **k):
        t0 = time.perf_counter()
        try:
            return real(*a, **k)
        finally:
            secs.append(time.perf_counter() - t0)
    mgr._write_snapshot = write
    return secs


def dir_bytes(path):
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def resume_run(torch, mgr, run, snapshot, steps=2):
    """Save asynchronously, run ``steps`` steps, restore, run them again:
    (readings, first losses, second losses, state before, state after)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = mgr.save(0)
    stall = time.perf_counter() - t0
    first = [run() for _ in range(steps)]
    before = snapshot()
    t0 = time.perf_counter()
    mgr.restore()
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    second = [run() for _ in range(steps)]
    torch.cuda.synchronize()
    return ({"stall_s": stall, "restore_s": restore_s, "bytes": None, "path": path},
            first, second, before, snapshot())


def checkpoint_resume(torch, args, device="cuda"):
    """Checkpoint resume on the card, bf16 GPT-2 small at the default
    dropout, B 16, T 1024, Adam: ``TrainStep`` runs 2 steps, saves
    asynchronously in the sharded layout (``state_arrays``, the step count
    in ``extra_state``), runs 2 more, restores and runs those 2 again; then
    the eager ``Trainer`` path (masks from the global key, restored from the
    manifest) through the local layout. Losses, parameters and optimizer
    states must be the same bits; prints the checkpoint bytes, the stall
    of the training thread in ``save``, the background write's seconds and
    the restore's."""
    import shutil
    from mxnet_tpu_torch import _build, optimizer, parallel, random
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models import GPTModel
    root = _build.BUILD_DIR.parent / "checkpoint_resume"
    shutil.rmtree(root, ignore_errors=True)
    cfg = gpt2_train_config(torch.bfloat16, DEFAULT_DROPOUT)
    B, T = TRAIN_B, TRAIN_T
    ids, labels = train_batch(args, cfg.vocab_size, B, T)
    ids, labels = torch.from_numpy(ids).to(device), torch.from_numpy(labels).to(device)
    ce = SoftmaxCrossEntropyLoss()
    out = {}

    net = GPTModel(cfg, device=device).init_weights(args.seed)
    step = parallel.TrainStep(net, ce, optimizer.Adam(learning_rate=TRAIN_LR),
                              example_inputs=[ids])
    mgr = CheckpointManager(str(root / "sharded"), net=net, sharded=True, blocking=False,
                            state_arrays=step.state_arrays,
                            write_state_arrays=step.write_state_arrays,
                            extra_state=lambda: {"step": step._step},
                            restore_extra=lambda e: setattr(step, "_step", e["step"]))
    writes = timed_writes(mgr)
    for _ in range(2):
        step(ids, labels)

    def step_state():
        return ([p.detach().clone() for p in net.parameters()],
                [t.clone() for t in step.state_arrays().values()])
    read, first, second, before, after = resume_run(
        torch, mgr, lambda: step(ids, labels), step_state)
    read.update(bytes=dir_bytes(root / "sharded"), write_s=writes, step=step._step)
    out["train_step_sharded"] = (read, first, second, before, after)
    del net, step, mgr, before, after
    torch.cuda.empty_cache()

    net = GPTModel(cfg, device=device).init_weights(args.seed).train()
    trainer = Trainer(dict(net.named_parameters()), "adam", {"learning_rate": TRAIN_LR})
    mgr = CheckpointManager(str(root / "local"), net=net, trainer=trainer, blocking=False)
    writes = timed_writes(mgr)
    random.seed(args.seed)

    def eager():
        loss = ce(net(ids), labels)
        loss.backward(torch.ones_like(loss))
        trainer.step(B)
        return loss.detach().mean()

    def trainer_state():
        return ([p.detach().clone() for p in net.parameters()],
                [t.clone() for i in sorted(trainer._states) for t in trainer._states[i]])
    for _ in range(2):
        eager()
    read, first, second, before, after = resume_run(torch, mgr, eager, trainer_state)
    read.update(bytes=dir_bytes(root / "local"), write_s=writes)
    out["trainer_local"] = (read, first, second, before, after)
    del net, trainer, mgr

    report = {}
    for name, (read, first, second, before, after) in out.items():
        same = (all(torch.equal(a, b) for a, b in zip(first, second)),
                all(torch.equal(a, b) for a, b in zip(before[0], after[0])),
                all(torch.equal(a, b) for a, b in zip(before[1], after[1])))
        report[name] = {**read, "losses": [float(x) for x in first],
                        "losses_again": [float(x) for x in second],
                        "same_bits": {"losses": same[0], "parameters": same[1],
                                      "optimizer_states": same[2]},
                        "state_tensors": len(before[1])}
    emit({"checkpoint_resume": {"model": "gpt2-small", "dtype": "bfloat16", "B": B, "T": T,
                                "dropout": DEFAULT_DROPOUT, **report}})
    shutil.rmtree(root, ignore_errors=True)
    for name, r in report.items():
        check(all(r["same_bits"].values()),
              f"{name}: resume is not the same bits as the run: {r['same_bits']}")
        check(r["write_s"] and r["bytes"] > 0, f"{name}: no checkpoint was written")


GLUON_B, GLUON_STEPS, GLUON_LR = 128, 20, 1e-3
GLUON_CPU_TOL = 1e-5          # README losses, card against the CPU port (relative)
ATTN_B, ATTN_T, ATTN_D, ATTN_HEADS = 4, 1024, 768, 12
ATTN_CPU_TOL = 1e-4           # f32 gradients at B 1, card against the CPU port (rel L2)


def host_ms(torch, fn, device, iters=10):
    """Mean ms of ``fn()`` on the host clock around synchronised work."""
    fn()
    sync(torch, device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync(torch, device)
    return (time.perf_counter() - t0) / iters * 1e3


def readme_train(torch, args, device, hybridize, follow=None):
    """The README's first program at its own widths on ``device``. With
    ``follow`` (another run's ``snaps``) each step first loads that run's
    weights, so each loss is computed from the same weights. Returns
    {losses, snaps (the weights before each step), params, first_s, ms
    (per later step), net, x}."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon import Trainer, nn
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    rng = np.random.RandomState(args.seed)
    X = rng.rand(GLUON_B, 784).astype("float32")
    Y = rng.randint(0, 10, GLUON_B).astype("int32")
    with mx.Device(torch.device(device)):
        mx.random.seed(args.seed)
        net = nn.HybridSequential()
        net.add(nn.Dense(128, activation="relu"), nn.Dense(10))
        net.initialize(mx.init.Xavier())
        if hybridize:
            net.hybridize(static_alloc=True)
        trainer = Trainer(net.collect_params(), "adam", {"learning_rate": GLUON_LR})
        loss_fn = SoftmaxCrossEntropyLoss()
        x, y = mx.np.array(X), mx.np.array(Y)
        losses, marks, snaps = [], [], []
        sync(torch, device)
        t0 = time.perf_counter()
        for i in range(GLUON_STEPS):
            if follow is not None:
                net.load_dict(follow[i])
            with autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            snaps.append({k: p.data().copy() for k, p in net.collect_params().items()})
            trainer.step(GLUON_B)
            losses.append(loss)
            sync(torch, device)
            marks.append(time.perf_counter())
        return {"losses": [l.asnumpy() for l in losses],
                "snaps": [{k: v.asnumpy() for k, v in snap.items()} for snap in snaps],
                "params": {k: p.data().asnumpy() for k, p in net.collect_params().items()},
                "first_s": marks[0] - t0,
                "ms": (marks[-1] - marks[0]) / (GLUON_STEPS - 1) * 1e3, "net": net, "x": x}


def attention_block(plain):
    """A user HybridBlock at GPT-2 small's width: LayerNorm, Dense 3 x D,
    causal attention over ATTN_HEADS heads, Dense D, residual. With
    ``plain`` the attention is the plain version, called directly."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import HybridBlock, nn
    from mxnet_tpu_torch.ndarray import apply
    from mxnet_tpu_torch.ops import attention as fa

    class AttentionBlock(HybridBlock):
        def __init__(self):
            super().__init__()
            self.ln = nn.LayerNorm(in_channels=ATTN_D)
            self.qkv = nn.Dense(3 * ATTN_D, flatten=False, in_units=ATTN_D)
            self.proj = nn.Dense(ATTN_D, flatten=False, in_units=ATTN_D)

        def forward(self, x):
            B, T, D = x.shape
            hd = D // ATTN_HEADS
            qkv = self.qkv(self.ln(x)).reshape(B, T, 3, ATTN_HEADS, hd).transpose(2, 0, 3, 1, 4)
            q, k, v = qkv[0], qkv[1], qkv[2]
            if plain:
                o = apply(lambda a, b, c: fa._reference_flash_forward(
                    a.float(), b.float(), c.float(), True, hd ** -0.5)[0].to(a.dtype), q, k, v)
            else:
                o = mx.ops.attention(q, k, v, causal=True)
            return x + self.proj(o.transpose(0, 2, 1, 3).reshape(B, T, D))

    return AttentionBlock()


def attention_step(torch, args, device, dtype, B, plain=False):
    """One recorded forward and backward of the attention block: returns
    ({leaf: f32 CPU gradient}, launches, ms, (forward + backward callable))."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.ops.int8_gemv import launches, reset_launches
    rng = np.random.RandomState(args.seed + 1)
    X = rng.randn(B, ATTN_T, ATTN_D).astype("float32")
    DY = rng.randn(B, ATTN_T, ATTN_D).astype("float32")
    with mx.Device(torch.device(device)):
        mx.random.seed(args.seed)
        net = attention_block(plain)
        net.initialize(mx.init.Xavier())
        if dtype == "bfloat16":
            net.cast("bfloat16")
        net.hybridize(static_alloc=True)
        x = mx.np.array(X).astype(dtype)
        dy = mx.np.array(DY).astype(dtype)

        def step():
            x.attach_grad()
            with autograd.record():
                loss = (net(x) * dy).astype("float32").sum()
            loss.backward()

        sync(torch, device)
        reset_launches()
        t0 = time.perf_counter()
        step()
        sync(torch, device)
        ms = (time.perf_counter() - t0) * 1e3
        counts = launches()
        grads = {n: p.grad()._data.detach().float().cpu()
                 for n, p in net.collect_params().items()}
        grads["x"] = x.grad._data.detach().float().cpu()
    return grads, counts, ms, step


def gluon_substrate(torch, args, device="cuda"):
    """Phase 8 (module docstring). ``device='cpu'`` rehearses it with the
    CPU as both sides."""
    import numpy as np
    from mxnet_tpu_torch import metrics
    on_card = torch.device(device).type == "cuda"
    t_phase = time.perf_counter()
    # (a) the README program
    eager = readme_train(torch, args, device, False)
    hyb = readme_train(torch, args, device, True)
    e_loss, e_net, h_net, x = eager["losses"], eager["net"], hyb["net"], eager["x"]
    check(all(np.array_equal(a, b) for a, b in zip(e_loss, hyb["losses"]))
          and all(np.array_equal(eager["params"][k], hyb["params"][k]) for k in hyb["params"]),
          "README program: hybridized losses or parameters differ from eager")

    def rel_err(losses):
        return [float(np.abs(a - b).max() / np.abs(b).max()) for a, b in zip(e_loss, losses)]
    # each CPU step from the card's weights before that step; the free run
    # drifts (Adam's first steps move a weight by lr x sign(g), so a
    # gradient near 0 whose sign the card and the CPU round apart moves it
    # by 2 lr), and is recorded
    rel = max(rel_err(readme_train(torch, args, "cpu", False, follow=eager["snaps"])["losses"]))
    check(rel <= GLUON_CPU_TOL, f"README program: card losses {rel} from the CPU port's")
    free = rel_err(readme_train(torch, args, "cpu", False)["losses"])
    check(e_loss[-1].mean() < e_loss[0].mean(), "README program: the loss did not fall")
    op = h_net._cached_op
    want = e_net(x).asnumpy()
    h_net(x)
    h_net(x)                           # eager warm-up, then capture
    was = metrics.enabled()
    metrics.enable()
    try:
        def counters():
            lab = {"block": "HybridSequential"}
            return (sum(metrics.get_sample_value("mxnet_recompilations_total",
                                                 dict(lab, kind=k)) or 0
                        for k in ("initial", "retrace")),
                    metrics.get_sample_value("mxnet_cachedop_cache_hits_total", lab) or 0)
        before, entries, replays = counters(), op.cache_size, op.replays
        got = h_net(x).asnumpy()
        after = counters()
    finally:
        (metrics.enable if was else metrics.disable)()
    check(after[0] == before[0] and after[1] == before[1] + 1 and op.cache_size == entries,
          f"predict after warm-up: recompilations/cache hits {before} -> {after}")
    check(op.replays == replays + (1 if on_card else 0),
          f"predict after warm-up replayed {op.replays - replays} graphs")
    check(np.array_equal(got, want), "predict replay differs from the eager forward")
    predict = {"eager_ms": host_ms(torch, lambda: e_net(x), device),
               "replay_ms": host_ms(torch, lambda: h_net(x), device)}
    # (b) the attention block
    rows = {}
    for dtype in ("float32", "bfloat16"):
        got, counts, ms, step = attention_step(torch, args, device, dtype, ATTN_B)
        want = attention_step(torch, args, device, dtype, ATTN_B, plain=True)[0]
        for kind in ("flash_fwd", "flash_bwd"):
            check(counts.get(kind, 0) > 0, f"attention block {dtype}: {kind} never launched "
                  "from the tape")
        errs = {n: flash_errors(got[n], want[n]) for n in want}
        gated = [n for n in want if dtype == "float32" or n != "x"]
        bad = [n for n in gated if not flash_within(got[n], want[n], dtype)]
        check(not bad, f"attention block {dtype}: gradients past K1/K2's gates: "
              f"{ {n: errs[n] for n in bad} }")
        prof = train_profile(torch, lambda *_: step(), None, None, device) if on_card else None
        share = None if prof is None else \
            (prof["kernel_ms"].get("flash_fwd", 0) + prof["kernel_ms"].get("flash_bwd", 0)) \
            / prof["device_busy_ms"]
        rows[dtype] = {"launches": {k: counts.get(k, 0) for k in ("flash_fwd", "flash_bwd")},
                       "first_fwd_bwd_ms": ms,
                       "fwd_bwd_ms": host_ms(torch, step, device, iters=3),
                       "k1_k2_device_share": share if share is not None else "not measured",
                       "worst_row_err": max(errs[n][2] for n in gated),
                       "input_grad_row_err": errs["x"][2]}
    card1 = attention_step(torch, args, device, "float32", 1)[0]
    cpu1 = attention_step(torch, args, "cpu", "float32", 1)[0]
    errs = leaf_errors(card1, cpu1)
    check(max(errs.values()) <= ATTN_CPU_TOL,
          f"attention block: f32 gradients at B 1 {worst(errs)} from the CPU port's")
    out = {"readme": {"B": GLUON_B, "steps": GLUON_STEPS, "losses_first_last":
                      [float(e_loss[0].mean()), float(e_loss[-1].mean())],
                      "card_vs_cpu_rel": rel, "free_running_cpu_rel_by_step": free,
                      "eager_ms_per_step": eager["ms"], "hybridized_ms_per_step": hyb["ms"],
                      "eager_first_step_s": eager["first_s"],
                      "hybridized_first_step_s": hyb["first_s"], "predict": predict},
           "attention_block": {"B": ATTN_B, "T": ATTN_T, "D": ATTN_D, "heads": ATTN_HEADS,
                               **rows, "card_vs_cpu_B1": worst(errs)},
           "phase_s": time.perf_counter() - t_phase}
    emit({"gluon_substrate": out})
    return {k: sum(r["launches"][k] for r in rows.values()) for k in ("flash_fwd", "flash_bwd")}


def head_row(head):
    """A kernels-line row of the tied head on the warp route: its 8-row
    numbers (the decode batch of a multi_token=1 engine), the 1-row time
    (token 0) beside them."""
    m8 = head["m8"]
    return {"max_abs_err": head["max_abs_err"], "ms": m8["ms"], "plain_ms": m8["plain_ms"],
            "bound_ms": m8["bound_ms"], "bound_by": m8["bound_by"],
            "library_ms": m8["library_ms"]}


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
    check(GPT2_SMALL.dropout == DEFAULT_DROPOUT,
          f"GPTConfig()'s dropout {GPT2_SMALL.dropout} != DEFAULT_DROPOUT {DEFAULT_DROPOUT}")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain/library in full f32
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    per_source = _build.build_all()
    # per kernel: its entry function, then its registers and spills
    logs = {n: [ln.strip() for ln in (_build.BUILD_DIR / f"{n}.log").read_text()
                .splitlines() if "entry function" in ln or "registers" in ln or "spill" in ln]
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
        k3 = kernel_gemv(torch, timer, gen, 8)
        k5 = kernel_k5(torch, timer, gen,
                       pack_gpt_block(net.blocks[0], eps=net.cfg.layer_norm_eps))
        k8 = kernel_k8(torch, timer, gen, net.head_weights())
        k8l = kernel_k8_lanes(torch, timer, gen, net.head_weights())
        k67 = kernel_k6_k7(torch, timer, gen,
                           pack_gpt_block(net.blocks[0], eps=net.cfg.layer_norm_eps))
        sampling = sampling_card(torch, args, timer)
    emit({"k3": k3, "k5": k5, "k8": k8, "k8_lanes": k8l, "k6_k7": k67})
    emit({"sampling": sampling})

    serve_counts = serve(torch, args, net, cpu_net)
    k1_counts = serve_k1(torch, args, net, serve_counts["k4"])
    paged_counts = {phase: serve_paged(torch, args, net, phase) for phase in "AB"}
    cs_counts = constrained_spec(torch, args, net, cpu_net)
    http_counts = http_serve(torch, args, net, cpu_net)
    del cpu_net
    t_modes = time.perf_counter()
    for window in ("contiguous", "paged_B"):
        dispatch_modes(torch, args, net, window)
    emit({"dispatch_modes_s": time.perf_counter() - t_modes})
    int8_bytes = quant_bytes(torch, net)
    del net
    torch.cuda.empty_cache()

    int4_counts, r4k = int4_stage(torch, args, timer, gen, int8_bytes)
    torch.cuda.empty_cache()
    b16_counts, r16k = bf16_stage(torch, args, timer, gen)
    emit({"kv_bytes_f32_bf16": {
        "contiguous": [serve_counts["kv_bytes"], b16_counts["contiguous"]["kv_bytes"]],
        "paged_A": [paged_counts["A"]["kv_bytes"], b16_counts["A"]["kv_bytes"]],
        "paged_B": [paged_counts["B"]["kv_bytes"], b16_counts["B"]["kv_bytes"]]}})

    k1, k2 = kernel_flash(torch, timer, gen)
    torch.cuda.empty_cache()
    train_counts = train(torch, args, DEFAULT_DROPOUT)   # this slice's path
    torch.cuda.empty_cache()
    train(torch, args, 0.0)
    torch.cuda.empty_cache()
    for dropout in (DEFAULT_DROPOUT, 0.0):
        train_card_vs_cpu(torch, args, dropout)
    torch.cuda.empty_cache()
    checkpoint_resume(torch, args)
    torch.cuda.empty_cache()
    gluon_counts = gluon_substrate(torch, args)

    def routes(*phases):
        return {r: sum(c["routes"][r] for c in phases) for r in ("warp", "mma")}

    r8 = routes(serve_counts, paged_counts["A"], paged_counts["B"], *cs_counts.values(),
                http_counts)

    def cs_launches(kind):
        return sum(c.get(kind, 0) for c in cs_counts.values())

    r4 = routes(int4_counts["contiguous"], int4_counts["A"], int4_counts["C"])
    emit({"gemv_routes": {"int8": r8, "int4": r4}})

    def lanes(keys, *phases):
        """Launches of the given dtype lanes over the given phases."""
        return sum(c["lanes"].get(k, 0) for c in phases for k in keys)

    b8 = [b16_counts[p] for p in ("generate", "contiguous", "A", "B")]
    b4 = [b16_counts[p] for p in ("int4_generate", "int4_contiguous")]
    emit({"bf16_lanes": {p: c["lanes"] for p, c in b16_counts.items()}})
    # block 0 takes bf16 x, blocks 1-11 f32 x; both lanes must run
    for key, phases in (("fused_block:x_bf16:kv_bf16", b8), ("fused_block:x_f32:kv_bf16", b8),
                        ("fused_block_int4:x_bf16:kv_bf16", b4),
                        ("fused_block_int4:x_f32:kv_bf16", b4)):
        check(lanes([key], *phases) > 0, f"the {key} lane never launched")
    kv16 = ("x_bf16:kv_bf16", "x_f32:kv_bf16")
    gemv8, gemv4 = "mxnet_tpu_torch/csrc/int8_gemv.cu", "mxnet_tpu_torch/csrc/int4_gemv.cu"
    head_src = "mxnet_tpu_torch/csrc/lm_head_sample.cu"
    emit({"gemv_heads_warp": {"int8": k3["head"], "int4": r4k["K4"]["head"],
                              "int8_bf16_x": r16k["K3"]["head"],
                              "int4_bf16_x": r16k["K4"]["head"]}})
    rows = []
    for name, src, replaces, launched, r in (
            ("int8_gemv", gemv8, "mxnet_tpu/ops/int8_gemv.py:113", r8["warp"], k3["warp"]),
            ("int8_gemv_mma", gemv8, "mxnet_tpu/ops/int8_gemv.py:113", r8["mma"], k3["mma"]),
            ("fused_block_decode", "mxnet_tpu_torch/csrc/fused_block_decode.cu",
             "mxnet_tpu/ops/fused_block_gemv.py:424",
             serve_counts.get("fused_block", 0) + cs_launches("fused_block"), k5),
            ("fused_block_decode_paged", "mxnet_tpu_torch/csrc/fused_block_decode_paged.cu",
             "mxnet_tpu/ops/fused_block_gemv.py:601",
             paged_counts["A"].get("fused_block_paged", 0) + cs_launches("fused_block_paged")
             + http_counts.get("fused_block_paged", 0), k67["K6"]),
            ("fused_block_decode_paged_dma",
             "mxnet_tpu_torch/csrc/fused_block_decode_paged_dma.cu",
             "mxnet_tpu/ops/fused_block_gemv.py:810",
             paged_counts["B"].get("fused_block_paged_dma", 0), k67["K7"]),
            ("lm_head_sample", "mxnet_tpu_torch/csrc/lm_head_sample.cu",
             "mxnet_tpu/ops/fused_block_gemv.py:1218",
             serve_counts.get("fused_head", 0) + http_counts.get("fused_head", 0), k8),
            ("int4_gemv", gemv4, "mxnet_tpu/ops/int8_gemv.py:186", r4["warp"], r4k["K4"]["warp"]),
            ("int4_gemv_mma", gemv4, "mxnet_tpu/ops/int8_gemv.py:186", r4["mma"],
             r4k["K4"]["mma"]),
            ("fused_block_decode_int4", "mxnet_tpu_torch/csrc/fused_block_decode.cu",
             "mxnet_tpu/ops/fused_block_gemv.py:424",
             int4_counts["contiguous"].get("fused_block_int4", 0), r4k["K5"]),
            ("fused_block_decode_paged_int4", "mxnet_tpu_torch/csrc/fused_block_decode_paged.cu",
             "mxnet_tpu/ops/fused_block_gemv.py:601",
             int4_counts["A"].get("fused_block_paged_int4", 0), r4k["K6"]),
            ("fused_block_decode_paged_dma_int4",
             "mxnet_tpu_torch/csrc/fused_block_decode_paged_dma.cu",
             "mxnet_tpu/ops/fused_block_gemv.py:810",
             int4_counts["C"].get("fused_block_paged_dma_int4", 0), r4k["K7"]),
            ("lm_head_sample_int4", "mxnet_tpu_torch/csrc/lm_head_sample.cu",
             "mxnet_tpu/ops/fused_block_gemv.py:1218",
             int4_counts["contiguous"].get("fused_head_int4", 0), r4k["K8"]),
            ("int8_gemv_bf16", gemv8, "mxnet_tpu/ops/int8_gemv.py:113",
             lanes(["gemv:warp:bf16"], *b8), r16k["K3"]["warp"]),
            ("int8_gemv_mma_bf16", gemv8, "mxnet_tpu/ops/int8_gemv.py:113",
             lanes(["gemv:mma:bf16"], *b8), r16k["K3"]["mma"]),
            ("fused_block_decode_bf16", "mxnet_tpu_torch/csrc/fused_block_decode.cu",
             "mxnet_tpu/ops/fused_block_gemv.py:424",
             lanes(["fused_block:" + k for k in kv16], *b8), r16k["K5"]),
            ("fused_block_decode_paged_bf16", "mxnet_tpu_torch/csrc/fused_block_decode_paged.cu",
             "mxnet_tpu/ops/fused_block_gemv.py:601",
             lanes(["fused_block_paged:" + k for k in kv16], b16_counts["A"]), r16k["K6"]),
            ("fused_block_decode_paged_dma_bf16",
             "mxnet_tpu_torch/csrc/fused_block_decode_paged_dma.cu",
             "mxnet_tpu/ops/fused_block_gemv.py:810",
             lanes(["fused_block_paged_dma:" + k for k in kv16], b16_counts["B"]), r16k["K7"]),
            ("int4_gemv_bf16", gemv4, "mxnet_tpu/ops/int8_gemv.py:186",
             lanes(["gemv_int4:warp:bf16"], *b4), r16k["K4"]["warp"]),
            ("int4_gemv_mma_bf16", gemv4, "mxnet_tpu/ops/int8_gemv.py:186",
             lanes(["gemv_int4:mma:bf16"], *b4), r16k["K4"]["mma"]),
            ("fused_block_decode_int4_bf16", "mxnet_tpu_torch/csrc/fused_block_decode.cu",
             "mxnet_tpu/ops/fused_block_gemv.py:424",
             lanes(["fused_block_int4:" + k for k in kv16], *b4), r16k["K5_int4"]),
            ("int8_gemv_head", gemv8, "mxnet_tpu/ops/int8_gemv.py:113",
             k1_counts["widths"].get("warp:50304", 0), head_row(k3["head"])),
            ("int4_gemv_head", gemv4, "mxnet_tpu/ops/int8_gemv.py:186",
             int4_counts["contiguous"]["widths"].get("warp:50304", 0),
             head_row(r4k["K4"]["head"])),
            ("flash_attention_fwd", "mxnet_tpu_torch/csrc/flash_attention_fwd.cu",
             "mxnet_tpu/ops/attention.py:286", train_counts.get("flash_fwd", 0), k1),
            ("flash_attention_bwd", "mxnet_tpu_torch/csrc/flash_attention_bwd.cu",
             "mxnet_tpu/ops/attention.py:383", train_counts.get("flash_bwd", 0), k2)):
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launched,
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                     # K5 with every row at position 64; K6 at B 8
                     **{k: r[k] for k in ("ms_pos64", "ms_b8", "bound_ms_b8") if k in r}})
        if name.startswith("flash_attention"):
            # launched from the tape by the gluon_substrate phase's block
            rows[-1]["launches_gluon"] = gluon_counts["flash_fwd" if name.endswith("fwd")
                                                      else "flash_bwd"]
        check(rows[-1]["launches"] > 0, f"{name} never launched on its main path")
    # K8's mask and bf16 lanes: no path of the JAX package reaches them (only
    # GPT exposes head_weights, and its decode loops pass neither), so their
    # launches are the direct calls of kernel_k8_lanes' counted phase
    for name, r in (("lm_head_sample_mask", k8l["mask"]), ("lm_head_sample_bf16", k8l["bf16"]),
                    ("lm_head_sample_int4_mask", r4k["K8_lanes"]["mask"]),
                    ("lm_head_sample_int4_bf16", r4k["K8_lanes"]["bf16"])):
        rows.append({"name": name, "route": "cuda", "source": head_src,
                     "replaces": "mxnet_tpu/ops/fused_block_gemv.py:1218",
                     "launches": r["launches"], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                     "path": "direct calls (no JAX path reaches this lane)"})
        check(rows[-1]["launches"] > 0, f"{name} never launched in its direct-call phase")
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
