// Shared pieces of the three one-launch block decode kernels: K5
// (fused_block_decode.cu, contiguous cache), K6 (fused_block_decode_paged.cu,
// page pools gathered into shared memory) and K7
// (fused_block_decode_paged_dma.cu, page pools streamed through a ring).
//
// One GPT block's T = 1 decode step is five phases separated by
// cooperative_groups grid barriers (block_step):
//   1. LN1 -> qkv GEMV        (the epilogue writes the new K/V rows)
//   2. attention -> ctx       (streamed_attention over the kernel's copies)
//   3. out GEMV + residual -> res
//   4. LN2 -> fc GEMV + tanh-GeLU -> fc
//   5. proj GEMV + residual -> out
// Every weight matrix is streamed once, by warps spread over all resident
// CTAs, with the fixed-order dot of gemv_common.cuh, in one of its two
// weight lanes: the phases are templates on the lane (Int8Rows: int8 rows,
// per-channel scales after the dot; Int4Rows: packed nibble rows, block
// scales on each code before its FMA), and every kernel is instantiated for
// both and picks one at launch by BlockArgs::block. LayerNorm is
// recomputed per CTA from the B x D rows instead of paying a grid barrier.
// The attention phase is one copy of code too (streamed_attention: a ring
// of shared-memory slots filled by TMA copies), over each kernel's source
// of copies (a contiguous slab, or pages through a block table), and every
// sum in it keeps one order, so the three kernels give a row the same bits
// for the same logical cache.
//
// The weight phases (redesigned for Hopper; the first design unrolled a
// copy of the GEMV per phase, staged with synchronous loads, and waited one
// memory round trip per chunk): the four GEMV phases are iterations of one
// loop with a run-time epilogue (Epi), so one copy of their code serves all
// four. The block kernels' code runs once per phase and each phase's copy
// was cold in the SM's instruction cache: the unrolled copies cost more
// than the weights' bytes (tools/head_block_compare.py --probes split a
// step's device time). Activations (and the LayerNorm
// gains and offsets) are staged by cp.async, every word in flight at once;
// each warp streams its channels' chunks in batches whose loads are issued
// one batch ahead, the next channel's included; codes become floats by
// exact byte tricks and the butterfly is the transposed one
// (gemv_common.cuh). The sums are the first design's, in the same order.
//
// Element types. x, the block's input row, is f32 or bf16 (X: block 0 of a
// bf16 model gets the bf16 embedding sum; every later block the f32
// residual stream), and the K/V caches or pools are f32 or bf16 (C: the
// model's dtype). Each kernel is instantiated for every (lane, X, C) and
// picks one at launch. On bf16 x the LayerNorm rounds as the plain version
// (npx.layer_norm) does: f32 statistics, the normalised row rounded to
// bf16, times bf16(gamma) rounded to bf16, plus bf16(beta) rounded to bf16
// (the TPU kernel kept this LayerNorm in f32; the port follows the plain
// version, so that tokens on the card match the JAX package's CPU path).
// The residual and everything after it are f32. A new K/V row is rounded
// once to C (round to nearest even) and written in place, and every read of
// a cache row widens it to f32, the current position's row included.
#pragma once

#include <cmath>

#include <cooperative_groups.h>

#include "gemv_warp.cuh"

namespace mx {

// The weights, activations and scratch of one block step. The int8 lane
// (block == 0): w_* [N, K] int8, s_* [N] f32. The int4 lane: w_* [N, K / 2]
// uint8 nibble pairs, s_* [N, K / block] f32 block scales, with `block` the
// codes per scale of the three K = D matrices and `block4` of proj (K = 4D).
struct BlockArgs {
  const void* x;   // [B, D], f32 or bf16 (the kernel's X)
  const void* w_qkv;
  const float* s_qkv;
  const float* b_qkv;  // [3D, D]
  const void* w_out;
  const float* s_out;
  const float* b_out;  // [D, D]
  const void* w_fc;
  const float* s_fc;
  const float* b_fc;  // [4D, D]
  const void* w_proj;
  const float* s_proj;
  const float* b_proj;  // [D, 4D]
  const float* g1;
  const float* be1;
  const float* g2;
  const float* be2;
  float* qkv;  // scratch [B, 3D]
  float* ctx;  // scratch [B, D]
  float* res;  // scratch [B, D]
  float* fc;   // scratch [B, 4D]
  float* out;  // [B, D]
  int B, D, H;
  int block, block4;
  float eps;
};

// Fill a from the C entry point's arguments; scratch is 9 * B * D f32
// (qkv 3D, ctx D, res D, fc 4D per row).
inline void set_block_args(BlockArgs& a, const void* x, const void* w_qkv, const void* s_qkv,
                           const void* b_qkv, const void* w_out, const void* s_out,
                           const void* b_out, const void* w_fc, const void* s_fc,
                           const void* b_fc, const void* w_proj, const void* s_proj,
                           const void* b_proj, const void* g1, const void* be1, const void* g2,
                           const void* be2, void* scratch, void* out, int B, int D, int H,
                           int block, int block4, float eps) {
  a.x = x;
  a.w_qkv = w_qkv;
  a.s_qkv = static_cast<const float*>(s_qkv);
  a.b_qkv = static_cast<const float*>(b_qkv);
  a.w_out = w_out;
  a.s_out = static_cast<const float*>(s_out);
  a.b_out = static_cast<const float*>(b_out);
  a.w_fc = w_fc;
  a.s_fc = static_cast<const float*>(s_fc);
  a.b_fc = static_cast<const float*>(b_fc);
  a.w_proj = w_proj;
  a.s_proj = static_cast<const float*>(s_proj);
  a.b_proj = static_cast<const float*>(b_proj);
  a.g1 = static_cast<const float*>(g1);
  a.be1 = static_cast<const float*>(be1);
  a.g2 = static_cast<const float*>(g2);
  a.be2 = static_cast<const float*>(be2);
  float* sp = static_cast<float*>(scratch);
  a.qkv = sp;
  a.ctx = a.qkv + static_cast<size_t>(B) * 3 * D;
  a.res = a.ctx + static_cast<size_t>(B) * D;
  a.fc = a.res + static_cast<size_t>(B) * D;
  a.out = static_cast<float*>(out);
  a.B = B;
  a.D = D;
  a.H = H;
  a.block = block;
  a.block4 = block4;
  a.eps = eps;
}

// The lane's block sizes are valid for this D (0, 0: the int8 lane): every
// int4 chunk of 16 codes lies in one scale block and both K divide into
// blocks (ops/fused_block_gemv._tiles).
inline bool lane_fits(int D, int block, int block4) {
  if (block == 0 && block4 == 0) return true;
  return block >= 16 && block4 >= 16 && block % 16 == 0 && block4 % 16 == 0 && D % block == 0 &&
         (4 * D) % block4 == 0;
}

constexpr long long kSmemLimit = 232448;  // one CTA's shared memory on Hopper

// The block kernels run one CTA an SM (two (row, head) items on one SM
// share its copy and shared-memory bandwidth while other SMs idle, and
// every CTA stages the activations and waits at every grid barrier), so a
// thread may hold up to 255 registers: __launch_bounds__(kThreads,
// kBlockCtasPerSm). Without the second bound the compiler kept them to 128
// and spilled.
constexpr int kBlockCtasPerSm = 1;

// Shared memory of the staged activation tile: R rows of the 4D-wide fc
// activations (the widest GEMV input), in bytes.
__host__ __device__ inline long long block_tile_bytes(int R, int D) {
  return 4LL * R * 4 * D;
}

// Rows the weight phases stage per pass: kRowTile, and past kRowTile rows
// kWideRowTile where that tile fits in one CTA's shared memory (192 KB at
// D 768), so that every weight matrix is streamed once for up to 16 rows
// rather than once per 8. A row's sums are the same bits either way.
__host__ __device__ inline int block_rows(int B, int D) {
  return B > kRowTile && block_tile_bytes(kWideRowTile, D) <= kSmemLimit ? kWideRowTile
                                                                          : kRowTile;
}

// Enough CTAs for the widest phase (4D fc channels, one warp each) or one
// per (row, head), never more than fit on the card at once (a cooperative
// launch refuses more).
inline int block_grid(int B, int D, int H, int resident) {
  int want = (4 * D + kWarps - 1) / kWarps;
  if (B * H > want) want = B * H;
  return want < resident ? want : resident;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Fixed-order CTA reductions; every thread returns the same value.
__device__ __forceinline__ float cta_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int q = 1; q < kWarps; ++q) r += red[q];
  __syncthreads();
  return r;
}

__device__ __forceinline__ float cta_max(float v, float* red) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int q = 1; q < kWarps; ++q) r = fmaxf(r, red[q]);
  __syncthreads();
  return r;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The LayerNorm of one value after the row's statistics: in f32 for an f32
// row; for a bf16 row the plain version's roundings, each product and sum
// rounded to f32 on its own (no fused multiply-add) and then to bf16.
__device__ __forceinline__ float ln_value(float v, float mean, float inv, float g, float be,
                                          const float*) {
  return (v - mean) * inv * g + be;
}
__device__ __forceinline__ float ln_value(float v, float mean, float inv, float g, float be,
                                          const bf16*) {
  const float n = round_bf16(__fmul_rn(__fsub_rn(v, mean), inv));
  return round_bf16(__fadd_rn(round_bf16(__fmul_rn(n, round_bf16(g))), round_bf16(be)));
}

// LayerNorm of rows [r0, r0 + nr) of src[., D] (f32 or bf16, 16-byte
// aligned rows; nr <= R) into xs[nr][D] (f32, swizzle4 layout). The rows,
// then the gain and offset, are first copied as they are into the bytes
// after the tile (nr * D values of X at xs + R * D, then 2 * D f32), every
// 16-byte word an asynchronous copy in flight at once; then warp w
// normalises rows r0 + w, r0 + w + kWarps, ... from there (f32 statistics:
// mean, E[x^2] - mean^2 clamped at 0, rsqrt; the sums in the order of a
// lane's loop, d = lane, lane + 32, ..., then the butterfly).
template <class X>
__device__ __forceinline__ void stage_ln(float* xs, const X* src, int r0, int nr, int R, int D,
                                         const float* g, const float* be, float eps) {
  X* raw = reinterpret_cast<X*>(xs + R * D);
  float* gs = reinterpret_cast<float*>(raw + R * D);
  const int words = nr * D * static_cast<int>(sizeof(X)) / 16, dw = D / 4;
  const float4* s4 = reinterpret_cast<const float4*>(src + static_cast<size_t>(r0) * D);
  for (int i = threadIdx.x; i < words + 2 * dw; i += blockDim.x) {
    const float4* from = i < words ? s4 + i
                         : i < words + dw ? reinterpret_cast<const float4*>(g) + (i - words)
                                          : reinterpret_cast<const float4*>(be) + (i - words - dw);
    float4* to = i < words ? reinterpret_cast<float4*>(raw) + i
                           : reinterpret_cast<float4*>(gs) + (i - words);
    warp::cp_async_word(to, from);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int warp = threadIdx.x >> 5; warp < nr; warp += kWarps) {
    const X* row = raw + static_cast<size_t>(warp) * D;
    float s = 0.f, ss = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float v = to_f32(row[d]);
      s += v;
      ss = fmaf(v, v, ss);
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    const float mean = s / D;
    const float var = fmaxf(ss / D - mean * mean, 0.f);
    const float inv = rsqrtf(var + eps);
    for (int d = lane; d < D; d += 32) {
      xs[warp * D + 4 * swizzle4(d >> 2, D) + (d & 3)] =
          ln_value(to_f32(row[d]), mean, inv, gs[d], gs[D + d], row);
    }
  }
}

__device__ __forceinline__ float gelu_tanh(float v) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return v * (0.5f * (1.f + tanhf(c * (v + 0.044715f * (v * v * v)))));
}

// The softmax of one (row, head) over the scores sc[0 .. p] in place (K5's
// order: per-thread max and sum over j = tid, tid + kThreads, ..., then the
// fixed-order CTA reductions); returns the sum. On return sc[j] holds
// exp(score - max) and every thread sees it.
__device__ __forceinline__ float softmax_scores(float* sc, int p, float* red) {
  const int tid = threadIdx.x;
  float m = -INFINITY;
  for (int j = tid; j <= p; j += kThreads) m = fmaxf(m, sc[j]);
  m = cta_max(m, red);
  float sum = 0.f;
  for (int j = tid; j <= p; j += kThreads) {
    const float e = expf(sc[j] - m);
    sc[j] = e;
    sum += e;
  }
  return cta_sum(sum, red);  // its barriers also publish sc[]
}

// Sum the P.V group partials (group g's float4 of head element t lands at
// red[g * hd + t]) in group order into ctx[b, h*hd ..]; ends with a
// barrier, so red and the caller's buffers may be reused.
__device__ __forceinline__ void store_head_context(float4 part, float* red, int groups, int hd,
                                                   float* ctx_row) {
  const int tid = threadIdx.x;
  reinterpret_cast<float4*>(red)[tid] = part;
  __syncthreads();
  if (tid < hd) {
    float c = red[tid];
    for (int q = 1; q < groups; ++q) c += red[q * hd + tid];
    ctx_row[tid] = c;
  }
  __syncthreads();
}

// Cache elements (C): a row of hd values is hd / 4 words, a float4 of f32
// or a uint2 of four bf16; load4 returns word w of a row widened to f32.
__device__ __forceinline__ float4 load4(const float* row, int w) {
  return reinterpret_cast<const float4*>(row)[w];
}
__device__ __forceinline__ float4 load4(const bf16* row, int w) {
  return widen4(reinterpret_cast<const uint2*>(row)[w]);
}
__device__ __forceinline__ void store_elem(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_elem(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ void fma4(float4& acc, float w, const float4 v) {
  acc.x = fmaf(w, v.x, acc.x);
  acc.y = fmaf(w, v.y, acc.y);
  acc.z = fmaf(w, v.z, acc.z);
  acc.w = fmaf(w, v.w, acc.w);
}

// Where the qkv epilogue writes the new K and V rows. Paged pools: row r's
// position pos[r] in page bt[r, pos / ps], or the sink page when pos >= L
// = maxp * ps (the padded tail of a chunk; clamping the page index would
// overwrite the row's last real page); inactive rows (table all sink, pos
// 0) write the sink page concurrently: harmless, nothing reads it
// unmasked. Contiguous caches (bt == nullptr, K5: [B, H, L, hd] as row r's
// page r of ps = L rows): position pos[r] clamped into [0, L - 1], as
// lax.dynamic_update_slice clamps, so a bad position never writes outside
// the row's slab. The grid barrier after phase 1 orders every row's write
// before any (row, head) reads the caches, so rows sharing pages see one
// pool state, and the attention's copies read the new rows.
template <class C>
struct KVRows {
  const int* pos;
  const int* bt;  // [B, maxp], or null: contiguous caches
  C* kp;          // [NP + 1, H, ps, hd], or [B, H, L, hd]
  C* vp;
  int ps, maxp, sink;
};

// The epilogue of a GEMV phase, y = x_row . w[n] * s[n] + bias[n] for
// (row r, channel n), chosen at run time so that one copy of the GEMV's
// code serves the four phases (a copy per phase, unrolled, would not stay
// in the SM's instruction cache: the block kernels' code runs once per
// phase, cold): kQkv stores y to the qkv scratch and writes the K and V
// channels into the caches (KVRows); kResidualX stores x + y (x the block
// input, f32 or bf16 widened); kGelu stores gelu(y); kResidual stores res +
// y. prepare(r) readies a copy for row r first (the new rows' slot).
template <class X, class C>
struct Epi {
  enum Kind { kQkv, kResidualX, kGelu, kResidual };
  int kind;
  float* dst;
  int N, D, H;
  const X* x;
  const float* res;
  KVRows<C> kv;
  size_t slot;  // prepare(r): row r's slot in its page, head 0 (values)

  __device__ void prepare(int r) {
    if (kind != kQkv) return;
    int p = max(kv.pos[r], 0), page = r;
    if (kv.bt == nullptr) {
      p = min(p, kv.ps - 1);
    } else {
      page = p < kv.maxp * kv.ps
                 ? kv.bt[static_cast<size_t>(r) * kv.maxp + p / kv.ps]
                 : kv.sink;
    }
    slot = (static_cast<size_t>(page) * H * kv.ps + p % kv.ps) * (D / H);
  }

  __device__ void operator()(int r, int n, float y) const {
    const size_t o = static_cast<size_t>(r) * N + n;
    if (kind == kResidualX) {
      dst[o] = to_f32(x[o]) + y;
    } else if (kind == kGelu) {
      dst[o] = gelu_tanh(y);
    } else if (kind == kResidual) {
      dst[o] = res[o] + y;
    } else {
      dst[o] = y;
      if (n < D) return;
      int c = n - D;
      C* pool = kv.kp;
      if (c >= D) {
        c -= D;
        pool = kv.vp;
      }
      const int hd = D / H;
      const int h = c / hd;
      store_elem(pool + slot + static_cast<size_t>(h) * kv.ps * hd + (c - h * hd), y);
    }
  }
};

// epi(r0 + r, n, xs[r] . w[n] * scale(n) + bias[n]) for the staged rows (nr
// of R = kRowTile or kWideRowTile; lane (32 / R) r holds row r's sum), n
// over all warps of the grid, one channel a warp at a time; w is the lane
// W's table [N, K] with its scales s and the lane's block (unused by the
// int8 lane). Each dot is the warp dot of gemv_common.cuh (lane l walks
// chunks l, l + 32, ... ascending, fmaf in ascending k, then the xor
// butterfly's sums by scatter_sum: lane 4r holds row r). A warp's work is
// one stream of chunk batches (kBatch chunks a lane; a GPT-2 row of 768
// codes is one batch, of 3072 two) over its channels, and the loads of the
// next batch, next channel's included, are in flight while the current
// batch's FMAs run.
template <class W, int R, class X, class C>
__device__ __forceinline__ void gemv_rows(const float* xs, int r0, int nr, const void* w,
                                          const float* s, int block, const float* bias, int N,
                                          int K, Epi<X, C> epi) {
  typedef typename W::Raw Raw;
  const W wt(w, s, K, block);
  const int lane = threadIdx.x & 31;
  const int r = lane / (32 / R);  // scatter_sum<R>: the lane holding row r
  if (r < nr) epi.prepare(r0 + r);
  const int nchunk = K >> 4;
  const int nb = (nchunk + 32 * kBatch - 1) / (32 * kBatch);  // batches a row
  const int stride = gridDim.x * kWarps;
  const int n0 = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int total = n0 < N ? ((N - 1 - n0) / stride + 1) * nb : 0;  // this warp's batches
  Raw nraw[kBatch];
  float nsc[kBatch], nscale = 0.f, nbias = 0.f;
  if (total > 0) {
    load_batch(wt, n0, 0, nchunk, nraw, nsc);
    nscale = wt.scale(n0);
    nbias = __ldg(bias + n0);
  }
  float acc[R];
#pragma unroll
  for (int q = 0; q < R; ++q) acc[q] = 0.f;
  float scale = 0.f, b = 0.f;
  int n = n0, j = 0;  // the current batch: batch j of channel n
  for (int t = 0; t < total; ++t) {
    Raw raw[kBatch];
    float sc[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      raw[i] = nraw[i];
      sc[i] = nsc[i];
    }
    if (j == 0) {
      scale = nscale;
      b = nbias;
    }
    if (t + 1 < total) {  // the next batch: this channel's next, or the next channel's first
      const int n1 = j + 1 < nb ? n : n + stride, j1 = j + 1 < nb ? j + 1 : 0;
      load_batch(wt, n1, j1, nchunk, nraw, nsc);
      if (j1 == 0) {
        nscale = wt.scale(n1);
        nbias = __ldg(bias + n1);
      }
    }
    dot_batch<W, R>(xs, nr, K, j, raw, sc, acc);
    if (++j == nb) {
      const float v = scatter_sum<R>(acc);
      if ((lane & (32 / R - 1)) == 0 && r < nr) epi(r0 + r, n, v * scale + b);
#pragma unroll
      for (int q = 0; q < R; ++q) acc[q] = 0.f;
      j = 0;
      n += stride;
    }
  }
}

// One block step's four GEMV phases, with the kernel's attention phase
// (`attention()`, which writes ctx) between the first two and a grid
// barrier between phases:
//   0. LN1 -> qkv GEMV (kQkv: the new K/V rows land where `kv` says)
//   1. out GEMV + residual on x -> res
//   2. LN2 -> fc GEMV + tanh-GeLU -> fc
//   3. proj GEMV (K = 4D) + residual on res -> out
// The phases are iterations of one loop: one copy of the staging and GEMV
// code serves all four (see Epi). Rows pass in tiles of block_rows(B, D).
template <class W, class X, class C, class Attention>
__device__ __forceinline__ void block_step(const BlockArgs& a, float* smem,
                                           cooperative_groups::grid_group& grid,
                                           const KVRows<C>& kv,
                                           const Attention& attention) {
  const int D = a.D;
  typedef Epi<X, C> E;
  for (int ph = 0; ph < 4; ++ph) {
    if (ph == 1) {
      grid.sync();  // every row's qkv (and new K/V rows) lands before attention
      attention();
    }
    if (ph > 0) grid.sync();
    const int K = ph == 3 ? 4 * D : D;
    const int N = ph == 0 ? 3 * D : ph == 2 ? 4 * D : D;
    const void* w = ph == 0 ? a.w_qkv : ph == 1 ? a.w_out : ph == 2 ? a.w_fc : a.w_proj;
    const float* s = ph == 0 ? a.s_qkv : ph == 1 ? a.s_out : ph == 2 ? a.s_fc : a.s_proj;
    const float* bias = ph == 0 ? a.b_qkv : ph == 1 ? a.b_out : ph == 2 ? a.b_fc : a.b_proj;
    E epi;
    epi.kind = ph == 0 ? E::kQkv : ph == 1 ? E::kResidualX : ph == 2 ? E::kGelu : E::kResidual;
    epi.dst = ph == 0 ? a.qkv : ph == 1 ? a.res : ph == 2 ? a.fc : a.out;
    epi.N = N;
    epi.D = D;
    epi.H = a.H;
    epi.x = static_cast<const X*>(a.x);
    epi.res = a.res;
    epi.kv = kv;
    epi.slot = 0;
    const int R = block_rows(a.B, D);
    for (int r0 = 0; r0 < a.B; r0 += R) {
      const int nr = min(R, a.B - r0);
      if (ph == 0) {
        stage_ln(smem, static_cast<const X*>(a.x), r0, nr, R, D, a.g1, a.be1, a.eps);
      } else if (ph == 2) {
        stage_ln(smem, a.res, r0, nr, R, D, a.g2, a.be2, a.eps);
      } else {
        warp::stage_x(smem, ph == 1 ? a.ctx : a.fc, r0, nr, nr, K);
      }
      __syncthreads();
      const int blk = ph == 3 ? a.block4 : a.block;
      if (R == kWideRowTile) {
        gemv_rows<W, kWideRowTile>(smem, r0, nr, w, s, blk, bias, N, K, epi);
      } else {
        gemv_rows<W, kRowTile>(smem, r0, nr, w, s, blk, bias, N, K, epi);
      }
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------------------
// Streamed attention (the attention phase of K5, K6 and K7)
// ---------------------------------------------------------------------------
// A CTA takes (row, head) items. Each item's key rows [0, pa] (pa = pos
// clamped into [0, L - 1]) pass through a ring of `depth` shared-memory
// slots of `rows` rows each, in the cache's dtype (a copy moves bytes, it
// cannot convert), filled by TMA copies that complete on the slot's
// mbarrier: its K rows slot by slot (pass 1 writes the f32 score row),
// then the softmax, then its V rows (pass 2, P.V). One thread keeps the
// ring full: after each slot is read, it starts the next copy of this
// CTA's stream into it, the next item's included, so a CTA's next item
// loads while the current one computes. Where a CTA has more than one item
// (B H > grid), items go longest first, the rounds snaking (CTA c takes
// item c of round 0 and item G - 1 - c of round 1, ...), so the second
// round's items land beside the first round's shortest.
//
// The source of the copies (S) is a kernel's cache layout:
//   S::tiles(pa)                      slots a pass of the item takes
//   S::start(b, h, pa, i, n, slot, bar)  thread 0: arm bar and start load i
//                                     (pass i / n, slot i % n of the pass)
//   S::waited(pa, i, n)               thread 0: after load i was read
//   S::swizzled()                     key rows written by swizzled tensor copies
// Every sum keeps K5's first design's order (a score's FMAs in ascending
// head-dim order, the softmax of softmax_scores, P.V by groups in
// store_head_context's order), so the three kernels give a row the same
// bits for the same logical cache.

// q . k over one head row, four FMAs a word, words in ascending order, with
// this thread's 16-byte loads `lag` steps late. A row of the ring is hd *
// itemsize bytes (256 or 128 at hd 64, a multiple of 128): read in order,
// the 8 threads of a load phase (8 rows) would all read
// the same 16-byte bank group, an 8-way conflict on every load. With lag =
// tid % 8 they read 8 different groups. f32: a load is one word (four
// values); bf16: two words (eight values), and q is staged as its even
// words, then its odd ones (streamed_attention), so that the q words of a
// step are 8 different groups too.
__device__ __forceinline__ float dot_row_lagged(const float4* q4, const float* k, int hd4,
                                                int lag) {
  float s = 0.f;
  for (int t = 0; t < hd4 + 7; ++t) {
    const int e = t - lag;
    if (e >= 0 && e < hd4) {
      const float4 kv = reinterpret_cast<const float4*>(k)[e];
      const float4 qv = q4[e];
      s = fmaf(qv.x, kv.x, s);
      s = fmaf(qv.y, kv.y, s);
      s = fmaf(qv.z, kv.z, s);
      s = fmaf(qv.w, kv.w, s);
    }
  }
  return s;
}
__device__ __forceinline__ float dot_row_lagged(const float4* q4, const bf16* k, int hd4,
                                                int lag) {
  float s = 0.f;
  const int units = hd4 >> 1;
  for (int t = 0; t < units + 7; ++t) {
    const int u = t - lag;
    if (u >= 0 && u < units) {
      const uint4 v = reinterpret_cast<const uint4*>(k)[u];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 kv = widen4(h ? make_uint2(v.z, v.w) : make_uint2(v.x, v.y));
        const float4 qv = q4[h * (hd4 >> 1) + u];
        s = fmaf(qv.x, kv.x, s);
        s = fmaf(qv.y, kv.y, s);
        s = fmaf(qv.z, kv.z, s);
        s = fmaf(qv.w, kv.w, s);
      }
    }
  }
  return s;
}

// q . k over one bf16 key row of 64 values that a tensor copy with the
// 128-byte swizzle wrote (its 16-byte chunk u at u ^ sw, sw = the row's
// index in its 1 KB swizzle pattern), in ascending order: the 8 rows of a
// load phase read 8 different bank groups with no lag; every thread reads
// the same q word (a broadcast).
__device__ __forceinline__ float dot_row_swizzled(const float4* q4, const bf16* k, int sw) {
  float s = 0.f;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const uint4 v = reinterpret_cast<const uint4*>(k)[u ^ sw];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 kv = widen4(h ? make_uint2(v.z, v.w) : make_uint2(v.x, v.y));
      const float4 qv = q4[2 * u + h];
      s = fmaf(qv.x, kv.x, s);
      s = fmaf(qv.y, kv.y, s);
      s = fmaf(qv.z, kv.z, s);
      s = fmaf(qv.w, kv.w, s);
    }
  }
  return s;
}

// Bytes of the attention layout in front of the mbarriers: the ring of
// `depth` slots of `rows` rows (itemsize bytes a value), then q (hd f32),
// the score row of L f32 rounded up to 4, the float4 P.V scratch and the
// item order (kThreads ints).
__host__ __device__ inline long long attention_bytes(int hd, int L, int depth, int rows,
                                                     int itemsize) {
  return static_cast<long long>(depth) * rows * hd * itemsize +
         4LL * (hd + ((L + 3) & ~3) + 4 * kThreads + kThreads);
}

// Dynamic shared memory of a block kernel with streamed attention: the
// larger of the staged activation tile and the attention layout, then one
// 8-byte mbarrier per slot.
__host__ __device__ inline long long streamed_smem(int B, int D, int H, int L, int depth,
                                                   int rows, int itemsize) {
  const long long tile = block_tile_bytes(block_rows(B, D), D);
  const long long attn = attention_bytes(D / H, L, depth, rows, itemsize);
  return (tile > attn ? tile : attn) + 8LL * depth;
}

// The mbarriers of that layout: past the larger of the tile and the
// attention layout, where no phase writes.
__device__ __forceinline__ uint64_t* streamed_bars(float* smem, const BlockArgs& blk, int L,
                                                   int depth, int rows, int itemsize) {
  return reinterpret_cast<uint64_t*>(
      reinterpret_cast<char*>(smem) +
      streamed_smem(blk.B, blk.D, blk.H, L, depth, rows, itemsize) - 8LL * depth);
}

// The attention phase: every (row, head) item of the grid's share, by
// S's copies through the ring (see above); writes ctx. `smem` is the
// kernel's dynamic shared memory (1 KB aligned, the mbarriers past the
// larger of the tile and the attention layout, at `bars`).
template <class C, class S>
__device__ void streamed_attention(const BlockArgs& blk, const int* pos, int L, const S& src,
                                   float* smem, uint64_t* bars, int depth, int rows) {
  const int H = blk.H, hd = blk.D / H, hd4 = hd >> 2;
  C* ring = reinterpret_cast<C*>(smem);  // [depth][rows * hd]
  float* qs = reinterpret_cast<float*>(ring + static_cast<size_t>(depth) * rows * hd);  // [hd]
  float* sc = qs + hd;                   // [L rounded up to 4]
  float* red = sc + ((L + 3) & ~3);      // [4 * kThreads]
  int* order = reinterpret_cast<int*>(red + 4 * kThreads);  // [kThreads]
  const int tid = threadIdx.x;
  const float scale = 1.f / sqrtf(static_cast<float>(hd));
  const int groups = kThreads / hd4;
  const int N = blk.B * H, G = gridDim.x, cta = blockIdx.x;
  const bool sorted = N > G && blk.B <= kThreads;
  if (tid == 0) {
    for (int s = 0; s < depth; ++s) mxh::mbar_init(bars + s, 1);
    mxh::mbar_fence_init();
  }
  mxh::fence_proxy_async();  // the qkv phase staged activations in these bytes
  if (sorted) {
    // rank the rows by attended length, longest first, ties by row
    int* len = reinterpret_cast<int*>(red);
    for (int b = tid; b < blk.B; b += kThreads) len[b] = min(max(pos[b], 0), L - 1);
    __syncthreads();
    for (int b = tid; b < blk.B; b += kThreads) {
      int rank = 0;
      for (int o = 0; o < blk.B; ++o) rank += len[o] > len[b] || (len[o] == len[b] && o < b);
      order[rank] = b;
    }
  }
  __syncthreads();
  // this CTA's items: round m takes item m G + cta, or (sorted, odd m)
  // m G + G - 1 - cta, of the item list in order; (row, head) of item k
  int k = cta < N ? cta : -1;
  unsigned seq = 0;  // loads consumed: load n uses slot n % depth
  int ahead = 0;     // loads of the current item started during the last one
  for (int m = 0; k >= 0; ++m) {
    const int b = sorted ? order[k / H] : k / H, h = k % H;
    const int pa = min(max(pos[b], 0), L - 1);
    const int ntile = src.tiles(pa), loads = 2 * ntile;
    // the next item, whose first loads start as this one's slots free up
    const int k1 = (m + 1) * G + (sorted && !(m & 1) ? G - 1 - cta : cta);
    const int nk = k1 < N ? k1 : -1;
    const int nb = nk < 0 ? 0 : sorted ? order[nk / H] : nk / H, nh = nk < 0 ? 0 : nk % H;
    const int npa = min(max(pos[nb], 0), L - 1);
    const int nn = nk < 0 ? 0 : src.tiles(npa), nloads = 2 * nn;
    if (tid == 0) {
      // fill the ring: this item's loads not started yet, then the next's
      for (int i = ahead; i < depth; ++i) {
        const unsigned n = seq + i;
        C* slot = ring + static_cast<size_t>(n % depth) * rows * hd;
        if (i < loads) {
          src.start(b, h, pa, i, ntile, slot, bars + n % depth);
        } else if (i - loads < nloads) {
          src.start(nb, nh, npa, i - loads, nn, slot, bars + n % depth);
        }
      }
    }
    const float* row = blk.qkv + static_cast<size_t>(b) * 3 * blk.D + h * hd;
    // q, in order, or (bf16 rows read lagged) its even words then its odd
    const bool split = sizeof(C) == 2 && !src.swizzled();
    for (int d = tid; d < hd; d += kThreads) {
      const int w = d >> 2;
      qs[4 * (split ? (w & 1) * (hd4 >> 1) + (w >> 1) : w) + (d & 3)] = row[d];
    }
    __syncthreads();
    const float4* q4 = reinterpret_cast<const float4*>(qs);
    float sum = 0.f;
    float4 part = make_float4(0.f, 0.f, 0.f, 0.f);
    const int g = tid / hd4, d4 = tid - g * hd4;
    for (int i = 0; i < loads; ++i, ++seq) {
      const int slot_i = seq % depth;
      C* slot = ring + static_cast<size_t>(slot_i) * rows * hd;
      mxh::mbar_wait(bars + slot_i, (seq / depth) & 1u);
      const int j0 = (i % ntile) * rows;  // first key row of the slot
      const int jn = min(j0 + rows, pa + 1);
      if (i < ntile) {
        // pass 1: scores of the slot's key rows
        for (int j = j0 + tid; j < jn; j += kThreads) {
          const C* kr = slot + static_cast<size_t>(j - j0) * hd;
          float s;
          if constexpr (sizeof(C) == 2) {
            s = src.swizzled() ? dot_row_swizzled(q4, kr, (j - j0) & 7)
                               : dot_row_lagged(q4, kr, hd4, tid & 7);
          } else {
            s = dot_row_lagged(q4, kr, hd4, tid & 7);
          }
          sc[j] = s * scale;
        }
      } else if (g < groups) {
        // pass 2: group g takes rows j = g (mod groups), ascending
        for (int j = j0 + ((g - j0 % groups) + groups) % groups; j < jn; j += groups) {
          fma4(part, sc[j] / sum, load4(slot + static_cast<size_t>(j - j0) * hd, d4));
        }
      }
      if (tid == 0) src.waited(pa, i, ntile);
      mxh::fence_proxy_async();
      __syncthreads();  // the slot is read: it may be refilled
      if (tid == 0) {  // refill it: load seq + depth, this item's or the next's
        const int t = i + depth;
        if (t < loads) {
          src.start(b, h, pa, t, ntile, slot, bars + slot_i);
        } else if (t - loads < nloads) {
          src.start(nb, nh, npa, t - loads, nn, slot, bars + slot_i);
        }
      }
      if (i == ntile - 1) sum = softmax_scores(sc, pa, red);
    }
    store_head_context(part, red, groups, hd, blk.ctx + static_cast<size_t>(b) * blk.D + h * hd);
    ahead = min(depth, nloads);
    k = nk;
  }
}

// The copies of paged pools [NP + 1, H, ps, hd] through a block table (K6,
// K7): a slot holds tp pages; load i of a (row, head) with np = pa / ps + 1
// attended pages copies pages [t tp, min((t + 1) tp, np)) of K (i < n) or
// V (t = i % n): per page one 1-D TMA bulk copy (cp.async.bulk, ps * hd *
// itemsize contiguous bytes) onto the slot's mbarrier, or for swizzled key
// pages (swz: bf16 pools at hd 64, ps % 8 == 0) one 2-D tensor copy of the
// page through `tk` (the pool as [(NP + 1) H, ps, hd], one-page boxes,
// 128-byte swizzle). With a non-null `counters` thread 0 adds the copies it
// started to counters[0] and those it waited for to counters[1].
template <class C>
struct PagedSource {
  const C* pool[2];     // K, V
  const int* bt;        // [B, maxp]
  const CUtensorMap* tk;
  int* counters;
  int H, hd, ps, maxp, tp, swz;

  __device__ __forceinline__ int tiles(int pa) const { return (pa / ps + tp) / tp; }
  __device__ __forceinline__ bool swizzled() const { return sizeof(C) == 2 && swz; }
  __device__ void start(int b, int h, int pa, int i, int n, C* slot, uint64_t* bar) const {
    const uint32_t page_bytes = static_cast<uint32_t>(ps) * hd * sizeof(C);
    const int first = (i % n) * tp;
    const int np = min(tp, pa / ps + 1 - first);
    const int* table = bt + static_cast<size_t>(b) * maxp + first;
    const C* from = i < n ? pool[0] : pool[1];
    mxh::mbar_expect(bar, page_bytes * np);
    const bool tensor = swizzled() && i < n;  // a swizzled K slot
    for (int k = 0; k < np; ++k) {
      const int page = table[k];
      if (tensor) {
        mxh::tma_load_3d(slot + static_cast<size_t>(k) * ps * hd, tk, bar, 0, 0, page * H + h);
      } else {
        warp::bulk_copy(slot + static_cast<size_t>(k) * ps * hd,
                        from + (static_cast<size_t>(page) * H + h) * ps * hd, page_bytes, bar);
      }
    }
    if (counters != nullptr) atomicAdd(counters, np);
  }
  __device__ __forceinline__ void waited(int pa, int i, int n) const {
    if (counters != nullptr) atomicAdd(counters + 1, min(tp, pa / ps + 1 - (i % n) * tp));
  }
};

// The tensor map of a bf16 cache [mats, rows, 64] for boxes of box_rows
// rows with the 128-byte swizzle, encoded once per (cache, shape) and kept
// (a decode step launches a block kernel once per layer, on the layer's own
// cache). Returns false where the map cannot be encoded.
inline bool bf16_cache_map(CUtensorMap* map, const void* base, int mats, int rows, int box_rows) {
  struct Entry {
    const void* base;
    int mats, rows, box;
    CUtensorMap map;
  };
  static std::mutex mu;
  static std::vector<Entry> cache;
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& e : cache) {
    if (e.base == base && e.mats == mats && e.rows == rows && e.box == box_rows) {
      *map = e.map;
      return true;
    }
  }
  if (!mxh::bf16_rows_map(map, base, mats, rows, 64, box_rows)) return false;
  if (cache.size() >= 256) cache.clear();
  cache.push_back(Entry{base, mats, rows, box_rows, *map});
  return true;
}

// The instantiation of a block kernel for the weight lane W, f32 or bf16 x
// and f32 or bf16 caches. K<W, X, C>::get() returns the kernel template's
// instantiation (a __global__ function cannot be a class member, so each
// kernel file wraps its own).
template <template <class, class, class> class K, class W, class Args>
inline void (*pick_types(int x_bf16, int cache_bf16))(Args) {
  if (x_bf16) return cache_bf16 ? K<W, bf16, bf16>::get() : K<W, bf16, float>::get();
  return cache_bf16 ? K<W, float, bf16>::get() : K<W, float, float>::get();
}

// ... and of the int8 or int4 lane, by a.blk.block.
template <template <class, class, class> class K, class Args>
inline void (*pick_block_kernel(const Args& a, int x_bf16, int cache_bf16))(Args) {
  return a.blk.block ? pick_types<K, Int4Rows, Args>(x_bf16, cache_bf16)
                     : pick_types<K, Int8Rows, Args>(x_bf16, cache_bf16);
}

// Cooperative launch of one instantiation of a block kernel on the grid of
// block_grid, never more CTAs than fit at once, nor more than
// kBlockCtasPerSm an SM.
template <class Args>
inline int launch_block(void (*kernel)(Args), Args& a, size_t smem, void* stream) {
  if (!lane_fits(a.blk.D, a.blk.block, a.blk.block4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int ctas = 0;
  cudaError_t err = resident_ctas(kernel, smem, &ctas);
  if (err != cudaSuccess) return static_cast<int>(err);
  int smem_max = 0, sms = 0;
  if ((err = device_limits(&smem_max, &sms)) != cudaSuccess) return static_cast<int>(err);
  ctas = ctas < kBlockCtasPerSm * sms ? ctas : kBlockCtasPerSm * sms;
  const int grid = block_grid(a.blk.B, a.blk.D, a.blk.H, ctas);
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(grid), dim3(kThreads),
                                    params, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mx
