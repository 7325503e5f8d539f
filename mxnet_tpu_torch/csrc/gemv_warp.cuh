// Warp route of the weight-only GEMVs K3 (int8_gemv.cu) and K4
// (int4_gemv.cu): y[M, N] = x[M, K] @ W.T for decode rows (M <= 8, and rows
// past gemv_max_m()), redesigned for Hopper. K8 (lm_head_sample.cu) runs
// the same route with an epilogue that selects tokens instead of storing
// y (gemv_warp's Epi).
//
// What must not change is the arithmetic of gemv_common.cuh's warp dot,
// which K5-K7 run as well: every output's dot is taken by one
// warp, lane l walks the 16-code chunks l, l + 32, ... in ascending order,
// turns each chunk's codes into f32 weights (int4: code times its block
// scale), runs fmaf in ascending k, and the 32 lane partials are summed by
// the xor butterfly (masks 16, 8, 4, 2, 1); the row scale multiplies the
// finished dot. That order depends on K alone, so a row's bits do not
// depend on M, on the launch or on the kernel, and the head GEMV + argmax
// equals K8's greedy token bit for bit.
//
// What changed is the data movement and the work split (the PR-1 design
// staged x as f32 in every CTA, up to N / 8 CTAs, one channel per warp,
// weights by synchronous __ldg, and queried the occupancy on every launch):
// - x is staged once per CTA, in its own dtype (bf16 stays bf16: half the
//   bytes, widened exactly at read), by cp.async straight into the swizzle4
//   word layout (word q of chunk c at q * K / 16 + c: a warp's reads of one
//   q are consecutive words, free of bank conflicts), every word in flight
//   at once. The grid is persistent: at most kCtasPerSm CTAs per SM, each
//   owning a contiguous range of channel groups, so x crosses L2 -> shared
//   memory once per CTA, not once per 8 channels.
// - A warp works on a group of G neighbouring channels at a time (G = 4, 2
//   or 1, chosen per call: wide groups read each x word from shared memory
//   for G channels' FMAs, narrow ones spread a small layer over more warps,
//   which is what a latency-bound launch needs). Each channel's dot keeps
//   its own order.
// - The weights stream ahead of the FMAs: each warp owns a ring of stages
//   in shared memory; its lane 0 starts a 1-D TMA bulk copy
//   (cp.async.bulk) of a group's rows (int4: the nibble rows and their
//   block scales, two copies) into a stage that completes on the stage's
//   mbarrier, `stages` groups ahead of the dot that consumes it. The copies
//   are started before x is staged, so both are in flight together.
// - Codes become f32 by exact integer tricks on the ALU and FMA pipes
//   (a byte placed under the exponent of 2^23, then one subtraction), not
//   by I2F conversions, which run at a quarter of the FMA rate on sm_90.
//   The values are the same floats, so the products are the same bits.
// - The G x R partial sums of a group are reduced by a transposed
//   butterfly: at mask m a lane keeps the half of its values whose index
//   bit matches its own lane bit and adds the partner's partial of the same
//   value. Every value sees exactly the additions of the plain butterfly
//   (pairs by lane bit 4, then 3, 2, 1, 0; a + b == b + a), in 31 shuffles
//   for 32 values rather than 160, and lane l ends up holding value
//   l >> (5 - log2(G R)).
// - The occupancy query runs once per (kernel, shared-memory bytes, device)
//   (resident_ctas, gemv_common.cuh).
// The last group of a matrix whose N is not a multiple of G is short; its
// warp takes it with direct loads from device memory (same arithmetic).
//
// What bounds it (H100 80GB HBM3; tools/gemv_warp_compare.py --probes):
// at 1 row the weight stream (the tied head's 38.6 MB int8 at 3.35 TB/s
// is 11.6 us; the copies alone take about 18.5 us, 2.1 TB/s); at 8 rows
// the f32 FMAs the bit contract fixes (8 per weight, bound by instruction
// throughput on the CUDA cores: the head's dot products alone take about
// 30 us); at GPT-2's block widths the launch's latency.
#pragma once

#include <cstdint>

#include "gemv_common.cuh"
#include "hopper_common.cuh"

namespace mx {
namespace warp {

constexpr int kMaxStages = 4;          // ring stages per warp, at most
constexpr int kRingBudget = 8192;      // ring bytes per warp the stage count aims at
constexpr int kCtasPerSm = 2;          // persistent grid: CTAs per SM, at most
constexpr int kStageAlign = 128;

// x words: 4 elements of the staged row (float4 of f32, uint2 of bf16).
template <class X>
struct XWord;
template <>
struct XWord<float> {
  typedef float4 T;
  __device__ static __forceinline__ float4 widen(const float4 v) { return v; }
  __device__ static __forceinline__ float4 zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
};
template <>
struct XWord<bf16> {
  typedef uint2 T;
  __device__ static __forceinline__ float4 widen(const uint2 v) { return widen4(v); }
  __device__ static __forceinline__ uint2 zero() { return make_uint2(0u, 0u); }
};

// Asynchronous copy of one x word (16 or 8 bytes) into shared memory.
__device__ __forceinline__ void cp_async_word(float4* dst, const float4* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(mxh::smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_word(uint2* dst, const uint2* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(mxh::smem_addr(dst)),
               "l"(src)
               : "memory");
}

// Stage rows [r0, r0 + nr) of x [*, K] into xs (R rows, swizzle4 word
// layout, x's own dtype); rows nr .. R - 1 are zero. Every word is an
// asynchronous copy straight into its slot, so all of them are in flight at
// once (x is cold in memory: a load-then-store loop would pay one round
// trip per word a thread moves). Thread i fills slot i (slot q * K / 16 + c
// of a row holds word 4 c + q), so a warp's writes are consecutive words,
// free of bank conflicts. Called by the whole CTA; the caller syncs.
template <class X>
__device__ __forceinline__ void stage_x(void* xs, const X* x, int r0, int nr, int R, int K) {
  typedef typename XWord<X>::T Word;
  const Word* src = reinterpret_cast<const Word*>(x + static_cast<size_t>(r0) * K);
  Word* dst = static_cast<Word*>(xs);
  const int kw = K >> 2, nchunk = K >> 4;
  for (int i = threadIdx.x; i < R * kw; i += blockDim.x) {
    const int r = i / kw, j = i - r * kw;
    const int q = j / nchunk, c = j - q * nchunk;
    if (r < nr) {
      cp_async_word(dst + i, src + r * kw + 4 * c + q);
    } else {
      dst[i] = XWord<X>::zero();
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// 1-D TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) into shared memory; completes on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(mxh::smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(mxh::smem_addr(bar))
      : "memory");
}

// int8 lane: a group's stage is G rows of K bytes; a chunk is 16 codes
// (one int4 of four words); the row scale multiplies the finished dot.
struct Int8Lane {
  typedef Int8Rows Table;
  typedef int4 Raw;
  __host__ __device__ static size_t row_bytes(int K) { return static_cast<size_t>(K); }
  __host__ __device__ static size_t scale_bytes(int, int) { return 0; }
  __device__ static __forceinline__ Raw smem_chunk(const char* stage, int g, int c, int K) {
    return reinterpret_cast<const int4*>(stage + static_cast<size_t>(g) * K)[c];
  }
  template <int G>
  __device__ static __forceinline__ float smem_scale(const char*, int, int, const Table&) {
    return 1.f;
  }
  __device__ static __forceinline__ Raw gmem_chunk(const Table& t, int n, int c) {
    return __ldg(reinterpret_cast<const int4*>(t.w + static_cast<size_t>(n) * t.K) + c);
  }
  __device__ static __forceinline__ float gmem_scale(const Table&, int, int) { return 1.f; }
  __device__ static __forceinline__ void word(const Raw& v, int q, float sc, float (&f)[4]) {
    Table::word(v, q, sc, f);
  }
  __device__ static __forceinline__ float out_scale(const Table& t, int n) {
    return __ldg(t.s + n);
  }
  // the stage's bulk copies: rows [n0, n0 + G)
  template <int G>
  __device__ static __forceinline__ void copy(char* stage, const Table& t, int n0, uint64_t* bar) {
    const uint32_t bytes = static_cast<uint32_t>(G) * t.K;
    mxh::mbar_expect(bar, bytes);
    bulk_copy(stage, t.w + static_cast<size_t>(n0) * t.K, bytes, bar);
  }
};

// int4 lane: a group's stage is G rows of K / 2 bytes of nibble pairs,
// then the group's G * nsb f32 block scales; a chunk is 16 codes (one
// uint2), all in one block; each code times its block scale before the FMA.
struct Int4Lane {
  typedef Int4Rows Table;
  typedef uint2 Raw;
  __host__ __device__ static size_t row_bytes(int K) { return static_cast<size_t>(K) / 2; }
  __host__ __device__ static size_t scale_bytes(int K, int block) {
    return sizeof(float) * static_cast<size_t>(K / block);
  }
  __device__ static __forceinline__ Raw smem_chunk(const char* stage, int g, int c, int K) {
    return reinterpret_cast<const uint2*>(stage + static_cast<size_t>(g) * (K >> 1))[c];
  }
  template <int G>
  __device__ static __forceinline__ float smem_scale(const char* stage, int g, int c,
                                                     const Table& t) {
    const float* s = reinterpret_cast<const float*>(stage + static_cast<size_t>(G) * (t.K >> 1));
    return s[g * t.nsb + c / t.cpb];
  }
  __device__ static __forceinline__ Raw gmem_chunk(const Table& t, int n, int c) {
    return __ldg(reinterpret_cast<const uint2*>(t.w + static_cast<size_t>(n) * (t.K >> 1)) + c);
  }
  __device__ static __forceinline__ float gmem_scale(const Table& t, int n, int c) {
    return __ldg(t.s + static_cast<size_t>(n) * t.nsb + c / t.cpb);
  }
  __device__ static __forceinline__ void word(const Raw& v, int q, float sc, float (&f)[4]) {
    Table::word(v, q, sc, f);
  }
  __device__ static __forceinline__ float out_scale(const Table&, int) { return 1.f; }
  template <int G>
  __device__ static __forceinline__ void copy(char* stage, const Table& t, int n0, uint64_t* bar) {
    const uint32_t rows = static_cast<uint32_t>(G) * (t.K >> 1);
    const uint32_t scales = static_cast<uint32_t>(G) * t.nsb * sizeof(float);
    mxh::mbar_expect(bar, rows + scales);
    bulk_copy(stage, t.w + static_cast<size_t>(n0) * (t.K >> 1), rows, bar);
    bulk_copy(stage + rows, t.s + static_cast<size_t>(n0) * t.nsb, scales, bar);
  }
};

// The group's chunk source: a ring stage, or (the short last group) the
// table in device memory, channel indices clamped to the last row.
template <class L, int G>
struct StageSrc {
  const char* stage;
  const typename L::Table& t;
  __device__ __forceinline__ typename L::Raw chunk(int g, int c) const {
    return L::smem_chunk(stage, g, c, t.K);
  }
  __device__ __forceinline__ float scale(int g, int c) const {
    return L::template smem_scale<G>(stage, g, c, t);
  }
};
template <class L>
struct GlobalSrc {
  const typename L::Table& t;
  int n0, nlast;
  __device__ __forceinline__ typename L::Raw chunk(int g, int c) const {
    return L::gmem_chunk(t, min(n0 + g, nlast), c);
  }
  __device__ __forceinline__ float scale(int g, int c) const {
    return L::gmem_scale(t, min(n0 + g, nlast), c);
  }
};

// a[g * R + r] = this lane's partial of row r's dot with channel g of the
// group: chunks c = lane, lane + 32, ... ascending, fmaf in ascending k
// (the warp dot's order for every (g, r)).
template <int G, int R, class L, class X, class Src>
__device__ __forceinline__ void group_dot(const void* xs, int K, const Src& src,
                                          float (&a)[G * R]) {
  typedef typename XWord<X>::T Word;
  const Word* xw = static_cast<const Word*>(xs);
  const int lane = threadIdx.x & 31;
  const int nchunk = K >> 4, kw = K >> 2;
#pragma unroll
  for (int i = 0; i < G * R; ++i) a[i] = 0.f;
  for (int c = lane; c < nchunk; c += 32) {
    typename L::Raw raw[G];
    float sc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      raw[g] = src.chunk(g, c);
      sc[g] = src.scale(g, c);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float w[G][4];
#pragma unroll
      for (int g = 0; g < G; ++g) L::word(raw[g], q, sc[g], w[g]);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 xv = XWord<X>::widen(xw[r * kw + q * nchunk + c]);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float& s = a[g * R + r];
          s = fmaf(xv.x, w[g][0], s);
          s = fmaf(xv.y, w[g][1], s);
          s = fmaf(xv.z, w[g][2], s);
          s = fmaf(xv.w, w[g][3], s);
        }
      }
    }
  }
}

// Kernel parameters beside the table: the ring's shape, chosen by the host.
struct Ring {
  int nw;        // warps that take groups (the others only stage x)
  int stages;    // ring stages per warp
  int stage_bytes;
  int x_bytes;   // the staged x tile, rounded up to kStageAlign
};

// The GEMV's epilogue: y[row, n] = dot * out_scale(n), written by the
// first lane that holds the value. An epilogue is called by every thread:
// tile(r0, nr) when a tile of rows [r0, r0 + nr) is staged, value(v, row,
// n, ok, rep) by every lane after each group's reduction (v: the dot of
// row `row` with channel n; ok: both exist; rep: the lane is the value's
// first holder, lanes hold each of the G * R values 32 / (G R) times), and
// tile_end(r0, nr) after the tile's last group (it may sync the CTA).
template <class L>
struct StoreY {
  const typename L::Table& t;
  float* __restrict__ y;
  int N;
  __device__ __forceinline__ void tile(int, int) {}
  __device__ __forceinline__ void value(float v, int row, int n, bool ok, bool rep) {
    if (rep && ok) y[static_cast<size_t>(row) * N + n] = v * L::out_scale(t, n);
  }
  __device__ __forceinline__ void tile_end(int, int) {}
};

// The warp route: every CTA owns groups [g0, g1) of G channels; warp w
// takes its groups g0 + w, g0 + w + nw, ...; rows in tiles of R. Each
// value goes to `epi` (StoreY for K3/K4; K8 selects tokens instead).
template <int G, int R, class L, class X, class Epi>
__device__ __forceinline__ void gemv_warp(char* smem, const X* __restrict__ x,
                                          const typename L::Table& t, Epi& epi, int M, int N,
                                          int K, Ring ring) {
  constexpr int V = G * R;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ngroups = (N + G - 1) / G;
  const int nfull = N / G;  // groups of G whole channels
  const int g0 = static_cast<int>(static_cast<long long>(ngroups) * blockIdx.x / gridDim.x);
  const int g1 = static_cast<int>(static_cast<long long>(ngroups) * (blockIdx.x + 1) / gridDim.x);
  const bool active = warp < ring.nw;
  // this warp's groups: gfirst, gfirst + gstep, ... (mine of them)
  const int gfirst = g0 + warp, gstep = ring.nw;
  const int mine = active && gfirst < g1 ? (g1 - gfirst + gstep - 1) / gstep : 0;
  // the short last group (N % G channels) is this warp's last, if any
  const bool short_last = mine > 0 && gfirst + (mine - 1) * gstep >= nfull;
  const int nring = mine - (short_last ? 1 : 0);
  const int ntiles = (M + R - 1) / R;
  const int total = nring * ntiles;  // this warp's ring sequence: (tile, group)

  void* xs = smem;
  char* ringp = smem + ring.x_bytes + static_cast<size_t>(warp) * ring.stages * ring.stage_bytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(
                       smem + ring.x_bytes +
                       static_cast<size_t>(ring.nw) * ring.stages * ring.stage_bytes) +
                   warp * ring.stages;
  // first channel of element s of the ring sequence
  const int n_first = G * gfirst;
  const int n_step = G * gstep;
  if (lane == 0 && nring > 0) {
    for (int s = 0; s < ring.stages; ++s) mxh::mbar_init(bars + s, 1);
    mxh::mbar_fence_init();
    for (int s = 0; s < ring.stages && s < total; ++s) {
      L::template copy<G>(ringp + static_cast<size_t>(s) * ring.stage_bytes, t,
                          n_first + (s % nring) * n_step, bars + s);
    }
  }
  __syncwarp();
  for (int tile = 0; tile < ntiles; ++tile) {
    const int r0 = tile * R;
    const int nr = min(R, M - r0);
    __syncthreads();
    stage_x(xs, x, r0, nr, R, K);
    epi.tile(r0, nr);
    __syncthreads();
    for (int i = 0; i <= nring; ++i) {
      float a[V];
      int n0;
      if (i < nring) {
        const int s = tile * nring + i;
        const int st = s % ring.stages;
        char* stage = ringp + static_cast<size_t>(st) * ring.stage_bytes;
        mxh::mbar_wait(bars + st, static_cast<uint32_t>((s / ring.stages) & 1));
        group_dot<G, R, L, X>(xs, K, StageSrc<L, G>{stage, t}, a);
        __syncwarp();
        if (lane == 0 && s + ring.stages < total) {
          mxh::fence_proxy_async();
          L::template copy<G>(stage, t, n_first + ((s + ring.stages) % nring) * n_step, bars + st);
        }
        n0 = n_first + i * n_step;
      } else if (short_last) {
        n0 = n_first + (mine - 1) * n_step;
        group_dot<G, R, L, X>(xs, K, GlobalSrc<L>{t, n0, N - 1}, a);
      } else {
        break;
      }
      const float v = scatter_sum<V>(a);
      const int idx = lane >> (5 - Log2<V>::v);
      const int g = idx / R, r = idx - g * R;
      epi.value(v, r0 + r, n0 + g, r < nr && n0 + g < N,
                (lane & ((32 >> Log2<V>::v) - 1)) == 0);
    }
    epi.tile_end(r0, nr);
  }
}

// Host side: the ring's shape for groups of G channels and R rows per
// tile, or false if even one warp's single stage does not fit.
template <class L>
inline bool plan_ring(int G, int R, int K, int block, int xsize, int smem_max, Ring* ring) {
  const size_t sb0 = G * (L::row_bytes(K) + L::scale_bytes(K, block));
  const int sb = static_cast<int>((sb0 + kStageAlign - 1) / kStageAlign * kStageAlign);
  const int xb = (R * K * xsize + kStageAlign - 1) / kStageAlign * kStageAlign;
  const int per_stage = sb + static_cast<int>(sizeof(uint64_t));
  const int room = smem_max - xb;
  if (room < per_stage) return false;
  int stages = kRingBudget / sb;
  stages = stages < 1 ? 1 : stages > kMaxStages ? kMaxStages : stages;
  int nw = room / (stages * per_stage);
  if (nw < 1) {
    stages = 1;
    nw = room / per_stage;
  }
  ring->nw = nw < kWarps ? nw : kWarps;
  ring->stages = stages;
  ring->stage_bytes = sb;
  ring->x_bytes = xb;
  return true;
}

inline size_t ring_smem(const Ring& r) {
  return static_cast<size_t>(r.x_bytes) +
         static_cast<size_t>(r.nw) * r.stages * (r.stage_bytes + sizeof(uint64_t));
}

// A group of G channels streams by bulk copies: its rows and (int4) scales
// are whole 16-byte units, and so are their offsets (group starts are
// multiples of G channels).
template <class L>
inline bool group_copies(int G, int K, int block) {
  return (G * L::row_bytes(K)) % 16 == 0 && (G * L::scale_bytes(K, block)) % 16 == 0;
}

// The kernel of one (lane, x dtype, G, R): kernel(x, table, y, M, N, K, ring).
template <class L, class X>
using Kernel = void (*)(const X*, typename L::Table, float*, int, int, int, Ring);

// kernels[gi][ri]: G = 1, 2, 4 channels a group, R = 1, 2, 4, 8 rows a tile.
template <class L, class X>
using Kernels = Kernel<L, X>[3][4];

// The launch of the warp route for (M, N, K): G, the largest of 4, 2, 1
// that still gives half the warps of one CTA per SM a group (small layers
// are latency-bound: narrower groups spread them over more warps; wide
// ones read each x word for more channels), among those whose groups
// stream by bulk copies (4 always does). R: the smallest of 1, 2, 4, 8
// that holds min(M, 8) rows (fewer when shared memory is short: more row
// tiles). Grid: persistent, at most kCtasPerSm CTAs per SM, at least one
// per SM where there are groups for it. `reserve`: static shared memory
// bytes of the kernel beside the ring. `kernels[gi][ri]` is the kernel of
// G = 1 << gi, R = 1 << ri.
struct Plan {
  int gi, ri, grid;
  Ring ring;
  size_t smem;
};

template <class L, class Kern>
inline cudaError_t plan(Kern const (&kernels)[3][4], int M, int N, int K, int block, int xsize,
                        int reserve, Plan* p) {
  int smem_max = 0, sms = 0;
  cudaError_t err = device_limits(&smem_max, &sms);
  if (err != cudaSuccess) return err;
  int gi = 2;
  while (gi > 0 && (N >> gi) < sms * kWarps / 2) --gi;
  while (gi < 2 && !group_copies<L>(1 << gi, K, block)) ++gi;
  int ri = M <= 1 ? 0 : M <= 2 ? 1 : M <= 4 ? 2 : 3;
  while (!plan_ring<L>(1 << gi, 1 << ri, K, block, xsize, smem_max - reserve, &p->ring)) {
    if (ri == 0) return cudaErrorInvalidValue;
    --ri;
  }
  p->gi = gi;
  p->ri = ri;
  p->smem = ring_smem(p->ring);
  int ctas = 0;
  err = resident_ctas(kernels[gi][ri], p->smem, &ctas);
  if (err != cudaSuccess) return err;
  const int ngroups = (N + (1 << gi) - 1) >> gi;
  const int per_cta = kWarps < p->ring.nw ? kWarps : p->ring.nw;
  int grid = (ngroups + per_cta - 1) / per_cta;
  grid = grid > sms ? grid : sms;
  grid = grid < ngroups ? grid : ngroups;
  grid = grid < ctas ? grid : ctas;
  p->grid = grid < kCtasPerSm * sms ? grid : kCtasPerSm * sms;
  return cudaSuccess;
}

// Launch the warp route of K3/K4 (y = x @ W.T): the plan above.
template <class L, class X>
inline int launch(const Kernels<L, X>& kernels, const void* x, const typename L::Table& t,
                  void* y, int M, int N, int K, int block, void* stream) {
  Plan p;
  cudaError_t err =
      plan<L>(kernels, M, N, K, block, static_cast<int>(sizeof(X)), 0, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernels[p.gi][p.ri]<<<p.grid, kThreads, p.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const X*>(x), t, static_cast<float*>(y), M, N, K, p.ring);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace warp
}  // namespace mx
