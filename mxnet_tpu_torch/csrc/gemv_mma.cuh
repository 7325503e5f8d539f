// Tile route of the weight-only GEMVs K3 (int8_gemv.cu) and K4
// (int4_gemv.cu): y[M, N] = x[M, K] @ W.T on the tensor cores, for the
// prefill row counts 9 <= M <= 64 (ops/int8_gemv.py:gemv_route). Decode
// rows (M <= 8) keep the warp route of gemv_common.cuh, whose dot order K8
// shares.
//
// Replaces, for those rows, the TPU kernels mxnet_tpu/ops/int8_gemv.py:
// int8_weight_matmul (pl.pallas_call at :160) and int4_weight_matmul
// (:237), which dequantize a weight block in VMEM and run one bf16 MXU dot.
//
// Bound on the H100: the larger of the bytes (the weight table read once,
// x read once, y written once, at 3.35 TB/s) and 2 M N K operations at the
// 989 TFLOP/s bf16 tensor rate. At M <= 64 and GPT-2 widths the bytes bound
// every case (one layer's four GEMVs at 64 rows: 10.25 MB int8, 3.1 us).
//
// Design against that bound:
// - Tensor cores, f32 accuracy. x is written as three bf16 planes, hi =
//   bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid) (round to nearest
//   even; the residues are exact in f32): together 24 significant bits, all
//   of f32's. The codes are exact in bf16 (int8 codes in [-127, 127], int4
//   codes nibble - 8 in [-8, 7]), so every product is exact and mma.sync
//   m16n8k16 sums them in f32. Three planes, not two: two leave x's last 8
//   bits out, and a head GEMV on this route is held to greedy parity with
//   K8 (the warp route), where logits closer than the error could swap an
//   argmax. The third plane costs MMAs, which are not the bound.
// - bf16 x (block 0 of a bf16 model). A bf16 value is its own hi plane and
//   its mid and lo planes are zero, so the bf16 lane stages x as bf16 (half
//   the bytes), uses the staged tile as the one plane and runs a third of
//   the MMAs. Its sums equal the f32 lane's on x.float() bit for bit: the
//   f32 lane's mid and lo MMAs add products that are all zero to the
//   accumulators, which leaves every accumulator as it was (zero products
//   added to a +0 accumulator give +0, the accumulator's own start).
// - Scales. An int4 block scale multiplies the partial sum of that block's
//   codes (within one CTA's k-slice), which is added to the f32
//   accumulator. An int8 row is one block of scale 1, and its row scale
//   multiplies the finished dot, as on the warp route.
// - Stream. A CTA owns kBN = 64 output channels and one k-slice. Stages of
//   kSub k-tiles (64 codes) of its weight rows, and the f32 x rows of the
//   same codes, stream from device memory into a kStages-deep ring in
//   shared memory by cp.async (every weight byte is read once per launch).
//   The CTA splits each x stage into the three planes once, in shared
//   memory; each warp converts its codes to bf16 on the way into its B
//   fragments and multiplies them with its row tiles of every plane. Eight
//   warps: four across the channels (16 each) by two across the 16-row
//   tiles.
// - Lane order of the codes. mma.sync wants lane (g, t) to hold codes
//   {2t, 2t+1, 2t+8, 2t+9} of each k16 step. The sum does not care which
//   physical code is called logical code kk, so physical code 8t + 4s + j
//   plays kk = 2t + (j & 1) + 8 (j >> 1) of step s (j = 0..3): a lane's
//   codes of a k-tile are the 8 contiguous codes 8t..8t+7 (one 8-byte int8
//   or 4-byte int4 load), and the A fragments of both steps of one row are
//   one 16-byte load from a plane in its natural order. No ldmatrix; padded
//   rows keep the loads free of bank conflicts.
// - Grid. kBN-channel tiles alone give 12 CTAs at N = 768, so K is split
//   into up to kMaxSlices slices, one CTA each, as many as keep the grid
//   within kFillCtas CTAs, launched as one thread-block cluster per channel
//   tile. Each CTA leaves its partial tile in its shared memory; after a
//   cluster barrier, each CTA sums a share of the tile's elements over the
//   slices in ascending order through distributed shared memory. No
//   atomics, no workspace, one launch. (Measured on the H100: fewer, longer
//   CTAs beat a grid of two per SM; these kernels last 7-20 us, so a launch
//   and a few memory latencies are most of their time, see PERF.md.)
// - Determinism. The slice count depends on N and K only. Within a slice,
//   a block's partial sum is kept in two sets, one per k16 step of a k-tile
//   (so that consecutive MMAs of a warp feed different accumulators), each
//   summed over the block's k-tiles in ascending order, then planes (hi,
//   mid, lo); the block adds (set 0 + set 1) x scale to the slice's sum.
//   The same inputs give the same bits on every launch, and a row's bits
//   do not depend on M (rows past M are zero-filled and never stored).
#pragma once

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_common.cuh"

namespace mx {
namespace tile {

constexpr int kChannelWarps = 4;     // warps across the channels, 16 channels each
constexpr int kRowGroups = 2;        // warps across the 16-row tiles
constexpr int kWarps = kChannelWarps * kRowGroups;
constexpr int kThreads = 32 * kWarps;
constexpr int kBN = 16 * kChannelWarps;   // output channels per CTA
constexpr int kRowTiles = 4 / kRowGroups; // 16-row tiles per warp (of four at M = 64)
constexpr int kBK = 32;              // codes per k-tile: two k16 steps
constexpr int kSub = 2;              // k-tiles per ring stage (64 codes)
constexpr int kStages = 3;           // depth of the cp.async ring
constexpr int kMinCtas = 2;          // resident CTAs per SM the registers must allow
constexpr int kMaxRows = 64;         // gemv_max_m(): four 16-row tiles
constexpr int kMaxSlices = 16;       // k-slices per channel tile: the largest cluster
constexpr int kFillCtas = 192;       // CTAs the split stays within
constexpr int kRedLd = kBN + 8;      // f32 row stride of the partial tile
// f32 row stride of a staged x tile (16 bytes of padding)
constexpr int kXLd = kSub * kBK + 4;
// bf16 row stride of a plane tile: 64 bytes of padding, so the two rows a
// quarter-warp reads at once fall in distinct banks
constexpr int kPLd = kSub * kBK + 32;

typedef __nv_bfloat16 bf16;

inline int n_tiles(int N) { return (N + kBN - 1) / kBN; }

// How a ring stage holds x: f32 rows of kXLd floats split into three bf16
// planes per stage, or bf16 rows of kPLd that are the one plane themselves.
template <class X>
struct XStage;
template <>
struct XStage<float> {
  static constexpr int kPlanes = 3;
  static constexpr int kLd = kXLd;
};
template <>
struct XStage<bf16> {
  static constexpr int kPlanes = 1;
  static constexpr int kLd = kPLd;
};

// K-slices of a launch: as many as keep the grid within kFillCtas CTAs, at
// most kMaxSlices and at most one per k-tile. A function of N and K only.
inline int slices(int N, int K) {
  const int nt = n_tiles(N);
  int s = kFillCtas / nt;
  s = s < kMaxSlices ? s : kMaxSlices;
  s = s < K / kBK ? s : K / kBK;
  return s > 1 ? s : 1;
}

// bf16(lo) in the low half, bf16(hi) in the high half, rounded to nearest
// even: one cvt.rn.bf16x2
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 16 bytes global -> shared, asynchronously; zero-filled when !full.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// int8 lane: rows [N, K] int8, one f32 scale per row, applied to the
// finished dot.
struct Int8Tile {
  static constexpr int kRowBytes = kBK;   // bytes of one row's k-tile
  static constexpr int kLaneBytes = 8;    // bytes of a lane's 8 codes
  const unsigned char* w;
  const float* s;   // [N]
  int row_bytes, block;
  __host__ __device__ Int8Tile(const void* w_, const float* s_, int K, int /*block*/)
      : w(static_cast<const unsigned char*>(w_)), s(s_), row_bytes(K), block(K) {}
  // c[q] = bf16 pair of codes 2q, 2q + 1 of the 8 codes at p
  __device__ __forceinline__ void pairs(const unsigned char* p, uint32_t (&c)[4]) const {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t h = (q < 2 ? v.x : v.y) >> (16 * (q & 1));
      c[q] = pack_bf16(static_cast<float>(static_cast<int8_t>(h)),
                       static_cast<float>(static_cast<int8_t>(h >> 8)));
    }
  }
  __device__ __forceinline__ float out_scale(int n) const { return __ldg(s + n); }
  // the whole row is one block of scale 1: its partial sum is the slice's
  __device__ __forceinline__ float block_scale(int, int) const { return 1.f; }
};

// int4 lane: rows [N, K / 2] uint8 of nibble pairs (code 2i the lo nibble
// of byte i, code 2i + 1 the hi nibble, each stored as code + 8) and f32
// block scales [N, K / block] (block % kBK == 0, so a k-tile lies in one
// block). The scale after the dot is 1 (x * 1 is exact).
struct Int4Tile {
  static constexpr int kRowBytes = kBK / 2;
  static constexpr int kLaneBytes = 4;
  const unsigned char* w;
  const float* s;   // [N, K / block]
  int row_bytes, block, nsb;
  __host__ __device__ Int4Tile(const void* w_, const float* s_, int K, int block_)
      : w(static_cast<const unsigned char*>(w_)), s(s_), row_bytes(K / 2), block(block_),
        nsb(K / block_) {}
  __device__ __forceinline__ void pairs(const unsigned char* p, uint32_t (&c)[4]) const {
    const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t b = v >> (8 * q);
      c[q] = pack_bf16(static_cast<float>(static_cast<int>(b & 0xFu) - 8),
                       static_cast<float>(static_cast<int>((b >> 4) & 0xFu) - 8));
    }
  }
  __device__ __forceinline__ float out_scale(int) const { return 1.f; }
  __device__ __forceinline__ float block_scale(int n, int blk) const {
    return __ldg(s + static_cast<size_t>(n) * nsb + blk);
  }
};

// Byte row stride of a staged weight tile: one k-tile's bytes of padding
// past kSub of them, so the rows a warp reads at once fall in distinct
// banks.
template <class L>
__host__ __device__ constexpr int w_ld() {
  return (kSub + 1) * L::kRowBytes;
}

// Bytes of one ring stage: the x tile [MP][XStage<X>::kLd] and the weight
// tile [kBN][w_ld].
template <class L, class X>
__host__ __device__ inline size_t stage_bytes(int MP) {
  return static_cast<size_t>(MP) * XStage<X>::kLd * sizeof(X) + kBN * w_ld<L>();
}

// Dynamic shared memory of a launch with MP (a multiple of 16) padded rows:
// the ring, then (f32 x) the planes [3][MP][kPLd] bf16 of one stage; the
// partial tile [MP][kRedLd] f32 reuses them after the k loop.
template <class L, class X>
inline size_t smem_bytes(int MP) {
  const size_t planes =
      XStage<X>::kPlanes > 1 ? static_cast<size_t>(XStage<X>::kPlanes) * MP * kPLd * sizeof(bf16)
                             : 0;
  const size_t all = kStages * stage_bytes<L, X>(MP) + planes;
  const size_t red = static_cast<size_t>(MP) * kRedLd * sizeof(float);
  return all > red ? all : red;
}

// Start the copies of nt k-tiles from code k0 on (x rows [0, MP), channels
// [n0, n0 + kBN)) into one ring slot. Called by the whole CTA.
template <class L, class X>
__device__ __forceinline__ void issue_stage(char* slot, const X* __restrict__ x, const L& wt,
                                            int M, int MP, int N, int K, int n0, int k0, int nt) {
  constexpr int kLd = XStage<X>::kLd;
  constexpr int kPer = 16 / sizeof(X);          // x values per 16-byte copy
  X* xs = reinterpret_cast<X*>(slot);
  unsigned char* ws = reinterpret_cast<unsigned char*>(slot) + MP * kLd * sizeof(X);
  const int xch = nt * (kBK / kPer);            // 16-byte chunks of an x row's stage
  for (int i = threadIdx.x; i < MP * xch; i += kThreads) {
    const int r = i / xch, c = i - r * xch;
    const bool ok = r < M;
    cp_async16(xs + r * kLd + kPer * c,
               x + static_cast<size_t>(ok ? r : 0) * K + k0 + kPer * c, ok);
  }
  const int wch = nt * (L::kRowBytes / 16);     // 16-byte chunks of a weight row's stage
  const size_t wk0 = static_cast<size_t>(k0 / kBK) * L::kRowBytes;
  for (int i = threadIdx.x; i < kBN * wch; i += kThreads) {
    const int r = i / wch, c = i - r * wch;
    const bool ok = n0 + r < N;
    cp_async16(ws + r * w_ld<L>() + 16 * c,
               wt.w + static_cast<size_t>(ok ? n0 + r : 0) * wt.row_bytes + wk0 + 16 * c, ok);
  }
}

// planes[p][r][k] = plane p of xs[r][k] (hi, mid, lo) for r < MP and the
// stage's nt k-tiles: each x value is split once per CTA.
__device__ __forceinline__ void split_planes(const float* xs, bf16* planes, int MP, int nt) {
  constexpr int kPlanes = XStage<float>::kPlanes;
  const int qpr = nt * (kBK / 4);               // quads of a row
  for (int i = threadIdx.x; i < MP * qpr; i += kThreads) {
    const int r = i / qpr, c = i - r * qpr;
    const float4 v = *reinterpret_cast<const float4*>(xs + r * kXLd + 4 * c);
    float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) {
      uint32_t w[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        w[h] = pack_bf16(f[2 * h], f[2 * h + 1]);
        // the rounding residues, exact in f32 (a bf16 is the top half of an f32)
        f[2 * h] -= __uint_as_float(w[h] << 16);
        f[2 * h + 1] -= __uint_as_float(w[h] & 0xFFFF0000u);
      }
      *reinterpret_cast<uint2*>(planes + (static_cast<size_t>(p) * MP + r) * kPLd + 4 * c) =
          make_uint2(w[0], w[1]);
    }
  }
}

// The tile route's body: CTA (channel tile blockIdx.x, k-slice = rank in
// its cluster of gridDim.y CTAs).
template <class L, class X>
__device__ __forceinline__ void gemv_mma(char* smem, const X* __restrict__ x, const L& wt,
                                         float* __restrict__ y, int M, int N, int K) {
  constexpr int kPlanes = XStage<X>::kPlanes;
  constexpr int kLd = XStage<X>::kLd;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int slice = static_cast<int>(cluster.block_rank());
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // the warp's 16 channels, and its row tiles: rg, rg + kRowGroups, ...
  const int cw = warp % kChannelWarps, rg = warp / kChannelWarps;
  const int MT = (M + 15) >> 4, MP = MT * 16;
  const int n0 = blockIdx.x * kBN;
  const int ktiles = K / kBK;
  const int kt_lo = slice * ktiles / S, kt_hi = (slice + 1) * ktiles / S;
  const int T = kt_hi - kt_lo;
  const int stages = (T + kSub - 1) / kSub;
  const size_t stage = stage_bytes<L, X>(MP);
  bf16* split = reinterpret_cast<bf16*>(smem + kStages * stage);   // f32 x only

  // acc: the slice's sum; part[s]: the current block's partial sums of
  // k16 step s of each k-tile (two sets, so that consecutive MMAs of a warp
  // feed different accumulators)
  float acc[kRowTiles][2][4], part[2][kRowTiles][2][4];
#pragma unroll
  for (int m = 0; m < kRowTiles; ++m)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = part[0][m][j][e] = part[1][m][j][e] = 0.f;

#pragma unroll
  for (int u = 0; u < kStages - 1; ++u) {
    if (u < stages) {
      issue_stage(smem + u * stage, x, wt, M, MP, N, K, n0, (kt_lo + u * kSub) * kBK,
                  min(kSub, T - u * kSub));
    }
    cp_async_commit();
  }
  for (int u = 0; u < stages; ++u) {
    cp_async_wait<kStages - 2>();   // stage u has landed
    __syncthreads();                // and every warp is done with stage u - 1
    const int v = u + kStages - 1;
    if (v < stages) {
      issue_stage(smem + (v % kStages) * stage, x, wt, M, MP, N, K, n0, (kt_lo + v * kSub) * kBK,
                  min(kSub, T - v * kSub));
    }
    cp_async_commit();
    const X* xs = reinterpret_cast<const X*>(smem + (u % kStages) * stage);
    const unsigned char* ws = reinterpret_cast<const unsigned char*>(xs + MP * kLd);
    const int nt = min(kSub, T - u * kSub);
    const bf16* planes;
    if constexpr (kPlanes > 1) {
      split_planes(xs, split, MP, nt);
      __syncthreads();
      planes = split;
    } else {
      planes = xs;   // bf16 x: the staged tile is the hi plane, row stride kPLd
    }
    for (int q = 0; q < nt; ++q) {
      // B fragments of the warp's two 8-channel tiles for both k16 steps
      uint32_t bfr[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wt.pairs(ws + (cw * 16 + 8 * j + g) * w_ld<L>() + q * L::kRowBytes + t * L::kLaneBytes,
                 bfr[j]);
      }
#pragma unroll
      for (int mi = 0; mi < kRowTiles; ++mi) {
        const int m = rg + kRowGroups * mi;   // the row tile
        if (m < MT) {
#pragma unroll
          for (int p = 0; p < kPlanes; ++p) {
            const bf16* pl = planes + (static_cast<size_t>(p) * MP + m * 16 + g) * kPLd +
                             q * kBK + 8 * t;
            const uint4 r0 = *reinterpret_cast<const uint4*>(pl);
            const uint4 r1 = *reinterpret_cast<const uint4*>(pl + 8 * kPLd);
            const uint32_t a0[4] = {r0.x, r1.x, r0.y, r1.y};   // k16 step 0
            const uint32_t a1[4] = {r0.z, r1.z, r0.w, r1.w};   // k16 step 1
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              mma16816(part[0][mi][j], a0, bfr[j]);
              mma16816(part[1][mi][j], a1, bfr[j] + 2);
            }
          }
        }
      }
      const int i = u * kSub + q, kt = kt_lo + i;
      if (i == T - 1 || ((kt + 1) * kBK) % wt.block == 0) {
        // the block's partial sum (within the slice) times its scale into the
        // accumulator: an int4 block scale; 1 for int8, whose block is the row
        const int blk = kt * kBK / wt.block;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = n0 + cw * 16 + 8 * j + 2 * t;
          const float s0 = n < N ? wt.block_scale(n, blk) : 0.f;
          const float s1 = n + 1 < N ? wt.block_scale(n + 1, blk) : 0.f;
#pragma unroll
          for (int m = 0; m < kRowTiles; ++m) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[m][j][e] = fmaf(part[0][m][j][e] + part[1][m][j][e], e & 1 ? s1 : s0,
                                  acc[m][j][e]);
              part[0][m][j][e] = part[1][m][j][e] = 0.f;
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the slice's partial tile into this CTA's shared memory
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mi = 0; mi < kRowTiles; ++mi) {
    const int m = rg + kRowGroups * mi;
    if (m < MT) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = cw * 16 + 8 * j + 2 * t;
        *reinterpret_cast<float2*>(red + (m * 16 + g) * kRedLd + c) =
            make_float2(acc[mi][j][0], acc[mi][j][1]);
        *reinterpret_cast<float2*>(red + (m * 16 + g + 8) * kRedLd + c) =
            make_float2(acc[mi][j][2], acc[mi][j][3]);
      }
    }
  }
  cluster.sync();
  // each CTA sums its share of the tile over the slices, in ascending order
  for (int e = slice * kThreads + threadIdx.x; e < M * kBN; e += S * kThreads) {
    const int m = e / kBN, c = e % kBN, n = n0 + c;
    if (n < N) {
      float v = cluster.map_shared_rank(red, 0)[m * kRedLd + c];
      for (int q = 1; q < S; ++q) v += cluster.map_shared_rank(red, q)[m * kRedLd + c];
      y[static_cast<size_t>(m) * N + n] = v * wt.out_scale(n);
    }
  }
  cluster.sync();   // no CTA leaves while another reads its shared memory
}

// Per device: the shared-memory limit of the kernel of lane L and x type X
// is set (one flag set per instantiation and kernel library).
template <class L, class X>
inline bool* smem_limit_set() {
  static bool set[64];
  return set;
}

// Launch a gemv_mma kernel (kernel(x, wt, y, M, N, K)): grid (channel
// tiles, slices), one cluster of `slices` CTAs per channel tile.
template <class L, class X>
inline int launch_gemv_mma(void (*kernel)(const X*, L, float*, int, int, int), const void* x,
                           const L& wt, void* y, int M, int N, int K, void* stream) {
  if (M < 1 || M > kMaxRows || N < 1 || K < kBK || K % kBK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int MP = (M + 15) / 16 * 16;
  const size_t smem = smem_bytes<L, X>(MP);
  // the shared-memory limit of the largest launch, set once per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  bool* limit_set = smem_limit_set<L, X>();
  if (dev >= 64 || !limit_set[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_bytes<L, X>(kMaxRows)));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (kMaxSlices > 8) {   // clusters past the portable size of 8
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    if (dev < 64) limit_set[dev] = true;
  }
  const int S = slices(N, K);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_tiles(N), S, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = S;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const X*>(x), wt, static_cast<float*>(y),
                           M, N, K);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tile
}  // namespace mx
