// Shared pieces of the flash-attention kernels (flash_attention_fwd.cu, K1,
// and flash_attention_bwd.cu, K2).
//
// Layout: q, o, do, dq are (B, H, T, D) and k, v, dk, dv are (B, H, S, D),
// contiguous, in the storage type (f32 or bf16); lse is (B, H, T) f32. One
// CTA works on one tile of rows of one (b, h). Tiles live in shared memory
// with the head dimension zero-padded to DP (64, 128 or 256: the TPU
// kernel's padding, done here by masked loads, not by padded copies in
// device memory) and rows past T or S zero-filled.
//
// Each kernel has two bodies, chosen by the storage type:
// - bf16: tensor cores through mma.sync m16n8k16 (bf16 in, f32 out). Each
//   warp owns 16 rows of the tile and one 64-column slice of the head dim
//   for its accumulators, which stay in registers; score tiles never leave
//   registers either (the C fragment of S is the A fragment of P). Operand
//   fragments come from the shared tiles by ldmatrix.
// - f32: plain f32 FMA on the CUDA cores through tile_mm over shared tiles,
//   so the f32 path agrees with the CPU to f32 rounding; TF32 tensor cores
//   would keep only 10 mantissa bits.
// The softmax statistics and every elementwise pass are f32 in both.
#pragma once

#include <cfloat>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_common.cuh"

namespace mxfa {

using mx::mma16816;

// jnp.finfo(float32).min: the TPU kernel's mask value (not -inf, so that
// max/exp never see inf - inf)
constexpr float kMaskValue = -FLT_MAX;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// Bump allocator over dynamic shared memory: every array starts on a
// 128-byte boundary.
struct Smem {
  char* p;
  size_t off;
  template <typename U>
  __device__ U* take(size_t n) {
    off = (off + 127) & ~size_t(127);
    U* r = reinterpret_cast<U*>(p + off);
    off += n * sizeof(U);
    return r;
  }
};

template <typename U>
__host__ __device__ constexpr size_t span(size_t n) {
  return ((n * sizeof(U)) + 127) & ~size_t(127);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Number of key tiles a causal query tile [q0, q0 + BQ) visits: keys up to
// the last valid row's limit (q_last + S - T), end-aligned as in the TPU
// kernel (attention.py:331-340).
__device__ __forceinline__ int kv_tiles(int q0, int BQ, int BK, int T, int S, bool causal) {
  const int nkv = (S + BK - 1) / BK;
  if (!causal) return nkv;
  const int q_last = min(q0 + BQ, T) - 1;
  const int last_key = q_last + (S - T);
  return max(0, min(nkv, last_key / BK + 1));
}

// Stage rows [row0, row0 + R) of a (rows, D) matrix into a shared tile of
// R x DP (leading dimension ld), zero past `rows` and past D. NT threads
// take part. bf16 rows move in 16-byte chunks when D is a multiple of 8.
template <int R, int DP, int NT, typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* __restrict__ src,
                                          int row0, int rows, int D) {
  constexpr int kVec = 16 / sizeof(T);
  if (sizeof(T) == 2 && D % kVec == 0) {
    constexpr int CH = DP / kVec;
    for (int i = threadIdx.x; i < R * CH; i += NT) {
      const int r = i / CH, c = (i % CH) * kVec;
      const int g = row0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (g < rows && c < D) v = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(g) * D + c);
      *reinterpret_cast<uint4*>(dst + r * ld + c) = v;
    }
    return;
  }
  for (int i = threadIdx.x; i < R * DP; i += NT) {
    const int r = i / DP, c = i % DP;
    const int g = row0 + r;
    dst[r * ld + c] = (g < rows && c < D) ? src[static_cast<size_t>(g) * D + c] : T(0.f);
  }
}

// lse and delta = sum(do * o) over the real head dim for query rows
// [q0, q0 + R), both 0 past T. The NT threads split each row among NT / R
// neighbouring lanes of one warp (16-byte loads for bf16 rows with D a
// multiple of 8), whose partial sums meet by shuffles in a fixed order.
template <int R, int NT, typename T>
__device__ __forceinline__ void row_stats(float* sLse, float* sDelta, const float* lseb,
                                          const T* ob, const T* dob, int q0, int T_, int D) {
  constexpr int TPR = NT / R;
  static_assert(NT % R == 0 && TPR <= 32 && (TPR & (TPR - 1)) == 0, "row split");
  const int r = threadIdx.x / TPR, part = threadIdx.x % TPR;
  const int g = q0 + r;
  float acc = 0.f;
  if (g < T_) {
    const T* orow = ob + static_cast<size_t>(g) * D;
    const T* dorow = dob + static_cast<size_t>(g) * D;
    if constexpr (sizeof(T) == 2) {
      if (D % 8 == 0) {
        for (int c = part * 8; c < D; c += TPR * 8) {
          const uint4 a = *reinterpret_cast<const uint4*>(orow + c);
          const uint4 b = *reinterpret_cast<const uint4*>(dorow + c);
          const T* pa = reinterpret_cast<const T*>(&a);
          const T* pb = reinterpret_cast<const T*>(&b);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc += to_f32(pb[j]) * to_f32(pa[j]);
        }
      } else {
        for (int c = part; c < D; c += TPR) acc += to_f32(dorow[c]) * to_f32(orow[c]);
      }
    } else {
      for (int c = part; c < D; c += TPR) acc += to_f32(dorow[c]) * to_f32(orow[c]);
    }
  }
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (part == 0) {
    sDelta[r] = acc;
    sLse[r] = g < T_ ? lseb[g] : 0.f;
  }
}

// ---------------------------------------------------------------------------
// f32 body: tiles in shared memory, products by tile_mm on the CUDA cores.
// ---------------------------------------------------------------------------
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
// Row padding of f32 shared tiles: tile_mm reads columns of B with lanes
// one row apart, so an odd stride keeps those reads free of bank conflicts.
constexpr int kPad = 1;

// Tile sizes of the f32 body for a head dim DP: query rows per tile (BQ)
// and key rows per tile (BK), chosen so that each kernel's shared memory
// fits the 227 KB a CTA may use on Hopper.
template <int DP>
struct FwdTile {
  static constexpr int BQ = 64;
  static constexpr int BK = DP <= 128 ? 64 : 32;
};
template <int DP>
struct BwdTile {
  static constexpr int BQ = DP == 64 ? 64 : 32;
  static constexpr int BK = DP <= 128 ? 64 : 32;
};

template <int R, int C>
__device__ __forceinline__ void zero_f32(float* dst, int ld) {
  for (int i = threadIdx.x; i < R * C; i += kThreads) dst[(i / C) * ld + i % C] = 0.f;
}

// Write rows [row0, row0 + R) x [0, D) of an f32 shared tile to a (rows, D)
// f32 matrix, skipping rows past `rows`. `div` (may be null) divides row r
// by div[r].
template <int R, int DP>
__device__ __forceinline__ void store_tile(float* __restrict__ dst, const float* src, int ld,
                                           int row0, int rows, int D, const float* div) {
  for (int i = threadIdx.x; i < R * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    const int g = row0 + r;
    if (g < rows && c < D) {
      const float x = src[r * ld + c];
      dst[static_cast<size_t>(g) * D + c] = div ? x / div[r] : x;
    }
  }
}

// C[M][N] (+)= A[M][K] * B[K][N] over f32 shared tiles. A is row-major
// (element (m, k) at a[m * lda + k]) or column-major (a[k * lda + m]); B is
// row-major (b[k * ldb + n]) or column-major (b[n * ldb + k]). C is
// row-major, leading dimension ldc. kThreads threads as 16 x 16, each
// owning a strided (M/16) x (N/16) block of C; the caller synchronises
// before and after.
template <int M, int N, int K, bool A_ROW, bool B_ROW, bool ACC>
__device__ __forceinline__ void tile_mm(float* c, int ldc, const float* a, int lda,
                                        const float* b, int ldb) {
  static_assert(M % 16 == 0 && N % 16 == 0, "tile shape");
  constexpr int RM = M / 16, RN = N / 16;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = ACC ? c[(ty + 16 * i) * ldc + tx + 16 * j] : 0.f;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[RM], bv[RN];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int m = ty + 16 * i;
      av[i] = A_ROW ? a[m * lda + k] : a[k * lda + m];
    }
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int n = tx + 16 * j;
      bv[j] = B_ROW ? b[k * ldb + n] : b[n * ldb + k];
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) c[(ty + 16 * i) * ldc + tx + 16 * j] = acc[i][j];
}

// ---------------------------------------------------------------------------
// bf16 body: mma.sync m16n8k16 with register-resident fragments.
//
// Fragment layouts: mma_common.cuh (mma16816). The C fragments of two
// neighbouring 8-column tiles of S are exactly the A fragment of the
// 16-column block of P: scores never leave registers.
// ---------------------------------------------------------------------------
template <int DP>
struct MmaCfg {
  static constexpr int BQ = 64, BK = 64;       // query and key rows per tile
  static constexpr int SLICES = DP / 64;       // 64-column accumulator slices
  static constexpr int WARPS = 4 * SLICES;     // 4 row groups of 16 x slices
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int LD = DP + 8;            // bf16 row stride of shared tiles
};

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  const bf16 l = __float2bfloat16(lo), h = __float2bfloat16(hi);
  return static_cast<uint32_t>(__bfloat16_as_ushort(l)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(h)) << 16);
}

// ldmatrix: four 8 x 8 bf16 matrices from shared memory, one register each.
// Lanes 8i..8i+7 give the addresses of matrix i's eight rows (16 bytes
// each). Plain: lane 4g + t gets row g, columns 2t, 2t+1. With .trans: row
// 2t and 2t+1 of column g, i.e. the matrix transposed. The tiles' row
// stride (LD = DP + 8 bf16, 16 bytes past a multiple of 128) puts the eight
// rows of a matrix in distinct banks.
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// A fragment of the 16 x 16 block at (r0, k0) of a row-major shared tile:
// matrices (rows +0/+8, columns +0/+8) in the order a0..a3.
__device__ __forceinline__ void frag_a(uint32_t a[4], const bf16* t, int ld, int r0, int k0,
                                       int lane) {
  ldsm_x4(a, t + (r0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}

// B fragments of two neighbouring n-tiles (n0 and n0 + 8) with
// B[k][n] = t[n0 + n][k0 + k]: the tile's rows are B's columns (k^T in
// q k^T, v^T in do v^T, q^T and do^T in the dk/dv kernel). b[0..1] belong to
// n-tile n0, b[2..3] to n0 + 8.
__device__ __forceinline__ void frag_b_t2(uint32_t b[4], const bf16* t, int ld, int n0, int k0,
                                          int lane) {
  ldsm_x4(b, t + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 + ((lane >> 3) & 1) * 8);
}

// The same with B[k][n] = t[k0 + k][n0 + n]: the tile's rows are B's rows
// (v in p v, k in ds k, do and q in the dk/dv kernel), read transposed.
__device__ __forceinline__ void frag_b2(uint32_t b[4], const bf16* t, int ld, int k0, int n0,
                                        int lane) {
  ldsm_x4_trans(b, t + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 + (lane >> 4) * 8);
}

// A fragments of the 16 x 16 block kt of a 16-row f32 score tile held as
// C fragments s[n-tile][4], rounded to bf16.
template <int N>
__device__ __forceinline__ void frag_a_from_c(uint32_t a[4], const float (&s)[N][4], int kt) {
  a[0] = pack_f32(s[2 * kt][0], s[2 * kt][1]);
  a[1] = pack_f32(s[2 * kt][2], s[2 * kt][3]);
  a[2] = pack_f32(s[2 * kt + 1][0], s[2 * kt + 1][1]);
  a[3] = pack_f32(s[2 * kt + 1][2], s[2 * kt + 1][3]);
}

// acc[N][4] (16 rows x 8N columns) = (rows r0.. of a) * (rows 0..8N of b)^T
// over the shared tiles' first K columns.
template <int N, int K>
__device__ __forceinline__ void mma_abt(float (&acc)[N][4], const bf16* a, const bf16* b,
                                        int ld, int r0, int lane) {
  static_assert(N % 2 == 0, "n-tiles are loaded in pairs");
#pragma unroll
  for (int n = 0; n < N; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int kt = 0; kt < K / 16; ++kt) {
    // all of the k-step's fragments first, then its products
    uint32_t fa[4], fb[N / 2][4];
    frag_a(fa, a, ld, r0, kt * 16, lane);
#pragma unroll
    for (int n = 0; n < N / 2; ++n) frag_b_t2(fb[n], b, ld, n * 16, kt * 16, lane);
#pragma unroll
    for (int n = 0; n < N / 2; ++n) {
      mma16816(acc[2 * n], fa, fb[n]);
      mma16816(acc[2 * n + 1], fa, fb[n] + 2);
    }
  }
}

// acc[N][4] += p * (rows 0..16 KS of b, columns c0.. c0 + 8N), with p held
// as C fragments over KS 16-column blocks.
template <int N, int KS, int NP>
__device__ __forceinline__ void mma_pb(float (&acc)[N][4], const float (&p)[NP][4], const bf16* b,
                                       int ld, int c0, int lane) {
  static_assert(N % 2 == 0, "n-tiles are loaded in pairs");
#pragma unroll
  for (int kt = 0; kt < KS; ++kt) {
    uint32_t fa[4], fb[N / 2][4];
    frag_a_from_c(fa, p, kt);
#pragma unroll
    for (int n = 0; n < N / 2; ++n) frag_b2(fb[n], b, ld, kt * 16, c0 + n * 16, lane);
#pragma unroll
    for (int n = 0; n < N / 2; ++n) {
      mma16816(acc[2 * n], fa, fb[n]);
      mma16816(acc[2 * n + 1], fa, fb[n] + 2);
    }
  }
}

}  // namespace mxfa
