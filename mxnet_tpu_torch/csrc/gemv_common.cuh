// Shared pieces of the weight-stream kernels (int8_gemv.cu, int4_gemv.cu,
// the block decode kernels, lm_head_sample.cu).
//
// Every dot product of an activation row with one weight row is taken by
// ONE warp in ONE fixed order: lane l walks the 16-code weight chunks
// c = l, l + 32, ... in ascending order, turns each chunk's 16 codes into
// f32 weights, multiplies them with the matching f32 activations by
// explicit fmaf in ascending k, and the 32 lane partials are then summed by
// a xor butterfly. That order depends on K alone: not on the number of rows
// in the batch, not on the CTA or warp that runs the row, not on the kernel.
// So a row's logits are the same bits whether it was decoded alone or in a
// batch of eight, and the head GEMV (K3, or K4 for an int4 table) and the
// K8 fused head agree bit for bit (greedy tokens match across the two head
// paths).
//
// Both halves of that contract hold on the warp route of K3 and K4
// (gemv_warp.cuh: the same sums, its own data movement), which takes M <= 8
// rows (decode batches). Prefill rows, 9 <= M <= 64, take the tile route
// (gemv_mma.cuh): tensor cores over x as three bf16 planes, in another
// fixed order. Its rows are the same bits at any M from 9 to 64 and on
// every launch, and agree with the warp route (and with K8) to rounding,
// not bit for bit.
//
// The activations come as f32 or bf16 rows (the model's dtype at block 0 of
// a bf16 model; K8's h in a model whose head sees bf16). A bf16 value is
// exact in f32, so every dot above is the f32 lane's on x.float(), bit for
// bit: the block kernels widen it as they stage it, the warp route (K3, K4,
// K8) as it reads it.
//
// Two weight lanes feed that loop (Int8Rows, Int4Rows below). An int8 chunk
// is 16 bytes and its codes are the weights; the row's f32 scale multiplies
// the finished dot. An int4 chunk is 8 bytes of nibble pairs; each code is
// multiplied by its f32 block scale BEFORE its FMA (the TPU kernel's order:
// dequantize, then dot), and the scale after the dot is 1.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <mutex>
#include <utility>
#include <vector>

namespace mx {

constexpr int kWarps = 8;              // warps per CTA
constexpr int kThreads = 32 * kWarps;  // threads per CTA
constexpr int kRowTile = 8;            // activation rows staged per pass
constexpr int kWideRowTile = 16;       // ... by the block kernels past kRowTile rows

// Shared-memory layout of a staged f32 activation row of length K: the
// row is K / 16 chunks of four float4 words; word q of chunk c is stored
// at float4 index q * (K / 16) + c. In the warp dot lane l reads chunk
// l (+ 32 i), so for each q the warp reads 32 consecutive float4 words,
// free of bank conflicts (in row order the lanes would sit 64 bytes
// apart: a 4-way conflict on every load). `w` is the float4 word index
// k / 4 in row order.
__device__ __forceinline__ int swizzle4(int w, int K) {
  return (w & 3) * (K >> 4) + (w >> 2);
}

typedef __nv_bfloat16 bf16;

// Four bf16 (8 bytes) widened to f32, exactly.
__device__ __forceinline__ float4 widen4(const uint2 v) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// Four int8 codes (one 32-bit word) as exact f32 values: byte b + 128 is
// placed under the exponent of 2^23, and 2^23 + 128 is subtracted (the
// integer ALU and one FMA-pipe subtraction, not I2F conversions, which run
// at a quarter of the FMA rate on sm_90).
__device__ __forceinline__ void i8x4(const int w, float (&f)[4]) {
  const uint32_t u = static_cast<uint32_t>(w) ^ 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u + j)) - 8388736.f;
  }
}

// Nibble code byte j of `nib` (0..15, stored as code + 8) as the exact f32
// value code - 8.
__device__ __forceinline__ float nib_f32(const uint32_t nib, int j) {
  return __uint_as_float(__byte_perm(nib, 0x4B000000u, 0x7540u + j)) - 8388616.f;
}

// int8 lane: rows [N, K] int8 (16-byte aligned rows, K % 16 == 0) and one
// f32 scale per row, applied after the dot. A chunk is 16 codes (one int4).
struct Int8Rows {
  typedef int4 Raw;
  const int8_t* w;
  const float* s;  // [N]
  int K;
  __host__ __device__ Int8Rows(const void* w_, const float* s_, int K_, int /*block*/)
      : w(static_cast<const int8_t*>(w_)), s(s_), K(K_) {}
  __device__ __forceinline__ Raw raw(int n, int c) const {
    return __ldg(reinterpret_cast<const int4*>(w + static_cast<size_t>(n) * K) + c);
  }
  __device__ __forceinline__ float raw_scale(int, int) const { return 1.f; }
  // weights 4q .. 4q + 3 of the chunk
  __device__ static __forceinline__ void word(const Raw& v, int q, float, float (&f)[4]) {
    i8x4(q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w, f);
  }
  __device__ __forceinline__ float scale(int n) const { return __ldg(s + n); }
};

// int4 lane: rows [N, K / 2] uint8 of nibble pairs (K % 16 == 0, so a row
// is whole 8-byte chunks) and f32 block scales [N, K / block]. A chunk's 16
// codes lie in one block (block % 16 == 0, gated by the wrappers), so one
// scale serves the chunk: code 2i is the lo nibble of byte i, code 2i + 1
// the hi nibble, each stored as code + 8 (kvstore/quant.py:pack_codes),
// each times its block scale and rounded to f32 (the plain version's
// dequantize_blocks) BEFORE its FMA. The scale after the dot is 1.
struct Int4Rows {
  typedef uint2 Raw;
  const uint8_t* w;
  const float* s;  // [N, K / block]
  int K, nsb, cpb;  // row length, scale blocks per row, chunks per block
  __host__ __device__ Int4Rows(const void* w_, const float* s_, int K_, int block)
      : w(static_cast<const uint8_t*>(w_)), s(s_), K(K_), nsb(K_ / block), cpb(block >> 4) {}
  __device__ __forceinline__ Raw raw(int n, int c) const {
    return __ldg(reinterpret_cast<const uint2*>(w + static_cast<size_t>(n) * (K >> 1)) + c);
  }
  __device__ __forceinline__ float raw_scale(int n, int c) const {
    return __ldg(s + static_cast<size_t>(n) * nsb + c / cpb);
  }
  // codes 4q .. 4q + 3 of the chunk: lo, hi nibble of byte 2q, then of
  // byte 2q + 1, each times the block scale
  __device__ static __forceinline__ void word(const Raw& v, int q, float sc, float (&f)[4]) {
    const uint32_t w = (q < 2) ? v.x : v.y;
    const uint32_t lo = w & 0x0F0F0F0Fu, hi = (w >> 4) & 0x0F0F0F0Fu;
    const int b = (2 * q) & 3;
    f[0] = nib_f32(lo, b) * sc;
    f[1] = nib_f32(hi, b) * sc;
    f[2] = nib_f32(lo, b + 1) * sc;
    f[3] = nib_f32(hi, b + 1) * sc;
  }
  __device__ __forceinline__ float scale(int) const { return 1.f; }
};

// One step of the transposed butterfly at lane mask Mask over the first
// 2 H partials: a lane keeps the half whose index bit matches its lane bit
// and adds its partner's partial of the same value; then the next step.
template <int V, int H, int Mask>
__device__ __forceinline__ void scatter_step(float (&a)[V], int lane) {
  const bool up = lane & Mask;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? a[i] : a[i + H];
    const float keep = up ? a[i + H] : a[i];
    a[i] = keep + __shfl_xor_sync(0xffffffffu, send, Mask);
  }
  if constexpr (H > 1) scatter_step<V, H / 2, Mask / 2>(a, lane);
}

template <int V>
struct Log2 {
  static constexpr int v = V <= 1 ? 0 : 1 + Log2<V / 2>::v;
};
template <>
struct Log2<1> {
  static constexpr int v = 0;
};

// Transposed butterfly over V lane partials (a power of two, at most 32):
// returns value lane >> (5 - log2 V), summed over the warp exactly as the
// xor butterfly (masks 16, 8, 4, 2, 1) sums each value: every value sees
// the same pairs in the same order (a + b == b + a), in V - 1 + 5 - log2 V
// shuffles instead of 5 V.
template <int V>
__device__ __forceinline__ float scatter_sum(float (&a)[V]) {
  static_assert(V >= 1 && V <= 32 && (V & (V - 1)) == 0, "V: a power of two up to 32");
  const int lane = threadIdx.x & 31;
  if constexpr (V > 1) scatter_step<V, V / 2, 16>(a, lane);
#pragma unroll
  for (int m = 16 >> Log2<V>::v; m > 0; m >>= 1) a[0] += __shfl_xor_sync(0xffffffffu, a[0], m);
  return a[0];
}

// acc[r] += xs[r] . the 16 weights wf of chunk c (fmaf in ascending k), for
// the staged rows r < nr of R (xs in shared memory, row length K in the
// swizzle4 layout).
template <int R>
__device__ __forceinline__ void fma_chunk(const float* xs, int nr, int K, int c,
                                          const float (&wf)[16], float (&acc)[R]) {
  const int nchunk = K >> 4;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < nr) {
      const float4* xr = reinterpret_cast<const float4*>(xs + r * K) + c;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 xv = xr[q * nchunk];
        acc[r] = fmaf(xv.x, wf[4 * q + 0], acc[r]);
        acc[r] = fmaf(xv.y, wf[4 * q + 1], acc[r]);
        acc[r] = fmaf(xv.z, wf[4 * q + 2], acc[r]);
        acc[r] = fmaf(xv.w, wf[4 * q + 3], acc[r]);
      }
    }
  }
}

// A lane's chunks of one row, in batches of kBatch: batch j holds chunks
// c = lane + 32 (kBatch j + i), i < kBatch (those below K / 16).
constexpr int kBatch = 3;

template <class W>
__device__ __forceinline__ void load_batch(const W& wt, int n, int j, int nchunk,
                                           typename W::Raw (&raw)[kBatch],
                                           float (&sc)[kBatch]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kBatch; ++i) {
    const int c = lane + 32 * (kBatch * j + i);
    if (c < nchunk) {
      raw[i] = wt.raw(n, c);
      sc[i] = wt.raw_scale(n, c);
    }
  }
}

// acc[r] += the lane's partial of row r's dot with the batch's chunks (r <
// nr), fmaf in ascending k: over the batches of a row in order, the lane
// walks its chunks lane, lane + 32, ... in ascending order.
template <class W, int R>
__device__ __forceinline__ void dot_batch(const float* xs, int nr, int K, int j,
                                          const typename W::Raw (&raw)[kBatch],
                                          const float (&sc)[kBatch], float (&acc)[R]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kBatch; ++i) {
    const int c = lane + 32 * (kBatch * j + i);
    if (c < (K >> 4)) {
      float wf[16];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float f[4];
        W::word(raw[i], q, sc[i], f);
#pragma unroll
        for (int e = 0; e < 4; ++e) wf[4 * q + e] = f[e];
      }
      fma_chunk(xs, nr, K, c, wf, acc);
    }
  }
}

// Number of CTAs of `kernel` (kThreads threads, `smem` dynamic bytes) that
// fit on the card at once. The query runs once per
// (kernel, smem, device) in a process and is cached (a serving step
// launches dozens of kernels; each query is a few CUDA runtime calls). The
// dynamic shared memory limit of a kernel is raised, never lowered, so a
// cached count stays valid after a later call raised it.
template <typename Kernel>
inline cudaError_t resident_ctas(Kernel kernel, size_t smem, int* ctas) {
  struct Entry {
    const void* fn;
    size_t smem;
    int dev, ctas;
  };
  struct Limit {
    const void* fn;
    int dev;
    size_t smem;
  };
  static std::mutex mu;
  static std::vector<Entry> cache;
  static std::vector<Limit> limits;
  const void* fn = reinterpret_cast<const void*>(kernel);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& e : cache) {
    if (e.fn == fn && e.smem == smem && e.dev == dev) {
      *ctas = e.ctas;
      return cudaSuccess;
    }
  }
  Limit* lim = nullptr;
  for (Limit& l : limits) {
    if (l.fn == fn && l.dev == dev) lim = &l;
  }
  if (lim == nullptr || lim->smem < smem) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    if (lim == nullptr) {
      limits.push_back(Limit{fn, dev, smem});
    } else {
      lim->smem = smem;
    }
  }
  int sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
      cudaSuccess)
    return err;
  if (sms * per_sm <= 0) return cudaErrorInvalidConfiguration;
  cache.push_back(Entry{fn, smem, dev, sms * per_sm});
  *ctas = sms * per_sm;
  return cudaSuccess;
}

// The most dynamic shared memory a CTA may take on the current device and
// its SM count (cached per device).
inline cudaError_t device_limits(int* smem_bytes, int* sms) {
  struct Entry {
    int dev, smem, sms;
  };
  static std::mutex mu;
  static std::vector<Entry> cache;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& e : cache) {
    if (e.dev == dev) {
      *smem_bytes = e.smem;
      *sms = e.sms;
      return cudaSuccess;
    }
  }
  if ((err = cudaDeviceGetAttribute(smem_bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return err;
  if ((err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  cache.push_back(Entry{dev, *smem_bytes, *sms});
  return cudaSuccess;
}

}  // namespace mx
