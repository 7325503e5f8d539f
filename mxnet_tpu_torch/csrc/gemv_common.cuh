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
// bit: stage_rows widens it as it stages, the warp route at read.
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

// Shared-memory layout of a staged f32 activation row of length K: the
// row is K / 16 chunks of four float4 words; word q of chunk c is stored
// at float4 index q * (K / 16) + c. In warp_dot_rows lane l reads chunk
// l (+ 32 i), so for each q the warp reads 32 consecutive float4 words,
// free of bank conflicts (in row order the lanes would sit 64 bytes
// apart: a 4-way conflict on every load). `w` is the float4 word index
// k / 4 in row order.
__device__ __forceinline__ int swizzle4(int w, int K) {
  return (w & 3) * (K >> 4) + (w >> 2);
}

__device__ __forceinline__ void unpack16(const int4 v, float* f) {
  const int words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      f[4 * q + j] = static_cast<float>(static_cast<int8_t>(words[q] >> (8 * j)));
    }
  }
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

// Copy rows [r0, r0 + nr) of the row-major f32 matrix src (row length K)
// into shared memory dst[nr][K], each row in the swizzle4 layout. Called
// by the whole CTA.
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int r0,
                                           int nr, int K) {
  const float4* s4 = reinterpret_cast<const float4*>(src + static_cast<size_t>(r0) * K);
  float4* d4 = reinterpret_cast<float4*>(dst);
  const int kw = K >> 2;
  for (int i = threadIdx.x; i < nr * kw; i += blockDim.x) {
    const int r = i / kw;
    d4[r * kw + swizzle4(i - r * kw, K)] = s4[i];
  }
}

// The same from a bf16 matrix (16-byte aligned rows, K % 8 == 0): each
// thread loads 8 bf16 (16 bytes) and stores them widened as two float4
// words.
__device__ __forceinline__ void stage_rows(float* dst, const bf16* src, int r0, int nr,
                                           int K) {
  const uint4* s8 = reinterpret_cast<const uint4*>(src + static_cast<size_t>(r0) * K);
  float4* d4 = reinterpret_cast<float4*>(dst);
  const int kw = K >> 2, k8 = K >> 3;
  for (int i = threadIdx.x; i < nr * k8; i += blockDim.x) {
    const int r = i / k8, c = i - r * k8;
    const uint4 v = s8[i];
    d4[r * kw + swizzle4(2 * c, K)] = widen4(make_uint2(v.x, v.y));
    d4[r * kw + swizzle4(2 * c + 1, K)] = widen4(make_uint2(v.z, v.w));
  }
}

// Codes 16c .. 16c + 15 of an int4 row from its chunk c, 8 bytes of
// nibble pairs: code 2i is the lo nibble of byte i, code 2i + 1 the hi
// nibble, each stored as code + 8 (kvstore/quant.py:pack_codes). Each code
// times its block scale `sc`, rounded to f32, as the plain version's
// dequantize_blocks rounds it.
__device__ __forceinline__ void unpack_nibbles16(const uint2 v, float sc, float* f) {
  const uint32_t words[2] = {v.x, v.y};
#pragma unroll
  for (int q = 0; q < 2; ++q) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t b = words[q] >> (8 * j);
      f[8 * q + 2 * j] = static_cast<float>(static_cast<int>(b & 0xFu) - 8) * sc;
      f[8 * q + 2 * j + 1] = static_cast<float>(static_cast<int>((b >> 4) & 0xFu) - 8) * sc;
    }
  }
}

// int8 lane: rows [N, K] int8 (16-byte aligned rows, K % 16 == 0) and one
// f32 scale per row, applied after the dot.
struct Int8Rows {
  const int8_t* w;
  const float* s;  // [N]
  int K;
  __host__ __device__ Int8Rows(const void* w_, const float* s_, int K_, int /*block*/)
      : w(static_cast<const int8_t*>(w_)), s(s_), K(K_) {}
  __device__ __forceinline__ void chunk(int n, int c, float* f) const {
    unpack16(__ldg(reinterpret_cast<const int4*>(w + static_cast<size_t>(n) * K) + c), f);
  }
  __device__ __forceinline__ float scale(int n) const { return __ldg(s + n); }
};

// int4 lane: rows [N, K / 2] uint8 of nibble pairs (K % 16 == 0, so a row
// is whole 8-byte chunks) and f32 block scales [N, K / block]. A chunk's 16
// codes lie in one block (block % 16 == 0, gated by the wrappers), so one
// scale serves the chunk. The scale after the dot is 1 (x * 1 is exact).
struct Int4Rows {
  const uint8_t* w;
  const float* s;  // [N, K / block]
  int K, nsb, cpb;  // row length, scale blocks per row, chunks per block
  __host__ __device__ Int4Rows(const void* w_, const float* s_, int K_, int block)
      : w(static_cast<const uint8_t*>(w_)), s(s_), K(K_), nsb(K_ / block), cpb(block >> 4) {}
  __device__ __forceinline__ void chunk(int n, int c, float* f) const {
    const uint2 v =
        __ldg(reinterpret_cast<const uint2*>(w + static_cast<size_t>(n) * (K >> 1)) + c);
    unpack_nibbles16(v, __ldg(s + static_cast<size_t>(n) * nsb + c / cpb), f);
  }
  __device__ __forceinline__ float scale(int) const { return 1.f; }
};

// acc[r] = sum_k xs[r][k] * w_n[k] for r < nr (xs in shared memory, row
// length K in the swizzle4 layout, K % 16 == 0; w_n row n of the lane's
// table, as f32 weights). Every lane of the warp returns the same values.
template <class W>
__device__ __forceinline__ void warp_dot_rows(const float* xs, int nr, const W& wt, int n,
                                              int K, float (&acc)[kRowTile]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < kRowTile; ++r) acc[r] = 0.f;
  const int nchunk = K >> 4;
  for (int c = lane; c < nchunk; c += 32) {
    float wf[16];
    wt.chunk(n, c, wf);
#pragma unroll
    for (int r = 0; r < kRowTile; ++r) {
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
#pragma unroll
  for (int r = 0; r < kRowTile; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
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
