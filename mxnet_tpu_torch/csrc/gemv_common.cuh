// Shared pieces of the int8 weight-stream kernels (int8_gemv.cu,
// fused_block_decode.cu, lm_head_sample.cu).
//
// Every dot product of an activation row with one int8 weight row is taken
// by ONE warp in ONE fixed order: lane l walks the 16-byte weight chunks
// c = l, l + 32, ... in ascending order, multiplies each of the 16 int8
// values (converted to f32) with the matching f32 activations by explicit
// fmaf in ascending k, and the 32 lane partials are then summed by a xor
// butterfly. That order depends on K alone: not on the number of rows in
// the batch, not on the CTA or warp that runs the row, not on the kernel.
// So a row's logits are the same bits whether it was decoded alone or in a
// batch of eight, and the K3 head GEMV and the K8 fused head agree bit for
// bit (greedy tokens match across the two head paths).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

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

// acc[r] = sum_k xs[r][k] * w[k] for r < nr (xs in shared memory, row
// length K in the swizzle4 layout, K % 16 == 0; w one int8 weight row,
// 16-byte aligned). Every lane of the warp returns the same values.
__device__ __forceinline__ void warp_dot_rows(const float* xs, int nr,
                                              const int8_t* w, int K,
                                              float (&acc)[kRowTile]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < kRowTile; ++r) acc[r] = 0.f;
  const int nchunk = K >> 4;
  const int4* w4 = reinterpret_cast<const int4*>(w);
  for (int c = lane; c < nchunk; c += 32) {
    float wf[16];
    unpack16(__ldg(w4 + c), wf);
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
// fit on the card at once; sets the dynamic shared memory limit first.
template <typename Kernel>
inline cudaError_t resident_ctas(Kernel kernel, size_t smem, int* ctas) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
      cudaSuccess)
    return err;
  *ctas = sms * per_sm;
  return *ctas > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

}  // namespace mx
