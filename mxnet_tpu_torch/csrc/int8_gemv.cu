// K3: weight-only int8 GEMV, y[M, N] = x[M, K] @ (w_q[N, K] * s[N]).T
//
// Replaces the TPU kernel mxnet_tpu/ops/int8_gemv.py:int8_weight_matmul
// (pl.pallas_call at int8_gemv.py:160).
//
// Bound: at decode row counts (M <= 64) the int8 weight bytes dominate
// (N * K bytes, read once); at 3.35 TB/s the 50304 x 768 tied head takes
// 11.5 us. At M = 64 the f32 FMAs on the CUDA cores (67 TFLOP/s) become the
// larger bound.
//
// Design against that bound: each warp streams whole weight rows in
// 16-byte loads per lane (one int8 row is read from device memory once per
// CTA and re-read from L1 for later row tiles), converts to f32 in
// registers and accumulates in f32 against activations kept in f32 in
// shared memory (in a layout the warp reads without bank conflicts, see
// gemv_common.cuh); the per-channel scale multiplies the finished dot. The
// activations stay f32 (the TPU kernel cast them to bf16 for the MXU): the
// stream is weight-bound, so f32 costs nothing and matches the plain
// version's precision. CTAs are sized to the card's resident count and
// stride over the output channels, so the activation tile is staged once
// per CTA, not once per channel.
#include "gemv_common.cuh"

namespace {

__global__ void __launch_bounds__(mx::kThreads)
    int8_gemv_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                     const float* __restrict__ s, float* __restrict__ y, int M,
                     int N, int K) {
  extern __shared__ __align__(16) float xs[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r0 = 0; r0 < M; r0 += mx::kRowTile) {
    const int nr = min(mx::kRowTile, M - r0);
    __syncthreads();
    mx::stage_rows(xs, x, r0, nr, K);
    __syncthreads();
    for (int n = blockIdx.x * mx::kWarps + warp; n < N; n += gridDim.x * mx::kWarps) {
      float acc[mx::kRowTile];
      mx::warp_dot_rows(xs, nr, w + static_cast<size_t>(n) * K, K, acc);
      const float sc = __ldg(s + n);
#pragma unroll
      for (int r = 0; r < mx::kRowTile; ++r) {
        if (lane == r && r < nr) y[static_cast<size_t>(r0 + r) * N + n] = acc[r] * sc;
      }
    }
  }
}

}  // namespace

extern "C" int mx_int8_gemv(const void* x, const void* w, const void* s, void* y, int M,
                            int N, int K, void* stream) {
  const size_t smem = sizeof(float) * mx::kRowTile * K;
  int ctas = 0;
  cudaError_t err = mx::resident_ctas(int8_gemv_kernel, smem, &ctas);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int want = (N + mx::kWarps - 1) / mx::kWarps;
  const int grid = want < ctas ? want : ctas;
  int8_gemv_kernel<<<grid, mx::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(s), static_cast<float*>(y), M, N, K);
  return static_cast<int>(cudaGetLastError());
}
