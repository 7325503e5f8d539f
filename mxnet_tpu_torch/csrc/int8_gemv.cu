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
    int8_gemv_kernel(const float* __restrict__ x, mx::Int8Rows w, float* __restrict__ y, int M,
                     int N, int K) {
  extern __shared__ __align__(16) float xs[];
  mx::gemv_tiles(xs, x, w, y, M, N, K);
}

}  // namespace

extern "C" int mx_int8_gemv(const void* x, const void* w, const void* s, void* y, int M,
                            int N, int K, void* stream) {
  return mx::launch_gemv(int8_gemv_kernel, x, mx::Int8Rows(w, static_cast<const float*>(s), K, 0),
                         y, M, N, K, stream);
}
