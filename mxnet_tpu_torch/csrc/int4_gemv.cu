// K4: weight-only int4 GEMV, y[M, N] = x[M, K] @ dequant(w_p[N, K/2], s[N, K/block]).T
// with dequant(w)[n, k] = (nibble k of row n - 8) * s[n, k / block].
//
// Replaces the TPU kernel mxnet_tpu/ops/int8_gemv.py:int4_weight_matmul
// (pl.pallas_call at int8_gemv.py:237).
//
// Bound: at decode row counts (M <= 64) the packed weight bytes dominate
// (N * K / 2 bytes plus N * K / block * 4 bytes of scales, read once); at
// 3.35 TB/s the 50304 x 768 tied head (19.3 MB + 1.2 MB) takes 6.1 us. At
// M = 64 the f32 FMAs on the CUDA cores (67 TFLOP/s) become the larger
// bound.
//
// Design against that bound: K3's (int8_gemv.cu) with the int4 lane of
// gemv_common.cuh: each warp streams whole rows in 8-byte loads per lane
// (16 codes), unpacks the lo then the hi nibble of each byte, multiplies
// each code by its block scale in registers and accumulates in f32 against
// activations kept in f32 in shared memory. The TPU kernel dequantized a
// (bn, K) tile in VMEM and cast x to bf16 for the MXU; here x stays f32
// (the stream is weight-bound) and the dot order is the one K8's int4 lane
// takes, so the int4 head GEMV + argmax and K8's greedy rows select the
// same token bit for bit.
#include "gemv_common.cuh"

namespace {

__global__ void __launch_bounds__(mx::kThreads)
    int4_gemv_kernel(const float* __restrict__ x, mx::Int4Rows w, float* __restrict__ y, int M,
                     int N, int K) {
  extern __shared__ __align__(16) float xs[];
  mx::gemv_tiles(xs, x, w, y, M, N, K);
}

}  // namespace

// w: [N, K / 2] uint8 nibble pairs; s: [N, K / block] f32; K % 16 == 0,
// block % 16 == 0 (ops/int8_gemv.int4_chunks_fit).
extern "C" int mx_int4_gemv(const void* x, const void* w, const void* s, void* y, int M,
                            int N, int K, int block, void* stream) {
  if (K % 16 || block < 16 || block % 16 || K % block) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return mx::launch_gemv(int4_gemv_kernel, x,
                         mx::Int4Rows(w, static_cast<const float*>(s), K, block), y, M, N, K,
                         stream);
}
