// K3: weight-only int8 GEMV, y[M, N] = x[M, K] @ (w_q[N, K] * s[N]).T
//
// Replaces the TPU kernel mxnet_tpu/ops/int8_gemv.py:int8_weight_matmul
// (pl.pallas_call at int8_gemv.py:160).
//
// Two routes, chosen per call by ops/int8_gemv.py:gemv_route:
//
// Warp route (mx_int8_gemv; decode, M <= 8, and M past gemv_max_m()).
// Bound: the int8 weight bytes (N * K, read once); at 3.35 TB/s the
// 50304 x 768 tied head takes 11.5 us. Each warp streams whole weight rows
// in 16-byte loads per lane (one int8 row is read from device memory once
// per CTA and re-read from L1 for later row tiles), converts to f32 in
// registers and accumulates in f32 against activations kept in f32 in
// shared memory (in a layout the warp reads without bank conflicts, see
// gemv_common.cuh); the per-channel scale multiplies the finished dot. The
// activations stay f32 (the TPU kernel cast them to bf16 for the MXU):
// the stream is weight-bound, so f32 costs nothing and matches the plain
// version's precision. Its dot order is K8's, so the head GEMV + argmax
// and K8 pick the same greedy token. CTAs are sized to the card's resident
// count and stride over the output channels.
//
// x is f32, or bf16 (block 0 of a bf16 model; x_bf16): both routes widen
// bf16 to f32 exactly (the warp route as it stages x, the tile route by
// taking x as its own hi plane, gemv_mma.cuh), so a bf16 call gives the
// f32 call on x.float() bit for bit.
//
// Tile route (mx_int8_gemv_mma; prefill, 9 <= M <= 64). Bound: the larger
// of the bytes and 2 M N K operations at the 989 TFLOP/s bf16 tensor rate;
// bytes bound it (one GPT-2 layer's four GEMVs at 64 rows: 10.25 MB, 3.1
// us). On the warp route those rows cost 8 passes over x, every weight row
// re-read 8 times, and f32 FMAs on the CUDA cores; here the weights stream
// once through a cp.async ring in shared memory into mma.sync with x as
// three bf16 planes (f32 accuracy), K split across a thread-block cluster
// where N alone gives too few CTAs. Design: gemv_mma.cuh.
#include "gemv_common.cuh"
#include "gemv_mma.cuh"

namespace {

template <class X>
__global__ void __launch_bounds__(mx::kThreads)
    int8_gemv_kernel(const X* __restrict__ x, mx::Int8Rows w, float* __restrict__ y, int M,
                     int N, int K) {
  extern __shared__ __align__(16) float xs[];
  mx::gemv_tiles(xs, x, w, y, M, N, K);
}

template <class X>
__global__ void __launch_bounds__(mx::tile::kThreads, mx::tile::kMinCtas)
    int8_gemv_mma_kernel(const X* __restrict__ x, mx::tile::Int8Tile w,
                         float* __restrict__ y, int M, int N, int K) {
  extern __shared__ __align__(128) char smem[];
  mx::tile::gemv_mma(smem, x, w, y, M, N, K);
}

}  // namespace

// x: [M, K] f32, or bf16 where x_bf16 (16-byte aligned rows).
extern "C" int mx_int8_gemv(const void* x, const void* w, const void* s, void* y, int M,
                            int N, int K, int x_bf16, void* stream) {
  const mx::Int8Rows wt(w, static_cast<const float*>(s), K, 0);
  return x_bf16 ? mx::launch_gemv(int8_gemv_kernel<mx::bf16>, x, wt, y, M, N, K, stream)
                : mx::launch_gemv(int8_gemv_kernel<float>, x, wt, y, M, N, K, stream);
}

// 1 <= M <= 64, K % 32 == 0 (ops/int8_gemv.py checks both first).
extern "C" int mx_int8_gemv_mma(const void* x, const void* w, const void* s, void* y, int M,
                                int N, int K, int x_bf16, void* stream) {
  const mx::tile::Int8Tile wt(w, static_cast<const float*>(s), K, 0);
  return x_bf16 ? mx::tile::launch_gemv_mma(int8_gemv_mma_kernel<mx::bf16>, x, wt, y, M, N, K,
                                            stream)
                : mx::tile::launch_gemv_mma(int8_gemv_mma_kernel<float>, x, wt, y, M, N, K,
                                            stream);
}
