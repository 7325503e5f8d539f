// K3: weight-only int8 GEMV, y[M, N] = x[M, K] @ (w_q[N, K] * s[N]).T
//
// Replaces the TPU kernel mxnet_tpu/ops/int8_gemv.py:int8_weight_matmul
// (pl.pallas_call at int8_gemv.py:160).
//
// Two routes, chosen per call by ops/int8_gemv.py:gemv_route:
//
// Warp route (mx_int8_gemv; decode, M <= 8, and M past gemv_max_m()).
// Bound: the int8 weight bytes (N * K, read once); at 3.35 TB/s the
// 50304 x 768 tied head takes 11.5 us. Every dot is one warp's, in K8's
// order (gemv_common.cuh), so the head GEMV + argmax and K8 pick the same
// greedy token and a row's bits do not depend on M. Design (gemv_warp.cuh,
// redesigned for Hopper): a persistent grid; x staged once per CTA in its
// own dtype by cp.async; each warp takes groups of G = 4, 2 or 1
// neighbouring channels whose rows stream into its ring of shared-memory
// stages by TMA bulk copies on mbarriers, ahead of the f32 FMAs; the row
// scale multiplies the finished dot. The activations stay f32 (the TPU
// kernel cast them to bf16 for the MXU) to keep the plain version's
// precision.
//
// x is f32, or bf16 (block 0 of a bf16 model; x_bf16): both routes widen
// bf16 to f32 exactly (the warp route as it reads x from shared memory, the
// tile route by taking x as its own hi plane, gemv_mma.cuh), so a bf16 call
// gives the f32 call on x.float() bit for bit.
//
// Tile route (mx_int8_gemv_mma; prefill, 9 <= M <= 64). Bound: the larger
// of the bytes and 2 M N K operations at the 989 TFLOP/s bf16 tensor rate;
// bytes bound it (one GPT-2 layer's four GEMVs at 64 rows: 10.25 MB, 3.1
// us). On the warp route those rows cost 8 passes over x, every weight row
// re-read 8 times, and f32 FMAs on the CUDA cores; here the weights stream
// once through a cp.async ring in shared memory into mma.sync with x as
// three bf16 planes (f32 accuracy), K split across a thread-block cluster
// where N alone gives too few CTAs. Design: gemv_mma.cuh.
#include "gemv_mma.cuh"
#include "gemv_warp.cuh"

namespace {

template <int G, int R, class X>
__global__ void __launch_bounds__(mx::kThreads, mx::warp::kCtasPerSm)
    int8_gemv_kernel(const X* __restrict__ x, mx::Int8Rows w, float* __restrict__ y, int M,
                     int N, int K, mx::warp::Ring ring) {
  extern __shared__ __align__(128) char smem[];
  mx::warp::StoreY<mx::warp::Int8Lane> epi{w, y, N};
  mx::warp::gemv_warp<G, R, mx::warp::Int8Lane, X>(smem, x, w, epi, M, N, K, ring);
}

template <class X>
int launch_warp(const void* x, const mx::Int8Rows& wt, void* y, int M, int N, int K, int block,
                void* stream) {
  static const mx::warp::Kernels<mx::warp::Int8Lane, X> kernels = {
      {int8_gemv_kernel<1, 1, X>, int8_gemv_kernel<1, 2, X>, int8_gemv_kernel<1, 4, X>,
       int8_gemv_kernel<1, 8, X>},
      {int8_gemv_kernel<2, 1, X>, int8_gemv_kernel<2, 2, X>, int8_gemv_kernel<2, 4, X>,
       int8_gemv_kernel<2, 8, X>},
      {int8_gemv_kernel<4, 1, X>, int8_gemv_kernel<4, 2, X>, int8_gemv_kernel<4, 4, X>,
       int8_gemv_kernel<4, 8, X>}};
  return mx::warp::launch<mx::warp::Int8Lane, X>(kernels, x, wt, y, M, N, K, block, stream);
}

template <class X>
__global__ void __launch_bounds__(mx::tile::kThreads, mx::tile::kMinCtas)
    int8_gemv_mma_kernel(const X* __restrict__ x, mx::tile::Int8Tile w,
                         float* __restrict__ y, int M, int N, int K) {
  extern __shared__ __align__(128) char smem[];
  mx::tile::gemv_mma(smem, x, w, y, M, N, K);
}

}  // namespace

// x: [M, K] f32, or bf16 where x_bf16 (16-byte aligned rows); w and s on
// 16-byte boundaries (the bulk copies move whole 16-byte units).
extern "C" int mx_int8_gemv(const void* x, const void* w, const void* s, void* y, int M,
                            int N, int K, int x_bf16, void* stream) {
  const mx::Int8Rows wt(w, static_cast<const float*>(s), K, 0);
  return x_bf16 ? launch_warp<mx::bf16>(x, wt, y, M, N, K, 0, stream)
                : launch_warp<float>(x, wt, y, M, N, K, 0, stream);
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
