// K4: weight-only int4 GEMV, y[M, N] = x[M, K] @ dequant(w_p[N, K/2], s[N, K/block]).T
// with dequant(w)[n, k] = (nibble k of row n - 8) * s[n, k / block].
//
// Replaces the TPU kernel mxnet_tpu/ops/int8_gemv.py:int4_weight_matmul
// (pl.pallas_call at int8_gemv.py:237).
//
// Two routes, chosen per call by ops/int8_gemv.py:gemv_route:
//
// Warp route (mx_int4_gemv; decode, M <= 8, and M past gemv_max_m()).
// Bound: the packed weight bytes (N * K / 2 bytes plus N * K / block * 4
// bytes of scales, read once); at 3.35 TB/s the 50304 x 768 tied head
// (19.3 MB + 1.2 MB) takes 6.1 us. K3's warp design (gemv_warp.cuh) with
// the int4 lane: a group's stage holds its nibble rows and their block
// scales (two bulk copies); each code is multiplied by its block scale in
// registers before its FMA. The TPU kernel dequantized a (bn, K) tile in
// VMEM and cast x to bf16 for the MXU; here x stays f32 and the dot order
// is the one K8's int4 lane takes, so the int4 head GEMV + argmax and K8's
// greedy rows select the same token bit for bit.
//
// x is f32, or bf16 (x_bf16), widened exactly as in K3 (int8_gemv.cu).
//
// Tile route (mx_int4_gemv_mma; prefill, 9 <= M <= 64). Bound: the larger
// of the bytes and 2 M N K operations at the 989 TFLOP/s bf16 tensor rate;
// bytes bound it (one GPT-2 layer's four GEMVs at 64 rows: 6.9 MB, 2.1
// us). The nibbles stream once through a cp.async ring into mma.sync
// (codes nibble - 8, exact in bf16) against x as three bf16 planes; each
// block's partial sum is multiplied by its block scale into the f32
// accumulator. Design: gemv_mma.cuh.
#include "gemv_mma.cuh"
#include "gemv_warp.cuh"

namespace {

template <int G, int R, class X>
__global__ void __launch_bounds__(mx::kThreads, mx::warp::kCtasPerSm)
    int4_gemv_kernel(const X* __restrict__ x, mx::Int4Rows w, float* __restrict__ y, int M,
                     int N, int K, mx::warp::Ring ring) {
  extern __shared__ __align__(128) char smem[];
  mx::warp::StoreY<mx::warp::Int4Lane> epi{w, y, N};
  mx::warp::gemv_warp<G, R, mx::warp::Int4Lane, X>(smem, x, w, epi, M, N, K, ring);
}

template <class X>
int launch_warp(const void* x, const mx::Int4Rows& wt, void* y, int M, int N, int K, int block,
                void* stream) {
  static const mx::warp::Kernels<mx::warp::Int4Lane, X> kernels = {
      {int4_gemv_kernel<1, 1, X>, int4_gemv_kernel<1, 2, X>, int4_gemv_kernel<1, 4, X>,
       int4_gemv_kernel<1, 8, X>},
      {int4_gemv_kernel<2, 1, X>, int4_gemv_kernel<2, 2, X>, int4_gemv_kernel<2, 4, X>,
       int4_gemv_kernel<2, 8, X>},
      {int4_gemv_kernel<4, 1, X>, int4_gemv_kernel<4, 2, X>, int4_gemv_kernel<4, 4, X>,
       int4_gemv_kernel<4, 8, X>}};
  return mx::warp::launch<mx::warp::Int4Lane, X>(kernels, x, wt, y, M, N, K, block, stream);
}

template <class X>
__global__ void __launch_bounds__(mx::tile::kThreads, mx::tile::kMinCtas)
    int4_gemv_mma_kernel(const X* __restrict__ x, mx::tile::Int4Tile w,
                         float* __restrict__ y, int M, int N, int K) {
  extern __shared__ __align__(128) char smem[];
  mx::tile::gemv_mma(smem, x, w, y, M, N, K);
}

}  // namespace

// w: [N, K / 2] uint8 nibble pairs; s: [N, K / block] f32; K % 16 == 0,
// block % 16 == 0 (ops/int8_gemv.int4_chunks_fit); x [M, K] f32, or bf16
// where x_bf16; w and s on 16-byte boundaries (the bulk copies).
extern "C" int mx_int4_gemv(const void* x, const void* w, const void* s, void* y, int M,
                            int N, int K, int block, int x_bf16, void* stream) {
  if (K % 16 || block < 16 || block % 16 || K % block) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const mx::Int4Rows wt(w, static_cast<const float*>(s), K, block);
  return x_bf16 ? launch_warp<mx::bf16>(x, wt, y, M, N, K, block, stream)
                : launch_warp<float>(x, wt, y, M, N, K, block, stream);
}

// w, s, x as mx_int4_gemv; 1 <= M <= 64, K % 32 == 0, block % 32 == 0 (a
// k-tile of 32 codes lies in one block; ops/int8_gemv.py checks first).
extern "C" int mx_int4_gemv_mma(const void* x, const void* w, const void* s, void* y, int M,
                                int N, int K, int block, int x_bf16, void* stream) {
  if (block < mx::tile::kBK || block % mx::tile::kBK || K % block) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const mx::tile::Int4Tile wt(w, static_cast<const float*>(s), K, block);
  return x_bf16 ? mx::tile::launch_gemv_mma(int4_gemv_mma_kernel<mx::bf16>, x, wt, y, M, N, K,
                                            stream)
                : mx::tile::launch_gemv_mma(int4_gemv_mma_kernel<float>, x, wt, y, M, N, K,
                                            stream);
}
