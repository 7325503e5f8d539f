// K8: fused tied-head GEMV + token selection. For each row b of h[B, D]:
//   a[v]   = (h[b] . w[v]) * s[v]             (int8 table)
//   a[v]   = h[b] . dequant(w)[v]             (int4 table)
//   a[v]   = bf16(a[v])                        where the logits are bf16
//   z[v]   = a[v] / (T_b > 0 ? T_b : 1)
//   z[v]  += -log(-log(u(keybits_b, v)))      for rows with T_b > 0
//   z[v]   = -inf                              where mask[b, v] == 0
//   z[v]   = -inf                              for pad lanes v >= vocab
//   tok[b] = argmax_v z[v], ties to the lowest lane
// The [B, Vp] logits are never written to device memory. h is f32, or bf16
// (exact in f32, so the bf16 lane gives the f32 lane's tokens on
// h.float()); the mask (the caller's bool [B, vocab], a grammar's allowed
// lanes, one byte a lane) is optional and folded in after the noise and
// before the pad mask, the TPU kernel's order. A row whose every lane
// scores -inf selects lane 0, as the TPU kernel's zero-initialised running
// index gives.
//
// Replaces the TPU kernel mxnet_tpu/ops/fused_block_gemv.py:_head_kernel
// (pl.pallas_call at fused_block_gemv.py:1325), reached through
// fused_lm_head_sample (:1340).
//
// Bound: the table, Vp * D bytes int8 (50304 x 768 = 38.6 MB for GPT-2,
// 11.5 us at 3.35 TB/s) or Vp * D / 2 bytes of int4 nibble pairs plus
// Vp * D / 128 f32 block scales (20.5 MB, 6.1 us); at 8 rows the int8 dot
// products' f32 FMAs come close (8 per weight, the bit contract fixes them).
//
// Design: the warp route of K3/K4 (gemv_warp.cuh) with a selecting
// epilogue, so every logit is the head GEMV's dot bit for bit (greedy rows
// equal the K3/K4 head GEMV + argmax). A persistent grid of at most
// kCtasPerSm CTAs an SM, each owning a contiguous range of channel groups;
// h staged once per CTA in its own dtype by cp.async; each warp streams
// groups of G channels through its ring of TMA bulk copies; after a
// group's transposed butterfly the lane that holds value (row, channel)
// scores it (scale, bf16 rounding, temperature, noise, masks) and keeps a
// running best for its row over its warp's groups, in ascending channel
// order (a later equal score never wins). At the end of a row tile the
// lanes of a row merge their bests by shuffles, the warps theirs in shared
// memory, and the CTA writes one (max, lane) pair per row. The last CTA to
// arrive (an atomic ticket, which it resets for the next launch) reduces
// the pairs of every row. Max-with-lowest-lane is exact, so no order of
// these reductions changes the token.
#include <climits>
#include <cmath>

#include "gemv_warp.cuh"

namespace {

// fused_block_gemv.py:_hash_uniform, in uint32: a murmur3-style finalizer
// of (lane * golden ratio) ^ key bits, top 24 bits mapped into (0, 1).
__device__ __forceinline__ float hash_uniform(uint32_t key, uint32_t lane) {
  uint32_t z = lane * 0x9E3779B9u;
  z ^= key;
  z ^= z >> 16;
  z *= 0x7FEB352Du;
  z ^= z >> 15;
  z *= 0x846CA68Bu;
  z ^= z >> 16;
  return (static_cast<float>(z >> 8) + 0.5f) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

struct HeadArgs {
  const float* temps;    // [B] (tstride 1) or one for all rows (tstride 0)
  const long long* keys;  // row b's key bits: keys[b * kwords] ^ keys[b * kwords + 1]
                          // (kwords 2, [B, 2] keys) or keys[b] (kwords 1); low 32 bits
  const uint8_t* mask;   // null, or bool [B, vocab] (0 = forbidden lane)
  float* pmax;           // [B, gridDim.x] per-CTA best score
  int* pidx;             // [B, gridDim.x] and its lane
  int* ticket;           // 0 between launches
  int* tok;              // [B]
  int tstride, kwords, vocab, round_bf16;
};

// The selecting epilogue of gemv_warp. A lane's value index is fixed for a
// tile: lane l holds value (l >> S) of the G x R group, channel g =
// (l >> S) / R and row r = (l >> S) % R, with S = 5 - log2(G R) (lanes
// with the same l >> S hold copies of one value).
template <class L, int G, int R>
struct Select {
  static constexpr int S = 5 - mx::Log2<G * R>::v;
  static constexpr int LR = mx::Log2<R>::v;
  const typename L::Table& t;
  const HeadArgs& a;
  float* wv;  // shared [kWarps * R]
  int* wi;
  float temp = 0.f, bv = -INFINITY;
  uint32_t key = 0u;
  int bi = INT_MAX;

  __device__ __forceinline__ int my_row() const { return ((threadIdx.x & 31) >> S) & (R - 1); }

  __device__ __forceinline__ void tile(int r0, int nr) {
    const int r = my_row();
    if (r < nr) {
      const int b = r0 + r;
      temp = a.temps[b * a.tstride];
      const long long* k = a.keys + static_cast<size_t>(b) * a.kwords;
      key = static_cast<uint32_t>(a.kwords == 2 ? k[0] ^ k[1] : k[0]);
    }
    bv = -INFINITY;
    bi = INT_MAX;
  }

  __device__ __forceinline__ void value(float v, int row, int n, bool ok, bool) {
    if (!ok) return;
    float z = v * L::out_scale(t, n);
    if (a.round_bf16) z = __bfloat162float(__float2bfloat16_rn(z));
    z = z / (temp > 0.f ? temp : 1.f);
    if (temp > 0.f) z = z + (-logf(-logf(hash_uniform(key, static_cast<uint32_t>(n)))));
    if (n >= a.vocab || (a.mask != nullptr && !a.mask[static_cast<size_t>(row) * a.vocab + n])) {
      z = -INFINITY;
    }
    if (z > bv) {  // channels arrive in ascending order: ties keep the lowest
      bv = z;
      bi = n;
    }
  }

  // Merge the lanes of each row (their channels and copies), then the
  // warps, and write the CTA's pair of each row of the tile.
  __device__ __forceinline__ void tile_end(int r0, int nr) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int b = 0; b < 5; ++b) {
      if (b >= S && b < S + LR) continue;  // the row's bits
      const float ov = __shfl_xor_sync(0xffffffffu, bv, 1 << b);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, 1 << b);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if ((lane & ~(((R - 1) << S))) == 0) {  // channel 0, first copy: lane r << S
      wv[warp * R + my_row()] = bv;
      wi[warp * R + my_row()] = bi;
    }
    __syncthreads();
    if (threadIdx.x < nr) {
      const int r = threadIdx.x;
      float m = wv[r];
      int mi = wi[r];
      for (int q = 1; q < mx::kWarps; ++q) {
        if (better(wv[q * R + r], wi[q * R + r], m, mi)) {
          m = wv[q * R + r];
          mi = wi[q * R + r];
        }
      }
      a.pmax[static_cast<size_t>(r0 + r) * gridDim.x + blockIdx.x] = m;
      a.pidx[static_cast<size_t>(r0 + r) * gridDim.x + blockIdx.x] = mi;
    }
  }
};

// Row w, w + kWarps, ... for warp w of the CTA: reduce each row's `ctas`
// pairs (read through L2: other SMs wrote them) and write its token.
__device__ __forceinline__ void reduce_rows(const HeadArgs& a, int B, int ctas) {
  const int lane = threadIdx.x & 31;
  for (int row = threadIdx.x >> 5; row < B; row += mx::kWarps) {
    float m = -INFINITY;
    int mi = INT_MAX;
    for (int c = lane; c < ctas; c += 32) {
      const float v = __ldcg(a.pmax + static_cast<size_t>(row) * ctas + c);
      const int i = __ldcg(a.pidx + static_cast<size_t>(row) * ctas + c);
      if (better(v, i, m, mi)) {
        m = v;
        mi = i;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, m, off);
      const int oi = __shfl_xor_sync(0xffffffffu, mi, off);
      if (better(ov, oi, m, mi)) {
        m = ov;
        mi = oi;
      }
    }
    // no lane scored above -inf: lane 0
    if (lane == 0) a.tok[row] = mi == INT_MAX ? 0 : mi;
  }
}

template <int G, int R, class L, class X>
__global__ void __launch_bounds__(mx::kThreads, mx::warp::kCtasPerSm)
    head_kernel(const X* __restrict__ h, typename L::Table t, HeadArgs a, int M, int N, int K,
                mx::warp::Ring ring) {
  extern __shared__ __align__(128) char smem[];
  __shared__ float wv[mx::kWarps * R];
  __shared__ int wi[mx::kWarps * R];
  __shared__ int last;
  Select<L, G, R> epi{t, a, wv, wi};
  mx::warp::gemv_warp<G, R, L, X>(smem, h, t, epi, M, N, K, ring);
  __threadfence();  // this CTA's pairs before its ticket
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(a.ticket, 1) == static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  reduce_rows(a, M, gridDim.x);  // the last CTA: every row
  if (threadIdx.x == 0) *a.ticket = 0;  // for the next launch
}

template <class L, class X>
using HeadKernel = void (*)(const X*, typename L::Table, HeadArgs, int, int, int,
                            mx::warp::Ring);

template <class L, class X>
int launch_head(const void* h, const typename L::Table& t, HeadArgs& a, int B, int Vp, int D,
                int block, cudaStream_t st) {
  static const HeadKernel<L, X> kernels[3][4] = {
      {head_kernel<1, 1, L, X>, head_kernel<1, 2, L, X>, head_kernel<1, 4, L, X>,
       head_kernel<1, 8, L, X>},
      {head_kernel<2, 1, L, X>, head_kernel<2, 2, L, X>, head_kernel<2, 4, L, X>,
       head_kernel<2, 8, L, X>},
      {head_kernel<4, 1, L, X>, head_kernel<4, 2, L, X>, head_kernel<4, 4, L, X>,
       head_kernel<4, 8, L, X>}};
  // the kernel's static shared memory: the warps' pairs and the flag
  constexpr int kReserve = 2 * 4 * mx::kWarps * 8 + 16;
  mx::warp::Plan p;
  cudaError_t err =
      mx::warp::plan<L>(kernels, B, Vp, D, block, static_cast<int>(sizeof(X)), kReserve, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernels[p.gi][p.ri]<<<p.grid, mx::kThreads, p.smem, st>>>(static_cast<const X*>(h), t, a, B,
                                                            Vp, D, p.ring);
  return static_cast<int>(cudaGetLastError());
}

template <class L>
int launch_head(const void* h, int h_bf16, const typename L::Table& t, HeadArgs& a, int B,
                int Vp, int D, int block, cudaStream_t st) {
  return h_bf16 ? launch_head<L, mx::bf16>(h, t, a, B, Vp, D, block, st)
                : launch_head<L, float>(h, t, a, B, Vp, D, block, st);
}

}  // namespace

// CTAs a launch may use at most on the current device (the per-CTA pairs:
// pmax and pidx hold B * mx_head_max_ctas() entries each); 0 on error.
extern "C" int mx_head_max_ctas() {
  int smem = 0, sms = 0;
  if (mx::device_limits(&smem, &sms) != cudaSuccess) return 0;
  return mx::warp::kCtasPerSm * sms;
}

// block 0: w is the int8 table [Vp, D] with scales s [Vp]; block > 0: w is
// the int4 table [Vp, D / 2] with block scales s [Vp, D / block] (D % 16 ==
// 0, block % 16 == 0); both on 16-byte boundaries (bulk copies). h [B, D]
// is f32, or bf16 where h_bf16 (16-byte aligned rows). temps: f32, [B]
// (tstride 1) or one value (tstride 0). keys: int64, [B, 2] (kwords 2:
// their xor is the key bits) or [B] key bits (kwords 1), low 32 bits used.
// mask: null or bool [B, vocab]. round_bf16 rounds each logit through bf16
// before the temperature. ticket: one int, 0, left 0.
extern "C" int mx_lm_head_sample(const void* h, const void* w, const void* s, const void* temps,
                                 int tstride, const void* keys, int kwords, const void* mask,
                                 void* pmax, void* pidx, void* ticket, void* tok, int B, int Vp,
                                 int D, int vocab, int block, int h_bf16, int round_bf16,
                                 void* stream) {
  if (B < 1 || D % 16 || (kwords != 1 && kwords != 2) ||
      (block != 0 && (block < 16 || block % 16 || D % block))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  HeadArgs a;
  a.temps = static_cast<const float*>(temps);
  a.keys = static_cast<const long long*>(keys);
  a.mask = static_cast<const uint8_t*>(mask);
  a.pmax = static_cast<float*>(pmax);
  a.pidx = static_cast<int*>(pidx);
  a.ticket = static_cast<int*>(ticket);
  a.tok = static_cast<int*>(tok);
  a.tstride = tstride;
  a.kwords = kwords;
  a.vocab = vocab;
  a.round_bf16 = round_bf16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sf = static_cast<const float*>(s);
  return block ? launch_head<mx::warp::Int4Lane>(h, h_bf16, mx::Int4Rows(w, sf, D, block), a, B,
                                                 Vp, D, block, st)
               : launch_head<mx::warp::Int8Lane>(h, h_bf16, mx::Int8Rows(w, sf, D, 0), a, B,
                                                 Vp, D, 0, st);
}
