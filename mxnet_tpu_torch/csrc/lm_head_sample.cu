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
// (widened exactly as it is staged, so the bf16 lane gives the f32 lane's
// tokens on h.float()); the mask (uint8 [B, Vp], a grammar's allowed
// lanes) is optional, read by the lane that scores the row beside its
// noise, in the TPU kernel's order (after the noise, before the pad mask).
//
// Replaces the TPU kernel mxnet_tpu/ops/fused_block_gemv.py:_head_kernel
// (pl.pallas_call at fused_block_gemv.py:1325), reached through
// fused_lm_head_sample (:1340).
//
// Bound: the table, Vp * D bytes int8 (50304 x 768 = 38.6 MB for GPT-2,
// 11.5 us at 3.35 TB/s) or Vp * D / 2 bytes of int4 nibble pairs plus
// Vp * D / 128 f32 block scales (20.5 MB, 6.1 us); the activations and the
// per-tile partials are a rounding error beside it.
//
// Design against that bound: pass 1 streams the table once, one warp per
// vocab lane in 16-byte (int8) or 8-byte (int4) loads per lane (the dot
// and its weight lanes are gemv_common.cuh's, so greedy rows select
// exactly the token the K3 or K4 head GEMV + argmax would),
// applies temperature, hash-Gumbel noise and the pad mask in registers
// (lane r of the warp for row r) and reduces each CTA's tile of lanes to
// one (max, lowest lane) pair per row.
// The TPU kernel carried a running argmax from one grid step to the next;
// CTAs here run in no order, so a second small pass reduces the per-tile
// pairs of each row with the same tie rule. Max-with-lowest-lane is exact,
// so the result does not depend on the order of either reduction.
#include <climits>
#include <cmath>

#include "gemv_common.cuh"

namespace {

constexpr int kLanesPerWarp = 16;                            // vocab lanes per warp per tile
constexpr int kTile = mx::kWarps * kLanesPerWarp;            // vocab lanes per CTA

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

template <class W, class X>
__global__ void __launch_bounds__(mx::kThreads)
    head_tiles_kernel(const X* __restrict__ h, W w, const float* __restrict__ temps,
                      const int* __restrict__ keybits, const uint8_t* __restrict__ mask,
                      int round_bf16, int B, int Vp, int D, int vocab, int ntiles,
                      float* __restrict__ pmax, int* __restrict__ pidx) {
  extern __shared__ __align__(16) float hs[];
  __shared__ float wmax[mx::kWarps][mx::kRowTile];
  __shared__ int widx[mx::kWarps][mx::kRowTile];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r0 = 0; r0 < B; r0 += mx::kRowTile) {
    const int nr = min(mx::kRowTile, B - r0);
    __syncthreads();
    mx::stage_rows(hs, h, r0, nr, D);
    __syncthreads();
    // after the dot every lane holds all nr row sums; lane r < nr scores
    // row r (temperature, noise, pad mask, running argmax) alone
    const float temp = lane < nr ? temps[r0 + lane] : 0.f;
    const uint32_t key = lane < nr ? static_cast<uint32_t>(keybits[r0 + lane]) : 0u;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      float bv = -INFINITY;
      int bi = INT_MAX;
      const int v0 = t * kTile + warp * kLanesPerWarp;
      for (int i = 0; i < kLanesPerWarp; ++i) {
        const int v = v0 + i;  // ascending: a later equal value never wins
        if (v >= Vp) break;
        float acc[mx::kRowTile];
        mx::warp_dot_rows(hs, nr, w, v, D, acc);
        float mine = acc[0];
#pragma unroll
        for (int r = 1; r < mx::kRowTile; ++r) {
          if (lane == r) mine = acc[r];
        }
        if (lane < nr) {
          float a = mine * w.scale(v);
          if (round_bf16) a = __bfloat162float(__float2bfloat16_rn(a));
          float z = a / (temp > 0.f ? temp : 1.f);
          if (temp > 0.f) z = z + (-logf(-logf(hash_uniform(key, static_cast<uint32_t>(v)))));
          if (mask != nullptr && !mask[static_cast<size_t>(r0 + lane) * Vp + v]) z = -INFINITY;
          if (v >= vocab) z = -INFINITY;
          if (z > bv) {
            bv = z;
            bi = v;
          }
        }
      }
      if (lane < nr) {
        wmax[warp][lane] = bv;
        widx[warp][lane] = bi;
      }
      __syncthreads();
      if (threadIdx.x < nr) {
        const int r = threadIdx.x;
        float m = wmax[0][r];
        int mi = widx[0][r];
        for (int q = 1; q < mx::kWarps; ++q) {
          if (better(wmax[q][r], widx[q][r], m, mi)) {
            m = wmax[q][r];
            mi = widx[q][r];
          }
        }
        pmax[static_cast<size_t>(r0 + r) * ntiles + t] = m;
        pidx[static_cast<size_t>(r0 + r) * ntiles + t] = mi;
      }
      __syncthreads();
    }
  }
}

// One warp per row: reduce the row's per-tile (max, lane) pairs.
__global__ void head_reduce_kernel(const float* __restrict__ pmax, const int* __restrict__ pidx,
                                   int B, int ntiles, int* __restrict__ tok) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= B) return;
  float m = -INFINITY;
  int mi = INT_MAX;
  for (int t = lane; t < ntiles; t += 32) {
    const float v = pmax[static_cast<size_t>(row) * ntiles + t];
    const int i = pidx[static_cast<size_t>(row) * ntiles + t];
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
  // every lane scored -inf (cannot happen with vocab >= 1): lane 0, as the
  // TPU kernel's zero-initialised running index gives
  if (lane == 0) tok[row] = mi == INT_MAX ? 0 : mi;
}

}  // namespace

extern "C" int mx_head_tiles(int Vp) { return (Vp + kTile - 1) / kTile; }

namespace {

template <class W, class X>
cudaError_t launch_tiles(const void* h, const W& w, const void* temps, const void* keybits,
                         const void* mask, int round_bf16, void* pmax, void* pidx, int B, int Vp,
                         int D, int vocab, int ntiles, cudaStream_t st) {
  const size_t smem = sizeof(float) * mx::kRowTile * D;
  int ctas = 0;
  cudaError_t err = mx::resident_ctas(head_tiles_kernel<W, X>, smem, &ctas);
  if (err != cudaSuccess) return err;
  const int grid = ntiles < ctas ? ntiles : ctas;
  head_tiles_kernel<W, X><<<grid, mx::kThreads, smem, st>>>(
      static_cast<const X*>(h), w, static_cast<const float*>(temps),
      static_cast<const int*>(keybits), static_cast<const uint8_t*>(mask), round_bf16, B, Vp, D,
      vocab, ntiles, static_cast<float*>(pmax), static_cast<int*>(pidx));
  return cudaGetLastError();
}

template <class W>
cudaError_t launch_tiles(const void* h, int h_bf16, const W& w, const void* temps,
                         const void* keybits, const void* mask, int round_bf16, void* pmax,
                         void* pidx, int B, int Vp, int D, int vocab, int ntiles,
                         cudaStream_t st) {
  return h_bf16 ? launch_tiles<W, mx::bf16>(h, w, temps, keybits, mask, round_bf16, pmax, pidx,
                                            B, Vp, D, vocab, ntiles, st)
                : launch_tiles<W, float>(h, w, temps, keybits, mask, round_bf16, pmax, pidx, B,
                                         Vp, D, vocab, ntiles, st);
}

}  // namespace

// pmax/pidx: scratch of B * mx_head_tiles(Vp) entries each. block 0: w is
// the int8 table [Vp, D] with scales s [Vp]; block > 0: w is the int4
// table [Vp, D / 2] with block scales s [Vp, D / block] (D % 16 == 0,
// block % 16 == 0). h [B, D] is f32, or bf16 where h_bf16 (16-byte
// aligned rows); mask is null or uint8 [B, Vp] (0 = forbidden lane);
// round_bf16 rounds each logit through bf16 before the temperature.
extern "C" int mx_lm_head_sample(const void* h, const void* w, const void* s,
                                 const void* temps, const void* keybits, const void* mask,
                                 void* pmax, void* pidx, void* tok, int B, int Vp, int D,
                                 int vocab, int block, int h_bf16, int round_bf16,
                                 void* stream) {
  const int ntiles = mx_head_tiles(Vp);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sf = static_cast<const float*>(s);
  if (block != 0 && (D % 16 || block < 16 || block % 16 || D % block)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err =
      block ? launch_tiles(h, h_bf16, mx::Int4Rows(w, sf, D, block), temps, keybits, mask,
                           round_bf16, pmax, pidx, B, Vp, D, vocab, ntiles, st)
            : launch_tiles(h, h_bf16, mx::Int8Rows(w, sf, D, 0), temps, keybits, mask,
                           round_bf16, pmax, pidx, B, Vp, D, vocab, ntiles, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kRowsPerCta = 4;
  head_reduce_kernel<<<(B + kRowsPerCta - 1) / kRowsPerCta, 32 * kRowsPerCta, 0, st>>>(
      static_cast<const float*>(pmax), static_cast<const int*>(pidx), B, ntiles,
      static_cast<int*>(tok));
  return static_cast<int>(cudaGetLastError());
}
