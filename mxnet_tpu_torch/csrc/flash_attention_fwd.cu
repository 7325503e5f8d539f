// K1: flash-attention forward, o = softmax(q k^T * scale) v with an f32
// log-sum-exp per query row.
//
// Replaces the TPU kernel mxnet_tpu/ops/attention.py:_pallas_forward
// (pl.pallas_call at attention.py:359). Same function: end-aligned causal
// mask (query i sees keys j <= i + S - T), keys past S masked by position,
// fully masked key tiles skipped, masked scores at finfo(f32).min, o in the
// storage type and lse = m + log(l) in f32. Padding differs: the TPU kernel
// padded q/k/v in device memory; here tiles are zero-filled in shared memory
// by masked loads, and rows past T are never stored (so lse has T rows, not
// the padded Tp).
//
// Bound: at the training shape (B 16, H 12, T = S 1024, D 64, causal, bf16)
// about 25.8 GFLOP of tensor-core work against about 101 MB moved (q, k, v
// read once, o written, lse written): 0.030 ms at 3.35 TB/s, the larger of
// the two (the tensor-core time is 0.026 ms at 989 TFLOP/s).
//
// Design: one CTA per (query tile of 64 rows, b * h), longest causal rows
// launched first; the CTA loops over key tiles of 64 up to the causal limit
// with the online softmax (m, l in f32, masked p set to exactly 0) and casts
// p to the storage type before p v, as the TPU kernel does.
// - bf16: four row groups of 16 query rows, one warp each per 64-column
//   slice of the head dim. S = Q K^T, the softmax and O += P V all stay in
//   mma.sync fragments in registers; only the Q, K and V tiles go through
//   shared memory (16-byte global loads, ldmatrix fragment reads).
// - f32: tiles and products in shared memory (tile_mm on the CUDA cores).
// No cp.async, wgmma or TMA yet: the next steps toward the bound.
#include "flash_common.cuh"

namespace mxfa {
namespace {

// ---------------------------------------------------------------------------
// f32 body
// ---------------------------------------------------------------------------
template <int DP>
struct FwdLayout {
  static constexpr int BQ = FwdTile<DP>::BQ, BK = FwdTile<DP>::BK;
  static constexpr int LDT = DP + kPad;    // q, k, v, f32 output tiles
  static constexpr int LDS = BK + kPad;    // score and p tiles
  static constexpr size_t bytes() {
    return span<float>(BQ * LDT) + 2 * span<float>(BK * LDT) + 2 * span<float>(BQ * LDS) +
           span<float>(BQ * LDT) + 3 * span<float>(BQ);
  }
};

template <int DP>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                  int T_, int S, int D, int causal, float scale) {
  using L = FwdLayout<DP>;
  constexpr int BQ = L::BQ, BK = L::BK;
  extern __shared__ __align__(128) char smem_raw[];
  Smem sm{smem_raw, 0};
  float* sQ = sm.take<float>(BQ * L::LDT);
  float* sK = sm.take<float>(BK * L::LDT);
  float* sV = sm.take<float>(BK * L::LDT);
  float* sS = sm.take<float>(BQ * L::LDS);
  float* sP = sm.take<float>(BQ * L::LDS);
  float* sO = sm.take<float>(BQ * L::LDT);
  float* sM = sm.take<float>(BQ);
  float* sL = sm.take<float>(BQ);
  float* sC = sm.take<float>(BQ);

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int q0 = qt * BQ;
  const size_t bh = blockIdx.y;
  const float* qb = q + bh * T_ * D;
  const float* kb = k + bh * S * D;
  const float* vb = v + bh * S * D;
  const int off = S - T_;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  load_tile<BQ, DP, kThreads>(sQ, L::LDT, qb, q0, T_, D);
  zero_f32<BQ, DP>(sO, L::LDT);
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    sM[r] = kMaskValue;
    sL[r] = 0.f;
  }
  const int nkv = kv_tiles(q0, BQ, BK, T_, S, causal != 0);
  for (int j = 0; j < nkv; ++j) {
    const int k0 = j * BK;
    __syncthreads();
    load_tile<BK, DP, kThreads>(sK, L::LDT, kb, k0, S, D);
    load_tile<BK, DP, kThreads>(sV, L::LDT, vb, k0, S, D);
    __syncthreads();
    tile_mm<BQ, BK, DP, true, false, false>(sS, L::LDS, sQ, L::LDT, sK, L::LDT);
    __syncthreads();
    // online softmax, one warp per row
    for (int r = warp; r < BQ; r += kWarps) {
      const int qp = q0 + r;
      float s[BK / 32];
      float mx = kMaskValue;
#pragma unroll
      for (int u = 0; u < BK / 32; ++u) {
        const int c = lane + 32 * u;
        const int kp = k0 + c;
        const bool ok = kp < S && (!causal || qp + off >= kp);
        s[u] = ok ? sS[r * L::LDS + c] * scale : kMaskValue;
        mx = fmaxf(mx, s[u]);
      }
      mx = warp_max(mx);
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < BK / 32; ++u) {
        const int c = lane + 32 * u;
        const float p = s[u] == kMaskValue ? 0.f : expf(s[u] - m_new);
        sum += p;
        sP[r * L::LDS + c] = p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        sC[r] = corr;
        sL[r] = sL[r] * corr + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < BQ * DP; i += kThreads) {
      const int r = i / DP, c = i % DP;
      sO[r * L::LDT + c] *= sC[r];
    }
    __syncthreads();
    tile_mm<BQ, DP, BK, true, true, true>(sO, L::LDT, sP, L::LDS, sV, L::LDT);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    const float l = fmaxf(sL[r], 1e-30f);
    sC[r] = l;
    if (q0 + r < T_) lse[bh * T_ + q0 + r] = sM[r] + logf(l);
  }
  __syncthreads();
  store_tile<BQ, DP>(o + bh * T_ * D, sO, L::LDT, q0, T_, D, sC);
}

// ---------------------------------------------------------------------------
// bf16 body
// ---------------------------------------------------------------------------
template <int DP>
__global__ void __launch_bounds__(MmaCfg<DP>::THREADS)
    flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                   int T_, int S, int D, int causal, float scale) {
  using C = MmaCfg<DP>;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, NT = C::THREADS;
  constexpr int NS = BK / 8;   // score n-tiles of a row group
  constexpr int NO = 64 / 8;   // output n-tiles of a warp's column slice
  extern __shared__ __align__(128) char smem_raw[];
  Smem sm{smem_raw, 0};
  bf16* sQ = sm.take<bf16>(BQ * LD);
  bf16* sK = sm.take<bf16>(BK * LD);
  bf16* sV = sm.take<bf16>(BK * LD);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int r0 = (warp & 3) * 16;   // the warp's 16 query rows in the tile
  const int c0 = (warp >> 2) * 64;  // the warp's slice of the head dim
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest causal rows first
  const size_t bh = blockIdx.y;
  const bf16* kb = k + bh * S * D;
  const bf16* vb = v + bh * S * D;
  const int off = S - T_;

  load_tile<BQ, DP, NT>(sQ, LD, q + bh * T_ * D, q0, T_, D);
  float m[2] = {kMaskValue, kMaskValue}, l[2] = {0.f, 0.f};
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const int nkv = kv_tiles(q0, BQ, BK, T_, S, causal != 0);
  for (int j = 0; j < nkv; ++j) {
    const int k0 = j * BK;
    __syncthreads();
    load_tile<BK, DP, NT>(sK, LD, kb, k0, S, D);
    load_tile<BK, DP, NT>(sV, LD, vb, k0, S, D);
    __syncthreads();
    float s[NS][4];
    mma_abt<NS, DP>(s, sQ, sK, LD, r0, lane);
    float mx[2] = {kMaskValue, kMaskValue};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qp = q0 + r0 + g + (e >> 1) * 8;
        const int kp = k0 + n * 8 + 2 * tg + (e & 1);
        const bool ok = kp < S && (!causal || qp + off >= kp);
        s[n][e] = ok ? s[n][e] * scale : kMaskValue;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = expf(m[h] - m_new);
      m[h] = m_new;
      l[h] *= corr[h];
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = s[n][e] == kMaskValue ? 0.f : expf(s[n][e] - m[e >> 1]);
        s[n][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
    mma_pb<NO, BK / 16>(acc, s, sV, LD, c0, lane);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l[h] = fmaxf(l[h], 1e-30f);
    const int qp = q0 + r0 + g + h * 8;
    if (c0 == 0 && tg == 0 && qp < T_) lse[bh * T_ + qp] = m[h] + logf(l[h]);
  }
  bf16* ob = o + bh * T_ * D;
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qp = q0 + r0 + g + (e >> 1) * 8;
      const int c = c0 + n * 8 + 2 * tg + (e & 1);
      if (qp < T_ && c < D)
        ob[static_cast<size_t>(qp) * D + c] = __float2bfloat16(acc[n][e] / l[e >> 1]);
    }
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

template <int DP>
int launch_f32(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
               int T_, int S, int D, int causal, float scale, cudaStream_t stream) {
  using L = FwdLayout<DP>;
  const size_t smem = L::bytes();
  if (int err = prepare(flash_fwd_f32<DP>, smem)) return err;
  flash_fwd_f32<DP><<<dim3((T_ + L::BQ - 1) / L::BQ, BH), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), static_cast<float*>(lse), T_, S,
      D, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_bf16(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
                int T_, int S, int D, int causal, float scale, cudaStream_t stream) {
  using C = MmaCfg<DP>;
  const size_t smem = span<bf16>(C::BQ * C::LD) + 2 * span<bf16>(C::BK * C::LD);
  if (int err = prepare(flash_fwd_bf16<DP>, smem)) return err;
  flash_fwd_bf16<DP><<<dim3((T_ + C::BQ - 1) / C::BQ, BH), C::THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), T_, S, D, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace mxfa

// q (B*H, T, D), k/v (B*H, S, D), o (B*H, T, D) in the storage type; lse
// (B*H, T) f32. DP is the padded head dim (64, 128 or 256, >= D); bf16 != 0
// selects bf16 storage, else f32. Returns the CUDA error code of the launch.
extern "C" int mx_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                            int BH, int T, int S, int D, int DP, int causal, float scale,
                            int bf16, void* stream) {
  using namespace mxfa;
  if (D > DP || BH > 65535 || T < 1 || S < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (DP * 2 + (bf16 != 0)) {
    case 128: return launch_f32<64>(q, k, v, o, lse, BH, T, S, D, causal, scale, st);
    case 256: return launch_f32<128>(q, k, v, o, lse, BH, T, S, D, causal, scale, st);
    case 512: return launch_f32<256>(q, k, v, o, lse, BH, T, S, D, causal, scale, st);
    case 129: return launch_bf16<64>(q, k, v, o, lse, BH, T, S, D, causal, scale, st);
    case 257: return launch_bf16<128>(q, k, v, o, lse, BH, T, S, D, causal, scale, st);
    case 513: return launch_bf16<256>(q, k, v, o, lse, BH, T, S, D, causal, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
