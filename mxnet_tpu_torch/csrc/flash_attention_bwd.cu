// K2: flash-attention backward, (dq, dk, dv) of K1 from q, k, v, o, do and
// K1's f32 log-sum-exp.
//
// Replaces the TPU kernel mxnet_tpu/ops/attention.py:_pallas_backward
// (pl.pallas_call at attention.py:568, fused sweep; :591 dq and :606 dk+dv,
// the two-kernel sweep). Same function: p = exp(s - lse) recomputed per
// tile (the (T, S) matrix never exists in device memory), delta = sum(do * o)
// taken inside each kernel from do and o (per query tile, by all threads of
// the CTA), ds = p * (do v^T - delta) * scale,
// p and ds cast to the storage type before their products as on the TPU.
//
// Design: the deterministic two-kernel sweep of attention.py:427-503. The
// TPU's fused kernel carried dq across kv grid cells in a VMEM-resident f32
// block, which works because the TPU grid runs in order; Hopper runs CTAs in
// no order, so one sweep would need atomics on dq and its sums would then
// change from run to run. Here
// - the dk/dv kernel runs one CTA per (key tile, b * h) and loops over the
//   query tiles from the first one that can see the tile;
// - the dq kernel runs one CTA per (query tile, b * h) and loops over the key
//   tiles up to the causal limit.
// Both serve every length (no VMEM-style budget switch) and need no atomics,
// so a run repeats bit for bit. bf16 runs on the tensor cores with
// mma.sync fragments in registers (four row groups of 16 rows, one warp per
// row group and 64-column slice of the head dim); f32 runs tile_mm over
// shared tiles on the CUDA cores. The one-sweep design with dq atomics, and
// cp.async/wgmma/TMA, are a later redesign.
//
// Bound: at the training shape (B 16, H 12, T = S 1024, D 64, causal, bf16)
// five tile products against K1's two, about 64.5 GFLOP (0.065 ms at 989
// TFLOP/s) against about 202 MB moved (q, k, v, o, do, lse read once; dq, dk,
// dv written): 0.060 ms at 3.35 TB/s. Bound by operations. This two-kernel
// design recomputes S and dP in both kernels (seven products in all).
#include "flash_common.cuh"

namespace mxfa {
namespace {

// ---------------------------------------------------------------------------
// f32 body
// ---------------------------------------------------------------------------
template <int DP>
struct BwdLayout {
  static constexpr int BQ = BwdTile<DP>::BQ, BK = BwdTile<DP>::BK;
  static constexpr int LDT = DP + kPad;    // q, do, k, v tiles and accumulators
  static constexpr int LDS = BK + kPad;    // s, dp, p and ds tiles
  // q, do, k, v; s, dp, p, ds; one or two accumulators; lse and delta
  static constexpr size_t bytes(int n_acc, int acc_rows) {
    return 2 * span<float>(BQ * LDT) + 2 * span<float>(BK * LDT) +
           4 * span<float>(BQ * LDS) + n_acc * span<float>(acc_rows * LDT) +
           2 * span<float>(BQ);
  }
};

// p and ds of one (query tile, key tile) pair from the s and dp tiles:
// p = exp(s * scale - lse) where the pair is visible (0 elsewhere, including
// query rows past T), ds = p * (dp - delta) * scale.
template <int BQ, int BK>
__device__ __forceinline__ void probs_and_dscores(float* sP, float* sDS, const float* sS,
                                                  const float* sDP, int ld,
                                                  const float* sLse, const float* sDelta,
                                                  int q0, int k0, int T_, int S, int causal,
                                                  float scale) {
  const int off = S - T_;
  for (int i = threadIdx.x; i < BQ * BK; i += kThreads) {
    const int r = i / BK, c = i % BK;
    const int qp = q0 + r, kp = k0 + c;
    const bool ok = qp < T_ && kp < S && (!causal || qp + off >= kp);
    const float p = ok ? expf(sS[r * ld + c] * scale - sLse[r]) : 0.f;
    sP[r * ld + c] = p;
    sDS[r * ld + c] = p * (sDP[r * ld + c] - sDelta[r]) * scale;
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
    flash_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ o,
                   const float* __restrict__ lse, const float* __restrict__ dout,
                   float* __restrict__ dk, float* __restrict__ dv, int T_, int S, int D,
                   int causal, float scale) {
  using L = BwdLayout<DP>;
  constexpr int BQ = L::BQ, BK = L::BK, LDT = L::LDT, LDS = L::LDS;
  extern __shared__ __align__(128) char smem_raw[];
  Smem sm{smem_raw, 0};
  float* sQ = sm.take<float>(BQ * LDT);
  float* sDO = sm.take<float>(BQ * LDT);
  float* sK = sm.take<float>(BK * LDT);
  float* sV = sm.take<float>(BK * LDT);
  float* sS = sm.take<float>(BQ * LDS);
  float* sDP = sm.take<float>(BQ * LDS);
  float* sP = sm.take<float>(BQ * LDS);
  float* sDS = sm.take<float>(BQ * LDS);
  float* sDK = sm.take<float>(BK * LDT);
  float* sDV = sm.take<float>(BK * LDT);
  float* sLse = sm.take<float>(BQ);
  float* sDelta = sm.take<float>(BQ);

  const int k0 = blockIdx.x * BK;
  const size_t bh = blockIdx.y;
  const float* qb = q + bh * T_ * D;
  const float* ob = o + bh * T_ * D;
  const float* dob = dout + bh * T_ * D;
  const float* lseb = lse + bh * T_;
  const int off = S - T_;

  load_tile<BK, DP, kThreads>(sK, LDT, k + bh * S * D, k0, S, D);
  load_tile<BK, DP, kThreads>(sV, LDT, v + bh * S * D, k0, S, D);
  zero_f32<BK, DP>(sDK, LDT);
  zero_f32<BK, DP>(sDV, LDT);
  // first query tile that can see this key tile: q >= k0 - (S - T)
  // (attention.py:494-501)
  const int lower = causal ? max(0, k0 - off) / BQ : 0;
  const int nq = (T_ + BQ - 1) / BQ;
  for (int i = lower; i < nq; ++i) {
    const int q0 = i * BQ;
    __syncthreads();
    load_tile<BQ, DP, kThreads>(sQ, LDT, qb, q0, T_, D);
    load_tile<BQ, DP, kThreads>(sDO, LDT, dob, q0, T_, D);
    row_stats<BQ, kThreads>(sLse, sDelta, lseb, ob, dob, q0, T_, D);
    __syncthreads();
    tile_mm<BQ, BK, DP, true, false, false>(sS, LDS, sQ, LDT, sK, LDT);    // q k^T
    tile_mm<BQ, BK, DP, true, false, false>(sDP, LDS, sDO, LDT, sV, LDT);  // do v^T
    __syncthreads();
    probs_and_dscores<BQ, BK>(sP, sDS, sS, sDP, LDS, sLse, sDelta, q0, k0, T_, S, causal,
                              scale);
    __syncthreads();
    tile_mm<BK, DP, BQ, false, true, true>(sDV, LDT, sP, LDS, sDO, LDT);   // p^T do
    tile_mm<BK, DP, BQ, false, true, true>(sDK, LDT, sDS, LDS, sQ, LDT);   // ds^T q
  }
  __syncthreads();
  store_tile<BK, DP>(dk + bh * S * D, sDK, LDT, k0, S, D, nullptr);
  store_tile<BK, DP>(dv + bh * S * D, sDV, LDT, k0, S, D, nullptr);
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
    flash_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ o,
                 const float* __restrict__ lse, const float* __restrict__ dout,
                 float* __restrict__ dq, int T_, int S, int D, int causal, float scale) {
  using L = BwdLayout<DP>;
  constexpr int BQ = L::BQ, BK = L::BK, LDT = L::LDT, LDS = L::LDS;
  extern __shared__ __align__(128) char smem_raw[];
  Smem sm{smem_raw, 0};
  float* sQ = sm.take<float>(BQ * LDT);
  float* sDO = sm.take<float>(BQ * LDT);
  float* sK = sm.take<float>(BK * LDT);
  float* sV = sm.take<float>(BK * LDT);
  float* sS = sm.take<float>(BQ * LDS);
  float* sDP = sm.take<float>(BQ * LDS);
  float* sP = sm.take<float>(BQ * LDS);
  float* sDS = sm.take<float>(BQ * LDS);
  float* sDQ = sm.take<float>(BQ * LDT);
  float* sLse = sm.take<float>(BQ);
  float* sDelta = sm.take<float>(BQ);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest causal rows first
  const size_t bh = blockIdx.y;
  const float* kb = k + bh * S * D;
  const float* vb = v + bh * S * D;
  const float* dob = dout + bh * T_ * D;

  load_tile<BQ, DP, kThreads>(sQ, LDT, q + bh * T_ * D, q0, T_, D);
  load_tile<BQ, DP, kThreads>(sDO, LDT, dob, q0, T_, D);
  row_stats<BQ, kThreads>(sLse, sDelta, lse + bh * T_, o + bh * T_ * D, dob, q0, T_, D);
  zero_f32<BQ, DP>(sDQ, LDT);
  const int nkv = kv_tiles(q0, BQ, BK, T_, S, causal != 0);
  for (int j = 0; j < nkv; ++j) {
    const int k0 = j * BK;
    __syncthreads();
    load_tile<BK, DP, kThreads>(sK, LDT, kb, k0, S, D);
    load_tile<BK, DP, kThreads>(sV, LDT, vb, k0, S, D);
    __syncthreads();
    tile_mm<BQ, BK, DP, true, false, false>(sS, LDS, sQ, LDT, sK, LDT);    // q k^T
    tile_mm<BQ, BK, DP, true, false, false>(sDP, LDS, sDO, LDT, sV, LDT);  // do v^T
    __syncthreads();
    probs_and_dscores<BQ, BK>(sP, sDS, sS, sDP, LDS, sLse, sDelta, q0, k0, T_, S, causal,
                              scale);
    __syncthreads();
    tile_mm<BQ, DP, BK, true, true, true>(sDQ, LDT, sDS, LDS, sK, LDT);    // ds k
  }
  __syncthreads();
  store_tile<BQ, DP>(dq + bh * T_ * D, sDQ, LDT, q0, T_, D, nullptr);
}

// ---------------------------------------------------------------------------
// bf16 body
// ---------------------------------------------------------------------------
template <int DP>
__global__ void __launch_bounds__(MmaCfg<DP>::THREADS)
    flash_dkdv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ o,
                    const float* __restrict__ lse, const bf16* __restrict__ dout,
                    bf16* __restrict__ dk, bf16* __restrict__ dv, int T_, int S, int D,
                    int causal, float scale) {
  using C = MmaCfg<DP>;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, NT = C::THREADS;
  constexpr int NS = BQ / 8;   // n-tiles of the (key x query) score tile
  constexpr int NO = 64 / 8;   // n-tiles of a warp's column slice
  extern __shared__ __align__(128) char smem_raw[];
  Smem sm{smem_raw, 0};
  bf16* sK = sm.take<bf16>(BK * LD);
  bf16* sV = sm.take<bf16>(BK * LD);
  bf16* sQ = sm.take<bf16>(BQ * LD);
  bf16* sDO = sm.take<bf16>(BQ * LD);
  float* sLse = sm.take<float>(BQ);
  float* sDelta = sm.take<float>(BQ);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int r0 = (warp & 3) * 16;   // the warp's 16 key rows in the tile
  const int c0 = (warp >> 2) * 64;  // the warp's slice of the head dim
  const int k0 = blockIdx.x * BK;
  const size_t bh = blockIdx.y;
  const bf16* qb = q + bh * T_ * D;
  const bf16* ob = o + bh * T_ * D;
  const bf16* dob = dout + bh * T_ * D;
  const float* lseb = lse + bh * T_;
  const int off = S - T_;

  load_tile<BK, DP, NT>(sK, LD, k + bh * S * D, k0, S, D);
  load_tile<BK, DP, NT>(sV, LD, v + bh * S * D, k0, S, D);
  float adk[NO][4], adv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;
  // first query tile that can see this key tile (attention.py:494-501)
  const int lower = causal ? max(0, k0 - off) / BQ : 0;
  const int nq = (T_ + BQ - 1) / BQ;
  for (int i = lower; i < nq; ++i) {
    const int q0 = i * BQ;
    __syncthreads();
    load_tile<BQ, DP, NT>(sQ, LD, qb, q0, T_, D);
    load_tile<BQ, DP, NT>(sDO, LD, dob, q0, T_, D);
    row_stats<BQ, NT>(sLse, sDelta, lseb, ob, dob, q0, T_, D);
    __syncthreads();
    // s^T = k q^T and dp^T = v do^T: rows are keys, columns are queries
    float s[NS][4], dp[NS][4];
    mma_abt<NS, DP>(s, sK, sQ, LD, r0, lane);
    mma_abt<NS, DP>(dp, sV, sDO, LD, r0, lane);
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + r0 + g + (e >> 1) * 8;
        const int c = n * 8 + 2 * tg + (e & 1);
        const int qp = q0 + c;
        const bool ok = qp < T_ && kp < S && (!causal || qp + off >= kp);
        const float p = ok ? expf(s[n][e] * scale - sLse[c]) : 0.f;
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - sDelta[c]) * scale;
      }
    mma_pb<NO, BQ / 16>(adv, s, sDO, LD, c0, lane);   // dv += p^T do
    mma_pb<NO, BQ / 16>(adk, dp, sQ, LD, c0, lane);   // dk += ds^T q
  }
  bf16* dkb = dk + bh * S * D;
  bf16* dvb = dv + bh * S * D;
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kp = k0 + r0 + g + (e >> 1) * 8;
      const int c = c0 + n * 8 + 2 * tg + (e & 1);
      if (kp < S && c < D) {
        dkb[static_cast<size_t>(kp) * D + c] = __float2bfloat16(adk[n][e]);
        dvb[static_cast<size_t>(kp) * D + c] = __float2bfloat16(adv[n][e]);
      }
    }
}

template <int DP>
__global__ void __launch_bounds__(MmaCfg<DP>::THREADS)
    flash_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ o,
                  const float* __restrict__ lse, const bf16* __restrict__ dout,
                  bf16* __restrict__ dq, int T_, int S, int D, int causal, float scale) {
  using C = MmaCfg<DP>;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, NT = C::THREADS;
  constexpr int NS = BK / 8;
  constexpr int NO = 64 / 8;
  extern __shared__ __align__(128) char smem_raw[];
  Smem sm{smem_raw, 0};
  bf16* sQ = sm.take<bf16>(BQ * LD);
  bf16* sDO = sm.take<bf16>(BQ * LD);
  bf16* sK = sm.take<bf16>(BK * LD);
  bf16* sV = sm.take<bf16>(BK * LD);
  float* sLse = sm.take<float>(BQ);
  float* sDelta = sm.take<float>(BQ);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int r0 = (warp & 3) * 16;
  const int c0 = (warp >> 2) * 64;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest causal rows first
  const size_t bh = blockIdx.y;
  const bf16* kb = k + bh * S * D;
  const bf16* vb = v + bh * S * D;
  const bf16* dob = dout + bh * T_ * D;
  const int off = S - T_;

  load_tile<BQ, DP, NT>(sQ, LD, q + bh * T_ * D, q0, T_, D);
  load_tile<BQ, DP, NT>(sDO, LD, dob, q0, T_, D);
  row_stats<BQ, NT>(sLse, sDelta, lse + bh * T_, o + bh * T_ * D, dob, q0, T_, D);
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
    float s[NS][4], dp[NS][4];
    mma_abt<NS, DP>(s, sQ, sK, LD, r0, lane);    // q k^T
    mma_abt<NS, DP>(dp, sDO, sV, LD, r0, lane);  // do v^T
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + g + (e >> 1) * 8;
        const int qp = q0 + r;
        const int kp = k0 + n * 8 + 2 * tg + (e & 1);
        const bool ok = qp < T_ && kp < S && (!causal || qp + off >= kp);
        const float p = ok ? expf(s[n][e] * scale - sLse[r]) : 0.f;
        dp[n][e] = p * (dp[n][e] - sDelta[r]) * scale;
      }
    mma_pb<NO, BK / 16>(acc, dp, sK, LD, c0, lane);  // dq += ds k
  }
  bf16* dqb = dq + bh * T_ * D;
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qp = q0 + r0 + g + (e >> 1) * 8;
      const int c = c0 + n * 8 + 2 * tg + (e & 1);
      if (qp < T_ && c < D) dqb[static_cast<size_t>(qp) * D + c] = __float2bfloat16(acc[n][e]);
    }
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

struct Args {
  const void *q, *k, *v, *o, *lse, *dout;
  void *dq, *dk, *dv;
  int BH, T, S, D, causal;
  float scale;
  cudaStream_t stream;
};

template <int DP>
int launch_f32(const Args& a) {
  using L = BwdLayout<DP>;
  const size_t smem_kv = L::bytes(2, L::BK), smem_q = L::bytes(1, L::BQ);
  if (int err = prepare(flash_dkdv_f32<DP>, smem_kv)) return err;
  if (int err = prepare(flash_dq_f32<DP>, smem_q)) return err;
  const auto* q = static_cast<const float*>(a.q);
  const auto* k = static_cast<const float*>(a.k);
  const auto* v = static_cast<const float*>(a.v);
  const auto* o = static_cast<const float*>(a.o);
  const auto* lse = static_cast<const float*>(a.lse);
  const auto* dout = static_cast<const float*>(a.dout);
  flash_dkdv_f32<DP><<<dim3((a.S + L::BK - 1) / L::BK, a.BH), kThreads, smem_kv, a.stream>>>(
      q, k, v, o, lse, dout, static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.T, a.S,
      a.D, a.causal, a.scale);
  if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  flash_dq_f32<DP><<<dim3((a.T + L::BQ - 1) / L::BQ, a.BH), kThreads, smem_q, a.stream>>>(
      q, k, v, o, lse, dout, static_cast<float*>(a.dq), a.T, a.S, a.D, a.causal, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_bf16(const Args& a) {
  using C = MmaCfg<DP>;
  const size_t smem = 4 * span<bf16>(64 * C::LD) + 2 * span<float>(64);
  if (int err = prepare(flash_dkdv_bf16<DP>, smem)) return err;
  if (int err = prepare(flash_dq_bf16<DP>, smem)) return err;
  const auto* q = static_cast<const bf16*>(a.q);
  const auto* k = static_cast<const bf16*>(a.k);
  const auto* v = static_cast<const bf16*>(a.v);
  const auto* o = static_cast<const bf16*>(a.o);
  const auto* lse = static_cast<const float*>(a.lse);
  const auto* dout = static_cast<const bf16*>(a.dout);
  flash_dkdv_bf16<DP><<<dim3((a.S + C::BK - 1) / C::BK, a.BH), C::THREADS, smem, a.stream>>>(
      q, k, v, o, lse, dout, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.T, a.S,
      a.D, a.causal, a.scale);
  if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  flash_dq_bf16<DP><<<dim3((a.T + C::BQ - 1) / C::BQ, a.BH), C::THREADS, smem, a.stream>>>(
      q, k, v, o, lse, dout, static_cast<bf16*>(a.dq), a.T, a.S, a.D, a.causal, a.scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace mxfa

// q, o, do, dq (B*H, T, D) and k, v, dk, dv (B*H, S, D) in the storage type;
// lse (B*H, T) f32 from mx_flash_fwd. Launches the dk/dv kernel, then the dq
// kernel, on `stream`. Returns the first CUDA error code (0 on success).
extern "C" int mx_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                            const void* lse, const void* dout, void* dq, void* dk, void* dv,
                            int BH, int T, int S, int D, int DP, int causal, float scale,
                            int bf16, void* stream) {
  using namespace mxfa;
  if (D > DP || BH > 65535 || T < 1 || S < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, lse, dout, dq, dk, dv, BH, T, S, D, causal, scale,
               static_cast<cudaStream_t>(stream)};
  switch (DP * 2 + (bf16 != 0)) {
    case 128: return launch_f32<64>(a);
    case 256: return launch_f32<128>(a);
    case 512: return launch_f32<256>(a);
    case 129: return launch_bf16<64>(a);
    case 257: return launch_bf16<128>(a);
    case 513: return launch_bf16<256>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
