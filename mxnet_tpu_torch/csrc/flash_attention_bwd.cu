// K2: flash-attention backward, (dq, dk, dv) of K1 from q, k, v, o, do and
// K1's f32 log-sum-exp.
//
// Replaces the TPU kernel mxnet_tpu/ops/attention.py:_pallas_backward
// (pl.pallas_call at attention.py:568, fused sweep; :591 dq and :606 dk+dv,
// the two-kernel sweep). Same function: p = exp(s - lse) recomputed per
// tile (the (T, S) matrix never exists in device memory), delta =
// sum(do * o), ds = p * (do v^T - delta) * scale, p and ds cast to the
// storage type before their products as on the TPU.
//
// Bound: at the training shape (B 16, H 12, T = S 1024, D 64, causal, bf16)
// five tile products against K1's two, about 64.5 GFLOP (0.065 ms at 989
// TFLOP/s) against about 202 MB moved (q, k, v, o, do, lse read once; dq,
// dk, dv written): 0.060 ms at 3.35 TB/s. Bound by operations.
//
// Routes by storage type and padded head dim DP (chosen by shape, never a
// fallback taken on failure):
// - bf16, DP 64 or 128: the TPU's one sweep (fused_kernel, attention.py:505),
//   five products per tile pair, in three launches.
//   1. A preprocess kernel computes delta (B*H, T) in f32 once and zeroes
//      the sweep's counters.
//   2. The sweep: one CTA per (key tile of 128 keys, b * h), taken in the
//      order of a ticket counter (key tile major: the longest causal columns
//      first). K and V stay resident in shared memory; a producer
//      warp streams Q and dO tiles of 64 queries by TMA (two stages on
//      mbarriers) with their lse and delta; two consumer warpgroups of 64
//      keys each run S^T = K Q^T and dP^T = V dO^T (wgmma from shared
//      memory), P^T and dS^T in registers, dV += P^T dO and dK += dS^T Q
//      (wgmma, A from registers, dO and Q through the transpose flag), and
//      write dS^T to shared memory, from which both warpgroups compute the
//      tile's dq contribution dS K (each a half of the head dim) and hand it
//      to a dq warp through shared memory (3 buffers on mbarriers at DP 64,
//      2 at DP 128), which keeps two tiles' additions in flight.
//      Determinism: the dq warp adds a query tile's contributions to the
//      f32 accumulator in ascending key-tile order, by one TMA bulk copy
//      (key tile 0, the first contributor of every query tile) or bulk
//      reduction (the others) each. Each (query tile, b * h) has a turn counter in device
//      memory; the CTA of key tile kt waits for it to read kt, adds, and
//      sets it to kt + 1. The CTA it waits on holds an earlier ticket, so
//      it is running or done: the sweep cannot deadlock however many CTAs
//      are resident, and the consumers never wait on a turn.
//   3. A postprocess kernel casts the accumulator to dq's storage type.
//   So a run repeats bit for bit.
// - bf16, DP 256: the mma.sync two-kernel sweep of the previous design (a
//   dk/dv kernel over the query tiles and a dq kernel over the key tiles,
//   seven products per tile pair, no atomics); its tiles do not fit the
//   one sweep's shared memory.
// - f32: the same two-kernel sweep with tile_mm on the CUDA cores, the
//   card-against-CPU check.
#include "flash_common.cuh"
#include "hopper_common.cuh"

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


// ---------------------------------------------------------------------------
// bf16 one-sweep body (DP 64 or 128)
// ---------------------------------------------------------------------------
template <int DP>
struct WgBwd {
  static constexpr int BK = 128, BQ = 64, STAGES = DP == 64 ? 3 : 2;
  static constexpr int HALVES = DP / 64;
  static constexpr int KV_BYTES = BK * DP * 2;   // K or V, resident
  static constexpr int QT_BYTES = BQ * DP * 2;   // one Q or dO tile
  static constexpr int DS_BYTES = BK * BQ * 2;   // dS^T, 128 keys x 64 queries
  static constexpr int DQ_BYTES = BQ * DP * 4;   // one f32 dq contribution
  static constexpr int DQ_BUFS = DP == 64 ? 3 : 2;
  static constexpr int THREADS = 384;
  static constexpr size_t SMEM = 1024 + 2 * KV_BYTES + STAGES * 2 * QT_BYTES + DS_BYTES +
                                 DQ_BUFS * DQ_BYTES + STAGES * 2 * BQ * 4 + 128;
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// dst[i] = src[i] (add == false) or dst[i] += src[i] over `bytes` (a
// multiple of 16) by one TMA bulk copy or reduction from shared to global
// memory, committed as one bulk group.
__device__ __forceinline__ void bulk_store_f32(float* dst, const float* src, uint32_t bytes,
                                               bool add) {
  if (add)
    asm volatile(
        "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n" ::"l"(
            dst),
        "r"(mxh::smem_addr(src)), "r"(bytes)
        : "memory");
  else
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
                 "r"(mxh::smem_addr(src)), "r"(bytes)
                 : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's bulk groups are still in flight.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// Order this thread's generic-proxy global accesses with its async-proxy
// (bulk copy) ones.
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// delta = sum(do * o) per query row (one warp a row, f32); block 0 also
// zeroes the counters.
__global__ void __launch_bounds__(256)
    bwd_prep(const bf16* __restrict__ o, const bf16* __restrict__ dout, float* __restrict__ delta,
             int* __restrict__ counters, int n_counters, int rows, int D) {
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < n_counters; i += blockDim.x) counters[i] = 0;
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x & 31;
  if (row >= rows) return;
  const size_t base = static_cast<size_t>(row) * D;
  float acc = 0.f;
  for (int c = 2 * lane; c < D; c += 64) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o + base + c));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dout + base + c));
    acc += b.x * a.x + b.y * a.y;
  }
  acc = warp_sum(acc);
  if (lane == 0) delta[row] = acc;
}

__global__ void __launch_bounds__(256)
    bwd_cast(const float* __restrict__ acc, bf16* __restrict__ dq, size_t n) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x)
    dq[i] = __float2bfloat16(acc[i]);
}

template <int DP>
__global__ void __launch_bounds__(WgBwd<DP>::THREADS, 1)
    flash_bwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq_acc, int* __restrict__ turns, int* __restrict__ ticket,
                    bf16* __restrict__ dk, bf16* __restrict__ dv, int BH, int T_, int S, int D,
                    int causal, float scale) {
  using W = WgBwd<DP>;
  using namespace mxh;
  constexpr int BK = W::BK, BQ = W::BQ, ST = W::STAGES, NB = W::DQ_BUFS, NA = DP / 2,
                NQ = DP / 4;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(128) char smem_raw[];
  char* sK = reinterpret_cast<char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                     ~uintptr_t(1023));
  char* sV = sK + W::KV_BYTES;
  char* sQD = sV + W::KV_BYTES;                   // stage s: Q, then dO
  char* sDS = sQD + ST * 2 * W::QT_BYTES;
  float* sDQ = reinterpret_cast<float*>(sDS + W::DS_BYTES);    // NB (BQ, D) f32 buffers
  float* sStat = reinterpret_cast<float*>(sDS + W::DS_BYTES + NB * W::DQ_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(sStat + ST * 2 * BQ);  // stage s: lse * log2e, delta
  uint64_t* empty = full + ST;
  uint64_t* kvbar = empty + ST;
  uint64_t* dqfull = kvbar + 1;                   // [NB]
  uint64_t* dqempty = dqfull + NB;                // [NB]
  __shared__ int s_tile;

  if (threadIdx.x == 0) {
    s_tile = atomicAdd(ticket, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 32);   // the producer warp's lanes
      mbar_init(&empty[s], 2);   // one arrival per consumer warpgroup
    }
    mbar_init(kvbar, 1);
    for (int b = 0; b < NB; ++b) {
      mbar_init(&dqfull[b], 256);   // every consumer thread
      mbar_init(&dqempty[b], 1);    // the dq warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int kt = s_tile / BH, bh = s_tile % BH;
  const int k0 = kt * BK;
  const int off = S - T_;
  const int nq = (T_ + BQ - 1) / BQ;
  // first query tile that can see this key tile (attention.py:494-501)
  const int lower = causal ? max(0, k0 - off) / BQ : 0;

  if (threadIdx.x < 128) {
    // 128 x 24 + 256 x 240 registers: the whole register file
    reg_dealloc<24>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_expect(kvbar, 2 * W::KV_BYTES);
        for (int h = 0; h < W::HALVES; ++h) {
          tma_load_3d(sK + h * BK * 128, &tk, kvbar, 64 * h, k0, bh);
          tma_load_3d(sV + h * BK * 128, &tv, kvbar, 64 * h, k0, bh);
        }
      }
      for (int i = lower; i < nq; ++i) {
        const int n = i - lower, s = n % ST;
        if (n >= ST) mbar_wait(&empty[s], (n / ST - 1) & 1);
        if (lane == 0) {
          // the tiles first: their copies run while the lanes load lse and delta
          char* sQ = sQD + s * 2 * W::QT_BYTES;
          char* sDO = sQ + W::QT_BYTES;
          mbar_expect_tx(&full[s], 2 * W::QT_BYTES);
          for (int h = 0; h < W::HALVES; ++h) {
            tma_load_3d(sQ + h * BQ * 128, &tq, &full[s], 64 * h, i * BQ, bh);
            tma_load_3d(sDO + h * BQ * 128, &tdo, &full[s], 64 * h, i * BQ, bh);
          }
        }
        float* st = sStat + s * 2 * BQ;
        for (int r = lane; r < BQ; r += 32) {
          const int qp = i * BQ + r;
          const bool ok = qp < T_;
          st[r] = ok ? lse[static_cast<size_t>(bh) * T_ + qp] * kLog2e : 0.f;
          st[BQ + r] = ok ? delta[static_cast<size_t>(bh) * T_ + qp] : 0.f;
        }
        mbar_arrive(&full[s]);
      }
    } else if (threadIdx.x == 32) {
      // the dq warp: adds each query tile's contribution to the f32
      // accumulator in ascending key-tile order, off the consumers' path.
      // Tile i's copy is issued before tile i - 1's is completed and its
      // turn passed on, so two are in flight.
      int* const head_turns = turns + static_cast<size_t>(bh) * nq;
      for (int i = lower; i <= nq; ++i) {
        const int n = i - lower;
        if (i < nq) {
          const int b = n % NB;
          mbar_wait(&dqfull[b], (n / NB) & 1);
          const long long t0 = clock64();
          while (ld_acquire(head_turns + i) != kt) {
            if (clock64() - t0 > (1LL << 34)) __trap();
          }
          fence_proxy_async_global();
          const int rows = min(BQ, T_ - i * BQ);
          bulk_store_f32(dq_acc + (static_cast<size_t>(bh) * T_ + i * BQ) * D,
                         sDQ + b * BQ * DP, static_cast<uint32_t>(rows * D * 4), kt > 0);
        }
        if (n > 0) {
          if (i < nq) bulk_wait<1>();
          else bulk_wait<0>();
          fence_proxy_async_global();
          st_release(head_turns + i - 1, kt + 1);
          mbar_arrive(&dqempty[(n - 1) % NB]);
        }
      }
    }
  } else {
    reg_alloc<240>();
    const int w = threadIdx.x / 128 - 1;          // keys [64 w, 64 w + 64) of the tile
    const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int kr = 64 * w + 16 * warp + g;        // this thread's keys in the tile: kr, kr + 8
    const float scale_log2 = scale * kLog2e;
    float adk[NA], adv[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) adk[i] = adv[i] = 0.f;
    mbar_wait(kvbar, 0);
    for (int i = lower; i < nq; ++i) {
      const int n = i - lower, s = n % ST;
      const int q0 = i * BQ;
      mbar_wait(&full[s], (n / ST) & 1);
      const char* sQ = sQD + s * 2 * W::QT_BYTES;
      const char* sDO = sQ + W::QT_BYTES;
      const float* st = sStat + s * 2 * BQ;
      // S^T = K Q^T and dP^T = V dO^T: rows are keys, columns queries
      float sT[32], dpT[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) sT[e] = dpT[e] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int h = kk / 4, c = 32 * (kk % 4);
        wgmma_ss<64, 0, 0>(sT, desc_sw128(sK + h * BK * 128 + w * 64 * 128 + c, 16, 1024),
                           desc_sw128(sQ + h * BQ * 128 + c, 16, 1024), 1);
        wgmma_ss<64, 0, 0>(dpT, desc_sw128(sV + h * BK * 128 + w * 64 * 128 + c, 16, 1024),
                           desc_sw128(sDO + h * BQ * 128 + c, 16, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      const bool need_mask = q0 + BQ > T_ || k0 + BK > S ||
                             (causal && k0 + 64 * w + 63 > q0 + off);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int qc = 8 * (e / 4) + 2 * t + (e & 1);
        float p = ex2(sT[e] * scale_log2 - st[qc]);
        if (need_mask) {
          const int kp = k0 + kr + 8 * ((e / 2) & 1), qp = q0 + qc;
          if (qp >= T_ || kp >= S || (causal && kp > qp + off)) p = 0.f;
        }
        sT[e] = p;
        dpT[e] = p * (dpT[e] - st[BQ + qc]) * scale;
      }
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        frag_from_acc(pa[kk], sT, kk);
        frag_from_acc(da[kk], dpT, kk);
      }
      // dV += P^T dO, dK += dS^T Q (the queries are the reduction)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        wgmma_rs<DP, 1>(adv, pa[kk], desc_sw128(sDO + kk * 2048, BQ * 128, 1024), 1);
        wgmma_rs<DP, 1>(adk, da[kk], desc_sw128(sQ + kk * 2048, BQ * 128, 1024), 1);
      }
      wgmma_commit();
      // dS^T to shared memory in the 128-byte swizzle, for the dq product
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = kr + 8 * (r & 1);        // a[0], a[2]: row g; a[1], a[3]: row g + 8
          const int chunk = 2 * kk + (r >> 1);     // 8-query chunk of the row
          *reinterpret_cast<uint32_t*>(sDS + row * 128 + ((chunk ^ (row & 7)) << 4) + 4 * t) =
              da[kk][r];
        }
      // the register fragments are free once dV and dK have read them
      wgmma_wait_all();
      fence_proxy_async();
      named_sync(1, 256);
      // this warpgroup's half of the head dim of dq += dS K (the keys are the
      // reduction): dS^T and K read through the transpose flag
      float adq[NQ];
#pragma unroll
      for (int e = 0; e < NQ; ++e) adq[e] = 0.f;
      const char* sKh = DP == 128 ? sK + w * BK * 128 : sK + w * 64;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_ss<DP / 2, 1, 1>(adq, desc_sw128(sDS + kk * 2048, 16, 1024),
                               desc_sw128(sKh + kk * 2048, BK * 128, 1024), 1);
      wgmma_commit();
      wgmma_wait_all();
      if ((threadIdx.x & 127) == 0) mbar_arrive(&empty[s]);
      // dS^T is read by both warpgroups' dq products: the next write waits
      named_sync(2, 256);
      // hand the contribution, rows of D floats as in the accumulator, to
      // the dq warp
      const int b = n % NB;
      if (n >= NB) mbar_wait(&dqempty[b], (n / NB - 1) & 1);
      float* dqs = sDQ + b * BQ * DP;
#pragma unroll
      for (int e = 0; e < NQ; e += 2) {
        const int r = 16 * warp + g + 8 * ((e / 2) & 1);
        const int c = (DP / 2) * w + 8 * (e / 4) + 2 * t;
        if (c < D) *reinterpret_cast<float2*>(dqs + r * D + c) = make_float2(adq[e], adq[e + 1]);
      }
      fence_proxy_async();
      mbar_arrive(&dqfull[b]);
    }
    bf16* dkb = dk + static_cast<size_t>(bh) * S * D;
    bf16* dvb = dv + static_cast<size_t>(bh) * S * D;
#pragma unroll
    for (int e = 0; e < NA; e += 2) {
      const int kp = k0 + kr + 8 * ((e / 2) & 1);
      const int c = 8 * (e / 4) + 2 * t;
      if (kp < S && c < D) {
        const size_t at = static_cast<size_t>(kp) * D + c;
        *reinterpret_cast<__nv_bfloat162*>(dkb + at) = __floats2bfloat162_rn(adk[e], adk[e + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dvb + at) = __floats2bfloat162_rn(adv[e], adv[e + 1]);
      }
    }
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
  void *ws_f32, *ws_i32;
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

template <int DP>
int launch_wgmma(const Args& a) {
  using W = WgBwd<DP>;
  if (a.D % 8 != 0 || a.ws_f32 == nullptr || a.ws_i32 == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv, tdo;
  if (!mxh::bf16_rows_map(&tq, a.q, a.BH, a.T, a.D, W::BQ) ||
      !mxh::bf16_rows_map(&tdo, a.dout, a.BH, a.T, a.D, W::BQ) ||
      !mxh::bf16_rows_map(&tk, a.k, a.BH, a.S, a.D, W::BK) ||
      !mxh::bf16_rows_map(&tv, a.v, a.BH, a.S, a.D, W::BK))
    return static_cast<int>(cudaErrorNotSupported);  // a tensor map was refused
  const int nq = (a.T + W::BQ - 1) / W::BQ, nk = (a.S + W::BK - 1) / W::BK;
  const size_t rows = static_cast<size_t>(a.BH) * a.T;
  float* dq_acc = static_cast<float*>(a.ws_f32);
  float* delta = dq_acc + rows * a.D;
  int* turns = static_cast<int*>(a.ws_i32);
  int* ticket = turns + static_cast<size_t>(a.BH) * nq;
  bwd_prep<<<static_cast<unsigned>((rows + 7) / 8), 256, 0, a.stream>>>(
      static_cast<const bf16*>(a.o), static_cast<const bf16*>(a.dout), delta, turns,
      a.BH * nq + 1, static_cast<int>(rows), a.D);
  if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  if (int err = prepare(flash_bwd_wgmma<DP>, W::SMEM)) return err;
  flash_bwd_wgmma<DP><<<nk * a.BH, W::THREADS, W::SMEM, a.stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(a.lse), delta, dq_acc, turns, ticket,
      static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.BH, a.T, a.S, a.D, a.causal,
      a.scale);
  if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  bwd_cast<<<1024, 256, 0, a.stream>>>(dq_acc, static_cast<bf16*>(a.dq), rows * a.D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace mxfa

// q, o, do, dq (B*H, T, D) and k, v, dk, dv (B*H, S, D) in the storage type;
// lse (B*H, T) f32 from mx_flash_fwd. bf16 at DP 64 or 128 (D % 8 == 0,
// 16-byte aligned rows) runs the one sweep and needs the workspaces: ws_f32
// of B*H*T*(D + 1) floats (the dq accumulator, then delta) and ws_i32 of
// B*H*ceil(T/64) + 1 ints (turn counters, then the ticket); the other routes
// take null. Launches every kernel of the route on `stream`. Returns the
// first CUDA error code (0 on success).
extern "C" int mx_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                            const void* lse, const void* dout, void* dq, void* dk, void* dv,
                            void* ws_f32, void* ws_i32, int BH, int T, int S, int D, int DP,
                            int causal, float scale, int bf16, void* stream) {
  using namespace mxfa;
  if (D > DP || BH > 65535 || T < 1 || S < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, lse, dout, dq, dk, dv, ws_f32, ws_i32, BH, T, S, D, causal, scale,
               static_cast<cudaStream_t>(stream)};
  switch (DP * 2 + (bf16 != 0)) {
    case 128: return launch_f32<64>(a);
    case 256: return launch_f32<128>(a);
    case 512: return launch_f32<256>(a);
    case 129: return launch_wgmma<64>(a);
    case 257: return launch_wgmma<128>(a);
    case 513: return launch_bf16<256>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
