// K5: one GPT block's whole T = 1 decode step in ONE cooperative launch:
//   LN1 -> qkv GEMV -> K/V row write at pos[b] + cached attention over
//   [0, pos[b]] -> out GEMV + residual -> LN2 -> fc GEMV + tanh-GeLU ->
//   proj GEMV + residual.
// The K/V caches [B, H, L, hd] are updated IN PLACE (the TPU kernel
// returned new cache arrays).
//
// Replaces the TPU kernel mxnet_tpu/ops/fused_block_gemv.py:
// _pallas_block_decode (pl.pallas_call at fused_block_gemv.py:566), reached
// through fused_block_decode (:1116).
//
// Bound: the int8 weight bytes (12 D^2: 7.1 MB per GPT-2-small block) plus
// the cache rows the step attends over (B * H * (pos + 1) * hd * 4 bytes,
// K and V), at 3.35 TB/s; at long positions the cache rows dominate.
//
// Design against that bound: every weight matrix is streamed once, by
// warps spread over all resident CTAs, with the dot of gemv_common.cuh
// (16-byte int8 loads per lane, f32 accumulation, scale after the dot) and
// bias / residual / GeLU applied in registers. Activations stay on chip or
// in a few KB of global scratch; LayerNorm is recomputed per CTA from the
// B x D rows instead of paying a grid barrier. The TPU grid ran its phases
// in order on one core; here the phases are separated by
// cooperative_groups grid barriers, so the grid never exceeds the number
// of co-resident CTAs. Attention takes one CTA per (row, head): it reads
// only rows [0, pos] of that head's K and V once. Every reduction has a
// fixed order that does not depend on B or on the slot, so a request
// decodes to the same bits alone or in a full batch.
#include <cmath>

#include <cooperative_groups.h>

#include "gemv_common.cuh"

namespace cg = cooperative_groups;

namespace {

static_assert(mx::kWarps == mx::kRowTile, "LayerNorm staging gives one warp per row");

struct Args {
  const float* x;  // [B, D]
  const int* pos;  // [B]
  const int8_t* w_qkv;
  const float* s_qkv;
  const float* b_qkv;  // [3D, D]
  const int8_t* w_out;
  const float* s_out;
  const float* b_out;  // [D, D]
  const int8_t* w_fc;
  const float* s_fc;
  const float* b_fc;  // [4D, D]
  const int8_t* w_proj;
  const float* s_proj;
  const float* b_proj;  // [D, 4D]
  const float* g1;
  const float* be1;
  const float* g2;
  const float* be2;
  float* kc;   // [B, H, L, hd], in place
  float* vc;   // [B, H, L, hd], in place
  float* qkv;  // scratch [B, 3D]
  float* ctx;  // scratch [B, D]
  float* res;  // scratch [B, D]
  float* fc;   // scratch [B, 4D]
  float* out;  // [B, D]
  int B, D, H, L;
  float eps;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Fixed-order CTA reductions; every thread returns the same value.
__device__ float cta_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int q = 1; q < mx::kWarps; ++q) r += red[q];
  __syncthreads();
  return r;
}

__device__ float cta_max(float v, float* red) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int q = 1; q < mx::kWarps; ++q) r = fmaxf(r, red[q]);
  __syncthreads();
  return r;
}

// LayerNorm of rows [r0, r0 + nr) of src[., D] into xs[nr][D] (swizzle4
// layout); warp w normalises row r0 + w (mean, E[x^2] - mean^2 clamped
// at 0, rsqrt).
__device__ void stage_ln(float* xs, const float* src, int r0, int nr, int D,
                         const float* g, const float* be, float eps) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp < nr) {
    const float* row = src + static_cast<size_t>(r0 + warp) * D;
    float s = 0.f, ss = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float v = row[d];
      s += v;
      ss = fmaf(v, v, ss);
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    const float mean = s / D;
    const float var = fmaxf(ss / D - mean * mean, 0.f);
    const float inv = rsqrtf(var + eps);
    for (int d = lane; d < D; d += 32) {
      xs[warp * D + 4 * mx::swizzle4(d >> 2, D) + (d & 3)] = (row[d] - mean) * inv * g[d] + be[d];
    }
  }
}

__device__ __forceinline__ float gelu_tanh(float v) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return v * (0.5f * (1.f + tanhf(c * (v + 0.044715f * (v * v * v)))));
}

enum Epilogue { kStore, kResidual, kGelu };

// out[r0 + r, n] = epilogue(xs[r] . w[n] * s[n] + bias[n]) for the staged
// rows, n over all warps of the grid.
template <Epilogue E>
__device__ void gemv_rows(const float* xs, int r0, int nr, const int8_t* w, const float* s,
                          const float* bias, int N, int K, const float* resid, float* dst) {
  const int lane = threadIdx.x & 31;
  const int gw = blockIdx.x * mx::kWarps + (threadIdx.x >> 5);
  for (int n = gw; n < N; n += gridDim.x * mx::kWarps) {
    float acc[mx::kRowTile];
    mx::warp_dot_rows(xs, nr, w + static_cast<size_t>(n) * K, K, acc);
    const float sc = __ldg(s + n);
    const float bn = __ldg(bias + n);
#pragma unroll
    for (int r = 0; r < mx::kRowTile; ++r) {
      if (lane == r && r < nr) {
        const size_t o = static_cast<size_t>(r0 + r) * N + n;
        const float y = acc[r] * sc + bn;
        if (E == kResidual) {
          dst[o] = resid[o] + y;
        } else if (E == kGelu) {
          dst[o] = gelu_tanh(y);
        } else {
          dst[o] = y;
        }
      }
    }
  }
}

// One CTA per (row, head): write the new K/V row at pos, attend rows
// [0, pos], write the head's context. Scores take one thread per key row
// (the hd-long dot in ascending order, hd / 4 independent 16-byte loads
// in flight per thread); P.V takes groups of hd / 4 threads, each group
// walking every groups-th cache row with one float4 of the head dim per
// thread, and the group partials are summed in group order.
__device__ void attention(const Args& a, float* smem) {
  const int D = a.D, H = a.H, L = a.L;
  const int hd = D / H;
  const int hd4 = hd >> 2;                 // float4 words per head row
  float* qs = smem;                        // [hd]
  float* sc = qs + hd;                     // [L rounded up to 4]
  float* red = sc + ((L + 3) & ~3);        // [4 * kThreads]
  const int tid = threadIdx.x;
  const float scale = 1.f / sqrtf(static_cast<float>(hd));
  const int groups = mx::kThreads / hd4;
  for (int item = blockIdx.x; item < a.B * H; item += gridDim.x) {
    const int b = item / H, h = item % H;
    // clamped into the cache as lax.dynamic_update_slice clamps: a bad
    // position never writes outside the row's [L, hd] slab
    const int p = min(max(a.pos[b], 0), L - 1);
    float* kb = a.kc + static_cast<size_t>(b * H + h) * L * hd;
    float* vb = a.vc + static_cast<size_t>(b * H + h) * L * hd;
    const float* row = a.qkv + static_cast<size_t>(b) * 3 * D + h * hd;
    for (int d = tid; d < hd; d += mx::kThreads) {
      qs[d] = row[d];
      kb[static_cast<size_t>(p) * hd + d] = row[D + d];
      vb[static_cast<size_t>(p) * hd + d] = row[2 * D + d];
    }
    __syncthreads();
    const float4* q4 = reinterpret_cast<const float4*>(qs);
    for (int j = tid; j <= p; j += mx::kThreads) {
      const float4* kr = reinterpret_cast<const float4*>(kb + static_cast<size_t>(j) * hd);
      float s = 0.f;
      for (int e = 0; e < hd4; ++e) {
        const float4 kv = kr[e];
        const float4 qv = q4[e];
        s = fmaf(qv.x, kv.x, s);
        s = fmaf(qv.y, kv.y, s);
        s = fmaf(qv.z, kv.z, s);
        s = fmaf(qv.w, kv.w, s);
      }
      sc[j] = s * scale;
    }
    __syncthreads();
    float m = -INFINITY;
    for (int j = tid; j <= p; j += mx::kThreads) m = fmaxf(m, sc[j]);
    m = cta_max(m, red);
    float sum = 0.f;
    for (int j = tid; j <= p; j += mx::kThreads) {
      const float e = expf(sc[j] - m);
      sc[j] = e;
      sum += e;
    }
    sum = cta_sum(sum, red);  // its barriers also publish sc[]
    float4 part = make_float4(0.f, 0.f, 0.f, 0.f);
    const int g = tid / hd4, d4 = tid - g * hd4;
    if (g < groups) {
      for (int j = g; j <= p; j += groups) {
        const float w = sc[j] / sum;
        const float4 vv = reinterpret_cast<const float4*>(vb + static_cast<size_t>(j) * hd)[d4];
        part.x = fmaf(w, vv.x, part.x);
        part.y = fmaf(w, vv.y, part.y);
        part.z = fmaf(w, vv.z, part.z);
        part.w = fmaf(w, vv.w, part.w);
      }
    }
    // group g's partial of head element t lands at red[g * hd + t]
    reinterpret_cast<float4*>(red)[tid] = part;
    __syncthreads();
    if (tid < hd) {
      float c = red[tid];
      for (int q = 1; q < groups; ++q) c += red[q * hd + tid];
      a.ctx[static_cast<size_t>(b) * D + h * hd + tid] = c;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(mx::kThreads) fused_block_decode_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const int D = a.D;
  // phase 1: LN1 -> qkv
  for (int r0 = 0; r0 < a.B; r0 += mx::kRowTile) {
    const int nr = min(mx::kRowTile, a.B - r0);
    stage_ln(smem, a.x, r0, nr, D, a.g1, a.be1, a.eps);
    __syncthreads();
    gemv_rows<kStore>(smem, r0, nr, a.w_qkv, a.s_qkv, a.b_qkv, 3 * D, D, nullptr, a.qkv);
    __syncthreads();
  }
  grid.sync();
  // phase 2: cache row write + attention -> ctx
  attention(a, smem);
  grid.sync();
  // phase 3: out GEMV + residual -> res
  for (int r0 = 0; r0 < a.B; r0 += mx::kRowTile) {
    const int nr = min(mx::kRowTile, a.B - r0);
    mx::stage_rows(smem, a.ctx, r0, nr, D);
    __syncthreads();
    gemv_rows<kResidual>(smem, r0, nr, a.w_out, a.s_out, a.b_out, D, D, a.x, a.res);
    __syncthreads();
  }
  grid.sync();
  // phase 4: LN2 -> fc GEMV + GeLU -> fc
  for (int r0 = 0; r0 < a.B; r0 += mx::kRowTile) {
    const int nr = min(mx::kRowTile, a.B - r0);
    stage_ln(smem, a.res, r0, nr, D, a.g2, a.be2, a.eps);
    __syncthreads();
    gemv_rows<kGelu>(smem, r0, nr, a.w_fc, a.s_fc, a.b_fc, 4 * D, D, nullptr, a.fc);
    __syncthreads();
  }
  grid.sync();
  // phase 5: proj GEMV (K = 4D) + residual -> out
  for (int r0 = 0; r0 < a.B; r0 += mx::kRowTile) {
    const int nr = min(mx::kRowTile, a.B - r0);
    mx::stage_rows(smem, a.fc, r0, nr, 4 * D);
    __syncthreads();
    gemv_rows<kResidual>(smem, r0, nr, a.w_proj, a.s_proj, a.b_proj, D, 4 * D, a.res, a.out);
    __syncthreads();
  }
}

}  // namespace

// Dynamic shared memory the kernel needs (0 if the shape cannot run):
// the larger of the staged activation tile (kRowTile rows of the 4D-wide
// fc activations) and the attention buffers (q, one score row of L f32
// rounded up to 4, the float4 P.V reduction scratch).
extern "C" long long mx_fused_block_smem(int D, int H, int L) {
  if (H <= 0 || D % H || (D / H) % 4) return 0;
  const long long hd = D / H;
  const long long tile = static_cast<long long>(mx::kRowTile) * 4 * D;
  const long long attn = hd + ((L + 3) & ~3) + 4 * mx::kThreads;
  return static_cast<long long>(sizeof(float)) * (tile > attn ? tile : attn);
}

// scratch: 9 * B * D f32 (qkv 3D, ctx D, res D, fc 4D per row).
extern "C" int mx_fused_block_decode(
    const void* x, const void* pos, const void* w_qkv, const void* s_qkv, const void* b_qkv,
    const void* w_out, const void* s_out, const void* b_out, const void* w_fc,
    const void* s_fc, const void* b_fc, const void* w_proj, const void* s_proj,
    const void* b_proj, const void* g1, const void* be1, const void* g2, const void* be2,
    void* kc, void* vc, void* scratch, void* out, int B, int D, int H, int L, float eps,
    void* stream) {
  Args a;
  a.x = static_cast<const float*>(x);
  a.pos = static_cast<const int*>(pos);
  a.w_qkv = static_cast<const int8_t*>(w_qkv);
  a.s_qkv = static_cast<const float*>(s_qkv);
  a.b_qkv = static_cast<const float*>(b_qkv);
  a.w_out = static_cast<const int8_t*>(w_out);
  a.s_out = static_cast<const float*>(s_out);
  a.b_out = static_cast<const float*>(b_out);
  a.w_fc = static_cast<const int8_t*>(w_fc);
  a.s_fc = static_cast<const float*>(s_fc);
  a.b_fc = static_cast<const float*>(b_fc);
  a.w_proj = static_cast<const int8_t*>(w_proj);
  a.s_proj = static_cast<const float*>(s_proj);
  a.b_proj = static_cast<const float*>(b_proj);
  a.g1 = static_cast<const float*>(g1);
  a.be1 = static_cast<const float*>(be1);
  a.g2 = static_cast<const float*>(g2);
  a.be2 = static_cast<const float*>(be2);
  a.kc = static_cast<float*>(kc);
  a.vc = static_cast<float*>(vc);
  float* sp = static_cast<float*>(scratch);
  a.qkv = sp;
  a.ctx = a.qkv + static_cast<size_t>(B) * 3 * D;
  a.res = a.ctx + static_cast<size_t>(B) * D;
  a.fc = a.res + static_cast<size_t>(B) * D;
  a.out = static_cast<float*>(out);
  a.B = B;
  a.D = D;
  a.H = H;
  a.L = L;
  a.eps = eps;

  const size_t smem = static_cast<size_t>(mx_fused_block_smem(D, H, L));
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  int ctas = 0;
  cudaError_t err = mx::resident_ctas(fused_block_decode_kernel, smem, &ctas);
  if (err != cudaSuccess) return static_cast<int>(err);
  // enough CTAs for the widest phase (4D fc channels, one warp each) or
  // one per (row, head), never more than fit on the card at once
  int want = (4 * D + mx::kWarps - 1) / mx::kWarps;
  if (B * H > want) want = B * H;
  const int grid = want < ctas ? want : ctas;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(fused_block_decode_kernel),
                                    dim3(grid), dim3(mx::kThreads), params, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
