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
// Bound: the weight bytes (int8: 12 D^2, 7.1 MB per GPT-2-small block; int4:
// 6 D^2 + 12 D^2 / 128 * 4, 3.8 MB) plus
// the cache rows the step attends over (B * H * (pos + 1) * hd * itemsize
// bytes, K and V; bf16 caches halve them), at 3.35 TB/s; at long positions
// the cache rows dominate.
//
// Design against that bound: the weight phases of block_decode_common.cuh
// stream every matrix once over all resident CTAs, in the int8 or the int4
// weight lane (the kernel is instantiated for both; the TPU kernel's
// _deq_dot_body took either by the table's dtype); activations stay on chip
// or in a few KB of global scratch. The TPU grid ran its phases in order on
// one core; here the phases are separated by cooperative_groups grid
// barriers, so the grid never exceeds the number of co-resident CTAs.
// Attention takes one CTA per (row, head): it reads only rows [0, pos] of
// that head's K and V once. Every reduction has a fixed order that does not
// depend on B or on the slot, so a request decodes to the same bits alone
// or in a full batch.
#include "block_decode_common.cuh"

namespace cg = cooperative_groups;

namespace {

struct Args {
  mx::BlockArgs blk;
  const int* pos;  // [B]
  void* kc;        // [B, H, L, hd] f32 or bf16 (the kernel's C), in place
  void* vc;
  int L;
};

// One CTA per (row, head): write the new K/V row at pos, attend rows
// [0, pos], write the head's context. Scores take one thread per key row
// (the hd-long dot in ascending order, hd / 4 independent 16-byte loads
// in flight per thread); P.V takes groups of hd / 4 threads, each group
// walking every groups-th cache row with one word (four values) of the
// head dim per thread, and the group partials are summed in group order.
// The new row is written rounded to C and read back from the cache.
template <class C>
__device__ void attention(const Args& a, float* smem) {
  const int D = a.blk.D, H = a.blk.H, L = a.L;
  const int hd = D / H;
  const int hd4 = hd >> 2;                 // float4 words per head row
  float* qs = smem;                        // [hd]
  float* sc = qs + hd;                     // [L rounded up to 4]
  float* red = sc + ((L + 3) & ~3);        // [4 * kThreads]
  const int tid = threadIdx.x;
  const float scale = 1.f / sqrtf(static_cast<float>(hd));
  const int groups = mx::kThreads / hd4;
  for (int item = blockIdx.x; item < a.blk.B * H; item += gridDim.x) {
    const int b = item / H, h = item % H;
    // clamped into the cache as lax.dynamic_update_slice clamps: a bad
    // position never writes outside the row's [L, hd] slab
    const int p = min(max(a.pos[b], 0), L - 1);
    C* kb = static_cast<C*>(a.kc) + static_cast<size_t>(b * H + h) * L * hd;
    C* vb = static_cast<C*>(a.vc) + static_cast<size_t>(b * H + h) * L * hd;
    const float* row = a.blk.qkv + static_cast<size_t>(b) * 3 * D + h * hd;
    for (int d = tid; d < hd; d += mx::kThreads) {
      qs[d] = row[d];
      mx::store_elem(kb + static_cast<size_t>(p) * hd + d, row[D + d]);
      mx::store_elem(vb + static_cast<size_t>(p) * hd + d, row[2 * D + d]);
    }
    __syncthreads();
    const float4* q4 = reinterpret_cast<const float4*>(qs);
    for (int j = tid; j <= p; j += mx::kThreads) {
      sc[j] = mx::dot_row(q4, kb + static_cast<size_t>(j) * hd, hd4) * scale;
    }
    __syncthreads();
    const float sum = mx::softmax_scores(sc, p, red);
    float4 part = make_float4(0.f, 0.f, 0.f, 0.f);
    const int g = tid / hd4, d4 = tid - g * hd4;
    if (g < groups) {
      for (int j = g; j <= p; j += groups) {
        mx::fma4(part, sc[j] / sum, mx::load4(vb + static_cast<size_t>(j) * hd, d4));
      }
    }
    mx::store_head_context(part, red, groups, hd, a.blk.ctx + static_cast<size_t>(b) * D + h * hd);
  }
}

template <class W, class X, class C>
__global__ void __launch_bounds__(mx::kThreads) fused_block_decode_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  // no pools: the attention phase writes the cache rows and attends -> ctx
  mx::block_step<W, X, C>(a.blk, smem, grid,
                          mx::PagedRows<C>{nullptr, nullptr, nullptr, nullptr, 0, 0, 0},
                          [&] { attention<C>(a, smem); });
}

template <class W, class X, class C>
struct Kernel {
  static void (*get())(Args) { return fused_block_decode_kernel<W, X, C>; }
};

}  // namespace

// Dynamic shared memory the kernel needs (0 if the shape cannot run):
// the larger of the staged activation tile (kRowTile rows of the 4D-wide
// fc activations) and the attention buffers (q, one score row of L f32
// rounded up to 4, the float4 P.V reduction scratch).
extern "C" long long mx_fused_block_smem(int D, int H, int L) {
  if (H <= 0 || D % H || (D / H) % 4) return 0;
  const long long hd = D / H;
  const long long tile = mx::block_tile_floats(D);
  const long long attn = hd + ((L + 3) & ~3) + 4 * mx::kThreads;
  return static_cast<long long>(sizeof(float)) * (tile > attn ? tile : attn);
}

// scratch: 9 * B * D f32 (qkv 3D, ctx D, res D, fc 4D per row). block =
// block4 = 0: int8 weights; else int4 weights with those scale blocks
// (BlockArgs). x is bf16 where x_bf16, else f32; kc/vc bf16 where
// cache_bf16, else f32.
extern "C" int mx_fused_block_decode(
    const void* x, const void* pos, const void* w_qkv, const void* s_qkv, const void* b_qkv,
    const void* w_out, const void* s_out, const void* b_out, const void* w_fc,
    const void* s_fc, const void* b_fc, const void* w_proj, const void* s_proj,
    const void* b_proj, const void* g1, const void* be1, const void* g2, const void* be2,
    void* kc, void* vc, void* scratch, void* out, int B, int D, int H, int L, int block,
    int block4, int x_bf16, int cache_bf16, float eps, void* stream) {
  Args a;
  mx::set_block_args(a.blk, x, w_qkv, s_qkv, b_qkv, w_out, s_out, b_out, w_fc, s_fc, b_fc,
                     w_proj, s_proj, b_proj, g1, be1, g2, be2, scratch, out, B, D, H, block,
                     block4, eps);
  a.pos = static_cast<const int*>(pos);
  a.kc = kc;
  a.vc = vc;
  a.L = L;

  const size_t smem = static_cast<size_t>(mx_fused_block_smem(D, H, L));
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  return mx::launch_block(mx::pick_block_kernel<Kernel>(a, x_bf16, cache_bf16), a, smem, stream);
}
