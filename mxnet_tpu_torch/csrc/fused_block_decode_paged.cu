// K6: one GPT block's whole T = 1 decode step over the PAGED KV pools in
// ONE cooperative launch: LN1 -> qkv GEMV (whose epilogue scatters the new
// K/V row through the block table) -> per (row, head) gather of the row's
// pages into shared memory + attention over [0, pos] -> out GEMV +
// residual -> LN2 -> fc GEMV + tanh-GeLU -> proj GEMV + residual.
// The pools [NP + 1, H, ps, hd] (page NP = the sink) are updated IN PLACE;
// the block table bt [B, maxp] maps row b's logical page i (positions
// [i*ps, (i+1)*ps)) to a physical page.
//
// Replaces the TPU kernel mxnet_tpu/ops/fused_block_gemv.py:
// _pallas_block_decode_paged (pl.pallas_call at fused_block_gemv.py:772),
// reached through fused_block_decode_paged (:1140).
//
// Bound: the weight bytes (int8: 12 D^2, 7.1 MB per GPT-2-small block; int4:
// 6 D^2 + 12 D^2 / 128 * 4, 3.8 MB) plus
// the K/V rows the step attends over (sum_b (pos_b + 1) * H * hd * itemsize
// bytes, K and V) plus the new rows (2 * B * D * itemsize bytes), at 3.35
// TB/s (bf16 pools halve the K/V bytes).
//
// Design against that bound: the weight phases are K5's
// (block_decode_common.cuh): every matrix streamed once over all resident
// CTAs. The TPU kernel held the whole pool in VMEM and gathered one (row,
// head)'s logical [L, hd] view into scratch; here the pools stay in device
// memory and one CTA per (row, head) gathers only the pages 0 .. pos / ps
// that the row attends, K and V, with L2 loads of one word (four values:
// 16 bytes of f32, 8 of bf16) into shared memory in the pool's dtype (row
// j's word e stored at (e + j) mod hd/4, so the thread-per-row score loop
// is free of bank conflicts), widened to f32 as the dots read them, then
// runs K5's score / max / sum /
// P.V code from shared memory. Each attended row is read once. The scatter
// of the new rows rides the qkv epilogue, so the grid barrier after phase 1
// orders every row's scatter before any gather (pages may be shared between
// rows: prefix-cache pages, and the sink that inactive rows write). Every
// sum keeps K5's order: K5, K6 and K7 give a row the same bits for the same
// logical cache. The shared-memory footprint (2 L hd values) caps the
// context: fusable_paged accepts L <= 432 at hd 64 with f32 pools and L <=
// 864 with bf16 pools; K7 streams longer ones.
#include "block_decode_common.cuh"

namespace cg = cooperative_groups;

namespace {

struct Args {
  mx::BlockArgs blk;
  const int* pos;  // [B]
  const int* bt;   // [B, maxp]
  void* kp;        // [NP + 1, H, ps, hd] f32 or bf16 (the kernel's C), in place
  void* vp;
  int ps, maxp, sink;
};

__device__ __forceinline__ int rot(int e, int j, int hd4) {
  const int r = e + j % hd4;
  return r < hd4 ? r : r - hd4;
}

// One CTA per (row, head): gather the row's pages 0 .. pa / ps of K and V,
// attend rows [0, pa] (pa = min(pos, L - 1)), write the head's context.
template <class C>
__device__ void attention(const Args& a, float* smem) {
  typedef typename mx::CacheWord<C>::type Word;   // four values of C
  const int D = a.blk.D, H = a.blk.H;
  const int hd = D / H, hd4 = hd >> 2;
  const int ps = a.ps, L = a.maxp * ps;
  Word* k4 = reinterpret_cast<Word*>(smem);  // [L, hd / 4] words, rotated
  Word* v4 = k4 + static_cast<size_t>(L) * hd4;
  float* qs = reinterpret_cast<float*>(v4 + static_cast<size_t>(L) * hd4);  // [hd]
  float* sc = qs + hd;                     // [L rounded up to 4]
  float* red = sc + ((L + 3) & ~3);        // [4 * kThreads]
  const int tid = threadIdx.x;
  const float scale = 1.f / sqrtf(static_cast<float>(hd));
  const int groups = mx::kThreads / hd4;
  for (int item = blockIdx.x; item < a.blk.B * H; item += gridDim.x) {
    const int b = item / H, h = item % H;
    const int pa = min(max(a.pos[b], 0), L - 1);
    const int words = (pa / ps + 1) * ps * hd4;  // float4 words to gather
    const int* table = a.bt + static_cast<size_t>(b) * a.maxp;
    for (int i = tid; i < words; i += mx::kThreads) {
      const int j = i / hd4, e = i - j * hd4;  // logical row, word
      const int page = table[j / ps];
      const size_t src = ((static_cast<size_t>(page) * H + h) * ps + j % ps) * hd4 + e;
      const int dst = j * hd4 + rot(e, j, hd4);
      // L2 loads: other CTAs wrote these pools before the grid barrier
      k4[dst] = __ldcg(static_cast<const Word*>(a.kp) + src);
      v4[dst] = __ldcg(static_cast<const Word*>(a.vp) + src);
    }
    const float* row = a.blk.qkv + static_cast<size_t>(b) * 3 * D + h * hd;
    for (int d = tid; d < hd; d += mx::kThreads) qs[d] = row[d];
    __syncthreads();
    const float4* q4 = reinterpret_cast<const float4*>(qs);
    for (int j = tid; j <= pa; j += mx::kThreads) {
      const Word* kr = k4 + static_cast<size_t>(j) * hd4;
      float s = 0.f;
      for (int e = 0; e < hd4; ++e) {  // K5's order: ascending e
        const float4 kv = mx::widen_word(kr[rot(e, j, hd4)]);
        const float4 qv = q4[e];
        s = fmaf(qv.x, kv.x, s);
        s = fmaf(qv.y, kv.y, s);
        s = fmaf(qv.z, kv.z, s);
        s = fmaf(qv.w, kv.w, s);
      }
      sc[j] = s * scale;
    }
    __syncthreads();
    const float sum = mx::softmax_scores(sc, pa, red);
    float4 part = make_float4(0.f, 0.f, 0.f, 0.f);
    const int g = tid / hd4, d4 = tid - g * hd4;
    if (g < groups) {
      for (int j = g; j <= pa; j += groups) {
        mx::fma4(part, sc[j] / sum,
                 mx::widen_word(v4[static_cast<size_t>(j) * hd4 + rot(d4, j, hd4)]));
      }
    }
    mx::store_head_context(part, red, groups, hd, a.blk.ctx + static_cast<size_t>(b) * D + h * hd);
  }
}

template <class W, class X, class C>
__global__ void __launch_bounds__(mx::kThreads) fused_block_decode_paged_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  // the qkv phase scatters the new K/V rows; its barrier orders them before
  // any gather
  mx::block_step<W, X, C>(a.blk, smem, grid,
                          mx::PagedRows<C>{a.pos, a.bt, static_cast<C*>(a.kp),
                                           static_cast<C*>(a.vp), a.ps, a.maxp, a.sink},
                          [&] { attention<C>(a, smem); });
}

template <class W, class X, class C>
struct Kernel {
  static void (*get())(Args) { return fused_block_decode_paged_kernel<W, X, C>; }
};

}  // namespace

// Dynamic shared memory of K6 in bytes (0 if the shape cannot run): the
// staged activation tile, or the gathered [L, hd] K and V (itemsize bytes a
// value), q, the score row of L rounded up to 4 and the float4 P.V
// reduction scratch, whichever is larger (ops/fused_block_gemv._paged_smem).
extern "C" long long mx_paged_smem(int D, int H, int ps, int maxp, int itemsize) {
  if (H <= 0 || D % H || (D / H) % 8 || ps < 1 || maxp < 1 || (itemsize != 2 && itemsize != 4))
    return 0;
  const long long hd = D / H, L = static_cast<long long>(ps) * maxp;
  const long long tile = 4 * mx::block_tile_floats(D);
  const long long attn =
      2 * L * hd * itemsize + 4 * (hd + ((L + 3) & ~3LL) + 4 * mx::kThreads);
  return tile > attn ? tile : attn;
}

// bt [B, maxp] int32; pools [sink + 1, H, ps, D / H], bf16 where cache_bf16,
// else f32; x bf16 where x_bf16, else f32; scratch 9 * B * D f32.
extern "C" int mx_fused_block_decode_paged(
    const void* x, const void* pos, const void* bt, const void* w_qkv, const void* s_qkv,
    const void* b_qkv, const void* w_out, const void* s_out, const void* b_out,
    const void* w_fc, const void* s_fc, const void* b_fc, const void* w_proj,
    const void* s_proj, const void* b_proj, const void* g1, const void* be1, const void* g2,
    const void* be2, void* kp, void* vp, void* scratch, void* out, int B, int D, int H, int ps,
    int maxp, int sink, int block, int block4, int x_bf16, int cache_bf16, float eps,
    void* stream) {
  Args a;
  mx::set_block_args(a.blk, x, w_qkv, s_qkv, b_qkv, w_out, s_out, b_out, w_fc, s_fc, b_fc,
                     w_proj, s_proj, b_proj, g1, be1, g2, be2, scratch, out, B, D, H, block,
                     block4, eps);
  a.pos = static_cast<const int*>(pos);
  a.bt = static_cast<const int*>(bt);
  a.kp = kp;
  a.vp = vp;
  a.ps = ps;
  a.maxp = maxp;
  a.sink = sink;

  const size_t smem = static_cast<size_t>(mx_paged_smem(D, H, ps, maxp, cache_bf16 ? 2 : 4));
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  return mx::launch_block(mx::pick_block_kernel<Kernel>(a, x_bf16, cache_bf16), a, smem, stream);
}
