// K5: one GPT block's whole T = 1 decode step in ONE cooperative launch:
//   LN1 -> qkv GEMV (epilogue writes the new K/V row at pos[b]) -> cached
//   attention over [0, pos[b]] -> out GEMV + residual -> LN2 -> fc GEMV +
//   tanh-GeLU -> proj GEMV + residual.
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
// Every reduction has a fixed order that does not depend on B or on the
// slot, so a request decodes to the same bits alone or in a full batch.
//
// Redesigned for Hopper after splitting the first design's device time by
// probe builds (tools/head_block_compare.py --probes; PERF.md): the first
// design read every key row thread by thread straight from device memory
// (32 rows 256 bytes apart a warp, no staging, one (row, head) a CTA) and
// ran two CTAs an SM, each staging the activations and waiting at every
// grid barrier. Now:
// - attention is K7's streamed attention (block_decode_common.cuh): a (row,
//   head)'s rows [0, pos] of a contiguous cache are one slab of (pos + 1)
//   hd values, copied slot by slot into the ring, one 1-D TMA bulk copy a
//   slot (no table), or for bf16 caches at hd 64 2-D tensor copies of
//   16-row boxes with the 128-byte swizzle; pass 1 reads f32 (and unswizzled
//   bf16) rows lagged, pass 2 takes K5's group order: the same sums;
// - the new K/V rows are written by the qkv epilogue (the grid barrier after
//   it orders them before any copy), rounded once to the cache's dtype;
// - the launch takes one CTA an SM.
#include <cstdint>

#include "block_decode_common.cuh"

namespace cg = cooperative_groups;

namespace {

// key rows of a bf16 slab's tensor-copy box: whole 1 KB swizzle patterns
constexpr int kBoxRows = 16;

struct Args {
  mx::BlockArgs blk;
  const int* pos;  // [B]
  void* kc;        // [B, H, L, hd] f32 or bf16 (the kernel's C), in place
  void* vc;
  int L, depth, rows;  // ring slots, key rows a slot
  // swz: K rows come by 2-D tensor copies through tk (kc as [B H, L, 64]
  // bf16, kBoxRows-row boxes, 128-byte swizzle): bf16 caches at hd 64
  int swz;
  alignas(64) CUtensorMap tk;
};

// The copies of a contiguous cache: load i of a (row, head) copies rows
// [t rows, min((t + 1) rows, pa + 1)) of its K (i < n) or V slab (t = i %
// n); one bulk copy, or (swizzled K) ceil(rows / kBoxRows) box copies,
// whose rows past pa are copied and never read.
template <class C>
struct SlabSource {
  const C* cache[2];  // K, V
  const CUtensorMap* tk;
  int H, hd, L, rows, swz;

  __device__ __forceinline__ int tiles(int pa) const { return (pa + rows) / rows; }
  __device__ __forceinline__ bool swizzled() const { return sizeof(C) == 2 && swz; }
  __device__ void start(int b, int h, int pa, int i, int n, C* slot, uint64_t* bar) const {
    const int r0 = (i % n) * rows;
    const int nr = min(rows, pa + 1 - r0);
    if (swizzled() && i < n) {
      const int boxes = (nr + kBoxRows - 1) / kBoxRows;
      mxh::mbar_expect(bar, static_cast<uint32_t>(boxes) * kBoxRows * hd * sizeof(C));
      for (int k = 0; k < boxes; ++k) {
        mxh::tma_load_3d(slot + static_cast<size_t>(k) * kBoxRows * hd, tk, bar, 0,
                         r0 + k * kBoxRows, b * H + h);
      }
      return;
    }
    const uint32_t bytes = static_cast<uint32_t>(nr) * hd * sizeof(C);
    mxh::mbar_expect(bar, bytes);
    mx::warp::bulk_copy(slot,
                        (i < n ? cache[0] : cache[1]) +
                            (static_cast<size_t>(b * H + h) * L + r0) * hd,
                        bytes, bar);
  }
  __device__ __forceinline__ void waited(int, int, int) const {}
};

template <class W, class X, class C>
__global__ void __launch_bounds__(mx::kThreads, mx::kBlockCtasPerSm)
    fused_block_decode_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(1024) float smem[];
  cg::grid_group grid = cg::this_grid();
  // swizzled slots need their 1 KB swizzle patterns aligned
  if (sizeof(C) == 2 && a.swz && (mxh::smem_addr(smem) & 1023u)) __trap();
  // the qkv phase writes the new K/V rows (a contiguous cache is row b's
  // page b of L rows); its barrier orders them before any copy. The
  // attention's operands are formed inside its phase, as K7's.
  mx::block_step<W, X, C>(
      a.blk, smem, grid,
      mx::KVRows<C>{a.pos, nullptr, static_cast<C*>(a.kc), static_cast<C*>(a.vc), a.L, 1, 0},
      [&] {
        const SlabSource<C> src{{static_cast<const C*>(a.kc), static_cast<const C*>(a.vc)},
                                &a.tk, a.blk.H, a.blk.D / a.blk.H, a.L, a.rows, a.swz};
        mx::streamed_attention<C>(a.blk, a.pos, a.L, src, smem,
                                  mx::streamed_bars(smem, a.blk, a.L, a.depth, a.rows, sizeof(C)),
                                  a.depth, a.rows);
      });
}

template <class W, class X, class C>
struct Kernel {
  static void (*get())(Args) { return fused_block_decode_kernel<W, X, C>; }
};

constexpr int kDepth = 2;  // ring slots

}  // namespace

// Key rows a ring slot of K5 holds (ops/fused_block_gemv._slab_rows): 1024
// / itemsize (K7's slot), fewer by kBoxRows while the ring does not fit.
extern "C" int mx_fused_block_slot_rows(int D, int H, int L, int itemsize) {
  int rows = mx::kThreads * 4 / itemsize;
  while (rows > kBoxRows &&
         mx::streamed_smem(1, D, H, L, kDepth, rows, itemsize) > mx::kSmemLimit)
    rows -= kBoxRows;
  return rows;
}

// Dynamic shared memory of K5 in bytes at B rows (0 if the shape cannot
// run): the staged activation tile (block_rows(B, D) rows of the 4D-wide
// fc activations) or the attention layout (the ring of two slots, q, one
// score row of L f32 rounded up to 4, the float4 P.V reduction scratch and
// the item order), whichever is larger; then the mbarriers
// (ops/fused_block_gemv._block_smem).
extern "C" long long mx_fused_block_smem(int B, int D, int H, int L, int itemsize) {
  if (B < 1 || H <= 0 || D % H || (D / H) % 8 || L < 1 || (itemsize != 2 && itemsize != 4))
    return 0;
  return mx::streamed_smem(B, D, H, L, kDepth, mx_fused_block_slot_rows(D, H, L, itemsize),
                           itemsize);
}

// scratch: 9 * B * D f32 (qkv 3D, ctx D, res D, fc 4D per row). block =
// block4 = 0: int8 weights; else int4 weights with those scale blocks
// (BlockArgs). x is bf16 where x_bf16, else f32; kc/vc bf16 where
// cache_bf16, else f32, 16-byte aligned.
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
  a.depth = kDepth;
  const int itemsize = cache_bf16 ? 2 : 4;
  a.rows = mx_fused_block_slot_rows(D, H, L, itemsize);
  a.swz = cache_bf16 && D / H == 64 && mx::bf16_cache_map(&a.tk, kc, B * H, L, kBoxRows);
  if (reinterpret_cast<uintptr_t>(kc) % 16 || reinterpret_cast<uintptr_t>(vc) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);  // TMA needs 16-byte slabs
  }
  const size_t smem = static_cast<size_t>(mx_fused_block_smem(B, D, H, L, itemsize));
  if (smem == 0 || smem > static_cast<size_t>(mx::kSmemLimit)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return mx::launch_block(mx::pick_block_kernel<Kernel>(a, x_bf16, cache_bf16), a, smem, stream);
}
