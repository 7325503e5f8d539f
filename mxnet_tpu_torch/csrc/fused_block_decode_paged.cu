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
// Design against that bound: the weight phases are block_decode_common.cuh's
// (every matrix streamed once over all resident CTAs; past 8 rows in tiles
// of 16, so a 16-row step streams each matrix once, not twice). The TPU
// kernel held the whole pool in VMEM and gathered one (row, head)'s logical
// [L, hd] view into scratch; here the pools stay in device memory and a CTA
// gathers the pages 0 .. pos / ps that a (row, head) attends, its K pages
// into one slot of shared memory and its V pages into another, in the
// pool's dtype: one thread starts a TMA copy per page (1-D bulk copies, or
// 2-D tensor copies with the 128-byte swizzle for bf16 key pages at hd 64,
// ps % 8 == 0) that complete on the slot's mbarrier. It is
// block_decode_common.cuh's streamed attention with a slot as long as the
// context (tp = maxp pages): the copies of a CTA's next (row, head) start
// as soon as a slot is read (3 or 4 slots where they fit: the next item's K
// and V are in flight while this one computes), and a CTA with two items
// takes them longest first, snaking. The first design gathered with
// synchronous L2 loads into rotated rows, every word before any dot, and
// took items by blockIdx.x. The scatter of the new rows rides the qkv
// epilogue, so the grid barrier after phase 1 orders every row's scatter
// before any copy (pages may be shared between rows: prefix-cache pages,
// and the sink that inactive rows write). Every sum keeps K5's order: K5,
// K6 and K7 give a row the same bits for the same logical cache. The
// shared-memory footprint (two slots of L hd values) caps the context:
// fusable_paged accepts L <= 432 at hd 64 with f32 pools and L <= 864 with
// bf16 pools (page 16); K7 streams longer ones.
#include <cstdint>

#include "block_decode_common.cuh"

namespace cg = cooperative_groups;

namespace {

struct Args {
  mx::BlockArgs blk;
  const int* pos;  // [B]
  const int* bt;   // [B, maxp]
  void* kp;        // [NP + 1, H, ps, hd] f32 or bf16 (the kernel's C), in place
  void* vp;
  int ps, maxp, sink, depth;
  // swz: K pages come by 2-D tensor copies through tk (kp as [(NP + 1) H,
  // ps, hd] bf16, boxes of one page, 128-byte swizzle): bf16 pools at hd 64
  // with pages of whole 1 KB swizzle patterns (ps % 8 == 0)
  int swz;
  alignas(64) CUtensorMap tk;
};

template <class W, class X, class C>
__global__ void __launch_bounds__(mx::kThreads, mx::kBlockCtasPerSm)
    fused_block_decode_paged_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(1024) float smem[];
  cg::grid_group grid = cg::this_grid();
  // swizzled slots need their 1 KB swizzle patterns aligned
  if (sizeof(C) == 2 && a.swz && (mxh::smem_addr(smem) & 1023u)) __trap();
  // the qkv phase scatters the new K/V rows; its barrier orders them before
  // any page copy. The attention's operands are formed inside its phase, as
  // K7's.
  mx::block_step<W, X, C>(
      a.blk, smem, grid,
      mx::KVRows<C>{a.pos, a.bt, static_cast<C*>(a.kp), static_cast<C*>(a.vp), a.ps,
                       a.maxp, a.sink},
      [&] {
        const int L = a.ps * a.maxp;
        const mx::PagedSource<C> src{{static_cast<const C*>(a.kp), static_cast<const C*>(a.vp)},
                                     a.bt, &a.tk, nullptr, a.blk.H, a.blk.D / a.blk.H, a.ps,
                                     a.maxp, a.maxp, a.swz};
        mx::streamed_attention<C>(a.blk, a.pos, L, src, smem,
                                  mx::streamed_bars(smem, a.blk, L, a.depth, L, sizeof(C)),
                                  a.depth, L);
      });
}

template <class W, class X, class C>
struct Kernel {
  static void (*get())(Args) { return fused_block_decode_paged_kernel<W, X, C>; }
};

}  // namespace

// Slots of K6's ring at B rows (ops/fused_block_gemv._paged_depth): 4, 3 or
// 2 slots of L key rows, the most that fit (0: not even two fit).
extern "C" int mx_paged_depth(int B, int D, int H, int ps, int maxp, int itemsize) {
  if (B < 1 || H <= 0 || D % H || (D / H) % 8 || ps < 1 || maxp < 1 ||
      (itemsize != 2 && itemsize != 4))
    return 0;
  const int L = ps * maxp;
  for (int depth = 4; depth >= 2; --depth) {
    if (mx::streamed_smem(B, D, H, L, depth, L, itemsize) <= mx::kSmemLimit) return depth;
  }
  return 0;
}

// Dynamic shared memory of K6 in bytes at B rows (0 if the shape cannot
// run): the staged activation tile (block_rows(B, D) rows), or the gathered
// K and V slots (mx_paged_depth of them, L hd values each, itemsize bytes a
// value), q, the score row of L rounded up to 4, the float4 P.V reduction
// scratch and the item order, whichever is larger; then the mbarriers
// (ops/fused_block_gemv._paged_smem).
extern "C" long long mx_paged_smem(int B, int D, int H, int ps, int maxp, int itemsize) {
  const int depth = mx_paged_depth(B, D, H, ps, maxp, itemsize);
  if (depth == 0) return 0;
  return mx::streamed_smem(B, D, H, ps * maxp, depth, ps * maxp, itemsize);
}

// bt [B, maxp] int32; pools [sink + 1, H, ps, D / H], bf16 where cache_bf16,
// else f32, 16-byte aligned; x bf16 where x_bf16, else f32; scratch 9 * B * D
// f32.
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
  const int itemsize = cache_bf16 ? 2 : 4;
  a.depth = mx_paged_depth(B, D, H, ps, maxp, itemsize);
  a.swz = cache_bf16 && D / H == 64 && ps % 8 == 0 && ps <= 256 &&
          mx::bf16_cache_map(&a.tk, kp, (sink + 1) * H, ps, ps);
  if ((static_cast<long long>(ps) * (D / H) * itemsize) % 16 ||
      reinterpret_cast<uintptr_t>(kp) % 16 || reinterpret_cast<uintptr_t>(vp) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);  // TMA needs 16-byte slabs
  }
  const size_t smem = static_cast<size_t>(mx_paged_smem(B, D, H, ps, maxp, itemsize));
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  return mx::launch_block(mx::pick_block_kernel<Kernel>(a, x_bf16, cache_bf16), a, smem, stream);
}
