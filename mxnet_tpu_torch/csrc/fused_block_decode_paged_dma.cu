// K7: K6 with the pages STREAMED: one GPT block's whole T = 1 decode step
// over the paged KV pools in ONE cooperative launch, where each (row,
// head)'s K and V pages pass through a ring of `depth` shared-memory slots
// filled by TMA bulk copies, so the context length is not capped by
// holding [L, hd] K and V in shared memory.
//   LN1 -> qkv GEMV (epilogue scatters the new K/V row through the block
//   table) -> per (row, head): pass 1 streams K pages and writes the score
//   row, softmax, pass 2 streams V pages for P.V -> out GEMV + residual ->
//   LN2 -> fc GEMV + tanh-GeLU -> proj GEMV + residual.
// The pools [NP + 1, H, ps, hd] (page NP = the sink) are updated IN PLACE.
//
// Replaces the TPU kernel mxnet_tpu/ops/fused_block_gemv.py:
// _pallas_block_decode_paged_dma (pl.pallas_call at fused_block_gemv.py:1048),
// reached through fused_block_decode_paged (:1140).
//
// Bound: the weight bytes (int8: 12 D^2, 7.1 MB per GPT-2-small block; int4:
// 6 D^2 + 12 D^2 / 128 * 4, 3.8 MB) plus
// the K/V rows the step attends over (sum_b (pos_b + 1) * H * hd * itemsize
// bytes, K and V) plus the new rows (2 * B * D * itemsize bytes), at 3.35
// TB/s. At L 1024 the attended rows dominate (bf16 pools halve them).
//
// Design against that bound: the weight phases are K5's
// (block_decode_common.cuh). The TPU kernel left the pools in HBM and
// double-buffered per-page async copies into `depth` VMEM slots; here one
// thread of the CTA starts, per page of a slot, a 1-D TMA bulk copy
// (cp.async.bulk, ps * hd * itemsize contiguous bytes: 4 KB of f32 or 2 KB
// of bf16 at ps 16, hd 64) that completes on the slot's mbarrier. Slots
// hold the pool's dtype (a copy moves bytes, it cannot convert); the dots
// widen each bf16 word to f32 after the wait. A slot holds 1024 / itemsize
// key rows (tp = that / ps pages): one f32 row a thread, two bf16 rows, the
// same 64 KB at hd 64; and the next slot's copies are in flight while the
// current slot's dot products run. Only pages 0 .. pos / ps are copied, so
// each attended row is read once. Pass 1 keeps K5's f32 score row of L in
// shared memory (4 KB at L 1024), pass 2 visits rows in K5's group order:
// every sum keeps K5's order, so K5, K6 and K7 give a row the same bits.
// The new rows are scattered by the qkv epilogue before the grid barrier,
// so every row's scatter lands before any page is copied: plain stores, not
// copies.
//
// Redesigned for Hopper after splitting the first design's device time by
// probe builds (tools/head_block_compare.py --probes, H100 at B 8, L 1024:
// weight phases about 57 us, attention 31, grid barriers 5 of 93): the
// weight phases are block_decode_common.cuh's one-loop design; pass 1 reads
// a row's words `tid % 8` steps late (dot_row_lagged), which keeps the
// dot's order and removes its 8-way bank conflicts; and the launch
// takes one CTA an SM (two (row, head) items on one SM shared its copies
// and bank bandwidth: the bf16 ring, small enough for two CTAs an SM, was
// slower than the f32 one). A deeper ring (3, 4) and an L2 prefetch of the
// pages and weights at launch measured no gain and were left out.
//
// The attention code is block_decode_common.cuh's streamed_attention, over
// PagedSource copies; K5 and K6 run the same code over their own sources.
//
// Copy ledger (ops/int8_gemv.record_dma): per launch 2 * H * sum_b
// (min(pos_b, L - 1) / ps + 1) page copies (a K and a V copy per attended
// page of every (row, head)), each of ps * hd * itemsize bytes, and every
// copy is waited for. With a non-null `counters` the kernel adds the copies it
// started to counters[0] and those it waited for to counters[1].
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
  int* counters;   // [2] copies started, copies waited; may be null
  int ps, maxp, sink, depth, tp;
  // swz: K pages come by 2-D tensor copies through tk (kp as [(NP + 1) H,
  // ps, hd] bf16, boxes of one page, 128-byte swizzle): bf16 pools at hd 64
  // with pages of whole 1 KB swizzle patterns (ps % 8 == 0)
  int swz;
  alignas(64) CUtensorMap tk;
};

template <class W, class X, class C>
__global__ void __launch_bounds__(mx::kThreads, mx::kBlockCtasPerSm)
    fused_block_decode_paged_dma_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(1024) float smem[];
  cg::grid_group grid = cg::this_grid();
  // swizzled slots need their 1 KB swizzle patterns aligned
  if (sizeof(C) == 2 && a.swz && (mxh::smem_addr(smem) & 1023u)) __trap();
  // the qkv phase scatters the new K/V rows; its barrier orders them before
  // any page copy. The attention's operands are formed inside its phase
  // (from the parameter space), so none of them stays live in registers
  // across the weight phases.
  mx::block_step<W, X, C>(
      a.blk, smem, grid,
      mx::KVRows<C>{a.pos, a.bt, static_cast<C*>(a.kp), static_cast<C*>(a.vp), a.ps,
                       a.maxp, a.sink},
      [&] {
        const int L = a.ps * a.maxp, rows = a.tp * a.ps;
        const mx::PagedSource<C> src{{static_cast<const C*>(a.kp), static_cast<const C*>(a.vp)},
                                     a.bt, &a.tk, a.counters, a.blk.H, a.blk.D / a.blk.H, a.ps,
                                     a.maxp, a.tp, a.swz};
        mx::streamed_attention<C>(a.blk, a.pos, L, src, smem,
                                  mx::streamed_bars(smem, a.blk, L, a.depth, rows, sizeof(C)),
                                  a.depth, rows);
      });
}

template <class W, class X, class C>
struct Kernel {
  static void (*get())(Args) { return fused_block_decode_paged_dma_kernel<W, X, C>; }
};

}  // namespace

// Pages per ring slot (ops/fused_block_gemv._dma_tile_pages): 1024 /
// itemsize key rows (one f32 row a thread, two bf16 rows: a copy's latency,
// not its bytes, bounds a slot, so bf16 slots hold twice the rows), fewer
// while the ring does not fit.
extern "C" int mx_paged_dma_tile_pages(int D, int H, int ps, int maxp, int depth, int itemsize) {
  const int rows = mx::kThreads * 4 / itemsize;
  int tp = rows / ps > 1 ? rows / ps : 1;
  while (tp > 1 && mx::streamed_smem(1, D, H, ps * maxp, depth, tp * ps, itemsize) >
                        mx::kSmemLimit)
    --tp;
  return tp;
}

// Dynamic shared memory of K7 in bytes at B rows (0 if the shape cannot
// run): the staged activation tile (block_rows(B, D) rows), or the ring,
// q, the score row of L rounded up to 4, the float4 P.V reduction scratch
// and the item order, whichever is larger; then one 8-byte mbarrier per
// slot (ops/fused_block_gemv._paged_dma_smem).
extern "C" long long mx_paged_dma_smem(int B, int D, int H, int ps, int maxp, int depth,
                                       int itemsize) {
  if (B < 1 || H <= 0 || D % H || (D / H) % 8 || ps < 1 || maxp < 1 || depth < 1 ||
      (itemsize != 2 && itemsize != 4))
    return 0;
  return mx::streamed_smem(B, D, H, ps * maxp, depth,
                           mx_paged_dma_tile_pages(D, H, ps, maxp, depth, itemsize) * ps,
                           itemsize);
}

// bt [B, maxp] int32; pools [sink + 1, H, ps, D / H], bf16 where cache_bf16,
// else f32, 16-byte aligned; x bf16 where x_bf16, else f32; scratch 9 * B *
// D f32; counters null or [2] int32.
extern "C" int mx_fused_block_decode_paged_dma(
    const void* x, const void* pos, const void* bt, const void* w_qkv, const void* s_qkv,
    const void* b_qkv, const void* w_out, const void* s_out, const void* b_out,
    const void* w_fc, const void* s_fc, const void* b_fc, const void* w_proj,
    const void* s_proj, const void* b_proj, const void* g1, const void* be1, const void* g2,
    const void* be2, void* kp, void* vp, void* scratch, void* out, void* counters, int B,
    int D, int H, int ps, int maxp, int sink, int depth, int block, int block4, int x_bf16,
    int cache_bf16, float eps, void* stream) {
  Args a;
  mx::set_block_args(a.blk, x, w_qkv, s_qkv, b_qkv, w_out, s_out, b_out, w_fc, s_fc, b_fc,
                     w_proj, s_proj, b_proj, g1, be1, g2, be2, scratch, out, B, D, H, block,
                     block4, eps);
  a.pos = static_cast<const int*>(pos);
  a.bt = static_cast<const int*>(bt);
  a.kp = kp;
  a.vp = vp;
  a.counters = static_cast<int*>(counters);
  a.ps = ps;
  a.maxp = maxp;
  a.sink = sink;
  a.depth = depth;
  const int itemsize = cache_bf16 ? 2 : 4;
  a.tp = mx_paged_dma_tile_pages(D, H, ps, maxp, depth, itemsize);
  a.swz = cache_bf16 && D / H == 64 && ps % 8 == 0 && ps <= 256 &&
          mx::bf16_cache_map(&a.tk, kp, (sink + 1) * H, ps, ps);
  if ((static_cast<long long>(ps) * (D / H) * itemsize) % 16 ||
      reinterpret_cast<uintptr_t>(kp) % 16 || reinterpret_cast<uintptr_t>(vp) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);  // TMA needs 16-byte slabs
  }
  const size_t smem = static_cast<size_t>(mx_paged_dma_smem(B, D, H, ps, maxp, depth, itemsize));
  if (smem == 0 || smem > static_cast<size_t>(mx::kSmemLimit)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return mx::launch_block(mx::pick_block_kernel<Kernel>(a, x_bf16, cache_bf16), a, smem, stream);
}
