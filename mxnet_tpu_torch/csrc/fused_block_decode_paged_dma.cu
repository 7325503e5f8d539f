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
// widen each bf16 word to f32 after the wait. A slot holds tp = 256 / ps pages, one
// key row per thread, and the next slot's copies are in flight while the
// current slot's dot products run. Only pages 0 .. pos / ps are copied, so
// each attended row is read once. Pass 1 keeps K5's f32 score row of L in
// shared memory (4 KB at L 1024), pass 2 visits rows in K5's group order:
// every sum keeps K5's order, so K5, K6 and K7 give a row the same bits.
// The new rows are scattered by the qkv epilogue before the grid barrier,
// so every row's scatter lands before any page is copied: plain stores, not
// copies.
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
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

// Arm the barrier for `bytes` of incoming copies (this arrival completes
// the phase together with those bytes).
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the completion of the barrier's phase with this parity. Traps
// (a launch error, never a hang) if it has not completed after ~2^34
// cycles.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  const long long t0 = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1LL << 34)) __trap();
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Order this thread's generic-proxy shared-memory accesses before later
// async-proxy (TMA) writes to the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The copies of one (row, head): load i < 2 * ntile is pass i / ntile (0: K,
// 1: V) of tile i % ntile, pages [t * tp, min((t + 1) * tp, np)).
template <class C>
struct Stream {
  const C* pool[2];
  const int* table;
  int h, np, ntile;
};

// Thread 0: arm slot `slot` and start the page copies of load i.
template <class C>
__device__ void start_load(const Args& a, const Stream<C>& st, int i, C* slot, uint64_t* bar) {
  const int hd = a.blk.D / a.blk.H;
  const uint32_t page_bytes = static_cast<uint32_t>(a.ps) * hd * sizeof(C);
  const int t = i % st.ntile;
  const C* pool = st.pool[i / st.ntile];
  const int first = t * a.tp;
  const int n = min(a.tp, st.np - first);
  mbar_expect(bar, page_bytes * n);
  for (int k = 0; k < n; ++k) {
    const int page = st.table[first + k];
    bulk_copy(slot + static_cast<size_t>(k) * a.ps * hd,
              pool + (static_cast<size_t>(page) * a.blk.H + st.h) * a.ps * hd, page_bytes, bar);
  }
  if (a.counters != nullptr) atomicAdd(a.counters, n);
}

// One CTA per (row, head): stream the row's pages 0 .. pa / ps (pa =
// min(pos, L - 1)) of K then V through the ring, attend rows [0, pa], write
// the head's context. `seq` counts the loads this CTA has consumed: load n
// uses slot n % depth, the (n / depth)-th completion of that slot's
// barrier.
template <class C>
__device__ void attention(const Args& a, float* smem, uint64_t* bars) {
  const int D = a.blk.D, H = a.blk.H;
  const int hd = D / H, hd4 = hd >> 2;
  const int ps = a.ps, L = a.maxp * ps, depth = a.depth;
  const int rows = a.tp * ps;              // key rows per slot
  C* ring = reinterpret_cast<C*>(smem);    // [depth][rows * hd]
  float* qs = reinterpret_cast<float*>(ring + static_cast<size_t>(depth) * rows * hd);  // [hd]
  float* sc = qs + hd;                     // [L rounded up to 4]
  float* red = sc + ((L + 3) & ~3);        // [4 * kThreads]
  const int tid = threadIdx.x;
  const float scale = 1.f / sqrtf(static_cast<float>(hd));
  const int groups = mx::kThreads / hd4;
  unsigned seq = 0;
  if (tid == 0) {
    for (int s = 0; s < depth; ++s) mbar_init(bars + s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fence_proxy_async();  // the qkv phase staged activations in these bytes
  __syncthreads();
  for (int item = blockIdx.x; item < a.blk.B * H; item += gridDim.x) {
    const int b = item / H, h = item % H;
    const int pa = min(max(a.pos[b], 0), L - 1);
    Stream<C> st;
    st.pool[0] = static_cast<const C*>(a.kp);
    st.pool[1] = static_cast<const C*>(a.vp);
    st.table = a.bt + static_cast<size_t>(b) * a.maxp;
    st.h = h;
    st.np = pa / ps + 1;
    st.ntile = (st.np + a.tp - 1) / a.tp;
    const int loads = 2 * st.ntile;
    if (tid == 0) {
      for (int i = 0; i < depth && i < loads; ++i) {
        const unsigned n = seq + i;
        start_load(a, st, i, ring + static_cast<size_t>(n % depth) * rows * hd, bars + n % depth);
      }
    }
    const float* row = a.blk.qkv + static_cast<size_t>(b) * 3 * D + h * hd;
    for (int d = tid; d < hd; d += mx::kThreads) qs[d] = row[d];
    __syncthreads();
    const float4* q4 = reinterpret_cast<const float4*>(qs);
    float sum = 0.f;
    float4 part = make_float4(0.f, 0.f, 0.f, 0.f);
    const int g = tid / hd4, d4 = tid - g * hd4;
    for (int i = 0; i < loads; ++i, ++seq) {
      const int slot_i = seq % depth;
      C* slot = ring + static_cast<size_t>(slot_i) * rows * hd;
      mbar_wait(bars + slot_i, (seq / depth) & 1u);
      const int j0 = (i % st.ntile) * rows;  // first key row of the slot
      const int jn = min(j0 + rows, pa + 1);
      if (i < st.ntile) {
        // pass 1: scores of the slot's key rows
        for (int j = j0 + tid; j < jn; j += mx::kThreads) {
          sc[j] = mx::dot_row(q4, slot + static_cast<size_t>(j - j0) * hd, hd4) * scale;
        }
      } else if (g < groups) {
        // pass 2: group g takes rows j = g (mod groups), ascending
        for (int j = j0 + ((g - j0 % groups) + groups) % groups; j < jn; j += groups) {
          mx::fma4(part, sc[j] / sum, mx::load4(slot + static_cast<size_t>(j - j0) * hd, d4));
        }
      }
      if (tid == 0 && a.counters != nullptr) {
        atomicAdd(a.counters + 1, min(a.tp, st.np - (i % st.ntile) * a.tp));
      }
      fence_proxy_async();
      __syncthreads();  // the slot is read: it may be refilled
      if (tid == 0 && i + depth < loads) {
        start_load(a, st, i + depth, slot, bars + slot_i);
      }
      if (i == st.ntile - 1) sum = mx::softmax_scores(sc, pa, red);
    }
    mx::store_head_context(part, red, groups, hd, a.blk.ctx + static_cast<size_t>(b) * D + h * hd);
  }
}

// Bytes of the larger of the staged activation tile and the attention
// layout (the ring of `depth` slots of tp pages, itemsize bytes a value,
// then q, the score row of L rounded up to 4 and the float4 P.V scratch);
// the mbarriers sit past it, where no phase writes.
__host__ __device__ long long layout_bytes(int D, int H, int ps, int maxp, int depth, int tp,
                                           int itemsize) {
  const long long hd = D / H, L = static_cast<long long>(ps) * maxp;
  const long long tile = 4 * mx::block_tile_floats(D);
  const long long attn = static_cast<long long>(depth) * tp * ps * hd * itemsize +
                         4 * (hd + ((L + 3) & ~3LL) + 4 * mx::kThreads);
  return tile > attn ? tile : attn;
}

template <class W, class X, class C>
__global__ void __launch_bounds__(mx::kThreads) fused_block_decode_paged_dma_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  mx::block_phase_qkv<W, X>(
      a.blk, smem,
      mx::PagedQkvEpi<C>{a.blk.qkv, a.pos, a.bt, static_cast<C*>(a.kp), static_cast<C*>(a.vp),
                         a.blk.D, a.blk.H, a.ps, a.maxp, a.sink});
  grid.sync();  // every row's K/V scatter lands before any page copy
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      reinterpret_cast<char*>(smem) +
      layout_bytes(a.blk.D, a.blk.H, a.ps, a.maxp, a.depth, a.tp, sizeof(C)));
  attention<C>(a, smem, bars);
  grid.sync();
  mx::block_phases_out_mlp<W, X>(a.blk, smem, grid);
}

template <class W, class X, class C>
struct Kernel {
  static void (*get())(Args) { return fused_block_decode_paged_dma_kernel<W, X, C>; }
};

long long smem_bytes(int D, int H, int ps, int maxp, int depth, int tp, int itemsize) {
  return layout_bytes(D, H, ps, maxp, depth, tp, itemsize) + 8LL * depth;
}

constexpr long long kSmemLimit = 232448;  // one CTA's shared memory on Hopper

}  // namespace

// Pages per ring slot (ops/fused_block_gemv._dma_tile_pages): 256 / ps, one
// key row per thread, fewer while the ring does not fit.
extern "C" int mx_paged_dma_tile_pages(int D, int H, int ps, int maxp, int depth, int itemsize) {
  int tp = mx::kThreads / ps > 1 ? mx::kThreads / ps : 1;
  while (tp > 1 && smem_bytes(D, H, ps, maxp, depth, tp, itemsize) > kSmemLimit) --tp;
  return tp;
}

// Dynamic shared memory of K7 in bytes (0 if the shape cannot run): the
// staged activation tile, or the ring, q, the score row of L rounded up to
// 4 and the float4 P.V reduction scratch, whichever is larger; then one
// 8-byte mbarrier per slot (ops/fused_block_gemv._paged_dma_smem).
extern "C" long long mx_paged_dma_smem(int D, int H, int ps, int maxp, int depth, int itemsize) {
  if (H <= 0 || D % H || (D / H) % 8 || ps < 1 || maxp < 1 || depth < 1 ||
      (itemsize != 2 && itemsize != 4))
    return 0;
  return smem_bytes(D, H, ps, maxp, depth,
                    mx_paged_dma_tile_pages(D, H, ps, maxp, depth, itemsize), itemsize);
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
  if ((static_cast<long long>(ps) * (D / H) * itemsize) % 16 ||
      reinterpret_cast<uintptr_t>(kp) % 16 || reinterpret_cast<uintptr_t>(vp) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);  // TMA needs 16-byte slabs
  }
  const size_t smem = static_cast<size_t>(mx_paged_dma_smem(D, H, ps, maxp, depth, itemsize));
  if (smem == 0 || smem > static_cast<size_t>(kSmemLimit)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return mx::launch_block(mx::pick_block_kernel<Kernel>(a, x_bf16, cache_bf16), a, smem, stream);
}
