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
// a row's words `tid % 8` steps late (dot_row_lagged), which keeps
// dot_row's order and removes its 8-way bank conflicts; and the launch
// takes one CTA an SM (two (row, head) items on one SM shared its copies
// and bank bandwidth: the bf16 ring, small enough for two CTAs an SM, was
// slower than the f32 one). A deeper ring (3, 4) and an L2 prefetch of the
// pages and weights at launch measured no gain and were left out.
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
  mxh::mbar_expect(bar, page_bytes * n);
  const bool tensor = sizeof(C) == 2 && a.swz && i < st.ntile;  // a swizzled K slot
  for (int k = 0; k < n; ++k) {
    const int page = st.table[first + k];
    if constexpr (sizeof(C) == 2) {
      if (tensor) {
        mxh::tma_load_3d(slot + static_cast<size_t>(k) * a.ps * hd, &a.tk, bar, 0, 0,
                         page * a.blk.H + st.h);
        continue;
      }
    }
    mx::warp::bulk_copy(slot + static_cast<size_t>(k) * a.ps * hd,
              pool + (static_cast<size_t>(page) * a.blk.H + st.h) * a.ps * hd, page_bytes, bar);
  }
  if (a.counters != nullptr) atomicAdd(a.counters, n);
}

// q . k over one head row in ascending order (dot_row's FMAs, in its
// order), with this thread's 16-byte loads `lag` steps late. A row of the
// ring is hd * itemsize bytes (256 or 128 at hd 64, a multiple of 128): in
// dot_row's order the 8 threads of a load phase (8 rows) would all read
// the same 16-byte bank group, an 8-way conflict on every load. With lag =
// tid % 8 they read 8 different groups. f32: a load is one word (four
// values); bf16: two words (eight values), and q is staged as its even
// words, then its odd ones (q_word), so that the q words of a step are 8
// different groups too.
__device__ __forceinline__ float dot_row_lagged(const float4* q4, const float* k, int hd4,
                                                int lag) {
  float s = 0.f;
  for (int t = 0; t < hd4 + 7; ++t) {
    const int e = t - lag;
    if (e >= 0 && e < hd4) {
      const float4 kv = reinterpret_cast<const float4*>(k)[e];
      const float4 qv = q4[e];
      s = fmaf(qv.x, kv.x, s);
      s = fmaf(qv.y, kv.y, s);
      s = fmaf(qv.z, kv.z, s);
      s = fmaf(qv.w, kv.w, s);
    }
  }
  return s;
}
__device__ __forceinline__ float dot_row_lagged(const float4* q4, const mx::bf16* k, int hd4,
                                                int lag) {
  float s = 0.f;
  const int units = hd4 >> 1;
  for (int t = 0; t < units + 7; ++t) {
    const int u = t - lag;
    if (u >= 0 && u < units) {
      const uint4 v = reinterpret_cast<const uint4*>(k)[u];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 kv = mx::widen4(h ? make_uint2(v.z, v.w) : make_uint2(v.x, v.y));
        const float4 qv = q4[h * (hd4 >> 1) + u];
        s = fmaf(qv.x, kv.x, s);
        s = fmaf(qv.y, kv.y, s);
        s = fmaf(qv.z, kv.z, s);
        s = fmaf(qv.w, kv.w, s);
      }
    }
  }
  return s;
}

// q . k over one bf16 key row of 64 values that a tensor copy with the
// 128-byte swizzle wrote (its 16-byte chunk u at u ^ sw, sw = the row's
// index in its 1 KB swizzle pattern), in ascending order: the 8 rows of a
// load phase read 8 different bank groups with no lag; every thread reads
// the same q word (a broadcast).
__device__ __forceinline__ float dot_row_swizzled(const float4* q4, const mx::bf16* k, int sw) {
  float s = 0.f;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const uint4 v = reinterpret_cast<const uint4*>(k)[u ^ sw];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 kv = mx::widen4(h ? make_uint2(v.z, v.w) : make_uint2(v.x, v.y));
      const float4 qv = q4[2 * u + h];
      s = fmaf(qv.x, kv.x, s);
      s = fmaf(qv.y, kv.y, s);
      s = fmaf(qv.z, kv.z, s);
      s = fmaf(qv.w, kv.w, s);
    }
  }
  return s;
}

// The score of key row jj of a slot (q . k, not yet scaled).
template <class C>
__device__ __forceinline__ float score_row(const Args& a, const float4* q4, const C* k, int jj,
                                           int hd4) {
  if constexpr (sizeof(C) == 2) {
    if (a.swz) return dot_row_swizzled(q4, k, jj & 7);
  }
  return dot_row_lagged(q4, k, hd4, threadIdx.x & 7);
}

// Where q's float4 word w is staged: in order, or (bf16 rows read lagged)
// even words then odd ones (dot_row_lagged).
template <class C>
__device__ __forceinline__ int q_word(const Args& a, int w, int hd4) {
  return sizeof(C) == 2 && !a.swz ? (w & 1) * (hd4 >> 1) + (w >> 1) : w;
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
    for (int s = 0; s < depth; ++s) mxh::mbar_init(bars + s, 1);
    mxh::mbar_fence_init();
  }
  mxh::fence_proxy_async();  // the qkv phase staged activations in these bytes
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
    for (int d = tid; d < hd; d += mx::kThreads) {
      qs[4 * q_word<C>(a, d >> 2, hd4) + (d & 3)] = row[d];
    }
    __syncthreads();
    const float4* q4 = reinterpret_cast<const float4*>(qs);
    float sum = 0.f;
    float4 part = make_float4(0.f, 0.f, 0.f, 0.f);
    const int g = tid / hd4, d4 = tid - g * hd4;
    for (int i = 0; i < loads; ++i, ++seq) {
      const int slot_i = seq % depth;
      C* slot = ring + static_cast<size_t>(slot_i) * rows * hd;
      mxh::mbar_wait(bars + slot_i, (seq / depth) & 1u);
      const int j0 = (i % st.ntile) * rows;  // first key row of the slot
      const int jn = min(j0 + rows, pa + 1);
      if (i < st.ntile) {
        // pass 1: scores of the slot's key rows
        for (int j = j0 + tid; j < jn; j += mx::kThreads) {
          sc[j] = score_row(a, q4, slot + static_cast<size_t>(j - j0) * hd, j - j0, hd4) * scale;
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
      mxh::fence_proxy_async();
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
__global__ void __launch_bounds__(mx::kThreads)
    fused_block_decode_paged_dma_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(1024) float smem[];
  cg::grid_group grid = cg::this_grid();
  // swizzled slots need their 1 KB swizzle patterns aligned
  if (sizeof(C) == 2 && a.swz && (mxh::smem_addr(smem) & 1023u)) __trap();
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      reinterpret_cast<char*>(smem) +
      layout_bytes(a.blk.D, a.blk.H, a.ps, a.maxp, a.depth, a.tp, sizeof(C)));
  // the qkv phase scatters the new K/V rows; its barrier orders them before
  // any page copy
  mx::block_step<W, X, C>(a.blk, smem, grid,
                          mx::PagedRows<C>{a.pos, a.bt, static_cast<C*>(a.kp),
                                           static_cast<C*>(a.vp), a.ps, a.maxp, a.sink},
                          [&] { attention<C>(a, smem, bars); });
}

template <class W, class X, class C>
struct Kernel {
  static void (*get())(Args) { return fused_block_decode_paged_dma_kernel<W, X, C>; }
};

long long smem_bytes(int D, int H, int ps, int maxp, int depth, int tp, int itemsize) {
  return layout_bytes(D, H, ps, maxp, depth, tp, itemsize) + 8LL * depth;
}

constexpr long long kSmemLimit = 232448;  // one CTA's shared memory on Hopper

// The tensor map of a bf16 K pool [mats, ps, 64] for one-page boxes with the
// 128-byte swizzle, encoded once per (pool, shape) and kept (a decode step
// launches K7 once per layer, on the layer's own pool).
bool key_map(CUtensorMap* map, const void* kp, int mats, int ps) {
  struct Entry {
    const void* kp;
    int mats, ps;
    CUtensorMap map;
  };
  static std::mutex mu;
  static std::vector<Entry> cache;
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& e : cache) {
    if (e.kp == kp && e.mats == mats && e.ps == ps) {
      *map = e.map;
      return true;
    }
  }
  if (!mxh::bf16_rows_map(map, kp, mats, ps, 64, ps)) return false;
  if (cache.size() >= 256) cache.clear();
  cache.push_back(Entry{kp, mats, ps, *map});
  return true;
}

}  // namespace

// Pages per ring slot (ops/fused_block_gemv._dma_tile_pages): 1024 /
// itemsize key rows (one f32 row a thread, two bf16 rows: a copy's latency,
// not its bytes, bounds a slot, so bf16 slots hold twice the rows), fewer
// while the ring does not fit.
extern "C" int mx_paged_dma_tile_pages(int D, int H, int ps, int maxp, int depth, int itemsize) {
  const int rows = mx::kThreads * 4 / itemsize;
  int tp = rows / ps > 1 ? rows / ps : 1;
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
  a.swz = cache_bf16 && D / H == 64 && ps % 8 == 0 && ps <= 256 &&
          key_map(&a.tk, kp, (sink + 1) * H, ps);
  if ((static_cast<long long>(ps) * (D / H) * itemsize) % 16 ||
      reinterpret_cast<uintptr_t>(kp) % 16 || reinterpret_cast<uintptr_t>(vp) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);  // TMA needs 16-byte slabs
  }
  const size_t smem = static_cast<size_t>(mx_paged_dma_smem(D, H, ps, maxp, depth, itemsize));
  if (smem == 0 || smem > static_cast<size_t>(kSmemLimit)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // one CTA an SM: two (row, head) items streaming on one SM share its
  // copy and shared-memory bandwidth while other SMs idle
  return mx::launch_block(mx::pick_block_kernel<Kernel>(a, x_bf16, cache_bf16), a, smem, stream,
                          1);
}
