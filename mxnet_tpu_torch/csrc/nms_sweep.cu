// Greedy NMS sweep over a precomputed decision matrix, one CTA an image.
//
// Replaces no TPU kernel. The JAX package ends box_nms and
// multibox_detection (mxnet_tpu/ops/contrib.py:227 and :386) with a
// lax.fori_loop over every row, n dependent steps that XLA runs as one
// device loop; eager PyTorch would spend a few launches a row on it. This
// kernel is the whole loop in one launch.
//
// Input: dec bool [B, m, n], m <= n (row i suppresses row j: IoU above
// the threshold, j > i, the class mask applied; built by the plain
// version's own torch ops, ops/contrib.py nms_decisions; rows past m, past
// a top-k, suppress nothing) and valid bool [B, n].
// Output: keep bool [B, n], bit for bit the plain sweep's
//     keep &= ~(dec[i] & keep[i] & valid[i])  for i = 0 .. m-1;  keep &= valid.
//
// Design: the keep and valid bits live in shared memory as 32-bit words.
// The CTA walks the words; within a word it takes the lowest row that is
// still kept and valid (every thread reads the same shared words after a
// barrier, so control flow is uniform), and its warps stream that row of
// dec, four coalesced 32-byte loads a warp in flight at once, fold each
// into a word with __ballot_sync and clear it from the keep word that
// warp owns.
// A row that is suppressed or invalid is never read: only kept rows cost
// a pass over global memory.
//
// Bound: the bytes of the rows read (each kept row's tail after i) plus
// valid and keep; the work is tiny and the sweep is serial, so the kernel
// is bounded by the latency of one global read and one barrier per kept
// row, not by the card's bandwidth.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 4;   // 32-byte chunks of a row a warp loads at once

__global__ void nms_sweep_kernel(const uint8_t* __restrict__ dec,
                                 const uint8_t* __restrict__ valid,
                                 uint8_t* __restrict__ keep, int m, int n) {
    extern __shared__ uint32_t smem[];
    const int words = (n + 31) >> 5;
    uint32_t* keepw = smem;
    uint32_t* validw = smem + words;
    const int b = blockIdx.x;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    const uint8_t* vrow = valid + (size_t)b * n;

    // valid bits by ballot, keep bits all ones below n
    for (int j0 = warp * 32; j0 < words * 32; j0 += nwarps * 32) {
        int j = j0 + lane;
        uint32_t v = __ballot_sync(0xffffffffu, j < n && vrow[j] != 0);
        uint32_t k = __ballot_sync(0xffffffffu, j < n);
        if (lane == 0) {
            validw[j0 >> 5] = v;
            keepw[j0 >> 5] = k;
        }
    }
    __syncthreads();

    const uint8_t* base = dec + (size_t)b * m * n;
    const int row_words = (m + 31) >> 5;
    for (int w = 0; w < row_words; ++w) {
        // rows of this word below m
        const int left = m - (w << 5);
        const uint32_t rows = left >= 32 ? 0xffffffffu : ((1u << left) - 1u);
        uint32_t cand = keepw[w] & validw[w] & rows;
        while (cand) {
            const int bit = __ffs(cand) - 1;
            const int i = (w << 5) + bit;
            const uint8_t* row = base + (size_t)i * n;
            // rows after i: from the word of i + 1 on, each warp its own
            // CHUNK consecutive words an iteration, every load issued
            // before the first ballot
            const int first = (i + 1) & ~31;
            for (int j0 = first + warp * 32 * CHUNK; j0 < n; j0 += nwarps * 32 * CHUNK) {
                bool d[CHUNK];
#pragma unroll
                for (int c = 0; c < CHUNK; ++c) {
                    const int j = j0 + c * 32 + lane;
                    d[c] = j > i && j < n && row[j] != 0;
                }
#pragma unroll
                for (int c = 0; c < CHUNK; ++c) {
                    const uint32_t s = __ballot_sync(0xffffffffu, d[c]);
                    const int w2 = (j0 >> 5) + c;
                    if (lane == 0 && s) keepw[w2] &= ~s;
                }
            }
            __syncthreads();
            const uint32_t above = bit == 31 ? 0u : (0xffffffffu << (bit + 1));
            cand = keepw[w] & validw[w] & rows & above;
            __syncthreads();   // every thread has read keepw[w] before the next row writes
        }
    }

    uint8_t* krow = keep + (size_t)b * n;
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
        krow[j] = (uint8_t)((keepw[j >> 5] & validw[j >> 5]) >> (j & 31) & 1u);
    }
}

}  // namespace

extern "C" int mx_nms_sweep(const void* dec, const void* valid, void* keep, int B, int m,
                            int n, int threads, void* stream) {
    const int words = (n + 31) >> 5;
    const size_t smem = (size_t)words * 2 * sizeof(uint32_t);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(nms_sweep_kernel,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    nms_sweep_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)dec, (const uint8_t*)valid, (uint8_t*)keep, m, n);
    return (int)cudaGetLastError();
}
