"""Block-level fused decode and the fused LM-head sampler (counterpart of
``mxnet_tpu/ops/fused_block_gemv.py``, int8 and int4 weight lanes).

- :func:`pack_gpt_block` extracts one GPT block's frozen quantized weights:
  int8 tables with per-channel scales, or packed int4 tables (uint8 nibble
  pairs) with block scales. The table's dtype picks the lane everywhere
  below, and the launch kinds of the int4 lane carry an ``_int4`` suffix.
- :func:`fused_block_decode` runs one block's whole T=1 decode step: on a
  CUDA tensor as ONE cooperative launch of ``csrc/fused_block_decode.cu``
  (K5, each (row, head)'s cache slab streamed through a ring of
  shared-memory slots by TMA copies), on a CPU tensor as
  :func:`_reference_block_decode`, which replays
  the unfused LayerNorm -> QuantizedDense -> cached-attention op sequence.
  The caches are updated in place (the JAX function returns copies).
- :func:`fused_block_decode_paged` is the same step over the paged KV
  pools through a block table: ``csrc/fused_block_decode_paged.cu`` (K6,
  the rows' pages gathered into shared memory by TMA copies) where
  :func:`fusable_paged` accepts the context length, else
  ``csrc/fused_block_decode_paged_dma.cu`` (K7, pages streamed through a
  ring of shared-memory slots by TMA bulk copies) where
  :func:`fusable_paged_dma` accepts it; on a CPU tensor
  :func:`_reference_block_decode_paged` (the unfused op sequence with
  ``_paged_attention``). The pools are updated in place.
- :func:`fused_lm_head_sample` folds the tied quantized head GEMV into greedy or
  temperature sampling: ``csrc/lm_head_sample.cu`` (K8) on CUDA, and
  :func:`_reference_head_sample` on the CPU. Sampled rows draw Gumbel noise
  from :func:`_hash_uniform` of (request key bits, vocab lane), as the TPU
  kernel does; the JAX package's off-TPU path samples with
  ``jax.random.categorical`` instead, so unfiltered sampled tokens match
  JAX only against its kernel (interpret mode), never against its CPU
  fallback. A batch with any top-k/top-p row takes the reference's other
  branch on every device: head GEMV logits, then
  ``generation.sample_tokens``, which matches JAX's stream.

Element types: ``x`` is f32 or bf16 (block 0 of a bf16 model gets the
bf16 embedding sum) and the caches or pools f32 or bf16 (the model's
dtype); the output is f32. The kernels compute what the plain versions
compute: on bf16 x the LayerNorm rounds as ``npx.layer_norm`` does, and a
new K/V row is rounded once to the cache's dtype and read back from it.
f16 caches raise on the card. K8 takes f32 or bf16 h, f32 or bf16 logits
and an optional grammar mask.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import numpy_extension as npx
from ..base import MXNetError
from .int8_gemv import _deq_matmul, int4_chunks_fit, record_dma, record_lane, record_launch

__all__ = ["pack_gpt_block", "fused_block_decode", "fused_block_decode_paged",
           "fused_lm_head_sample", "fusable", "fusable_paged",
           "fusable_paged_dma", "VOCAB_LANE", "pad_vocab"]

# lane width the vocab dim is padded to (50257 -> 50304)
VOCAB_LANE = 128
# shared memory one CTA may use on Hopper (H100: 227 KB)
_SMEM_LIMIT = 232448
# kernel geometry of csrc/block_decode_common.cuh (kRowTile, kWideRowTile,
# kThreads)
_ROW_TILE = 8
_WIDE_ROW_TILE = 16
_THREADS = 256
# ring slots of the streamed paged kernel (the JAX knob fused_dma_depth)
_DMA_DEPTH = 2
# K5's ring: slots, and the step of its slot rows (its tensor-copy box)
_SLAB_DEPTH = 2
_BOX_ROWS = 16


def pad_vocab(n: int) -> int:
    """Smallest multiple of VOCAB_LANE >= n."""
    return -(-int(n) // VOCAB_LANE) * VOCAB_LANE


def _round4(n: int) -> int:
    return -(-int(n) // 4) * 4


def _tiles(B: int, D: int, heads: int, blocks=()) -> bool:
    """Tiling rules of the three block kernels: rows of whole 16-code
    chunks (D % 16: 16 bytes of int8, 8 bytes of int4) and whole heads with
    hd % 8 == 0 and hd <= 256 (one CTA per (row, head) covers the head dim
    in float4 words). The int4 lane (``blocks``: the scale blocks of qkv,
    out, fc and proj) also needs each chunk inside one scale block, and one
    block for the three K = D matrices (the kernels take one)."""
    if B < 1 or heads < 1 or D % 16 or D % heads:
        return False
    if blocks and not (len(set(blocks[:3])) == 1 and int4_chunks_fit(D, blocks[0])
                       and int4_chunks_fit(4 * D, blocks[3])):
        return False
    hd = D // heads
    return hd % 8 == 0 and hd <= _THREADS


def _block_rows(B: int, D: int) -> int:
    """Rows the block kernels' weight phases stage per pass
    (``block_rows``): 8, and past 8 rows 16 where that 4D-wide f32 tile
    fits (192 KB at D 768), so each weight matrix streams once for 16 rows."""
    wide = 4 * _WIDE_ROW_TILE * 4 * D <= _SMEM_LIMIT
    return _WIDE_ROW_TILE if B > _ROW_TILE and wide else _ROW_TILE


def _streamed_smem(D: int, heads: int, L: int, depth: int, rows: int, itemsize: int,
                   B: int = 1) -> int:
    """Dynamic shared memory of a block kernel with streamed attention
    (``streamed_smem``): the larger of the staged activation tile
    (:func:`_block_rows` rows of the 4D fc activations) and the attention
    layout (``depth`` ring slots of ``rows`` key rows in the cache's dtype,
    q, the f32 score row of L, the float4 P.V scratch and the item order),
    then one 8-byte mbarrier a slot."""
    hd = D // heads
    tile = 4 * _block_rows(B, D) * 4 * D
    attn = depth * rows * hd * itemsize + 4 * (hd + _round4(L) + 5 * _THREADS)
    return max(tile, attn) + 8 * depth


def _slab_rows(D: int, heads: int, L: int, itemsize: int = 4) -> int:
    """Key rows a ring slot of K5 holds (``mx_fused_block_slot_rows``):
    1024 // itemsize (K7's slot: 256 f32 or 512 bf16 rows), fewer by 16
    while the ring does not fit."""
    rows = _THREADS * 4 // itemsize
    while rows > _BOX_ROWS and _streamed_smem(D, heads, L, _SLAB_DEPTH, rows,
                                              itemsize) > _SMEM_LIMIT:
        rows -= _BOX_ROWS
    return rows


def _block_smem(D: int, heads: int, L: int, itemsize: int = 4, B: int = 1) -> int:
    """Dynamic shared memory of K5 at B rows (``mx_fused_block_smem``)."""
    return _streamed_smem(D, heads, L, _SLAB_DEPTH, _slab_rows(D, heads, L, itemsize),
                          itemsize, B)


def fusable(B: int, D: int, heads: int, L: int, blocks=(),
            cache_itemsize: int = 4) -> bool:
    """Shape gate of the Hopper block kernel: :func:`_tiles`, f32 or bf16
    caches (``cache_itemsize`` 4 or 2, as the JAX gate takes it), and
    :func:`_block_smem` within one CTA's 227 KB of shared memory: the
    larger of the staged activation tile (8 rows of the 4D fc activations,
    16 past 8 rows) and the attention layout (two ring slots of 1024 //
    itemsize key rows, one f32 score row of L, q, the reduction scratch and
    the item order); the caches stay in device memory and stream through
    the ring, so only the score row grows with L. It replaces the TPU
    kernel's VMEM budget gate, which would reject GPT-2 small at L =
    1024."""
    if not _tiles(B, D, heads, blocks) or cache_itemsize not in (2, 4):
        return False
    return _block_smem(D, heads, L, cache_itemsize, B) <= _SMEM_LIMIT


def _paged_depth(D: int, heads: int, L: int, itemsize: int = 4, B: int = 1) -> int:
    """Slots of K6's ring (``mx_paged_depth``): 4, 3 or 2 slots of the
    whole context (L key rows), the most that fit; 0 where two do not."""
    for depth in (4, 3, 2):
        if _streamed_smem(D, heads, L, depth, L, itemsize, B) <= _SMEM_LIMIT:
            return depth
    return 0


def _paged_smem(D: int, heads: int, L: int, itemsize: int = 4, B: int = 1) -> int:
    """Dynamic shared memory of K6 at B rows (``mx_paged_smem``): the
    staged activation tile, or :func:`_paged_depth` slots of the gathered
    [L, hd] K or V of one (row, head) in the pools' dtype (``itemsize``
    bytes a value), q, the score row, the reduction scratch and the item
    order, whichever is larger; then the mbarriers. Where two slots do not
    fit, the two-slot size (above the limit)."""
    depth = _paged_depth(D, heads, L, itemsize, B) or 2
    return _streamed_smem(D, heads, L, depth, L, itemsize, B)


def _dma_smem(D: int, heads: int, ps: int, L: int, depth: int, tp: int,
              itemsize: int = 4, B: int = 1) -> int:
    return _streamed_smem(D, heads, L, depth, tp * ps, itemsize, B)


def _dma_tile_pages(D: int, heads: int, ps: int, L: int, depth: int,
                    itemsize: int = 4) -> int:
    """Pages per ring slot of K7 (``mx_paged_dma_tile_pages``): 1024 //
    itemsize key rows (one f32 row a thread, two bf16 rows: 256 // ps or 512
    // ps pages), fewer while the ring does not fit."""
    tp = max(1, _THREADS * 4 // itemsize // ps)
    while tp > 1 and _dma_smem(D, heads, ps, L, depth, tp, itemsize) > _SMEM_LIMIT:
        tp -= 1
    return tp


def _paged_dma_smem(D: int, heads: int, ps: int, L: int, depth: int,
                    itemsize: int = 4, B: int = 1) -> int:
    """Dynamic shared memory of K7 at B rows (``mx_paged_dma_smem``): the
    staged activation tile, or ``depth`` ring slots of
    :func:`_dma_tile_pages` pages in the pools' dtype, q, the score row,
    the reduction scratch and the item order, whichever is larger; then
    one 8-byte mbarrier per slot."""
    return _dma_smem(D, heads, ps, L, depth,
                     _dma_tile_pages(D, heads, ps, L, depth, itemsize), itemsize, B)


def fusable_paged(B: int, D: int, heads: int, pool_pages: int,
                  page_size: int, max_pages: int, cache_itemsize: int = 4,
                  blocks=()):
    """Shape gate of K6, the gathered paged kernel, restated for Hopper:
    :func:`_tiles`, f32 or bf16 pools (``cache_itemsize`` 4 or 2), and two
    slots of the whole context within one CTA's 227 KB (:func:`_paged_depth`
    > 0): ``2*L*hd*itemsize + 4 * (L + hd + 5*256) + 16`` bytes at GPT-2
    widths, which accepts L <= 432 at hd 64 with f32 pools (page 16:
    max_len 256 or 384) and L <= 864 with bf16 pools (paged A's L 256
    takes K6 either way; paged B's L 1024 takes K7). It replaces the TPU's
    VMEM test on the whole pool; ``pool_pages`` does not enter it, because
    the pools stay in device memory."""
    if not _tiles(B, D, heads, blocks) or cache_itemsize not in (2, 4):
        return False
    return _paged_depth(D, heads, max_pages * page_size, cache_itemsize, B) > 0


def fusable_paged_dma(B: int, D: int, heads: int, pool_pages: int,
                      page_size: int, max_pages: int,
                      cache_itemsize: int = 4, depth: int = None, blocks=()):
    """Shape gate of K7, the streamed paged kernel: :func:`_tiles`, f32 or
    bf16 pools, 16-byte page slabs for the TMA bulk copies (``page_size *
    hd * itemsize % 16 == 0``), and :func:`_paged_dma_smem` within 227 KB.
    Neither the pool size nor ``2*L*hd`` enters it: only the score row of
    L grows with the context, which is the cap this variant removes."""
    if not _tiles(B, D, heads, blocks) or cache_itemsize not in (2, 4):
        return False
    depth = _DMA_DEPTH if depth is None else int(depth)
    if depth < 1 or (page_size * (D // heads) * cache_itemsize) % 16:
        return False
    L = max_pages * page_size
    return _paged_dma_smem(D, heads, page_size, L, depth, cache_itemsize, B) <= _SMEM_LIMIT


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

def pack_gpt_block(block, eps: float):
    """One GPTBlock's fused-decode pack, or None if any of its four Dense
    layers is not a frozen QuantizedDense (per-layer opt-in: such blocks
    keep the unfused path), or if the block mixes int4 and int8 layers (an
    odd-K layer kept int8 under ``bits=4``): one launch streams one weight
    lane. ``blocks`` holds the int4 tables' scale blocks (qkv, out, fc,
    proj), and is empty for int8."""
    layers = []
    for name in ("attn_qkv", "attn_out", "mlp_fc", "mlp_proj"):
        q = getattr(block, name, None)
        if q is None or getattr(q, "w_q", None) is None:
            return None
        layers.append(q)
    if len({q.w_q.dtype for q in layers}) > 1:
        return None
    int4 = layers[0].w_q.dtype == torch.uint8

    def wsb(q):
        bias = q.inner.bias
        if bias is None:
            bias = torch.zeros(q.w_q.shape[0], device=q.w_q.device)
        return q.w_q, q.w_scale, bias

    qkv, out, fc, proj = layers
    return {
        "qkv": wsb(qkv), "out": wsb(out), "fc": wsb(fc), "proj": wsb(proj),
        "ln1": (block.ln_1.gamma, block.ln_1.beta),
        "ln2": (block.ln_2.gamma, block.ln_2.beta),
        "eps": float(eps), "heads": int(block.heads),
        "blocks": tuple(2 * q.w_q.shape[1] // q.w_scale.shape[1] for q in layers)
        if int4 else (),
    }


def _kind_suffix(pack) -> str:
    """Launch-kind suffix of the pack's weight lane: int4 packs tally under
    their own ``*_int4`` kinds, as in the JAX package."""
    return "_int4" if pack["qkv"][0].dtype == torch.uint8 else ""


# ---------------------------------------------------------------------------
# plain version of K5 — the op sequence of the unfused quantized block
# ---------------------------------------------------------------------------

def _dense(xv, w_q, w_scale, bias):
    B, T, _ = xv.shape
    y = _deq_matmul(xv.reshape(B * T, xv.shape[-1]), w_q, w_scale)
    return y.reshape(B, T, w_q.shape[0]) + bias


def _reference_block_decode(xv, posv, kc, vc, pack):
    """One block's decode step with the op sequence of the unfused
    LayerNorm -> QuantizedDense -> _cached_attention chain; the caches
    are written in place."""
    from ..models.llama import _cached_attention
    heads, eps = pack["heads"], pack["eps"]
    g1, b1 = pack["ln1"]
    g2, b2 = pack["ln2"]
    B, T, d = xv.shape
    hd = d // heads
    qkv = _dense(npx.layer_norm(xv, g1, b1, eps=eps), *pack["qkv"])
    q, k, v = torch.split(qkv, d, dim=-1)
    qh = q.reshape(B, T, heads, hd).transpose(1, 2)
    kh = k.reshape(B, T, heads, hd).transpose(1, 2)
    vh = v.reshape(B, T, heads, hd).transpose(1, 2)
    o, kc, vc = _cached_attention(qh, kh, vh, kc, vc, posv)
    ctx = o.transpose(1, 2).reshape(B, T, d)
    x = xv + _dense(ctx, *pack["out"])
    h = _dense(npx.layer_norm(x, g2, b2, eps=eps), *pack["fc"])
    h = npx.gelu(h, approximate=True)
    return x + _dense(h, *pack["proj"]), kc, vc


def _reference_block_decode_paged(xv, posv, bt, kp, vp, pack):
    """One block's PAGED decode step with the op sequence of the unfused
    LayerNorm -> QuantizedDense -> _paged_attention chain; the pools are
    written in place."""
    from ..models.llama import _paged_attention
    heads, eps = pack["heads"], pack["eps"]
    g1, b1 = pack["ln1"]
    g2, b2 = pack["ln2"]
    B, T, d = xv.shape
    hd = d // heads
    qkv = _dense(npx.layer_norm(xv, g1, b1, eps=eps), *pack["qkv"])
    q, k, v = torch.split(qkv, d, dim=-1)
    qh = q.reshape(B, T, heads, hd).transpose(1, 2)
    kh = k.reshape(B, T, heads, hd).transpose(1, 2)
    vh = v.reshape(B, T, heads, hd).transpose(1, 2)
    o, kp, vp = _paged_attention(qh, kh, vh, kp, vp, bt, posv)
    ctx = o.transpose(1, 2).reshape(B, T, d)
    x = xv + _dense(ctx, *pack["out"])
    h = _dense(npx.layer_norm(x, g2, b2, eps=eps), *pack["fc"])
    h = npx.gelu(h, approximate=True)
    return x + _dense(h, *pack["proj"]), kp, vp


def _row_positions(posv, B, device):
    pos = torch.as_tensor(posv, dtype=torch.int32, device=device)
    return pos.reshape(-1).expand(B).contiguous() if pos.numel() == 1 else pos


def fused_block_decode(xv, posv, kc, vc, pack):
    """One transformer block's whole T=1 decode step. ``xv`` [B, 1, D] f32
    or bf16, ``posv`` scalar or [B] positions, ``kc``/``vc`` [B, H, L, hd]
    f32 or bf16 caches, updated IN PLACE (the JAX function returns new
    caches; copying 12 layers x 2 x B x H x L x hd x itemsize bytes every
    step is what the in-place update saves). Returns ``(out [B, 1, D] f32,
    kc, vc)``.

    A CUDA tensor launches K5 once; a CPU tensor runs the plain version.
    Shapes :func:`fusable` rejects raise: the model routes them to the
    unfused layers before calling here."""
    heads = pack["heads"]
    B, T, D = xv.shape
    L = kc.shape[2]
    if T != 1 or not fusable(B, D, heads, L, pack["blocks"], kc.element_size()):
        raise MXNetError(f"fused_block_decode: shape B={B} T={T} D={D} "
                         f"heads={heads} L={L} is not fusable")
    if kc.shape != (B, heads, L, D // heads) or vc.shape != kc.shape:
        raise MXNetError(f"fused_block_decode: caches {tuple(kc.shape)} / "
                         f"{tuple(vc.shape)} do not match x {tuple(xv.shape)}")
    if xv.device.type == "cpu":
        res = _reference_block_decode(xv, posv, kc, vc, pack)
    else:
        res = _cuda_block_decode(xv, posv, kc, vc, pack)
    record_launch("fused_block" + _kind_suffix(pack))
    return res


def _weight_operands(pack, what):
    """The pack's 16 kernel operands: (w, scale, bias) of qkv, out, fc and
    proj, then the two LayerNorms' gains and offsets; and the lane
    arguments (block of the K = D matrices, block of proj): (0, 0) for
    int8 tables, the scale blocks for int4 ones. Biases and LayerNorm
    parameters are f32 (a bf16 model's are converted): the operands are
    kept in the pack beside the source tensors they came from, and formed
    again when a source is replaced (another tensor object) or written (a
    new ``_version``), so a step launches no conversion."""
    sources = [t for key in ("qkv", "out", "fc", "proj") for t in pack[key]]
    sources += [*pack["ln1"], *pack["ln2"]]
    versions = [t._version for t in sources]
    memo = pack.get("_kernel_operands")
    if (memo is not None and all(s is m for s, m in zip(sources, memo[0]))
            and memo[1] == versions):
        return memo[2]
    ops = []
    lane = pack["qkv"][0].dtype
    for name in ("qkv", "out", "fc", "proj"):
        w, s, b = pack[name]
        if w.dtype != lane or lane not in (torch.int8, torch.uint8):
            raise MXNetError(f"{what}: the kernel takes int8 or packed int4 "
                             "weights, one lane for all four matrices")
        ops += [w.contiguous(), s.contiguous(), b.detach().float().contiguous()]
    g1, b1 = pack["ln1"]
    g2, b2 = pack["ln2"]
    blocks = pack["blocks"]
    lane_args = (blocks[0], blocks[3]) if blocks else (0, 0)
    ln = [t.detach().float().contiguous() for t in (g1, b1, g2, b2)]
    # the kernels copy the LayerNorm parameters in 16-byte words
    res = ops + [t.clone() if t.data_ptr() % 16 else t for t in ln], lane_args
    pack["_kernel_operands"] = (sources, versions, res)
    return res


_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _kernel_dtypes(xv, caches, what, aligned=False):
    """The kernels' (x_bf16, cache_bf16) flags, or raise: x f32 or bf16;
    the caches or pools of one dtype, f32 or bf16, contiguous (they are
    written in place) and, where ``aligned``, on 16-byte boundaries."""
    if xv.dtype not in _KERNEL_DTYPES:
        raise MXNetError(f"{what}: the kernel takes f32 or bf16 activations "
                         f"(got {xv.dtype})")
    cdt = caches[0].dtype
    for t in caches:
        if (t.dtype != cdt or cdt not in _KERNEL_DTYPES or not t.is_contiguous()
                or (aligned and t.data_ptr() % 16)):
            raise MXNetError(f"{what}: caches must be contiguous f32 or bf16 of one "
                             f"dtype{', 16-byte aligned' if aligned else ''} (they are "
                             f"written in place; got {[c.dtype for c in caches]})")
    return int(xv.dtype == torch.bfloat16), int(cdt == torch.bfloat16)


def _record_dtypes(kind, flags):
    """Record a block kernel launch under its element-type lane."""
    x, kv = ("bf16" if f else "f32" for f in flags)
    record_lane(f"{kind}:x_{x}:kv_{kv}")


def _kernel_rows(xv, B, D):
    """x as the kernels read it: [B, D] contiguous on a 16-byte boundary."""
    x = xv.reshape(B, D).contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def _cuda_block_decode(xv, posv, kc, vc, pack):
    from .. import _build
    B, _, D = xv.shape
    heads = pack["heads"]
    L = kc.shape[2]
    flags = _kernel_dtypes(xv, (kc, vc), "fused_block_decode", aligned=True)
    pos = _row_positions(posv, B, xv.device)
    x = _kernel_rows(xv, B, D)
    ops, lane = _weight_operands(pack, "fused_block_decode")
    scratch = torch.empty(9 * B * D, device=xv.device, dtype=torch.float32)
    out = torch.empty(B, D, device=xv.device, dtype=torch.float32)
    lib = _build.library("fused_block_decode")
    stream = torch.cuda.current_stream(xv.device).cuda_stream
    _build.check(lib.mx_fused_block_decode(
        x.data_ptr(), pos.data_ptr(), *[t.data_ptr() for t in ops],
        kc.data_ptr(), vc.data_ptr(), scratch.data_ptr(), out.data_ptr(),
        B, D, heads, L, *lane, *flags, pack["eps"], stream), "fused_block_decode")
    _record_dtypes("fused_block" + _kind_suffix(pack), flags)
    return out.reshape(B, 1, D), kc, vc


# (memo key, result) of :func:`_dma_program` for the last position tensor
_DMA_MEMO = [None]


def _dma_program(pos, H, hd, ps, maxp, itemsize=4):
    """(copies, bytes) K7 starts for these row positions: the K and the V
    page of every (row, head) for logical pages 0 .. min(pos, L-1) // ps,
    ``ps * hd * itemsize`` bytes each
    (``csrc/fused_block_decode_paged_dma.cu``). On a CUDA tensor the values
    stay 0-dim device tensors (no host sync); the 12 blocks of one step
    share the position tensor, so the count is formed once per step."""
    key = (pos, pos._version, H, hd, ps, maxp, itemsize)
    memo = _DMA_MEMO[0]
    if memo is not None and memo[0][0] is pos and memo[0][1:] == key[1:]:
        return memo[1]
    L = maxp * ps
    pages = (torch.clamp(pos.long(), 0, L - 1).div(ps, rounding_mode="floor")
             + 1).sum()
    if pos.device.type == "cpu":
        pages = int(pages)
    copies = 2 * H * pages
    out = (copies, copies * (ps * hd * itemsize))
    _DMA_MEMO[0] = (key, out)
    return out


def fused_block_decode_paged(xv, posv, bt, kp, vp, pack, dma_counters=None):
    """One transformer block's whole T=1 decode step over the PAGED KV
    pools. ``xv`` [B, 1, D] f32 or bf16, ``posv`` scalar or [B] positions,
    ``bt`` the [B, max_pages] int32 block table, ``kp``/``vp`` the shared
    [NP + 1, H, ps, hd] f32 or bf16 pools (last page = sink), updated IN
    PLACE. Returns ``(out [B, 1, D] f32, kp, vp)``.

    Routing, as in JAX: K6 where :func:`fusable_paged` accepts the shape,
    else K7 where :func:`fusable_paged_dma` does (recording its page
    copies with :func:`~mxnet_tpu_torch.ops.int8_gemv.record_dma`). A CUDA
    tensor launches that kernel once, and raises where neither gate
    accepts the shape (the model routes such shapes to the unfused layers
    first). A CPU tensor runs the plain version; a shape neither gate
    accepts records 4 ``gemv`` launches there, as the JAX fallback does.
    ``dma_counters``: an optional [2] int32 CUDA tensor to which K7 adds
    the page copies it started and waited for."""
    heads = pack["heads"]
    B, T, D = xv.shape
    NP1, H, ps, hd = kp.shape
    maxp = bt.shape[1]
    gate = (B, D, heads, NP1, ps, maxp, kp.element_size())
    blocks = pack["blocks"]
    use_k6 = T == 1 and fusable_paged(*gate, blocks=blocks)
    use_k7 = T == 1 and not use_k6 and fusable_paged_dma(*gate, blocks=blocks)
    if H != heads or hd * heads != D or vp.shape != kp.shape \
            or tuple(bt.shape) != (B, maxp):
        raise MXNetError(f"fused_block_decode_paged: pools {tuple(kp.shape)} / "
                         f"{tuple(vp.shape)}, table {tuple(bt.shape)} do not "
                         f"match x {tuple(xv.shape)} with {heads} heads")
    on_cpu = xv.device.type == "cpu"
    if not (use_k6 or use_k7 or on_cpu):
        raise MXNetError(f"fused_block_decode_paged: shape B={B} T={T} D={D} "
                         f"heads={heads} L={maxp * ps} is not fusable")
    if on_cpu:
        res = _reference_block_decode_paged(xv, posv, bt, kp, vp, pack)
    else:
        res = _cuda_block_decode_paged(xv, posv, bt, kp, vp, pack, use_k7,
                                       dma_counters)
    if use_k6:
        record_launch("fused_block_paged" + _kind_suffix(pack))
    elif use_k7:
        record_launch("fused_block_paged_dma" + _kind_suffix(pack))
        copies, nbytes = _dma_program(_row_positions(posv, B, xv.device),
                                      H, hd, ps, maxp, kp.element_size())
        record_dma(copies, nbytes)
    else:
        for _ in range(4):
            record_launch("gemv")
    return res


def _cuda_block_decode_paged(xv, posv, bt, kp, vp, pack, streamed, counters):
    from .. import _build
    what = "fused_block_decode_paged"
    B, _, D = xv.shape
    NP1, H, ps, hd = kp.shape
    maxp = bt.shape[1]
    flags = _kernel_dtypes(xv, (kp, vp), what, aligned=True)
    pos = _row_positions(posv, B, xv.device)
    table = bt.to(torch.int32).contiguous()
    x = _kernel_rows(xv, B, D)
    ops, lane = _weight_operands(pack, what)
    scratch = torch.empty(9 * B * D, device=xv.device, dtype=torch.float32)
    out = torch.empty(B, D, device=xv.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(xv.device).cuda_stream
    head = [x.data_ptr(), pos.data_ptr(), table.data_ptr()]
    ptrs = [t.data_ptr() for t in ops] + [kp.data_ptr(), vp.data_ptr(),
                                          scratch.data_ptr(), out.data_ptr()]
    if not streamed:
        lib = _build.library("fused_block_decode_paged")
        _build.check(lib.mx_fused_block_decode_paged(
            *head, *ptrs, B, D, H, ps, maxp, NP1 - 1, *lane, *flags, pack["eps"], stream),
            what)
        _record_dtypes("fused_block_paged" + _kind_suffix(pack), flags)
    else:
        if counters is not None and (counters.dtype != torch.int32
                                     or counters.numel() != 2
                                     or counters.device != xv.device):
            raise MXNetError(f"{what}: dma_counters must be a [2] int32 tensor "
                             "on the pools' device")
        lib = _build.library("fused_block_decode_paged_dma")
        _build.check(lib.mx_fused_block_decode_paged_dma(
            *head, *ptrs, 0 if counters is None else counters.data_ptr(),
            B, D, H, ps, maxp, NP1 - 1, _DMA_DEPTH, *lane, *flags, pack["eps"], stream), what)
        _record_dtypes("fused_block_paged_dma" + _kind_suffix(pack), flags)
    return out.reshape(B, 1, D), kp, vp


# ---------------------------------------------------------------------------
# fused LM-head sampling
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _hash_uniform(keys, lanes):
    """Stateless per-(request key, absolute lane) uniform in (0, 1): the
    murmur3-style finalizer of ``fused_block_gemv._hash_uniform``, in
    uint32 arithmetic carried in int64 (the low 32 bits of every product
    are exact). ``keys`` and ``lanes`` broadcast; both hold values in
    [0, 2**32)."""
    z = (lanes.long() * 0x9E3779B9) & _M32
    z = z ^ (keys.long() & _M32)
    z = z ^ (z >> 16)
    z = (z * 0x7FEB352D) & _M32
    z = z ^ (z >> 15)
    z = (z * 0x846CA68B) & _M32
    z = z ^ (z >> 16)
    return ((z >> 8).float() + 0.5) * (1.0 / (1 << 24))


def _reference_head_sample(h, w_q, w_scale, vocab, temps, keybits,
                           out_dtype=None, mask=None):
    """Plain version of K8: dequantized head logits (either weight lane),
    rounded through ``out_dtype`` where one other than f32 is given (the
    unfused head casts its logits to the activation dtype), divided by T
    (T > 0 rows), hash-Gumbel noise on T > 0 rows, lanes the grammar
    ``mask`` (bool [B, Vp], True = allowed) forbids at -inf, pad lanes at
    -inf, argmax with ties to the lowest lane (the TPU kernel's order)."""
    B = h.shape[0]
    Vp = w_q.shape[0]
    acc = _deq_matmul(h, w_q, w_scale)                             # [B, Vp]
    if out_dtype is not None and out_dtype != torch.float32:
        acc = acc.to(out_dtype).float()
    t = temps.reshape(B, 1)
    z = acc / torch.where(t > 0, t, torch.ones_like(t))
    lanes = torch.arange(Vp, device=h.device)[None, :]
    u = _hash_uniform(keybits.reshape(B, 1), lanes)
    gumbel = -torch.log(-torch.log(u))
    z = torch.where(t > 0, z + gumbel, z)
    ninf = torch.full_like(z, float("-inf"))
    if mask is not None:
        z = torch.where(mask, z, ninf)
    z = torch.where(lanes < vocab, z, ninf)
    return torch.argmax(z, dim=-1).to(torch.int32)


def fused_lm_head_sample(h, w_q, w_scale, vocab, keys, temps, topks=0,
                         topps=1.0, out_dtype=None, mask=None, filtered=None,
                         greedy=None):
    """Tied-head GEMV + token selection for one decode step's last-position
    hidden state ``h`` [B, D] (f32 or bf16). ``(w_q, w_scale)`` is the
    vocab-padded table: int8 [Vp, D] with per-row scales [Vp], or packed
    int4 [Vp, D/2] uint8 with block scales [Vp, D/block]; pad lanes never
    win. ``keys`` are the rows' [B, 2] ``_prng`` keys (or, for a batch with
    no top-k/top-p row, their [B] key bits, ``k[:, 0] ^ k[:, 1]``, values in
    [0, 2**32)). Returns [B] int32.

    A batch with no top-k/top-p row streams the table once through K8:
    greedy rows (T == 0) take the exact argmax of the head logits, T > 0
    rows Gumbel-argmax sample with noise from :func:`_hash_uniform` of the
    key bits (the TPU kernel's stream). A batch with any filtered row takes
    the reference's other branch (``lax.cond``, fused_block_gemv.py:
    1379-1391): logits from the head GEMV (K3, or K4) cut to ``vocab``,
    then ``generation.sample_tokens`` with the rows' keys.

    ``out_dtype`` is the dtype the unfused head would give the logits (the
    caller passes its hidden state's dtype, as the JAX package does): the
    logits are rounded through it before selection. K8 on the card takes
    f32 (no rounding) and bf16; the plain version and the filtered branch
    honour any dtype.

    ``mask`` (bool [B, vocab], True = allowed) is a grammar constraint: K8
    reads it as it is (one byte a lane; lanes past ``vocab`` are pad), the
    plain version pads it to [B, Vp] with False as the reference does, and
    both fold it in after the noise and before the pad mask; the filtered
    branch hands it to ``sample_tokens``. A mask held on the host
    (numpy, or a CPU tensor) is checked first: a row that allows no token
    raises (``generation._check_mask_live``). A mask already on the card
    is not (that check would put a host sync on every decode step; the JAX
    package's kernel branch does not check either, and its engine guards
    its masks on the host): K8 then selects lane 0 for such a row, as the
    TPU kernel does.

    ``filtered`` (a bool) names the branch instead of reading it from
    ``topks``/``topps``, which may then be [B] device tensors: the choice
    stays on the host, so a step that calls this with device parameters
    syncs nowhere and can be captured in a CUDA graph. ``greedy`` is handed
    to ``sample_tokens`` on the filtered branch."""
    B, D = h.shape
    rounded = out_dtype is not None and out_dtype != torch.float32
    topks = torch.as_tensor(np.asarray(topks) if not isinstance(topks, torch.Tensor)
                            else topks).reshape(-1)
    topps = torch.as_tensor(np.asarray(topps, np.float32) if not isinstance(topps, torch.Tensor)
                            else topps, dtype=torch.float32).reshape(-1)
    keys = torch.as_tensor(keys, device=h.device)
    if mask is not None:
        from ..models.generation import _check_mask_live
        mask = torch.as_tensor(mask, dtype=torch.bool)
        if mask.shape != (B, int(vocab)):
            raise MXNetError(f"fused_lm_head_sample: mask must be bool [B, vocab] = "
                             f"[{B}, {int(vocab)}] (got {tuple(mask.shape)})")
        if mask.device.type == "cpu":
            _check_mask_live(mask)
        mask = mask.to(h.device)
    if filtered is None:
        filtered = bool((topks > 0).any()) or bool((topps < 1.0).any())
    if filtered:
        from ..models.generation import sample_tokens
        from .int8_gemv import weight_matmul
        if keys.shape != (B, 2):
            raise MXNetError("fused_lm_head_sample: a top-k/top-p batch needs the "
                             "rows' [B, 2] keys")
        logits = weight_matmul(h, w_q, w_scale)[:, :int(vocab)]
        if rounded:
            logits = logits.to(out_dtype)
        return sample_tokens(logits, keys, temps, topks, topps, mask=mask, greedy=greedy)
    Vp = w_q.shape[0]
    if w_q.dtype == torch.uint8:
        nsb = w_scale.shape[-1] if w_scale.dim() == 2 else 0
        if (w_q.shape != (Vp, D // 2) or D % 2 or w_scale.shape != (Vp, nsb)
                or nsb < 1 or D % nsb):
            raise MXNetError("fused_lm_head_sample: int4 table w_q (Vp, D/2) "
                             "uint8, w_scale (Vp, D/block)")
        block = D // nsb
    elif w_q.shape != (Vp, D) or w_scale.shape != (Vp,) or w_q.dtype != torch.int8:
        raise MXNetError("fused_lm_head_sample: w_q (Vp, D) int8, w_scale (Vp,)")
    else:
        block = 0
    dev = h.device
    temps = torch.as_tensor(temps, dtype=torch.float32, device=dev).reshape(-1)
    if temps.numel() not in (1, B):
        raise MXNetError("fused_lm_head_sample: one temperature per row, or one for all")
    if keys.dim() == 2 and keys.shape != (B, 2) or keys.dim() != 2 and keys.numel() != B:
        raise MXNetError("fused_lm_head_sample: one key per row")
    if dev.type == "cpu":
        mask_p = None
        if mask is not None:
            mask_p = torch.zeros(B, Vp, dtype=torch.bool, device=dev)
            mask_p[:, :int(vocab)] = mask
        keybits = keys[:, 0] ^ keys[:, 1] if keys.dim() == 2 else keys.reshape(-1)
        tok = _reference_head_sample(h.float(), w_q, w_scale, int(vocab),
                                     temps.expand(B).contiguous(), keybits, out_dtype, mask_p)
    else:
        if rounded and out_dtype != torch.bfloat16:
            raise MXNetError(f"fused_lm_head_sample: the kernel rounds logits through "
                             f"bf16 or not at all (out_dtype {out_dtype})")
        tok = _cuda_head_sample(h, w_q, w_scale, int(vocab), temps, keys, block,
                                mask, rounded)
    record_launch("fused_head" + ("_int4" if block else ""))
    return tok


# per (device, stream): the int32 workspace of K8, [ticket, pad to 16
# bytes, per-CTA best scores, their lanes], and its row capacity. A
# workspace outgrown by a wider call is kept in _HEAD_WS_KEPT, never freed:
# a CUDA graph captured on its stream holds its address.
_HEAD_WS = {}
_HEAD_WS_KEPT = []


def _head_workspace(lib, dev, stream, B):
    """K8's ticket (an int that every launch leaves 0) and room for B rows
    of per-CTA pairs, kept per (device, stream): launches on one stream
    run in turn, so they may share it (graphs captured on a stream share
    its workspace and must replay in turn too). Returns (ticket, pmax,
    pidx) pointers."""
    key = (dev.index, stream)
    ws = _HEAD_WS.get(key)
    if ws is None or ws[1] < B:
        ctas = lib.mx_head_max_ctas()
        if ctas <= 0:
            raise MXNetError("fused_lm_head_sample: no CUDA device limits")
        cap = max(B, 16)
        if ws is not None:
            _HEAD_WS_KEPT.append(ws)
        ws = (torch.zeros(4 + 2 * cap * ctas, dtype=torch.int32, device=dev), cap, ctas)
        _HEAD_WS[key] = ws
    buf, cap, ctas = ws
    base = buf.data_ptr()
    return base, base + 16, base + 16 + 4 * cap * ctas


def _cuda_head_sample(h, w_q, w_scale, vocab, temps, keys, block, mask, rounded):
    from .. import _build
    from .int8_gemv import _check_aligned, _kernel_x
    B, D = h.shape
    Vp = w_q.shape[0]
    if D % 16:
        raise MXNetError("fused_lm_head_sample: the kernel needs D % 16 == 0")
    if block and not int4_chunks_fit(D, block):
        raise MXNetError(f"fused_lm_head_sample: the int4 lane needs block % 16 "
                         f"== 0 (got {block})")
    h, h_bf16 = _kernel_x(h, "fused_lm_head_sample")
    w_q, w_scale = w_q.contiguous(), w_scale.contiguous()
    _check_aligned((w_q, w_scale) if block else (w_q,), "fused_lm_head_sample")
    # the caller's keys as int64 ([B, 2]: the kernel xors the words) and
    # mask (bool [B, vocab], one byte a lane) are read as they are
    keys = keys.to(torch.int64).contiguous()
    if mask is not None:
        mask = mask.contiguous()
    lib = _build.library("lm_head_sample")
    stream = torch.cuda.current_stream(h.device).cuda_stream
    ticket, pmax, pidx = _head_workspace(lib, h.device, stream, B)
    tok = torch.empty(B, device=h.device, dtype=torch.int32)
    _build.check(lib.mx_lm_head_sample(
        h.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(), temps.data_ptr(),
        int(temps.numel() > 1), keys.data_ptr(), 2 if keys.dim() == 2 else 1,
        None if mask is None else mask.data_ptr(), pmax, pidx, ticket, tok.data_ptr(),
        B, Vp, D, vocab, block, h_bf16, int(rounded), stream), "lm_head_sample")
    record_lane("fused_head" + ("_int4" if block else "") + ":h_" + ("bf16" if h_bf16 else "f32")
                + (":bf16_logits" if rounded else "") + (":mask" if mask is not None else ""))
    return tok
