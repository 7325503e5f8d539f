"""Host-side arithmetic of the block decode kernels K5, K6 and K7 (the
Python mirrors of their C shared-memory and slot functions) at GPT-2 small's
widths, and the routing of paged steps between K6 and K7. Runs on the CPU:
the kernels' own C values are held against these mirrors by
``tests/test_torch_cuda_kernels.py::test_paged_smem_matches_python_gates`` on
the card."""
import dataclasses

import numpy as onp
import pytest
import torch

from mxnet_tpu_torch.contrib.quantization import quantize_net
from mxnet_tpu_torch.models import GPT2_SMALL, GPTModel
from mxnet_tpu_torch.ops import fused_block_gemv as fb
from mxnet_tpu_torch.ops.int8_gemv import count_launches

D, H = 768, 12


@pytest.mark.parametrize("B,rows", [(1, 8), (8, 8), (9, 16), (16, 16), (64, 16)])
def test_weight_phases_take_16_rows_past_8(B, rows):
    """Past 8 rows the weight phases stage 16 rows a pass at GPT-2 small
    (16 x 4D f32 = 192 KB fits in 227 KB), so a 16-row step streams every
    weight matrix once; at D 1024 the 16-row tile (256 KB) does not fit."""
    assert fb._block_rows(B, D) == rows
    assert fb._block_rows(B, 1024) == 8


# K5's shared memory by (B, cache itemsize, L): the larger of the staged
# activation tile (8 rows of 4D f32, 98304 bytes; 16 rows past 8, 196608)
# and the attention layout (two ring slots of 1024 / itemsize key rows,
# 64 KB each at hd 64 in either dtype, + 4 * (64 + L + 5 * 256) bytes of q,
# score row, P.V scratch and item order), then two 8-byte mbarriers
_K5_SMEM = {
    (1, 4, 256): 137488, (1, 4, 1024): 140560, (1, 2, 256): 137488, (1, 2, 1024): 140560,
    (8, 4, 256): 137488, (8, 4, 1024): 140560, (8, 2, 256): 137488, (8, 2, 1024): 140560,
    (9, 4, 256): 196624, (9, 4, 1024): 196624, (9, 2, 256): 196624, (9, 2, 1024): 196624,
    (16, 4, 256): 196624, (16, 4, 1024): 196624, (16, 2, 256): 196624,
    (16, 2, 1024): 196624,
}


@pytest.mark.parametrize("B,itemsize,L", sorted(_K5_SMEM))
def test_contiguous_kernel_smem_at_gpt2_small(B, itemsize, L):
    """K5's Python mirrors (``mx_fused_block_slot_rows``,
    ``mx_fused_block_smem``): 256 f32 or 512 bf16 key rows a slot, the
    stated bytes, and the gate accepts every such shape."""
    assert fb._slab_rows(D, H, L, itemsize) == 1024 // itemsize
    assert fb._block_smem(D, H, L, itemsize, B) == _K5_SMEM[B, itemsize, L]
    tile = 4 * fb._block_rows(B, D) * 4 * D
    ring = 2 * 1024 * 64 + 4 * (64 + L + 5 * 256)
    assert _K5_SMEM[B, itemsize, L] == max(tile, ring) + 16
    assert fb.fusable(B, D, H, L, cache_itemsize=itemsize)


def test_contiguous_kernel_slots_shrink_where_the_ring_does_not_fit():
    """At hd 128 two slots of 256 f32 rows (256 KB) do not fit: K5's slot
    shrinks by 16 rows until the ring does; only the score row grows with
    L, so the gate still takes L 8192 at GPT-2 small."""
    rows = fb._slab_rows(1024, 8, 1024)
    assert rows % 16 == 0 and rows < 256
    assert fb._streamed_smem(1024, 8, 1024, 2, rows, 4) <= fb._SMEM_LIMIT
    assert fb._streamed_smem(1024, 8, 1024, 2, rows + 16, 4) > fb._SMEM_LIMIT
    assert fb.fusable(8, 1024, 8, 1024)
    assert fb.fusable(8, D, H, 8192) and fb.fusable(8, D, H, 8192, cache_itemsize=2)


# K6's ring slots (each the whole context: L key rows) and shared memory by
# (B, pool itemsize, L): 4, 3 or 2 slots of L * 64 * itemsize bytes, the
# most that fit beside 4 * (64 + L + 5 * 256) bytes of q, score row, P.V
# scratch and item order, or the 16-row tile at B 16 where that is larger;
# then one mbarrier a slot. Depth 0: two slots do not fit (K7 takes L).
_K6_GATE = {
    (8, 4, 256): (3, 203032), (8, 4, 432): (2, 228304), (8, 4, 448): (0, None),
    (8, 2, 256): (4, 137504), (8, 2, 432): (4, 228320), (8, 2, 864): (2, 230032),
    (8, 2, 880): (0, None),
    (16, 4, 256): (3, 203032), (16, 4, 432): (2, 228304), (16, 2, 256): (4, 196640),
    (16, 2, 864): (2, 230032),
}


@pytest.mark.parametrize("B,itemsize,L", sorted(_K6_GATE))
def test_gathered_kernel_ring_at_gpt2_small(B, itemsize, L):
    """K6's Python mirrors (``mx_paged_depth``, ``mx_paged_smem``) and its
    gate: L <= 432 with f32 pools and L <= 864 with bf16 pools at page 16,
    as ``fusable_paged`` documents; f32 L 256 keeps the next row's K in a
    third slot, bf16 both its K and V in a third and fourth."""
    depth, smem = _K6_GATE[B, itemsize, L]
    assert fb._paged_depth(D, H, L, itemsize, B) == depth
    assert fb.fusable_paged(B, D, H, 200, 16, L // 16, itemsize) == (depth > 0)
    if depth:
        assert fb._paged_smem(D, H, L, itemsize, B) == smem <= fb._SMEM_LIMIT
        tile = 4 * fb._block_rows(B, D) * 4 * D
        assert smem == max(tile, depth * L * 64 * itemsize + 4 * (64 + L + 5 * 256)) + 8 * depth
    else:
        assert fb._paged_smem(D, H, L, itemsize, B) > fb._SMEM_LIMIT
        assert fb.fusable_paged_dma(B, D, H, 200, 16, L // 16, itemsize)


@pytest.mark.parametrize("B,itemsize", [(8, 4), (16, 4), (8, 2), (16, 2)])
def test_streamed_kernel_smem_follows_the_row_tile(B, itemsize):
    """K7's slot pages do not depend on B, its shared memory does: the
    16-row tile (196608 bytes) exceeds a two-slot ring at B 16."""
    tp = fb._dma_tile_pages(D, H, 16, 1024, 2, itemsize)
    assert tp == 1024 // itemsize // 16
    ring = 2 * 1024 * 64 + 4 * (64 + 1024 + 5 * 256)
    want = max(196608 if B > 8 else 98304, ring) + 16
    assert fb._paged_dma_smem(D, H, 16, 1024, 2, itemsize, B) == want


@pytest.fixture(scope="module")
def gpt2_block():
    """One int8 block of GPT-2 small's widths on the CPU, and its pack."""
    cfg = dataclasses.replace(GPT2_SMALL, num_layers=1, dropout=0.0, vocab_size=256)
    net = quantize_net(GPTModel(cfg, device="cpu").init_weights(0), fused_decode=True)
    return fb.pack_gpt_block(net.blocks[0], eps=cfg.layer_norm_eps)


def _paged_step(pack, B, maxp, dtype, seed):
    """A CPU paged step at GPT-2 small's widths: B rows over pages of 16
    positions (scattered tables, the last row inactive)."""
    rng = onp.random.RandomState(seed)
    pool = B * maxp
    perm = rng.permutation(pool)
    table = onp.full((B, maxp), pool, onp.int32)
    pos = rng.randint(0, 16 * maxp, B)
    pos[-1] = 0
    for b in range(B - 1):
        table[b, :pos[b] // 16 + 1] = perm[b * maxp:b * maxp + pos[b] // 16 + 1]
    x = torch.from_numpy(rng.randn(B, 1, D).astype(onp.float32)).to(dtype)
    kp = torch.from_numpy(rng.randn(pool + 1, H, 16, 64).astype(onp.float32) * 0.1).to(dtype)
    return x, torch.from_numpy(pos.astype(onp.int32)), torch.from_numpy(table), kp, kp.clone()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("phase,B,maxp,kind", [("A", 16, 16, "fused_block_paged"),
                                               ("B", 8, 64, "fused_block_paged_dma")])
def test_paged_phases_route_to_their_kernels(gpt2_block, dtype, phase, B, maxp, kind):
    """``chip_smoke``'s paged A (16 rows, L 256) takes K6 and paged B (8
    rows, L 1024) K7, with f32 and bf16 pools: the gates the wrapper routes
    by, and the launch it records (the plain version runs here)."""
    gate = (B, D, H, B * maxp + 1, 16, maxp, dtype.itemsize)
    assert fb.fusable_paged(*gate) == (phase == "A")
    assert fb.fusable_paged_dma(*gate)
    x, pos, table, kp, vp = _paged_step(gpt2_block, B, maxp, dtype, seed=3)
    with torch.no_grad(), count_launches() as tally:
        out, _, _ = fb.fused_block_decode_paged(x, pos, table, kp, vp, gpt2_block)
    assert tally == {kind: 1}
    assert out.shape == (B, 1, D) and bool(torch.isfinite(out).all())
