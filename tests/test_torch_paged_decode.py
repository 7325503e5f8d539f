"""Port parity of the paged decode path: ``_paged_attention``, the plain
versions of K6 (gathered paged block decode) and K7 (its streamed variant)
against the JAX package's reference and its interpret-mode Pallas kernels,
and the routing of ``fused_block_decode_paged`` on CPU tensors."""
import numpy as onp
import pytest
import torch

import jax.numpy as jnp
import mxnet_tpu as mx
from mxnet_tpu import np as mnp
from mxnet_tpu.contrib.quantization import quantize_net as jax_quantize_net
from mxnet_tpu.models import GPTModel as JaxGPT
from mxnet_tpu.models import llama as jllama
from mxnet_tpu.models.gpt import GPTConfig as JaxGPTConfig
from mxnet_tpu.ops import fused_block_gemv as jfb

from mxnet_tpu_torch.contrib.quantization import quantize_net
from mxnet_tpu_torch.interop import params_from_numpy
from mxnet_tpu_torch.models import GPTConfig, GPTModel
from mxnet_tpu_torch.models import llama
from mxnet_tpu_torch.ops import fused_block_gemv as fb
from mxnet_tpu_torch.ops.int8_gemv import (count_launches, dma_ledger,
                                           reset_launches)


def _pair(hidden=256, heads=4, maxpos=64):
    """A JAX GPT and the port's GPT with the same weights, both int8 (the
    JAX one as ``tests/test_fused_decode.py``'s ``_quantized``)."""
    cfg = dict(vocab_size=256, hidden_size=hidden, num_layers=1,
               num_heads=heads, max_position_embeddings=maxpos, dropout=0.0)
    mx.random.seed(0)
    jnet = JaxGPT(JaxGPTConfig(**cfg))
    jnet.initialize()
    jnet(mnp.array(onp.zeros((1, 4), "int32")))
    named = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    jax_quantize_net(jnet, calib_mode="none")
    tnet = GPTModel(GPTConfig(**cfg), device="cpu")
    params_from_numpy(tnet, named)
    quantize_net(tnet)
    return jnet, tnet


@pytest.fixture(scope="module")
def nets():
    return _pair()


@pytest.fixture
def pallas_load_store(monkeypatch):
    """jax 0.9 dropped ``pl.load``/``pl.store``, which the JAX paged
    kernels still call; alias them to the ref indexing they performed while
    a test runs the kernels in interpret mode."""
    from jax.experimental import pallas as pl

    def _store(ref, idx, val):
        ref[idx] = val

    monkeypatch.setattr(pl, "load", lambda ref, idx: ref[idx], raising=False)
    monkeypatch.setattr(pl, "store", _store, raising=False)


def _paged_fixture(D=256, H=4, B=3, ps=4, maxp=4, pool=10, pos=(5, 9, 2)):
    """``tests/test_fused_decode.py:_paged_fixture``: scattered physical
    pages, rows at mixed depths, unleased entries on the sink."""
    rng = onp.random.RandomState(0)
    hd = D // H
    x = rng.randn(B, 1, D).astype("float32")
    kp = (rng.randn(pool + 1, H, ps, hd) * 0.1).astype("float32")
    vp = (rng.randn(pool + 1, H, ps, hd) * 0.1).astype("float32")
    bt = onp.full((B, maxp), pool, onp.int32)
    bt[0, :2] = [3, 7]
    bt[1, :3] = [0, 5, 2]
    bt[2, :1] = [9]
    return x, onp.asarray(pos, "int32"), bt, kp, vp


def _written(pos, bt, pool, ps, H, T=1):
    """[pool + 1, H, ps] bool: the rows the step writes, sink page whole."""
    mask = onp.zeros((pool + 1, H, ps), bool)
    L = bt.shape[1] * ps
    for b, p in enumerate(pos):
        for c in range(p, p + T):
            if c < L:
                mask[bt[b, c // ps], :, c % ps] = True
    mask[pool] = True
    return mask


# ------------------------------------------------------------ _paged_attention
@pytest.mark.parametrize("T,pos", [(1, [5, 9, 2]), (8, [10, 12, 3])])
def test_paged_attention_matches_jax(T, pos):
    """The port's ``_paged_attention`` against JAX's on scattered tables:
    T=1 decode, and a T=8 chunk whose pad columns run past L (they go to
    the sink page). Pools bitwise equal outside the sink page (several rows
    write the sink: either write may win); output within 1e-6."""
    rng = onp.random.RandomState(1)
    B, H, hd, ps, maxp, pool = 3, 4, 16, 4, 4, 12
    bt = onp.full((B, maxp), pool, onp.int32)
    bt[0] = [3, 7, 1, 4]
    bt[1] = [0, 5, 2, 8]
    bt[2, :3] = [9, 6, 11]
    qh, kh, vh = (rng.randn(B, H, T, hd).astype("float32") for _ in range(3))
    kp = rng.randn(pool + 1, H, ps, hd).astype("float32")
    vp = rng.randn(pool + 1, H, ps, hd).astype("float32")
    posv = onp.asarray(pos, "int32")
    jo, jk, jv = jllama._paged_attention(*map(jnp.asarray, (qh, kh, vh, kp, vp, bt,
                                                            posv)), 1)
    to, tk, tv = llama._paged_attention(*map(torch.from_numpy, (
        qh, kh, vh, kp.copy(), vp.copy(), bt, posv)))
    assert onp.abs(to.numpy() - onp.asarray(jo)).max() < 1e-6
    for got, want, old in ((tk, jk, kp), (tv, jv, vp)):
        got, want = got.numpy()[:pool], onp.asarray(want)[:pool]
        assert (got == want).all()
        assert (got != old[:pool]).any()          # the step did write rows
    # T=8: columns 16.. of rows 0 and 1 went to the sink, not to their last page
    if T == 8:
        assert (tk.numpy()[bt[0, 3], :, 3] == kh[0, :, 5]).all()


# ------------------------------------------------------------ plain K6 / K7
def test_plain_paged_block_decode_matches_jax_reference_and_kernels(
        nets, pallas_load_store):
    """The port's ``_reference_block_decode_paged`` (the plain version of
    K6 and K7) against JAX's reference and against ``_pallas_block_decode
    _paged`` and ``_pallas_block_decode_paged_dma`` in interpret mode on
    ``_paged_fixture``: output within 1e-4 (the JAX kernel parity test's
    tolerance), written rows within 1e-5 (f32 sums in another order),
    every other non-sink pool entry bitwise unchanged."""
    jnet, tnet = nets
    x, pos, bt, kp, vp = _paged_fixture()
    pack = jfb.pack_gpt_block(list(jnet.blocks)[0], eps=jnet.cfg.layer_norm_eps)
    args = (jnp.asarray(x), jnp.asarray(pos), jnp.asarray(bt), jnp.asarray(kp),
            jnp.asarray(vp), jfb._consts(pack), 4, pack["eps"])
    wants = [jfb._reference_block_decode_paged(*args),
             jfb._pallas_block_decode_paged(*args, interpret=True),
             jfb._pallas_block_decode_paged_dma(*args, interpret=True)]
    tpack = fb.pack_gpt_block(tnet.blocks[0], eps=tnet.cfg.layer_norm_eps)
    with torch.no_grad():
        out, tk, tv = fb._reference_block_decode_paged(
            torch.from_numpy(x), torch.from_numpy(pos), torch.from_numpy(bt),
            torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy()), tpack)
    written = _written(pos, bt, 10, 4, 4)
    nonsink = written.copy()
    nonsink[10] = False
    for want in wants:
        want = [onp.asarray(a) for a in want]
        assert onp.abs(out.numpy() - want[0]).max() < 1e-4
        for got, exp, old in ((tk.numpy(), want[1], kp), (tv.numpy(), want[2], vp)):
            assert (got[~written] == old[~written]).all()
            assert (exp[~written] == old[~written]).all()
            assert onp.abs(got[nonsink] - exp[nonsink]).max() < 1e-5


# ------------------------------------------------------------ routing
def _unfused(blk, x, pos, bt, kp, vp):
    pack, blk._fused_pack = blk._fused_pack, None
    try:
        return blk.forward_cached_paged(x, pos, bt, kp, vp)
    finally:
        blk._fused_pack = pack


def _leased_table(pos, ps, maxp, pool, seed=2):
    """[B, maxp] table leasing each row the scattered pages that cover its
    position, the rest on the sink."""
    perm = list(onp.random.RandomState(seed).permutation(pool))
    bt = onp.full((len(pos), maxp), pool, onp.int32)
    for b, p in enumerate(pos):
        for i in range(min(p, maxp * ps - 1) // ps + 1):
            bt[b, i] = perm.pop()
    return bt


@pytest.mark.parametrize("maxp,ps,pos,kind", [
    (4, 4, (5, 15, 9), "fused_block_paged"),
    (28, 16, (5, 447, 100), "fused_block_paged_dma")])
def test_routing_by_gate_is_bitwise_unfused(maxp, ps, pos, kind):
    """On CPU tensors ``fused_block_decode_paged`` tallies one launch of
    the kernel its gate picks (L 16: K6; L 448, past K6's shared-memory
    gate at hd 64: K7, with its page copies in the ``record_dma`` ledger)
    and is bitwise the unfused paged block."""
    _, tnet = _pair(maxpos=512)
    tnet.enable_fused_decode()
    blk = tnet.blocks[0]
    D, H, hd, pool = 256, 4, 64, 40
    x, _, _, kp, vp = _paged_fixture(ps=ps, maxp=maxp, pool=pool)
    bt = _leased_table(pos, ps, maxp, pool)
    gate = (3, D, H, pool + 1, ps, maxp)
    assert fb.fusable_paged(*gate) == (kind == "fused_block_paged")
    assert fb.fusable_paged_dma(*gate)
    t = [torch.from_numpy(a) for a in (x, onp.asarray(pos, "int32"), bt)]
    reset_launches()
    with torch.no_grad(), count_launches() as tally:
        got = fb.fused_block_decode_paged(*t, torch.from_numpy(kp.copy()),
                                          torch.from_numpy(vp.copy()),
                                          blk._fused_pack)
    assert tally == {kind: 1}
    pages = sum(min(p, maxp * ps - 1) // ps + 1 for p in pos)
    copies = 2 * H * pages if kind == "fused_block_paged_dma" else 0
    assert dma_ledger() == {"copies": copies, "waits": copies,
                            "bytes": copies * ps * hd * 4}
    with torch.no_grad():
        want = _unfused(blk, *t, torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy()))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_declined_shape_takes_plain_path_with_four_gemvs():
    """hd 12 fails both Hopper gates' tiling: on a CPU tensor the wrapper
    tallies 4 ``gemv`` launches and runs the plain version, bitwise the
    unfused block; the model routes such a block to the unfused layers
    itself."""
    tnet = quantize_net(GPTModel(GPTConfig(vocab_size=64, hidden_size=48, num_layers=1,
                                           num_heads=4, max_position_embeddings=64,
                                           dropout=0.0), device="cpu")
                        .init_weights(3, std=0.1), fused_decode=True)
    blk = tnet.blocks[0]
    x, pos, bt, kp, vp = _paged_fixture(D=48, H=4)
    assert not fb.fusable_paged(3, 48, 4, 11, 4, 4)
    assert not fb.fusable_paged_dma(3, 48, 4, 11, 4, 4)
    t = [torch.from_numpy(a) for a in (x, pos, bt)]
    with torch.no_grad(), count_launches() as tally:
        got = fb.fused_block_decode_paged(*t, torch.from_numpy(kp.copy()),
                                          torch.from_numpy(vp.copy()), blk._fused_pack)
    assert tally == {"gemv": 4}
    with torch.no_grad(), count_launches() as tally:
        routed = blk.forward_cached_paged(*t, torch.from_numpy(kp.copy()),
                                          torch.from_numpy(vp.copy()))
    assert tally == {"gemv": 4}                   # the block's own QuantizedDenses
    for a, b in zip(got, routed):
        assert torch.equal(a, b)


def test_hopper_gates_at_gpt2_small():
    """GPT-2 small (D 768, 12 heads, page 16): L 256 (and 384, 432) takes
    K6; L 448, 512 and 1024 exceed K6's shared memory and take K7; the pool
    size enters neither gate. bf16 pools halve the gathered K and V: K6
    takes L up to 864 (page 16), K7 beyond; f64 pools take neither."""
    for maxp in (16, 24, 27):
        assert fb.fusable_paged(16, 768, 12, 129, 16, maxp)
    for maxp in (28, 32, 64):
        assert not fb.fusable_paged(8, 768, 12, 161, 16, maxp)
        assert fb.fusable_paged_dma(8, 768, 12, 161, 16, maxp)
    # three slots of the whole context fit at L 256 (the next row's K in flight)
    assert fb._paged_smem(768, 12, 256) == 3 * 256 * 64 * 4 + 4 * (256 + 64 + 5 * 256) + 24
    assert fb._dma_tile_pages(768, 12, 16, 1024, 2) == 16       # 256 key rows a slot
    assert fb.fusable_paged(8, 768, 12, 10 ** 6, 16, 16)
    assert fb.fusable_paged_dma(8, 768, 12, 10 ** 6, 16, 64)
    for maxp in (16, 54):
        assert fb.fusable_paged(8, 768, 12, 161, 16, maxp, cache_itemsize=2)
    for maxp in (55, 64):
        assert not fb.fusable_paged(8, 768, 12, 161, 16, maxp, cache_itemsize=2)
        assert fb.fusable_paged_dma(8, 768, 12, 161, 16, maxp, cache_itemsize=2)
    assert fb._paged_smem(768, 12, 864, 2) <= fb._SMEM_LIMIT < fb._paged_smem(768, 12, 880, 2)
    assert fb._dma_tile_pages(768, 12, 16, 1024, 2, 2) == 32     # 512 bf16 key rows a slot
    assert not fb.fusable_paged(8, 768, 12, 161, 16, 16, cache_itemsize=8)
    assert not fb.fusable_paged_dma(8, 768, 12, 161, 16, 64, cache_itemsize=8)


# K7's shared memory at GPT-2 small (D 768, 12 heads, hd 64, page 16), by
# (L, pool itemsize, depth): the larger of the staged activation tile (8
# rows of 4D f32: 98304 bytes) and the ring (depth slots of 1024 / itemsize
# key rows, 64 KB at hd 64 in either dtype: 16 pages of f32, 32 of bf16) +
# q + the score row + the P.V scratch + the item order (4 * (64 + L + 1280)
# bytes), then one 8-byte mbarrier a slot. Whole slots fit everywhere, so
# every shape is fusable.
_K7_SMEM = {
    (256, 4, 1): 98312, (256, 4, 2): 137488, (256, 4, 3): 203032,
    (512, 4, 1): 98312, (512, 4, 2): 138512, (512, 4, 3): 204056,
    (1024, 4, 1): 98312, (1024, 4, 2): 140560, (1024, 4, 3): 206104,
    (256, 2, 1): 98312, (256, 2, 2): 137488, (256, 2, 3): 203032,
    (512, 2, 1): 98312, (512, 2, 2): 138512, (512, 2, 3): 204056,
    (1024, 2, 1): 98312, (1024, 2, 2): 140560, (1024, 2, 3): 206104,
}


@pytest.mark.parametrize("L,itemsize,depth", sorted(_K7_SMEM))
def test_streamed_kernel_gates_at_gpt2_small(L, itemsize, depth):
    """K7's Python gates (the mirrors of ``mx_paged_dma_tile_pages`` and
    ``mx_paged_dma_smem``) at GPT-2 small's shapes, f32 and bf16 pools,
    ring depth 1-3: the stated pages a slot, shared-memory bytes and
    acceptance."""
    ps, maxp = 16, L // 16
    tp = 1024 // itemsize // ps
    assert fb._dma_tile_pages(768, 12, ps, L, depth, itemsize) == tp
    assert fb._paged_dma_smem(768, 12, ps, L, depth, itemsize) == _K7_SMEM[L, itemsize, depth]
    ring = depth * tp * ps * 64 * itemsize + 4 * (64 + L + 5 * 256)
    assert _K7_SMEM[L, itemsize, depth] == max(98304, ring) + 8 * depth
    assert fb.fusable_paged_dma(8, 768, 12, 161, ps, maxp, cache_itemsize=itemsize,
                                depth=depth)


def test_weight_operands_follow_their_sources(nets):
    """The block kernels' operands are formed once per source tensor: a
    second call returns the kept operands, and a source written in place
    or replaced by another tensor (equal values, or a bf16 bias) forms
    them again from what the pack now holds."""
    _, tnet = nets
    pack = dict(fb.pack_gpt_block(tnet.blocks[0], eps=tnet.cfg.layer_norm_eps))
    ops, lane = fb._weight_operands(pack, "test")
    assert fb._weight_operands(pack, "test")[0] is ops
    assert lane == (0, 0) and len(ops) == 16
    g1, b1 = pack["ln1"]
    pack["ln1"] = (g1.clone(), b1)
    again = fb._weight_operands(pack, "test")[0]
    assert again is not ops and torch.equal(again[12], g1)
    w, s, b = pack["qkv"]
    wide = b.detach().clone()
    pack["qkv"] = (w, s, wide.bfloat16())
    conv = fb._weight_operands(pack, "test")[0]
    assert conv[2].dtype == torch.float32
    assert torch.equal(conv[2], wide.bfloat16().float())
    assert fb._weight_operands(pack, "test")[0] is conv
    with torch.no_grad():
        pack["qkv"][2].add_(1)
    written = fb._weight_operands(pack, "test")[0]
    assert written is not conv
    assert torch.equal(written[2], (wide.bfloat16() + 1).float())
