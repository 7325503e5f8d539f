"""Port parity of the int4 weight-only serving slice: ``quantize_net(bits=4)``
tables, K4 (``int4_weight_matmul``) and the int4 weight lanes of K5, K6, K7
and K8, each plain version against the JAX package's reference and its
interpret-mode Pallas kernel, and the port's engines on an int4 GPT against
JAX ``generate()``. All on the CPU, where every kernel wrapper takes its
plain version; the CUDA kernels are held against those plain versions in
``tests/test_torch_cuda_kernels.py``."""
from types import SimpleNamespace

import numpy as onp
import pytest
import torch

import jax.numpy as jnp
import mxnet_tpu as mx
from mxnet_tpu import np as mnp
from mxnet_tpu.contrib.quantization import quantize_net as jax_quantize_net
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.kvstore import quant as jquant
from mxnet_tpu.models import GPTModel as JaxGPT
from mxnet_tpu.models import generate as jax_generate
from mxnet_tpu.models.gpt import GPTConfig as JaxGPTConfig
from mxnet_tpu.ops import fused_block_gemv as jfb
from mxnet_tpu.ops import int8_gemv as jgemv

from mxnet_tpu_torch import _build
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.contrib.quantization import QuantizedDense, quantize_net
from mxnet_tpu_torch.gluon.nn import Dense
from mxnet_tpu_torch.interop import params_from_numpy
from mxnet_tpu_torch.models import GPTConfig, GPTModel, generate
from mxnet_tpu_torch.models import generation as gen
from mxnet_tpu_torch.ops import fused_block_gemv as fb
from mxnet_tpu_torch.ops import int8_gemv
from mxnet_tpu_torch.ops.fused_block_gemv import pad_vocab
from mxnet_tpu_torch.ops.int8_gemv import count_launches, launches, reset_launches
from mxnet_tpu_torch.serve import InferenceEngine

MAXPOS = 64


def _pair(vocab=256, hidden=256, heads=4, layers=2, perturb=False):
    """A JAX GPT and the port's GPT holding the same seeded weights, not
    yet quantized. ``perturb``: N(0, 0.1) weights (LayerNorm gains about
    1), so that greedy decoding of the tiny model wanders over the vocab."""
    cfg = dict(vocab_size=vocab, hidden_size=hidden, num_layers=layers,
               num_heads=heads, max_position_embeddings=MAXPOS, dropout=0.0)
    mx.random.seed(0)
    jnet = JaxGPT(JaxGPTConfig(**cfg))
    jnet.initialize()
    jnet(mnp.array(onp.zeros((1, 4), "int32")))
    if perturb:
        rng = onp.random.RandomState(0)
        for name, p in jnet.collect_params().items():
            base = 1.0 if name.endswith("gamma") else 0.0
            p.set_data(mnp.array((base + 0.1 * rng.randn(*p.shape)).astype("float32")))
    named = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    tnet = GPTModel(GPTConfig(**cfg), device="cpu")
    params_from_numpy(tnet, named)
    return jnet, tnet


def _int4_pair(**kw):
    jnet, tnet = _pair(**kw)
    jax_quantize_net(jnet, calib_mode="none", bits=4)
    quantize_net(tnet, bits=4)
    return jnet, tnet


@pytest.fixture(scope="module")
def nets():
    """``tests/test_fused_decode.py``'s net256_int4 (vocab 256, hidden 256,
    4 heads, 2 layers, ``bits=4``) and the port's GPT with its weights."""
    return _int4_pair()


@pytest.fixture(scope="module")
def served():
    """The perturbed int4 pair with fused decode, for the engines."""
    jnet, tnet = _pair(perturb=True)
    jax_quantize_net(jnet, calib_mode="none", bits=4, fused_decode=True)
    quantize_net(tnet, bits=4, fused_decode=True)
    return jnet, tnet


@pytest.fixture
def pallas_load_store(monkeypatch):
    """jax 0.9 dropped ``pl.load``/``pl.store``, which the JAX block kernels
    still call; alias them to the ref indexing they performed while a test
    runs the kernels in interpret mode."""
    from jax.experimental import pallas as pl

    def _store(ref, idx, val):
        ref[idx] = val

    monkeypatch.setattr(pl, "load", lambda ref, idx: ref[idx], raising=False)
    monkeypatch.setattr(pl, "store", _store, raising=False)


# ------------------------------------------------------------ quantize_net
@pytest.mark.parametrize("vocab", [256, 251])
def test_int4_tables_bitwise(vocab):
    """Every Dense layer's packed table and block scales, and the
    vocab-padded tied head, equal the JAX package's ``bits=4`` tables bit
    for bit; the head's pad rows are all-zero blocks (bytes 0x88, scale
    1.0), so they dequantize to exact zeros."""
    jnet, tnet = _int4_pair(vocab=vocab)
    for jblk, tblk in zip(jnet.blocks, tnet.blocks):
        for name in ("attn_qkv", "attn_out", "mlp_fc", "mlp_proj"):
            jq, tq = getattr(jblk, name), getattr(tblk, name)
            assert tq.w_q.dtype == torch.uint8, name
            N, K = tq.inner.weight.shape
            assert tq.w_q.shape == (N, K // 2) and tq.w_scale.shape == (N, K // 128)
            assert (onp.asarray(jq._w_q) == tq.w_q.numpy()).all(), name
            assert (onp.asarray(jq._w_scale) == tq.w_scale.numpy()).all(), name
    jw, js, jv = jnet._q_lm_head
    tw, ts, tv = tnet.head_weights()
    Vp = pad_vocab(vocab)
    assert jv == tv == vocab and tw.shape == (Vp, 128) and ts.shape == (Vp, 2)
    assert (onp.asarray(jw) == tw.numpy()).all()
    assert (onp.asarray(js) == ts.numpy()).all()
    assert (tw[vocab:] == 0x88).all() and (ts[vocab:] == 1.0).all()
    deq = int8_gemv._reference_int4_matmul(torch.eye(256), tw, ts).T
    assert (deq[vocab:] == 0).all()


def test_odd_input_dim_keeps_int8():
    """A Dense whose input dim is odd cannot pack nibble pairs: under
    ``bits=4`` it keeps int8 while its even-K sibling packs, and both
    tables equal the JAX package's."""
    mx.random.seed(0)
    jnet = jnn.HybridSequential()
    jnet.add(jnn.Dense(64, in_units=47), jnn.Dense(10, in_units=64))
    jnet.initialize()
    tnet = torch.nn.Sequential(Dense(64, 47), Dense(10, 64))
    with torch.no_grad():
        for i in range(2):
            tnet[i].weight.copy_(torch.from_numpy(jnet[i].weight.data().asnumpy()))
            tnet[i].bias.copy_(torch.from_numpy(jnet[i].bias.data().asnumpy()))
    jax_quantize_net(jnet, calib_mode="none", bits=4)
    quantize_net(tnet, bits=4)
    assert tnet[0].w_q.dtype == torch.int8 and tnet[0].w_q.shape == (64, 47)
    assert tnet[1].w_q.dtype == torch.uint8 and tnet[1].w_q.shape == (10, 32)
    assert tnet[1].w_scale.shape == (10, 1)                # K 64: one block of 64
    for i in range(2):
        assert (tnet[i].w_q.numpy() == onp.asarray(jnet[i]._w_q)).all()
        assert (tnet[i].w_scale.numpy() == onp.asarray(jnet[i]._w_scale)).all()


def test_quantize_net_bits():
    """``bits`` takes 8 and 4 only, as in the JAX package."""
    _, tnet = _pair(layers=1)
    for bits in (3, 5, 16):
        with pytest.raises(MXNetError, match="bits"):
            quantize_net(tnet, bits=bits)
    assert isinstance(quantize_net(tnet, bits=4).blocks[0].attn_qkv, QuantizedDense)


# ------------------------------------------------------------ K4
def _int4_operands(M, N, K, seed=0):
    """x and the codec's packed table of an N(0, 1) weight (block 128, or
    K where 128 does not tile it)."""
    rng = onp.random.RandomState(seed)
    w = rng.randn(N, K).astype("float32")
    block = 128 if K % 128 == 0 else K
    codes, scales = jquant.quantize_blocks(jnp.asarray(w.reshape(-1)), 4, block)
    w_p = onp.asarray(jquant.pack_codes(codes, 4)).reshape(N, K // 2)
    w_s = onp.asarray(scales).reshape(N, K // block)
    return rng.randn(M, K).astype("float32"), w_p, w_s


@pytest.mark.parametrize("M", [1, 8, 64])
@pytest.mark.parametrize("N,K", [(768, 256), (256, 1024), (384, 96)])
def test_plain_k4_matches_jax(M, N, K):
    """The plain K4 against the JAX package's codec fallback: the same
    dequantized weights, f32 sums in another order, so 1e-5 of the output
    scale."""
    x, w_p, w_s = _int4_operands(M, N, K)
    want = onp.asarray(jgemv.int4_weight_matmul(*map(jnp.asarray, (x, w_p, w_s))))
    with count_launches() as tally:
        got = int8_gemv.int4_weight_matmul(*map(torch.from_numpy, (x, w_p, w_s))).numpy()
    assert tally == {"gemv_int4": 1}
    assert got.shape == (M, N) and got.dtype == onp.float32
    assert onp.abs(got - want).max() <= 1e-5 * onp.abs(want).max()


def test_plain_k4_matches_jax_kernel_in_interpret_mode():
    """The plain K4 against ``int4_weight_matmul``'s real Pallas kernel in
    interpret mode: that kernel rounds x and the dequantized weights to
    bf16 for the MXU, so the limit is the JAX package's own 5e-2 of the
    output scale."""
    x, w_p, w_s = _int4_operands(3, 384, 256)
    want = onp.asarray(jgemv.int4_weight_matmul(*map(jnp.asarray, (x, w_p, w_s)),
                                                interpret=True))
    got = int8_gemv.int4_weight_matmul(*map(torch.from_numpy, (x, w_p, w_s))).numpy()
    assert onp.abs(got - want).max() / onp.abs(want).max() < 5e-2


def test_k4_cpu_never_builds_and_bad_operands_raise(monkeypatch):
    def no_build(*_a, **_k):
        raise AssertionError("the CPU path must not build kernels")
    monkeypatch.setattr(_build, "library", no_build)
    monkeypatch.setattr(_build, "build_all", no_build)
    x, w_p, w_s = (torch.from_numpy(a) for a in _int4_operands(2, 32, 256))
    int8_gemv.int4_weight_matmul(x, w_p, w_s)
    with pytest.raises(MXNetError, match="disagree"):
        int8_gemv.int4_weight_matmul(x, w_p[:, :64], w_s)
    with pytest.raises(MXNetError, match="disagree"):
        int8_gemv.int4_weight_matmul(x, w_p, w_s[:, :1].repeat(1, 3))
    with pytest.raises(MXNetError, match="uint8"):
        int8_gemv.int4_weight_matmul(x, w_p.to(torch.int8), w_s)
    assert int8_gemv.int4_chunks_fit(768, 128) and int8_gemv.int4_chunks_fit(96, 96)
    assert not int8_gemv.int4_chunks_fit(768, 8) and not int8_gemv.int4_chunks_fit(40, 40)


@pytest.mark.parametrize("rows", [65, 96])
def test_large_m_forward_matches_jax(nets, rows):
    """Past 64 rows an int4 layer dequantizes its table through the codec
    and runs the f32 matmul, as the JAX package does: within 1e-5 of JAX's
    output scale, and within 1e-5 of the GEMV route on the same rows."""
    jnet, tnet = nets
    x = onp.random.RandomState(rows).randn(1, rows, 256).astype("float32")
    for name in ("attn_qkv", "mlp_fc"):
        want = getattr(list(jnet.blocks)[0], name)(mnp.array(x)).asnumpy()
        layer = getattr(tnet.blocks[0], name)
        with torch.no_grad(), count_launches() as tally:
            got = layer(torch.from_numpy(x)).numpy()
            small = layer(torch.from_numpy(x[:, :8])).numpy()
        assert tally == {"gemv_int4": 1}                   # only the 8-row call
        assert got.shape == want.shape
        assert onp.abs(got - want).max() <= 1e-5 * onp.abs(want).max(), name
        assert onp.abs(got[:, :8] - small).max() <= 1e-5 * onp.abs(small).max()


# ------------------------------------------------------------ K5, K6, K7 int4 lanes
def _decode_inputs():
    """test_pallas_kernels_int4_interpret_parity's contiguous decode step."""
    rng = onp.random.RandomState(0)
    B, D, H, L = 3, 256, 4, 16
    x = rng.randn(B, 1, D).astype("float32")
    kc = (rng.randn(B, H, L, D // H) * 0.1).astype("float32")
    vc = (rng.randn(B, H, L, D // H) * 0.1).astype("float32")
    return x, onp.array([3, 5, 2], "int32"), kc, vc


def _paged_inputs(D=256, H=4, B=3, ps=4, maxp=4, pool=10):
    """``tests/test_fused_decode.py:_paged_fixture``: scattered physical
    pages, rows at mixed depths, unleased entries on the sink."""
    rng = onp.random.RandomState(0)
    x = rng.randn(B, 1, D).astype("float32")
    kp = (rng.randn(pool + 1, H, ps, D // H) * 0.1).astype("float32")
    vp = (rng.randn(pool + 1, H, ps, D // H) * 0.1).astype("float32")
    bt = onp.full((B, maxp), pool, onp.int32)
    bt[0, :2] = [3, 7]
    bt[1, :3] = [0, 5, 2]
    bt[2, :1] = [9]
    return x, onp.array([5, 9, 2], "int32"), bt, kp, vp


def _packs(jnet, tnet):
    jpack = jfb.pack_gpt_block(list(jnet.blocks)[0], eps=jnet.cfg.layer_norm_eps)
    tpack = fb.pack_gpt_block(tnet.blocks[0], eps=tnet.cfg.layer_norm_eps)
    assert jfb._consts(jpack)[0].dtype == jnp.uint8 and tpack["blocks"] == (128,) * 4
    return jfb._consts(jpack), jpack["eps"], tpack


def _hold(out, new, old, written, want):
    """The block output within 1e-4 of ``want[0]``; the cache or pool rows
    outside ``written`` bitwise unchanged in both; written rows within
    1e-5 (the qkv values, f32 sums in another order)."""
    want = [onp.asarray(a) for a in want]
    assert onp.abs(out.numpy() - want[0]).max() < 1e-4
    for got, exp, prev in zip(new, want[1:], old):
        got = got.numpy()
        assert (got[~written] == prev[~written]).all()
        assert (exp[~written] == prev[~written]).all()
        assert onp.abs(got[written] - exp[written]).max() < 1e-5


def test_plain_int4_block_decode_matches_jax(nets, pallas_load_store):
    """The plain int4 K5 against ``_reference_block_decode`` and the real
    ``_pallas_block_decode`` in interpret mode, on int4 consts."""
    jnet, tnet = nets
    consts, eps, tpack = _packs(jnet, tnet)
    x, pos, kc, vc = _decode_inputs()
    args = tuple(map(jnp.asarray, (x, pos, kc, vc))) + (consts, 4, eps)
    wants = [jfb._reference_block_decode(*args),
             jfb._pallas_block_decode(*args, interpret=True)]
    with torch.no_grad():
        out, tkc, tvc = fb._reference_block_decode(*map(torch.from_numpy, (
            x, pos, kc.copy(), vc.copy())), tpack)
    written = onp.zeros(kc.shape, bool)
    for b, p in enumerate(pos):
        written[b, :, p] = True
    for want in wants:
        _hold(out, (tkc, tvc), (kc, vc), written, want)


@pytest.mark.parametrize("kernel", ["reference", "paged", "paged_dma"])
def test_plain_int4_paged_block_decode_matches_jax(nets, pallas_load_store, kernel):
    """The plain int4 K6/K7 against JAX's paged reference and its two
    interpret-mode paged kernels (gathered, streamed); the sink page is
    written by unleased rows and never compared."""
    jnet, tnet = nets
    consts, eps, tpack = _packs(jnet, tnet)
    x, pos, bt, kp, vp = _paged_inputs()
    args = tuple(map(jnp.asarray, (x, pos, bt, kp, vp))) + (consts, 4, eps)
    fn = {"reference": jfb._reference_block_decode_paged,
          "paged": lambda *a: jfb._pallas_block_decode_paged(*a, interpret=True),
          "paged_dma": lambda *a: jfb._pallas_block_decode_paged_dma(*a, interpret=True)}
    want = fn[kernel](*args)
    with torch.no_grad():
        out, tk, tv = fb._reference_block_decode_paged(*map(torch.from_numpy, (
            x, pos, bt, kp.copy(), vp.copy())), tpack)
    written = onp.zeros(kp.shape, bool)
    for b, p in enumerate(pos):
        written[bt[b, p // 4], :, p % 4] = True
    sink = onp.zeros(kp.shape, bool)
    sink[10] = True
    want = [onp.asarray(a) for a in want]
    want[1] = onp.where(sink, kp, want[1])             # either sink write may win
    want[2] = onp.where(sink, vp, want[2])
    _hold(out, (torch.where(torch.from_numpy(sink), torch.from_numpy(kp), tk),
                torch.where(torch.from_numpy(sink), torch.from_numpy(vp), tv)),
          (kp, vp), written, want)


def test_fused_int4_block_equals_unfused_on_cpu(nets):
    """On a CPU tensor the fused int4 block step replays the unfused op
    sequence (K4's plain version for every GEMV): output and caches bitwise
    the unfused block's, under the ``fused_block_int4`` launch kind."""
    _, tnet = nets
    x, pos, kc, vc = _decode_inputs()
    blk = tnet.blocks[0]
    pack = fb.pack_gpt_block(blk, eps=tnet.cfg.layer_norm_eps)
    t = [torch.from_numpy(a) for a in (x, pos)]
    with torch.no_grad(), count_launches() as tally:
        got = fb.fused_block_decode(*t, torch.from_numpy(kc.copy()),
                                    torch.from_numpy(vc.copy()), pack)
    assert tally == {"fused_block_int4": 1}
    with torch.no_grad(), count_launches() as tally:
        want = blk.forward_cached(*t, torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy()))
    assert tally == {"gemv_int4": 4}
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_mixed_block_declines_the_pack():
    """A block mixing int4 and int8 layers (an odd-K layer kept int8 under
    ``bits=4``) cannot stream one weight lane: no pack, the block keeps
    the unfused path."""
    _, t4 = _int4_pair(hidden=128, layers=1)
    _, t8 = _pair(hidden=128, layers=1)
    quantize_net(t8)
    b4, b8 = t4.blocks[0], t8.blocks[0]
    assert fb.pack_gpt_block(b4, eps=1e-5)["blocks"] == (128,) * 4
    assert fb.pack_gpt_block(b8, eps=1e-5)["blocks"] == ()
    mixed = SimpleNamespace(attn_qkv=b4.attn_qkv, attn_out=b8.attn_out, mlp_fc=b4.mlp_fc,
                            mlp_proj=b4.mlp_proj, ln_1=b4.ln_1, ln_2=b4.ln_2, heads=b4.heads)
    assert fb.pack_gpt_block(mixed, eps=1e-5) is None


def test_int4_lane_gate():
    """The int4 lane's tiling rule: a lane reads 16 codes, which must lie in
    one scale block, and the K = D matrices share one block."""
    assert fb.fusable(8, 768, 12, 1024, (128,) * 4)
    assert fb.fusable(3, 48, 3, 16, (48, 48, 48, 64))
    assert not fb.fusable(8, 768, 12, 1024, (8, 8, 8, 8))
    assert not fb.fusable(8, 768, 12, 1024, (128, 256, 128, 128))
    assert fb.fusable_paged(16, 768, 12, 129, 16, 16, blocks=(128,) * 4)
    assert not fb.fusable_paged(16, 768, 12, 129, 16, 16, blocks=(24,) * 4)
    assert fb.fusable_paged_dma(8, 768, 12, 161, 16, 64, blocks=(128,) * 4)
    assert not fb.fusable_paged_dma(8, 768, 12, 161, 16, 64, blocks=(8,) * 4)


# ------------------------------------------------------------ K8 int4 lane
@pytest.mark.parametrize("temp", [0.0, 0.8])
def test_plain_int4_head_sampler_matches_jax_kernel(nets, temp):
    """The plain int4 K8 against the real ``_head_kernel`` in interpret mode
    on the packed table, given the same key bits: identical tokens for
    greedy and T = 0.8 rows; greedy rows are also the argmax of K4's
    logits."""
    jnet, tnet = nets
    w_q, scale, V = jnet._q_lm_head
    rng = onp.random.RandomState(4)
    B = 6
    h = rng.randn(B, 256).astype("float32")
    kb = gen._key_bits(onp.arange(B) + 11, onp.full(B, 3))
    temps = onp.full(B, temp, "float32")
    want = onp.asarray(jfb._head_kernel(jnp.asarray(h), w_q, scale, V, jnp.asarray(temps),
                                        jnp.asarray(kb.astype(onp.uint32)), interpret=True))
    tw, ts, tv = tnet.head_weights()
    with count_launches() as tally:
        got = fb.fused_lm_head_sample(torch.from_numpy(h), tw, ts, tv, torch.from_numpy(kb),
                                      torch.from_numpy(temps)).numpy()
    assert tally == {"fused_head_int4": 1}
    assert (got == want).all() and (got < V).all()
    if temp == 0.0:
        logits = int8_gemv.int4_weight_matmul(torch.from_numpy(h), tw, ts)
        assert (got == logits[:, :V].argmax(-1).numpy()).all()


def test_int4_head_operands_checked(nets):
    _, tnet = nets
    tw, ts, tv = tnet.head_weights()
    h, kb = torch.zeros(2, 256), torch.zeros(2, dtype=torch.int64)
    with pytest.raises(MXNetError, match="int4 table"):
        fb.fused_lm_head_sample(h, tw, ts[:, :1].repeat(1, 3), tv, kb, torch.zeros(2))
    with pytest.raises(MXNetError, match="int4 table"):
        fb.fused_lm_head_sample(h, tw[:, :64], ts, tv, kb, torch.zeros(2))


# ------------------------------------------------------------ the slice end to end
@pytest.mark.parametrize("vocab,hidden,heads", [(251, 48, 4), (256, 256, 4)])
def test_int4_fused_generate_bitwise(vocab, hidden, heads):
    """``enable_fused_decode`` on an int4 model is bitwise invisible on the
    CPU, at a fusable shape and at one the gates decline (hd 12 at D 48:
    those blocks keep the unfused layers; 251 pads the vocab)."""
    _, tnet = _int4_pair(vocab=vocab, hidden=hidden, heads=heads)
    p = torch.from_numpy(onp.random.RandomState(1).randint(0, vocab, (2, 5)).astype("int32"))
    ref = generate(tnet, p, 8)
    assert tnet.enable_fused_decode() == 2
    with count_launches() as tally:
        got = generate(tnet, p, 8)
    assert torch.equal(got, ref)
    blocks = tnet.blocks[0]._fused_pack["blocks"]
    fused = 2 * 7 if fb.fusable(2, hidden, heads, MAXPOS, blocks) else 0
    assert tally.get("fused_block_int4", 0) == fused and "gemv" not in tally
    tnet.disable_fused_decode()
    assert torch.equal(generate(tnet, p, 8), ref)


def test_int4_decode_step_launch_tally(served):
    """One decode substep of the fused int4 model: one ``fused_block_int4``
    per block and one ``fused_head_int4`` (the 13-launch shape of the int8
    step, with the int4 kinds), and no int8 kind."""
    _, tnet = served
    caches = tnet.new_caches(4, MAXPOS)
    tok = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
    with count_launches() as tally:
        gen.decode_multi_tokens(tnet, tok, 0, caches, 1, [0.0] * 4, [0] * 4, [0] * 4,
                                head=tnet.head_weights())
    assert tally == {"fused_block_int4": 2, "fused_head_int4": 1}


def _jax_tokens(jnet, prompts, new, multi_token):
    """JAX ``generate()`` per prompt (prompts of one length batched)."""
    out = {}
    for n in sorted({len(p) for p in prompts}):
        idx = [i for i, p in enumerate(prompts) if len(p) == n]
        got = jax_generate(jnet, mnp.array(onp.asarray([prompts[i] for i in idx], "int32")),
                           max(new[i] for i in idx), multi_token=multi_token).asnumpy()
        for r, i in enumerate(idx):
            out[i] = got[r, n:n + new[i]].tolist()
    return [out[i] for i in range(len(prompts))]


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("multi_token", [1, 4])
def test_int4_engine_matches_jax_generate(served, paged, multi_token):
    """Six greedy requests through a 4-slot engine over the int4 GPT,
    contiguous or paged (page 8): tokens equal JAX ``generate()``; every
    decode substep runs each block through the int4 lane of K5 or K6, the
    head through K8's at multi_token 4, and nothing takes an int8 kind."""
    jnet, tnet = served
    rng = onp.random.RandomState(3)
    lengths = [3, 9, 3, 12, 9, 12]
    prompts = [rng.randint(0, 256, n).tolist() for n in lengths]
    new = [10, 7, 12, 5, 9, 11]
    want = _jax_tokens(jnet, prompts, new, multi_token)
    reset_launches()
    eng = InferenceEngine(tnet, max_batch_size=4, max_len=MAXPOS, multi_token=multi_token,
                          paged=paged, page_size=8).start()
    try:
        res = [h.result(timeout=120) for h in [eng.submit(p, n) for p, n in zip(prompts, new)]]
    finally:
        eng.shutdown(drain=True, timeout=120)
    assert all(r.ok for r in res), [r.error for r in res]
    assert [r.generated_ids for r in res] == want
    stats, counts = eng.stats(), launches()
    kind = "fused_block_paged_int4" if paged else "fused_block_int4"
    assert counts[kind] == 2 * stats["decode_substeps"]
    assert counts["gemv_int4"] >= 4 * 2 * 6                 # every prefill
    assert ("fused_head_int4" in counts) == (multi_token > 1)
    assert not {"gemv", "fused_block", "fused_block_paged", "fused_head"} & set(counts)
