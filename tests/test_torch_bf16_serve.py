"""Port parity of the bf16 quantized serving slice: a bf16 GPT quantized
int8 with calibrated activation scales (``calib_mode='naive'`` or
``'entropy'``) or int4 (``calib_mode='none'``), served by ``generate()``
and both engine layouts, against the JAX package on the CPU.

The same numpy weights go into both packages (``interop.params_from_numpy``)
and the same numpy token batches come from a seed. On the CPU every kernel
wrapper takes its plain version; the CUDA lanes are held against those in
``tests/test_torch_cuda_kernels.py``.

Tolerances are sized from bf16's rounding: a bf16 value carries 8
significant bits, so one rounding moves it by at most 2**-8 of its size
and one ulp is at most 2**-7 of it. Where torch and XLA sum a LayerNorm's
statistics in another order, a bf16 rounding can land one ulp apart; the
tests allow that one ulp and no more.
"""
import numpy as onp
import pytest
import torch

import jax.numpy as jnp
import mxnet_tpu as mx
from mxnet_tpu import np as mnp
from mxnet_tpu.contrib import quantization as jq
from mxnet_tpu.models import GPTModel as JaxGPT
from mxnet_tpu.models import generate as jax_generate
from mxnet_tpu.models.gpt import GPTConfig as JaxGPTConfig
from mxnet_tpu.ops import fused_block_gemv as jfb
from mxnet_tpu.ops import int8_gemv as jgemv
from mxnet_tpu.serve import InferenceEngine as JaxEngine

from mxnet_tpu_torch.contrib import quantization as tq
from mxnet_tpu_torch.interop import params_from_numpy
from mxnet_tpu_torch.models import GPTConfig, GPTModel, generate
from mxnet_tpu_torch.ops import fused_block_gemv as fb
from mxnet_tpu_torch.ops import int8_gemv
from mxnet_tpu_torch.ops.int8_gemv import count_launches, launches, reset_launches
from mxnet_tpu_torch.serve import InferenceEngine

VOCAB, HIDDEN, LAYERS, HEADS, MAXPOS = 96, 64, 2, 4, 128
LAYER_NAMES = ("attn_qkv", "attn_out", "mlp_fc", "mlp_proj")
# one rounding to bf16 moves a value by at most this share of its size
BF16_ROUND = 2.0 ** -8


def _bf16_ulp(v):
    """One bf16 ulp of each value of ``v`` (2**-7 of its binade)."""
    v = onp.abs(onp.asarray(v, onp.float64))
    return onp.exp2(onp.floor(onp.log2(onp.maximum(v, 2.0 ** -126))) - 7)


def _pair(dtype="bfloat16", vocab=VOCAB):
    """A JAX GPT and the port's GPT holding the same N(0, 0.1) weights
    (LayerNorm gains about 1), so that greedy decoding of the tiny model
    wanders over the vocab; parameters in ``dtype`` (LayerNorm f32)."""
    cfg = dict(vocab_size=vocab, hidden_size=HIDDEN, num_layers=LAYERS,
               num_heads=HEADS, max_position_embeddings=MAXPOS, dropout=0.0)
    mx.random.seed(0)
    jnet = JaxGPT(JaxGPTConfig(**cfg, dtype=getattr(jnp, dtype)))
    jnet.initialize()
    jnet(mnp.array(onp.zeros((1, 4), "int32")))
    rng = onp.random.RandomState(0)
    for name, p in jnet.collect_params().items():
        base = 1.0 if name.endswith("gamma") else 0.0
        val = (base + 0.1 * rng.randn(*p.shape)).astype("float32")
        p.set_data(mnp.array(val).astype(p.data().dtype))
    named = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    tnet = GPTModel(GPTConfig(**cfg, dtype=getattr(torch, dtype)), device="cpu")
    params_from_numpy(tnet, named)
    return jnet, tnet


def _calib_batches(n=2, seed=0, vocab=VOCAB):
    rng = onp.random.RandomState(seed)
    return [rng.randint(0, vocab, (8, 32)).astype("int32") for _ in range(n)]


def _quantized(dtype, calib_mode, bits=8):
    """The pair quantized alike, with fused decode."""
    jnet, tnet = _pair(dtype)
    kw = dict(calib_mode=calib_mode, bits=bits, fused_decode=True)
    if calib_mode != "none":
        batches = _calib_batches()
        jq.quantize_net(jnet, calib_data=[mnp.array(b) for b in batches], **kw)
        tq.quantize_net(tnet, calib_data=batches, **kw)
    else:
        jq.quantize_net(jnet, **kw)
        tq.quantize_net(tnet, **kw)
    return jnet, tnet


@pytest.fixture(scope="module")
def naive():
    """The bf16 pair quantized int8 with naive calibration."""
    return _quantized("bfloat16", "naive")


@pytest.fixture(scope="module")
def int4():
    """The bf16 pair quantized int4 (dynamic scales, as ``bench.py``)."""
    return _quantized("bfloat16", "none", bits=4)


def _layers(net, torch_side):
    blocks = net.blocks if torch_side else list(net.blocks)
    return [getattr(b, n) for b in blocks for n in LAYER_NAMES]


# ------------------------------------------------------------ the >64-row repair
@pytest.mark.parametrize("frozen", [False, True], ids=["dynamic", "frozen"])
@pytest.mark.parametrize("rows", [65, 96])
def test_bf16_activation_quantized_rows_match_jax(frozen, rows):
    """A bf16 input of more than 64 rows takes the activation-quantized
    int8 product: ``x / s_x`` is divided in f32, as JAX's f32 scale
    promotes the bf16 input, so the int8 codes are the JAX package's, with
    the dynamic scale and with a frozen one (torch's 0-dim f32 scale would
    leave the division in bf16 and pick other codes). The outputs agree
    within one f32 ulp of their scale: XLA on the CPU fuses the rescale
    and the bf16 bias into one multiply-add, which rounds once where the
    port rounds twice. One code apart would move an output by s_x *
    w_scale (about 1e-5 here), far past that."""
    jnet, tnet = _pair()
    jq.quantize_net(jnet, calib_mode="none")
    tq.quantize_net(tnet)
    x = onp.random.RandomState(rows).randn(1, rows, HIDDEN).astype("float32")
    xb = mnp.array(x).astype(jnp.bfloat16)
    for name in ("attn_qkv", "mlp_fc"):
        jl, tl = getattr(list(jnet.blocks)[0], name), getattr(tnet.blocks[0], name)
        if frozen:
            jl._act_scale = tl._act_scale = 0.0123
        want = jl(xb).asnumpy()
        with torch.no_grad():
            got = tl(torch.from_numpy(x).to(torch.bfloat16)).numpy()
        assert got.dtype == want.dtype == onp.float32
        ulp = 2.0 ** (onp.floor(onp.log2(onp.abs(want).max())) - 23)
        assert onp.abs(got - want).max() <= ulp, name


# ------------------------------------------------------------ calibration
@pytest.mark.parametrize("n,bins", [(2048, 255), (600, 255), (2048, 128)])
def test_optimal_kl_threshold_bitwise(n, bins):
    """The port's copy of ``optimal_kl_threshold`` returns JAX's threshold
    exactly, on skewed and on sparse histograms."""
    rng = onp.random.RandomState(n + bins)
    for hist in (onp.floor(rng.exponential(50.0, n) * onp.exp(-onp.arange(n) / 300.0)),
                 onp.where(rng.rand(n) < 0.1, rng.randint(0, 40, n), 0).astype("int64")):
        edges = onp.linspace(0, 3.7, n + 1)[1:]
        assert tq.optimal_kl_threshold(hist, edges, bins) == \
            jq.optimal_kl_threshold(hist, edges, bins)


def test_calibrator_bitwise():
    """``_Calibrator`` observes the same arrays as JAX's: the same running
    abs-max, histogram (counts and dtype, through every re-binning as the
    range grows) and edges, and the same naive and entropy thresholds."""
    rng = onp.random.RandomState(5)
    jc, tc = jq._Calibrator(), tq._Calibrator()
    for scale in (1.0, 0.5, 2.5, 2.5, 4.0):
        x = (rng.randn(16, 64) * scale).astype("float32")
        jc.observe(x)
        tc.observe(x)
        assert tc.amax == jc.amax
        assert tc.hist.dtype == jc.hist.dtype and (tc.hist == jc.hist).all()
        assert (tc.edges == jc.edges).all()
    for mode in ("naive", "entropy"):
        assert tc.threshold(mode) == jc.threshold(mode)


def _observed(monkeypatch, dtype, calib_mode):
    """Quantize the pair with calibration, recording every array each
    package's calibrators observe (in layer order: block 0's qkv, out, fc,
    proj, then block 1's). Returns (jnet, tnet, JAX's arrays, the port's)."""
    seen = {"jax": [], "port": []}
    for mod, key in ((jq, "jax"), (tq, "port")):
        orig = mod._Calibrator.observe

        def observe(self, x, orig=orig, key=key):
            seen[key].append(onp.array(x, onp.float32))
            return orig(self, x)
        monkeypatch.setattr(mod._Calibrator, "observe", observe)
    jnet, tnet = _quantized(dtype, calib_mode)
    n = len(LAYER_NAMES) * LAYERS
    assert len(seen["jax"]) == len(seen["port"]) == 2 * n     # two batches
    return jnet, tnet, seen["jax"], seen["port"]


@pytest.mark.parametrize("calib_mode", ["naive", "entropy"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_act_scales_from_jax_observations_bitwise(monkeypatch, dtype, calib_mode):
    """The port's observe -> freeze lifecycle, fed the activations JAX's
    layers observed, freezes every layer's ``_act_scale`` to JAX's exactly:
    the histograms, re-binnings and KL search are the same numpy
    arithmetic."""
    jnet, tnet, jseen, _ = _observed(monkeypatch, dtype, calib_mode)
    n = len(LAYER_NAMES) * LAYERS
    for i, (jl, tl) in enumerate(zip(_layers(jnet, False), _layers(tnet, True))):
        fresh = tq.QuantizedDense(tl.inner)
        fresh.begin_observe()
        for batch in (0, 1):
            fresh._calib.observe(jseen[batch * n + i])
        fresh.freeze(calib_mode)
        assert fresh._mode == jl._mode == "frozen"
        assert fresh._act_scale == jl._act_scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_naive_act_scales_on_model(monkeypatch, dtype):
    """Through the models' own forwards. bf16: the observed activations are
    bf16, and each layer's abs-max, hence ``_act_scale * 127``, is within
    one bf16 ulp of JAX's. f32: torch and XLA sum LayerNorm statistics and
    products in other orders; a sum of 64 terms (K = 64 here) taken in
    another order moves by up to 64 roundings of 2**-24, so the abs-max is
    held within 2**-18 of its size."""
    jnet, tnet, _, _ = _observed(monkeypatch, dtype, "naive")
    for jl, tl in zip(_layers(jnet, False), _layers(tnet, True)):
        t_thr, j_thr = tl._act_scale * 127.0, jl._act_scale * 127.0
        tol = _bf16_ulp(j_thr) if dtype == "bfloat16" else 2.0 ** -18 * j_thr
        assert abs(t_thr - j_thr) <= tol


def test_entropy_act_scales_on_bf16_model(monkeypatch):
    """Through the models' own forwards on a bf16 GPT: every layer whose
    observed bf16 activations are JAX's bit for bit freezes JAX's entropy
    scale exactly (block 0's qkv layer, the LayerNorm of the embedding sum,
    is one). Where a few activations of a layer's input lie an ulp or more
    apart (attention sums its f32 scores and products in another order,
    and later layers carry the difference), the KL-optimal bin of a bf16
    histogram can move by many bins; those layers are held only through
    ``test_act_scales_from_jax_observations_bitwise``."""
    jnet, tnet, jseen, tseen = _observed(monkeypatch, "bfloat16", "entropy")
    n = len(LAYER_NAMES) * LAYERS
    same = [i for i in range(n)
            if all((jseen[b * n + i] == tseen[b * n + i]).all() for b in (0, 1))]
    assert 0 in same
    layers = list(zip(_layers(jnet, False), _layers(tnet, True)))
    for i in same:
        assert layers[i][1]._act_scale == layers[i][0]._act_scale


def test_calibration_options():
    """Missing ``calib_data`` and unknown modes raise with JAX's messages;
    ``num_calib_batches`` stops the observation early; int4 layers keep
    their weight-only product and still freeze a scale."""
    _, tnet = _pair()
    with pytest.raises(Exception, match="calib_data required for calib_mode='entropy'"):
        tq.quantize_net(tnet, calib_mode="entropy")
    _, tnet = _pair()
    with pytest.raises(Exception, match="unknown calib_mode 'minmax'"):
        tq.quantize_net(tnet, calib_mode="minmax")
    jnet, tnet = _pair()
    batches = _calib_batches(3)
    jq.quantize_net(jnet, calib_mode="naive", calib_data=[mnp.array(b) for b in batches],
                    num_calib_batches=1)
    tq.quantize_net(tnet, calib_mode="naive", calib_data=batches, num_calib_batches=1)
    one = [tl._act_scale for tl in _layers(tnet, True)]
    _, full = _pair()
    tq.quantize_net(full, calib_mode="naive", calib_data=batches)
    assert one != [tl._act_scale for tl in _layers(full, True)]
    for jl, tl in zip(_layers(jnet, False), _layers(tnet, True)):
        assert abs(tl._act_scale - jl._act_scale) * 127.0 <= _bf16_ulp(jl._act_scale * 127.0)


# ------------------------------------------------------------ K3 / K4 on bf16 x
@pytest.mark.parametrize("M", [1, 9, 64])
@pytest.mark.parametrize("bits", [8, 4])
def test_plain_gemv_on_bf16_x_matches_jax(naive, int4, M, bits):
    """The plain K3/K4 on bf16 x (widened, then the f32 product) against the
    JAX package's fallback on the same bf16 x: f32 sums in another order,
    within 1e-5 of the output scale; and equal to the port's f32 call on
    ``x.float()`` bit for bit."""
    jnet, tnet = naive if bits == 8 else int4
    jl, tl = list(jnet.blocks)[0].mlp_fc, tnet.blocks[0].mlp_fc
    x = onp.random.RandomState(M).randn(M, HIDDEN).astype("float32")
    xt = torch.from_numpy(x).to(torch.bfloat16)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    fn = int8_gemv.int8_weight_matmul if bits == 8 else int8_gemv.int4_weight_matmul
    jfn = jgemv.int8_weight_matmul if bits == 8 else jgemv.int4_weight_matmul
    want = onp.asarray(jfn(xj, jl._w_q, jl._w_scale))
    got = fn(xt, tl.w_q, tl.w_scale)
    assert got.dtype == torch.float32 and got.shape == (M, tl.w_q.shape[0])
    assert onp.abs(got.numpy() - want).max() <= 1e-5 * onp.abs(want).max()
    assert torch.equal(got, fn(xt.float(), tl.w_q, tl.w_scale))


# ------------------------------------------------------------ K5 / K6 on bf16
def _bf16(a):
    return torch.from_numpy(onp.asarray(a, "float32")).to(torch.bfloat16)


def _jbf16(a):
    return jnp.asarray(onp.asarray(a, "float32")).astype(jnp.bfloat16)


def _f32(a):
    return onp.asarray(jnp.asarray(a).astype(jnp.float32)) if not torch.is_tensor(a) \
        else a.float().numpy()


def _hold_bf16(out, new, old, written, want):
    """The block output (f32) within one bf16 rounding of its scale: a
    LayerNorm value one bf16 ulp apart moves the output by about that much
    at most. Cache or pool rows outside ``written`` bitwise unchanged in
    both; written rows (bf16) within one bf16 ulp of JAX's."""
    wout = _f32(want[0])
    assert out.dtype == torch.float32
    assert onp.abs(out.numpy() - wout).max() <= BF16_ROUND * onp.abs(wout).max()
    for got, exp, prev in zip(new, want[1:], old):
        got, exp, prev = _f32(got), _f32(exp), _f32(prev)
        assert (got[~written] == prev[~written]).all()
        assert (exp[~written] == prev[~written]).all()
        assert (onp.abs(got[written] - exp[written]) <= _bf16_ulp(exp[written])).all()


def _pack_pair(pair):
    jnet, tnet = pair
    jpack = jfb.pack_gpt_block(list(jnet.blocks)[0], eps=jnet.cfg.layer_norm_eps)
    tpack = fb.pack_gpt_block(tnet.blocks[0], eps=tnet.cfg.layer_norm_eps)
    return jfb._consts(jpack), jpack["eps"], tpack


@pytest.mark.parametrize("lane", ["int8", "int4"])
def test_plain_block_decode_bf16_matches_jax(naive, int4, lane):
    """The plain K5 on bf16 x and bf16 caches (bf16 LayerNorm rounding,
    new rows rounded once to bf16 and read back) against JAX's
    ``_reference_block_decode`` on the same bf16 inputs."""
    consts, eps, tpack = _pack_pair(naive if lane == "int8" else int4)
    rng = onp.random.RandomState(0)
    B, L = 3, 16
    x = rng.randn(B, 1, HIDDEN)
    kc = rng.randn(B, HEADS, L, HIDDEN // HEADS) * 0.1
    vc = rng.randn(B, HEADS, L, HIDDEN // HEADS) * 0.1
    pos = onp.array([3, 15, 0], "int32")
    want = jfb._reference_block_decode(_jbf16(x), jnp.asarray(pos), _jbf16(kc), _jbf16(vc),
                                       consts, HEADS, eps)
    kt, vt = _bf16(kc), _bf16(vc)
    with torch.no_grad(), count_launches() as tally:
        out, tk, tv = fb.fused_block_decode(_bf16(x), torch.from_numpy(pos), kt.clone(),
                                            vt.clone(), tpack)
    assert tally == {"fused_block" + ("_int4" if lane == "int4" else ""): 1}
    assert tk.dtype == torch.bfloat16
    written = onp.zeros(kc.shape, bool)
    for b, p in enumerate(pos):
        written[b, :, p] = True
    _hold_bf16(out, (tk, tv), (kt, vt), written, want)


@pytest.mark.parametrize("lane", ["int8", "int4"])
def test_plain_paged_block_decode_bf16_matches_jax(naive, int4, lane):
    """The plain K6/K7 on bf16 x and bf16 pools against JAX's
    ``_reference_block_decode_paged``: scattered pages, rows at mixed
    depths, unleased entries on the sink page (never compared)."""
    consts, eps, tpack = _pack_pair(naive if lane == "int8" else int4)
    rng = onp.random.RandomState(1)
    B, ps, maxp, pool = 3, 4, 4, 10
    hd = HIDDEN // HEADS
    x = rng.randn(B, 1, HIDDEN)
    kp = rng.randn(pool + 1, HEADS, ps, hd) * 0.1
    vp = rng.randn(pool + 1, HEADS, ps, hd) * 0.1
    bt = onp.full((B, maxp), pool, onp.int32)
    bt[0, :2] = [3, 7]
    bt[1, :3] = [0, 5, 2]
    bt[2, :1] = [9]
    pos = onp.array([5, 9, 2], "int32")
    want = list(jfb._reference_block_decode_paged(
        _jbf16(x), jnp.asarray(pos), jnp.asarray(bt), _jbf16(kp), _jbf16(vp), consts, HEADS,
        eps))
    kt, vt = _bf16(kp), _bf16(vp)
    with torch.no_grad():
        out, tk, tv = fb.fused_block_decode_paged(_bf16(x), torch.from_numpy(pos),
                                                  torch.from_numpy(bt), kt.clone(), vt.clone(),
                                                  tpack)
    written = onp.zeros(kp.shape, bool)
    for b, p in enumerate(pos):
        written[bt[b, p // ps], :, p % ps] = True
    sink = torch.zeros(kp.shape, dtype=torch.bool)
    sink[pool] = True
    want[1] = jnp.where(jnp.asarray(sink.numpy()), _jbf16(kp), want[1])
    want[2] = jnp.where(jnp.asarray(sink.numpy()), _jbf16(vp), want[2])
    _hold_bf16(out, (torch.where(sink, kt, tk), torch.where(sink, vt, tv)), (kt, vt),
               written, want)


def test_bf16_gates_and_k7_ledger_bytes():
    """The block gates take the caches' itemsize (bf16 2, as JAX's gates
    do; f64 pools fit no kernel), and K7's ledger counts bf16 page bytes."""
    assert fb.fusable(8, 768, 12, 1024, cache_itemsize=2)
    assert fb.fusable(8, 768, 12, 1024, (128,) * 4, 2)
    assert not fb.fusable(8, 768, 12, 1024, cache_itemsize=8)
    pos = torch.tensor([0, 17, 40], dtype=torch.int32)
    copies, nbytes = fb._dma_program(pos, 12, 64, 16, 64, 2)
    assert copies == 2 * 12 * (1 + 2 + 3) and nbytes == copies * 16 * 64 * 2


# ------------------------------------------------------------ the slice end to end
def _prompts(lengths, seed):
    rng = onp.random.RandomState(seed)
    return [rng.randint(0, VOCAB, n).tolist() for n in lengths]


def _top2_gap(tnet, tokens):
    """Top-1 minus top-2 logit of the port's model after ``tokens``."""
    ids = torch.tensor([tokens], dtype=torch.int32)
    with torch.no_grad():
        logits = tnet.forward_cached(ids, 0, *tnet.new_caches(1, len(tokens)))[0][0, -1]
    top = torch.topk(logits.float(), 2).values
    return (top[0] - top[1]).item(), top[0].abs().item()


def _hold_tokens(tnet, prompts, got, want):
    """Greedy tokens equal JAX's, or differ first where the top-2 logits lie
    within two bf16 roundings of the top logit (a LayerNorm value one ulp
    apart moves a logit by about one rounding of its size, each side)."""
    for p, g, w in zip(prompts, got, want):
        if g == w:
            continue
        d = next(i for i, (a, b) in enumerate(zip(g, w)) if a != b)
        gap, top = _top2_gap(tnet, list(p) + list(w[:d]))
        assert gap <= 2 * BF16_ROUND * top, (d, gap, top)


@pytest.mark.parametrize("multi_token", [1, 4])
@pytest.mark.parametrize("quant", ["naive_int8", "int4"])
def test_generate_bf16_matches_jax(naive, int4, quant, multi_token):
    """Greedy ``generate()`` of the bf16 model: four prompts of 16 tokens
    prefilled together (64 rows: K3/K4's plain version on block 0's bf16
    LayerNorm rows), then K5's plain version on bf16 caches and, at
    ``multi_token`` 4, K8's plain version on f32 hidden states; held
    against JAX's ``generate()``. (Past 64 rows the activation-quantized
    product takes over; see ``test_generate_bf16_calibrated_prefill``.)"""
    jnet, tnet = naive if quant == "naive_int8" else int4
    ids = onp.asarray(_prompts([16] * 4, seed=2), "int32")
    want = jax_generate(jnet, mnp.array(ids), 16, multi_token=multi_token).asnumpy()
    with count_launches() as tally:
        got = generate(tnet, torch.from_numpy(ids), 16, multi_token=multi_token).numpy()
    sfx = "_int4" if quant == "int4" else ""
    steps = 15 if multi_token == 1 else -(-15 // multi_token) * multi_token
    assert tally["fused_block" + sfx] == LAYERS * steps
    assert (multi_token > 1) == ("fused_head" + sfx in tally)
    _hold_tokens(tnet, ids.tolist(), [g[16:].tolist() for g in got],
                 [w[16:].tolist() for w in want])


def test_generate_bf16_calibrated_prefill(naive, monkeypatch):
    """Four 20-token prompts prefilled together (80 rows): every int8 layer
    of the bf16 model takes the activation-quantized product at its frozen
    calibrated scale (never an in-graph abs-max), and the greedy tokens lie
    in the vocab and repeat. Against JAX they are held only layer by layer
    (``test_bf16_activation_quantized_rows_match_jax``): an input one f32
    rounding apart can land on the neighbouring int8 code, which moves an
    output by a whole code step."""
    _, tnet = naive
    scales = []
    orig = tq.QuantizedDense._input_qscale

    def spy(self, x):
        s = orig(self, x)
        scales.append((float(s), self._act_scale))
        return s
    monkeypatch.setattr(tq.QuantizedDense, "_input_qscale", spy)
    ids = torch.from_numpy(onp.asarray(_prompts([20] * 4, seed=4), "int32"))
    got = generate(tnet, ids, 8, multi_token=4)
    assert len(scales) == len(LAYER_NAMES) * LAYERS
    assert all(s == onp.float32(a) for s, a in scales)
    assert ((got >= 0) & (got < VOCAB)).all()
    assert torch.equal(got, generate(tnet, ids, 8, multi_token=4))


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("quant", ["naive_int8", "int4"])
def test_engine_bf16_matches_jax_generate(naive, int4, quant, paged):
    """Six greedy requests through a 4-slot ``multi_token=4`` engine over
    the bf16 model, contiguous or paged (page 8, bf16 pools): tokens held
    against JAX ``generate()``; every decode substep runs each block
    through K5 or K6 and the head through K8, in the model's lane; the KV
    state is bf16, half the f32 bytes."""
    jnet, tnet = naive if quant == "naive_int8" else int4
    lengths, new = [3, 9, 3, 12, 9, 12], [10, 7, 12, 5, 9, 11]
    prompts = _prompts(lengths, seed=3)
    want = []
    for p, n in zip(prompts, new):
        ids = mnp.array(onp.asarray([p], "int32"))
        want.append(jax_generate(jnet, ids, n, multi_token=4).asnumpy()[0, len(p):].tolist())
    reset_launches()
    eng = InferenceEngine(tnet, max_batch_size=4, max_len=MAXPOS, multi_token=4,
                          paged=paged, page_size=8).start()
    try:
        res = [h.result(timeout=120) for h in [eng.submit(p, n) for p, n in zip(prompts, new)]]
    finally:
        eng.shutdown(drain=True, timeout=120)
    assert all(r.ok for r in res), [r.error for r in res]
    _hold_tokens(tnet, prompts, [r.generated_ids for r in res], want)
    stats, counts = eng.stats(), launches()
    sfx = "_int4" if quant == "int4" else ""
    kind = ("fused_block_paged" if paged else "fused_block") + sfx
    assert counts[kind] == LAYERS * stats["decode_substeps"]
    assert counts["fused_head" + sfx] == stats["decode_substeps"]
    hd = HIDDEN // HEADS
    if not paged:
        assert stats["kv_bytes"] == 2 * LAYERS * 4 * HEADS * MAXPOS * hd * 2


_REQS = [  # (temperature, top_k, top_p, seed)
    (0.8, 0, 1.0, 3), (1.0, 10, 1.0, 4), (0.7, 0, 0.9, 5), (1.2, 25, 0.8, 6),
    (0.0, 0, 1.0, 7), (0.9, 0, 1.0, 8)]


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_engine_bf16_token0_matches_jax_engine(naive, paged):
    """Token 0 of sampled requests, with and without top-k/top-p, on a
    ``multi_token=4`` engine over the bf16 naive-int8 model: drawn by
    ``sample_tokens`` from the last prompt row's logits, the JAX
    ``InferenceEngine``'s token (``test_torch_sampling.py``'s check on the
    bf16 model)."""
    jnet, tnet = naive
    prompts = _prompts([5, 9, 12, 7, 6, 11], seed=5)
    kw = dict(max_batch_size=4, max_len=MAXPOS, multi_token=4, paged=paged, page_size=8)
    out = []
    for cls, net in ((JaxEngine, jnet), (InferenceEngine, tnet)):
        eng = cls(net, **kw).start()
        try:
            hs = [eng.submit(p, 4, temperature=t, top_k=k, top_p=pp, seed=s)
                  for p, (t, k, pp, s) in zip(prompts, _REQS)]
            res = [h.result(timeout=300) for h in hs]
        finally:
            eng.shutdown(drain=True, timeout=300)
        assert all(r.status == "ok" for r in res), [r.error for r in res]
        out.append([r.generated_ids[0] for r in res])
    assert out[0] == out[1]


def test_head_out_dtype_rounds_logits(naive):
    """``fused_lm_head_sample(out_dtype=bf16)`` rounds the head logits to
    bf16 before selection, as JAX's head does: greedy rows are the argmax
    of the bf16-rounded logits (ties to the lowest lane)."""
    _, tnet = naive
    w, s, v = tnet.head_weights()
    h = torch.from_numpy(onp.random.RandomState(8).randn(5, HIDDEN).astype("float32"))
    kb = torch.zeros(5, dtype=torch.int64)
    got = fb.fused_lm_head_sample(h, w, s, v, kb, torch.zeros(5), out_dtype=torch.bfloat16)
    logits = int8_gemv.int8_weight_matmul(h, w, s)[:, :v].to(torch.bfloat16).float()
    assert torch.equal(got.long(), logits.argmax(-1))
