"""Port parity of the sampling stream: ``mxnet_tpu_torch._prng`` against
``jax.random`` (threefry2x32 keys, ``fold_in``, ``split``, partitionable
``random_bits``, ``uniform``, ``gumbel``, ``categorical``), the ported
``filter_logits`` / keyed ``sample_tokens`` against the JAX package's,
sampled ``generate()`` and the serving engine's sampled streams (both
layouts) against the JAX package's on the CPU.

The contract carried from the TPU: a ``multi_token > 1`` engine or
``generate()`` with a quantized tied head selects unfiltered T > 0 rows
after token 0 with the fused head's hash-Gumbel stream (K8, as the TPU
kernel does), while the JAX package's CPU path sends every such call to
``sample_tokens``. Those rows, and only those, differ from JAX on the CPU
by design; they are held against the port's plain K8 stream instead.
Token 0, filtered batches and engines without a fused head draw JAX's
``random.categorical`` stream and are held against JAX token for token.
"""
import numpy as onp
import pytest
import torch

import chip_smoke
import jax
import jax.numpy as jnp
import mxnet_tpu as mx
from mxnet_tpu import np as mnp
from mxnet_tpu.contrib.quantization import quantize_net as jax_quantize_net
from mxnet_tpu.models import GPTModel as JaxGPT
from mxnet_tpu.models import generate as jax_generate
from mxnet_tpu.models import generation as jgen
from mxnet_tpu.models.gpt import GPTConfig as JaxGPTConfig
from mxnet_tpu.serve import InferenceEngine as JaxEngine

from mxnet_tpu_torch import _prng
from mxnet_tpu_torch.contrib.quantization import quantize_net
from mxnet_tpu_torch.interop import params_from_numpy
from mxnet_tpu_torch.models import GPTConfig, GPTModel, generate
from mxnet_tpu_torch.models import generation as gen
from mxnet_tpu_torch.serve import InferenceEngine

VOCAB, HIDDEN, LAYERS, HEADS, MAXPOS = 256, 256, 2, 4, 64
_SEEDS = onp.array([0, 1, 7, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1, 123456789], onp.uint32)


def _jkeys(seeds):
    return jax.vmap(jax.random.key)(jnp.asarray(seeds, jnp.uint32))


def _data(keys):
    return onp.asarray(jax.random.key_data(keys)).astype(onp.int64)


# ---------------------------------------------------------------------------
# _prng against jax.random
# ---------------------------------------------------------------------------
def test_key_fold_in_split_bitwise():
    """``key``, ``fold_in`` and ``split`` give JAX's key data bit for bit."""
    for s in [0, 1, 5, 2 ** 31 - 1, 2 ** 32 - 1, -1, -12345]:
        want = _data(jax.random.key(s))
        assert (_prng.key(s).numpy() == want).all(), s
        for d in [0, 1, 3, 2 ** 31 - 1, 2 ** 32 - 1]:
            fw = _data(jax.random.fold_in(jax.random.key(s), jnp.uint32(d)))
            assert (_prng.fold_in(_prng.key(s), d).numpy() == fw).all(), (s, d)
        for n in (2, 3, 7):
            sw = _data(jax.random.split(jax.random.key(s), n))
            assert (_prng.split(_prng.key(s), n).numpy() == sw).all(), (s, n)
    counters = onp.arange(len(_SEEDS)) * 977
    want = _data(jax.vmap(jax.random.fold_in)(_jkeys(_SEEDS), jnp.asarray(counters, jnp.uint32)))
    assert (_prng.fold_keys(_SEEDS, counters).numpy() == want).all()


@pytest.mark.parametrize("shape", [(1,), (257,), (4, 1000), (3, 5, 7)],
                         ids=["1", "V", "BxV", "odd3d"])
def test_random_bits_bitwise(shape):
    """Partitionable ``random_bits`` for one key and, as JAX's ``vmap``,
    for a batch of keys: bit for bit."""
    k = jax.random.fold_in(jax.random.key(42), 3)
    want = onp.asarray(jax.random.bits(k, shape, jnp.uint32)).astype(onp.int64)
    got = _prng.random_bits(_prng.fold_in(_prng.key(42), 3), shape).numpy()
    assert got.shape == shape and (got == want).all()
    keys = _jkeys(_SEEDS)
    want = onp.asarray(jax.vmap(lambda kk: jax.random.bits(kk, shape, jnp.uint32))(keys))
    got = _prng.random_bits(_prng.keys(_SEEDS), shape).numpy()
    assert got.shape == (len(_SEEDS),) + shape
    assert (got == want.astype(onp.int64)).all()


@pytest.mark.parametrize("lo", [0.0, float(onp.finfo(onp.float32).tiny)], ids=["0", "tiny"])
def test_uniform_bitwise(lo):
    k = jax.random.key(9)
    want = onp.asarray(jax.random.uniform(k, (6, 999), jnp.float32, minval=lo, maxval=1.0))
    got = _prng.uniform(_prng.key(9), (6, 999), lo, 1.0).numpy()
    assert got.dtype == onp.float32
    assert (got.view(onp.int32) == want.view(onp.int32)).all()


def test_gumbel_within_2_ulp():
    """Gumbel noise within 2 ulp, counted at the scale max(|g|, 1): the
    uniforms are bitwise equal, but XLA's CPU log and torch's differ in the
    last place for about one value in seven, and the inner log's rounding
    reaches the outer one as an absolute error of at most 2^-23
    (d(-log y) = -dy / y), below one ulp of 1."""
    for s in (0, 3, 77):
        want = onp.asarray(jax.random.gumbel(jax.random.key(s), (8, 4096), jnp.float32))
        got = _prng.gumbel(_prng.key(s), (8, 4096)).numpy()
        ulp = onp.spacing(onp.maximum(onp.abs(want), 1.0).astype(onp.float32))
        assert (onp.abs(got - want) <= 2 * ulp).all(), s


def test_categorical_tokens_equal_over_200_seeds():
    """``random.categorical`` with one key over [B, V] (generate's split
    chain) and with a key per row (``vmap``): the same token for every one
    of 200 seeds."""
    rng = onp.random.RandomState(0)
    logits = (rng.randn(4, 1000) * 2).astype(onp.float32)
    jl = jnp.asarray(logits)
    tl = torch.from_numpy(logits)
    one_j, one_t, row_j, row_t = [], [], [], []
    for s in range(200):
        one_j.append(onp.asarray(jax.random.categorical(jax.random.key(s), jl, axis=-1)))
        one_t.append(_prng.categorical(_prng.key(s), tl).numpy())
        seeds = onp.arange(4, dtype=onp.uint32) + 1000 * s
        row_j.append(onp.asarray(jax.vmap(jax.random.categorical)(_jkeys(seeds), jl)))
        row_t.append(_prng.categorical(_prng.keys(seeds), tl).numpy())
    assert (onp.stack(one_j) == onp.stack(one_t)).all()
    assert (onp.stack(row_j) == onp.stack(row_t)).all()


# ---------------------------------------------------------------------------
# filter_logits and keyed sample_tokens against the JAX package
# ---------------------------------------------------------------------------
_ROWS = [  # (temperature, top_k, top_p): greedy rows among filtered ones
    (0.0, 0, 1.0), (0.7, 5, 1.0), (1.3, 0, None), (1.0, 40, None),
    (0.9, 0, 1.0), (0.0, 3, None), (2.0, 1, 1.0), (4.0, 200, None)]


def _nucleus_inputs(seed, V=300):
    """Logits and per-row (temps, top_k, top_p) with no probability mass
    within 1e-6 of a nucleus boundary: each ``top_p`` (None above) lies
    halfway between two exclusive prefix sums, 1e-4 or more apart, of the
    row's sorted, temperature-scaled, top-k-filtered probabilities
    (``chip_smoke.nucleus_away_from_edges``). The nucleus cut compares a
    cumsum, whose rounding differs between XLA and torch; away from the
    boundary the two cut at the same place."""
    rng = onp.random.RandomState(seed)
    logits = (rng.randn(len(_ROWS), V) * 3).astype(onp.float32)
    temps = onp.array([r[0] for r in _ROWS], onp.float32)
    topk = onp.array([r[1] for r in _ROWS], onp.int32)
    rows = [b for b, r in enumerate(_ROWS) if r[2] is None]
    return logits, temps, topk, chip_smoke.nucleus_away_from_edges(onp, logits, temps, topk, rows)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_filter_logits_masks_equal(seed):
    logits, temps, topk, topp = _nucleus_inputs(seed)
    scaled = logits / onp.where(temps > 0, temps, 1.0)[:, None]
    want = onp.asarray(jgen.filter_logits(jnp.asarray(scaled), jnp.asarray(topk),
                                          jnp.asarray(topp)))
    got = gen.filter_logits(torch.from_numpy(scaled), topk, topp).numpy()
    assert (onp.isfinite(want) == onp.isfinite(got)).all()
    assert (got[onp.isfinite(got)] == want[onp.isfinite(want)]).all()
    mask = onp.random.RandomState(seed + 50).rand(*scaled.shape) < 0.5
    mask[:, 0] = True
    want = onp.asarray(jgen.filter_logits(jnp.asarray(scaled), jnp.asarray(topk),
                                          jnp.asarray(onp.ones_like(topp)), mask=jnp.asarray(mask)))
    got = gen.filter_logits(torch.from_numpy(scaled), topk, onp.ones_like(topp),
                            mask=torch.from_numpy(mask)).numpy()
    assert (onp.isfinite(want) == onp.isfinite(got)).all()
    assert (got[onp.isfinite(got)] == want[onp.isfinite(want)]).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_tokens_equal(seed):
    """Keyed ``sample_tokens`` (per-row ``fold_in(key(seed), counter)``)
    with mixes of greedy, plain, top-k and top-p rows: the JAX package's
    tokens, for 25 counters."""
    logits, temps, topk, topp = _nucleus_inputs(seed)
    seeds = onp.arange(len(temps), dtype=onp.uint32) * 31 + seed
    for c in range(25):
        counters = onp.full(len(temps), c, onp.int32)
        keys = jgen._fold_keys(jnp.asarray(seeds), jnp.asarray(counters))
        want = onp.asarray(jgen.sample_tokens(jnp.asarray(logits), keys, jnp.asarray(temps),
                                              jnp.asarray(topk), jnp.asarray(topp)))
        got = gen.sample_tokens(torch.from_numpy(logits), _prng.fold_keys(seeds, counters),
                                temps, topk, topp).numpy()
        assert got.dtype == onp.int32 and (got == want).all(), c
        greedy = temps == 0
        assert (got[greedy] == logits[greedy].argmax(-1)).all()


# ---------------------------------------------------------------------------
# generate() and the engine against the JAX package
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def nets():
    """A JAX GPT and the port's GPT with the same N(0, 0.1) weights, both
    int8 with fused decode (``tests/test_torch_gpt_serve.py``'s pair)."""
    cfg = dict(vocab_size=VOCAB, hidden_size=HIDDEN, num_layers=LAYERS,
               num_heads=HEADS, max_position_embeddings=MAXPOS, dropout=0.0)
    mx.random.seed(0)
    jnet = JaxGPT(JaxGPTConfig(**cfg))
    jnet.initialize()
    jnet(mnp.array(onp.zeros((1, 4), "int32")))
    rng = onp.random.RandomState(0)
    for name, p in jnet.collect_params().items():
        base = 1.0 if name.endswith("gamma") else 0.0
        p.set_data(mnp.array((base + 0.1 * rng.randn(*p.shape)).astype("float32")))
    named = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    tnet = GPTModel(GPTConfig(**cfg), device="cpu")
    params_from_numpy(tnet, named)
    jax_quantize_net(jnet, calib_mode="none", fused_decode=True)
    quantize_net(tnet, fused_decode=True)
    return jnet, tnet


def _prompts(lengths, seed=1):
    rng = onp.random.RandomState(seed)
    return [rng.randint(0, VOCAB, n).astype("int32") for n in lengths]


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (20, 1.0), (0, 0.9), (30, 0.8)],
                         ids=["plain", "topk", "topp", "both"])
def test_generate_single_sampled_matches_jax(nets, top_k, top_p):
    """``generate(multi_token=1)`` at T 0.9: JAX's split chain, token for
    token."""
    jnet, tnet = nets
    ids = onp.stack(_prompts([6, 6, 6], seed=2))
    for seed in (0, 5):
        kw = dict(temperature=0.9, top_k=top_k, top_p=top_p, seed=seed)
        want = jax_generate(jnet, mnp.array(ids), 12, **kw).asnumpy()
        got = generate(tnet, ids, 12, **kw).numpy()
        assert (got == want).all(), seed


@pytest.mark.parametrize("top_k,top_p", [(20, 1.0), (0, 0.85)], ids=["topk", "topp"])
def test_generate_multi_filtered_matches_jax(nets, top_k, top_p):
    """``generate(multi_token=4)`` with a filtered sampled head: every
    substep takes ``sample_tokens`` on the head GEMV's logits, JAX's
    stream token for token."""
    jnet, tnet = nets
    ids = onp.stack(_prompts([5, 5], seed=3))
    kw = dict(temperature=1.1, top_k=top_k, top_p=top_p, seed=11, multi_token=4)
    want = jax_generate(jnet, mnp.array(ids), 14, **kw).asnumpy()
    got = generate(tnet, ids, 14, **kw).numpy()
    assert (got == want).all()


_REQS = [  # (temperature, top_k, top_p, seed)
    (0.8, 0, 1.0, 3), (1.0, 10, 1.0, 4), (0.7, 0, 0.9, 5), (1.2, 25, 0.8, 6),
    (0.0, 0, 1.0, 7), (0.9, 0, 1.0, 8)]


def _serve(engine_cls, net, reqs, prompts, new, **kw):
    eng = engine_cls(net, **kw).start()
    try:
        hs = [eng.submit(p, new, temperature=t, top_k=k, top_p=pp, seed=s)
              for p, (t, k, pp, s) in zip(prompts, reqs)]
        res = [h.result(timeout=300) for h in hs]
    finally:
        eng.shutdown(drain=True, timeout=300)
    assert all(r.status == "ok" for r in res), [r.error for r in res]
    return [list(r.generated_ids) for r in res]


_LAYOUTS = [dict(paged=False), dict(paged=True, page_size=8)]


@pytest.mark.parametrize("layout", _LAYOUTS, ids=["contiguous", "paged"])
def test_engine_token0_matches_jax_engine(nets, layout):
    """Token 0 of T > 0 requests, with and without top-k/top-p, on a
    ``multi_token=4`` engine with the fused head: drawn by
    ``sample_tokens`` from the last prompt row's logits, the JAX
    ``InferenceEngine``'s token."""
    jnet, tnet = nets
    prompts = _prompts([5, 9, 12, 7, 6, 11], seed=5)
    kw = dict(max_batch_size=4, max_len=MAXPOS, multi_token=4, **layout)
    want = _serve(JaxEngine, jnet, _REQS, prompts, 6, **kw)
    got = _serve(InferenceEngine, tnet, _REQS, prompts, 6, **kw)
    assert [w[0] for w in want] == [g[0] for g in got]


@pytest.mark.parametrize("layout", _LAYOUTS, ids=["contiguous", "paged"])
def test_engine_without_fused_head_matches_jax_stream(nets, layout):
    """A ``multi_token=1`` engine (no fused head): every token of sampled,
    filtered and greedy requests is the JAX engine's."""
    jnet, tnet = nets
    prompts = _prompts([5, 9, 12, 7, 6, 11], seed=6)
    kw = dict(max_batch_size=4, max_len=MAXPOS, multi_token=1, **layout)
    want = _serve(JaxEngine, jnet, _REQS, prompts, 10, **kw)
    got = _serve(InferenceEngine, tnet, _REQS, prompts, 10, **kw)
    assert got == want


@pytest.mark.parametrize("layout", _LAYOUTS, ids=["contiguous", "paged"])
def test_engine_all_filtered_matches_jax_stream(nets, layout):
    """A ``multi_token=4`` fused-head engine whose every request is
    filtered: each decode batch takes ``sample_tokens`` on the head GEMV's
    logits (the reference's ``lax.cond`` branch), so the whole stream is
    the JAX engine's."""
    jnet, tnet = nets
    reqs = [r for r in _REQS if r[1] > 0 or r[2] < 1.0]
    prompts = _prompts([5, 9, 12, 7], seed=7)
    kw = dict(max_batch_size=4, max_len=MAXPOS, multi_token=4, **layout)
    want = _serve(JaxEngine, jnet, reqs, prompts, 11, **kw)
    got = _serve(InferenceEngine, tnet, reqs, prompts, 11, **kw)
    assert got == want


@pytest.mark.parametrize("layout", _LAYOUTS, ids=["contiguous", "paged"])
def test_engine_unfiltered_rows_follow_k8_stream(nets, layout):
    """Unfiltered T > 0 rows after token 0 on a fused-head engine follow
    K8's hash-Gumbel stream (the TPU kernel's, by the contract in the
    module docstring), not JAX's CPU path: held against the port's plain
    K8 stream driven by hand from the same prompt, token 0 against the
    JAX engine."""
    jnet, tnet = nets
    prompt = _prompts([7], seed=8)[0]
    temp, seed, new, K = 0.9, 21, 9, 4
    kw = dict(max_batch_size=2, max_len=MAXPOS, multi_token=K, **layout)
    got = _serve(InferenceEngine, tnet, [(temp, 0, 1.0, seed)], [prompt], new, **kw)[0]
    want0 = _serve(JaxEngine, jnet, [(temp, 0, 1.0, seed)], [prompt], new, **kw)[0][0]
    with torch.no_grad():
        P = len(prompt)
        caches = tnet.new_caches(1, MAXPOS)
        hidden, caches = gen.decode_step_hidden(tnet, torch.from_numpy(prompt)[None], 0, caches)
        tok0 = gen.sample_tokens(tnet._lm_head(hidden[:, -1]), _prng.fold_keys([seed], [0]),
                                 [temp])
        toks, _, steps, _, _ = gen.decode_multi_tokens(
            tnet, tok0, P, caches, K * 2, [temp], [seed], [1], remaining=[new - 1],
            head=tnet.head_weights())
    assert got[0] == int(tok0[0]) == want0
    assert got[1:] == toks[0, :new - 1].tolist()


def test_engine_preempted_sampled_request_continues_its_stream(nets):
    """Filtered sampled requests on a paged engine whose pool forces
    preemption: the resumed requests re-prefill and draw token 0 of the
    resume at their counter, so the tokens equal the JAX engine's on a
    pool large enough for no preemption."""
    jnet, tnet = nets
    reqs = [(1.0, 15, 1.0, 31), (0.8, 0, 0.85, 32), (1.1, 40, 0.9, 33)]
    prompts = _prompts([20, 24, 22], seed=9)
    kw = dict(max_batch_size=3, max_len=MAXPOS, multi_token=1, paged=True, page_size=8)
    want = _serve(JaxEngine, jnet, reqs, prompts, 30, num_pages=48, **kw)
    eng = InferenceEngine(tnet, num_pages=14, **kw).start()
    try:
        hs = [eng.submit(p, 30, temperature=t, top_k=k, top_p=pp, seed=s)
              for p, (t, k, pp, s) in zip(prompts, reqs)]
        got = [list(h.result(timeout=300).generated_ids) for h in hs]
        stats = eng.stats()
    finally:
        eng.shutdown(drain=True, timeout=300)
    assert stats["preemptions"] > 0
    assert got == want
