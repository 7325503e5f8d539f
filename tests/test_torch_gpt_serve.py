"""Port parity of the int8 GPT serving slice: the port's GPT (weights
copied from a JAX GPT through ``interop.params_from_numpy``) against the
JAX package's ``forward_cached``, ``generate`` and, through the port's
``InferenceEngine``, continuous batching — all on the CPU, where every
kernel wrapper takes its plain version."""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import np as mnp
from mxnet_tpu.contrib.quantization import quantize_net as jax_quantize_net
from mxnet_tpu.models import GPTModel as JaxGPT
from mxnet_tpu.models import generate as jax_generate
from mxnet_tpu.models.gpt import GPTConfig as JaxGPTConfig

from mxnet_tpu_torch import _build
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.contrib.quantization import quantize_net
from mxnet_tpu_torch.interop import params_from_numpy
from mxnet_tpu_torch.models import GPTConfig, GPTModel, generate
from mxnet_tpu_torch.ops.int8_gemv import count_launches, launches, reset_launches
from mxnet_tpu_torch.serve import InferenceEngine

VOCAB, HIDDEN, LAYERS, HEADS, MAXPOS = 256, 256, 2, 4, 64


@pytest.fixture(scope="module")
def nets():
    """A JAX GPT and the port's GPT with the same weights, both int8 with
    fused decode. The weights are N(0, 0.1) (biases and LayerNorm
    parameters perturbed too) so that greedy decoding of the tiny model
    wanders over the vocab instead of repeating one token."""
    cfg = dict(vocab_size=VOCAB, hidden_size=HIDDEN, num_layers=LAYERS,
               num_heads=HEADS, max_position_embeddings=MAXPOS, dropout=0.0)
    mx.random.seed(0)
    jnet = JaxGPT(JaxGPTConfig(**cfg))
    jnet.initialize()
    jnet(mnp.array(onp.zeros((1, 4), "int32")))
    rng = onp.random.RandomState(0)
    for name, p in jnet.collect_params().items():
        if name.endswith("gamma"):
            v = 1.0 + 0.1 * rng.randn(*p.shape)
        elif name.endswith(("beta", "bias")):
            v = 0.1 * rng.randn(*p.shape)
        else:
            v = 0.1 * rng.randn(*p.shape)
        p.set_data(mnp.array(v.astype("float32")))
    named = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    tnet = GPTModel(GPTConfig(**cfg), device="cpu")
    params_from_numpy(tnet, named)
    jfp = jnet(mnp.array(onp.arange(6, dtype="int32")[None])).asnumpy()
    with torch.no_grad():       # parameters are trainable; this is inference
        tfp = tnet(torch.arange(6, dtype=torch.int32)[None]).numpy()
    jax_quantize_net(jnet, calib_mode="none", fused_decode=True)
    quantize_net(tnet, fused_decode=True)
    return jnet, tnet, (jfp, tfp)


def _prompts(lengths, seed=1):
    rng = onp.random.RandomState(seed)
    return [rng.randint(0, VOCAB, n).astype("int32") for n in lengths]


def test_full_precision_forward_matches(nets):
    """Before quantization the two forwards agree to f32 summation order."""
    _, _, (jfp, tfp) = nets
    assert onp.abs(jfp - tfp).max() < 1e-4


def test_forward_cached_logits_match(nets):
    """Prefill (5 rows per sequence: the K3 routes) and one fused decode
    step: logits within 1e-4 of JAX's."""
    jnet, tnet, _ = nets
    ids = onp.stack(_prompts([5, 5]))
    B, P, L = 2, 5, 16
    jc = [mnp.array(onp.zeros(s, "float32")) for s, _ in jnet.cache_spec(B, L)]
    jout = jnet.forward_cached(mnp.array(ids), mnp.array(onp.int32(0)), *jc)
    tc = tnet.new_caches(B, L)
    tout = tnet.forward_cached(torch.from_numpy(ids), 0, *tc)
    assert onp.abs(jout[0].asnumpy() - tout[0].numpy()).max() < 1e-4
    nxt = onp.array([[7], [9]], "int32")
    pos = onp.array([P, P], "int32")
    jout2 = jnet.forward_cached(mnp.array(nxt), mnp.array(pos), *jout[1:])
    tout2 = tnet.forward_cached(torch.from_numpy(nxt), torch.from_numpy(pos),
                                *tout[1:])
    assert onp.abs(jout2[0].asnumpy() - tout2[0].numpy()).max() < 1e-4
    for jk, tk in zip(jout2[1:], tout2[1:]):
        assert onp.abs(jk.asnumpy() - tk.numpy()).max() < 1e-4


@pytest.mark.parametrize("multi_token", [1, 4])
def test_generate_greedy_matches_jax(nets, multi_token):
    """Greedy ``generate`` equals ``mxnet_tpu.models.generate`` token for
    token; at multi_token=4 the head is the fused sampler (K8's plain
    version) and the launch tally shows one K5 per block per step."""
    jnet, tnet, _ = nets
    ids = onp.stack(_prompts([6, 6, 6], seed=2))
    want = jax_generate(jnet, mnp.array(ids), 13,
                        multi_token=multi_token).asnumpy()
    with count_launches() as tally:
        got = generate(tnet, ids, 13, multi_token=multi_token).numpy()
    assert (got == want).all()
    assert tally["fused_block"] == LAYERS * 12           # 12 decode steps
    if multi_token == 1:
        assert "fused_head" not in tally
        assert tally["gemv"] == 4 * LAYERS + 13            # prefill + heads
    else:
        assert tally["fused_head"] == 13
        assert tally["gemv"] == 4 * LAYERS                 # prefill only


@pytest.mark.parametrize("multi_token", [1, 4])
def test_engine_matches_jax_generate(nets, multi_token):
    """Six concurrent greedy requests of mixed prompt length through a
    4-slot engine (so finished slots are refilled mid-flight): each
    request's tokens equal JAX ``generate`` on that prompt, and the
    engine thread's launches show one fused block step per block per
    decode substep."""
    jnet, tnet, _ = nets
    lengths = [3, 9, 3, 12, 9, 12]
    prompts = _prompts(lengths, seed=3)
    new = [10, 7, 12, 5, 9, 11]
    want = {}
    for n in sorted(set(lengths)):
        idx = [i for i, m in enumerate(lengths) if m == n]
        out = jax_generate(jnet, mnp.array(onp.stack([prompts[i] for i in idx])),
                           max(new[i] for i in idx)).asnumpy()
        for r, i in enumerate(idx):
            want[i] = out[r, n:n + new[i]].tolist()
    eng = InferenceEngine(tnet, max_batch_size=4, max_len=MAXPOS,
                          multi_token=multi_token).start()
    reset_launches()
    try:
        handles = [eng.submit(p, n) for p, n in zip(prompts, new)]
        results = [h.result(timeout=120) for h in handles]
    finally:
        eng.shutdown(drain=True, timeout=120)
    for i, res in enumerate(results):
        assert res.status == "ok", res.error
        assert res.generated_ids == want[i], i
    stats = eng.stats()
    assert stats["completed"] == {"ok": 6} and stats["max_active"] == 4
    counts = launches()
    assert counts["fused_block"] == LAYERS * stats["decode_substeps"]
    assert counts["gemv"] >= 4 * LAYERS * 6                # every prefill
    assert ("fused_head" in counts) == (multi_token > 1)


def test_engine_sampling_repeats_per_seed(nets):
    """T = 0.8 requests through the fused sampler: tokens stay in the vocab
    and repeat exactly when the same seed is resubmitted; another seed
    draws another stream."""
    _, tnet, _ = nets
    prompt = _prompts([5], seed=4)[0]
    eng = InferenceEngine(tnet, max_batch_size=2, max_len=MAXPOS,
                          multi_token=4).start()
    try:
        runs = [eng.generate(prompt, 12, timeout=120, temperature=0.8, seed=s)
                for s in (7, 7, 8)]
    finally:
        eng.shutdown(drain=True, timeout=120)
    a, b, c = (r.generated_ids for r in runs)
    assert all(r.status == "ok" for r in runs)
    assert a == b and a != c
    assert all(0 <= t < VOCAB for t in a + c)


def test_cpu_path_never_builds_kernels(nets, monkeypatch):
    """Tensors on the CPU never reach the kernel build: no nvcc needed."""
    _, tnet, _ = nets

    def no_build(*_a, **_k):
        raise AssertionError("the CPU path must not build kernels")
    monkeypatch.setattr(_build, "library", no_build)
    monkeypatch.setattr(_build, "build_all", no_build)
    out = generate(tnet, _prompts([4])[0][None], 6, multi_token=4)
    assert out.shape == (1, 10)


@pytest.mark.parametrize("lo,hi,growth", [(8, 64, 2), (1, 8, 2), (8, 512, 3),
                                          (16, 100, 4)])
def test_bucketing_matches_jax(lo, hi, growth):
    """The engine's prompt and batch buckets are the JAX engine's."""
    from mxnet_tpu.serve import bucketing as jb

    from mxnet_tpu_torch.serve import bucketing as tb
    assert tb.bucket_ladder(lo, hi, growth) == jb.bucket_ladder(lo, hi, growth)
    for n in range(1, hi + 1):
        assert tb.bucket_for(n, lo, hi, growth) == jb.bucket_for(n, lo, hi, growth)
        assert tb.next_pow2(n) == jb.next_pow2(n)
    with pytest.raises(MXNetError):
        tb.bucket_for(hi + 1, lo, hi, growth)


def test_unported_paths_raise(nets):
    """The configurations the JAX engine refuses still raise: a speculation
    width of 1, grammar with ``multi_token > 1``, and an over-long request.
    Speculation and grammar themselves are ported
    (tests/test_torch_speculative.py, tests/test_torch_grammar.py)."""
    _, tnet, _ = nets
    prompt = _prompts([4])[0][None]
    with pytest.raises(MXNetError, match="speculate must be 0"):
        InferenceEngine(tnet, speculate=1)
    with pytest.raises(MXNetError, match="mutually exclusive"):
        InferenceEngine(tnet, grammar=True, multi_token=2)
    eng = InferenceEngine(tnet, max_len=MAXPOS).start()
    try:
        with pytest.raises(MXNetError, match="max_len"):
            eng.submit(prompt[0], MAXPOS)
    finally:
        eng.shutdown(timeout=60)
