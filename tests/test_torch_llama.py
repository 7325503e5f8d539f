"""Port parity of the Llama slice (``mxnet_tpu_torch.models.llama``) with
``mxnet_tpu.models.llama`` on the CPU: each model is built in the JAX
package, its weights carried into the port with
``interop.params_from_numpy``, and both are fed the same seeded numpy ids.
f32 logits agree within 1e-5 of the logits' scale; greedy tokens are
equal. Covered: ``_rope`` at [T] and [B, T] positions, the cache-free
forward (GQA at rep 2 and rep 1, and head dim 128 at T 256, where the
port's K1 ``autograd.Function`` route runs its plain version), the cached
forwards against the forward, paged against contiguous bit for bit, the
stacked decoder against the per-layer one, ``generate``, the serving
engine in both layouts with both decoders, ``quantize_net`` int8 and int4
(untied and tied: tables bit for bit, the tied head through K8's plain
version), the cache-spec refusals, the unported options, and the
parameter names both ways. Training and the MoE layers are held in
``tests/test_torch_llama_train.py``. The CUDA kernels on this path are held against
these plain versions in ``tests/test_torch_cuda_kernels.py``."""
import dataclasses

import numpy as onp
import pytest
import torch

import chip_smoke
import jax.numpy as jnp
import mxnet_tpu as mx
from mxnet_tpu import np as mnp
from mxnet_tpu import numpy_extension as jnpx
from mxnet_tpu.base import MXNetError as JaxMXNetError
from mxnet_tpu.contrib.quantization import quantize_net as jax_quantize_net
from mxnet_tpu.models import generate as jax_generate
from mxnet_tpu.models import llama as JL

from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.contrib.quantization import (QuantizedDense, _quantize_tied_lm_head,
                                                  quantize_net)
from mxnet_tpu_torch.interop import params_from_numpy, params_to_numpy
from mxnet_tpu_torch.models import generate
from mxnet_tpu_torch.models import llama as TL
from mxnet_tpu_torch.models._layers import RMSNorm
from mxnet_tpu_torch.ops.fused_block_gemv import pad_vocab
from mxnet_tpu_torch.ops.int8_gemv import launches, reset_launches
from mxnet_tpu_torch.serve import InferenceEngine

TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
            num_heads=4, num_kv_heads=2)                      # LLAMA_TINY: rep 2
REP1 = dict(vocab_size=256, hidden_size=64, intermediate_size=96, num_layers=2,
            num_heads=4, num_kv_heads=4)
HD128 = dict(vocab_size=256, hidden_size=256, intermediate_size=256, num_layers=2,
             num_heads=2, num_kv_heads=1)
MAXLEN = 32


def _close(got, want, tol=1e-5):
    got, want = onp.asarray(got, onp.float32), onp.asarray(want, onp.float32)
    assert got.shape == want.shape
    err = onp.abs(got - want).max()
    assert err <= tol * max(1.0, onp.abs(want).max()), err


def _pair(shape=TINY, stacked=False, tie=False, seed=1):
    """A JAX Llama and the port's Llama (on the CPU, f32) holding the same
    seeded weights: N(0, 0.1) matrices, gains 1 + N(0, 0.1), so that
    greedy decoding of the tiny model wanders over the vocab."""
    kw = dict(shape, stacked=stacked, tie_embeddings=tie)
    mx.random.seed(0)
    jnet = JL.LlamaForCausalLM(JL.LlamaConfig(dtype=onp.float32, **kw))
    jnet.initialize()
    jnet(mnp.array(onp.zeros((1, 4), "int32")))
    rng = onp.random.RandomState(seed)
    for name, p in jnet.collect_params().items():
        base = 1.0 if name.endswith(("gamma", ".ln1", ".ln2")) else 0.0
        p.set_data(mnp.array((base + 0.1 * rng.randn(*p.shape)).astype("float32")))
    named = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    tnet = TL.LlamaForCausalLM(TL.LlamaConfig(dtype=torch.float32, **kw), device="cpu")
    params_from_numpy(tnet, named)
    return jnet, tnet


def _ids(B, T, seed=0, vocab=256):
    return onp.random.RandomState(seed).randint(0, vocab, (B, T)).astype(onp.int32)


@pytest.fixture(scope="module")
def tiny():
    return _pair()


@pytest.fixture(scope="module")
def tiny_stacked():
    return _pair(stacked=True)


@pytest.mark.parametrize("positions", ["T", "BT"])
def test_rope_matches_jax(positions):
    """Split-half rotation in f32 (the JAX code, not its docstring's
    interleaved pairs), at [T] and per-row [B, T] positions."""
    rng = onp.random.RandomState(3)
    x = rng.randn(2, 4, 6, 128).astype(onp.float32)
    pos = (onp.arange(6) + 5 if positions == "T"
           else onp.stack([onp.arange(6) + 3, onp.arange(6) + 900]))
    want = onp.asarray(JL._rope(jnp.asarray(x), jnp.asarray(pos), 500000.0))
    got = TL._rope(torch.from_numpy(x), torch.from_numpy(pos), 500000.0).numpy()
    _close(got, want)
    half = 64
    assert not onp.allclose(got[..., :half], x[..., :half])    # the halves rotate


def test_rms_norm_bf16_rounds_as_jax():
    """RMSNorm in bf16: normalized in f32, rounded to bf16, times the bf16
    gain, bit for bit the JAX package's ``npx.rms_norm``."""
    rng = onp.random.RandomState(4)
    x = rng.randn(3, 7, 256).astype(onp.float32)
    g = (1.0 + 0.1 * rng.randn(256)).astype(onp.float32)
    jx = mnp.array(x).astype(jnp.bfloat16)
    jg = mnp.array(g).astype(jnp.bfloat16)
    want = jnpx.rms_norm(jx, jg, eps=1e-5).asnumpy()
    layer = RMSNorm(256, epsilon=1e-5, device="cpu", dtype=torch.bfloat16)
    with torch.no_grad():
        layer.gamma.copy_(torch.from_numpy(g))
        got = layer(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    assert (got.view(torch.int16).numpy().view(onp.uint16)
            == onp.asarray(want).view(onp.uint16)).all()


@pytest.mark.parametrize("shape,T", [(TINY, 12), (REP1, 12), (HD128, 256)],
                         ids=["tiny_rep2", "rep1", "hd128_T256"])
def test_forward_matches_jax(shape, T):
    """The cache-free forward: logits within 1e-5 of JAX's. At hd 128 and
    T 256 the port's attention takes K1's ``autograd.Function`` with the
    plain version on the CPU."""
    jnet, tnet = _pair(shape)
    ids = _ids(2, T, seed=T)
    reset_launches()
    with torch.no_grad():
        got = tnet(torch.from_numpy(ids)).numpy()
    if T >= 256:
        assert launches().get("flash_fwd", 0) == shape["num_layers"]
    _close(got, jnet(mnp.array(ids)).asnumpy())


@pytest.mark.parametrize("stacked", [False, True], ids=["per_layer", "stacked"])
def test_forward_cached_matches_forward(stacked, tiny, tiny_stacked):
    """Prefill then per-row decode steps on the contiguous cache: each
    step's logits match the cache-free forward's (JAX's and the port's)."""
    jnet, tnet = tiny_stacked if stacked else tiny
    ids = _ids(2, 10, seed=5)
    want = jnet(mnp.array(ids)).asnumpy()
    caches = tnet.new_caches(2, 16)
    logits, *caches = tnet.forward_cached(torch.from_numpy(ids[:, :6]), 0, *caches)
    _close(logits.numpy(), want[:, :6])
    for t in range(6, 10):
        pos = torch.full((2,), t, dtype=torch.int32)
        logits, *caches = tnet.forward_cached(torch.from_numpy(ids[:, t:t + 1]), pos,
                                              *caches)
        _close(logits.numpy()[:, 0], want[:, t])


@pytest.mark.parametrize("stacked", [False, True], ids=["per_layer", "stacked"])
def test_paged_equals_contiguous_bitwise(stacked, tiny, tiny_stacked):
    """The paged pools through a scattered block table give the contiguous
    caches' logits bit for bit (one ``_attend`` program over the same
    values), for a prefill and rows at different depths."""
    _, tnet = tiny_stacked if stacked else tiny
    ids = _ids(2, 12, seed=6)
    ps, maxp = 4, 4
    caches = tnet.new_caches(2, ps * maxp)
    pools = tnet.new_pools(2 * maxp + 1, ps)
    table = torch.tensor([[7, 2, 5, 0], [1, 6, 3, 4]], dtype=torch.int32)
    a, *caches = tnet.forward_cached(torch.from_numpy(ids[:, :5]), 0, *caches)
    b, *pools = tnet.forward_cached_paged(torch.from_numpy(ids[:, :5]), 0, table, *pools)
    assert torch.equal(a, b)
    pos = torch.tensor([5, 3], dtype=torch.int32)
    for t in range(4):
        tok = torch.from_numpy(ids[:, 5 + t:6 + t])
        a, *caches = tnet.forward_cached(tok, pos + t, *caches)
        b, *pools = tnet.forward_cached_paged(tok, pos + t, table, *pools)
        assert torch.equal(a, b), t


def test_stacked_matches_per_layer(tiny):
    """The stacked decoder holding the per-layer model's weights gives its
    logits (cache-free and cached) and its greedy tokens."""
    _, tnet = tiny
    snet = chip_smoke.stack_llama(torch, tnet)
    ids = _ids(2, 9, seed=7)
    with torch.no_grad():
        _close(snet(torch.from_numpy(ids)).numpy(), tnet(torch.from_numpy(ids)).numpy())
    a = generate(tnet, ids, 6)
    b = generate(snet, ids, 6)
    assert torch.equal(a, b)


@pytest.mark.parametrize("stacked", [False, True], ids=["per_layer", "stacked"])
@pytest.mark.parametrize("multi_token", [1, 4])
def test_generate_matches_jax(stacked, multi_token, tiny, tiny_stacked):
    """Greedy ``generate`` (and its ``LlamaForCausalLM.generate`` method)
    gives JAX's tokens."""
    jnet, tnet = tiny_stacked if stacked else tiny
    ids = _ids(2, 5, seed=8)
    want = jax_generate(jnet, mnp.array(ids), 8, multi_token=multi_token).asnumpy()
    got = tnet.generate(ids, 8, multi_token=multi_token)
    assert (got.numpy() == want).all()


def _serve(net, prompts, new, **kw):
    eng = InferenceEngine(net, max_batch_size=2, max_len=MAXLEN, **kw).start()
    try:
        handles = [eng.submit(p, new) for p in prompts]
        out = []
        for h in handles:
            r = h.result(300)
            assert r.status == "ok"
            out.append(r.generated_ids)
        return out
    finally:
        eng.shutdown()


_PROMPTS = [onp.array([5, 9, 1, 7], onp.int32), onp.array([2, 4, 6, 8, 10, 12], onp.int32),
            onp.array([200, 31, 17], onp.int32)]


@pytest.fixture(scope="module")
def jax_refs(tiny, tiny_stacked):
    """JAX ``generate`` tokens of each prompt, per decoder."""
    out = {}
    for stacked, (jnet, _) in ((False, tiny), (True, tiny_stacked)):
        out[stacked] = [list(jax_generate(jnet, mnp.array(p[None]), 7).asnumpy()[0][len(p):])
                        for p in _PROMPTS]
    return out


@pytest.mark.parametrize("stacked", [False, True], ids=["per_layer", "stacked"])
@pytest.mark.parametrize("paged,multi_token", [(False, 1), (True, 1), (False, 3), (True, 3)],
                         ids=["contiguous", "paged", "contiguous_k3", "paged_k3"])
def test_engine_matches_jax_generate(stacked, paged, multi_token, tiny, tiny_stacked,
                                     jax_refs):
    """The engine drives any cache-protocol model (``tests/test_serve.py``'s
    Llama cases): per-layer GQA caches (batch axis 0) and the stacked
    decoder's [layers, B, ...] caches and [layers, pages, ...] pools (axis
    1), three requests through two slots, equal to JAX's ``generate``."""
    _, tnet = tiny_stacked if stacked else tiny
    got = _serve(tnet, _PROMPTS, 7, paged=paged, page_size=8, multi_token=multi_token)
    assert got == jax_refs[stacked]


def test_engine_cow_fork_copies_stacked_pages(tiny_stacked, jax_refs):
    """A shared prompt prefix maps the same pages (prefix cache) and the
    copy-on-write fork copies a page along the stacked pools' page axis."""
    _, tnet = tiny_stacked
    p = _PROMPTS[1]
    got = _serve(tnet, [p, p], 7, paged=True, page_size=4, prefill_chunk=4)
    assert got == [jax_refs[True][1]] * 2


def _q_pair(bits, tie, stacked=False):
    jnet, tnet = _pair(tie=tie, stacked=stacked)
    jax_quantize_net(jnet, calib_mode="none", bits=bits)
    quantize_net(tnet, bits=bits)
    return jnet, tnet


_DENSE = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj", "self_attn.o_proj",
          "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj")


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
def test_quantize_net_matches_jax(bits, tie):
    """Every Dense table (and the untied ``lm_head``'s, or the tied head's
    vocab-padded table from ``model.embed_tokens``) equals JAX's bit for
    bit; the quantized logits at GEMV row counts match within 1e-5 of
    their scale, and so do greedy tokens of ``generate``."""
    jnet, tnet = _q_pair(bits, tie)
    for jl, tl in zip(jnet.model.layers._children.values(), tnet.model.layers):
        for path in _DENSE:
            jq, tq = jl, tl
            for part in path.split("."):
                jq, tq = getattr(jq, part), getattr(tq, part)
            assert isinstance(tq, QuantizedDense)
            assert (onp.asarray(jq._w_q) == tq.w_q.numpy()).all(), path
            assert (onp.asarray(jq._w_scale) == tq.w_scale.numpy()).all(), path
    if tie:
        assert tnet.lm_head is None and tnet.head_weights() is tnet._q_lm_head
        (jw, js, jv), (tw, ts, tv) = jnet._q_lm_head, tnet._q_lm_head
        assert jv == tv == 256 and tw.shape[0] == pad_vocab(256)
        assert (onp.asarray(jw) == tw.numpy()).all() and (onp.asarray(js) == ts.numpy()).all()
    else:
        assert isinstance(tnet.lm_head, QuantizedDense) and tnet.head_weights() is None
        assert tnet._q_lm_head is None and getattr(jnet, "_q_lm_head", None) is None
        assert (onp.asarray(jnet.lm_head._w_q) == tnet.lm_head.w_q.numpy()).all()
    ids = _ids(2, 6, seed=9)
    caches = tnet.new_caches(2, 8)
    jcaches = [jnp.zeros(s, d) for s, d in jnet.cache_spec(2, 8)]
    want = onp.asarray(jnet.forward_cached(mnp.array(ids), 0, *jcaches)[0].asnumpy())
    _close(tnet.forward_cached(torch.from_numpy(ids), 0, *caches)[0].numpy(), want)
    for K in (1, 4):
        want = jax_generate(jnet, mnp.array(ids), 6, multi_token=K).asnumpy()
        assert (generate(tnet, ids, 6, multi_token=K).numpy() == want).all(), K


@pytest.mark.parametrize("bits", [8, 4])
def test_tied_quantized_engine_selects_through_k8(bits):
    """A tied quantized Llama in a ``multi_token=4`` engine selects every
    decode token through the fused head (K8's plain version here), with
    JAX ``generate``'s greedy tokens in both layouts."""
    jnet, tnet = _q_pair(bits, tie=True)
    want = [list(jax_generate(jnet, mnp.array(p[None]), 7, multi_token=4)
                 .asnumpy()[0][len(p):]) for p in _PROMPTS[:2]]
    kind = "fused_head" + ("_int4" if bits == 4 else "")
    for paged in (False, True):
        reset_launches()
        got = _serve(tnet, _PROMPTS[:2], 7, paged=paged, page_size=8, multi_token=4)
        assert got == want, paged
        assert launches().get(kind, 0) > 0


def test_stacked_quantize_leaves_the_model_as_jax_does():
    """``quantize_net`` on the stacked decoder (no Dense layer) returns the
    model unchanged, tied head included, as the JAX package does; the tied
    head quantized on its own feeds K8 bf16 hidden states of a bf16 model
    (the lane a bf16 hidden state reaches)."""
    jnet, tnet = _pair(tie=True, stacked=True)
    jax_quantize_net(jnet, calib_mode="none")
    quantize_net(tnet)
    assert getattr(jnet, "_q_lm_head", None) is None and tnet.head_weights() is None
    cfg = dataclasses.replace(tnet.cfg, dtype=torch.bfloat16)
    bnet = TL.LlamaForCausalLM(cfg, device="cpu").init_weights(3)
    _quantize_tied_lm_head(bnet, 8)
    ids = _ids(2, 5, seed=10)
    caches = bnet.new_caches(2, 8)
    hidden, *_ = bnet.forward_cached_hidden(torch.from_numpy(ids), 0, *caches)
    assert hidden.dtype == torch.bfloat16
    reset_launches()
    out = generate(bnet, ids, 3, multi_token=2)
    assert launches().get("fused_head", 0) > 0
    assert tuple(out.shape) == (2, 8)


@pytest.mark.parametrize("field,value,words", [
    ("num_experts", 4, "MoE"), ("sp_mesh", object(), "sequence-parallel"),
    ("pp_mesh", object(), "pipeline parallelism")], ids=["moe", "sp_mesh", "pp_mesh"])
def test_cache_spec_refusals(field, value, words):
    """``cache_spec`` and ``cache_spec_paged`` refuse MoE, sp_mesh and
    pp_mesh configs with the JAX package's words, and the engine and
    ``generate(use_cache=True)`` refuse such a model."""
    jnet = JL.LlamaForCausalLM(JL.LlamaConfig(dtype=onp.float32,
                                              **dict(TINY, **{field: value})))
    with pytest.raises(JaxMXNetError) as jerr:
        jnet.cache_spec(1, 8)
    # a real MoE model; sp_mesh and pp_mesh are read from the config of a
    # flash-attention model (their attention and schedule are not ported)
    cfg = TL.LlamaConfig(dtype=torch.float32, **TINY)
    if field == "num_experts":
        setattr(cfg, field, value)
    tnet = TL.LlamaForCausalLM(cfg, device="cpu")
    if field == "num_experts":
        assert isinstance(tnet.model.layers[0].mlp, TL.LlamaMoE)
    setattr(cfg, field, value)
    for call in (lambda: tnet.cache_spec(1, 8), lambda: tnet.cache_spec_paged(4, 8)):
        with pytest.raises(MXNetError) as terr:
            call()
        assert str(terr.value) == str(jerr.value) and words in str(terr.value)
    with pytest.raises(MXNetError, match="KV-cache decode protocol"):
        InferenceEngine(tnet, max_batch_size=1, max_len=16)
    with pytest.raises(MXNetError, match="use_cache=True"):
        generate(tnet, _ids(1, 3), 2, use_cache=True)


def test_unported_options_raise():
    """Ring/Ulysses attention and GPipe raise naming ROADMAP Queue 1 item 8;
    an MoE model builds (its MoE layers are ported); the stacked decoder's
    own refusals keep JAX's words."""
    moe = TL.LlamaForCausalLM(TL.LlamaConfig(dtype=torch.float32, num_experts=4, **TINY),
                              device="cpu")
    assert all(isinstance(layer.mlp, TL.LlamaMoE) for layer in moe.model.layers)
    with pytest.raises(MXNetError, match="does not support MoE"):
        TL.LlamaForCausalLM(TL.LlamaConfig(dtype=torch.float32, num_experts=4,
                                           stacked=True, **TINY), device="cpu")
    with pytest.raises(MXNetError, match="flash attention only"):
        TL.LlamaForCausalLM(TL.LlamaConfig(dtype=torch.float32, attn_impl="ring",
                                           stacked=True, **TINY), device="cpu")
    ids = torch.from_numpy(_ids(1, 4))
    for kw in (dict(attn_impl="ring", sp_mesh=object()),
               dict(attn_impl="ulysses", sp_mesh=object()), dict(pp_mesh=object())):
        net = TL.LlamaForCausalLM(TL.LlamaConfig(dtype=torch.float32, **TINY, **kw),
                                  device="cpu")
        with pytest.raises(MXNetError, match="Queue 1 item 8"), torch.no_grad():
            net(ids)


@pytest.mark.parametrize("stacked", [False, True], ids=["per_layer", "stacked"])
def test_interop_round_trip_keeps_jax_names(stacked, tiny, tiny_stacked):
    """``params_to_numpy`` gives JAX's ``collect_params()`` names and
    values; loading them into a fresh port model reproduces its logits."""
    jnet, tnet = tiny_stacked if stacked else tiny
    named = params_to_numpy(tnet)
    jnamed = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    assert list(named) == list(jnamed)
    for n in named:
        assert (named[n] == jnamed[n]).all(), n
    fresh = params_from_numpy(TL.LlamaForCausalLM(tnet.cfg, device="cpu"), named)
    ids = torch.from_numpy(_ids(1, 7))
    with torch.no_grad():
        assert torch.equal(fresh(ids), tnet(ids))


def test_engine_swaps_llama_weights_by_name():
    """A live swap of a Llama engine by publish names: later requests give
    the tokens of a fresh engine over the new weights."""
    _, a = _pair(seed=1)
    _, b = _pair(seed=2)
    p = _PROMPTS[0]
    want = _serve(b, [p], 6)
    eng = InferenceEngine(a, max_batch_size=2, max_len=MAXLEN).start()
    try:
        before = eng.generate(p, 6).generated_ids
        eng.swap_weights(params_to_numpy(b), version=1)
        after = eng.generate(p, 6).generated_ids
    finally:
        eng.shutdown()
    assert after == want[0] and before != after


def test_init_weights_on_the_model_device():
    """``init_weights(seed, std)``: N(0, std) matrices and embeddings, unit
    gains, drawn on the model's device, the same per seed."""
    cfg = TL.LlamaConfig(dtype=torch.float32, **dict(TINY, stacked=True))
    a = TL.LlamaForCausalLM(cfg, device="cpu").init_weights(5)
    b = TL.LlamaForCausalLM(cfg, device="cpu").init_weights(5)
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
        if n.endswith(("gamma", ".ln1", ".ln2")):
            assert bool((p == 1).all()), n
        else:
            assert abs(p.std().item() - 0.02) < 0.005, n
    assert a.device.type == "cpu" and tmodels.LLAMA3_8B.hd == 128
