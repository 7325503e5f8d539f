"""Port parity of self-speculative decoding: ``mxnet_tpu_torch.serve.speculate``
(the n-gram draft source and grammar-constrained drafts),
``generation.spec_verify_tokens`` and the engine's ``speculate=K`` against
``mxnet_tpu.serve.speculate``, ``mxnet_tpu.models.generation`` and the JAX
engine, on the CPU, where the verify and the sequential decode both take
the plain versions. Every comparison is bitwise: drafts, verified tokens
and acceptance counts, and the engines' tokens."""
import numpy as onp
import pytest
import torch

import jax.numpy as jnp
import mxnet_tpu as mx
from mxnet_tpu import np as mnp
from mxnet_tpu.contrib.quantization import quantize_net as jax_quantize_net
from mxnet_tpu.models import GPTModel as JaxGPT
from mxnet_tpu.models import generation as jgen
from mxnet_tpu.models.gpt import GPTConfig as JaxGPTConfig
from mxnet_tpu.serve import InferenceEngine as JaxEngine
from mxnet_tpu.serve import grammar as jg
from mxnet_tpu.serve import speculate as jspec

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.contrib.quantization import quantize_net
from mxnet_tpu_torch.interop import params_from_numpy
from mxnet_tpu_torch.models import GPTConfig, GPTModel
from mxnet_tpu_torch.models import generation as gen
from mxnet_tpu_torch.serve import InferenceEngine, compile_grammar
from mxnet_tpu_torch.serve import speculate as tspec

VOCAB, HIDDEN, LAYERS, HEADS, MAXPOS = 256, 256, 2, 4, 64
EOS = 0
SCHEMA = {"type": "object", "properties": {"ok": {"type": "boolean"},
                                           "mode": {"enum": ["fast", "safe"]}}}


# ---------------------------------------------------------------- the drafts
def _histories(seed, n=12):
    """Seeded histories: short and long, few-symbol (many n-gram matches)
    and wide, and the edge cases (one token, all one token)."""
    rng = onp.random.RandomState(seed)
    hs = [[5], [7, 7, 7, 7], [1, 2, 3, 1, 2, 3, 1, 2]]
    for i in range(n):
        hs.append(rng.randint(0, 3 if i % 2 else 50, rng.randint(2, 80)).tolist())
    return hs


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n_draft,window", [(3, 4), (1, 1), (6, 2), (0, 4)])
def test_draft_from_history_equals_jax(seed, n_draft, window):
    for h in _histories(seed):
        assert tspec.draft_from_history(h, n_draft, window) == \
            jspec.draft_from_history(h, n_draft, window)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_constrain_draft_equals_jax(seed):
    """Drafts walked through the same automaton from every state give
    JAX's rewritten drafts, per-position states and rejection counts."""
    src = r"(?:ab|c[d-f]+)x?[0-9]{0,3}"
    jgram = jg.compile_grammar(src, VOCAB, cache=False)
    tgram = compile_grammar(src, VOCAB, cache=False)
    rng = onp.random.RandomState(seed)
    alphabet = [ord(c) for c in "abcdefx0129"] + [EOS]
    for _ in range(40):
        draft = [int(t) for t in rng.choice(alphabet, rng.randint(1, 7))]
        for q in range(jgram.n_states):
            assert tspec.constrain_draft(draft, tgram, q) == \
                jspec.constrain_draft(draft, jgram, q)


# ---------------------------------------------------------------- the verify
def _verify_case(seed, B=3, T=4, V=VOCAB, masked=False):
    """Seeded logits, inputs, seeds, counters and masks (None unless
    ``masked``); row 0's drafts are its greedy tokens, row 1's first one."""
    rng = onp.random.RandomState(seed)
    logits = rng.randn(B, T, V).astype(onp.float32) * 3
    inputs = rng.randint(0, V, (B, T)).astype(onp.int32)
    masks = None
    if masked:
        masks = rng.rand(B, T, V) < 0.3
        masks[..., 0] = True
    best = onp.where(masks, logits, -onp.inf).argmax(-1) if masked else logits.argmax(-1)
    if T > 1:
        inputs[0, 1:] = best[0, :-1]
        inputs[1, 1] = best[1, 0]
    seeds = rng.randint(0, 2**32, B).astype(onp.uint32)
    counters = rng.randint(0, 100, B).astype(onp.int32)
    return logits, inputs, seeds, counters, masks


@pytest.mark.parametrize("case", ["greedy", "sampled", "masked", "masked_sampled", "T1"])
def test_spec_verify_tokens_equals_jax(case):
    """Tokens and acceptance counts equal JAX's: greedy rows, sampled rows
    (plain, top-k, top-p), per-position grammar masks, and T = 1; the
    keys handed ready (the engine's captured call) give the same."""
    T = 1 if case == "T1" else 4
    logits, inputs, seeds, counters, masks = _verify_case(len(case), T=T,
                                                          masked="masked" in case)
    B = logits.shape[0]
    sampled = "sampled" in case or case == "T1"
    temps = onp.array([0.0, 0.8, 1.2] if sampled else [0.0] * B, onp.float32)
    topks = onp.array([0, 20, 0], onp.int32)
    topps = onp.array([1.0, 1.0, 0.9], onp.float32)
    want = jgen.spec_verify_tokens(
        jnp.asarray(logits), jnp.asarray(inputs), jnp.asarray(temps), jnp.asarray(topks),
        jnp.asarray(topps), jnp.asarray(seeds), jnp.asarray(counters),
        masks=None if masks is None else jnp.asarray(masks))
    want = [onp.asarray(w) for w in want]
    got = gen.spec_verify_tokens(torch.from_numpy(logits), torch.from_numpy(inputs), temps,
                                 topks, topps, seeds, counters,
                                 masks=None if masks is None else torch.from_numpy(masks))
    assert (got[0].numpy() == want[0]).all() and (got[1].numpy() == want[1]).all()
    assert got[0].dtype == got[1].dtype == torch.int32
    if T > 1:
        assert want[1].tolist() != [1] * B          # the case accepts drafts
    from mxnet_tpu_torch import _prng
    keys = torch.from_numpy(_prng.step_keys(seeds, counters, T).transpose(1, 0, 2).copy())
    ready = gen.spec_verify_tokens(
        torch.from_numpy(logits), torch.from_numpy(inputs), torch.from_numpy(temps),
        torch.from_numpy(topks), torch.from_numpy(topps), keys=keys,
        masks=None if masks is None else torch.from_numpy(masks),
        greedy=not sampled, check_mask=False)
    assert all(torch.equal(a, b) for a, b in zip(ready, got))


def test_spec_verify_tokens_dead_mask_raises():
    """An eager call keeps the dead-end check and its message."""
    logits, inputs, seeds, counters, _ = _verify_case(0)
    masks = torch.ones(3, 4, VOCAB, dtype=torch.bool)
    masks[1, 2] = False
    with pytest.raises(MXNetError, match=r"row\(s\) \[6\]"):
        gen.spec_verify_tokens(torch.from_numpy(logits), torch.from_numpy(inputs),
                               [0.0] * 3, [0] * 3, [1.0] * 3, seeds, counters, masks=masks)


# ---------------------------------------------------------------- the engines
@pytest.fixture(scope="module")
def nets():
    """The tiny fused int8 GPT of ``tests/test_torch_gpt_serve.py`` in both
    packages, the same N(0, 0.1) weights copied by ``params_from_numpy``."""
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


def _structured(n, seed=0, max_tokens=24):
    """``tools/serve_loadgen.py:structured_prompts`` (boilerplate runs
    around key tokens: the repetitive traffic the drafts accept)."""
    rng = onp.random.RandomState(seed)
    boiler = int(rng.randint(1, VOCAB - 1))
    keys = rng.randint(1, VOCAB - 1, size=3)
    prompts = []
    for _ in range(n):
        body = []
        for k in keys:
            body.extend([boiler] * 16)
            body.append(int(k))
            body.append(int(rng.randint(1, VOCAB - 1)))
        prompts.append(onp.asarray(body[:max_tokens], onp.int32))
    return prompts


_LAYOUTS = {"contiguous": dict(paged=False), "paged": dict(paged=True, page_size=8)}
# (temperature, top_k, top_p) per request: greedy, plain, top-k, top-p
_MIX = [(0.0, 0, 1.0), (0.9, 0, 1.0), (0.0, 0, 1.0), (0.8, 12, 1.0), (1.1, 0, 0.9),
        (0.0, 0, 1.0)]


def _per_request(spec):
    return {k: spec[k] for k in ("drafted", "accepted", "acceptance_rate")}


def _serve(engine_cls, net, reqs, warm=False, **kw):
    """Submit every (prompt, new, kwargs) at once; returns (token lists,
    stats)."""
    eng = engine_cls(net, **kw).start()
    try:
        if warm:
            eng.warmup()
        hs = [eng.submit(p, n, **rkw) for p, n, rkw in reqs]
        res = [h.result(timeout=300) for h in hs]
        stats = eng.stats()
    finally:
        eng.shutdown(drain=True, timeout=300)
    assert all(r.status == "ok" for r in res), [(r.status, r.error) for r in res]
    return [list(r.generated_ids) for r in res], stats


@pytest.mark.parametrize("layout", list(_LAYOUTS))
def test_speculative_engine_equals_jax_and_speculate_0(nets, layout):
    """Six structured and random requests (greedy, plain, top-k, top-p)
    through two slots (refills mid-flight): a ``speculate=4`` engine gives
    the JAX ``speculate=4`` engine's tokens and the port's ``speculate=0``
    tokens; its warm-up built every verify step, and serving built no
    other; ``stats()["spec"]`` has JAX's keys and its drafted and
    accepted counts."""
    jnet, tnet = nets
    prompts = _structured(3) + [onp.random.RandomState(i).randint(1, VOCAB, 9).astype(onp.int32)
                                for i in range(3)]
    reqs = [(p, 30, dict(temperature=t, top_k=k, top_p=pp, seed=10 + i))
            for i, (p, (t, k, pp)) in enumerate(zip(prompts, _MIX))]
    kw = dict(max_batch_size=2, max_len=MAXPOS, **_LAYOUTS[layout])
    want, jstats = _serve(JaxEngine, jnet, reqs, speculate=4, **kw)
    got, stats = _serve(InferenceEngine, tnet, reqs, warm=True, speculate=4, **kw)
    base, bstats = _serve(InferenceEngine, tnet, reqs, speculate=0, **kw)
    assert got == want == base
    # per request, drafts and accepts depend on its tokens alone; rounds
    # also count how requests overlapped in the batch, which the timing of
    # admissions decides
    assert _per_request(stats["spec"]) == _per_request(jstats["spec"])
    assert set(stats["spec"]) == {"rounds", "drafted", "accepted", "acceptance_rate"}
    assert stats["spec"]["accepted"] > 0 and stats["speculate"] == 4
    assert "spec" not in bstats and bstats["speculate"] == 0
    assert stats["compiled_buckets"]["spec"] == [(1, "greedy"), (1, "sampled"),
                                                 (2, "greedy"), (2, "sampled")]
    assert stats["compiled_buckets"]["decode"] == []
    assert stats["captures"] == 4 + (1 if layout == "paged" else 0)
    assert stats["decode_dispatches"] == stats["spec"]["rounds"]


@pytest.mark.parametrize("spec_draft,spec_lookup", [(1, 4), (2, 1)])
def test_draft_knobs_equal_jax(nets, spec_draft, spec_lookup):
    """``spec_draft`` (fewer drafts than the width) and ``spec_lookup``
    give the JAX engine's tokens and counts."""
    jnet, tnet = nets
    reqs = [(p, 24, dict(seed=i)) for i, p in enumerate(_structured(2, seed=4))]
    kw = dict(max_batch_size=2, max_len=MAXPOS, paged=True, page_size=8, speculate=4,
              spec_draft=spec_draft, spec_lookup=spec_lookup)
    want, jstats = _serve(JaxEngine, jnet, reqs, **kw)
    got, stats = _serve(InferenceEngine, tnet, reqs, **kw)
    assert got == want and _per_request(stats["spec"]) == _per_request(jstats["spec"])


@pytest.mark.parametrize("layout", list(_LAYOUTS))
def test_eos_mid_round(nets, layout):
    """EOS and the token budget end a row inside a round: the rest of the
    round is discarded, and the tokens are ``speculate=0``'s and JAX's."""
    jnet, tnet = nets
    p = _structured(1, seed=2)[0]
    base, _ = _serve(InferenceEngine, tnet, [(p, 30, dict())], max_batch_size=1,
                     max_len=MAXPOS, **_LAYOUTS[layout])
    eos = base[0][9]
    reqs = [(p, 30, dict(eos_token_id=eos)), (p, 7, dict())]
    kw = dict(max_batch_size=2, max_len=MAXPOS, **_LAYOUTS[layout])
    got, _ = _serve(InferenceEngine, tnet, reqs, speculate=4, **kw)
    want, _ = _serve(JaxEngine, jnet, reqs, speculate=4, **kw)
    ref, _ = _serve(InferenceEngine, tnet, reqs, **kw)
    assert got == want == ref
    assert got[0][-1] == eos and len(got[0]) == base[0].index(eos) + 1
    assert len(got[1]) == 7


def test_prefix_cache_and_chunked_prefill(nets):
    """Requests that share a prompt prefix (prefix hits, copy-on-write)
    with prefills in 8-token chunks: a ``speculate=3`` engine gives
    ``speculate=0``'s tokens and JAX's."""
    jnet, tnet = nets
    shared = _structured(1, seed=6, max_tokens=20)[0]
    rng = onp.random.RandomState(6)
    reqs = [(onp.concatenate([shared, rng.randint(1, VOCAB, 3 + i).astype(onp.int32)]), 20,
             dict(seed=i, temperature=0.7 * (i % 2))) for i in range(4)]
    kw = dict(max_batch_size=2, max_len=MAXPOS, paged=True, page_size=8, prefill_chunk=8)
    got, stats = _serve(InferenceEngine, tnet, reqs, speculate=3, **kw)
    ref, _ = _serve(InferenceEngine, tnet, reqs, **kw)
    want, _ = _serve(JaxEngine, jnet, reqs, speculate=3, **kw)
    assert got == ref == want
    assert stats["pages"]["prefix_hits"] > 0 and stats["prefill_chunks"] > len(reqs)


@pytest.mark.parametrize("layout", list(_LAYOUTS))
def test_grammar_times_speculation(nets, layout):
    """A grammar engine with ``speculate=4``: schema-constrained, regex
    and free requests in one batch give the JAX engine's tokens and the
    port's ``speculate=0`` grammar engine's; every constrained completion
    replays; ``.*`` gives the free engine's tokens and an acceptance no
    lower than the free one."""
    jnet, tnet = nets
    g = compile_grammar(SCHEMA, VOCAB)
    prompts = _structured(4, seed=8, max_tokens=18)
    reqs = [(p, 40, dict(eos_token_id=EOS, seed=i, temperature=0.8 if i == 1 else 0.0,
                         **([{"grammar": SCHEMA}, {"grammar": r"[a-z]{3,9}\."}, {}, {}][i])))
            for i, p in enumerate(prompts)]
    kw = dict(max_batch_size=2, max_len=MAXPOS, grammar=True, **_LAYOUTS[layout])
    got, _ = _serve(InferenceEngine, tnet, reqs, warm=True, speculate=4, **kw)
    want, _ = _serve(JaxEngine, jnet, reqs, speculate=4, **kw)
    ref, _ = _serve(InferenceEngine, tnet, reqs, **kw)
    assert got == want == ref
    assert g.matches(got[0], eos_token_id=EOS)
    assert compile_grammar(r"[a-z]{3,9}\.", VOCAB).matches(got[1], eos_token_id=EOS)
    free_reqs = [(p, 24, dict(eos_token_id=EOS, seed=i)) for i, p in enumerate(prompts)]
    free, fstats = _serve(InferenceEngine, tnet, free_reqs, speculate=4,
                          max_batch_size=1, max_len=MAXPOS, **_LAYOUTS[layout])
    cons, cstats = _serve(InferenceEngine, tnet,
                          [(p, n, dict(r, grammar=".*")) for p, n, r in free_reqs],
                          speculate=4, max_batch_size=1, max_len=MAXPOS, grammar=True,
                          **_LAYOUTS[layout])
    assert cons == free
    assert cstats["spec"]["acceptance_rate"] >= fstats["spec"]["acceptance_rate"]


def test_spec_validation(nets):
    """The validation errors of ``tests/test_speculative.py:
    test_spec_validation``."""
    _, tnet = nets
    with pytest.raises(MXNetError, match="speculate"):
        InferenceEngine(tnet, max_len=32, speculate=1)
    with pytest.raises(MXNetError, match="mutually exclusive"):
        InferenceEngine(tnet, max_len=32, speculate=4, multi_token=2)
    with pytest.raises(MXNetError, match="spec_lookup"):
        InferenceEngine(tnet, max_len=32, speculate=4, spec_lookup=0)
    with pytest.raises(MXNetError, match="spec_draft"):
        InferenceEngine(tnet, max_len=32, speculate=4, spec_draft=-1)
    with pytest.raises(MXNetError, match="speculate must be < max_len"):
        InferenceEngine(tnet, max_len=32, speculate=32)
    eng = InferenceEngine(tnet, max_batch_size=2, max_len=32, speculate=4)
    with pytest.raises(MXNetError, match="headroom"):
        eng.start().submit(list(range(1, 25)), 6)
    eng.shutdown()
