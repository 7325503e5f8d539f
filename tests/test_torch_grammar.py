"""Port parity of grammar-constrained decoding: ``mxnet_tpu_torch.serve.grammar``
(regex / JSON-schema -> token automaton, its device gathers, its cache
layers) and the engine's ``grammar=True`` against ``mxnet_tpu.serve.grammar``
and the JAX engine, on the CPU. Every comparison is bitwise: the tables are
int32 and bool, the gathers integer ops, and the engines' tokens equal."""
import json

import numpy as onp
import pytest
import torch

import jax.numpy as jnp
import mxnet_tpu as mx
from mxnet_tpu import np as mnp
from mxnet_tpu.contrib.quantization import quantize_net as jax_quantize_net
from mxnet_tpu.models import GPTModel as JaxGPT
from mxnet_tpu.models.gpt import GPTConfig as JaxGPTConfig
from mxnet_tpu.serve import InferenceEngine as JaxEngine
from mxnet_tpu.serve import grammar as jg

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.contrib.quantization import quantize_net
from mxnet_tpu_torch.interop import params_from_numpy
from mxnet_tpu_torch.models import GPTConfig, GPTModel
from mxnet_tpu_torch.serve import InferenceEngine, TokenGrammar, compile_grammar
from mxnet_tpu_torch.serve import grammar as tg

VOCAB, HIDDEN, LAYERS, HEADS, MAXPOS = 256, 256, 2, 4, 64
EOS = 0
# bench.py's conformance schema (bench_grammar_decode)
BENCH_SCHEMA = {"type": "object", "properties": {
    "ok": {"type": "boolean"}, "mode": {"enum": ["fast", "safe", "off"]},
    "n": {"enum": [0, 1, 2]}}}
SCHEMA = {"type": "object", "properties": {"ok": {"type": "boolean"},
                                           "mode": {"enum": ["fast", "safe"]}}}
SOURCES = {
    "dotstar": ".*",
    "digits": r"\d{2,4}",
    "alt_class": "(?:ab|c[d-f]+)x?",
    "negated": r"[^a-z]{1,3}\.",
    "hex_escape": r"\x41B[\w\s]*",
    "literal_brace": "a{b}c{2}",
    "bench_schema": BENCH_SCHEMA,
    "string_len": {"type": "string", "minLength": 1, "maxLength": 3},
    "integer": {"type": "integer"},
    "number_min": {"type": "number", "minimum": 0},
    "array": {"type": "array", "items": {"type": "boolean"}, "minItems": 1,
              "maxItems": 3},
    "nested": {"type": "object", "properties": {
        "a": {"type": "array", "items": {"type": "null"}},
        "b": {"const": {"x": 1}}, "c": {"type": "string", "pattern": "[0-9]+"}}},
}


# ---------------------------------------------------------------- the tables
def _same_grammar(a, b):
    assert (a.cls == b.cls).all() and a.cls.dtype == b.cls.dtype == onp.int32
    assert (a.nxt == b.nxt).all() and a.nxt.dtype == b.nxt.dtype == onp.int32
    assert (a.accept == b.accept).all() and a.accept.dtype == b.accept.dtype == bool
    assert (a.n_states, a.n_classes, a.vocab, a.key, a.source) == \
        (b.n_states, b.n_classes, b.vocab, b.key, b.source)


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_compiled_tables_equal_jax(name):
    """``cls``, ``nxt``, ``accept``, the cache key and the host methods
    equal the JAX package's, and a schema lowers to JAX's regex string."""
    src = SOURCES[name]
    want = jg.compile_grammar(src, VOCAB, cache=False)
    got = compile_grammar(src, VOCAB, cache=False)
    _same_grammar(got, want)
    if isinstance(src, dict):
        assert tg.schema_regex(src) == jg.schema_regex(src)
    for q in range(want.n_states):
        assert got.first_allowed(q) == want.first_allowed(q)
        assert (got.allowed(q) == want.allowed(q)).all()
    assert [got.padded_tables(64, 64)[i].tolist() for i in range(3)] == \
        [want.padded_tables(64, 64)[i].tolist() for i in range(3)]
    rng = onp.random.RandomState(len(name))
    for toks in ([], [ord(c) for c in "ab"], rng.randint(0, VOCAB, 6).tolist()):
        assert got.matches(toks, eos_token_id=EOS) == want.matches(toks, eos_token_id=EOS)


def test_compiled_tables_equal_jax_at_gpt2_vocab():
    """The bench's schema over GPT-2's vocab (50257 tokens, ``chr(id)``)."""
    _same_grammar(compile_grammar(BENCH_SCHEMA, 50257, cache=False),
                  jg.compile_grammar(BENCH_SCHEMA, 50257, cache=False))


def test_identity_tables_equal_jax():
    for got, want in zip(tg.identity_tables(VOCAB, 8, 4), jg.identity_tables(VOCAB, 8, 4)):
        assert got.dtype == want.dtype and (got == want).all()


@pytest.mark.parametrize("src,kw", [
    ("(?:a|b|c|d|e)(?:a|b|c|d|e)(?:a|b|c|d|e)(?:a|b|c|d|e)", {"max_states": 3}),
    ({"type": "tuple"}, {}),
    ({"type": "array", "minItems": 3, "maxItems": 2}, {}),
    ("(?=x)", {}),
    ("[b-a]", {}),
    ("ab(", {}),
    (3, {}),
], ids=["state_cap", "unsupported_schema", "max_items", "lookahead", "reversed",
        "unbalanced", "not_a_source"])
def test_compile_errors_raise_as_jax(src, kw):
    """The state cap, unsupported schemas and malformed regexes raise with
    the JAX package's message."""
    with pytest.raises(mx.MXNetError) as want:
        jg.compile_grammar(src, VOCAB, cache=False, **kw)
    with pytest.raises(MXNetError) as got:
        compile_grammar(src, VOCAB, cache=False, **kw)
    assert str(got.value) == str(want.value)


def test_class_cap_raises_as_jax():
    """More token classes than the cap raises as JAX does."""
    src = "(?:ab)*"
    tbl = [("a", "b", "ab", "ba", "x")[i % 5] for i in range(VOCAB)]
    with pytest.raises(mx.MXNetError) as want:
        jg.compile_grammar(src, VOCAB, token_table=tbl, max_states=2, cache=False)
    with pytest.raises(MXNetError) as got:
        compile_grammar(src, VOCAB, token_table=tbl, max_states=2, cache=False)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------- the gathers
def _tables(seed, B, V=VOCAB, N=6, C=5):
    rng = onp.random.RandomState(seed)
    gcls = rng.randint(0, C, (B, V)).astype(onp.int32)
    gnxt = rng.randint(-1, N, (B, N, C)).astype(onp.int32)
    gacc = rng.rand(B, N) < 0.5
    geos = rng.choice([-1, 0, 7], B).astype(onp.int32)
    return rng, gcls, gnxt, gacc, geos


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_grammar_mask_equals_jax(seed):
    """The [B, V] mask on seeded tables, states in and out of range."""
    rng, gcls, gnxt, gacc, geos = _tables(seed, 5)
    gstate = rng.randint(-2, 8, 5).astype(onp.int32)
    want = onp.asarray(jg.grammar_mask(jnp.asarray(gcls), jnp.asarray(gnxt),
                                       jnp.asarray(gacc), jnp.asarray(gstate),
                                       jnp.asarray(geos)))
    got = tg.grammar_mask(*(torch.from_numpy(a) for a in (gcls, gnxt, gacc, gstate, geos)))
    assert got.dtype == torch.bool and (got.numpy() == want).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_grammar_mask_multi_equals_jax(seed):
    """The [B, T, V] per-position masks of the verify."""
    rng, gcls, gnxt, gacc, geos = _tables(seed, 3)
    gstates = rng.randint(-1, 7, (3, 4)).astype(onp.int32)
    want = onp.asarray(jg.grammar_mask_multi(jnp.asarray(gcls), jnp.asarray(gnxt),
                                             jnp.asarray(gacc), jnp.asarray(gstates),
                                             jnp.asarray(geos)))
    got = tg.grammar_mask_multi(*(torch.from_numpy(a)
                                  for a in (gcls, gnxt, gacc, gstates, geos)))
    assert got.shape == (3, 4, VOCAB) and (got.numpy() == want).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_grammar_advance_equals_jax(seed):
    """The advanced states, EOS and forbidden tokens parking, token ids
    inside and outside the vocab."""
    rng, gcls, gnxt, gacc, geos = _tables(seed, 8)
    gstate = rng.randint(0, 6, 8).astype(onp.int32)
    toks = rng.randint(0, VOCAB, 8).astype(onp.int32)
    toks[:3] = [geos[0] if geos[0] >= 0 else 3, -1, VOCAB + 5]
    want = onp.asarray(jg.grammar_advance(jnp.asarray(gcls), jnp.asarray(gnxt),
                                          jnp.asarray(gstate), jnp.asarray(toks),
                                          jnp.asarray(geos)))
    got = tg.grammar_advance(*(torch.from_numpy(a) for a in (gcls, gnxt, gstate, toks, geos)))
    assert got.dtype == torch.int32 and (got.numpy() == want).all()


# ---------------------------------------------------------------- the cache
def test_disk_cache_is_shared_with_jax(tmp_path, monkeypatch):
    """An entry written by JAX is read by the port (without compiling) and
    the reverse; both packages hit their memory layer after."""
    monkeypatch.setenv("MXNET_GRAMMAR_CACHE_DIR", str(tmp_path))
    jg.clear_grammar_cache()
    tg.clear_grammar_cache()
    want = jg.compile_grammar(SCHEMA, VOCAB)
    assert len(list(tmp_path.glob("*.grammar"))) == 1

    def no_build(*a, **kw):
        raise AssertionError("compiled instead of reading the cache")

    monkeypatch.setattr(tg, "_build_token_grammar", no_build)
    got = compile_grammar(SCHEMA, VOCAB)
    _same_grammar(got, want)
    assert compile_grammar(SCHEMA, VOCAB) is got            # memory layer
    monkeypatch.undo()
    monkeypatch.setenv("MXNET_GRAMMAR_CACHE_DIR", str(tmp_path))
    got2 = compile_grammar(r"[0-9]+", VOCAB)
    jg.clear_grammar_cache()
    monkeypatch.setattr(jg, "_build_token_grammar", no_build)
    _same_grammar(got2, jg.compile_grammar(r"[0-9]+", VOCAB))
    assert len(list(tmp_path.glob("*.grammar"))) == 2
    jg.clear_grammar_cache()
    tg.clear_grammar_cache()


def test_disk_cache_evicts_a_corrupt_entry(tmp_path, monkeypatch):
    """A corrupt entry (payload edited, its hash unchanged) warns, is
    deleted and compiles anew, as in the JAX package."""
    monkeypatch.setenv("MXNET_GRAMMAR_CACHE_DIR", str(tmp_path))
    tg.clear_grammar_cache()
    compile_grammar("ab+", VOCAB)
    path, = tmp_path.glob("*.grammar")
    entry = json.loads(path.read_text())
    doc = json.loads(path.read_text())
    doc["payload"]["accept"][0] = not doc["payload"]["accept"][0]
    path.write_text(json.dumps(doc))
    tg.clear_grammar_cache()
    with pytest.warns(UserWarning, match="corrupt"):
        got = compile_grammar("ab+", VOCAB)
    _same_grammar(got, jg.compile_grammar("ab+", VOCAB, cache=False))
    assert json.loads(path.read_text()) == entry    # rewritten by the recompile
    tg.clear_grammar_cache()


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


def _prompts(n, seed=0, lo=4, hi=12):
    rng = onp.random.RandomState(seed)
    return [rng.randint(1, VOCAB, rng.randint(lo, hi)).astype(onp.int32) for _ in range(n)]


_LAYOUTS = {"contiguous": dict(paged=False), "paged": dict(paged=True, page_size=8)}


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
@pytest.mark.parametrize("source", ["regex", "schema"])
def test_grammar_engine_equals_jax(nets, layout, source):
    """A ``grammar=True`` engine (K = 1) over greedy and sampled
    constrained requests mixed with free ones (two slots, refills) gives
    the JAX engine's tokens; every constrained completion replays through
    the automaton."""
    jnet, tnet = nets
    src = {"regex": r"(?:yes|no)(?: [a-z]{1,6}){1,3}\.", "schema": SCHEMA}[source]
    g = compile_grammar(src, VOCAB)
    prompts = _prompts(5, seed=3)
    reqs = [(p, 40, dict(eos_token_id=EOS, seed=i, temperature=0.0 if i % 2 else 0.9,
                         top_k=0 if i != 3 else 16, **({"grammar": src} if i != 2 else {})))
            for i, p in enumerate(prompts)]
    kw = dict(max_batch_size=2, max_len=MAXPOS, grammar=True, **_LAYOUTS[layout])
    want, _ = _serve(JaxEngine, jnet, reqs, **kw)
    got, stats = _serve(InferenceEngine, tnet, reqs, warm=True, **kw)
    assert got == want
    assert stats["grammar"] is True and stats["speculate"] == 0
    for (p, n, rkw), toks in zip(reqs, got):
        if "grammar" in rkw:
            assert g.matches(toks, eos_token_id=EOS), bytes(toks)


@pytest.mark.parametrize("layout", list(_LAYOUTS))
def test_passthrough_grammar_is_the_free_stream(nets, layout):
    """``.*`` allows every token in every state: constrained requests on a
    grammar engine give the tokens of free requests on an engine built
    without grammar, greedy and sampled."""
    _, tnet = nets
    prompts = _prompts(4, seed=5)
    mix = [dict(seed=i, temperature=[0.0, 0.8, 1.1, 0.0][i], eos_token_id=EOS)
           for i in range(4)]
    kw = dict(max_batch_size=2, max_len=MAXPOS, **_LAYOUTS[layout])
    free, _ = _serve(InferenceEngine, tnet, [(p, 20, m) for p, m in zip(prompts, mix)], **kw)
    cons, _ = _serve(InferenceEngine, tnet,
                     [(p, 20, dict(m, grammar=".*")) for p, m in zip(prompts, mix)],
                     grammar=True, **kw)
    assert cons == free


def test_constrained_request_resumes_after_preemption(nets):
    """A constrained request preempted on a pool too small for two (its
    resume re-prefills prompt + generated and walks the automaton over the
    generated tokens) gives the tokens of an uninterrupted run."""
    _, tnet = nets
    src = r"(?:[a-z]{2,5} ){2,4}[a-z]{1,4}\."
    prompts = _prompts(2, seed=7, lo=10, hi=12)
    reqs = [(p, 40, dict(eos_token_id=EOS, seed=i, grammar=src)) for i, p in enumerate(prompts)]
    alone, _ = _serve(InferenceEngine, tnet, reqs, max_batch_size=1, max_len=MAXPOS,
                      paged=True, page_size=8, grammar=True)
    tight, stats = _serve(InferenceEngine, tnet, reqs, max_batch_size=2, max_len=MAXPOS,
                          paged=True, page_size=8, num_pages=8, grammar=True)
    assert stats["preemptions"] > 0
    assert tight == alone
    g = compile_grammar(src, VOCAB)
    assert all(g.matches(t, eos_token_id=EOS) for t in tight)


def test_token0_is_masked(nets):
    """A grammar that allows a single first character makes token 0 that
    character in both layouts, as in the JAX engine."""
    jnet, tnet = nets
    prompts = _prompts(2, seed=9)
    reqs = [(p, 3, dict(eos_token_id=EOS, grammar="Q[a-c]+")) for p in prompts]
    for layout in _LAYOUTS.values():
        got, _ = _serve(InferenceEngine, tnet, reqs, max_batch_size=2, max_len=MAXPOS,
                        grammar=True, **layout)
        want, _ = _serve(JaxEngine, jnet, reqs, max_batch_size=2, max_len=MAXPOS,
                         grammar=True, **layout)
        assert got == want and all(t[0] == ord("Q") for t in got)


def test_submit_validation(nets):
    """The validation errors of the JAX engine's grammar gates
    (``tests/test_grammar.py:test_submit_validation``)."""
    _, tnet = nets
    plain = InferenceEngine(tnet, max_batch_size=1, max_len=MAXPOS).start()
    try:
        with pytest.raises(MXNetError, match="without grammar support"):
            plain.submit([1, 2], 4, grammar=SCHEMA, eos_token_id=EOS)
    finally:
        plain.shutdown()
    with pytest.raises(MXNetError, match="mutually exclusive"):
        InferenceEngine(tnet, max_len=MAXPOS, grammar=True, multi_token=2)
    eng = InferenceEngine(tnet, max_batch_size=1, max_len=MAXPOS, grammar=True).start()
    try:
        with pytest.raises(MXNetError, match="eos_token_id"):
            eng.submit([1, 2], 4, grammar=SCHEMA)
        with pytest.raises(MXNetError, match="vocab"):
            eng.submit([1, 2], 4, grammar=compile_grammar(SCHEMA, 64), eos_token_id=EOS)
        big = TokenGrammar(onp.zeros(VOCAB, onp.int32), onp.zeros((65, 1), onp.int32),
                           onp.ones(65, bool), VOCAB, key="big", source="big")
        with pytest.raises(MXNetError, match="serve_grammar_max_states=64"):
            eng.submit([1, 2], 4, grammar=big, eos_token_id=EOS)
        assert eng.stats()["grammar"] is True
    finally:
        eng.shutdown()
