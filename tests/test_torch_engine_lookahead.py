"""Port parity of the engine's decode lookahead and warm-up: the port's
``InferenceEngine(lookahead=True|False)`` and ``warmup()`` against the JAX
package's engine and ``generate()`` on the CPU, where every step of the
bucket ladder is its function run eagerly (on the card the same steps are
captured CUDA graphs: ``tests/test_torch_cuda_kernels.py``). Also the
pieces a captured step is made of: the dispatch keys hashed into a host
buffer (``_prng.step_keys``) and ``decode_multi_tokens`` /
``sample_tokens`` fed device tensors and host decisions, each against the
JAX function."""
import threading

import numpy as onp
import pytest
import torch

import jax
import jax.numpy as jnp
import mxnet_tpu as mx
from mxnet_tpu import np as mnp
from mxnet_tpu.contrib.quantization import quantize_net as jax_quantize_net
from mxnet_tpu.models import GPTModel as JaxGPT
from mxnet_tpu.models import generate as jax_generate
from mxnet_tpu.models import generation as jgen
from mxnet_tpu.models.gpt import GPTConfig as JaxGPTConfig
from mxnet_tpu.ndarray import NDArray
from mxnet_tpu.parallel.functional import functionalize
from mxnet_tpu.serve import InferenceEngine as JaxEngine

from mxnet_tpu_torch import _prng
from mxnet_tpu_torch.contrib.quantization import quantize_net
from mxnet_tpu_torch.interop import params_from_numpy
from mxnet_tpu_torch.models import GPTConfig, GPTModel, generate
from mxnet_tpu_torch.models import generation as gen
from mxnet_tpu_torch.serve import InferenceEngine
from mxnet_tpu_torch.serve.bucketing import bucket_ladder

VOCAB, HIDDEN, LAYERS, HEADS, MAXPOS = 64, 64, 2, 4, 64
MAX_LEN = 32


def _pair(quantized):
    """A JAX GPT (2 layers, D 64) and the port's GPT with the same N(0, 0.1)
    weights (LayerNorm gains about 1), both int8 with fused decode where
    ``quantized``."""
    cfg = dict(vocab_size=VOCAB, hidden_size=HIDDEN, num_layers=LAYERS,
               num_heads=HEADS, max_position_embeddings=MAXPOS, dropout=0.0)
    mx.random.seed(0)
    jnet = JaxGPT(JaxGPTConfig(**cfg))
    jnet.initialize()
    jnet(mnp.array(onp.zeros((1, 4), "int32")))
    rng = onp.random.RandomState(3)
    for name, p in jnet.collect_params().items():
        base = 1.0 if name.endswith("gamma") else 0.0
        p.set_data(mnp.array((base + 0.1 * rng.randn(*p.shape)).astype("float32")))
    named = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    tnet = GPTModel(GPTConfig(**cfg), device="cpu")
    params_from_numpy(tnet, named)
    if quantized:
        jax_quantize_net(jnet, calib_mode="none", fused_decode=True)
        quantize_net(tnet, fused_decode=True)
    return jnet, tnet


@pytest.fixture(scope="module")
def plain():
    """Full precision: a multi_token engine samples from the logits with
    ``sample_tokens``, JAX's stream for every row."""
    return _pair(False)


@pytest.fixture(scope="module")
def fused():
    """int8 with fused decode and the fused head (K8's plain version):
    greedy rows are JAX's, unfiltered T > 0 rows follow K8's stream."""
    return _pair(True)


def _prompts(n, lo=3, hi=10, seed=0):
    rng = onp.random.RandomState(seed)
    return [rng.randint(1, VOCAB, size=rng.randint(lo, hi)).astype(onp.int32)
            for _ in range(n)]


_LAYOUTS = {"contiguous": dict(paged=False), "paged": dict(paged=True, page_size=8)}
# (max_new_tokens, temperature, top_k, top_p, seed): lengths that end at
# and next to a lookahead boundary, greedy, plain, top-k and top-p rows
_MIX = [(1, 0.0, 0, 1.0, 1), (2, 0.9, 0, 1.0, 2), (5, 0.0, 0, 1.0, 3),
        (8, 0.8, 8, 1.0, 4), (3, 1.1, 0, 0.9, 5), (6, 0.0, 0, 1.0, 6)]


def _serve(engine_cls, net, prompts, mix, **kw):
    """Submit every request at once to one engine; returns (token lists,
    stats)."""
    eng = engine_cls(net, **kw).start()
    try:
        hs = [eng.submit(p, n, temperature=t, top_k=k, top_p=pp, seed=s)
              for p, (n, t, k, pp, s) in zip(prompts, mix)]
        res = [h.result(timeout=300) for h in hs]
        stats = eng.stats()
    finally:
        eng.shutdown(drain=True, timeout=300)
    assert all(r.status == "ok" for r in res), [r.error for r in res]
    return [list(r.generated_ids) for r in res], stats


@pytest.mark.parametrize("K", [1, 4], ids=["k1", "k4"])
@pytest.mark.parametrize("layout", list(_LAYOUTS))
def test_lookahead_parity_with_sync_engine(plain, layout, K):
    """Lookahead (dispatch N+1 before reading N) gives the tokens of the
    synchronous engine and of the JAX engine, greedy and sampled rows, with
    mid-flight refills (6 requests through 2 slots, lengths ending at and
    next to the boundary); greedy rows equal ``generate()`` of both
    packages. Steps are built as traffic first needs them, mid-flight."""
    jnet, tnet = plain
    prompts = _prompts(6, seed=5)
    kw = dict(max_batch_size=2, max_len=MAX_LEN, multi_token=K, **_LAYOUTS[layout])
    want, _ = _serve(JaxEngine, jnet, prompts, _MIX, **kw)
    outs = {}
    for la in (False, True):
        outs[la], stats = _serve(InferenceEngine, tnet, prompts, _MIX, lookahead=la, **kw)
        assert stats["lookahead"] == la and stats["multi_token"] == K
        assert stats["max_active"] == 2
    assert outs[True] == outs[False] == want
    for p, (n, t, *_), got in zip(prompts, _MIX, outs[True]):
        if t == 0.0:
            ids = p[None, :]
            assert got == generate(tnet, ids, n).numpy()[0, len(p):].tolist()
            assert got == jax_generate(jnet, mnp.array(ids), n).asnumpy()[0, len(p):].tolist()


@pytest.mark.parametrize("layout", list(_LAYOUTS))
def test_lookahead_parity_fused_head(fused, layout):
    """A ``multi_token=4`` engine over the fused head (K8's plain version)
    and fused blocks: lookahead gives the synchronous engine's tokens in
    every row (greedy, K8-sampled and filtered, refills mid-flight), and
    greedy rows are ``generate()``'s of both packages."""
    jnet, tnet = fused
    prompts = _prompts(6, seed=6)
    kw = dict(max_batch_size=2, max_len=MAX_LEN, multi_token=4, **_LAYOUTS[layout])
    outs = {la: _serve(InferenceEngine, tnet, prompts, _MIX, lookahead=la, **kw)[0]
            for la in (False, True)}
    assert outs[True] == outs[False]
    for p, (n, t, *_), got in zip(prompts, _MIX, outs[True]):
        if t == 0.0:
            ids = p[None, :]
            want = jax_generate(jnet, mnp.array(ids), n, multi_token=4).asnumpy()
            assert got == want[0, len(p):].tolist()


@pytest.mark.parametrize("layout", list(_LAYOUTS))
def test_lookahead_eos_at_boundary(plain, layout):
    """EOS landing while a lookahead step is in flight: the retired slot's
    speculative token is discarded, so the output ends at the first eos,
    ``generate()``'s truncation (JAX's and the port's)."""
    jnet, tnet = plain
    p = onp.array([7, 2, 9], onp.int32)
    ref = jax_generate(jnet, mnp.array(p[None, :]), 8).asnumpy()[0, 3:].tolist()
    assert ref == generate(tnet, p[None, :], 8).numpy()[0, 3:].tolist()
    eng = InferenceEngine(tnet, max_batch_size=1, max_len=MAX_LEN, lookahead=True,
                          **_LAYOUTS[layout]).start()
    try:
        # token 0 (prefill), the first lookahead boundary and the last token
        for k in (0, 1, len(ref) - 1):
            eos = int(ref[k])
            r = eng.generate(p, 8, eos_token_id=eos, timeout=300)
            assert r.status == "ok"
            assert r.generated_ids == ref[:ref.index(eos) + 1], f"eos at {k}"
    finally:
        eng.shutdown()


@pytest.mark.parametrize("layout", list(_LAYOUTS))
def test_lookahead_dispatch_failure_salvages_pending_tokens(plain, layout):
    """A failing decode dispatch does not lose the pending step's computed
    tokens: they are read first, so a request that completes on them
    retires OK and an unfinished one errors with every token so far."""
    jnet, tnet = plain
    p = onp.array([4, 2, 7], onp.int32)
    ref = jax_generate(jnet, mnp.array(p[None, :]), 6).asnumpy()[0, 3:].tolist()

    def run(max_new):
        eng = InferenceEngine(tnet, max_batch_size=1, max_len=MAX_LEN,
                              **_LAYOUTS[layout]).start()
        try:
            orig = eng._get_step
            calls = {"n": 0}

            def flaky(*key):
                step = orig(*key)

                def wrapped():
                    calls["n"] += 1
                    if calls["n"] == 3:     # the third decode dispatch dies
                        raise RuntimeError("injected dispatch failure")
                    return step()
                return wrapped
            eng._get_step = flaky
            return eng.generate(p, max_new, timeout=300)
        finally:
            eng.shutdown()

    r = run(10)
    assert r.status == "error"
    assert r.generated_ids == ref[:3]
    r = run(3)
    assert r.status == "ok"
    assert r.generated_ids == ref[:3]


def _ladder(eng):
    """The decode steps and chunk buckets ``warmup()`` must build."""
    branches = ("fused", "filtered") if eng._head is not None else ("greedy", "sampled")
    decode = sorted((sb, st, b) for sb in bucket_ladder(1, eng.S)
                    for st in range(1, eng.K + 1) for b in branches)
    prefill = (bucket_ladder(eng.min_prompt_bucket, eng._chunk) if eng._paged else [])
    return {"prefill": prefill, "decode": decode}


@pytest.mark.parametrize("K", [1, 4], ids=["k1", "k4"])
def test_zero_recompiles_after_warmup(plain, fused, K):
    """``warmup()`` builds the whole ladder (every batch bucket x substep
    count x branch), sets ``last_warmup_s`` and is idempotent; then 8
    concurrent mixed requests (greedy, sampled, top-k) from client threads
    build nothing: ``compiled_buckets`` and ``captures`` stay put. Greedy
    rows equal JAX ``generate()``."""
    jnet, tnet = fused if K == 4 else plain
    eng = InferenceEngine(tnet, max_batch_size=4, max_len=MAX_LEN, min_prompt_bucket=8,
                          multi_token=K).start()
    try:
        assert eng.stats()["last_warmup_s"] is None
        assert eng.warmup() is eng
        stats = eng.stats()
        buckets, captures = stats["compiled_buckets"], stats["captures"]
        assert buckets == _ladder(eng) and captures == len(buckets["decode"])
        assert stats["last_warmup_s"] > 0
        eng.warmup()
        assert eng.stats()["captures"] == captures
        prompts = _prompts(8, lo=2, hi=20, seed=3)
        results, errors = [None] * 8, []

        def client(i):
            try:
                results[i] = eng.generate(prompts[i], 6 + i % 5, temperature=0.5 * (i % 2),
                                          top_k=4 * (i % 2), seed=i, timeout=300)
            except Exception as e:  # noqa: BLE001 - surfaced below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        after = eng.stats()
    finally:
        eng.shutdown()
    assert not errors
    assert all(r is not None and r.status == "ok" for r in results)
    assert after["compiled_buckets"] == buckets and after["captures"] == captures
    for i in range(0, 8, 2):
        p = prompts[i]
        want = jax_generate(jnet, mnp.array(p[None, :]), 6 + i % 5).asnumpy()[0, len(p):]
        assert results[i].generated_ids == want.tolist()


def test_4x_concurrency_on_contiguous_hbm_budget(plain):
    """The paged counterpart: a pool of exactly the contiguous 4-slot x 32
    footprint (16 pages of 8) serves 16 concurrent requests after
    ``warmup()`` (decode steps and the chunk buckets 8 and 16 built) with
    nothing built while serving, about 4x the slots, and ``generate()``'s
    tokens."""
    jnet, tnet = plain
    prompts = _prompts(16, lo=3, hi=6, seed=7)
    eng = InferenceEngine(tnet, max_batch_size=16, max_len=32, paged=True, page_size=8,
                          num_pages=16, prefix_cache=False, max_queue_depth=32,
                          prefill_chunk=16).start()
    try:
        eng.warmup()
        stats = eng.stats()
        buckets, captures = stats["compiled_buckets"], stats["captures"]
        assert buckets == _ladder(eng) and buckets["prefill"] == [8, 16]
        assert captures == len(buckets["decode"]) + 2
        handles = [eng.submit(prompts[i], 3, seed=i) for i in range(16)]
        results = [h.result(300) for h in handles]
        after = eng.stats()
    finally:
        eng.shutdown()
    assert all(r.status == "ok" for r in results)
    assert after["max_active"] >= 12
    assert after["compiled_buckets"] == buckets and after["captures"] == captures
    for p, r in zip(prompts, results):
        want = jax_generate(jnet, mnp.array(p[None, :]), 3).asnumpy()[0, len(p):]
        assert list(r.generated_ids) == want.tolist()
    eng._pages.check_consistent()
    assert eng._pages.pages_in_use() == 0


def test_stats_and_constructor_keys(plain):
    """The JAX engine's keyword and ``stats()`` keys exist with its
    meaning: ``InferenceEngine(lookahead=False)`` is accepted, lookahead is
    on by default, ``multi_token`` and an empty ladder before any step."""
    _, tnet = plain
    eng = InferenceEngine(tnet, max_len=MAX_LEN, lookahead=False)
    st = eng.stats()
    assert st["lookahead"] is False and st["multi_token"] == 1
    assert st["compiled_buckets"] == {"prefill": [], "decode": []}
    assert st["captures"] == 0 and st["last_warmup_s"] is None
    assert InferenceEngine(tnet, max_len=MAX_LEN).stats()["lookahead"] is True


# ---------------------------------------------------------------------------
# the pieces of a captured step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("steps", [1, 4])
def test_step_keys_bitwise(steps):
    """A dispatch's [steps, B, 2] keys hashed into a host buffer equal
    ``fold_keys`` at each substep's counter and ``jax.random.fold_in`` bit
    for bit, 32-bit seeds and counters past 2**31 included."""
    seeds = onp.array([0, 1, 0xFFFFFFFF, 12345, 2**31 + 7], onp.int64)
    counters = onp.array([0, 5, 2**31 - 2, 2**32 - 3, 77], onp.int64)
    buf = onp.full((steps, len(seeds), 2), -1, onp.int64)
    out = _prng.step_keys(seeds, counters, steps, out=buf)
    assert out is buf
    for j in range(steps):
        assert (buf[j] == _prng.fold_keys(seeds, counters + j).numpy()).all()
        want = jax.vmap(lambda s, c: jax.random.key_data(
            jax.random.fold_in(jax.random.key(s), c)))(
            jnp.asarray(seeds, jnp.uint32), jnp.asarray(counters + j, jnp.uint32))
        assert (buf[j] == onp.asarray(want).astype(onp.int64)).all()


# (temperatures, top-k, top-p) per row of a 4-row batch; "filtered_greedy"
# rows are all greedy, some with top-k or top-p
_ROWS = {"greedy": ([0.0] * 4, [0] * 4, [1.0] * 4),
         "sampled": ([0.9, 0.0, 1.2, 0.7], [0, 0, 6, 0], [1.0, 1.0, 1.0, 0.85]),
         "filtered_greedy": ([0.0] * 4, [5, 0, 0, 3], [1.0, 0.9, 1.0, 1.0])}


def _prefilled(jnet, tnet, ids):
    """Both packages' caches after prefilling ``ids`` [B, P], and the
    functional view of the JAX model."""
    B, P = ids.shape
    fm = functionalize(jnet, NDArray(jnp.zeros((1, 8), jnp.int32)), training=False)
    values = tuple(fm.values())
    jc = [jnp.zeros(s, d) for s, d in jnet.cache_spec(B, MAX_LEN)]
    _, jc = jgen.decode_step(fm, values, jnp.asarray(ids), 0, jc)
    tc = tnet.new_caches(B, MAX_LEN)
    gen.decode_step(tnet, torch.from_numpy(ids), 0, tc)
    return fm, values, jc, tc


@pytest.mark.parametrize("rows", list(_ROWS))
@pytest.mark.parametrize("model", ["plain", "fused"])
def test_decode_multi_tokens_device_inputs_match_jax(plain, fused, model, rows):
    """``decode_multi_tokens`` fed [B] tensors, the dispatch's keys from
    ``step_keys`` and the host's decisions (substeps, branch, greedy) gives
    the JAX function's tokens, last tokens and written cache rows: on the
    logits path for every row kind, on the fused head for greedy rows and
    for a filtered batch (``sample_tokens`` on the head logits). Substeps
    past the budget are not run (``steps`` 3 of K 4)."""
    temps, topks, topps = _ROWS[rows]
    _device_inputs_match_jax(plain if model == "plain" else fused, model, rows,
                             any(k > 0 for k in topks) or any(p < 1.0 for p in topps))


def test_fused_branch_greedy_rows_with_topk_match_jax(fused):
    """The engine sends a batch with no row at T > 0 to the fused head
    (K8's argmax) even when some row sets top-k or top-p: its tokens,
    last tokens and cache rows equal the JAX function's, which takes the
    filtered branch for that batch."""
    _device_inputs_match_jax(fused, "fused", "filtered_greedy", False)


def _device_inputs_match_jax(nets, model, rows, filtered):
    """``decode_multi_tokens`` on device inputs and host decisions, with
    the fused head's branch named by ``filtered``, against JAX's."""
    jnet, tnet = nets
    temps, topks, topps = _ROWS[rows]
    B, P, K = 4, 5, 4
    ids = onp.random.RandomState(11).randint(1, VOCAB, (B, P)).astype(onp.int32)
    fm, values, jc, tc = _prefilled(jnet, tnet, ids)
    tok = onp.random.RandomState(12).randint(1, VOCAB, B).astype(onp.int32)
    seeds = onp.array([3, 4, 5, 6], onp.int64)
    counters = onp.array([1, 9, 2, 30], onp.int64)
    eos = onp.array([-1, 7, -1, 3], onp.int64)
    rem = onp.array([3, 2, 1, 3], onp.int64)
    head = jnet.head_weights() if model == "fused" else None
    jt, jlast, jsteps, _, jc = jgen.decode_multi_tokens(
        fm, values, jnp.asarray(tok), jnp.full((B,), P, jnp.int32), jc, K,
        jnp.asarray(temps, jnp.float32), jnp.asarray(topks), jnp.asarray(topps, jnp.float32),
        jnp.asarray(seeds, jnp.uint32), jnp.asarray(counters, jnp.int32),
        eos_ids=jnp.asarray(eos, jnp.int32), remaining=jnp.asarray(rem, jnp.int32),
        head=head)
    keys = torch.from_numpy(_prng.step_keys(seeds, counters, K))
    with torch.no_grad():
        tt, tlast, tsteps, _, tc = gen.decode_multi_tokens(
            tnet, torch.from_numpy(tok), torch.full((B,), P, dtype=torch.int32), tc, K,
            torch.tensor(temps, dtype=torch.float32), eos_ids=torch.from_numpy(eos).int(),
            remaining=torch.from_numpy(rem).int(), head=tnet.head_weights(),
            topks=torch.tensor(topks, dtype=torch.int32), topps=torch.tensor(topps),
            keys=keys, steps=3, filtered=filtered, greedy=all(t == 0 for t in temps))
    assert int(jsteps) == tsteps == 3
    assert (tt.numpy() == onp.asarray(jt)).all()
    assert (tlast.numpy() == onp.asarray(jlast)).all()
    for a, b in zip(jc, tc):
        written = onp.asarray(a)[:, :, :P + 3]
        assert onp.allclose(b.numpy()[:, :, :P + 3], written, atol=1e-5)


@pytest.mark.parametrize("rows", list(_ROWS))
def test_sample_tokens_device_params_match_jax(rows):
    """``sample_tokens`` with [B] tensor parameters and the host's
    ``greedy`` decision equals the JAX function (and the port's own
    undecided call), greedy, sampled, top-k and top-p rows."""
    temps, topks, topps = _ROWS[rows]
    B, V = 4, 97
    logits = onp.random.RandomState(13).randn(B, V).astype(onp.float32) * 3
    seeds, counters = onp.arange(4, dtype=onp.int64) + 20, onp.arange(4, dtype=onp.int64)
    want = jgen.sample_tokens(jnp.asarray(logits), jgen._fold_keys(
        jnp.asarray(seeds, jnp.uint32), jnp.asarray(counters, jnp.int32)),
        jnp.asarray(temps, jnp.float32), jnp.asarray(topks), jnp.asarray(topps, jnp.float32))
    keys = _prng.fold_keys(seeds, counters)
    args = (torch.from_numpy(logits), keys, torch.tensor(temps),
            torch.tensor(topks, dtype=torch.int32), torch.tensor(topps))
    got = gen.sample_tokens(*args, greedy=all(t == 0 for t in temps))
    assert (got.numpy() == onp.asarray(want)).all()
    assert (gen.sample_tokens(*args).numpy() == got.numpy()).all()
    if all(t == 0 for t in temps):
        # the sampling branch on all-greedy rows picks each row's argmax too
        assert (gen.sample_tokens(*args, greedy=False).numpy() == got.numpy()).all()


@pytest.mark.parametrize("enabled", [True, False])
def test_no_collection_keeps_the_collector_off_then_restores_it(enabled):
    """The engine captures a graph inside ``_no_collection``: the cyclic
    collector is off there and back to its earlier state after, also when
    the block raises."""
    import gc

    from mxnet_tpu_torch.serve.engine import _no_collection
    was = gc.isenabled()
    (gc.enable if enabled else gc.disable)()
    try:
        with pytest.raises(RuntimeError):
            with _no_collection():
                assert not gc.isenabled()
                raise RuntimeError("capture failed")
        assert gc.isenabled() == enabled
    finally:
        (gc.enable if was else gc.disable)()
