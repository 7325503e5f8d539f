"""Port parity of paged serving: the ``PagePool`` ledger against the JAX
package's, and the port's ``InferenceEngine(paged=True)`` on the CPU (the
plain versions of K6, K7 and K8) against the JAX package's ``generate()``
with copied weights and against the port's contiguous engine: plain and
multi-token decode, prefix reuse with copy-on-write forks, preemption with
exact resume, and chunked prefill interleaved with decode."""
import time

import numpy as onp
import pytest

import mxnet_tpu as mx
from mxnet_tpu import np as mnp
from mxnet_tpu.contrib.quantization import quantize_net as jax_quantize_net
from mxnet_tpu.models import GPTModel as JaxGPT
from mxnet_tpu.models import generate as jax_generate
from mxnet_tpu.models.gpt import GPTConfig as JaxGPTConfig
from mxnet_tpu.serve import paging as jpaging

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.contrib.quantization import quantize_net
from mxnet_tpu_torch.interop import params_from_numpy
from mxnet_tpu_torch.models import GPTConfig, GPTModel
from mxnet_tpu_torch.ops.int8_gemv import launches, reset_launches
from mxnet_tpu_torch.serve import InferenceEngine
from mxnet_tpu_torch.serve import paging as tpaging

VOCAB, HIDDEN, LAYERS, HEADS, MAXPOS = 256, 256, 2, 4, 64


# ------------------------------------------------------------ the ledger
def _ledgers_equal(jp, tp):
    assert (jp._tables == tp._tables).all()
    assert (jp._ref == tp._ref).all()
    assert jp._free == tp._free
    assert (jp._leased == tp._leased).all()
    assert jp.stats() == tp.stats()
    assert jp.cached_pages() == tp.cached_pages()
    jp.check_consistent()
    tp.check_consistent()


def _both(jp, tp, name, *args):
    """Call ``name`` on both pools: the same result or the same error."""
    out = []
    for pool in (jp, tp):
        try:
            out.append(("ok", getattr(pool, name)(*args)))
        except (jpaging.OutOfPages, tpaging.OutOfPages) as e:
            out.append(("out_of_pages", type(e).__name__))
    assert out[0] == out[1], (name, args, out)
    return out[0]


def test_page_ledger_matches_jax():
    """One seeded sequence of lease / match + map_prefix / insert_prefix /
    writable + fork / release / LRU eviction / OutOfPages through both
    ``PagePool``s: after every step equal tables, refcounts, free lists,
    ``stats()``, and ``check_consistent()`` passes on both."""
    rng = onp.random.RandomState(0)
    args = (12, 4, 16, 4)                 # pages, page size, max_len, slots
    jp, tp = jpaging.PagePool(*args), tpaging.PagePool(*args)
    systems = [rng.randint(0, 50, n).tolist() for n in (6, 9, 13)]
    kinds = {"out_of_pages": 0, "fork": 0, "hit": 0, "evict": 0}
    for step in range(400):
        slot = int(rng.randint(4))
        op = rng.choice(["lease", "prefix", "fork", "release", "clear"],
                        p=[0.3, 0.3, 0.2, 0.17, 0.03])
        if op == "lease":
            res = _both(jp, tp, "lease", slot, int(rng.randint(1, 17)))
            kinds["out_of_pages"] += res[0] == "out_of_pages"
        elif op == "prefix" and tp._leased[slot] == 0:
            toks = systems[rng.randint(3)] + rng.randint(0, 50, rng.randint(0, 4)).tolist()
            _, (pages, matched) = _both(jp, tp, "match_prefix", toks)
            kinds["hit"] += matched > 0
            if matched:
                _both(jp, tp, "map_prefix", slot, pages, matched)
            # the engine's prefill: lease, fork the shared pages it writes
            # (a mapped partial tail), publish
            if _both(jp, tp, "lease", slot, len(toks))[0] == "ok":
                _, spans = _both(jp, tp, "writable", slot, matched, len(toks))
                if all(_both(jp, tp, "fork", slot, ti)[0] == "ok" for ti, _ in spans):
                    kinds["fork"] += len(spans) > 0
                    _both(jp, tp, "insert_prefix", slot, toks)
        elif op == "fork":
            start = int(rng.randint(0, 16))
            _, spans = _both(jp, tp, "writable", slot, start, min(16, start + 4))
            for ti, _ in spans:
                res = _both(jp, tp, "fork", slot, ti)
                kinds["fork"] += res[0] == "ok"
        elif op == "release":
            _both(jp, tp, "release", slot)
        elif op == "clear":
            _both(jp, tp, "clear_prefix_cache")
        _ledgers_equal(jp, tp)
    kinds["evict"] = tp.stats()["prefix_evictions"]
    assert all(kinds.values()), kinds     # every path of the ledger was taken
    assert tpaging.prefix_key([1, 2, 3]) == jpaging.prefix_key([1, 2, 3])
    assert tpaging.pages_for(17, 4) == jpaging.pages_for(17, 4) == 5


def test_page_pool_refuses_bad_geometry():
    with pytest.raises(MXNetError, match="multiple of page_size"):
        tpaging.PagePool(8, 16, 40, 2)
    with pytest.raises(MXNetError, match="cannot hold"):
        tpaging.PagePool(2, 16, 64, 2)


# ------------------------------------------------------------ the engine
@pytest.fixture(scope="module")
def nets():
    """``tests/test_torch_gpt_serve.py``'s pair: a JAX GPT and the port's
    GPT with the same N(0, 0.1) weights, both int8 with fused decode."""
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


def _prompts(lengths, seed):
    rng = onp.random.RandomState(seed)
    return [rng.randint(0, VOCAB, n).astype("int32").tolist() for n in lengths]


def _jax_tokens(jnet, prompts, new, multi_token):
    """JAX ``generate()`` per prompt (prompts of one length batched)."""
    out = {}
    for n in sorted({len(p) for p in prompts}):
        idx = [i for i, p in enumerate(prompts) if len(p) == n]
        k = max(new[i] for i in idx)
        got = jax_generate(jnet, mnp.array(onp.asarray([prompts[i] for i in idx], "int32")),
                           k, multi_token=multi_token).asnumpy()
        for r, i in enumerate(idx):
            out[i] = got[r, n:n + new[i]].tolist()
    return [out[i] for i in range(len(prompts))]


def _serve(net, prompts, new, sequential=0, **kw):
    """Serve ``prompts`` (the first ``sequential`` one at a time, the rest
    together); returns (tokens per request, stats, engine)."""
    reset_launches()
    eng = InferenceEngine(net, **kw).start()
    try:
        toks = [eng.generate(p, n, timeout=120).generated_ids
                for p, n in zip(prompts[:sequential], new[:sequential])]
        handles = [eng.submit(p, n) for p, n in zip(prompts[sequential:], new[sequential:])]
        res = [h.result(timeout=120) for h in handles]
        assert all(r.ok for r in res), [r.error for r in res]
        toks += [r.generated_ids for r in res]
    finally:
        eng.shutdown(drain=True, timeout=120)
    return toks, eng.stats(), eng


def _drained(eng):
    """After the drain, with the prefix cache cleared, no page is held."""
    eng._pages.clear_prefix_cache()
    eng._pages.check_consistent()
    assert eng._pages.pages_in_use() == 0


@pytest.mark.parametrize("multi_token", [1, 4])
def test_paged_engine_matches_jax_generate(nets, multi_token):
    """Six greedy requests through a 4-slot paged engine (page 8): tokens
    equal JAX ``generate()`` and the port's contiguous engine; every decode
    substep runs each block through the K6 route, and the K8 head at
    multi_token 4."""
    jnet, tnet = nets
    lengths = [3, 9, 3, 12, 9, 12]
    prompts = _prompts(lengths, seed=3)
    new = [10, 7, 12, 5, 9, 11]
    want = _jax_tokens(jnet, prompts, new, multi_token)
    got, stats, eng = _serve(tnet, prompts, new, max_batch_size=4, max_len=MAXPOS,
                             multi_token=multi_token, paged=True, page_size=8)
    assert got == want
    counts = launches()
    assert counts["fused_block_paged"] == LAYERS * stats["decode_substeps"]
    assert "fused_block" not in counts and "fused_block_paged_dma" not in counts
    assert ("fused_head" in counts) == (multi_token > 1)
    assert stats["paged"] and stats["page_size"] == 8 and stats["completed"] == {"ok": 6}
    # the default pool holds the contiguous layout's bytes, plus the sink
    assert stats["kv_bytes"] == 2 * LAYERS * (4 * MAXPOS // 8 + 1) * HEADS * 8 * 64 * 4
    _drained(eng)
    contiguous, _, _ = _serve(tnet, prompts, new, max_batch_size=4, max_len=MAXPOS,
                              multi_token=multi_token, paged=False)
    assert contiguous == got


def test_prefix_reuse_forks_and_matches(nets):
    """Five requests sharing a 21-token system prompt: the first, served
    alone, publishes it; the other four map its pages (prefix hits) and
    prefill only their own tokens. Prompt tails that are not page-aligned
    are shared pages, copied before the first write (COW forks). Tokens
    equal JAX ``generate()`` at multi_token 4 and the contiguous engine."""
    jnet, tnet = nets
    system = _prompts([21], seed=5)[0]
    prompts = [system + own for own in _prompts([3, 6, 2, 11, 5], seed=6)]
    new = [8] * 5
    want = _jax_tokens(jnet, prompts, new, 4)
    got, stats, eng = _serve(tnet, prompts, new, sequential=1, max_batch_size=4,
                             max_len=MAXPOS, multi_token=4, paged=True, page_size=8)
    assert got == want
    pages = stats["pages"]
    assert pages["prefix_hits"] >= len(prompts) - 1 and pages["cow_forks"] > 0
    assert pages["prefix_tokens_saved"] >= 16 * (len(prompts) - 1)
    _drained(eng)
    contiguous, _, _ = _serve(tnet, prompts, new, max_batch_size=4, max_len=MAXPOS,
                              multi_token=4, paged=False)
    assert contiguous == got


def test_preemption_resumes_exactly(nets):
    """An 8-page pool (one max_len request) under four concurrent requests
    that together need about 20 pages: decode growth preempts the youngest
    request, which later resumes by re-prefilling prompt + generated at
    its sampling counter. Tokens still equal JAX ``generate()`` and the
    contiguous engine."""
    jnet, tnet = nets
    prompts = _prompts([10, 14, 7, 12], seed=7)
    new = [30, 26, 33, 28]
    want = _jax_tokens(jnet, prompts, new, 4)
    got, stats, eng = _serve(tnet, prompts, new, max_batch_size=4, max_len=MAXPOS,
                             multi_token=4, paged=True, page_size=8, num_pages=8,
                             prefix_cache=False)
    assert stats["preemptions"] > 0 and stats["resumed_tokens"] > 0
    assert got == want
    _drained(eng)
    contiguous, _, _ = _serve(tnet, prompts, new, max_batch_size=4, max_len=MAXPOS,
                              multi_token=4, paged=False)
    assert contiguous == got


def test_chunked_prefill_interleaves_with_decode(nets):
    """A 40-token prompt (5 chunks of 8) arrives while another request
    decodes: its chunks run one per tick between decode dispatches, and
    both requests' tokens equal JAX ``generate()`` and the contiguous
    engine."""
    jnet, tnet = nets
    prompts = _prompts([5, 40], seed=8)
    new = [20, 10]
    want = _jax_tokens(jnet, prompts, new, 1)
    eng = InferenceEngine(tnet, max_batch_size=2, max_len=MAXPOS, paged=True,
                          page_size=8).start()
    try:
        first = eng.submit(prompts[0], new[0])
        while eng.stats()["decode_dispatches"] == 0:
            time.sleep(0.005)
        before = eng.stats()
        second = eng.submit(prompts[1], new[1])
        got = [first.result(timeout=120).generated_ids,
               second.result(timeout=120).generated_ids]
    finally:
        eng.shutdown(drain=True, timeout=120)
    after = eng.stats()
    assert got == want
    # the long prompt's 5 chunks and the first request's decode steps shared ticks
    assert after["prefill_chunks"] - before["prefill_chunks"] == 5
    assert after["decode_dispatches"] - before["decode_dispatches"] >= 5
    _drained(eng)
    contiguous, _, _ = _serve(tnet, prompts, new, max_batch_size=2, max_len=MAXPOS,
                              paged=False)
    assert contiguous == got


def test_dropped_paged_engine_is_freed_without_the_collector(nets):
    """A paged engine that ran chunked prefills holds no reference cycle:
    once shut down and dropped, reference counting alone frees it and its
    KV pools (a cycle would hold their device memory until Python's
    collector runs)."""
    import gc
    import weakref
    _, tnet = nets
    gc.collect()
    gc.disable()
    try:
        eng = InferenceEngine(tnet, max_batch_size=2, max_len=MAXPOS, paged=True,
                              page_size=8, prefill_chunk=8).start()
        try:
            assert eng.generate(_prompts([20], seed=3)[0], 3, timeout=120).ok
            assert eng.stats()["prefill_chunks"] > 1
        finally:
            eng.shutdown(drain=True, timeout=120)
        refs = [weakref.ref(eng)] + [weakref.ref(p) for p in eng._pools]
        del eng
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


def test_paged_is_the_card_default(nets):
    """``paged=None`` follows JAX: paged on the card when max_len is a page
    multiple, contiguous on the CPU (or when it is not)."""
    _, tnet = nets
    assert not InferenceEngine(tnet, max_len=MAXPOS).stats()["paged"]
    assert InferenceEngine(tnet, max_len=MAXPOS, paged=True).stats()["paged"]
    with pytest.raises(MXNetError, match="multiple of page_size"):
        InferenceEngine(tnet, max_len=40, paged=True)
