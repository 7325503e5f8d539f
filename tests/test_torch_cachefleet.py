"""Port parity of the cache-aware fleet on paged engines:
``InferenceEngine.export_pages`` / ``import_pages``, ``submit(resume=)``,
``serve.cachefleet`` and the router's prefix affinity, against the JAX
package. A 2-layer, 64-wide f32 GPT with the same weights in both packages
(``interop.params_from_numpy``); one JAX paged engine per module serves
every reference request one at a time, and every fleet output must equal
its tokens: a migrated prefix (also over the HTTP endpoints), an affinity
fleet, a preempted request rescued on a peer, the prefill/decode pipeline.
Pages cross between packages both ways and serve the same tokens; a page
whose chain hash or shape is wrong is dropped and counted, never written;
an import captures nothing. The counted gc guard of the engine's graph
captures is held here too. Prompt families (the hundreds digit of a
seed) keep the cached pages of one test out of another's."""
import copy
import gc
import sys
import threading
import time

import numpy as onp
import pytest

import mxnet_tpu as mx
from mxnet_tpu import metrics as jm
from mxnet_tpu import np as mnp
from mxnet_tpu.models import GPTModel as JaxGPT
from mxnet_tpu.models.gpt import GPTConfig as JaxGPTConfig
from mxnet_tpu.serve import InferenceEngine as JaxEngine

from mxnet_tpu_torch import metrics
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.interop import params_from_numpy
from mxnet_tpu_torch.models import GPTConfig, GPTModel
from mxnet_tpu_torch.serve import (HTTPFrontend, InferenceEngine, PrefillDecodePipeline,
                                   Router, install_preempt_rescue, migrate_prefix)
from mxnet_tpu_torch.serve import engine as tengine

CFG = dict(vocab_size=64, hidden_size=64, num_layers=2, num_heads=2,
           max_position_embeddings=64, dropout=0.0)
DEADLINE = 120.0
PAGED = dict(max_len=64, paged=True, page_size=8)


@pytest.fixture(scope="module")
def nets():
    """A JAX GPT and the port's GPT with the same N(0, 0.3) weights."""
    mx.random.seed(0)
    jnet = JaxGPT(JaxGPTConfig(**CFG))
    jnet.initialize()
    jnet(mnp.array(onp.zeros((1, 4), "int32")))
    rng = onp.random.RandomState(0)
    for name, p in jnet.collect_params().items():
        base = 1.0 if name.endswith("gamma") else 0.0
        p.set_data(mnp.array((base + 0.3 * rng.randn(*p.shape)).astype("float32")))
    tnet = GPTModel(GPTConfig(**CFG), device="cpu")
    params_from_numpy(tnet, {n: p.data().asnumpy() for n, p in jnet.collect_params().items()})
    return jnet, tnet


@pytest.fixture(scope="module")
def ref_eng(nets):
    """The module's one JAX engine: the single-replica oracle."""
    eng = JaxEngine(nets[0], max_batch_size=4, num_pages=96, **PAGED).start()
    yield eng
    eng.shutdown()


@pytest.fixture(scope="module")
def pair(nets):
    """Two warmed port replicas, tiered prefill / decode (a tier only
    constrains tier-targeted dispatch), with an advert wide enough for the
    module."""
    engines = [InferenceEngine(nets[1], max_batch_size=2, num_pages=64, prefix_advert=32,
                               tier=t, **PAGED).start().warmup()
               for t in ("prefill", "decode")]
    yield engines
    for e in engines:
        e.shutdown()


@pytest.fixture(scope="module")
def fleet(pair):
    fronts = [HTTPFrontend(e, port=0).start() for e in pair]
    router = Router([f.url for f in fronts], health_interval=0.05, affinity=True).start()
    yield pair, fronts, router
    router.stop()
    for f in fronts:
        f.stop()


@pytest.fixture
def fresh_metrics():
    was = metrics.enabled()
    metrics.reset()
    metrics.enable()
    yield
    metrics.reset()
    if not was:
        metrics.disable()


def _prompt(seed, prefix_len=16, body_len=5, vocab=60):
    """A shared-prefix prompt: seeds 100..199 share a prefix, 200..299
    another."""
    pre = onp.random.RandomState(seed // 100).randint(1, vocab, size=prefix_len)
    body = onp.random.RandomState(seed).randint(1, vocab, size=body_len)
    return [int(t) for t in pre] + [int(t) for t in body]


def _run(eng, prompt, max_new, **kw):
    """One request on an engine of either package, with a deadline."""
    return eng.submit(prompt, max_new, **kw).result(DEADLINE)


def _reference(eng, prompts, max_new, seeds, temperature=0.0):
    outs = []
    for p, s in zip(prompts, seeds):
        r = _run(eng, p, max_new, temperature=temperature, seed=s)
        assert r.status == "ok"
        outs.append(list(r.generated_ids))
    return outs


def _wait_root(router, prompt, timeout=30.0):
    """The URL of a backend whose advert (as the router sees it) holds a
    root of ``prompt``."""
    from mxnet_tpu_torch.serve import prefix_key
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for url, b in router._backends.items():
            for key, ln in (b.prefix_summary or ()):
                if ln <= len(prompt) and prefix_key(prompt[:ln]) == key:
                    return url
        time.sleep(0.02)
    raise AssertionError("prefix advert never reached the router")


def test_page_migration_round_trip(pair, ref_eng, fresh_metrics):
    """A sampled continuation after a migration equals the source's and the
    JAX reference's; a page with a wrong chain hash and one with a wrong
    shape are dropped and counted and take no page; sent == received +
    verify failures; the import builds no step."""
    src, dst = pair
    prompt = _prompt(400, body_len=9)                  # 25 tokens: 3 full pages
    want = _reference(ref_eng, [prompt], 6, [9], temperature=0.8)[0]
    ra = _run(src, prompt, 6, temperature=0.8, seed=9)
    assert list(ra.generated_ids) == want
    doc = src.export_pages(prompt)
    assert [p["prefix_len"] for p in doc["pages"]] == [8, 16, 24]
    assert doc["pages"][0]["payload"][0]["shape"] == [1, 2, 8, 32]

    bad = copy.deepcopy(doc)
    bad["pages"][0]["key"] ^= 1                        # a corrupted chain hash
    arr = bad["pages"][1]["payload"][3]                # a page of another shape
    import base64
    raw = base64.b64decode(arr["data"])
    arr["data"] = base64.b64encode(raw[:len(raw) // 2]).decode()
    arr["shape"] = [1, 2, 4, 32]
    cached0 = dst.stats()["pages"]["pages_cached_only"]
    captures = dst.stats()["captures"]
    res = dst.import_pages(bad)
    assert res["verify_failures"] == 2 and res["received"] == 1 and res["adopted"] == 1
    assert dst.stats()["pages"]["pages_cached_only"] == cached0 + 1
    dst._pages.clear_prefix_cache()

    summary = migrate_prefix(src, dst, prompt)
    assert summary == {"received": 3, "adopted": 3, "verify_failures": 0,
                       "skipped_cached": 0, "out_of_pages": None}
    hits = dst.stats()["pages"]["prefix_tokens_saved"]
    rb = _run(dst, prompt, 6, temperature=0.8, seed=9)
    assert list(rb.generated_ids) == want
    assert dst.stats()["pages"]["prefix_tokens_saved"] == hits + 24
    assert dst.stats()["captures"] == captures
    sent = metrics.get_sample_value("mxnet_migrate_pages_sent_total")
    received = metrics.get_sample_value("mxnet_migrate_pages_received_total")
    failures = metrics.get_sample_value("mxnet_migrate_verify_failures_total")
    assert sent == 6 and sent == received + failures


def test_cache_http_endpoints_round_trip(fleet, ref_eng):
    """/cache/export -> /cache/import over the frontends (URL to URL), then
    the receiver serves the prompt from the imported pages as the JAX
    reference does."""
    (src, dst), (fs, fd), _router = fleet
    prompt = _prompt(500, body_len=9)
    want = _reference(ref_eng, [prompt], 4, [3])[0]
    assert list(_run(src, prompt, 4, seed=3).generated_ids) == want
    summary = migrate_prefix(fs.url, fd.url, prompt)
    assert summary["received"] == summary["adopted"] == 3
    assert list(_run(dst, prompt, 4, seed=3).generated_ids) == want


def test_affinity_fleet_matches_jax(fleet, ref_eng, fresh_metrics):
    """Two prompt families, three requests each, over the two-replica
    affinity fleet: the JAX reference's tokens, with affinity hits."""
    _engines, _fronts, router = fleet
    seeds = [600, 700, 601, 701, 602, 702]
    prompts = [_prompt(s) for s in seeds]
    ref = _reference(ref_eng, prompts, 4, seeds)
    outs, seen = [], set()
    for p, s in zip(prompts, seeds):
        if s // 100 in seen:
            _wait_root(router, p)
        seen.add(s // 100)
        doc = router.generate({"input_ids": p, "max_new_tokens": 4, "seed": s})
        assert doc["status"] == "ok"
        outs.append(list(doc["generated_ids"]))
    assert outs == ref
    assert (metrics.get_sample_value("mxnet_cache_affinity_dispatch_total",
                                     {"outcome": "hit"}) or 0) >= 1
    assert (metrics.get_sample_value("mxnet_cache_affinity_hit_tokens_total") or 0) >= 8


def test_preempt_rescue_matches_jax(nets, ref_eng, fresh_metrics):
    """A starved pool preempts; the rescue ships the victim's pages to the
    peer and resumes there: every output equals the unconstrained JAX
    reference's, and the rescues are counted."""
    seeds = [5, 6, 7]
    prompts = [_prompt(s, prefix_len=0, body_len=10 + s) for s in seeds]
    ref = _reference(ref_eng, prompts, 8, seeds, temperature=0.7)
    kw = dict(max_batch_size=3, max_len=32, paged=True, page_size=8, prefix_cache=False)
    victim = InferenceEngine(nets[1], num_pages=5, **kw).start()
    peer = InferenceEngine(nets[1], num_pages=16, **kw).start()
    install_preempt_rescue(victim, [peer])
    try:
        handles = [victim.submit(p, 8, temperature=0.7, seed=s)
                   for p, s in zip(prompts, seeds)]
        outs = [h.result(DEADLINE) for h in handles]
        assert all(r.status == "ok" for r in outs)
        assert [list(r.generated_ids) for r in outs] == ref
        assert victim.stats()["preemptions"] >= 1
    finally:
        victim.shutdown()
        peer.shutdown()
    assert (metrics.get_sample_value("mxnet_migrate_rescues_total",
                                     {"outcome": "resumed"}) or 0) >= 1
    with pytest.raises(MXNetError, match="paged engine"):
        InferenceEngine(nets[1], max_len=32, paged=False).start().submit(
            [1, 2], 2, resume=[3])


def test_prefill_decode_tiers_match_jax(fleet, ref_eng):
    """The pipeline prefills on the prefill replica, streams the pages and
    decodes on the decode replica with the JAX reference's tokens;
    tier-targeted dispatch keeps to its tier, an unknown tier is a named
    NoBackendError."""
    from mxnet_tpu_torch.serve import NoBackendError
    (pre, dec), (fp, fd), router = fleet
    seeds = [1000, 1001]
    prompts = [_prompt(s, body_len=9) for s in seeds]
    ref = _reference(ref_eng, prompts, 6, seeds)
    pipe = PrefillDecodePipeline([pre], [fd.url])
    hits = dec.stats()["pages"]["prefix_hits"]
    for p, s, want in zip(prompts, seeds, ref):
        doc = pipe.generate({"input_ids": p, "max_new_tokens": 6, "seed": s})
        assert doc["status"] == "ok" and list(doc["generated_ids"]) == want
    assert pipe.stats()["pages_streamed"] >= 2
    assert dec.stats()["pages"]["prefix_hits"] >= hits + 1
    deadline = time.monotonic() + 30
    while (any(b["tier"] is None for b in router.stats()["backends"].values())
           and time.monotonic() < deadline):
        time.sleep(0.02)
    before = (pre.stats()["submitted"], dec.stats()["submitted"])
    doc = router.generate({"input_ids": _prompt(1100), "max_new_tokens": 2, "seed": 0},
                          tier="decode")
    assert doc["status"] == "ok"
    assert (pre.stats()["submitted"], dec.stats()["submitted"]) == (before[0], before[1] + 1)
    with pytest.raises(NoBackendError, match="batch-tier"):
        router.generate({"input_ids": _prompt(1100), "max_new_tokens": 2}, tier="batch")


def test_pages_cross_packages(nets, ref_eng, pair):
    """Pages a JAX engine exported are adopted by a port engine and the
    reverse; each side then serves the other's greedy tokens from them."""
    src = pair[0]
    p_jax, p_port = _prompt(1200, body_len=11), _prompt(1300, body_len=13)
    want = _reference(ref_eng, [p_jax], 5, [0])[0]
    jdoc = ref_eng.export_pages(p_jax)
    eng = InferenceEngine(nets[1], max_batch_size=2, num_pages=32, **PAGED).start()
    try:
        res = eng.import_pages(jdoc)
        assert res["adopted"] == res["received"] == len(jdoc["pages"]) == 3
        saved = eng.stats()["pages"]["prefix_tokens_saved"]
        assert list(_run(eng, p_jax, 5, seed=0).generated_ids) == want
        assert eng.stats()["pages"]["prefix_tokens_saved"] == saved + 24
    finally:
        eng.shutdown()
    got = list(_run(src, p_port, 5, seed=0).generated_ids)
    res = ref_eng.import_pages(src.export_pages(p_port))
    assert res["adopted"] == res["received"] == 3 and res["verify_failures"] == 0
    assert list(_run(ref_eng, p_port, 5, seed=0).generated_ids) == got


def test_gc_guard_counted_across_threads():
    """The collector comes back only when the last capture guard exits,
    whichever thread entered first and in whatever order they leave."""
    was = gc.isenabled()
    gc.enable()
    try:
        entered = [threading.Event() for _ in range(2)]
        leave = [threading.Event() for _ in range(2)]

        def hold(i):
            with tengine._no_collection():
                entered[i].set()
                assert leave[i].wait(DEADLINE)

        threads = [threading.Thread(target=hold, args=(i,), daemon=True) for i in range(2)]
        threads[0].start()
        assert entered[0].wait(DEADLINE)
        threads[1].start()
        assert entered[1].wait(DEADLINE) and not gc.isenabled()
        leave[0].set()                       # the first one in leaves first
        threads[0].join(DEADLINE)
        assert not gc.isenabled()            # the second capture still runs
        leave[1].set()
        threads[1].join(DEADLINE)
        assert gc.isenabled()
        gc.disable()                         # a disabled collector stays off
        with tengine._no_collection():
            pass
        assert not gc.isenabled()
        gc.enable()
        # stress: more threads than cores, a short switch interval; every
        # holder must see the collector off, and it is on once all left
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        seen_on = []

        def churn():
            for _ in range(300):
                with tengine._no_collection():
                    if gc.isenabled():
                        seen_on.append(1)

        try:
            threads = [threading.Thread(target=churn, daemon=True) for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(DEADLINE)
            assert not any(t.is_alive() for t in threads)
        finally:
            sys.setswitchinterval(interval)
        assert not seen_on and gc.isenabled() and tengine._GC_HOLDS == 0
    finally:
        (gc.enable if was else gc.disable)()
