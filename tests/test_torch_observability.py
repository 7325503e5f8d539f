"""Port parity of request tracing and the flight recorder:
``mxnet_tpu_torch.observability`` against ``mxnet_tpu.observability``
(W3C traceparent, the bounded span store, a served request's span tree,
``StepTimeline``, the recorder's ring and dumps), and the profiler's host
event store."""
import json
import os

import numpy as onp
import pytest

import mxnet_tpu as mx
from mxnet_tpu import np as mnp
from mxnet_tpu.models import GPTModel as JaxGPT
from mxnet_tpu.models.gpt import GPTConfig as JaxGPTConfig
from mxnet_tpu.observability import recorder as jrec
from mxnet_tpu.observability import trace as jtr
from mxnet_tpu.serve import InferenceEngine as JaxEngine

from mxnet_tpu_torch import profiler as tprof
from mxnet_tpu_torch.interop import params_from_numpy
from mxnet_tpu_torch.models import GPTConfig, GPTModel
from mxnet_tpu_torch.observability import recorder as trec
from mxnet_tpu_torch.observability import trace as ttr
from mxnet_tpu_torch.serve import InferenceEngine

CFG = dict(vocab_size=64, hidden_size=64, num_layers=2, num_heads=2,
           max_position_embeddings=64, dropout=0.0)


@pytest.fixture(scope="module")
def nets():
    """A JAX GPT and the port's GPT with the same N(0, 0.1) weights."""
    mx.random.seed(0)
    jnet = JaxGPT(JaxGPTConfig(**CFG))
    jnet.initialize()
    jnet(mnp.array(onp.zeros((1, 4), "int32")))
    rng = onp.random.RandomState(0)
    for name, p in jnet.collect_params().items():
        base = 1.0 if name.endswith("gamma") else 0.0
        p.set_data(mnp.array((base + 0.1 * rng.randn(*p.shape)).astype("float32")))
    tnet = GPTModel(GPTConfig(**CFG), device="cpu")
    params_from_numpy(tnet, {n: p.data().asnumpy()
                             for n, p in jnet.collect_params().items()})
    return jnet, tnet


@pytest.fixture
def traced():
    """Tracing on in both packages for the test, stores emptied."""
    was = (jtr.enabled(), ttr.enabled())
    for mod in (jtr, ttr):
        mod.enable()
        mod.reset()
    yield
    for mod, on in zip((jtr, ttr), was):
        (mod.enable if on else mod.disable)()
        mod.reset()


def _tp(t, s):
    return f"00-{t * 16}-{s * 8}-01"


HEADERS = [_tp("ab", "cd"), _tp("AB", "CD").upper(), "00-" + "1" * 32 + "-" + "2" * 16 + "-00",
           "  " + _tp("12", "34") + " ", "ff-" + "1" * 32 + "-" + "2" * 16 + "-01",
           "00-" + "0" * 32 + "-" + "2" * 16 + "-01", "00-" + "1" * 32 + "-" + "0" * 16 + "-01",
           "00-" + "1" * 31 + "-" + "2" * 16 + "-01", "00-" + "g" * 32 + "-" + "2" * 16 + "-01",
           "00-" + "1" * 32 + "-" + "2" * 16, "", None, 42, "0-1-2-3"]


@pytest.mark.parametrize("header", HEADERS)
def test_traceparent_parse_matches_jax(header):
    """The same headers parse to the same context (or to None), and a
    context formats back to the same header."""
    j, t = jtr.parse_traceparent(header), ttr.parse_traceparent(header)
    if j is None:
        assert t is None
        return
    assert (t.trace_id, t.span_id, t.flags) == (j.trace_id, j.span_id, j.flags)
    assert t.traceparent() == j.traceparent()
    assert ttr.TraceContext(j.trace_id, j.span_id, 0).traceparent() == \
        jtr.TraceContext(j.trace_id, j.span_id, 0).traceparent()


def _fill(mod, store):
    """One fixed sequence of spans into ``store``: 3 traces of 1, 5 and 2
    spans, a span with 70 events."""
    trace_ids = ["a" * 32, "b" * 32, "c" * 32]
    for tid, n in zip(trace_ids, (1, 5, 2)):
        root = mod.Span("root", tid, None, t0=1.0)
        for i in range(n - 1):
            ch = mod.Span(f"child{i}", tid, root.span_id, t0=2.0 + i)
            ch.t1 = 3.0 + i
            store.add(ch)
        for k in range(70):
            root.event("e", k=k)
        root.t1 = 9.0
        store.add(root)
    return trace_ids


def test_store_caps_and_drop_counts_match_jax(traced):
    """LRU eviction of whole traces, the per-trace span cap (oldest span
    dropped), the per-span event cap: the same counts and survivors."""
    out = []
    for mod in (jtr, ttr):
        store = mod.TraceStore(max_traces=2, max_spans_per_trace=3)
        before = mod.STORE.dropped()
        ids = _fill(mod, store)
        docs = [store.export(t) for t in ids]
        out.append((store.ids(), store.dropped(), store.evicted(), store.added(),
                    mod.STORE.dropped() - before,
                    [None if d is None else [(s["name"], len(s["events"])) for s in d["spans"]]
                     for d in docs]))
    assert out[1] == out[0]
    assert out[0][1:3] == (2, 1)


def test_disabled_tracing_is_noop(nets):
    """With tracing off every call hands back the shared no-op span, the
    store takes nothing, and a request carries no trace."""
    assert not ttr.enabled()
    added = ttr.STORE.added()
    sp = ttr.start_span("decode", parent=_tp("ab", "cd"))
    assert sp is ttr.NOOP and sp.child("x") is ttr.NOOP and not sp
    sp.event("e")
    sp.set("k", 1)
    sp.end(status="ok")
    with InferenceEngine(nets[1], max_batch_size=1, max_len=32) as eng:
        h = eng.submit([1, 2, 3], 2, traceparent=_tp("ab", "cd"))
        assert h.result(60).trace_id is None and h.trace_id is None
    assert ttr.STORE.added() == added


def _tree_shape(doc):
    """(name, parent name, sorted attr keys, event names) of every span,
    sorted: the structure of a request's trace without ids and times."""
    by_id = {s["span_id"]: s for s in doc["spans"]}
    rows = []
    for s in doc["spans"]:
        parent = by_id.get(s["parent_id"])
        rows.append((s["name"], parent["name"] if parent else None,
                     tuple(sorted(s["attrs"])), tuple(e["name"] for e in s["events"]),
                     s["status"]))
    return sorted(rows, key=repr)


@pytest.mark.parametrize("paged", [False, True])
def test_request_span_tree_matches_jax(nets, traced, paged):
    """One request served under a client traceparent: the trace id comes
    from the header, the root is parented by the client's span, and the
    span tree (names, parentage, attribute keys, events, statuses) is the
    JAX engine's."""
    jnet, tnet = nets
    prompt = list(range(3, 14))
    tp = _tp("5e", "7f")
    kw = dict(max_batch_size=2, max_len=32)
    if paged:
        kw.update(paged=True, page_size=8)
    shapes, roots = [], []
    for Eng, net, mod in ((JaxEngine, jnet, jtr), (InferenceEngine, tnet, ttr)):
        eng = Eng(net, **kw).start()
        try:
            h = eng.submit(prompt, 5, traceparent=tp)
            res = h.result(120)
        finally:
            eng.shutdown()
        assert res.status == "ok" and res.trace_id == "5e" * 16 == h.trace_id
        doc = mod.export(res.trace_id)
        shapes.append(_tree_shape(doc))
        root = [s for s in doc["tree"] if s["name"] == "serve.request"][0]
        roots.append((root["parent_id"], root["attrs"], root["status"]))
        assert all(s["trace_id"] == "5e" * 16 and s["t1"] is not None for s in doc["spans"])
    assert shapes[1] == shapes[0]
    assert roots[1] == roots[0] == ("7f" * 8, {"prompt_tokens": 11, "max_new_tokens": 5,
                                               "generated_tokens": 5}, "ok")


def test_step_timeline_matches_jax(traced):
    """StepTimeline over three steps: the same span names and phases."""
    out = []
    for mod in (jtr, ttr):
        tl = mod.StepTimeline("train_step")
        mod.note_blocked("input_wait", 0.001)
        for _ in range(3):
            tl.begin()
            with tl.phase("dispatch"):
                pass
            with tl.phase("loss_sync"):
                pass
            tl.finish()
        doc = mod.export(tl.trace_id)
        out.append(sorted(s["name"] for s in doc["spans"]))
        assert tl.last_overlap is not None
    assert out[1] == out[0]


def test_recorder_ring_dump_and_storm(tmp_path):
    """The ring keeps the newest events, dumps are rate-limited per reason
    (``force`` bypasses), and a preemption storm dumps once, as the JAX
    recorder does."""
    out = []
    for mod in (jrec, trec):
        rec = mod.FlightRecorder(capacity=4, min_dump_interval=60.0,
                                 storm_window=5.0, storm_threshold=3)
        for i in range(6):
            rec.record("event", "e", i=i)
        p1 = rec.dump("manual", path=str(tmp_path / f"{mod.__name__}-1.json"))
        p2 = rec.dump("manual", path=str(tmp_path / f"{mod.__name__}-2.json"))
        p3 = rec.dump("manual", force=True, path=str(tmp_path / f"{mod.__name__}-3.json"))
        with open(p1) as f:
            doc = json.load(f)
        rec.reset()
        paths = []
        rec.dump = lambda reason, force=False, path=None: paths.append(reason)
        for _ in range(3):
            rec.record_preemption(slot=0, generated=1)
        out.append(([e["i"] for e in doc["events"]], doc["reason"], p2, os.path.exists(p3),
                    paths, [e["name"] for e in rec.snapshot()]))
    assert out[1] == out[0]
    assert out[0][0] == [2, 3, 4, 5] and out[0][4] == ["preemption_storm"]


def test_profiler_event_cap_counts_drops(traced):
    """The host event store takes finished spans while running and counts
    the events past ``max_events`` as dropped."""
    cap = tprof._CONFIG["max_events"]
    before = tprof.dropped_events()
    tprof.set_config(max_events=len(tprof.events()) + 2)
    tprof.set_state("run")
    try:
        for i in range(5):
            ttr.start_span(f"s{i}").end()
    finally:
        tprof.set_state("stop")
        tprof.set_config(max_events=cap)
    assert tprof.dropped_events() - before == 3
    assert [e["name"] for e in tprof.events()[-2:]] == ["s0", "s1"]
