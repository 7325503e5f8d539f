"""Port parity of the HTTP frontend: the JAX package's ``HTTPFrontend`` and
the port's serve the same GPT (2 layers, D 64, f32, weights copied with
``interop.params_from_numpy``) on the CPU, and the same requests give the
same answers: ``/generate`` as JSON and as SSE (greedy and sampled),
``/score`` (within 1e-5), the error codes, ``/healthz`` and ``/models``,
the request-fixed counters of ``/metrics``, ``/drain``, a client
disconnect, and multi-model routing."""
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as onp
import pytest

import mxnet_tpu as mx
from mxnet_tpu import metrics as jm
from mxnet_tpu import np as mnp
from mxnet_tpu.models import GPTModel as JaxGPT
from mxnet_tpu.models.gpt import GPTConfig as JaxGPTConfig
from mxnet_tpu.serve import HTTPFrontend as JaxFrontend
from mxnet_tpu.serve import InferenceEngine as JaxEngine
from mxnet_tpu.serve import ModelRegistry as JaxRegistry

from mxnet_tpu_torch import metrics as tm
from mxnet_tpu_torch.interop import params_from_numpy
from mxnet_tpu_torch.models import GPTConfig, GPTModel
from mxnet_tpu_torch.serve import HTTPFrontend, InferenceEngine, ModelRegistry

CFG = dict(vocab_size=64, hidden_size=64, num_layers=2, num_heads=2,
           max_position_embeddings=64, dropout=0.0)
SCORE_TOL = 1e-5          # f32 log-probabilities, two summation orders


def _pair(seed):
    """A JAX GPT and the port's GPT with the same N(0, 0.1) weights."""
    mx.random.seed(seed)
    jnet = JaxGPT(JaxGPTConfig(**CFG))
    jnet.initialize()
    jnet(mnp.array(onp.zeros((1, 4), "int32")))
    rng = onp.random.RandomState(seed)
    for name, p in jnet.collect_params().items():
        base = 1.0 if name.endswith("gamma") else 0.0
        p.set_data(mnp.array((base + 0.1 * rng.randn(*p.shape)).astype("float32")))
    tnet = GPTModel(GPTConfig(**CFG), device="cpu")
    params_from_numpy(tnet, {n: p.data().asnumpy()
                             for n, p in jnet.collect_params().items()})
    return jnet, tnet


@pytest.fixture(scope="module")
def nets():
    return _pair(0)


@pytest.fixture
def metrics_on():
    was = (jm.enabled(), tm.enabled())
    jm.enable()
    tm.enable()
    yield
    for mod, on in zip((jm, tm), was):
        (mod.enable if on else mod.disable)()


def _post(url, path, doc, headers=None, raw=None):
    """(status, parsed JSON body) of a POST; HTTP errors are answers."""
    req = urllib.request.Request(url + path, data=raw if raw is not None
                                 else json.dumps(doc).encode(),
                                 headers={"Content-Type": "application/json",
                                          **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url, path):
    try:
        with urllib.request.urlopen(url + path, timeout=60) as r:
            body = r.read()
            status = r.status
    except urllib.error.HTTPError as e:
        body, status = e.read(), e.code
    try:
        return status, json.loads(body)
    except ValueError:
        return status, body.decode()


def _sse(url, payload):
    """[(kind, data)] of one SSE /generate: 'token', 'done', 'comment'."""
    req = urllib.request.Request(url + "/generate", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    events = []
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.headers["Content-Type"] == "text/event-stream"
        kind, data = None, None
        for line in r:
            line = line.rstrip(b"\n")
            if line.startswith(b"event: "):
                kind = line[7:].decode()
            elif line.startswith(b"data: "):
                data = json.loads(line[6:])
            elif line.startswith(b":"):
                events.append(("comment", None))
            elif not line and kind is not None:
                events.append((kind, data))
                if kind == "done":
                    break
                kind = None
    return events


class _Served:
    """Both packages' engines over ``nets`` behind their frontends."""

    def __init__(self, nets, **kw):
        jnet, tnet = nets
        self.engines = [JaxEngine(jnet, **kw).start(), InferenceEngine(tnet, **kw).start()]
        self.fronts = [JaxFrontend(self.engines[0], port=0, heartbeat_s=0.01).start(),
                       HTTPFrontend(self.engines[1], port=0, heartbeat_s=0.01).start()]
        self.urls = [f.url for f in self.fronts]

    def close(self):
        for f in self.fronts:
            f.stop()
        for e in self.engines:
            e.shutdown(drain=False)


REQUESTS = [
    {"input_ids": [1, 2, 3, 4, 5], "max_new_tokens": 6},
    {"input_ids": list(range(7, 20)), "max_new_tokens": 5, "eos_token_id": 9},
    {"input_ids": [9, 8, 7], "max_new_tokens": 7, "temperature": 0.8, "seed": 3},
    {"input_ids": [4, 4, 4, 4], "max_new_tokens": 6, "temperature": 1.1,
     "top_k": 5, "top_p": 0.9, "seed": 11},
]


@pytest.mark.parametrize("paged", [False, True])
def test_generate_json_and_sse_match_jax(nets, paged):
    """Greedy and sampled requests: the port's JSON replies give JAX's
    tokens, and its SSE streams give the JSON replies' tokens frame for
    frame with a done frame equal to the JSON document."""
    kw = dict(max_batch_size=4, max_len=32)
    if paged:
        kw.update(paged=True, page_size=8)
    srv = _Served(nets, **kw)
    try:
        for payload in REQUESTS:
            (jc, jdoc), (tc, tdoc) = (_post(u, "/generate", payload) for u in srv.urls)
            assert jc == tc == 200
            assert tdoc["status"] == jdoc["status"] == "ok"
            assert tdoc["generated_ids"] == jdoc["generated_ids"], payload
            assert tdoc["output_ids"] == payload["input_ids"] + tdoc["generated_ids"]
            assert set(tdoc) == set(jdoc)
            events = _sse(srv.urls[1], dict(payload, stream=True))
            toks = [d for k, d in events if k == "token"]
            done = [d for k, d in events if k == "done"]
            assert [d["token"] for d in toks] == tdoc["generated_ids"]
            assert [d["index"] for d in toks] == list(range(len(toks)))
            assert len(done) == 1 and done[0]["generated_ids"] == tdoc["generated_ids"]
            assert set(done[0]) == set(jdoc)
    finally:
        srv.close()


def test_concurrent_clients_match_in_process(nets):
    """Eight client threads at once: each reply equals the same request
    run alone in-process."""
    srv = _Served(nets, max_batch_size=4, max_len=32)
    try:
        rng = onp.random.RandomState(5)
        payloads = [{"input_ids": rng.randint(0, 64, int(n)).tolist(), "max_new_tokens": 5,
                     "temperature": 0.7 * (i % 2), "seed": i}
                    for i, n in enumerate(rng.randint(2, 20, 8))]
        out = [None] * 8

        def client(i):
            out[i] = _post(srv.urls[1], "/generate", payloads[i])

        threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        for i, p in enumerate(payloads):
            want = srv.engines[1].generate(p["input_ids"], 5, temperature=p["temperature"],
                                           seed=p["seed"]).generated_ids
            assert out[i][0] == 200 and out[i][1]["generated_ids"] == want
    finally:
        srv.close()


BAD_SCORES = [
    ({"input_ids": [5]}, None),
    ({"input_ids": [5, 70]}, None),
    ({"input_ids": list(range(40))}, None),
    ({"ids": [1, 2]}, None),
    ({"input_ids": [[1, 2], [3, 4]]}, None),
    (None, b"{not json"),
    ({"input_ids": [1, 2], "model": "nope"}, None),
]


@pytest.mark.parametrize("paged", [False, True])
def test_score_matches_jax(nets, paged):
    """/score: JAX's token log-probabilities within 1e-5 (f32), the sum as
    ``logprob``, and the same status codes for bad requests."""
    kw = dict(max_batch_size=2, max_len=32)
    if paged:
        kw.update(paged=True, page_size=8)
    srv = _Served(nets, **kw)
    try:
        rng = onp.random.RandomState(2)
        for n in (2, 5, 8, 9, 17, 32):
            ids = rng.randint(0, 64, n).tolist()
            (jc, jdoc), (tc, tdoc) = (_post(u, "/score", {"input_ids": ids}) for u in srv.urls)
            assert jc == tc == 200
            assert tdoc["tokens"] == jdoc["tokens"] == n - 1
            onp.testing.assert_allclose(tdoc["token_logprobs"], jdoc["token_logprobs"],
                                        rtol=0, atol=SCORE_TOL)
            assert tdoc["logprob"] == pytest.approx(sum(tdoc["token_logprobs"]), abs=1e-9)
            assert abs(tdoc["logprob"] - jdoc["logprob"]) <= SCORE_TOL * n
        for doc, raw in BAD_SCORES:
            codes = [_post(u, "/score", doc, raw=raw)[0] for u in srv.urls]
            assert codes[1] == codes[0], (doc, raw, codes)
        assert srv.engines[1].stats()["compiled_buckets"]["score"] == [8, 16, 32]
    finally:
        srv.close()


BAD_GENERATES = [
    {"max_new_tokens": 3},
    {"input_ids": [1, 2], "max_new_tokens": 0},
    {"input_ids": [1, 99], "max_new_tokens": 2},
    {"input_ids": [1, 2], "max_new_tokens": 40},
    {"input_ids": [1, 2], "max_new_tokens": 2, "temperature": -1},
    {"input_ids": [], "max_new_tokens": 2},
    {"input_ids": [1, 2], "max_new_tokens": 2, "model": "other"},
    {"input_ids": [1, 2], "max_new_tokens": 2, "grammar": "[ab]+"},
]


def test_error_codes_match_jax(nets):
    """400 for bad requests, 503 for an unknown model, 404 for an unknown
    path, 429 when the queue is full and 503 once the engine is stopped:
    the JAX frontend's codes."""
    srv = _Served(nets, max_batch_size=1, max_len=32, max_queue_depth=1)
    try:
        for doc in BAD_GENERATES:
            codes = [_post(u, "/generate", doc)[0] for u in srv.urls]
            assert codes[1] == codes[0], (doc, codes)
        codes = [_get(u, "/nope")[0] for u in srv.urls]
        assert codes == [404, 404]
        codes = [_post(u, "/nope", {})[0] for u in srv.urls]
        assert codes == [404, 404]
        # a long request holds the slot, one waits in the queue: the next
        # is turned away
        for eng, url in zip(srv.engines, srv.urls):
            eng._step_delay = 0.01          # the JAX engine's test knob
            busy = eng.submit([1, 2, 3], 28)
            while busy.status == "queued":
                time.sleep(0.005)
            queued = eng.submit([1, 2, 3], 2)
            assert _post(url, "/generate", {"input_ids": [1], "max_new_tokens": 2})[0] == 429
            busy.cancel()
            queued.result(120)
        for eng in srv.engines:
            eng.shutdown()
        codes = [_post(u, "/generate", {"input_ids": [1], "max_new_tokens": 2})[0]
                 for u in srv.urls]
        assert codes == [503, 503]
    finally:
        srv.close()


# process-wide buffer counters: each package's own trace store and
# profiler, whatever else ran in the process
PROCESS_KEYS = ("dropped_trace_events", "evicted_traces", "profiler_dropped_events")


def _healthz_equal(th, jh):
    assert set(th) == set(jh)
    assert all(isinstance(th[k], int) for k in PROCESS_KEYS)
    assert {k: v for k, v in th.items() if k not in PROCESS_KEYS} == \
        {k: v for k, v in jh.items() if k not in PROCESS_KEYS}


def _comparable_stats(s):
    skip = {"last_warmup_s", "compiled_buckets", "kv_bytes"}
    return {k: v for k, v in s.items() if k not in skip}


@pytest.mark.parametrize("paged", [False, True])
def test_healthz_and_models_match_jax(nets, paged):
    """/healthz: the same keys and values (after the same requests; the
    process-wide buffer counters are each process's own);
    /models: the same models and versions, and every stats key of the JAX
    engine with its value (timings and bucket keys aside)."""
    kw = dict(max_batch_size=2, max_len=32)
    if paged:
        kw.update(paged=True, page_size=8)
    srv = _Served(nets, **kw)
    try:
        shared = list(range(1, 17))
        for tail in ([20, 21], [22, 23, 24]):
            for u in srv.urls:
                assert _post(u, "/generate", {"input_ids": shared + tail,
                                              "max_new_tokens": 3})[0] == 200
        (jc, jh), (tc, th) = (_get(u, "/healthz") for u in srv.urls)
        assert jc == tc == 200
        _healthz_equal(th, jh)
        (jc, jmod), (tc, tmod) = (_get(u, "/models") for u in srv.urls)
        assert jc == tc == 200
        assert set(tmod["models"]) == set(jmod["models"]) == {"default"}
        js, ts = jmod["models"]["default"]["stats"], tmod["models"]["default"]["stats"]
        assert tmod["models"]["default"]["weight_version"] == 0
        assert set(js) <= set(ts)
        theirs = _comparable_stats(js)
        assert {k: ts[k] for k in theirs} == theirs
        assert ts["kv_bytes"] == js["kv_bytes"]
    finally:
        srv.close()


COUNTERS = [("mxnet_serve_requests_total", {"status": "ok"}),
            ("mxnet_serve_tokens_total", None),
            ("mxnet_serve_ttft_seconds_count", None),
            ("mxnet_serve_request_seconds_count", None),
            ("mxnet_serve_queue_wait_seconds_count", None),
            ("mxnet_serve_host_roundtrips_total", {"path": "prefill"}),
            ("mxnet_serve_host_roundtrips_total", {"path": "score"}),
            ("mxnet_serve_page_prefix_hits_total", None),
            ("mxnet_serve_page_prefix_misses_total", None),
            ("mxnet_serve_page_prefix_tokens_saved_total", None)]


def _counters(url):
    status, text = _get(url, "/metrics")
    assert status == 200
    out = []
    for name, labels in COUNTERS:
        want = name + ("{" + ",".join(f'{k}="{v}"' for k, v in labels.items()) + "}"
                       if labels else "")
        vals = [float(ln.split()[-1]) for ln in text.splitlines()
                if ln.split(" ")[0] == want]
        out.append(sum(vals))
    return out


def test_metrics_request_counters_match_jax(nets, metrics_on):
    """The counters that the requests alone fix move by the same amounts in
    both packages, read through /metrics; /metrics/json is the JSON dump."""
    srv = _Served(nets, max_batch_size=2, max_len=32, paged=True, page_size=8)
    try:
        before = [_counters(u) for u in srv.urls]
        shared = list(range(1, 17))
        for u in srv.urls:
            for i, tail in enumerate(([20, 21], [22, 23, 24], [25])):
                assert _post(u, "/generate", {"input_ids": shared + tail,
                                              "max_new_tokens": 3 + i})[0] == 200
            assert _post(u, "/score", {"input_ids": shared})[0] == 200
        after = [_counters(u) for u in srv.urls]
        deltas = [[a - b for a, b in zip(x, y)] for x, y in zip(after, before)]
        assert deltas[1] == deltas[0]
        assert deltas[0][:3] == [3, 12, 3]
        status, doc = _get(srv.urls[1], "/metrics/json")
        assert status == 200 and doc["mxnet_serve_requests_total"]["type"] == "counter"
    finally:
        srv.close()


def test_drain(nets):
    """POST /drain: /healthz turns 503 with draining true, new /generate
    answers 503, and the request in flight finishes ok, in both
    packages."""
    srv = _Served(nets, max_batch_size=2, max_len=64)
    try:
        for eng, url in zip(srv.engines, srv.urls):
            eng._step_delay = 0.01          # the JAX engine's test knob
            inflight = eng.submit([1, 2, 3], 40)
            while inflight.status == "queued":
                time.sleep(0.005)
            assert _post(url, "/drain", {}) == (200, {"ok": True, "draining": True})
            code, h = _get(url, "/healthz")
            assert code == 503 and h["draining"] is True and h["ok"] is False
            assert _post(url, "/generate", {"input_ids": [1], "max_new_tokens": 2})[0] == 503
            res = inflight.result(120)
            assert res.status == "ok" and len(res.generated_ids) == 40
    finally:
        srv.close()


def test_client_disconnect_cancels_stream(nets, metrics_on):
    """Closing an SSE socket mid-stream cancels the request at the next
    step instead of decoding to its budget."""
    eng = InferenceEngine(nets[1], max_batch_size=2, max_len=64).start()
    eng._step_delay = 0.01
    fe = HTTPFrontend(eng, port=0, heartbeat_s=0.01).start()
    try:
        before = tm.get_sample_value("mxnet_serve_requests_total",
                                     {"status": "cancelled"}) or 0
        body = json.dumps({"input_ids": [1, 2, 3], "max_new_tokens": 60,
                           "stream": True}).encode()
        host, port = fe.url[len("http://"):].rsplit(":", 1)
        s = socket.create_connection((host, int(port)), timeout=30)
        s.sendall((f"POST /generate HTTP/1.1\r\nHost: {host}\r\n"
                   "Content-Type: application/json\r\n"
                   f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
        s.recv(1)
        s.close()
        deadline = time.monotonic() + 60
        while (tm.get_sample_value("mxnet_serve_requests_total",
                                   {"status": "cancelled"}) or 0) <= before:
            assert time.monotonic() < deadline, "disconnect never cancelled the request"
            time.sleep(0.02)
        assert eng.stats()["completed"].get("cancelled") == 1
    finally:
        fe.stop()
        eng.shutdown()


def test_multi_model_routing_matches_jax(nets):
    """A registry of two models behind one port: ``model`` routes
    /generate and /score, no key takes the default, an unknown model is a
    503, /healthz advertises both versions; the JAX registry answers the
    same."""
    other = _pair(1)
    engines = [[], []]
    fronts = []
    for pkg, (Eng, Reg, Fe) in enumerate(((JaxEngine, JaxRegistry, JaxFrontend),
                                          (InferenceEngine, ModelRegistry, HTTPFrontend))):
        reg = Reg()
        for name, pair in (("default", nets), ("other", other)):
            eng = Eng(pair[pkg], max_batch_size=2, max_len=32)
            engines[pkg].append(eng)
            reg.add(name, eng)
        reg.start()
        fronts.append(Fe(reg, port=0).start())
    try:
        urls = [f.url for f in fronts]
        for payload in ({"input_ids": [3, 4, 5], "max_new_tokens": 5},
                        {"input_ids": [3, 4, 5], "max_new_tokens": 5, "model": "other"},
                        {"input_ids": [3, 4, 5], "max_new_tokens": 5, "model": "default"}):
            (jc, jd), (tc, td) = (_post(u, "/generate", payload) for u in urls)
            assert jc == tc == 200 and td["generated_ids"] == jd["generated_ids"]
        a = _post(urls[1], "/generate", {"input_ids": [3, 4, 5], "max_new_tokens": 5})[1]
        b = _post(urls[1], "/generate", {"input_ids": [3, 4, 5], "max_new_tokens": 5,
                                         "model": "other"})[1]
        assert a["generated_ids"] != b["generated_ids"]
        (jc, jd), (tc, td) = (_post(u, "/score", {"input_ids": [3, 4, 5], "model": "other"})
                              for u in urls)
        assert jc == tc == 200
        onp.testing.assert_allclose(td["token_logprobs"], jd["token_logprobs"], rtol=0,
                                    atol=SCORE_TOL)
        codes = [_post(u, "/generate", {"input_ids": [1], "max_new_tokens": 2,
                                        "model": "nope"})[0] for u in urls]
        assert codes == [503, 503]
        (jc, jh), (tc, th) = (_get(u, "/healthz") for u in urls)
        assert jc == tc == 200
        _healthz_equal(th, jh)
        assert th["models"] == {"default": 0, "other": 0} and th["slots"] == 4
    finally:
        for f in fronts:
            f.stop()
        for eng in engines[0] + engines[1]:
            eng.shutdown()


def test_unported_endpoints_answer_501(nets):
    """/perf answers 501 with a message naming the ROADMAP item that brings
    it. /cache/export and /cache/import are served, and on a contiguous
    engine answer 400 naming the paged engine, as the JAX frontend does."""
    eng = InferenceEngine(nets[1], max_batch_size=1, max_len=32).start()
    fe = HTTPFrontend(eng, port=0).start()
    try:
        code, doc = _get(fe.url, "/perf")
        assert code == 501 and "ROADMAP Queue 1 item 8" in doc["error"]
        for code, doc in (_post(fe.url, "/cache/export", {"input_ids": [1, 2]}),
                          _post(fe.url, "/cache/import", {})):
            assert code == 400 and "paged engine" in doc["error"]
        # the connection still serves after an error with a body
        assert _post(fe.url, "/generate", {"input_ids": [1], "max_new_tokens": 2})[0] == 200
    finally:
        fe.stop()
        eng.shutdown()


def test_weights_endpoint_needs_dir_without_registry(nets, tmp_path):
    """POST /weights without a dir and without a registry is a 400, as in
    JAX; with a dir that holds no version, a 400 too."""
    srv = _Served(nets, max_batch_size=1, max_len=32)
    try:
        for payload in ({}, {"dir": str(tmp_path / "none")}):
            codes = [_post(u, "/weights", payload)[0] for u in srv.urls]
            assert codes == [400, 400]
    finally:
        srv.close()


@pytest.mark.parametrize("front", ["replica", "router"])
def test_frontend_backlog_holds_a_burst(nets, front):
    """32 clients connect at once, before the frontend's accept thread
    runs: every handshake completes at once. With the standard library's
    listen backlog of 5, the kernel drops the handshakes past it and the
    clients wait out SYN retransmits (seconds each), which cost a busy
    replica's HTTP burst most of its throughput on the card."""
    from mxnet_tpu_torch.serve import Router, RouterFrontend
    eng = None
    if front == "replica":
        eng = InferenceEngine(nets[1], max_batch_size=1, max_len=32)
        fe = HTTPFrontend(eng, port=0)
    else:
        fe = RouterFrontend(Router(["http://127.0.0.1:9"]), port=0)
    socks = []
    try:
        for _ in range(32):
            socks.append(socket.create_connection(fe.address[:2], timeout=0.5))
    finally:
        for s in socks:
            s.close()
        fe._httpd.server_close()
        if eng is not None:
            eng.shutdown()
    assert len(socks) == 32
