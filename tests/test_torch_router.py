"""Port parity of the multi-replica router: ``mxnet_tpu_torch.serve.router``
and the tenant scheduler of ``serve/registry.py`` against the JAX
package's. Both routers run the same scenario over identical fleets of
stdlib fake replicas (:class:`FakeReplica`, the port's copy of the JAX
suite's stub) and must make the same decisions: least-loaded dispatch and
rebalances, 5xx ejects and retries, rejoins, drains and drain-bounce
replays (streamed too, with no token twice), model-aware and
prefix-affinity dispatch, poll backoff, weighted fair queueing and the 429
of a tenant over quota. Health is probed by hand (a router started with
an hour's poll interval polls once), so every decision is deterministic."""
import json
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

import mxnet_tpu.metrics as jm
import mxnet_tpu.observability.trace as jtrace
import mxnet_tpu.serve.registry as jreg
import mxnet_tpu.serve.router as jrouter

import mxnet_tpu_torch.metrics as tm
import mxnet_tpu_torch.observability.trace as ttrace
import mxnet_tpu_torch.serve.registry as treg
import mxnet_tpu_torch.serve.router as trouter
from mxnet_tpu_torch.serve.paging import prefix_key

PACKAGES = {"jax": (jrouter, jreg, jm), "torch": (trouter, treg, tm)}
DEADLINE = 20.0


class FakeReplica:
    """Stdlib replica stub: settable ``/healthz`` fields (load, models,
    prefix advert, tier, draining), a script of ``/generate`` answers, SSE
    streams, ``/metrics/json`` and ``/drain``; records every request."""

    def __init__(self, name, load=0.0, models=None, slots=2):
        self.name = name
        state = self.state = {"load": load, "draining": False, "polls": 0,
                              "models": models, "slots": slots, "summary": None,
                              "tier": None, "script": [], "generated": [],
                              "metrics": {}, "tokens": [7, 8, 9]}

        class H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _json(self, code, doc):
                body = json.dumps(doc).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/metrics/json":
                    self._json(200, state["metrics"])
                    return
                if self.path.startswith("/trace/"):
                    self._json(404, {"error": "no trace"})
                    return
                state["polls"] += 1
                doc = {"ok": not state["draining"], "draining": state["draining"],
                       "load": state["load"], "slots": state["slots"],
                       "slots_in_use": 0, "queue_depth": 0}
                if state["models"] is not None:
                    doc["models"] = state["models"]
                if state["summary"] is not None:
                    doc["prefix_summary"] = state["summary"]
                if state["tier"] is not None:
                    doc["tier"] = state["tier"]
                self._json(503 if state["draining"] else 200, doc)

            def do_POST(self):
                payload = json.loads(self.rfile.read(
                    int(self.headers.get("Content-Length", 0))) or b"{}")
                if self.path == "/drain":
                    state["draining"] = True
                    self._json(200, {"ok": True, "draining": True})
                    return
                state["generated"].append(payload)
                code, doc = (state["script"].pop(0) if state["script"] else
                             (200, {"status": "ok", "output_ids": [1] + state["tokens"],
                                    "generated_ids": list(state["tokens"])}))
                if code == 200 and payload.get("stream"):
                    self.send_response(200)
                    self.send_header("Content-Type", "text/event-stream")
                    self.send_header("Connection", "close")
                    self.end_headers()
                    for i, tok in enumerate(doc.get("generated_ids", ())):
                        self.wfile.write(b"event: token\ndata: " + json.dumps(
                            {"token": tok, "index": i}).encode() + b"\n\n")
                    self.wfile.write(b"event: done\ndata: " + json.dumps(doc).encode()
                                     + b"\n\n")
                    self.wfile.flush()
                    self.close_connection = True
                    return
                self._json(code, doc)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.httpd.daemon_threads = True
        threading.Thread(target=self.httpd.serve_forever, kwargs={"poll_interval": 0.05},
                         daemon=True).start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.fixture
def fresh_metrics():
    was = (jm.enabled(), tm.enabled())
    for mod in (jm, tm):
        mod.reset()
        mod.enable()
    yield
    for mod, on in zip((jm, tm), was):
        mod.reset()
        (mod.enable if on else mod.disable)()


class Fleet:
    """Fake replicas plus one package's router over them, probed by hand."""

    def __init__(self, pkg, specs, **router_kw):
        self.R, self.reg, self.M = PACKAGES[pkg]
        self.fakes = {name: FakeReplica(name, **kw) for name, kw in specs.items()}
        self.names = {f.url: n for n, f in self.fakes.items()}
        self.router = self.R.Router([f.url for f in self.fakes.values()],
                                    health_interval=3600.0, health_jitter=0.0,
                                    **router_kw).start()

    def probe(self):
        for b in list(self.router._backends.values()):
            self.router._probe(b)

    def who(self):
        """The fakes that received a request since the last call, in order."""
        got = []
        for n, f in self.fakes.items():
            got += [n] * len(f.state["generated"])
            f.state["generated"].clear()
        return got

    def stats(self):
        """Router stats with fake names in place of URLs."""
        st = self.router.stats()
        st["backends"] = {self.names[u]: {k: v for k, v in b.items()}
                          for u, b in st["backends"].items()}
        return st

    def close(self):
        self.router.stop()
        for f in self.fakes.values():
            f.close()


def _both(scenario, specs, **router_kw):
    """Run ``scenario(fleet)`` for each package; return {pkg: its log}."""
    logs = {}
    for pkg in PACKAGES:
        fleet = Fleet(pkg, specs, **router_kw)
        try:
            logs[pkg] = scenario(fleet)
        finally:
            fleet.close()
    return logs


def _generate(fl, **payload):
    doc = {"input_ids": [1, 2, 3], "max_new_tokens": 3}
    doc.update(payload)
    try:
        out = fl.router.generate(doc)
        return out.get("status"), fl.who()
    except fl.R.NoBackendError as e:
        return "no_backend:" + str(e).split(" (")[0], fl.who()


def test_dispatch_eject_rejoin_drain_match_jax(fresh_metrics):
    """Least-loaded choice, rebalances, a 5xx eject with its retry, the
    rejoin at the next poll, model-aware dispatch, a drain, a drain-bounced
    replay and a non-retriable 4xx: the same decisions, stats and eject
    reasons in both packages."""
    def scenario(fl):
        f, log = fl.fakes, []
        log.append(("first", fl.stats()["healthy"]))
        log += [_generate(fl) for _ in range(3)]                 # b, least loaded
        f["b"].state["load"] = 2.0
        fl.probe()
        log.append(_generate(fl))                                # a: a rebalance
        f["b"].state["load"] = 0.0
        fl.probe()
        f["b"].state["script"] = [(503, {"error": "injected"})]
        log.append(_generate(fl))                                # b 503 -> a
        log.append(("after_5xx", fl.stats()["backends"]["b"]["healthy"]))
        fl.probe()                                               # b rejoins
        log.append(("rejoined", fl.stats()["backends"]["b"]["healthy"]))
        for n in "ab":
            f[n].state["models"] = {"x": 0}
        fl.probe()
        log.append(_generate(fl, model="m"))                     # only c serves m
        log.append(_generate(fl, model="x"))
        log.append(_generate(fl, model="zz"))                    # nobody
        f["a"].state["script"] = [(200, {"status": "shutdown", "generated_ids": [4]})]
        f["b"].state["load"] = 5.0
        fl.probe()
        log.append(_generate(fl, model="x"))                     # a bounces -> b
        fl.probe()
        f["b"].state["script"] = [(400, {"status": "error", "error": "bad"})]
        log.append(_generate(fl, model="x"))                     # 4xx passes through
        log.append(("drain", fl.router.drain(f["c"].url)))
        log.append(_generate(fl, model="m"))
        st = fl.stats()
        log.append({k: st[k] for k in ("healthy", "dispatches", "retries", "ejects",
                                        "rejoins", "rebalances")})
        log.append({n: (b["healthy"], b["draining"], b["load"], b["inflight"], b["fails"],
                        b["models"], b["slots"], b["poll_backoff"])
                    for n, b in sorted(st["backends"].items())})
        log.append({(fl.names[u], r): fl.M.get_sample_value(
            "mxnet_router_ejects_total", {"backend": u, "reason": r})
            for u in fl.names for r in ("poll_fail", "5xx", "draining")})
        log.append(fl.M.get_sample_value("mxnet_router_rebalances_total"))
        return log

    specs = {"a": dict(load=0.5), "b": dict(load=0.1), "c": dict(load=0.9, models={"m": 1})}
    logs = _both(scenario, specs)
    assert logs["torch"] == logs["jax"]
    assert logs["torch"][1] == ("ok", ["b"]) and logs["torch"][4] == ("ok", ["a"])


def test_poll_backoff_and_dead_replica_match_jax(fresh_metrics):
    """Backoff doubles per failed poll up to the cap and resets on success;
    a replica that stops answering is ejected (poll_fail) and its advert
    cleared; a request then fails over."""
    def scenario(fl):
        r, log = fl.router, []
        b = r._backends[fl.fakes["a"].url]
        for ok in (False, False, False, False, False, True, False):
            r._schedule_next_poll(b, ok, 100.0)
            log.append((round(b.poll_backoff, 6), round(b.next_poll - 100.0, 6)))
        fl.fakes["b"].close()
        fl.probe()
        st = fl.stats()
        log.append({n: (x["healthy"], x["poll_backoff"]) for n, x in st["backends"].items()})
        log.append(_generate(fl))
        return log

    logs = _both(scenario, {"a": {}, "b": {}}, health_backoff=2.0, health_backoff_max=0.4)
    assert logs["torch"] == logs["jax"]
    assert logs["torch"][4][0] == pytest.approx(0.4)


def _advert(prompt, lengths, ps=8):
    return {"page_size": ps, "roots": [[prefix_key(prompt[:n]), n, 2] for n in lengths]}


def test_affinity_dispatch_matches_jax(fresh_metrics):
    """Prefix-affinity: the longest advertised root wins (hit), a holder
    over the load bound falls back to least-loaded (load_bounded), a cold
    prompt dispatches least-loaded, a malformed advert reads as absent
    without an eject, a bounced replay scores the survivors again, and
    tier-targeted dispatch keeps to its tier: the same choices, outcomes
    and hit tokens in both packages."""
    prompt = list(range(3, 40))
    other = list(range(50, 70))

    def scenario(fl):
        f, log = fl.fakes, []
        f["a"].state["summary"] = _advert(prompt, [8, 16])
        f["b"].state["summary"] = _advert(prompt, [8, 16, 24])
        f["c"].state["summary"] = {"page_size": "WAT", "roots": [["x", "y"], [1], "junk"]}
        f["b"].state["tier"] = "decode"
        fl.probe()
        log.append({n: x["prefix_roots"] for n, x in fl.stats()["backends"].items()})
        log.append(_generate(fl, input_ids=prompt))              # b: 24 tokens
        log.append(_generate(fl, input_ids=other))               # cold: least loaded
        f["b"].state["load"] = 3.0
        fl.probe()
        log.append(_generate(fl, input_ids=prompt))              # a within the bound
        f["a"].state["load"] = 3.0
        fl.probe()
        log.append(_generate(fl, input_ids=prompt))              # both over: bounded
        f["a"].state["load"], f["b"].state["load"] = 0.0, 0.05
        f["b"].state["script"] = [(200, {"status": "shutdown"})]
        fl.probe()
        log.append(_generate(fl, input_ids=prompt))              # b bounces -> a
        fl.probe()
        log.append(("decode", fl.router.generate({"input_ids": prompt, "max_new_tokens": 2},
                                                 tier="decode")["status"], fl.who()))
        log.append(_generate(fl, input_ids=prompt[:1]))          # too short to score
        log.append({o: fl.M.get_sample_value("mxnet_cache_affinity_dispatch_total",
                                             {"outcome": o})
                    for o in ("hit", "load_bounded", "cold")})
        log.append(fl.M.get_sample_value("mxnet_cache_affinity_hit_tokens_total"))
        log.append(fl.stats()["backends"]["c"]["healthy"])
        return log

    specs = {"a": dict(load=0.2), "b": dict(load=0.3), "c": dict(load=0.1)}
    logs = _both(scenario, specs, affinity=True, affinity_max_load=1.5)
    assert logs["torch"] == logs["jax"]
    assert logs["torch"][1] == ("ok", ["b"])


def test_stream_replay_and_exactly_once_match_jax(fresh_metrics):
    """``generate_stream``: a drain bounce before any token replays on the
    next replica; a bounce after tokens ends the stream with the bounce as
    its terminal frame (no replay, no token twice); both packages yield
    the same frames."""
    def frames(fl, payload):
        return [fr for fr in fl.router.generate_stream(payload)]

    def scenario(fl):
        f, log = fl.fakes, []
        f["a"].state["script"] = [(200, {"status": "shutdown"})]
        out = frames(fl, {"input_ids": [1, 2], "max_new_tokens": 3})
        log.append((out, fl.who()))
        fl.probe()
        f["b"].state["load"] = 9.0
        fl.probe()
        f["a"].state["script"] = [(200, {"status": "shutdown", "generated_ids": [5, 6]})]
        log.append((frames(fl, {"input_ids": [1], "max_new_tokens": 3}), fl.who()))
        log.append({k: fl.stats()[k] for k in ("dispatches", "retries", "ejects")})
        return log

    logs = _both(scenario, {"a": dict(load=0.1), "b": dict(load=0.2)})
    assert logs["torch"] == logs["jax"]
    toks = [fr for fr in logs["torch"][0][0] if fr.startswith(b"event: token")]
    assert len(toks) == 3 and logs["torch"][0][1] == ["a", "b"]
    late = logs["torch"][1]
    assert late[1] == ["a"] and b'"shutdown"' in late[0][-1] and len(late[0]) == 3


def test_tenant_wfq_and_quota_match_jax(fresh_metrics):
    """The JAX suite's deterministic WFQ case on both schedulers: the
    released capacity goes to the tenant with less virtual time, quotas
    block past ``max_inflight`` and time out with QuotaExceededError."""
    def run(reg):
        sched = reg.TenantScheduler({"a": reg.TenantPolicy(weight=1.0),
                                     "b": reg.TenantPolicy(weight=4.0)},
                                    capacity_fn=lambda: 2)
        sched.acquire("a")
        sched.acquire("b")
        order = []
        evts = {tag: threading.Event() for tag in ("a2", "a3", "b2")}

        def waiter(tag, tenant):
            sched.acquire(tenant, timeout=DEADLINE)
            order.append(tag)
            evts[tag].set()

        threads = []
        for tag, tenant in (("a2", "a"), ("a3", "a"), ("b2", "b")):
            t = threading.Thread(target=waiter, args=(tag, tenant), daemon=True)
            t.start()
            threads.append(t)
            time.sleep(0.05)
        for release, tag in (("a", "a2"), ("b", "b2"), ("a", "a3")):
            sched.release(release)
            assert evts[tag].wait(DEADLINE)
        for t in threads:
            t.join(DEADLINE)
        stats = sched.stats()
        quota = reg.TenantScheduler({"q": reg.TenantPolicy(max_inflight=1)})
        quota.acquire("q")
        with pytest.raises(reg.QuotaExceededError):
            quota.acquire("q", timeout=0.05)
        with pytest.raises(treg.MXNetError if reg is treg else Exception):
            reg.TenantPolicy(weight=0)
        return order, stats

    jorder, jstats = run(jreg)
    torder, tstats = run(treg)
    assert torder == jorder == ["a2", "b2", "a3"]
    assert tstats == jstats
    assert tm.get_sample_value("mxnet_fleet_tenant_rejected_total", {"tenant": "q"}) == 1


def test_router_tenant_429_and_frontend_match_jax(fresh_metrics):
    """Through each package's RouterFrontend: a tenant over its quota gets
    429 while another tenant dispatches, the rejection is counted, /healthz
    aggregates the fleet, /perf answers (501 in the port, which has no cost
    ledger yet) and the fleet view merges the replicas' metrics."""
    def scenario(fl):
        log = []
        fe = fl.R.RouterFrontend(fl.router, port=0).start()
        try:
            fl.router._tenants.acquire("burst")
            for tenant in ("burst", "calm"):
                req = urllib.request.Request(
                    fe.url + "/generate", data=json.dumps(
                        {"input_ids": [1], "max_new_tokens": 1, "tenant": tenant}).encode(),
                    headers={"Content-Type": "application/json"})
                try:
                    with urllib.request.urlopen(req, timeout=DEADLINE) as r:
                        log.append((tenant, r.status))
                except urllib.error.HTTPError as e:
                    log.append((tenant, e.code))
            fl.router._tenants.release("burst")
            log.append(fl.M.get_sample_value("mxnet_fleet_tenant_rejected_total",
                                             {"tenant": "burst"}))
            with urllib.request.urlopen(fe.url + "/healthz", timeout=DEADLINE) as r:
                doc = json.loads(r.read())
            log.append((doc["ok"], doc["healthy"], doc["dispatches"]))
            try:
                urllib.request.urlopen(fe.url + "/perf", timeout=DEADLINE)
            except urllib.error.HTTPError as e:
                log.append(("perf", e.code))
            else:
                log.append(("perf", 200))
            return log
        finally:
            fe.stop()

    logs = _both(scenario, {"a": {}}, tenants={"burst": jreg.TenantPolicy(max_inflight=1)},
                 tenant_timeout=0.1)
    assert logs["torch"][:-1] == logs["jax"][:-1]
    assert logs["torch"][:2] == [("burst", 429), ("calm", 200)]
    assert logs["torch"][-1] == ("perf", 501) and logs["jax"][-1] == ("perf", 200)


def test_fleet_metrics_slo_and_trace(fresh_metrics):
    """``fleet_metrics`` merges the replicas' documents and refreshes the
    SLO tracker as the JAX router does (the replica families' lines and the
    ``mxnet_slo_*`` lines equal); with tracing on, a dispatched request's
    trace assembles a ``router.request`` root over its ``router.dispatch``
    attempts."""
    reg = jm.MetricsRegistry()
    h = jm.Histogram("mxnet_serve_ttft_seconds", "t", registry=reg)
    c = jm.Counter("mxnet_serve_requests_total", "r", ("status",), registry=reg)
    for v in (0.01, 0.2, 0.5, 3.0):
        h.observe(v)
    c.labels(status="ok").inc(4)
    doc = json.loads(reg.dumps("json"))

    def scenario(fl):
        for f in fl.fakes.values():
            f.state["metrics"] = doc
        text = fl.router.fleet_metrics()
        for u, n in fl.names.items():
            text = text.replace(u, n)
        keep = ("mxnet_serve_", "mxnet_slo_")
        return sorted(ln for ln in text.splitlines()
                      if ln.startswith(keep) or ln.startswith(("# HELP mxnet_serve",
                                                               "# TYPE mxnet_serve")))

    logs = _both(scenario, {"a": {}, "b": {}}, slo_targets={"ttft": 0.25})
    assert logs["torch"] == logs["jax"]
    assert any(ln.startswith('mxnet_slo_violations_total{slo="ttft"} 4') for ln in logs["torch"])

    spans = {}
    for pkg, tr in (("jax", jtrace), ("torch", ttrace)):
        was = tr.enabled()
        tr.enable()
        fl = Fleet(pkg, {"a": {}, "b": {}})
        try:
            fl.fakes["a"].state["script"] = [(503, {"error": "x"})]
            fl.fakes["a"].state["load"] = 0.0
            fl.fakes["b"].state["load"] = 0.5
            fl.probe()
            out = fl.router.generate({"input_ids": [1], "max_new_tokens": 1})
            got = fl.router.get_trace(out["trace_id"])
            spans[pkg] = sorted((s["name"], s["attrs"].get("attempt"), s["status"])
                                for s in got["spans"])
            assert got["trace_id"] == out["trace_id"]
        finally:
            fl.close()
            if not was:
                tr.disable()
    assert spans["torch"] == spans["jax"]
    assert [s[0] for s in spans["torch"]].count("router.dispatch") == 2
