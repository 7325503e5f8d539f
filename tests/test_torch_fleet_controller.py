"""Port parity of the autoscale controller: ``mxnet_tpu_torch.serve.fleet``
(and ``cachefleet.TieredFleetController``) against the JAX package's.
Both controllers tick over the same scripted router snapshots, SLO
state, replica health and clock, and must return the same decision
sequence: hysteresis, cooldown, the min-replica floor, SLO-burn scale-up
and its window, scale-down victims, graceful retirement and its grace
expiry, the replica bounds, tiers; with the same ``mxnet_fleet_*``
samples and ``stats()``. ``SubprocessSpawner`` boots, lists and stops a
replica process that the test writes to ``tmp_path``, with a deadline on
every wait."""
import sys
import textwrap

import pytest

import mxnet_tpu.metrics as jm
import mxnet_tpu.serve.cachefleet as jcf
import mxnet_tpu.serve.fleet as jfleet

import mxnet_tpu_torch.metrics as tm
import mxnet_tpu_torch.serve.cachefleet as tcf
import mxnet_tpu_torch.serve.fleet as tfleet
from mxnet_tpu_torch.base import MXNetError

PACKAGES = {"jax": (jfleet, jcf, jm), "torch": (tfleet, tcf, tm)}


class Clock:
    """A settable stand-in for the ``time`` module of the fleet module."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t

    def perf_counter(self):
        return self.t

    def time(self):
        return self.t

    def sleep(self, s):
        self.t += s


class SLO:
    objective = 0.99

    def __init__(self):
        self.last = {}


class FakeRouter:
    """The router surface the controller reads: ``stats()`` returns the
    scripted backends; drains, additions and removals are logged."""

    def __init__(self, slo=None):
        self.backends = {}
        self.log = []
        self._slo = slo
        self.scrapes = 0

    def stats(self):
        return {"backends": {u: dict(b) for u, b in self.backends.items()}}

    def fleet_metrics(self, timeout=2.0):
        self.scrapes += 1
        return ""

    def add_backend(self, url):
        self.log.append(("add", url))
        self.backends[url] = {"healthy": True, "load": 0.0, "tier": None}

    def remove_backend(self, url):
        self.log.append(("remove", url))
        self.backends.pop(url)

    def drain(self, url):
        self.log.append(("drain", url))
        self.backends[url]["healthy"] = False


class FakeSpawner:
    def __init__(self, tier=None):
        self.n = 0
        self.live = []
        self.tier = tier

    def spawn(self):
        self.n += 1
        url = f"http://{self.tier or 'r'}{self.n}"
        self.live.append(url)
        return url

    def stop(self, url):
        self.live.remove(url)

    def urls(self):
        return list(self.live)


def _samples(M):
    out = {}
    for fam in ("mxnet_fleet_decisions_suppressed_total", "mxnet_fleet_scale_events_total",
                "mxnet_fleet_replicas", "mxnet_fleet_pressure",
                "mxnet_fleet_controller_ticks_total", "mxnet_fleet_tier_replicas",
                "mxnet_fleet_tier_scale_events_total"):
        f = M.REGISTRY.get(fam)
        for labels in sorted(f._children) if f is not None else ():
            out[(fam, labels)] = M.get_sample_value(fam, dict(zip(f.labelnames, labels)))
    return out


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


def _run(pkg, monkeypatch, script, policy_kw, tier=None, slo=False):
    """Tick one package's controller through ``script``: a list of (clock
    advance, {url: (healthy, load)} or None to keep, SLO ``last`` or None,
    {url: healthz doc or None} for retiring replicas)."""
    F, _, M = PACKAGES[pkg]
    clock = Clock()
    monkeypatch.setattr(F, "time", clock)
    router = FakeRouter(SLO() if slo else None)
    spawner = FakeSpawner()
    ctl = F.FleetController(router, spawner, F.AutoscalePolicy(**policy_kw), tier=tier)
    health = {}
    ctl._healthz = lambda url: health.get(url)
    first = spawner.spawn()
    router.backends[first] = {"healthy": True, "load": 0.0, "tier": tier}
    log = []
    for dt, loads, slo_last, healthz in script:
        clock.t += dt
        if loads is not None:
            for url, (ok, load) in loads.items():
                url = url if url.startswith("http") else f"http://r{url}"
                if url in router.backends:
                    router.backends[url].update(healthy=ok, load=load)
        if slo_last is not None:
            router._slo.last = slo_last
        health.update({f"http://r{k}": v for k, v in (healthz or {}).items()})
        ev = ctl.tick()
        log.append((ev, list(router.log), spawner.urls(), sorted(ctl._retiring)))
        router.log.clear()
    st = ctl.stats()
    return log, st, _samples(M), ctl.slo_burn()


def _both(monkeypatch, script, policy_kw, **kw):
    out = {}
    for pkg in PACKAGES:
        for mod in (jm, tm):
            mod.reset()
        out[pkg] = _run(pkg, monkeypatch, script, policy_kw, **kw)
    return out


BUSY = {"slots_in_use": 1, "queue_depth": 0}
IDLE = {"slots_in_use": 0, "queue_depth": 0}


def test_tick_sequence_matches_jax(fresh_metrics, monkeypatch):
    """Load up through hysteresis, a scale-up, a cooldown suppression, the
    bound at max, slack down with the least-loaded owned victim, a busy
    then idle retirement, a grace expiry and a replica gone silent."""
    policy = dict(scale_up_load=0.7, scale_down_load=0.2, up_after=2, down_after=2,
                  cooldown_s=10.0, min_replicas=1, max_replicas=3, drain_grace_s=5.0,
                  refresh_slo=False)
    script = [
        (1, {"1": (True, 0.9)}, None, None),              # streak 1: hysteresis
        (1, None, None, None),                            # up -> r2
        (1, {"1": (True, 0.9), "2": (True, 0.9)}, None, None),
        (1, None, None, None),                            # cooldown
        (20, None, None, None),                           # up -> r3
        (20, {"3": (True, 0.95)}, None, None),
        (1, None, None, None),                            # at_max
        (1, {"1": (True, 0.1), "2": (True, 0.05), "3": (True, 0.15)}, None, None),
        (1, None, None, {"2": BUSY}),                     # down: r2 drains, busy
        (1, None, None, {"2": BUSY}),
        (1, None, None, {"2": IDLE}),                     # r2 retired
        (20, {"1": (True, 0.0), "3": (True, 0.0)}, None, None),
        (1, None, None, {"1": BUSY}),                     # down: r1 (tie: url order)
        (10, None, None, {"1": BUSY}),                    # grace expired
        (20, {"3": (True, 0.0)}, None, None),
        (1, None, None, None),                            # at_min
    ]
    out = _both(monkeypatch, script, policy)
    assert out["torch"] == out["jax"]
    events = [e for e, *_ in out["torch"][0] if e is not None]
    assert [e["direction"] for e in events] == ["up", "up", "down", "down"]


def test_min_floor_burn_and_no_owned_match_jax(fresh_metrics, monkeypatch):
    """The emergency floor spawns without hysteresis (and is bounded by the
    cooldown); SLO burn over the window (on the tier's own SLO axis) scales
    up with reason ``slo_burn`` and the window consumes; a replica that
    stops answering while retiring is given up after three failed
    probes."""
    policy = dict(scale_up_load=0.8, scale_down_load=0.1, up_after=1, down_after=1,
                  cooldown_s=5.0, min_replicas=1, max_replicas=3, drain_grace_s=60.0,
                  refresh_slo=True, slo_names=("ttft",))
    slo1 = {"ttft": {"violations": 0, "count": 100, "burn": 0.0},
            "intertoken": {"violations": 90, "count": 100, "burn": 90.0}}
    slo2 = {"ttft": {"violations": 5, "count": 200, "burn": 2.5},
            "intertoken": {"violations": 90, "count": 100, "burn": 90.0}}
    script = [
        (1, {"1": (False, 0.0)}, slo1, None),             # floor: spawn r2
        (1, {"2": (False, 0.0)}, None, None),             # floor again: cooldown
        (1, {"1": (True, 0.3), "2": (True, 0.3)}, slo1, None),
        (10, None, slo2, None),                           # ttft burn 5: up -> r3
        (1, {"2": (True, 0.0), "1": (True, 0.05), "3": (True, 0.05)}, None, None),
        (10, None, None, None),                           # down: r2
        (1, None, None, {"2": None}),
        (1, None, None, {"2": None}),                     # third failure: gone
        (1, None, None, None),
    ]
    out = _both(monkeypatch, script, policy, slo=True)
    assert out["torch"] == out["jax"]
    reasons = [(e["direction"], e["reason"]) for e, *_ in out["torch"][0] if e is not None]
    assert reasons == [("up", "min_floor"), ("up", "slo_burn"), ("down", "load")]
    assert out["torch"][3] == 2.5            # slo_names: the ttft axis only


def test_tiered_controller_matches_jax(fresh_metrics, monkeypatch):
    """Two tiers over one router: each tier's controller sees only its own
    backends and scales on its own pressure, counted per tier."""
    logs = {}
    for pkg, (F, CF, M) in PACKAGES.items():
        for mod in (jm, tm):
            mod.reset()
        clock = Clock()
        monkeypatch.setattr(F, "time", clock)
        router = FakeRouter()
        sp = {t: FakeSpawner(tier=t) for t in ("prefill", "decode")}
        pol = F.AutoscalePolicy(scale_up_load=0.5, scale_down_load=0.1, up_after=1,
                                down_after=1, cooldown_s=0.0, refresh_slo=False)
        tc = CF.TieredFleetController(router, {t: (s, pol) for t, s in sp.items()})
        for t, s in sp.items():
            url = s.spawn()
            router.backends[url] = {"healthy": True, "load": 0.9 if t == "prefill" else 0.3,
                                    "tier": t}
        got = []
        for _ in range(2):
            clock.t += 1
            got.append({t: (e or {}).get("direction") for t, e in tc.tick().items()})
            for url, b in router.backends.items():
                b["tier"] = b["tier"] or ("prefill" if "prefill" in url else "decode")
        got.append({t: s.urls() for t, s in sp.items()})
        got.append(_samples(M))
        got.append({t: {k: v for k, v in st.items() if k != "policy"}
                    for t, st in tc.stats().items()})
        logs[pkg] = got
        with pytest.raises(Exception):
            CF.TieredFleetController(router, {"x": (sp["decode"], object())})
    assert logs["torch"] == logs["jax"]
    assert logs["torch"][0] == {"prefill": "up", "decode": None}


def test_policy_validation():
    for kw in (dict(min_replicas=3, max_replicas=2), dict(scale_down_load=0.8),
               dict(up_after=0)):
        with pytest.raises(MXNetError):
            tfleet.AutoscalePolicy(**kw)


REPLICA = textwrap.dedent('''
    import json, sys
    from http.server import BaseHTTPRequestHandler, HTTPServer

    class H(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            body = json.dumps({"ok": True, "load": 0.0, "slots": 1}).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    HTTPServer(("127.0.0.1", int(sys.argv[1])), H).serve_forever()
''')


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_subprocess_spawner(tmp_path):
    """A replica process boots to healthy, is listed, and stops; a replica
    that exits during boot raises naming its exit code."""
    script = tmp_path / "replica.py"
    script.write_text(REPLICA)
    port = _free_port()
    sp = tfleet.SubprocessSpawner(lambda p: [sys.executable, str(script), str(p)],
                                  base_port=port, boot_timeout=30.0)
    url = sp.spawn()
    try:
        assert url == f"http://127.0.0.1:{port}" and sp.urls() == [url]
        proc = sp._procs[url]
    finally:
        sp.stop(url)
    assert proc.poll() is not None and sp.urls() == []
    with pytest.raises(MXNetError):
        sp.stop(url)
    bad = tfleet.SubprocessSpawner(lambda p: [sys.executable, "-c", "raise SystemExit(3)"],
                                   base_port=_free_port(), boot_timeout=30.0)
    with pytest.raises(MXNetError, match="rc=3"):
        bad.spawn()
