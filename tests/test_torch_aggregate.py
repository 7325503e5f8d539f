"""Port parity of the fleet's metric aggregation:
``mxnet_tpu_torch.observability.aggregate`` against
``mxnet_tpu.observability.aggregate``. On the same replica documents
(``metrics.dumps("json")`` of seeded registries), ``aggregate`` gives the
same merged document, ``render_prometheus`` the same text byte for byte,
and ``SLOTracker.update`` the same p99, violations and burn, scrape after
scrape, with the same ``mxnet_slo_*`` samples in each package's registry."""
import json

import numpy as onp
import pytest

from mxnet_tpu import metrics as jm
from mxnet_tpu.observability import aggregate as jagg

from mxnet_tpu_torch import metrics as tm
from mxnet_tpu_torch.observability import aggregate as tagg

TTFT, ITL = "mxnet_serve_ttft_seconds", "mxnet_serve_intertoken_seconds"


def _replica_doc(seed, scale=1.0):
    """One replica's JSON metrics document: a counter and a gauge with
    labels, the two SLO histograms, and a family already carrying a
    ``backend`` label (as the router's own do)."""
    rng = onp.random.RandomState(seed)
    reg = jm.MetricsRegistry()
    c = jm.Counter("mxnet_serve_requests_total", "Requests", ("status",), registry=reg)
    g = jm.Gauge("mxnet_serve_slots_in_use", "Slots", registry=reg)
    r = jm.Counter("mxnet_router_dispatch_total", "Dispatch", ("backend",), registry=reg)
    hs = [jm.Histogram(n, "latency", registry=reg) for n in (TTFT, ITL)]
    for status in ("ok", "error", 'we"ird\\'):
        c.labels(status=status).inc(float(rng.randint(0, 50)))
    g.set(float(rng.randint(0, 8)) / 3)
    r.labels(backend=f"http://h{seed}").inc(3)
    for h in hs:
        for v in rng.exponential(0.05 * scale, size=int(rng.randint(20, 200))):
            h.observe(float(v))
        h.observe(1e9)
    return json.loads(reg.dumps("json"))


@pytest.fixture
def enabled():
    was = (jm.enabled(), tm.enabled())
    jm.enable()
    tm.enable()
    jm.reset()
    tm.reset()
    yield
    for mod, on in zip((jm, tm), was):
        mod.reset()
        (mod.enable if on else mod.disable)()


@pytest.mark.parametrize("per_backend", [True, False])
def test_aggregate_and_render_match_jax(per_backend):
    """Three replicas (one missing a family) merged, then a router document
    merged on top with ``into=``: the same document and the same text."""
    docs = {f"http://r{i}:8000": _replica_doc(i) for i in range(3)}
    del docs["http://r2:8000"][ITL]
    jout = jagg.aggregate(docs, per_backend=per_backend)
    tout = tagg.aggregate(docs, per_backend=per_backend)
    assert json.dumps(tout, sort_keys=True) == json.dumps(jout, sort_keys=True)
    router = {"router": _replica_doc(7)}
    jout = jagg.aggregate(router, into=jout)
    tout = tagg.aggregate(router, into=tout)
    assert json.dumps(tout, sort_keys=True) == json.dumps(jout, sort_keys=True)
    assert tagg.render_prometheus(tout) == jagg.render_prometheus(jout)


def test_quantile_and_violation_helpers_match_jax():
    """The histogram quantile and the violation count on the same buckets,
    targets inside, between and past the grid."""
    doc = _replica_doc(3)
    sample = doc[TTFT]["samples"][0]
    buckets, count = sample["buckets"], sample["count"]
    for q in (0.5, 0.9, 0.99, 0.999):
        assert tagg._quantile(buckets, count, q) == jagg._quantile(buckets, count, q)
    for target in (0.0, 0.003, 0.05, 0.25, 7.5, 50.0):
        assert tagg._violations(buckets, count, target) == \
            jagg._violations(buckets, count, target)


def test_slo_tracker_update_matches_jax(enabled):
    """Scrape after scrape (replicas growing, one missing, one restarted),
    both trackers return the same SLO state and publish the same
    ``mxnet_slo_*`` samples."""
    targets = {"ttft": 0.1, "intertoken": 0.02}
    jt, tt = jagg.SLOTracker(targets), tagg.SLOTracker(targets)
    with pytest.raises(ValueError):
        tagg.SLOTracker({"tbt": 1.0})
    with pytest.raises(ValueError):
        tagg.SLOTracker(targets, objective=1.0)
    scrapes = [
        {"a": _replica_doc(10), "b": _replica_doc(11)},
        {"a": _replica_doc(12, 3.0), "b": _replica_doc(13, 2.0)},
        {"a": _replica_doc(14, 4.0)},                      # b missed a scrape
        {"a": _replica_doc(15, 1.0), "b": _replica_doc(16, 5.0)},   # a restarted
    ]
    for docs in scrapes:
        merged_j, merged_t = jagg.aggregate(docs), tagg.aggregate(docs)
        assert tt.update(merged_t) == jt.update(merged_j)
        assert tt.last == jt.last
        for fam in ("mxnet_slo_target_seconds", "mxnet_slo_p99_seconds",
                    "mxnet_slo_violations_total", "mxnet_slo_error_budget_burn"):
            for slo in targets:
                assert tm.get_sample_value(fam, {"slo": slo}) == \
                    jm.get_sample_value(fam, {"slo": slo}), (fam, slo)
    # a document without backend labels: fleet-total deltas
    flat = _replica_doc(20)
    assert tt.update(flat) == jt.update(flat)
