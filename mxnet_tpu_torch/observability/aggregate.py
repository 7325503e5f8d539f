"""Fleet metric aggregation and SLO tracking for the multi-replica router
(counterpart of ``mxnet_tpu/observability/aggregate.py``, function for
function).

A fleet of N serving replicas is N separate metrics registries. The router
is the one process that knows the fleet's membership, so its ``/metrics``
becomes the fleet view:

- :func:`aggregate` merges the replicas' ``metrics.dumps("json")``
  documents (fetched from each replica's ``/metrics/json``): counters and
  gauges with identical label sets sum, histograms merge bucket-wise (one
  codebase, so the same boundaries and cumulative counts add), and every
  sample is also re-emitted with a ``backend=<url>`` label so per-replica
  drill-down survives the merge.
- :func:`render_prometheus` turns the merged document back into text
  exposition (the inverse of ``metrics.dumps``), byte for byte what the
  JAX package renders for the same document.
- :class:`SLOTracker` reads the merged latency histograms on every scrape
  and keeps the serving SLOs: a p99 estimate per objective (linear
  interpolation inside the owning bucket), the violation count (requests
  over target, off the cumulative buckets) and the error-budget burn
  (observed violation fraction over the allowed fraction ``1 -
  objective``; burn > 1 spends the budget faster than it accrues),
  published as ``mxnet_slo_*`` in the router's own registry.

Pure host logic over JSON documents; nothing here touches a device.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

from .. import metrics as _metrics

__all__ = ["aggregate", "render_prometheus", "SLOTracker", "SLO_FAMILIES"]


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted(labels.items()))


def _merge_sample(into: Dict[str, Any], sample: Dict[str, Any], typ: str):
    if typ == "histogram":
        into["count"] = into.get("count", 0) + sample.get("count", 0)
        into["sum"] = into.get("sum", 0.0) + sample.get("sum", 0.0)
        buckets = into.setdefault("buckets", {})
        for b, n in (sample.get("buckets") or {}).items():
            buckets[b] = buckets.get(b, 0) + n
    else:
        into["value"] = into.get("value", 0.0) + sample.get("value", 0.0)


def aggregate(docs_by_backend: Dict[str, dict],
              per_backend: bool = True, into: Optional[dict] = None
              ) -> dict:
    """Merge per-replica JSON metric documents into one fleet document.

    For every family: one FLEET-TOTAL sample per distinct original label
    set (counters/gauges summed, histogram buckets merged), plus — with
    ``per_backend=True`` — each replica's samples re-labeled with
    ``backend=<name>`` for drill-down. Families missing from some
    replicas merge over the replicas that have them. Gauges sum, which
    is the right fleet semantic for the occupancy/queue gauges the
    router cares about (per-replica values stay readable under their
    backend label).

    ``into`` continues accumulation onto a previously aggregated
    document (its fleet totals and backend-labeled samples are adopted
    as-is, NOT re-summed) — the router merges its own registry into the
    replica merge this way without a second pass over the replicas."""
    out: Dict[str, Any] = {}
    if into:
        for fam_name, fam in into.items():
            ofam = out[fam_name] = {"type": fam.get("type", "untyped"),
                                    "help": fam.get("help", ""),
                                    "_merged": {}, "_backend": []}
            for sample in fam.get("samples", ()):
                if "backend" in (sample.get("labels") or {}):
                    ofam["_backend"].append(sample)
                else:
                    ofam["_merged"][_label_key(sample["labels"])] = sample
    for backend, doc in docs_by_backend.items():
        for fam_name, fam in (doc or {}).items():
            typ = fam.get("type", "untyped")
            ofam = out.setdefault(
                fam_name, {"type": typ, "help": fam.get("help", ""),
                           "_merged": {}, "_backend": []})
            merged = ofam["_merged"]
            for sample in fam.get("samples", ()):
                labels = dict(sample.get("labels") or {})
                slot = merged.setdefault(_label_key(labels),
                                         {"labels": labels})
                _merge_sample(slot, sample, typ)
                # samples that already carry a backend label (the
                # router's own per-replica families) are backend-
                # attributed as-is: re-labeling them would clobber the
                # original attribution AND emit duplicate series
                if per_backend and "backend" not in labels:
                    bs = dict(sample)
                    bs["labels"] = dict(labels, backend=backend)
                    ofam["_backend"].append(bs)
    for fam in out.values():
        fam["samples"] = list(fam.pop("_merged").values()) \
            + fam.pop("_backend")
    return out


def _fmt(v) -> str:
    # one source of truth for sample formatting: metrics.py's exposition
    # rules, so the router's rendered fleet text can never drift from
    # what the replicas themselves expose
    try:
        f = float(v)
    except (TypeError, ValueError):
        return "0"
    return _metrics._fmt(f)


_escape = _metrics._escape


def _label_str(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{_escape(v)}"'
                          for k, v in sorted(labels.items())) + "}"


def _bucket_sort_key(b: str):
    if b == "+Inf":
        return float("inf")
    try:
        return float(b)
    except ValueError:
        return float("inf")


def render_prometheus(doc: dict) -> str:
    """JSON metric document -> Prometheus text exposition (the inverse
    of ``metrics.dumps('json')``; same format ``metrics.expose()``
    emits, so tools/metrics_check.py's parser validates it)."""
    lines: List[str] = []
    for name, fam in doc.items():
        if fam.get("help"):
            lines.append(f"# HELP {name} {_escape(fam['help'])}")
        lines.append(f"# TYPE {name} {fam.get('type', 'untyped')}")
        for sample in fam.get("samples", ()):
            labels = dict(sample.get("labels") or {})
            if fam.get("type") == "histogram":
                buckets = sample.get("buckets") or {}
                for b in sorted(buckets, key=_bucket_sort_key):
                    bl = _label_str(dict(labels, le=b))
                    lines.append(f"{name}_bucket{bl} {int(buckets[b])}")
                ls = _label_str(labels)
                lines.append(f"{name}_sum{ls} {_fmt(sample.get('sum', 0))}")
                lines.append(
                    f"{name}_count{ls} {int(sample.get('count', 0))}")
            else:
                lines.append(f"{name}{_label_str(labels)} "
                             f"{_fmt(sample.get('value', 0))}")
    return "\n".join(lines) + "\n"


# slo name -> the latency histogram family it targets
SLO_FAMILIES = {
    "ttft": "mxnet_serve_ttft_seconds",
    "intertoken": "mxnet_serve_intertoken_seconds",
}


def _fleet_histogram(doc: dict, family: str) -> Optional[Dict[str, Any]]:
    """The fleet-total (no backend label) sample of one histogram
    family, merged across label sets."""
    fam = doc.get(family)
    if not fam:
        return None
    total: Dict[str, Any] = {}
    for sample in fam.get("samples", ()):
        if "backend" in (sample.get("labels") or {}):
            continue
        _merge_sample(total, sample, "histogram")
    return total if total.get("count") else None


def _backend_histograms(doc: dict, family: str) -> Dict[str, Dict[str, Any]]:
    """Per-backend merged samples of one histogram family (samples the
    aggregation re-labeled with ``backend=``)."""
    fam = doc.get(family)
    out: Dict[str, Dict[str, Any]] = {}
    if not fam:
        return out
    for sample in fam.get("samples", ()):
        backend = (sample.get("labels") or {}).get("backend")
        if backend is None:
            continue
        _merge_sample(out.setdefault(backend, {}), sample, "histogram")
    return out


def _quantile(buckets: Dict[str, int], count: int, q: float) -> float:
    """Prometheus-style histogram quantile: linear interpolation inside
    the owning bucket (cumulative counts)."""
    target = q * count
    prev_bound, prev_cum = 0.0, 0
    for b in sorted(buckets, key=_bucket_sort_key):
        cum = buckets[b]
        bound = _bucket_sort_key(b)
        if cum >= target:
            if bound == float("inf"):
                return prev_bound
            if cum == prev_cum:
                return bound
            frac = (target - prev_cum) / (cum - prev_cum)
            return prev_bound + (bound - prev_bound) * frac
        prev_bound, prev_cum = (0.0 if bound == float("inf") else bound), cum
    return prev_bound


def _violations(buckets: Dict[str, int], count: int,
                target: float) -> int:
    """Observations over ``target``, off the cumulative buckets. A
    target inside a bucket attributes the whole bucket as compliant
    (undercount — the grid quantizes the objective). A target ABOVE the
    largest finite bound cannot be resolved at all; rather than go
    blind (report 0 while every request blows the target), everything
    past the largest finite bound counts as a violation (overcount) —
    pick SLO targets inside the histogram grid for exact accounting."""
    best_cum = None
    largest_finite_cum = 0
    for b in sorted(buckets, key=_bucket_sort_key):
        bound = _bucket_sort_key(b)
        if bound != float("inf"):
            largest_finite_cum = buckets[b]
        if bound >= target and best_cum is None:
            if bound == float("inf"):
                best_cum = largest_finite_cum
            else:
                best_cum = buckets[b]
    if best_cum is None:
        best_cum = largest_finite_cum
    return max(0, count - best_cum)


class SLOTracker:
    """Latency-SLO bookkeeping over successive fleet scrapes.

    ``targets`` maps slo name (:data:`SLO_FAMILIES` keys) to the target
    latency in seconds at the given ``objective`` quantile (default
    0.99: "p99 TTFT under X ms"). Every :meth:`update` recomputes the
    p99 estimate and violation totals from the merged histograms and
    publishes::

        mxnet_slo_target_seconds{slo}       the configured target
        mxnet_slo_p99_seconds{slo}          current fleet p99 estimate
        mxnet_slo_violations_total{slo}     requests over target (monotone)
        mxnet_slo_error_budget_burn{slo}    violation fraction / allowed
                                            fraction (> 1 = burning)
    """

    def __init__(self, targets: Dict[str, float], objective: float = 0.99):
        unknown = set(targets) - set(SLO_FAMILIES)
        if unknown:
            raise ValueError(f"unknown SLOs {sorted(unknown)}; "
                             f"known: {sorted(SLO_FAMILIES)}")
        if not 0.0 < objective < 1.0:
            raise ValueError(f"objective must be in (0, 1), got {objective}")
        self.targets = {k: float(v) for k, v in targets.items()}
        self.objective = float(objective)
        self._lock = threading.Lock()
        #: last RAW cumulative violation total per (slo, backend) — or
        #: (slo, None) fleet-total when the document carries no backend
        #: labels. Per-backend tracking is what makes the counter
        #: flap-proof: a replica missing from one scrape simply
        #: contributes no delta, instead of shrinking the fleet total
        #: and masquerading as a counter reset.
        self._last_raw: Dict[Tuple[str, Optional[str]], int] = {}
        self.last: Dict[str, Dict[str, float]] = {}
        if _metrics.ENABLED:
            for slo, tgt in self.targets.items():
                _metrics.SLO_TARGET.labels(slo=slo).set(tgt)

    def update(self, merged_doc: dict) -> Dict[str, Dict[str, float]]:
        """Refresh every SLO from one merged fleet document; returns
        {slo: {target, p99, count, violations, burn}}."""
        out: Dict[str, Dict[str, float]] = {}
        budget = 1.0 - self.objective
        for slo, target in self.targets.items():
            hist = _fleet_histogram(merged_doc, SLO_FAMILIES[slo])
            if hist is None:
                continue
            count = int(hist["count"])
            buckets = hist.get("buckets") or {}
            p99 = _quantile(buckets, count, self.objective)
            viol = _violations(buckets, count, target)
            burn = (viol / count) / budget if count else 0.0
            # violation DELTAS are tracked per backend when the document
            # carries backend labels (the fleet aggregation's): a
            # replica missing from one scrape contributes no delta, and
            # a genuine restart (its own total shrinking) is a
            # Prometheus-style counter reset — count the post-reset
            # value instead of clamping
            per_backend = _backend_histograms(merged_doc,
                                              SLO_FAMILIES[slo])
            if per_backend:
                observed = {
                    b: _violations(h.get("buckets") or {},
                                   int(h.get("count", 0)), target)
                    for b, h in per_backend.items()}
            else:
                observed = {None: viol}
            delta = 0
            with self._lock:
                for b, v in observed.items():
                    prev = self._last_raw.get((slo, b), 0)
                    delta += v - prev if v >= prev else v
                    self._last_raw[(slo, b)] = v
            if _metrics.ENABLED:
                _metrics.SLO_TARGET.labels(slo=slo).set(target)
                _metrics.SLO_P99.labels(slo=slo).set(p99)
                _metrics.SLO_BURN.labels(slo=slo).set(burn)
                if delta:
                    _metrics.SLO_VIOLATIONS.labels(slo=slo).inc(delta)
            out[slo] = {"target": target, "p99": p99, "count": count,
                        "violations": viol, "burn": burn}
        self.last = out
        return out
