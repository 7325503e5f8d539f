"""Runtime telemetry: the process-wide metrics registry and its exposition
(counterpart of ``mxnet_tpu/metrics.py``).

Three instrument kinds, :class:`Counter`, :class:`Gauge` and
:class:`Histogram`, with Prometheus-style labels, collected in one
:data:`REGISTRY` and exposed as Prometheus text (``expose()``) or JSON
(``dumps("json")``). For the same calls both give the JAX package's text
byte for byte. While the profiler's host store runs, counter and gauge
updates are bridged onto it as chrome-trace 'C' events.

Collection is OFF by default (``MXNET_METRICS`` or ``enable()``); the
disabled path is one module-attribute check.

The families here are the JAX package's serving subset, under its names,
help strings, labels and buckets: ``mxnet_serve_*`` (requests, queue,
TTFT, inter-token, steps, compiles, host round trips, pages, prefix cache,
weight versions), ``mxnet_decode_launches_total`` and
``mxnet_decode_dma_*`` (the launch sites and DMA program of each built
step, counted once when the step is built), ``mxnet_spec_*``,
``mxnet_grammar_*``, ``mxnet_cache_advert_roots``,
``mxnet_cachedop_cache_hits_total`` (a hybridized block's cache hits),
``mxnet_recompilations_total``, the trace-store counters, the flight
recorder's dumps, and the step-phase families ``StepTimeline`` reports.
The training, elastic, ZeRO, SLO, AOT, fleet, router and executable-cost
families wait for their slices (ROADMAP Queue 1 item 8).
"""
from __future__ import annotations

import bisect
import json
import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from . import profiler as _profiler
from .base import MXNetError, get_env

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "enable", "disable", "enabled", "reset", "expose", "dumps",
    "get_sample_value", "register_collect_callback",
]

# fast-path flag consulted by runtime hot paths; True only after enable().
# Reading one module attribute is the whole disabled-path cost.
ENABLED = False

DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


class _Noop:
    """Shared do-nothing child returned by ``labels()`` while disabled:
    keeps instrumented call sites allocation- and lock-free when idle."""

    __slots__ = ()

    def inc(self, amount=1.0):
        pass

    def dec(self, amount=1.0):
        pass

    def set(self, value):
        pass

    def observe(self, value):
        pass


_NOOP = _Noop()


def _label_str(labelnames: Sequence[str], labelvalues: Sequence[str]) -> str:
    if not labelnames:
        return ""
    return "{" + ",".join(f'{k}="{_escape(v)}"'
                          for k, v in zip(labelnames, labelvalues)) + "}"


def _escape(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class _CounterChild:
    __slots__ = ("_family", "_labelvalues", "_lock", "_value", "_trace_name")

    def __init__(self, family, labelvalues):
        self._family = family
        self._labelvalues = labelvalues
        self._lock = threading.Lock()
        self._value = 0.0
        # precomputed: the chrome-trace bridge must cost nothing beyond the
        # ACTIVE check on the per-op enabled path
        self._trace_name = family.name + _label_str(family.labelnames,
                                                    labelvalues)

    @property
    def value(self) -> float:
        return self._value

    def inc(self, amount: float = 1.0):
        if not ENABLED:
            return
        if amount < 0:
            raise MXNetError(f"counter {self._family.name}: inc by {amount} < 0")
        with self._lock:
            self._value += amount
            v = self._value
        if _profiler.ACTIVE:
            _profiler.counter_event(self._trace_name, v)

    def _set_direct(self, value: float):
        """Collection-callback path: write an externally-sourced monotone
        value, bypassing the ENABLED gate (collection is explicit)."""
        with self._lock:
            self._value = float(value)


class _GaugeChild:
    __slots__ = ("_family", "_labelvalues", "_lock", "_value", "_trace_name")

    def __init__(self, family, labelvalues):
        self._family = family
        self._labelvalues = labelvalues
        self._lock = threading.Lock()
        self._value = 0.0
        self._trace_name = family.name + _label_str(family.labelnames,
                                                    labelvalues)

    @property
    def value(self) -> float:
        return self._value

    def set(self, value: float):
        if not ENABLED:
            return
        with self._lock:
            self._value = float(value)
        if _profiler.ACTIVE:
            _profiler.counter_event(self._trace_name, float(value))

    def inc(self, amount: float = 1.0):
        if not ENABLED:
            return
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0):
        self.inc(-amount)

    def _set_direct(self, value: float):
        with self._lock:
            self._value = float(value)


class _HistogramChild:
    __slots__ = ("_family", "_labelvalues", "_lock", "_counts", "_sum",
                 "_count")

    def __init__(self, family, labelvalues):
        self._family = family
        self._labelvalues = labelvalues
        self._lock = threading.Lock()
        self._counts = [0] * (len(family.buckets) + 1)  # last = +Inf
        self._sum = 0.0
        self._count = 0

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def observe(self, value: float):
        if not ENABLED:
            return
        i = bisect.bisect_left(self._family.buckets, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1

    def snapshot(self):
        """(cumulative bucket counts incl. +Inf, sum, count) — consistent
        under the child lock."""
        with self._lock:
            counts = list(self._counts)
            s, c = self._sum, self._count
        cum, acc = [], 0
        for n in counts:
            acc += n
            cum.append(acc)
        return cum, s, c


class _MetricFamily:
    """One named metric; holds label children (or a single unlabeled child,
    created eagerly so the enabled path never allocates either).

    Constructing a family whose name is already registered (same type and
    labels) returns THE REGISTERED INSTANCE — a re-executed notebook cell
    gets the live metric back instead of a silent orphan whose updates
    never reach expose()."""

    typ = "untyped"
    _child_cls: type = _CounterChild

    def __new__(cls, name: str, help: str = "", labels: Sequence[str] = (),
                registry: Optional["MetricsRegistry"] = None, **kwargs):
        reg = registry if registry is not None else REGISTRY
        existing = reg.get(name)
        if existing is not None:
            if (type(existing) is not cls
                    or existing.labelnames != tuple(labels)):
                raise MXNetError(
                    f"metric {name} already registered with a different "
                    "type/label set")
            return existing
        return super().__new__(cls)

    def __init__(self, name: str, help: str = "", labels: Sequence[str] = (),
                 registry: Optional["MetricsRegistry"] = None, **kwargs):
        if getattr(self, "_initialized", False):
            return  # deduplicated: __new__ returned the live instance
        self._initialized = True
        self.name = name
        self.help = help
        self.labelnames = tuple(labels)
        self._lock = threading.Lock()
        self._children: "OrderedDict[Tuple[str, ...], Any]" = OrderedDict()
        self._unlabeled = None
        if not self.labelnames:
            self._unlabeled = self._make_child(())
            self._children[()] = self._unlabeled
        if registry is None:
            registry = REGISTRY
        registry.register(self)

    def _make_child(self, labelvalues):
        return self._child_cls(self, labelvalues)

    def _child(self, labelvalues: Tuple[str, ...]):
        """Always-create child lookup (collection callbacks and the enabled
        ``labels()`` path)."""
        child = self._children.get(labelvalues)
        if child is None:
            with self._lock:
                child = self._children.get(labelvalues)
                if child is None:
                    child = self._make_child(labelvalues)
                    self._children[labelvalues] = child
        return child

    def labels(self, **kv):
        if not ENABLED:
            return _NOOP
        try:
            key = tuple(str(kv[k]) for k in self.labelnames)
        except KeyError as e:
            raise MXNetError(
                f"metric {self.name}: missing label {e.args[0]!r} "
                f"(declared: {list(self.labelnames)})")
        if len(kv) != len(self.labelnames):
            extra = set(kv) - set(self.labelnames)
            raise MXNetError(f"metric {self.name}: unknown labels {sorted(extra)}")
        return self._child(key)

    def children(self) -> List[Tuple[Tuple[str, ...], Any]]:
        with self._lock:
            return list(self._children.items())

    def reset(self):
        with self._lock:
            if self.labelnames:
                self._children.clear()
            else:
                self._unlabeled = self._make_child(())
                self._children[()] = self._unlabeled

    # unlabeled conveniences: forward to the single child
    def _only(self):
        if self.labelnames:
            raise MXNetError(
                f"metric {self.name} has labels {list(self.labelnames)}; "
                "use .labels(...)")
        return self._unlabeled


class Counter(_MetricFamily):
    """Monotonically-increasing count (Prometheus counter)."""

    typ = "counter"
    _child_cls = _CounterChild

    def inc(self, amount: float = 1.0):
        if not ENABLED:
            return
        self._only().inc(amount)


class Gauge(_MetricFamily):
    """Point-in-time value that can go up and down (Prometheus gauge)."""

    typ = "gauge"
    _child_cls = _GaugeChild

    def set(self, value: float):
        if not ENABLED:
            return
        self._only().set(value)

    def inc(self, amount: float = 1.0):
        if not ENABLED:
            return
        self._only().inc(amount)

    def dec(self, amount: float = 1.0):
        if not ENABLED:
            return
        self._only().dec(amount)


class Histogram(_MetricFamily):
    """Cumulative-bucket distribution (Prometheus histogram)."""

    typ = "histogram"
    _child_cls = _HistogramChild

    def __init__(self, name, help="", labels=(), registry=None,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        new_buckets = tuple(sorted(float(b) for b in buckets))
        if getattr(self, "_initialized", False):
            # deduplicated: different boundaries cannot merge into the
            # live children — fail loudly like a type/label mismatch does
            if new_buckets != self.buckets:
                raise MXNetError(
                    f"histogram {name} already registered with buckets "
                    f"{self.buckets}; cannot re-register with {new_buckets}")
            return
        self.buckets = new_buckets
        super().__init__(name, help, labels, registry)

    def observe(self, value: float):
        if not ENABLED:
            return
        self._only().observe(value)


class MetricsRegistry:
    """Process-wide named-metric registry with pluggable collection
    callbacks (sampled sources like PJRT memory stats)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: "OrderedDict[str, _MetricFamily]" = OrderedDict()
        self._callbacks: List[Callable[[], None]] = []

    def register(self, metric: _MetricFamily) -> _MetricFamily:
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None:
                if (type(existing) is not type(metric)
                        or existing.labelnames != metric.labelnames):
                    raise MXNetError(
                        f"metric {metric.name} already registered with a "
                        "different type/label set")
                return existing
            self._metrics[metric.name] = metric
            return metric

    def get(self, name: str) -> Optional[_MetricFamily]:
        with self._lock:
            return self._metrics.get(name)

    def register_callback(self, fn: Callable[[], None]):
        """``fn()`` runs at every collection (expose/dumps) to refresh
        sampled metrics; exceptions are swallowed (telemetry never takes
        the workload down)."""
        with self._lock:
            self._callbacks.append(fn)
        return fn

    def _run_callbacks(self):
        with self._lock:
            cbs = list(self._callbacks)
        for fn in cbs:
            try:
                fn()
            except Exception:
                pass

    def families(self) -> List[_MetricFamily]:
        self._run_callbacks()
        with self._lock:
            return list(self._metrics.values())

    def reset(self):
        with self._lock:
            fams = list(self._metrics.values())
        for f in fams:
            f.reset()

    # ------------------------------------------------------------ exposition
    def expose(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines: List[str] = []
        for fam in self.families():
            if fam.help:
                lines.append(f"# HELP {fam.name} {_escape(fam.help)}")
            lines.append(f"# TYPE {fam.name} {fam.typ}")
            for labelvalues, child in fam.children():
                ls = _label_str(fam.labelnames, labelvalues)
                if fam.typ == "histogram":
                    cum, s, c = child.snapshot()
                    for bound, n in zip(list(fam.buckets) + ["+Inf"], cum):
                        le = bound if bound == "+Inf" else repr(float(bound))
                        blabels = list(zip(fam.labelnames, labelvalues)) + \
                            [("le", str(le))]
                        bl = "{" + ",".join(
                            f'{k}="{_escape(v)}"' for k, v in blabels) + "}"
                        lines.append(f"{fam.name}_bucket{bl} {n}")
                    lines.append(f"{fam.name}_sum{ls} {_fmt(s)}")
                    lines.append(f"{fam.name}_count{ls} {c}")
                else:
                    lines.append(f"{fam.name}{ls} {_fmt(child.value)}")
        return "\n".join(lines) + "\n"

    def dumps(self, format: str = "json") -> str:
        """Machine-readable dump: ``format='json'`` (bench/CI) or a human
        ``'table'``."""
        if format == "json":
            doc: Dict[str, Any] = {}
            for fam in self.families():
                samples = []
                for labelvalues, child in fam.children():
                    labels = dict(zip(fam.labelnames, labelvalues))
                    if fam.typ == "histogram":
                        cum, s, c = child.snapshot()
                        samples.append({
                            "labels": labels, "count": c, "sum": s,
                            "buckets": {str(b): n for b, n in zip(
                                list(fam.buckets) + ["+Inf"], cum)},
                        })
                    else:
                        samples.append({"labels": labels,
                                        "value": child.value})
                doc[fam.name] = {"type": fam.typ, "help": fam.help,
                                 "samples": samples}
            return json.dumps(doc)
        if format == "table":
            rows = []
            for fam in self.families():
                for labelvalues, child in fam.children():
                    ls = _label_str(fam.labelnames, labelvalues)
                    if fam.typ == "histogram":
                        _, s, c = child.snapshot()
                        val = f"count={c} sum={_fmt(s)}"
                    else:
                        val = _fmt(child.value)
                    rows.append((fam.name + ls, fam.typ, val))
            w = max([len(r[0]) for r in rows], default=20)
            lines = [f"{'Metric':<{w}}  {'Type':<9}  Value"]
            lines += [f"{n:<{w}}  {t:<9}  {v}" for n, t, v in rows]
            return "\n".join(lines)
        raise MXNetError(f"metrics.dumps: unknown format {format!r}")

    def get_sample_value(self, name: str,
                         labels: Optional[Dict[str, str]] = None):
        """Read one sample by exposition name (histograms via ``_count`` /
        ``_sum`` suffixes). ``labels=None`` sums over all children — handy
        for 'total across ops' assertions. Returns None if absent."""
        base, field = name, "value"
        fam = self.get(name)
        if fam is None:
            for suffix in ("_count", "_sum"):
                if name.endswith(suffix):
                    fam = self.get(name[:-len(suffix)])
                    if fam is not None:
                        base, field = name[:-len(suffix)], suffix[1:]
                    break
        if fam is None:
            return None
        total, hit = 0.0, False
        for labelvalues, child in fam.children():
            if labels is not None:
                child_labels = dict(zip(fam.labelnames, labelvalues))
                if any(child_labels.get(k) != str(v)
                       for k, v in labels.items()):
                    continue
            hit = True
            if fam.typ == "histogram":
                _, s, c = child.snapshot()
                total += c if field == "count" else s
            else:
                total += child.value
        return total if hit else None


def _fmt(v: float) -> str:
    # Prometheus text format supports non-finite samples; int(v) on them
    # would raise and take the whole scrape down
    if v != v:
        return "NaN"
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


REGISTRY = MetricsRegistry()


def enable():
    """Turn collection on (hot paths start recording)."""
    global ENABLED
    ENABLED = True


def disable():
    global ENABLED
    ENABLED = False


def enabled() -> bool:
    return ENABLED


def reset():
    """Zero every metric (keep registrations); test/CI isolation."""
    REGISTRY.reset()


def expose() -> str:
    return REGISTRY.expose()


def dumps(format: str = "json") -> str:
    return REGISTRY.dumps(format)


def get_sample_value(name: str, labels: Optional[Dict[str, str]] = None):
    return REGISTRY.get_sample_value(name, labels)


def register_collect_callback(fn: Callable[[], None]):
    return REGISTRY.register_callback(fn)


# ---------------------------------------------------------------------------
# The serving instrument catalog (one definition site, in the JAX package's
# registration order)
# ---------------------------------------------------------------------------

CACHE_HITS = Counter(
    "mxnet_cachedop_cache_hits_total",
    "CachedOp trace-cache hits (no recompilation)", labels=("block",))
RECOMPILATIONS = Counter(
    "mxnet_recompilations_total",
    "XLA trace builds: kind=initial first trace, kind=retrace a new "
    "shape/dtype/mode signature forced recompilation (also warn-logged)",
    labels=("block", "kind"))
STEP_PHASE = Histogram(
    "mxnet_step_phase_seconds",
    "Per-step training phase durations (phase=input_wait|h2d|dispatch|"
    "loss_sync|checkpoint_stall|allreduce|update): the step timeline "
    "TrainStep/Trainer record through observability.trace.StepTimeline",
    labels=("path", "phase"))
STEP_OVERLAP = Gauge(
    "mxnet_step_overlap_fraction",
    "1 - blocked/wall per training step: the fraction of step wall time "
    "the host was NOT blocked waiting on data or the device — how much "
    "of the dispatch/collective window (incl. the ZeRO param all-gather) "
    "actually overlapped compute", labels=("path",))
TRACE_SPANS = Counter(
    "mxnet_trace_spans_total",
    "Spans recorded into the process trace store")
TRACE_DROPPED = Counter(
    "mxnet_trace_spans_dropped_total",
    "Spans/events dropped by the trace-store caps (mirrors "
    "trace.dropped_trace_events; nonzero means /trace output is "
    "truncated)")
FLIGHT_DUMPS = Counter(
    "mxnet_flight_recorder_dumps_total",
    "Flight-recorder dumps by trigger (reason=engine_exception|"
    "guard_violation|preemption_storm|sigterm|manual)",
    labels=("reason",))
SERVE_HOST_SYNC = Histogram(
    "mxnet_serve_host_sync_seconds",
    "Engine-loop blocking host reads (token D2H sync); with decode "
    "lookahead the read overlaps the next step's compute, so this is "
    "the residual un-overlapped host time")
SERVE_REQUESTS = Counter(
    "mxnet_serve_requests_total",
    "Serving requests by terminal status (ok/timeout/cancelled/rejected/"
    "shutdown/error)", labels=("status",))
SERVE_QUEUE_DEPTH = Gauge(
    "mxnet_serve_queue_depth", "Requests waiting for a decode slot")
SERVE_QUEUE_WAIT = Histogram(
    "mxnet_serve_queue_wait_seconds",
    "Submit-to-slot-admission wait (admission control latency)")
SERVE_TTFT = Histogram(
    "mxnet_serve_ttft_seconds",
    "Time to first token: submit -> prefill sampled token0")
SERVE_INTERTOKEN = Histogram(
    "mxnet_serve_intertoken_seconds",
    "Per-token decode latency (one continuous-batching step)")
SERVE_REQUEST_SECONDS = Histogram(
    "mxnet_serve_request_seconds", "End-to-end request latency")
SERVE_TOKENS = Counter(
    "mxnet_serve_tokens_total", "Tokens generated by the serving engine")
SERVE_TOKENS_PER_SEC = Gauge(
    "mxnet_serve_tokens_per_sec",
    "Decode throughput of the most recent engine step (active slots / "
    "step wall time)")
SERVE_SLOTS_IN_USE = Gauge(
    "mxnet_serve_slots_in_use", "KV-cache slots currently decoding")
SERVE_SLOT_OCCUPANCY = Gauge(
    "mxnet_serve_slot_occupancy",
    "Fraction of the slot pool in use (continuous-batching efficiency)")
SERVE_PREFILL_SECONDS = Histogram(
    "mxnet_serve_prefill_seconds",
    "Prefill latency per admitted request (bucketed prompt forward + "
    "slot cache insert)")
SERVE_STEP_SECONDS = Histogram(
    "mxnet_serve_decode_step_seconds",
    "Wall time of one batched decode step (all active slots advance one "
    "token)")
SERVE_COMPILES = Counter(
    "mxnet_serve_compiles_total",
    "Shape-bucket executables built by the serving engine (fn=prefill|"
    "decode). Flat after warmup = steady state hits only cached "
    "executables.", labels=("fn",))
SERVE_ROUNDTRIPS = Counter(
    "mxnet_serve_host_roundtrips_total",
    "Blocking host reads per engine dispatch (path=prefill|decode). With "
    "multi-token decode one decode round-trip covers K tokens, so "
    "round-trips/token << 1 is the overlap win the loadgen reports",
    labels=("path",))
DECODE_LAUNCHES = Counter(
    "mxnet_decode_launches_total",
    "Decode kernel-launch SITES recorded at trace time (kind=gemv|"
    "fused_block|fused_block_paged|fused_head|spec_verify): one "
    "increment per launch the compiled step will issue per execution — "
    "the static launches-per-step the fused-decode path collapses "
    "(ops/int8_gemv.count_launches tallies one trace). fused_block_paged "
    "is the paged engine's one-launch block step; fused_block_paged_dma "
    "its DMA-resident variant for pools past the VMEM budget; an _int4 "
    "suffix (and the gemv_int4 kind) marks the packed-nibble weight "
    "lane; spec_verify marks a speculative verify executable's trace",
    labels=("kind",))
DECODE_DMA_COPIES = Counter(
    "mxnet_decode_dma_copies_total",
    "Async K/V page copies the DMA-resident paged fused decode kernel "
    "issues per execution (scatters of the new token row + per-page "
    "gathers into the double buffer). Trace-time semantics like "
    "mxnet_decode_launches_total: the STATIC per-step DMA program, not "
    "runtime events")
DECODE_DMA_BYTES = Counter(
    "mxnet_decode_dma_bytes_total",
    "Bytes those async copies move per execution of the DMA-resident "
    "paged fused decode step (pool-dtype bytes; gathers dominate). "
    "bytes/copies = mean transfer size — small means the page size is "
    "fragmenting the stream")
DECODE_DMA_WAITS = Counter(
    "mxnet_decode_dma_waits_total",
    "Semaphore waits the DMA-resident paged fused decode kernel retires "
    "per execution. The lifecycle invariant is waits == copies (every "
    "async copy started is waited exactly once — the static guarantee "
    "mxlint MX101 proves on the kernel source); "
    "analysis.guards.dma_ledger_check() asserts the parity at runtime "
    "after a paged-DMA serve round")
SPEC_DRAFTED = Counter(
    "mxnet_spec_drafted_tokens_total",
    "Draft tokens proposed by the self-speculative (prompt-lookup) "
    "decode path, per verify round: speculate-1 per live row")
SPEC_ACCEPTED = Counter(
    "mxnet_spec_accepted_tokens_total",
    "Draft tokens the exact verify step accepted (the emitted token "
    "equals the draft). accepted + rejected == drafted")
SPEC_REJECTED = Counter(
    "mxnet_spec_rejected_tokens_total",
    "Draft tokens the exact verify step rejected (replaced by the true "
    "token; everything after the first rejection in a round is "
    "discarded unverified and counts rejected too)")
SPEC_ROUNDS = Counter(
    "mxnet_spec_rounds_total",
    "Speculative verify dispatches (each covers every live slot; one "
    "host round-trip emits 1..K tokens per row)")
SPEC_ACCEPTANCE = Gauge(
    "mxnet_spec_acceptance_rate",
    "Running draft acceptance rate: accepted_tokens / drafted_tokens "
    "over the engine's lifetime (1.0 = every draft right — repetitive/"
    "structured traffic; near 0 = speculation pays for nothing but "
    "still emits >= 1 true token per round)")
GRAMMAR_SESSIONS = Counter(
    "mxnet_grammar_sessions_total",
    "Requests admitted with a grammar constraint attached (each decodes "
    "through the token-mask automaton; schema-conformant output by "
    "construction)")
GRAMMAR_MASK_CACHE_HITS = Counter(
    "mxnet_grammar_mask_cache_hits_total",
    "Compiled-automaton cache hits (tier=memory|disk): the "
    "content-addressed mask cache served the grammar without a "
    "recompile — steady-state structured traffic should be all hits",
    labels=("tier",))
GRAMMAR_MASK_CACHE_MISSES = Counter(
    "mxnet_grammar_mask_cache_misses_total",
    "Grammar compilations that missed every cache tier and paid the "
    "regex->DFA->token-automaton build (mxnet_grammar_compile_seconds)")
GRAMMAR_REJECTED = Counter(
    "mxnet_grammar_rejected_tokens_total",
    "Speculative draft tokens the grammar forbade (rewritten to a legal "
    "token before the verify — a grammar rejection is exactly a "
    "mismatch rejection under the token-identical contract)")
GRAMMAR_COMPILE_SECONDS = Histogram(
    "mxnet_grammar_compile_seconds",
    "Wall seconds to compile one grammar to its token-mask automaton "
    "(cache misses only; hits cost two dict lookups)",
    buckets=(0.001, 0.005, 0.02, 0.1, 0.5, 2.0, 10.0))
SERVE_PAGE_POOL = Gauge(
    "mxnet_serve_page_pool_pages",
    "Leasable KV pages in the pool (paged engine HBM budget; excludes "
    "the sink page)")
SERVE_PAGE_IN_USE = Gauge(
    "mxnet_serve_page_in_use",
    "KV pages currently leased (slot block tables + prefix-cache pins): "
    "requests now cost their ACTUAL length in HBM, not max_len")
SERVE_PAGE_LEASES = Counter(
    "mxnet_serve_page_leases_total",
    "Pages leased on demand as decode positions advance (frees are "
    "implicit at retire/eviction: in_use is the live balance)")
SERVE_PAGE_COW = Counter(
    "mxnet_serve_page_cow_forks_total",
    "Copy-on-write forks: a slot wrote into a page shared with the "
    "prefix cache or another slot, so the page was copied first")
SERVE_PAGE_PREEMPTIONS = Counter(
    "mxnet_serve_page_preemptions_total",
    "Slots preempted on pool exhaustion (released + requeued; resumed "
    "exactly via the stateless per-request sampling streams)")
SERVE_PREFIX_HITS = Counter(
    "mxnet_serve_page_prefix_hits_total",
    "Admissions that mapped cached shared-prefix pages instead of "
    "re-prefilling them")
SERVE_PREFIX_MISSES = Counter(
    "mxnet_serve_page_prefix_misses_total",
    "Admissions with no cached prefix (full prefill)")
SERVE_PREFIX_TOKENS_SAVED = Counter(
    "mxnet_serve_page_prefix_tokens_saved_total",
    "Prompt tokens whose prefill was skipped via prefix-cache page "
    "mapping (bytes saved = tokens x per-token KV bytes, reported by "
    "the engine stats)")
SERVE_PREFIX_BYTES_SAVED = Counter(
    "mxnet_serve_page_prefix_bytes_saved_total",
    "HBM write traffic avoided by prefix-cache hits (tokens_saved x "
    "per-token KV row bytes)")
SERVE_PREFIX_COLLISIONS = Counter(
    "mxnet_serve_page_prefix_collisions_total",
    "Prefix-cache key collisions detected by token comparison (the "
    "match walk stops; the span is prefilled normally)")
SERVE_PREFILL_CHUNKS = Counter(
    "mxnet_serve_page_prefill_chunks_total",
    "Chunked-prefill chunks dispatched (long prompts split into "
    "page-sized chunks interleaved with decode steps, bounding TTFT "
    "p99 for in-flight requests)")
SERVE_WEIGHT_VERSION = Gauge(
    "mxnet_serve_weight_version",
    "Checkpoint version the engine's captured params currently serve "
    "(flips between decode ticks on a hot swap; 0 = construction-time "
    "weights, never published)", labels=("model",))
SERVE_WEIGHT_SWAPS = Counter(
    "mxnet_serve_weight_swaps_total",
    "Live weight swaps applied between decode ticks (no restart, no "
    "recompile — shapes unchanged means the same executables)",
    labels=("model",))
CACHE_ADVERT_ROOTS = Gauge(
    "mxnet_cache_advert_roots",
    "Prefix-cache roots this replica currently advertises via /healthz "
    "(bounded by the serve_prefix_advert knob — the O(N) health-poll "
    "payload contract)")


@register_collect_callback
def _sample_trace_counters():
    # lazy import: observability imports metrics at module top; this
    # callback only runs at collection time, after both modules exist
    try:
        from .observability import trace as _trace
    except Exception:
        return
    TRACE_DROPPED._child(())._set_direct(float(_trace.dropped_trace_events()))
    TRACE_SPANS._child(())._set_direct(float(_trace.STORE.added()))


if get_env("MXNET_METRICS", False, dtype=bool,
           doc="enable the runtime metrics registry at import"):
    enable()
