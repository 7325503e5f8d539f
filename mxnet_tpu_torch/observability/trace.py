"""Distributed request tracing: spans, W3C traceparent propagation, and
the process-local trace store (a copy of
``mxnet_tpu/observability/trace.py``).

The missing third leg of the observability stack (metrics count, the
profiler draws one process's timeline — neither can follow ONE request
across router → replica → engine → decode, which is what operating a
fleet actually requires; PAPERS 1605.08695 makes exactly this tracing
tooling a first-class subsystem). Three pieces:

- **Spans.** :func:`start_span` opens a named span; ``span.child()``
  nests, ``span.event()`` annotates, ``span.end()`` closes it into the
  process-local :class:`TraceStore` and — while the chrome-trace
  profiler is ACTIVE — bridges it onto the profiler timeline as a
  ``cat="trace"`` slice, so request spans and kernel/step spans land in
  ONE viewer.
- **Context propagation.** Trace identity travels as a W3C
  ``traceparent`` header (``00-<32h trace-id>-<16h span-id>-<2h flags>``)
  through the HTTP frontend and the multi-replica router. The router
  injects the SAME trace id into every failover retry and drain-bounced
  replay, so one trace id names the request across every replica that
  touched it. Propagation works even where recording is disabled: a
  relay that has tracing off forwards the header untouched.
- **The store.** Finished spans collect per trace id in a bounded LRU
  (:data:`STORE`); ``/trace/{id}`` on the serving frontend (and the
  router, which merges its own spans with each replica's) exports the
  assembled span tree. Overflow never blocks or grows: past the caps,
  spans are dropped and counted (``dropped_trace_events`` — surfaced on
  ``/healthz`` so silent truncation is visible from the router).

Collection is OFF by default (:func:`enable` / ``MXNET_TRACE``). The
disabled fast path is one module-attribute check returning the shared
:data:`NOOP` span — instrumented hot paths (engine decode ticks, router
dispatch) stay allocation-free.

Training-side: :class:`StepTimeline` gives ``TrainStep``/``Trainer`` the
per-step phase accounting (h2d, dispatch, collective staging, loss-sync,
plus input-wait / checkpoint-stall handed over from the prefetcher and
CheckpointManager via :func:`note_blocked`) that feeds
``mxnet_step_phase_seconds{path,phase}`` and derives
``mxnet_step_overlap_fraction{path}`` — the fraction of step wall time
the host was NOT blocked waiting (on data or on the device), i.e. how
much of the dispatch/collective window actually overlapped compute. The
ROADMAP "verify the all-gather/compute overlap" question reads straight
off that gauge: blocked host time is exactly the part of the update the
pipeline failed to hide.
"""
from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional

from ..base import get_env

__all__ = [
    "TraceContext", "Span", "TraceStore", "STORE", "NOOP",
    "enable", "disable", "enabled",
    "new_trace_id", "new_span_id", "parse_traceparent",
    "start_span", "export", "trace_ids", "dropped_trace_events",
    "evicted_traces", "reset", "assemble",
    "note_blocked", "take_blocked", "StepTimeline",
]

# fast-path flag consulted by instrumented hot paths; True only after
# enable(). Reading one module attribute is the whole disabled-path cost.
ENABLED = False

_SPAN_EVENT_CAP = 64          # events kept per span (excess -> dropped count)


def new_trace_id() -> str:
    """32 lowercase hex chars (W3C trace-id)."""
    return os.urandom(16).hex()


def new_span_id() -> str:
    """16 lowercase hex chars (W3C parent-id/span-id)."""
    return os.urandom(8).hex()


class TraceContext:
    """Immutable (trace_id, span_id, flags) triple — the propagated
    identity of one request."""

    __slots__ = ("trace_id", "span_id", "flags")

    def __init__(self, trace_id: str, span_id: str, flags: int = 1):
        self.trace_id = trace_id
        self.span_id = span_id
        self.flags = flags

    def traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-{self.flags:02x}"

    def __repr__(self):
        return f"TraceContext({self.traceparent()})"


def _is_hex(s: str) -> bool:
    return all(c in "0123456789abcdef" for c in s)


def parse_traceparent(header: Optional[str]) -> Optional[TraceContext]:
    """Parse a W3C ``traceparent`` header; returns None on anything
    malformed (a bad header must start a fresh trace, never 500 the
    request)."""
    if not header or not isinstance(header, str):
        return None
    parts = header.strip().lower().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, flags = parts
    if (len(version) != 2 or len(trace_id) != 32 or len(span_id) != 16
            or len(flags) != 2):
        return None
    if not (_is_hex(version) and _is_hex(trace_id) and _is_hex(span_id)
            and _is_hex(flags)):
        return None
    if version == "ff" or set(trace_id) == {"0"} or set(span_id) == {"0"}:
        return None
    return TraceContext(trace_id, span_id, int(flags, 16))


class _NoopSpan:
    """Shared do-nothing span returned while tracing is disabled: falsy,
    so call sites can also gate extra work with ``if span:``."""

    __slots__ = ()

    def __bool__(self):
        return False

    @property
    def context(self):
        return None

    @property
    def trace_id(self):
        return None

    def child(self, name, **attrs):
        return self

    def event(self, name, **attrs):
        pass

    def set(self, key, value):
        pass

    def end(self, status: Optional[str] = None,
            t1: Optional[float] = None):
        # signature-compatible with Span.end: call sites hold NOOP
        # children whenever tracing is toggled off mid-flight
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _NoopSpan()


class Span:
    """One timed, attributed operation in a trace. Not thread-safe per
    instance by design — each span is owned by the thread that opened it
    (the engine loop, one HTTP handler, one dispatch attempt)."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "t0", "t1",
                 "attrs", "events", "status", "_ended")

    def __init__(self, name: str, trace_id: str, parent_id: Optional[str],
                 t0: Optional[float] = None, **attrs):
        self.name = name
        self.trace_id = trace_id
        self.span_id = new_span_id()
        self.parent_id = parent_id
        self.t0 = time.time() if t0 is None else t0
        self.t1: Optional[float] = None
        self.attrs: Dict[str, Any] = attrs
        self.events: List[Dict[str, Any]] = []
        self.status: Optional[str] = None
        self._ended = False

    def __bool__(self):
        return True

    @property
    def context(self) -> TraceContext:
        return TraceContext(self.trace_id, self.span_id)

    def child(self, name: str, t0: Optional[float] = None,
              **attrs) -> "Span":
        if not ENABLED:
            return NOOP
        return Span(name, self.trace_id, self.span_id, t0=t0, **attrs)

    def event(self, name: str, **attrs):
        if len(self.events) < _SPAN_EVENT_CAP:
            self.events.append({"name": name, "t": time.time(), **attrs})
        else:
            STORE._drop(1)

    def set(self, key: str, value):
        self.attrs[key] = value

    def end(self, status: Optional[str] = None, t1: Optional[float] = None):
        """Close the span into the store (idempotent) and bridge it onto
        the chrome-trace timeline while the profiler is ACTIVE."""
        if self._ended:
            return
        self._ended = True
        self.t1 = time.time() if t1 is None else t1
        if status is not None:
            self.status = status
        STORE.add(self)
        from . import recorder as _recorder
        _recorder.RECORDER.record_span(self.name, self.trace_id,
                                       self.t1 - self.t0, self.status)
        from .. import profiler as _profiler
        if _profiler.ACTIVE:
            # wall-clock t0/t1 -> the profiler's perf_counter timeline:
            # shift by the (stable within a process) clock offset
            off = time.perf_counter() - time.time()
            _profiler.record_span(
                self.name, "trace", self.t0 + off, self.t1 + off,
                args={"trace_id": self.trace_id, "span_id": self.span_id,
                      **{k: v for k, v in self.attrs.items()
                         if isinstance(v, (str, int, float, bool))}})

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name, "trace_id": self.trace_id,
            "span_id": self.span_id, "parent_id": self.parent_id,
            "t0": self.t0, "t1": self.t1,
            "dur_s": (None if self.t1 is None else self.t1 - self.t0),
            "status": self.status, "attrs": dict(self.attrs),
            "events": list(self.events),
        }

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.end(status="error" if exc_type is not None else None)
        return False


class TraceStore:
    """Bounded LRU of finished spans, keyed by trace id. Overflow drops
    (and counts) instead of growing or blocking — the flight-recorder
    discipline, applied to traces."""

    def __init__(self, max_traces: int = 256,
                 max_spans_per_trace: int = 512):
        self.max_traces = int(max_traces)
        self.max_spans = int(max_spans_per_trace)
        self._lock = threading.Lock()
        self._traces: "OrderedDict[str, List[Dict[str, Any]]]" = \
            OrderedDict()
        self._dropped = 0
        self._evicted = 0      # whole traces LRU-evicted (monotone)
        self._added = 0        # monotone: every span ever accepted

    def _drop(self, n: int):
        with self._lock:
            self._dropped += n

    def dropped(self) -> int:
        """Spans/events discarded by the caps over the process lifetime
        (monotone — a valid Prometheus counter source)."""
        return self._dropped

    def evicted(self) -> int:
        """Whole traces rotated out by the LRU bound (monotone). Normal
        under sustained traffic — but a /trace 404 for a recently issued
        id reads off this, not off ``dropped()``."""
        return self._evicted

    def add(self, span: Span):
        doc = span.to_dict()
        with self._lock:
            spans = self._traces.get(span.trace_id)
            if spans is None:
                while len(self._traces) >= self.max_traces:
                    # LRU turnover is normal under sustained load, but a
                    # 404 for a trace id someone was handed must not be
                    # silent — count evictions separately from cap drops
                    self._traces.popitem(last=False)
                    self._evicted += 1
                spans = self._traces[span.trace_id] = []
            else:
                self._traces.move_to_end(span.trace_id)
            if len(spans) >= self.max_spans:
                # drop the OLDEST span, not the newest: the request root
                # ends LAST (carrying status/retire), and a long
                # generation's trace must keep its root + recent chunks
                # rather than an orphan forest of early chunks
                spans.pop(0)
                self._dropped += 1
            spans.append(doc)
            self._added += 1

    def added(self) -> int:
        """Spans ever accepted into the store (monotone)."""
        return self._added

    def export(self, trace_id: str) -> Optional[Dict[str, Any]]:
        """``{"trace_id", "spans", "tree"}`` for one trace, or None.
        ``spans`` is flat (t0-ordered); ``tree`` nests each span's
        ``children`` under it (spans whose parent is remote/unknown are
        roots — the replica's view of a router-rooted trace)."""
        with self._lock:
            spans = self._traces.get(trace_id)
            if spans is None:
                return None
            spans = [dict(s) for s in spans]
        return assemble(trace_id, spans)

    def ids(self) -> List[str]:
        with self._lock:
            return list(self._traces)

    def reset(self):
        with self._lock:
            self._traces.clear()
            self._dropped = 0
            self._evicted = 0
            self._added = 0


def assemble(trace_id: str,
             spans: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Build the export document from flat span dicts (dedup by span_id,
    t0-order, nest children under parents). Shared by the local store
    and the router's cross-process merge (its own spans + each
    replica's view of the same trace id)."""
    uniq: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
    for s in spans:
        uniq.setdefault(s["span_id"], s)
    spans = sorted(uniq.values(), key=lambda s: s["t0"])
    by_id = {s["span_id"]: dict(s, children=[]) for s in spans}
    roots = []
    for s in spans:
        node = by_id[s["span_id"]]
        parent = by_id.get(s["parent_id"])
        if parent is not None:
            parent["children"].append(node)
        else:
            roots.append(node)
    return {"trace_id": trace_id, "spans": spans, "tree": roots}


STORE = TraceStore()


def enable(max_traces: Optional[int] = None,
           max_spans_per_trace: Optional[int] = None):
    """Turn span recording on (hot paths start opening real spans)."""
    global ENABLED
    if max_traces is not None:
        STORE.max_traces = int(max_traces)
    if max_spans_per_trace is not None:
        STORE.max_spans = int(max_spans_per_trace)
    ENABLED = True


def disable():
    global ENABLED
    ENABLED = False


def enabled() -> bool:
    return ENABLED


def reset():
    """Drop every stored trace (test isolation); keeps the enable state."""
    STORE.reset()


def export(trace_id: str) -> Optional[Dict[str, Any]]:
    return STORE.export(trace_id)


def trace_ids() -> List[str]:
    return STORE.ids()


def dropped_trace_events() -> int:
    return STORE.dropped()


def evicted_traces() -> int:
    return STORE.evicted()


def start_span(name: str, parent=None, t0: Optional[float] = None,
               **attrs):
    """Open a span. ``parent`` may be a :class:`Span`, a
    :class:`TraceContext`, a raw ``traceparent`` header string, or None
    (a fresh trace). Returns :data:`NOOP` while tracing is disabled."""
    if not ENABLED:
        return NOOP
    if isinstance(parent, str):
        parent = parse_traceparent(parent)
    if isinstance(parent, Span):
        return Span(name, parent.trace_id, parent.span_id, t0=t0, **attrs)
    if isinstance(parent, TraceContext):
        return Span(name, parent.trace_id, parent.span_id, t0=t0, **attrs)
    return Span(name, new_trace_id(), None, t0=t0, **attrs)


# ---------------------------------------------------------------------------
# step-phase timelines (training side)
# ---------------------------------------------------------------------------

_tls = threading.local()

# phases where the host is BLOCKED (waiting on data or the device) rather
# than doing useful overlappable work; these subtract from the overlap
# fraction. dispatch/h2d/allreduce are host WORK that runs while the
# device computes — they are timed as phases but not counted as blocked.
BLOCKING_PHASES = frozenset(
    {"input_wait", "loss_sync", "checkpoint_stall"})


def note_blocked(phase: str, seconds: float):
    """Hand a blocking wait measured OUTSIDE the step body (prefetcher
    input wait, checkpoint-stall on save) to the thread's next
    ``StepTimeline`` step. Thread-local, bounded (a handful of phase
    keys), and safe to call with no timeline consuming it."""
    acc = getattr(_tls, "blocked", None)
    if acc is None:
        acc = _tls.blocked = {}
    acc[phase] = acc.get(phase, 0.0) + seconds


def take_blocked() -> Dict[str, float]:
    acc = getattr(_tls, "blocked", None)
    if not acc:
        return {}
    _tls.blocked = {}
    return acc


class _Phase:
    __slots__ = ("_tl", "_name", "_t0")

    def __init__(self, tl: "StepTimeline", name: str):
        self._tl = tl
        self._name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._tl._observe_phase(self._name,
                                time.perf_counter() - self._t0)
        return False


class _NoopPhase:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP_PHASE = _NoopPhase()


class StepTimeline:
    """Per-step phase accounting for one training loop (one ``path``
    label: train_step / train_step_multi / trainer).

    Drive it from the step implementation::

        tl = timeline.begin()            # no-op object when idle
        with tl.phase("h2d"): ...
        with tl.phase("dispatch"): ...
        timeline.finish()                # derives the overlap gauge

    ``begin()`` folds in any :func:`note_blocked` waits this thread
    recorded since the last step (prefetcher input wait, checkpoint
    stall). ``finish()`` publishes ``mxnet_step_phase_seconds`` samples
    (done live by ``phase()``), sets
    ``mxnet_step_overlap_fraction{path}`` — ``1 - blocked/wall`` over
    the window since the previous ``finish()`` — and, with tracing
    enabled, closes one ``train.step`` span (phases as children) into
    the shared trace for this timeline.

    Cost when both metrics and tracing are off: ``begin()`` is one bool
    check returning a shared no-op.
    """

    def __init__(self, path: str):
        self.path = path
        self._active = False
        self._t_begin: Optional[float] = None
        self._t_prev_finish: Optional[float] = None
        self._blocked = 0.0
        self._step = 0
        self._span = NOOP
        self._run_ctx: Optional[TraceContext] = None
        self.last_overlap: Optional[float] = None

    # ------------------------------------------------------------ driving
    def begin(self) -> "StepTimeline":
        from .. import metrics as _metrics
        if not (_metrics.ENABLED or ENABLED):
            self._active = False
            return self
        self._active = True
        self._step += 1
        self._blocked = 0.0
        self._t_begin = time.perf_counter()
        if ENABLED:
            # rotate the run trace periodically: a million-step run must
            # not silently stop tracing at the per-trace span cap (or
            # pollute the dropped counter every step past it). ~5 spans
            # per step (step + phases) x 64 steps stays well under the
            # default 512-span cap; each segment root names its window.
            if self._run_ctx is None or (self._step - 1) % 64 == 0:
                root = start_span("train.run", path=self.path,
                                  first_step=self._step)
                self._run_ctx = root.context
                root.end()
            self._span = Span("train.step", self._run_ctx.trace_id,
                              self._run_ctx.span_id, step=self._step,
                              path=self.path)
        else:
            self._span = NOOP
        # waits recorded between steps (input pipeline, checkpoint)
        for phase, dt in take_blocked().items():
            self._observe_phase(phase, dt)
        return self

    def phase(self, name: str):
        if not self._active:
            return _NOOP_PHASE
        return _Phase(self, name)

    def _observe_phase(self, name: str, dt: float):
        from .. import metrics as _metrics
        if _metrics.ENABLED:
            _metrics.STEP_PHASE.labels(path=self.path, phase=name).observe(dt)
        if name in BLOCKING_PHASES:
            self._blocked += dt
        if self._span:
            now = time.time()
            ph = self._span.child(f"phase.{name}", t0=now - dt)
            ph.end(t1=now)

    def finish(self):
        """Close the current step. The overlap window is measured from
        the PREVIOUS finish (so inter-step waits count as wall time);
        the first step has no window and sets no gauge."""
        if not self._active:
            return
        now = time.perf_counter()
        first = self._t_prev_finish is None
        wall = now - (self._t_begin if first else self._t_prev_finish)
        self._t_prev_finish = now
        if wall > 0 and not first:
            # no gauge on the first step: blocked time handed over from
            # before begin() (prefetcher warm-up waits) has no matching
            # wall window yet and would read as a spurious 0% overlap
            overlap = min(1.0, max(0.0, 1.0 - self._blocked / wall))
            self.last_overlap = overlap
            from .. import metrics as _metrics
            if _metrics.ENABLED:
                _metrics.STEP_OVERLAP.labels(path=self.path).set(overlap)
            if self._span:
                self._span.set("overlap_fraction", round(overlap, 4))
                self._span.set("blocked_s", round(self._blocked, 6))
        if self._span:
            self._span.end()
            self._span = NOOP
        self._active = False

    @property
    def trace_id(self) -> Optional[str]:
        return self._run_ctx.trace_id if self._run_ctx else None


if get_env("MXNET_TRACE", False, dtype=bool,
           doc="enable distributed request tracing at import"):
    enable()
