"""Flight recorder: an always-on, bounded ring of recent runtime events,
dumped to disk when something goes wrong (a copy of
``mxnet_tpu/observability/recorder.py``).

Metrics tell you THAT the fleet is unhealthy; a trace tells you about one
request you thought to follow. The flight recorder answers the third
question — "what were the last few hundred things this process did
before it fell over?" — without asking anyone to have been profiling at
the time. It is the black-box discipline: recording costs one deque
append (no lock on the hot path beyond the deque's own GIL atomicity,
no allocation beyond the event tuple), so it stays on in production.

Events come from the subsystems that already know their own milestones:
the serving engine (admissions, retires, preemptions, drains, defensive
failures), guard violations (``analysis/guards`` funnels every counted
violation here), checkpoint saves, and — when request tracing is enabled
— every finished span. The ring keeps the most recent ``capacity``
events and silently forgets the rest; nothing ever blocks or grows.

Dump triggers (each writes one JSON file under
``MXNET_FLIGHT_RECORDER_DIR``, default ``<tmp>/mxnet-flightrec``, and
ticks ``mxnet_flight_recorder_dumps_total{reason}``):

- ``engine_exception`` — the serve engine loop crashed unhandled
- ``guard_violation``  — a runtime guard fired in count mode (host sync
  in a no_sync window, recompile after warmup, lock-order cycle)
- ``preemption_storm`` — >= ``storm_threshold`` pool-exhaustion
  preemptions inside ``storm_window`` seconds (the pool is thrashing,
  not just full)
- ``sigterm``          — :func:`install_sigterm` chains the previous
  handler and snapshots state on the way down
- ``peer_lost``        — the elastic detector declared a training peer
  dead (``parallel.elastic``): the last-N-events context around a host
  loss — heartbeat ages, watchdog stalls, the fault itself in drills —
  ships with the declaration
- ``fault_kill``       — a fault-injection plan took THIS worker down
  (``parallel.faultinject``); dumped on the way out so the drill's
  post-mortem sees the victim's final state
- ``numeric_anomaly``  — the health monitor declared a nonfinite count,
  loss spike, or grad explosion (``observability.health``): the dump
  carries the last-W on-device health vectors around the blowup, so the
  post-mortem sees the slope into the cliff, not just the cliff

Dumps are rate-limited per reason (``min_dump_interval``) so a violation
loop cannot turn the recorder into a disk-filling hazard, and every
failure inside the recorder is swallowed with a warning — observability
never takes the workload down.
"""
from __future__ import annotations

import json
import os
import signal
import tempfile
import threading
import time
import warnings
from collections import deque
from typing import Any, Dict, List, Optional

from ..base import get_env

__all__ = ["FlightRecorder", "RECORDER", "record", "dump",
           "install_sigterm", "last_dump", "configure"]


def _default_dir() -> str:
    return get_env("MXNET_FLIGHT_RECORDER_DIR",
                   os.path.join(tempfile.gettempdir(), "mxnet-flightrec"),
                   doc="directory flight-recorder dumps are written to")


class FlightRecorder:
    """Bounded in-memory event ring + triggered JSON dumps."""

    def __init__(self, capacity: int = 2048,
                 min_dump_interval: float = 30.0,
                 storm_window: float = 5.0, storm_threshold: int = 8):
        self.capacity = int(capacity)
        self.min_dump_interval = float(min_dump_interval)
        self.storm_window = float(storm_window)
        self.storm_threshold = int(storm_threshold)
        self._ring: "deque" = deque(maxlen=self.capacity)
        # reentrant: the SIGTERM handler runs dump() on the main thread,
        # which may already hold this lock (record_violation's
        # rate-limit check, the storm calculation) — a plain Lock would
        # deadlock the graceful-shutdown path
        self._lock = threading.RLock()
        self._last_dump_ts: Dict[str, float] = {}
        self._last_dump_path: Optional[str] = None
        self._dumps = 0
        self._preempt_ts: "deque" = deque(maxlen=max(storm_threshold, 8))
        self._sigterm_installed = False

    # ------------------------------------------------------------ recording
    def record(self, kind: str, name: str, **attrs):
        """Append one event. Hot-path cheap: one deque append of a small
        dict; the deque's maxlen does the forgetting."""
        self._ring.append({"t": time.time(), "kind": kind, "name": name,
                           **attrs})

    def record_span(self, name: str, trace_id: str, dur_s: float,
                    status: Optional[str] = None):
        self._ring.append({"t": time.time(), "kind": "span", "name": name,
                           "trace_id": trace_id, "dur_s": dur_s,
                           "status": status})

    def record_preemption(self, **attrs):
        """Record a pool-exhaustion preemption and dump when they storm
        (>= threshold inside the window: the engine is thrashing slots
        through preempt/re-prefill cycles instead of making progress)."""
        now = time.monotonic()
        self.record("event", "preemption", **attrs)
        with self._lock:
            self._preempt_ts.append(now)
            # compare against the threshold-th MOST RECENT stamp, not
            # the oldest retained one: stale entries lingering in the
            # deque must not mask a genuine burst inside the window
            storm = (len(self._preempt_ts) >= self.storm_threshold
                     and now - self._preempt_ts[-self.storm_threshold]
                     <= self.storm_window)
        if storm:
            self.dump("preemption_storm")

    def record_violation(self, guard: str, n: int = 1):
        """Guard-violation funnel (analysis/guards count mode): record
        and dump — a violated invariant in production is exactly the
        moment the last-N-events context is worth a file."""
        self.record("violation", guard, count=n)
        self.dump("guard_violation")

    # ------------------------------------------------------------ dumping
    def snapshot(self) -> List[Dict[str, Any]]:
        return list(self._ring)

    def last_dump(self) -> Optional[str]:
        return self._last_dump_path

    def dump(self, reason: str, force: bool = False,
             path: Optional[str] = None) -> Optional[str]:
        """Write the ring (+ a best-effort metrics snapshot) as one JSON
        file; returns the path, or None when rate-limited or the write
        failed. Never raises."""
        now = time.monotonic()
        with self._lock:
            last = self._last_dump_ts.get(reason, -1e18)
            if not force and now - last < self.min_dump_interval:
                return None
            self._last_dump_ts[reason] = now
        try:
            doc: Dict[str, Any] = {
                "reason": reason,
                "time": time.time(),
                "pid": os.getpid(),
                "events": self.snapshot(),
            }
            try:
                from . import trace as _trace
                doc["dropped_trace_events"] = _trace.dropped_trace_events()
            except Exception:
                pass
            try:
                from .. import metrics as _metrics
                if _metrics.ENABLED:
                    doc["metrics"] = json.loads(_metrics.dumps("json"))
            except Exception:
                pass
            if path is None:
                d = _default_dir()
                os.makedirs(d, exist_ok=True)
                path = os.path.join(
                    d, f"flightrec-{os.getpid()}-{reason}-"
                       f"{int(time.time() * 1000)}.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, path)
            with self._lock:
                self._last_dump_path = path
                self._dumps += 1
            from .. import metrics as _metrics
            if _metrics.ENABLED:
                _metrics.FLIGHT_DUMPS.labels(reason=reason).inc()
            return path
        except Exception as e:  # pragma: no cover - defensive
            warnings.warn(f"flight recorder: dump failed: {e!r}")
            return None

    # ------------------------------------------------------------ signals
    def install_sigterm(self):
        """Dump on SIGTERM, chaining any existing handler. Main-thread
        only (signal module restriction) — a no-op elsewhere, so library
        code may call it unconditionally."""
        if self._sigterm_installed:
            return
        try:
            prev = signal.getsignal(signal.SIGTERM)

            def _on_term(signum, frame):
                self.record("signal", "SIGTERM")
                self.dump("sigterm", force=True)
                if callable(prev):
                    prev(signum, frame)
                elif prev == signal.SIG_DFL or prev is None:
                    # prev None = a non-Python (C-level) handler we
                    # cannot chain: fall back to default termination
                    # rather than swallowing SIGTERM entirely
                    signal.signal(signal.SIGTERM, signal.SIG_DFL)
                    os.kill(os.getpid(), signal.SIGTERM)

            signal.signal(signal.SIGTERM, _on_term)
            self._sigterm_installed = True
        except (ValueError, OSError):   # not the main thread / no signals
            pass

    def reset(self):
        with self._lock:
            self._ring.clear()
            self._preempt_ts.clear()
            self._last_dump_ts.clear()
            self._last_dump_path = None


RECORDER = FlightRecorder()


def record(kind: str, name: str, **attrs):
    RECORDER.record(kind, name, **attrs)


def dump(reason: str, force: bool = False,
         path: Optional[str] = None) -> Optional[str]:
    return RECORDER.dump(reason, force=force, path=path)


def install_sigterm():
    RECORDER.install_sigterm()


def last_dump() -> Optional[str]:
    return RECORDER.last_dump()


def configure(capacity: Optional[int] = None,
              min_dump_interval: Optional[float] = None,
              storm_window: Optional[float] = None,
              storm_threshold: Optional[int] = None):
    """Adjust the process recorder in place (tests tighten the storm
    window; operators widen the ring)."""
    if capacity is not None:
        RECORDER.capacity = int(capacity)
        with RECORDER._lock:
            RECORDER._ring = deque(RECORDER._ring, maxlen=int(capacity))
    if min_dump_interval is not None:
        RECORDER.min_dump_interval = float(min_dump_interval)
    if storm_window is not None:
        RECORDER.storm_window = float(storm_window)
    if storm_threshold is not None:
        RECORDER.storm_threshold = int(storm_threshold)
        with RECORDER._lock:
            RECORDER._preempt_ts = deque(
                RECORDER._preempt_ts, maxlen=max(int(storm_threshold), 8))
