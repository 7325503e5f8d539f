"""The profiler's host event store (counterpart of the first part of
``mxnet_tpu/profiler.py``): a bounded in-memory list of chrome-trace
events that request spans (``observability.trace``) and metric updates
(``metrics``) are bridged onto while the profiler runs, with the
``max_events`` cap whose overflow ``dropped_events`` counts (what
``/healthz`` reports as ``profiler_dropped_events``).

The JAX module's device trace (``jax.profiler``), pausing, scopes, tasks,
counters, markers, trace dumps, aggregate tables and memory stats are not
ported yet (ROADMAP Queue 1 item 8, ``observability/``); on the card
``torch.profiler`` takes the device trace's place.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from .base import MXNetError, get_env

__all__ = ["set_config", "set_state", "record_span", "counter_event",
           "dropped_events", "events"]

_LOCK = threading.Lock()
_CONFIG = {
    # request-trace spans bridged from observability.trace (cat="trace")
    "profile_trace": True,
    # event cap: beyond it the buffer stops growing and the dropped-events
    # count ticks
    "max_events": get_env("MXNET_PROFILER_MAX_EVENTS", 1_000_000,
                          doc="chrome-trace in-memory event cap; events "
                              "beyond it are counted as dropped"),
}
_CATEGORY_GATE = {"trace": "profile_trace"}
# fast-path flag read by the bridges: True only while running
ACTIVE = False
_EVENTS: List[Dict[str, Any]] = []
_START_TS: Optional[float] = None
_DROPPED = 0


def dropped_events() -> int:
    """Events discarded by the ``max_events`` cap over the process
    lifetime (monotone)."""
    return _DROPPED


def _append_locked(ev: Dict[str, Any]) -> bool:
    """Append one event honoring the cap; caller holds _LOCK. Returns
    False when the event was dropped."""
    global _DROPPED
    if len(_EVENTS) >= _CONFIG["max_events"]:
        _DROPPED += 1
        return False
    _EVENTS.append(ev)
    return True


def set_config(**kwargs):
    """Set ``profile_trace`` or ``max_events``."""
    unknown = set(kwargs) - set(_CONFIG)
    if unknown:
        raise MXNetError(f"profiler.set_config: unknown keys {sorted(unknown)}")
    _CONFIG.update(kwargs)


def set_state(state_name: str = "stop", profile_process: str = "worker"):
    """'run' | 'stop'."""
    global _START_TS, ACTIVE
    if state_name == "run":
        ACTIVE = True
        _START_TS = time.perf_counter()
    elif state_name == "stop":
        ACTIVE = False
    else:
        raise MXNetError(f"bad profiler state {state_name!r}")


def record_span(name: str, cat: str, t0: float, t1: float, args=None):
    """Record one completed span (``perf_counter`` seconds) while ACTIVE."""
    if not ACTIVE or _START_TS is None:
        return
    gate = _CATEGORY_GATE.get(cat)
    if gate and not _CONFIG[gate]:
        return
    ev = {"name": name, "cat": cat, "ph": "X",
          "ts": max((t0 - _START_TS) * 1e6, 0.0), "dur": (t1 - t0) * 1e6,
          "pid": 0, "tid": threading.get_ident() % 100000}
    if args:
        ev["args"] = args
    with _LOCK:
        _append_locked(ev)


def counter_event(name: str, value) -> None:
    """Append a chrome-trace 'C' (counter) event while ACTIVE (the metrics
    registry's bridge)."""
    if ACTIVE and _START_TS is not None:
        with _LOCK:
            _append_locked({
                "name": name, "cat": "counter", "ph": "C",
                "ts": max((time.perf_counter() - _START_TS) * 1e6, 0.0),
                "pid": 0, "tid": threading.get_ident() % 100000,
                "args": {"value": value},
            })


def events() -> List[Dict[str, Any]]:
    """A copy of the recorded events."""
    with _LOCK:
        return list(_EVENTS)
