"""Request tracing and the flight recorder (counterpart of
``mxnet_tpu/observability``, its ``trace`` and ``recorder`` modules).

- :mod:`~mxnet_tpu_torch.observability.trace`: spans with W3C
  ``traceparent`` propagation (HTTP frontend -> engine -> prefill and
  decode), the bounded trace store behind ``/trace/{id}``, and
  :class:`~mxnet_tpu_torch.observability.trace.StepTimeline`.
- :mod:`~mxnet_tpu_torch.observability.recorder`: the always-on ring of
  recent events, dumped to disk on an engine crash, a preemption storm or
  SIGTERM.

- :mod:`~mxnet_tpu_torch.observability.aggregate`: the fleet's metric
  merge across replicas, its Prometheus rendering and the SLO tracker.

The health monitor and the cost ledger wait for their slices (ROADMAP
Queue 1 item 8).
"""
from . import aggregate, recorder, trace
from .recorder import RECORDER, FlightRecorder
from .trace import (NOOP, STORE, Span, StepTimeline, TraceContext,
                    TraceStore, parse_traceparent, start_span)

__all__ = [
    "trace", "recorder", "aggregate",
    "Span", "TraceContext", "TraceStore", "STORE", "NOOP",
    "StepTimeline",
    "parse_traceparent", "start_span",
    "FlightRecorder", "RECORDER",
]
