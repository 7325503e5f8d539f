"""The execution engine's control surface (counterpart of
``mxnet_tpu/engine.py``).

PyTorch already queues CUDA work asynchronously, in stream order, so no
dependency scheduler stands in the way of an op. What stays is what users
set:

- the engine type: 'ThreadedEngine' (the default: ops return once queued)
  or 'NaiveEngine', the synchronous debugging double: every op of the
  funnel (``ndarray.apply_multi``) waits for the card's current stream
  before it returns, so a fault surfaces at the op that caused it;
- the ``bulk`` scope and ``set_bulk_size``, a hint kept for scripts.

The type is per thread, starting from ``MXNET_ENGINE_TYPE``.
"""
from __future__ import annotations

import contextlib
import threading

from . import _tape
from .base import MXNetError, get_env

__all__ = ["set_engine_type", "engine_type", "is_naive", "bulk", "set_bulk_size"]

_STATE = threading.local()
_TYPES = ("ThreadedEngine", "ThreadedEnginePerDevice", "NaiveEngine")


def _default_type() -> str:
    return get_env("MXNET_ENGINE_TYPE", "ThreadedEngine",
                   doc="Engine type: ThreadedEngine (async) or NaiveEngine (synchronous "
                       "debugging double)")


def engine_type() -> str:
    return getattr(_STATE, "engine_type", None) or _default_type()


def set_engine_type(name: str) -> None:
    if name not in _TYPES:
        raise MXNetError(f"unknown engine type {name!r}")
    _STATE.engine_type = name
    _tape.STATE.sync_execution = name == "NaiveEngine"


def is_naive() -> bool:
    return engine_type() == "NaiveEngine"


_bulk_size = int(get_env("MXNET_EXEC_BULK_EXEC_MAX_NODE_TRAIN", 15,
                         doc="op-bulking window (a hint: eager ops are queued one by one)"))


def set_bulk_size(size: int) -> int:
    global _bulk_size
    prev = _bulk_size
    _bulk_size = size
    return prev


@contextlib.contextmanager
def bulk(size: int):
    """Set the bulk size for the scope."""
    prev = set_bulk_size(size)
    try:
        yield
    finally:
        set_bulk_size(prev)
