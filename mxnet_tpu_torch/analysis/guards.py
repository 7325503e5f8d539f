"""Runtime lock-order guards (counterpart of the lock half of
``mxnet_tpu/analysis/guards.py``; ``no_sync``, ``no_recompile``,
``AliasSentinel`` and the DMA ledger check wait for the analysis slice).

- :class:`LockOrderWitness` / :func:`make_lock`: named lock wrappers that
  record the per-thread acquisition graph across the threaded subsystems
  (the router, the autoscale controller, the tenant scheduler, the
  spawners); :func:`check_lock_order` fails a test on an inversion or a
  cycle, and acquiring a lock this thread already holds raises at once
  instead of deadlocking.

Debug wiring: ``MXNET_DEBUG_GUARDS=1`` (or :func:`enable_debug`) makes
``make_lock`` return witness locks; the disabled path is a plain
``threading.Lock``. The JAX module also counts a violation in
``mxnet_guard_violations_total``, a family this package does not carry
yet, so here a violation only raises.
"""
from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional, Set, Tuple

from ..base import MXNetError, get_env

__all__ = ["GuardViolation", "LockOrderError", "LockOrderWitness", "WitnessLock",
           "make_lock", "witness", "check_lock_order", "reset_lock_witness",
           "debug_guards_enabled", "enable_debug", "disable_debug", "find_cycles"]


class GuardViolation(MXNetError):
    """Base class for runtime-guard violations."""


class LockOrderError(GuardViolation):
    """Lock acquisition order is cyclic (or a lock was re-acquired)."""


_DEBUG = bool(get_env("MXNET_DEBUG_GUARDS", False, dtype=bool,
                      doc="witness locks: record the lock-acquisition order"))


def debug_guards_enabled() -> bool:
    return _DEBUG


def enable_debug():
    """Turn on debug guards for objects constructed from now on."""
    global _DEBUG
    _DEBUG = True


def disable_debug():
    global _DEBUG
    _DEBUG = False


def find_cycles(pairs: Iterable[Tuple[str, str]]) -> List[List[str]]:
    """Cycles of a directed graph given as (a, b) edge pairs (the JAX
    package's ``analysis.linter.find_cycles``)."""
    graph: Dict[str, Set[str]] = {}
    for a, b in pairs:
        graph.setdefault(a, set()).add(b)
        graph.setdefault(b, set())
    cycles: List[List[str]] = []
    seen: Set[Tuple[str, ...]] = set()
    color: Dict[str, int] = {}
    stack: List[str] = []

    def dfs(u: str):
        color[u] = 1
        stack.append(u)
        for v in graph[u]:
            if color.get(v, 0) == 0:
                dfs(v)
            elif color.get(v) == 1:
                cyc = stack[stack.index(v):] + [v]
                key = tuple(sorted(cyc))
                if key not in seen:
                    seen.add(key)
                    cycles.append(cyc)
        stack.pop()
        color[u] = 2

    for node in list(graph):
        if color.get(node, 0) == 0:
            dfs(node)
    return cycles


class LockOrderWitness:
    """Records the cross-thread lock-acquisition graph. Nodes are lock
    names (role-level: every router's ``_lock`` is one node); an edge a->b
    means some thread acquired b while holding a. A cycle is a potential
    deadlock, and :meth:`check` raises naming the witness sites."""

    def __init__(self):
        self._mu = threading.Lock()          # plain: never witnessed
        self._tls = threading.local()
        self._edges: Dict[Tuple[str, str], str] = {}
        self._nodes: set = set()

    def _held(self) -> List["WitnessLock"]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def note_acquiring(self, lock: "WitnessLock"):
        for h in self._held():
            if h is lock:
                raise LockOrderError(
                    f"thread {threading.current_thread().name!r} re-acquiring "
                    f"non-reentrant lock {lock.name!r} it already holds — this "
                    "would deadlock")

    def note_acquired(self, lock: "WitnessLock"):
        held = self._held()
        tname = threading.current_thread().name
        with self._mu:
            self._nodes.add(lock.name)
            for h in held:
                if h.name != lock.name:
                    self._edges.setdefault(
                        (h.name, lock.name),
                        f"thread {tname!r} acquired {lock.name!r} while holding "
                        f"{h.name!r}")
        held.append(lock)

    def note_released(self, lock: "WitnessLock"):
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is lock:
                del held[i]
                return

    def edges(self) -> Dict[Tuple[str, str], str]:
        with self._mu:
            return dict(self._edges)

    def nodes(self) -> set:
        """Every lock name the witness has seen acquired."""
        with self._mu:
            return set(self._nodes)

    def cycles(self) -> List[List[str]]:
        return find_cycles(self.edges())

    def check(self):
        """Raise :class:`LockOrderError` when the recorded acquisition graph
        contains a cycle."""
        cycles = self.cycles()
        if not cycles:
            return
        edges = self.edges()
        lines = []
        for cyc in cycles:
            lines.append(" -> ".join(cyc))
            for a, b in zip(cyc, cyc[1:]):
                if (a, b) in edges:
                    lines.append(f"  {edges[(a, b)]}")
        raise LockOrderError("cyclic lock acquisition order across threads "
                             "(potential deadlock):\n" + "\n".join(lines))

    def reset(self):
        with self._mu:
            self._edges.clear()
            self._nodes.clear()


class WitnessLock:
    """A named ``threading.Lock`` that reports acquisitions to the process
    witness; also works as the lock behind a ``threading.Condition``."""

    def __init__(self, name: str, witness: Optional[LockOrderWitness] = None):
        self.name = name
        self._lock = threading.Lock()
        self._witness = witness or _WITNESS

    # Condition() probes ownership with acquire(0): keep the full signature
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if blocking:
            self._witness.note_acquiring(self)
        got = self._lock.acquire(blocking, timeout)
        if got:
            self._witness.note_acquired(self)
        return got

    def release(self):
        self._lock.release()
        self._witness.note_released(self)

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()


_WITNESS = LockOrderWitness()


def witness() -> LockOrderWitness:
    """The process-wide lock-order witness."""
    return _WITNESS


def check_lock_order():
    _WITNESS.check()


def reset_lock_witness():
    _WITNESS.reset()


def make_lock(name: str):
    """The threaded subsystems' lock factory: a plain ``threading.Lock``,
    or a :class:`WitnessLock` feeding the witness when debug guards are
    on."""
    if _DEBUG:
        return WitnessLock(name)
    return threading.Lock()
