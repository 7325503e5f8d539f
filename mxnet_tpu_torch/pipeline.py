"""Host-to-device pipelining (counterpart of ``mxnet_tpu/pipeline.py``):
keep the card busy while the host stages the next batch.

:class:`DevicePrefetcher` wraps any batch iterator and stages batch k+1 on
the device on a background thread while step k computes. On the card the
thread copies on a CUDA stream of its own (``torch.cuda.stream(s)``
entered on that thread: the current stream is per thread, and a copy on
the default stream would serialise with the step), so the copies overlap
the consumer's kernels. After each batch's copies it records a
``torch.cuda.Event`` and queues it with the batch; ``__next__`` makes the
consumer's current stream wait on that event and marks every staged
tensor with ``record_stream`` on the consumer's stream, so the caching
allocator does not hand the memory out again while the step still reads
it. Leave either out and the step reads half-copied or reused memory
without an error. Host leaves are copied into page-locked memory first,
so their copies are asynchronous.

``TrainStep`` takes tensors already on its device as they are
(``parallel/train.py``), so batches staged onto
``TrainStep.input_shardings()`` are not copied again. Depth is bounded
(default 2: one in the consumer's hands, one staged).

Placement: a port ``Device``, a torch device or its name, ``None`` (the
device current where the prefetcher is made), or a tuple of these
matching the batch's top-level structure. A mesh or sharding object
raises (ROADMAP Queue 1 item 8).

Telemetry: ``mxnet_input_wait_seconds{path}`` observes how long the
consumer blocked for the next staged batch (near zero: the pipeline keeps
up; large: the step is input-bound) and
``mxnet_pipeline_depth{path=prefetch_*}`` the staged batches ready.

Usage::

    it = loader.as_device_iterator(sharding=step.input_shardings())
    for x, y in it:
        step.step(x, y)            # windowed dispatch, no per-step sync
    step.drain()
"""
from __future__ import annotations

import queue as _queue
import threading
import time
from contextlib import nullcontext
from typing import Iterable

import numpy as onp
import torch

from . import metrics as _metrics
from .analysis import guards as _guards
from .base import MXNetError
from .device import Device, resolve
from .ndarray import NDArray
from .observability import trace as _trace

__all__ = ["DevicePrefetcher", "stage_batch"]

_MESH = ("placement on a mesh or by a sharding is not ported yet (ROADMAP Queue 1 "
         "item 8: kvstore and parallel); pass a device")


def _target(s):
    """A placement as a torch device (``None``: the current device)."""
    if s is None or isinstance(s, (Device, torch.device, str)):
        return resolve(s)
    raise MXNetError(f"{_MESH}, not {type(s).__name__}")


def _targets(sharding):
    """``sharding`` resolved now, in the caller's thread: one torch device,
    or a tuple of them."""
    if isinstance(sharding, (tuple, list)):
        return tuple(_target(s) for s in sharding)
    return _target(sharding)


def _host_tensor(a) -> torch.Tensor:
    a = onp.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(onp.ascontiguousarray(a).view(onp.int16)).view(torch.bfloat16)
    if a.dtype == object:
        raise MXNetError(f"cannot stage a leaf of {type(a).__name__}")
    return torch.from_numpy(onp.ascontiguousarray(a))


def _put(x, dev: torch.device) -> torch.Tensor:
    """One leaf on ``dev``: a tensor already there as it is; host data to
    the card through page-locked memory (an asynchronous copy on the
    current stream), to the CPU as a copy (the producer may reuse its
    buffer)."""
    if torch.is_tensor(x):
        if x.device == dev:
            return x
        if dev.type == "cuda" and x.device.type == "cpu":
            return (x if x.is_pinned() else x.pin_memory()).to(dev, non_blocking=True)
        return x.to(dev)
    t = _host_tensor(x)
    if dev.type == "cpu":
        return t.clone()
    return t.pin_memory().to(dev, non_blocking=True)


def _stage(batch, targets):
    if isinstance(batch, (tuple, list)):
        if isinstance(targets, tuple):
            if len(targets) != len(batch):
                raise MXNetError(f"a placement tuple of {len(targets)} does not match a "
                                 f"batch of {len(batch)}")
            return type(batch)(_stage(b, t) for b, t in zip(batch, targets))
        return type(batch)(_stage(b, targets) for b in batch)
    if isinstance(batch, dict):
        return {k: _stage(v, targets) for k, v in batch.items()}
    if batch is None:
        return None
    if isinstance(targets, tuple):
        raise MXNetError("a placement tuple needs a tuple or list batch")
    if isinstance(batch, NDArray):
        return NDArray._new(_put(batch._data, targets))
    return _put(batch, targets)


def stage_batch(batch, sharding=None):
    """Every array leaf of a batch tree (tuple/list/dict/NDArray/tensor/
    numpy) on the device, structure and NDArray wrappers kept. ``sharding``
    is a device for every leaf, a tuple or list of them matching the
    batch's top level (``(data_device, label_device)`` for ``(x, y)``
    batches), or None for the current device. A leaf already there is
    taken as it is; copies run on the current CUDA stream."""
    return _stage(batch, _targets(sharding))


def _tensors(tree, out):
    if isinstance(tree, (tuple, list)):
        for b in tree:
            _tensors(b, out)
    elif isinstance(tree, dict):
        for v in tree.values():
            _tensors(v, out)
    elif isinstance(tree, NDArray):
        out.append(tree._data)
    elif torch.is_tensor(tree):
        out.append(tree)
    return out


def _numpy_leaves(tree, out):
    if isinstance(tree, (tuple, list)):
        for b in tree:
            _numpy_leaves(b, out)
    elif isinstance(tree, dict):
        for v in tree.values():
            _numpy_leaves(v, out)
    elif isinstance(tree, onp.ndarray):
        out.append(tree)
    return out


class _Seal:
    """Debug-guard write protection of a producer's numpy leaves: sealed
    (``flags.writeable = False``) when staged, released once their copy's
    event has completed and the batch left the window of ``depth + 2``
    staged and in-flight batches. A producer that writes into a buffer it
    handed over inside the window raises ``ValueError`` at the write, which
    the consumer sees at its next ``next()``."""

    def __init__(self, depth: int):
        self._window = depth + 2
        self._held = []
        self._lock = threading.Lock()

    def seal(self, batch, event):
        leaves = [a for a in _numpy_leaves(batch, []) if a.flags.writeable]
        for a in leaves:
            a.flags.writeable = False
        with self._lock:
            self._held.append((leaves, event))
            while len(self._held) > self._window:
                self._release(*self._held.pop(0))

    @staticmethod
    def _release(leaves, event):
        if event is not None:
            event.synchronize()
        for a in leaves:
            a.flags.writeable = True

    def release_all(self):
        with self._lock:
            held, self._held = self._held, []
        for item in held:
            self._release(*item)


_END = object()


class DevicePrefetcher:
    """Bounded-depth background device stager over any batch iterable.

    A daemon thread pulls batches from ``source``, stages them
    (:func:`stage_batch` onto ``sharding``) on its own CUDA stream, and
    parks at most ``depth`` staged batches in a queue. Iteration yields them
    in order; a producer exception is raised at the consumer's next
    ``next()``, after every batch staged before it.

    The prefetcher is itself an iterator (single pass). ``close()`` stops
    the worker early (also called by ``__exit__``; the finalizer sets the
    stop flag); closing mid-iteration drops the staged batches. The worker
    holds no reference to the prefetcher, so one abandoned mid-epoch is
    collected and its thread exits.

    Under ``MXNET_DEBUG_GUARDS=1`` the producer's numpy leaves are
    read-only from their staging until their copy has run and they left
    the window of ``depth + 2`` batches (``close()`` releases all): a
    producer that reuses a buffer it handed over raises ``ValueError``,
    surfaced at the consumer like any producer error.
    """

    def __init__(self, source: Iterable, sharding=None, depth: int = 2, path: str = "train"):
        if depth < 1:
            raise MXNetError(f"DevicePrefetcher depth must be >= 1, got {depth}")
        self._targets = _targets(sharding)
        self._depth = int(depth)
        self._path = path
        self._q: "_queue.Queue" = _queue.Queue(maxsize=self._depth)
        self._stop = threading.Event()
        self._done = False
        cuda = [t for t in (self._targets if isinstance(self._targets, tuple)
                            else (self._targets,)) if t.type == "cuda"]
        self._device = cuda[0] if cuda else None
        self._side = torch.cuda.Stream(device=self._device) if cuda else None
        self._seal = _Seal(self._depth) if _guards.debug_guards_enabled() else None
        self._thread = threading.Thread(
            target=self._worker,
            args=(iter(source), self._q, self._stop, self._targets, self._side, self._seal),
            name="mxnet-device-prefetch", daemon=True)
        self._thread.start()

    @property
    def stream(self):
        """The CUDA stream the staging copies run on (None on the CPU)."""
        return self._side

    # ------------------------------------------------------------- worker
    @staticmethod
    def _worker(it, q, stop, targets, side, seal):
        def bounded_put(item) -> bool:
            # a put that keeps polling the stop flag: an abandoned consumer
            # must not leave the worker blocked forever
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except _queue.Full:
                    continue
            return False

        with torch.cuda.stream(side) if side is not None else nullcontext():
            try:
                for batch in it:
                    if stop.is_set():
                        return
                    staged = _stage(batch, targets)
                    event = None
                    if side is not None:
                        event = torch.cuda.Event()
                        event.record(side)
                    if seal is not None:
                        seal.seal(batch, event)
                    if not bounded_put((staged, event, None)):
                        return
            except BaseException as e:  # noqa: BLE001 - raised at the consumer
                bounded_put((_END, None, e))
                return
            bounded_put((_END, None, None))

    # ----------------------------------------------------------- consumer
    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        t0 = time.perf_counter() if _metrics.ENABLED or _trace.ENABLED else None
        item, event, err = self._q.get()
        if t0 is not None:
            dt = time.perf_counter() - t0
            _metrics.INPUT_WAIT.labels(path=self._path).observe(dt)
            _metrics.PIPELINE_DEPTH.labels(path=f"prefetch_{self._path}").set(self._q.qsize())
            # the wait lands as the next StepTimeline step's input_wait phase
            _trace.note_blocked("input_wait", dt)
        if item is _END:
            self._done = True
            if err is not None:
                raise err
            raise StopIteration
        if event is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(event)
            for t in _tensors(item, []):
                if t.is_cuda:
                    t.record_stream(consumer)
        return item

    # ---------------------------------------------------------- lifecycle
    def close(self):
        """Stop the worker and drop staged batches. Idempotent."""
        self._stop.set()
        self._done = True
        try:
            while True:
                self._q.get_nowait()
        except _queue.Empty:
            pass
        if self._thread.is_alive():
            self._thread.join(timeout=5)
        if self._seal is not None:
            # after the join nothing is sealed any more or in flight
            self._seal.release_all()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self._stop.set()
        except Exception:
            pass
