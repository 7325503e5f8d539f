"""DataLoader (counterpart of ``mxnet_tpu/gluon/data/dataloader.py``; the
reference's python/mxnet/gluon/data/dataloader.py:514).

Batches are NDArrays on the device that was current where iteration
started (``iter(loader)`` or ``as_device_iterator``): the card unless the
caller asks for the CPU, whichever thread assembles them. Three ways to
make them, all in the sampler's order:

- ``num_workers=0``: in the consumer's thread.
- ``thread_pool=True`` with ``num_workers > 0``: a ``ThreadPoolExecutor``
  of ``num_workers`` threads, ``prefetch`` batches ahead (the JAX
  package's fallback path; its native dependency engine is not ported,
  ROADMAP Queue 1 item 8).
- ``thread_pool=False`` with ``num_workers > 0``: forked worker processes
  that assemble numpy batches (``default_mp_batchify_fn``) and hand each
  over in one POSIX shared-memory segment of the standard library; the
  parent maps it, uploads every leaf and unlinks the segment once.

Forked workers must not touch CUDA: the parent has initialised it before
the fork, and a CUDA call in the child fails ("Cannot re-initialize CUDA
in forked subprocess"). That failure is not caught: it reaches the
consumer as ``MXNetError`` with the worker's traceback. Datasets, host
transforms and batchify functions of the process path therefore work on
numpy; torch's CPU thread pool is set to one thread in each worker. The
workers never run Python's cyclic collector over what they inherit (the
parent forks under ``gc.freeze()``): freeing an inherited CUDA tensor
would call CUDA in the child.

``pin_memory=True`` (process path) stages each leaf through page-locked
memory from torch's caching host allocator and copies it to the card with
``non_blocking=True``. The allocator keeps a pinned block out of reuse
until the copy that reads it has run, so no pool of our own is kept. When
batches land on the CPU, pinning does nothing.
"""
from __future__ import annotations

import gc
import os
import pickle
import queue
import time
import traceback
from typing import Callable, List, Optional

import numpy as onp
import torch

from ... import metrics as _metrics
from ... import profiler as _profiler
from ...base import MXNetError
from ...device import Device, current_device
from ...ndarray import NDArray
from ...pipeline import DevicePrefetcher, _host_tensor, _put
from .dataset import Dataset
from .sampler import BatchSampler, RandomSampler, Sampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn", "default_mp_batchify_fn"]


def default_batchify_fn(data: List):
    """Stack samples into a batch on the current device (reference
    default_batchify_fn)."""
    first = data[0]
    if isinstance(first, NDArray):
        return NDArray._new(torch.stack([d._data for d in data]))
    if isinstance(first, (tuple, list)):
        return tuple(default_batchify_fn(list(items)) for items in zip(*data))
    return NDArray(onp.asarray(data))


def _host_numpy(sample):
    """Worker-side leaf conversion: everything becomes host numpy."""
    if isinstance(sample, NDArray):
        return sample.asnumpy()
    return onp.asarray(sample)


def default_mp_batchify_fn(data: List):
    """Stack samples into numpy batches (worker-process side; the reference
    builds the batch in shared memory, here the copy into the segment
    happens once, after assembly)."""
    first = data[0]
    if isinstance(first, (tuple, list)):
        return tuple(default_mp_batchify_fn(list(items)) for items in zip(*data))
    return onp.stack([_host_numpy(d) for d in data])


# ------------------------------------------------------- shm batch wire ----
# A batch is a tree of numpy arrays. The wire format is one segment: leaves
# packed back to back (64-byte aligned), plus a pickled skeleton where each
# leaf is (offset, shape, dtype-str). The segment's name is the rendezvous
# key (the JAX package's wire, stdlib shared memory only).

_ALIGN = 64


class _Leaf:
    __slots__ = ("i",)

    def __init__(self, i):
        self.i = i


def _flatten_batch(batch, leaves):
    if isinstance(batch, (tuple, list)):
        return type(batch)(_flatten_batch(b, leaves) for b in batch)
    if isinstance(batch, dict):
        return {k: _flatten_batch(v, leaves) for k, v in sorted(batch.items())}
    leaves.append(onp.ascontiguousarray(_host_numpy(batch)))
    return _Leaf(len(leaves) - 1)


def _unflatten_batch(skel, leaves):
    if isinstance(skel, _Leaf):
        return leaves[skel.i]
    if isinstance(skel, (tuple, list)):
        return type(skel)(_unflatten_batch(s, leaves) for s in skel)
    if isinstance(skel, dict):
        return {k: _unflatten_batch(v, leaves) for k, v in skel.items()}
    return skel


def _shm(name: str, nbytes: int = 0, create: bool = False):
    from multiprocessing import shared_memory
    return shared_memory.SharedMemory(name=name.lstrip("/"), create=create, size=nbytes)


def _unlink(name: str):
    """Unlink a segment a worker made and nobody consumed."""
    try:
        seg = _shm(name)
    except FileNotFoundError:
        return
    seg.close()
    seg.unlink()


def _write_batch_shm(batch, name):
    """Pack a batch tree into a fresh segment; returns (nbytes, header). The
    worker leaves the segment to the parent: it closes its mapping and
    drops the name from its resource tracker, so the parent's one unlink
    is the only one."""
    from multiprocessing import resource_tracker
    leaves: List[onp.ndarray] = []
    skel = _flatten_batch(batch, leaves)
    offsets, pos = [], 0
    for arr in leaves:
        pos = (pos + _ALIGN - 1) // _ALIGN * _ALIGN
        offsets.append(pos)
        pos += arr.nbytes
    nbytes = max(pos, 1)
    seg = _shm(name, nbytes, create=True)
    mv = seg.buf.cast("B")
    for arr, off in zip(leaves, offsets):
        mv[off:off + arr.nbytes] = arr.reshape(-1).view(onp.uint8).data
    mv.release()
    seg.close()
    resource_tracker.unregister(seg._name, "shared_memory")
    header = pickle.dumps((skel, [(off, a.shape, a.dtype.str) for a, off in zip(leaves, offsets)]))
    return nbytes, header


def _read_batch_shm(name, header, device, pin_memory):
    """Map a segment, rebuild the tree with NDArray leaves on ``device``,
    unlink the segment."""
    skel, leaf_meta = pickle.loads(header)
    seg = _shm(name)
    try:
        mv = seg.buf.cast("B")
        leaves = []
        for off, shape, dtype in leaf_meta:
            n = int(onp.prod(shape)) if shape else 1
            view = onp.frombuffer(mv, dtype=onp.dtype(dtype), count=n, offset=off).reshape(shape)
            leaves.append(NDArray._new(_upload(view, device, pin_memory)))
            del view
        mv.release()
    finally:
        seg.close()
        seg.unlink()
    return _unflatten_batch(skel, leaves)


def _upload(view: onp.ndarray, device: torch.device, pin_memory: bool) -> torch.Tensor:
    """One shared-memory leaf on ``device``, copied out of the segment
    before this returns, so the parent may unlink it: to the card through
    page-locked memory with ``non_blocking=True`` (``pin_memory``) or from
    the segment itself; to the CPU by a copy (pinning does nothing
    there)."""
    if pin_memory or device.type == "cpu":
        return _put(view, device)
    return _host_tensor(view).to(device)


def _worker_loop(dataset, task_q, result_q, batchify_fn):
    """Worker-process main (reference dataloader.py worker_loop): pull index
    lists, assemble numpy batches, publish each through one segment."""
    torch.set_num_threads(1)
    pid = os.getpid()
    while True:
        task = task_q.get()
        if task is None:
            break
        seq, indices = task
        name = f"/mxtorch_{pid}_{seq}"
        try:
            batch = batchify_fn([dataset[i] for i in indices])
            nbytes, header = _write_batch_shm(batch, name)
            result_q.put((seq, name, nbytes, header, None))
        except BaseException:
            try:
                _unlink(name)      # the segment may exist half-written
            except Exception:
                pass
            result_q.put((seq, None, 0, None, traceback.format_exc()))


class DataLoader:
    def __init__(self, dataset: Dataset, batch_size: Optional[int] = None,
                 shuffle: bool = False, sampler: Optional[Sampler] = None,
                 last_batch: Optional[str] = None,
                 batch_sampler: Optional[BatchSampler] = None,
                 batchify_fn: Optional[Callable] = None,
                 num_workers: int = 0, pin_memory: bool = False,
                 prefetch: Optional[int] = None, thread_pool: bool = True,
                 timeout: int = 120, try_nopython=None,
                 device_prefetch: int = 0, device_sharding=None,
                 device_prefetch_path: str = "train"):
        """The JAX package's signature. ``try_nopython`` is accepted and
        unused, as there. ``device_prefetch=N`` wraps every ``__iter__`` in
        a :class:`~mxnet_tpu_torch.pipeline.DevicePrefetcher` of depth N
        onto ``device_sharding``, its telemetry labelled
        ``device_prefetch_path``."""
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise MXNetError("must specify batch_size or batch_sampler")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle \
                    else SequentialSampler(len(dataset))
            elif shuffle:
                raise MXNetError("shuffle must be False with explicit sampler")
            batch_sampler = BatchSampler(sampler, batch_size, last_batch or "keep")
        elif batch_size is not None or shuffle or sampler is not None or last_batch:
            raise MXNetError("batch_sampler is mutually exclusive with "
                             "batch_size/shuffle/sampler/last_batch")
        self._batch_sampler = batch_sampler
        self._num_workers = max(0, num_workers)
        self._thread_pool = thread_pool
        self._pin_memory = pin_memory
        if batchify_fn is None:
            batchify_fn = (default_mp_batchify_fn
                           if self._num_workers > 0 and not thread_pool
                           else default_batchify_fn)
        self._batchify_fn = batchify_fn
        self._prefetch = max(0, prefetch if prefetch is not None else 2 * self._num_workers)
        self._timeout = timeout
        self._device_prefetch = int(device_prefetch or 0)
        self._device_sharding = device_sharding
        self._device_prefetch_path = device_prefetch_path

    def __len__(self):
        return len(self._batch_sampler)

    def as_device_iterator(self, sharding=None, depth: int = 2, path: str = "train"):
        """Iterate batches pre-staged on the device: a background thread
        copies batch k+1 onto ``sharding`` (a device, or a tuple of them
        matching the batch, e.g. ``TrainStep.input_shardings()``) on its
        own CUDA stream while the consumer computes on batch k. Returns a
        single-pass :class:`~mxnet_tpu_torch.pipeline.DevicePrefetcher`
        (also a context manager)."""
        return DevicePrefetcher(self._iter_batches(current_device()), sharding=sharding,
                                depth=depth, path=path)

    def _make_batch(self, indices, device: Device):
        t0 = time.perf_counter() if (_metrics.ENABLED or _profiler.ACTIVE) else None
        with device:
            batch = self._batchify_fn([self._dataset[i] for i in indices])
        if t0 is not None:
            t1 = time.perf_counter()
            _profiler.record_span("DataLoader::batch", "data", t0, t1)
            if _metrics.ENABLED:
                _metrics.DATA_BATCH_LATENCY.observe(t1 - t0)
                _metrics.DATA_BATCHES.inc()
        return batch

    def __iter__(self):
        if self._device_prefetch:
            return self.as_device_iterator(sharding=self._device_sharding,
                                           depth=self._device_prefetch,
                                           path=self._device_prefetch_path)
        return self._iter_batches(current_device())

    def _iter_batches(self, device: Device):
        """The batches on ``device`` (the device current where iteration
        was asked for; a generator runs in whichever thread consumes it)."""
        if self._num_workers == 0:
            for indices in self._batch_sampler:
                yield self._make_batch(indices, device)
            return
        if self._thread_pool:
            yield from self._threadpool_iter(device)
        else:
            yield from self._process_iter(device)

    def _process_iter(self, device: Device):
        """Forked worker processes and the shared-memory wire (reference
        dataloader.py:187 _MultiWorkerIter over worker_loop processes)."""
        import multiprocessing as mp

        ctx = mp.get_context("fork")
        task_q, result_q = ctx.Queue(), ctx.Queue()
        target = device.torch_device
        workers = [ctx.Process(target=_worker_loop,
                               args=(self._dataset, task_q, result_q, self._batchify_fn),
                               daemon=True)
                   for _ in range(self._num_workers)]
        # the children must never collect what they inherit: cyclic garbage
        # holding a CUDA tensor, freed in a child, would call CUDA there and
        # abort it. Frozen at the fork, the inherited objects sit in the
        # children's permanent generation; the parent unfreezes its own.
        gc.freeze()
        try:
            for w in workers:
                w.start()
        finally:
            gc.unfreeze()
        batches = list(self._batch_sampler)
        depth = max(self._prefetch, self._num_workers)
        received = {}
        next_seq = 0
        try:
            sent = min(depth, len(batches))
            for seq in range(sent):
                task_q.put((seq, batches[seq]))
            while next_seq < len(batches):
                t_wait = time.perf_counter() if _metrics.ENABLED else None
                while next_seq not in received:
                    try:
                        seq, name, _, header, err = result_q.get(timeout=self._timeout)
                    except queue.Empty:
                        raise MXNetError(f"DataLoader worker timed out after {self._timeout}s "
                                         f"waiting for batch {next_seq}") from None
                    received[seq] = (name, header, err)
                if t_wait is not None:
                    _metrics.DATA_QUEUE_WAIT.observe(time.perf_counter() - t_wait)
                if sent < len(batches):
                    task_q.put((sent, batches[sent]))
                    sent += 1
                name, header, err = received.pop(next_seq)
                if err is not None:
                    # in order: the batches before the failing one first
                    raise MXNetError(f"DataLoader worker failed:\n{err}")
                t_b = time.perf_counter() if (_metrics.ENABLED or _profiler.ACTIVE) else None
                batch = _read_batch_shm(name, header, target, self._pin_memory)
                if t_b is not None:
                    # assembly runs in another process (its registry is not
                    # this one): this observes the parent's share, the map
                    # and the upload, and keeps batches_total right
                    t1 = time.perf_counter()
                    _profiler.record_span("DataLoader::shm_batch", "data", t_b, t1)
                    if _metrics.ENABLED:
                        _metrics.DATA_BATCH_LATENCY.observe(t1 - t_b)
                        _metrics.DATA_BATCHES.inc()
                yield batch
                next_seq += 1
        finally:
            for name, _, _ in received.values():
                if name:
                    _unlink(name)
            for _ in workers:
                task_q.put(None)
            for w in workers:
                w.join(timeout=5)
                if w.is_alive():
                    w.terminate()
                    w.join(timeout=5)
            # early exit or error: segments of batches still in flight were
            # made but never consumed
            try:
                while True:
                    _, name, _, _, _ = result_q.get(timeout=0.05)
                    if name:
                        _unlink(name)
            except queue.Empty:
                pass
            task_q.close()
            result_q.close()

    def _threadpool_iter(self, device: Device):
        """Ordered prefetching worker threads."""
        from concurrent.futures import ThreadPoolExecutor

        batches = list(self._batch_sampler)
        with ThreadPoolExecutor(max_workers=self._num_workers) as pool:
            depth = max(self._prefetch, 1)
            futures: "queue.Queue" = queue.Queue()
            it = iter(batches)

            def submit_next():
                try:
                    idx = next(it)
                except StopIteration:
                    return False
                futures.put(pool.submit(self._make_batch, idx, device))
                return True

            for _ in range(depth):
                if not submit_next():
                    break
            while not futures.empty():
                fut = futures.get()
                submit_next()
                t_wait = time.perf_counter() if _metrics.ENABLED else None
                batch = fut.result(timeout=self._timeout)
                if t_wait is not None:
                    _metrics.DATA_QUEUE_WAIT.observe(time.perf_counter() - t_wait)
                yield batch
