"""Samplers (counterpart of ``mxnet_tpu/gluon/data/sampler.py``; the
reference's python/mxnet/gluon/data/sampler.py). ``RandomSampler`` draws
from numpy's global RNG, so one ``numpy.random.seed`` gives both packages
the same order."""
from __future__ import annotations

import numpy as onp

from ...base import MXNetError

__all__ = ["Sampler", "SequentialSampler", "RandomSampler", "BatchSampler",
           "FilterSampler", "IntervalSampler"]


class Sampler:
    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class SequentialSampler(Sampler):
    def __init__(self, length: int, start: int = 0):
        self._length = length
        self._start = start

    def __iter__(self):
        return iter(range(self._start, self._start + self._length))

    def __len__(self):
        return self._length


class RandomSampler(Sampler):
    def __init__(self, length: int):
        self._length = length

    def __iter__(self):
        indices = onp.random.permutation(self._length)
        return iter(indices.tolist())

    def __len__(self):
        return self._length


class FilterSampler(Sampler):
    def __init__(self, fn, dataset):
        self._indices = [i for i in range(len(dataset)) if fn(dataset[i])]

    def __iter__(self):
        return iter(self._indices)

    def __len__(self):
        return len(self._indices)


class IntervalSampler(Sampler):
    def __init__(self, length: int, interval: int, rollover: bool = True):
        self._length = length
        self._interval = interval
        self._rollover = rollover

    def __iter__(self):
        for start in (range(self._interval) if self._rollover else [0]):
            yield from range(start, self._length, self._interval)

    def __len__(self):
        return self._length


class BatchSampler(Sampler):
    """Wrap a sampler into batches (reference BatchSampler);
    last_batch in {'keep','discard','rollover'}."""

    def __init__(self, sampler: Sampler, batch_size: int, last_batch: str = "keep"):
        if last_batch not in ("keep", "discard", "rollover"):
            raise MXNetError(f"bad last_batch {last_batch}")
        self._sampler = sampler
        self._batch_size = batch_size
        self._last_batch = last_batch
        self._prev = []

    def __iter__(self):
        batch, self._prev = self._prev, []
        for i in self._sampler:
            batch.append(i)
            if len(batch) == self._batch_size:
                yield batch
                batch = []
        if batch:
            if self._last_batch == "keep":
                yield batch
            elif self._last_batch == "rollover":
                self._prev = batch

    def __len__(self):
        n = len(self._sampler) + len(self._prev)
        if self._last_batch == "keep":
            return (n + self._batch_size - 1) // self._batch_size
        return n // self._batch_size
