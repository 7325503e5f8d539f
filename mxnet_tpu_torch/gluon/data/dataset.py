"""Datasets (counterpart of ``mxnet_tpu/gluon/data/dataset.py``; the
reference's python/mxnet/gluon/data/dataset.py)."""
from __future__ import annotations

from typing import Callable, Sequence

from ...base import MXNetError

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset",
           "RecordFileDataset"]


class Dataset:
    """Abstract dataset: __getitem__ + __len__ (reference data.Dataset)."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def transform(self, fn: Callable, lazy: bool = True) -> "Dataset":
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn: Callable, lazy: bool = True) -> "Dataset":
        return self.transform(_TransformFirstClosure(fn), lazy)

    def filter(self, fn: Callable) -> "Dataset":
        return SimpleDataset([s for s in (self[i] for i in range(len(self)))
                              if fn(s)])

    def take(self, count: int) -> "Dataset":
        return SimpleDataset([self[i] for i in range(min(count, len(self)))])

    def sample(self, sampler) -> "Dataset":
        return _SampledDataset(self, list(sampler))

    def shard(self, num_shards: int, index: int) -> "Dataset":
        """Contiguous shard for multi-process data parallel (reference
        dataset.shard); all shards have equal size (truncating remainder to
        keep per-step batch shapes static, as the JAX package does)."""
        if not 0 <= index < num_shards:
            raise MXNetError(f"shard index {index} out of range [0,{num_shards})")
        per = len(self) // num_shards
        start = per * index
        return _SampledDataset(self, list(range(start, start + per)))


class _TransformFirstClosure:
    def __init__(self, fn):
        self._fn = fn

    def __call__(self, x, *args):
        if args:
            return (self._fn(x),) + args
        return self._fn(x)


class SimpleDataset(Dataset):
    def __init__(self, data: Sequence):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class _LazyTransformDataset(Dataset):
    def __init__(self, data: Dataset, fn: Callable):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class _SampledDataset(Dataset):
    def __init__(self, data: Dataset, indices):
        self._data = data
        self._indices = indices

    def __len__(self):
        return len(self._indices)

    def __getitem__(self, idx):
        return self._data[self._indices[idx]]


class ArrayDataset(Dataset):
    """Zip of arrays/lists (reference data.ArrayDataset)."""

    def __init__(self, *args):
        if not args:
            raise MXNetError("ArrayDataset needs at least one array")
        self._length = len(args[0])
        for i, a in enumerate(args):
            if len(a) != self._length:
                raise MXNetError(f"ArrayDataset: arg {i} has length {len(a)}, "
                                 f"expected {self._length}")
        self._data = args

    def __len__(self):
        return self._length

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(d[idx] for d in self._data)


class RecordFileDataset(Dataset):
    """Random access over a RecordIO file via its .idx
    (reference gluon/data/dataset.py RecordFileDataset). Items are the raw
    record bytes; compose with ``.transform`` to decode.

    Fork-safe: the file is reopened per process (seek/read on a shared
    file description would race across DataLoader workers — reference
    MXRecordIO._check_pid semantics)."""

    def __init__(self, filename: str):
        import os
        self._filename = filename
        self._idx_path = filename[:-4] + ".idx" if filename.endswith(".rec") \
            else filename + ".idx"
        self._record = None
        self._pid = -1
        self._keys = sorted(self._reader().keys)

    def _reader(self):
        import os
        if self._record is None or self._pid != os.getpid():
            from ...io.recordio import MXIndexedRecordIO
            self._record = MXIndexedRecordIO(self._idx_path, self._filename,
                                             "r")
            self._pid = os.getpid()
        return self._record

    def __len__(self):
        return len(self._keys)

    def __getitem__(self, idx):
        return self._reader().read_idx(self._keys[idx])
