"""``mx.io``: the legacy DataIter API and its iterators (counterpart of
``mxnet_tpu/io/__init__.py``; the reference's python/mxnet/io/io.py,
DataIter:179, NDArrayIter:490, and the C++ iterators of src/io/).

``MNISTIter``, ``CSVIter``, ``LibSVMIter`` (rows densified, as in the JAX
package) and ``ImageRecordIter`` read local files on the host; batches are
NDArrays on the current device (for ``PrefetchingIter``, the device
current where it was made or last reset). ``PrefetchingIter`` keeps
``prefetch`` host batches ready on a background thread (the reference
PrefetcherIter's role, src/io/iter_prefetcher.h:46); to stage batches on
the card ahead of the step use ``pipeline.DevicePrefetcher``.
"""
from __future__ import annotations

import gzip
import os
import struct
import threading
import queue as _queue
from collections import namedtuple
from typing import List, Optional

import numpy as onp

from ..base import MXNetError
from ..device import current_device
from ..ndarray import NDArray
from . import recordio
from .recordio import (MXRecordIO, MXIndexedRecordIO, IRHeader, pack, unpack,
                       pack_img, unpack_img)

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "MNISTIter",
           "CSVIter", "LibSVMIter", "ImageRecordIter", "PrefetchingIter",
           "ResizeIter", "recordio"]


class DataDesc(namedtuple("DataDesc", ["name", "shape", "dtype", "layout"])):
    def __new__(cls, name, shape, dtype=onp.float32, layout="NCHW"):
        return super().__new__(cls, name, tuple(shape), dtype, layout)


class DataBatch:
    """One batch (reference io.DataBatch)."""

    def __init__(self, data: List[NDArray], label: Optional[List[NDArray]] = None,
                 pad: int = 0, index=None, provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        shapes = [d.shape for d in self.data]
        return f"DataBatch: data shapes {shapes} pad {self.pad}"


class DataIter:
    """Abstract iterator (reference io.py:179)."""

    def __init__(self, batch_size: int = 0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self) -> DataBatch:
        if self.iter_next():
            return DataBatch(self.getdata(), self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self) -> bool:
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        return 0


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays (reference io.py:490). Supports dict or
    single array data/label, shuffle, last_batch_handle pad/discard/roll_over."""

    def __init__(self, data, label=None, batch_size: int = 1, shuffle: bool = False,
                 last_batch_handle: str = "pad", data_name: str = "data",
                 label_name: str = "softmax_label"):
        super().__init__(batch_size)
        self.data = self._init_data(data, data_name)
        self.label = self._init_data(label, label_name) if label is not None else []
        self.num_data = self.data[0][1].shape[0] if self.data else 0
        if last_batch_handle not in ("pad", "discard", "roll_over"):
            raise MXNetError(f"bad last_batch_handle {last_batch_handle}")
        self.last_batch_handle = last_batch_handle
        self.shuffle = shuffle
        self.cursor = -batch_size
        self._order = onp.arange(self.num_data)
        if shuffle:
            onp.random.shuffle(self._order)

    @staticmethod
    def _init_data(data, default_name):
        if data is None:
            return []
        if isinstance(data, (onp.ndarray, NDArray)):
            data = {default_name: data}
        elif isinstance(data, (list, tuple)):
            data = {f"{default_name}_{i}" if i else default_name: d
                    for i, d in enumerate(data)}
        out = []
        for k, v in data.items():
            arr = v.asnumpy() if isinstance(v, NDArray) else onp.asarray(v)
            out.append((k, arr))
        return out

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def reset(self):
        if self.shuffle:
            onp.random.shuffle(self._order)
        if self.last_batch_handle == "roll_over" and \
                0 < self.cursor < self.num_data:
            self.cursor = self.cursor - self.num_data - self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self) -> bool:
        self.cursor += self.batch_size
        if self.last_batch_handle == "discard":
            return self.cursor + self.batch_size <= self.num_data
        return self.cursor < self.num_data

    def _slice(self, arrays):
        out = []
        for _, arr in arrays:
            start = max(self.cursor, 0)
            end = self.cursor + self.batch_size
            idx = self._order[start:end]
            part = arr[idx]
            if len(part) < self.batch_size:  # pad wraps around
                extra = self._order[:self.batch_size - len(part)]
                part = onp.concatenate([part, arr[extra]])
            out.append(NDArray(part))
        return out

    def getdata(self):
        return self._slice(self.data)

    def getlabel(self):
        return self._slice(self.label)

    def getpad(self) -> int:
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0


class MNISTIter(NDArrayIter):
    """idx-ubyte MNIST iterator (reference src/io/iter_mnist.cc:257)."""

    def __init__(self, image: str, label: str, batch_size: int = 128,
                 shuffle: bool = True, flat: bool = False, seed: int = 0,
                 **kwargs):
        from ..gluon.data.vision.datasets import _read_idx
        images = _read_idx(image).astype(onp.float32) / 255.0
        labels = _read_idx(label).astype(onp.float32)
        if flat:
            images = images.reshape(len(images), -1)
        else:
            images = images.reshape(len(images), 1, images.shape[1], images.shape[2])
        onp.random.seed(seed)
        super().__init__(images, labels, batch_size, shuffle,
                         last_batch_handle="discard")


class CSVIter(DataIter):
    """CSV iterator (reference src/io/iter_csv.cc)."""

    def __init__(self, data_csv: str, data_shape, label_csv: Optional[str] = None,
                 label_shape=(1,), batch_size: int = 128, round_batch: bool = True,
                 **kwargs):
        super().__init__(batch_size)
        data = onp.loadtxt(data_csv, delimiter=",", dtype=onp.float32, ndmin=2)
        self._data = data.reshape((-1,) + tuple(data_shape))
        if label_csv is not None:
            label = onp.loadtxt(label_csv, delimiter=",", dtype=onp.float32,
                                ndmin=2)
            self._label = label.reshape((-1,) + tuple(label_shape))
        else:
            self._label = onp.zeros((len(self._data), 1), dtype=onp.float32)
        self._inner = NDArrayIter(self._data, self._label, batch_size,
                                  last_batch_handle="pad" if round_batch else "discard")

    def reset(self):
        self._inner.reset()

    def iter_next(self):
        return self._inner.iter_next()

    def getdata(self):
        return self._inner.getdata()

    def getlabel(self):
        return self._inner.getlabel()

    def getpad(self):
        return self._inner.getpad()


class LibSVMIter(DataIter):
    """LibSVM sparse text format iterator (reference src/io/iter_libsvm.cc).
    Rows densify on load, as in the JAX package (arrays are dense)."""

    def __init__(self, data_libsvm: str, data_shape, label_shape=(1,),
                 batch_size: int = 128, **kwargs):
        super().__init__(batch_size)
        n_features = int(onp.prod(data_shape))
        rows, labels = [], []
        with open(data_libsvm) as f:
            for line in f:
                parts = line.strip().split()
                if not parts:
                    continue
                labels.append(float(parts[0]))
                row = onp.zeros(n_features, dtype=onp.float32)
                for kv in parts[1:]:
                    k, v = kv.split(":")
                    row[int(k)] = float(v)
                rows.append(row)
        data = onp.stack(rows).reshape((-1,) + tuple(data_shape))
        self._inner = NDArrayIter(data, onp.asarray(labels, dtype=onp.float32),
                                  batch_size, last_batch_handle="pad")

    def reset(self):
        self._inner.reset()

    def iter_next(self):
        return self._inner.iter_next()

    def getdata(self):
        return self._inner.getdata()

    def getlabel(self):
        return self._inner.getlabel()

    def getpad(self):
        return self._inner.getpad()


class ImageRecordIter(DataIter):
    """RecordIO-packed image iterator
    (reference src/io/iter_image_recordio_2.cc)."""

    def __init__(self, path_imgrec: str, data_shape, batch_size: int = 128,
                 path_imgidx: Optional[str] = None, shuffle: bool = False,
                 mean_r: float = 0, mean_g: float = 0, mean_b: float = 0,
                 scale: float = 1.0, **kwargs):
        super().__init__(batch_size)
        idx_path = path_imgidx or os.path.splitext(path_imgrec)[0] + ".idx"
        self._rec = MXIndexedRecordIO(idx_path, path_imgrec, "r")
        self._shape = tuple(data_shape)
        self._shuffle = shuffle
        self._mean = onp.array([mean_r, mean_g, mean_b], dtype=onp.float32)
        self._scale = scale
        self._order = list(self._rec.keys)
        self._pos = 0

    def reset(self):
        self._pos = 0
        if self._shuffle:
            onp.random.shuffle(self._order)

    def iter_next(self):
        return self._pos + self.batch_size <= len(self._order)

    def next(self):
        if not self.iter_next():
            raise StopIteration
        imgs, labels = [], []
        for key in self._order[self._pos:self._pos + self.batch_size]:
            header, img = unpack_img(self._rec.read_idx(key))
            img = onp.asarray(img, dtype=onp.float32)
            if img.ndim == 2:
                img = img[:, :, None]
            img = (img - self._mean[:img.shape[2]]) * self._scale
            imgs.append(img.transpose(2, 0, 1))
            lbl = header.label
            labels.append(float(lbl if onp.isscalar(lbl) else onp.ravel(lbl)[0]))
        self._pos += self.batch_size
        return DataBatch([NDArray(onp.stack(imgs))],
                         [NDArray(onp.asarray(labels, dtype=onp.float32))])


class PrefetchingIter(DataIter):
    """Double-buffering wrapper (reference iter_prefetcher.h:46 +
    python io.PrefetchingIter): a background thread keeps ``prefetch``
    batches ready so host batch assembly overlaps device compute."""

    def __init__(self, iters, rename_data=None, rename_label=None,
                 prefetch: int = 2):
        if not isinstance(iters, (list, tuple)):
            iters = [iters]
        if len(iters) != 1:
            raise MXNetError("PrefetchingIter here wraps a single iterator")
        self._iter = iters[0]
        super().__init__(self._iter.batch_size)
        self._depth = prefetch
        self._queue: _queue.Queue = _queue.Queue(maxsize=prefetch)
        self._thread = None
        self._stop = threading.Event()
        self._start()

    def _start(self):
        self._stop.clear()
        device = current_device()      # batches land where the caller is

        def worker():
            try:
                with device:
                    self._fill()
            except Exception as e:  # propagate like engine exception deferral
                self._queue.put(e)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def _fill(self):
        while not self._stop.is_set():
            try:
                batch = self._iter.next()
            except StopIteration:
                self._queue.put(None)
                return
            self._queue.put(batch)

    def reset(self):
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except _queue.Empty:
            pass
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._iter.reset()
        self._queue = _queue.Queue(maxsize=self._depth)
        self._start()

    def next(self):
        item = self._queue.get()
        if item is None:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        return item

    def iter_next(self):
        raise MXNetError("use next() on PrefetchingIter")


class ResizeIter(DataIter):
    """Resize an iterator to a fixed number of batches (reference ResizeIter)."""

    def __init__(self, data_iter: DataIter, size: int, reset_internal: bool = True):
        super().__init__(data_iter.batch_size)
        self._iter = data_iter
        self._size = size
        self._reset_internal = reset_internal
        self._count = 0

    def reset(self):
        self._count = 0
        if self._reset_internal:
            self._iter.reset()

    def next(self):
        if self._count >= self._size:
            raise StopIteration
        self._count += 1
        try:
            return self._iter.next()
        except StopIteration:
            self._iter.reset()
            return self._iter.next()
