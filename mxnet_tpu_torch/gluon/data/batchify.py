"""Batchify functions (counterpart of ``mxnet_tpu/gluon/data/batchify.py``;
the reference's Stack/Pad/Append/Group/AsList) for DataLoader's
``batchify_fn``. Samples are gathered as host numpy and each batch becomes
one NDArray on the current device, the card unless the caller asks for
the CPU: a forked DataLoader worker must not build one (CUDA cannot run in
a forked child), so process workers batchify with
``default_mp_batchify_fn``."""
from __future__ import annotations

from typing import List, Sequence

import numpy as onp

from ...base import MXNetError
from ...ndarray import NDArray

__all__ = ["Stack", "Pad", "Append", "Group", "AsList"]


def _to_np(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    return onp.asarray(x)


class Stack:
    """Stack equal-shaped samples along a new batch axis (reference
    batchify.Stack)."""

    def __call__(self, data: Sequence):
        return NDArray(onp.stack([_to_np(d) for d in data]))


class Pad:
    """Pad variable-length samples to the batch max along ``axis`` then
    stack (reference batchify.Pad)."""

    def __init__(self, axis: int = 0, val: float = 0, dtype=None):
        self._axis = axis
        self._val = val
        self._dtype = dtype

    def __call__(self, data: Sequence):
        arrays = [_to_np(d) for d in data]
        ndim = arrays[0].ndim
        if any(a.ndim != ndim for a in arrays):
            raise MXNetError("Pad: samples must share rank")
        axis = self._axis % max(ndim, 1)
        target = max(a.shape[axis] for a in arrays) if ndim else 0
        out = []
        for a in arrays:
            pad = [(0, 0)] * ndim
            pad[axis] = (0, target - a.shape[axis])
            out.append(onp.pad(a, pad, constant_values=self._val))
        batch = onp.stack(out)
        if self._dtype is not None:
            batch = batch.astype(self._dtype)
        return NDArray(batch)


class Append:
    """Return each sample as its own 1-batch array (no shape constraint;
    reference batchify.Append)."""

    def __init__(self, expand: bool = True, batch_axis: int = 0):
        self._expand = expand
        self._batch_axis = batch_axis

    def __call__(self, data: Sequence) -> List[NDArray]:
        out = []
        for d in data:
            a = _to_np(d)
            if self._expand:
                a = onp.expand_dims(a, self._batch_axis)
            out.append(NDArray(a))
        return out


class Group:
    """Apply the i-th batchify fn to the i-th field of tuple samples
    (reference batchify.Group)."""

    def __init__(self, *fns):
        if len(fns) == 1 and isinstance(fns[0], (list, tuple)):
            fns = tuple(fns[0])
        self._fns = fns

    def __call__(self, data: Sequence):
        if not data or len(data[0]) != len(self._fns):
            raise MXNetError(
                f"Group: samples have {len(data[0]) if data else 0} fields "
                f"but {len(self._fns)} batchify fns were given")
        return tuple(fn([sample[i] for sample in data])
                     for i, fn in enumerate(self._fns))


class AsList:
    """Forward the raw field values as a python list (reference
    batchify.AsList; for text fields under Group)."""

    def __call__(self, data: Sequence) -> list:
        return list(data)
