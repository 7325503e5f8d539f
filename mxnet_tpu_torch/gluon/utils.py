"""Gluon utilities (counterpart of ``mxnet_tpu/gluon/utils.py``; the
reference's python/mxnet/gluon/utils.py): ``split_data``,
``split_and_load`` onto a list of port ``Device``s, ``clip_global_norm``,
``check_sha1``; ``download`` raises, as the JAX package's does."""
from __future__ import annotations

from typing import List, Sequence

from .. import numpy_extension as npx
from ..base import MXNetError
from ..device import Device
from ..ndarray import NDArray, asarray

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download"]


def split_data(data: NDArray, num_slice: int, batch_axis: int = 0,
               even_split: bool = True) -> List[NDArray]:
    """Split a batch along ``batch_axis`` (reference utils.split_data)."""
    data = asarray(data)
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise MXNetError(
            f"cannot split axis of size {size} evenly into {num_slice} slices")
    step = size // num_slice
    slices = []
    for i in range(num_slice):
        begin = i * step
        end = (i + 1) * step if i < num_slice - 1 else size
        slices.append(npx.slice_axis(data, axis=batch_axis, begin=begin, end=end))
    return slices


def split_and_load(data, ctx_list: Sequence[Device], batch_axis: int = 0,
                   even_split: bool = True) -> List[NDArray]:
    """Split a batch and place the slices on devices (reference
    split_and_load): one slice per entry of ``ctx_list`` (port ``Device``s,
    e.g. ``[mx.gpu(0)]`` or ``[mx.cpu()]``)."""
    data = asarray(data)
    if len(ctx_list) == 1:
        return [data.to_device(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.to_device(d) for s, d in zip(slices, ctx_list)]


def clip_global_norm(arrays: Sequence[NDArray], max_norm: float,
                     check_isfinite: bool = True) -> float:
    """Reference utils.clip_global_norm."""
    return npx.clip_global_norm(list(arrays), max_norm, check_isfinite)


def check_sha1(filename: str, sha1_hash: str) -> bool:
    import hashlib
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            sha1.update(chunk)
    return sha1.hexdigest() == sha1_hash


def download(url: str, path=None, overwrite=False, sha1_hash=None,
             retries=5, verify_ssl=True):
    raise MXNetError("download() is not available: place the files locally and "
                     "pass their paths instead")
