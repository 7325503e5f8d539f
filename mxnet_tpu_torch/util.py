"""Utility toggles (counterpart of ``mxnet_tpu/util.py``): the np-shape and
np-array switches (always on: the frontend is NumPy's), their decorators
and scopes, and environment helpers."""
from __future__ import annotations

import contextlib
import os

__all__ = [
    "is_np_shape", "is_np_array", "set_np", "reset_np", "use_np", "np_shape",
    "np_array", "getenv", "setenv", "default_array",
]


def is_np_shape() -> bool:
    return True


def is_np_array() -> bool:
    return True


def set_np(shape: bool = True, array: bool = True, dtype=None):
    """Accepted for scripts: NumPy semantics are the only ones."""


def reset_np():
    set_np()


def use_np(func):
    return func


use_np_shape = use_np
use_np_array = use_np


@contextlib.contextmanager
def np_shape(active: bool = True):
    yield


@contextlib.contextmanager
def np_array(active: bool = True):
    yield


def getenv(name: str):
    return os.environ.get(name)


def setenv(name: str, value: str):
    os.environ[name] = value


def default_array(source_array, device=None, dtype=None):
    from .numpy import array
    return array(source_array, dtype=dtype, device=device)
