"""Test helpers (counterpart of ``mxnet_tpu/test_utils.py``):
``assert_almost_equal`` with the worst element reported,
``check_numeric_gradient`` (central differences against the tape),
``check_consistency`` (one computation on several devices, by default
the CPU against the CUDA card when there is one), ``environment``
(scoped environment variables) and ``rand_ndarray`` (dense, or row-sparse
or CSR with ``stype=``)."""
from __future__ import annotations

import contextlib
import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as onp
import torch

from .base import MXNetError
from .device import Device, cpu, gpu
from .ndarray import NDArray, asarray

__all__ = [
    "assert_almost_equal", "almost_equal", "check_numeric_gradient",
    "check_consistency", "environment", "default_device", "rand_ndarray",
    "same",
]


def default_device() -> Device:
    from .device import current_device
    return current_device()


def _np(x) -> onp.ndarray:
    if isinstance(x, NDArray) or hasattr(x, "asnumpy"):
        return x.asnumpy()
    return onp.asarray(x)


def same(a, b) -> bool:
    return onp.array_equal(_np(a), _np(b))


def almost_equal(a, b, rtol=1e-5, atol=1e-20) -> bool:
    return onp.allclose(_np(a), _np(b), rtol=rtol, atol=atol)


def assert_almost_equal(a, b, rtol=1e-5, atol=1e-20, names=("a", "b")):
    """``a`` close to ``b``; the failure names the worst element."""
    a, b = _np(a), _np(b)
    if a.shape != b.shape:
        raise AssertionError(f"shape mismatch {names[0]}{a.shape} vs {names[1]}{b.shape}")
    if onp.allclose(a, b, rtol=rtol, atol=atol, equal_nan=True):
        return
    diff = onp.abs(a - b)
    rel = diff / onp.maximum(onp.maximum(onp.abs(b), atol), 1e-30)
    idx = onp.unravel_index(onp.argmax(rel), rel.shape)
    raise AssertionError(
        f"{names[0]} != {names[1]} (rtol={rtol}, atol={atol}): max rel err "
        f"{rel[idx]:.3e} at {idx}: {a[idx]!r} vs {b[idx]!r}")


def rand_ndarray(shape, dtype=onp.float32, scale=1.0, stype: str = "default",
                 density: float = 0.5):
    """Normal draws times ``scale`` (numpy's global generator); with
    ``stype`` 'row_sparse' or 'csr', a fraction ``density`` of the rows
    (row-sparse) or cells (CSR) kept, in that storage."""
    a = (onp.random.randn(*shape) * scale).astype(dtype)
    if stype == "default":
        return NDArray(a)
    from . import sparse
    if stype == "row_sparse":
        a[onp.random.rand(shape[0]) >= density] = 0
        return sparse.row_sparse_array(a)
    if stype == "csr":
        a[onp.random.rand(*shape) >= density] = 0
        return sparse.csr_matrix(a)
    raise MXNetError(f"rand_ndarray: unknown stype {stype!r}")


def check_numeric_gradient(fn: Callable, inputs: Sequence, eps: float = 1e-4,
                           rtol: float = 1e-2, atol: float = 1e-3) -> None:
    """The tape's gradient of the scalar ``fn(*inputs)`` against central
    differences (in f64)."""
    from . import autograd

    inputs = [asarray(x).astype(onp.float64) for x in inputs]
    for x in inputs:
        x.attach_grad()
    with autograd.record():
        out = fn(*inputs)
    out.backward()
    analytic = [x.grad.asnumpy().copy() for x in inputs]
    for i, x in enumerate(inputs):
        base = x.asnumpy().copy()
        numeric = onp.zeros_like(base)
        flat, num_flat = base.ravel(), numeric.ravel()

        def value():
            args = [asarray(base.reshape(x.shape)) if k == i else a
                    for k, a in enumerate(inputs)]
            return float(fn(*args).item())
        for j in range(flat.size):
            orig = flat[j]
            flat[j] = orig + eps
            plus = value()
            flat[j] = orig - eps
            minus = value()
            flat[j] = orig
            num_flat[j] = (plus - minus) / (2 * eps)
        assert_almost_equal(analytic[i], numeric, rtol=rtol, atol=atol,
                            names=(f"analytic[{i}]", f"numeric[{i}]"))


def check_consistency(fn: Callable, inputs: Sequence, devices: Optional[List] = None,
                      rtol: float = 1e-4, atol: float = 1e-5) -> None:
    """``fn(*inputs)`` on each of ``devices`` (default: the CPU, and the
    card when there is one) agrees with the first's."""
    if devices is None:
        devices = [cpu()] + ([gpu(0)] if torch.cuda.is_available() else [])
    results = []
    for dev in devices:
        xs = [x.to_device(dev) if isinstance(x, NDArray) else NDArray(x, device=dev)
              for x in inputs]
        results.append(_np(fn(*xs)))
    for i in range(1, len(results)):
        assert_almost_equal(results[0], results[i], rtol=rtol, atol=atol,
                            names=("dev0", f"dev{i}"))


@contextlib.contextmanager
def environment(*args):
    """Scoped environment variables: ``environment('NAME', 'value')`` or
    ``environment({'A': '1', 'B': None})`` (None unsets)."""
    if len(args) == 2:
        updates: Dict[str, Optional[str]] = {args[0]: args[1]}
    elif len(args) == 1 and isinstance(args[0], dict):
        updates = args[0]
    else:
        raise MXNetError("environment(name, value) or environment(dict)")
    saved = {}
    try:
        for k, v in updates.items():
            saved[k] = os.environ.get(k)
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
