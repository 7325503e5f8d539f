"""Bijective transformations (counterpart of
``mxnet_tpu/gluon/probability/transformation.py``): each map and its
log-determinant runs through the funnel, so it records on the tape."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...ndarray import NDArray, apply_multi, asarray

__all__ = ["Transformation", "ComposeTransform", "ExpTransform",
           "AffineTransform", "PowerTransform", "AbsTransform",
           "SigmoidTransform", "SoftmaxTransform"]


def _wrap(fn, *arrays):
    return apply_multi(fn, [a if isinstance(a, NDArray) else asarray(a) for a in arrays])


class _Weak(NDArray):
    """An array derived from a Python scalar alone (a log-det-Jacobian of a
    Python-float scale): weakly typed in the JAX package, so it takes the
    dtype of a strongly typed operand it meets (see :func:`_combine`)."""

    __slots__ = ()


def _weak(arr):
    if isinstance(arr, NDArray):
        arr.__class__ = _Weak
    return arr


def _combine(fn, a, b):
    """``fn(a, b)`` with the JAX package's weak typing: a :class:`_Weak`
    operand takes the other operand's dtype unless both are weak."""
    wa, wb = isinstance(a, _Weak), isinstance(b, _Weak)
    out = _wrap(lambda x, y: fn(x.to(y.dtype) if wa and not wb else x,
                                y.to(x.dtype) if wb and not wa else y), a, b)
    return _weak(out) if wa and wb else out


class Transformation:
    """y = f(x) with a tractable inverse and log|det J|."""

    bijective = True
    event_dim = 0

    def __call__(self, x):
        return self._forward(asarray(x))

    def inv(self, y):
        return self._inverse(asarray(y))

    def log_det_jacobian(self, x, y=None):
        """log |dy/dx| evaluated at x (y may be supplied to reuse)."""
        raise NotImplementedError

    def _forward(self, x):
        raise NotImplementedError

    def _inverse(self, y):
        raise NotImplementedError


class ComposeTransform(Transformation):
    def __init__(self, parts):
        self.parts = list(parts)
        self.event_dim = max((p.event_dim for p in self.parts), default=0)

    def _forward(self, x):
        for p in self.parts:
            x = p(x)
        return x

    def _inverse(self, y):
        for p in reversed(self.parts):
            y = p.inv(y)
        return y

    def log_det_jacobian(self, x, y=None):
        total = None
        cur = asarray(x)
        for p in self.parts:
            nxt = p(cur)
            term = p.log_det_jacobian(cur, nxt)
            total = term if total is None else _combine(torch.add, total, term)
            cur = nxt
        return total


class ExpTransform(Transformation):
    def _forward(self, x):
        return _wrap(torch.exp, x)

    def _inverse(self, y):
        return _wrap(torch.log, y)

    def log_det_jacobian(self, x, y=None):
        return asarray(x)


class AffineTransform(Transformation):
    def __init__(self, loc, scale):
        self.loc = asarray(loc)
        self.scale = asarray(scale)
        self._weak_scale = isinstance(scale, (int, float))

    def _forward(self, x):
        return _wrap(lambda v, m, s: m + s * v, x, self.loc, self.scale)

    def _inverse(self, y):
        return _wrap(lambda v, m, s: (v - m) / s, y, self.loc, self.scale)

    def log_det_jacobian(self, x, y=None):
        out = _wrap(lambda v, s: torch.log(torch.abs(s)).broadcast_to(v.shape), x, self.scale)
        return _weak(out) if self._weak_scale else out


class PowerTransform(Transformation):
    def __init__(self, exponent):
        self.exponent = asarray(exponent)

    def _forward(self, x):
        return _wrap(lambda v, e: v ** e, x, self.exponent)

    def _inverse(self, y):
        return _wrap(lambda v, e: v ** (1.0 / e), y, self.exponent)

    def log_det_jacobian(self, x, y=None):
        return _wrap(lambda v, e: torch.log(torch.abs(e * v ** (e - 1))), x, self.exponent)


class AbsTransform(Transformation):
    bijective = False

    def _forward(self, x):
        return _wrap(torch.abs, x)

    def _inverse(self, y):
        return asarray(y)


class SigmoidTransform(Transformation):
    def _forward(self, x):
        return _wrap(torch.sigmoid, x)

    def _inverse(self, y):
        return _wrap(lambda v: torch.log(v) - torch.log1p(-v), y)

    def log_det_jacobian(self, x, y=None):
        return _wrap(lambda v: F.logsigmoid(v) + F.logsigmoid(-v), x)


class SoftmaxTransform(Transformation):
    bijective = False
    event_dim = 1

    def _forward(self, x):
        return _wrap(lambda v: torch.softmax(v, -1), x)

    def _inverse(self, y):
        return _wrap(torch.log, y)
