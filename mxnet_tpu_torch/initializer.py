"""Weight initializers (counterpart of ``mxnet_tpu/initializer.py``).

The same registry and ``Initializer`` contract as the JAX package, and
the same draws: each random initializer takes one key of the global
stream (``_random.next_key()``) per array and draws with jax.random's
algorithms on the host (``_prng``), so ``mx.random.seed(s)`` then
``initialize()`` gives the JAX package's values. Uniform draws are bit
for bit (Xavier's f64 draw cast to the parameter's dtype too); normal
ones go through erfinv and may differ in the last place; ``Orthogonal``
takes an SVD, whose signs and last bits are the library's.
"""
from __future__ import annotations

import json
import math
from typing import Dict

import numpy as onp
import torch

from . import _prng
from ._random import next_key
from .base import MXNetError

__all__ = [
    "Initializer", "register", "create", "Zero", "One", "Constant", "Uniform", "Normal",
    "Orthogonal", "Xavier", "StackedXavier", "MSRAPrelu", "Bilinear", "LSTMBias", "InitDesc",
    "zeros", "ones",
]

_REGISTRY: Dict[str, type] = {}


def register(klass=None, name=None):
    """Register an initializer class under ``name`` (default: its class
    name, lower-cased)."""
    def _do(k):
        _REGISTRY[(name or k.__name__).lower()] = k
        return k
    return _do if klass is None else _do(klass)


def create(initializer, **kwargs) -> "Initializer":
    """An initializer from an instance, a registered name, or None (the
    JAX package's default for gluon parameters, ``Uniform(0.07)``)."""
    if initializer is None:
        return Uniform(0.07)
    if isinstance(initializer, Initializer):
        return initializer
    if isinstance(initializer, str):
        key = initializer.lower()
        if key not in _REGISTRY:
            raise MXNetError(f"initializer registry: unknown entry {initializer!r}; "
                             f"known: {sorted(_REGISTRY)}")
        return _REGISTRY[key](**kwargs)
    raise MXNetError(f"cannot create initializer from {initializer!r}")


class InitDesc(str):
    """A parameter's name as given to an initializer, with ``attrs``."""

    def __new__(cls, name, attrs=None, global_init=None):
        obj = super().__new__(cls, name)
        obj.attrs = attrs or {}
        obj.global_init = global_init
        return obj


def _fill(arr, values) -> None:
    """Write host values (numpy or a tensor) into ``arr`` in its dtype."""
    t = values if isinstance(values, torch.Tensor) else torch.from_numpy(
        onp.ascontiguousarray(values))
    arr._set_data(t.to(device=arr._data.device, dtype=arr._data.dtype))


class Initializer:
    """Base initializer: biases, betas and running means get zeros, gammas
    and running variances ones, anything else ``_init_weight``."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, name, arr) -> None:
        self.init_array(name, arr)

    def init_array(self, name, arr) -> None:
        name = str(name)
        if name.endswith(("bias", "beta", "running_mean")):
            _fill(arr, torch.zeros(arr.shape))
        elif name.endswith(("gamma", "running_var")):
            _fill(arr, torch.ones(arr.shape))
        else:
            self._init_weight(name, arr)

    def _init_weight(self, name, arr) -> None:
        raise NotImplementedError

    def __repr__(self):
        kv = ", ".join(f"{k}={v!r}" for k, v in self._kwargs.items())
        return f"{type(self).__name__}({kv})"

    def dumps(self) -> str:
        return json.dumps([type(self).__name__.lower(), self._kwargs])


@register
class Zero(Initializer):
    def _init_weight(self, name, arr):
        _fill(arr, torch.zeros(arr.shape))


register(Zero, name="zeros")


@register
class One(Initializer):
    def _init_weight(self, name, arr):
        _fill(arr, torch.ones(arr.shape))


register(One, name="ones")


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, name, arr):
        _fill(arr, torch.full(arr.shape, float(self.value), dtype=torch.float64))


@register
class Uniform(Initializer):
    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, name, arr):
        _fill(arr, _prng.host_uniform(next_key(), arr.shape, -self.scale, self.scale))


@register
class Normal(Initializer):
    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, name, arr):
        z = _prng.host_normal(next_key(), arr.shape)
        _fill(arr, (onp.float32(self.sigma) * z).astype(onp.float32))


@register
class Orthogonal(Initializer):
    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, name, arr):
        nout = arr.shape[0]
        nin = int(onp.prod(arr.shape[1:])) if arr.ndim > 1 else 1
        if self.rand_type == "uniform":
            tmp = _prng.host_uniform(next_key(), (nout, nin), -1.0, 1.0, onp.float64)
        else:
            tmp = _prng.host_normal(next_key(), (nout, nin), onp.float64)
        u, _, v = torch.linalg.svd(torch.from_numpy(tmp), full_matrices=False)
        q = u if tuple(u.shape) == (nout, nin) else v
        _fill(arr, (self.scale * q).reshape(arr.shape))


@register
class Xavier(Initializer):
    """factor_type in/out/avg, magnitude; rnd_type uniform or gaussian
    (drawn in f64, as the JAX package's default dtype, then cast)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type, magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = arr.shape
        if len(shape) < 2:
            fan_in = fan_out = shape[0] if shape else 1
        else:
            hw_scale = int(onp.prod(shape[2:])) if len(shape) > 2 else 1
            fan_in = shape[1] * hw_scale
            fan_out = shape[0] * hw_scale
        self._fill(arr, shape, fan_in, fan_out)

    def _fill(self, arr, shape, fan_in, fan_out):
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}.get(self.factor_type)
        if factor is None:
            raise MXNetError(f"invalid factor_type {self.factor_type}")
        scale = math.sqrt(self.magnitude / max(factor, 1.0))
        if self.rnd_type == "uniform":
            data = _prng.host_uniform(next_key(), shape, -scale, scale, onp.float64)
        elif self.rnd_type == "gaussian":
            data = scale * _prng.host_normal(next_key(), shape, onp.float64)
        else:
            raise MXNetError(f"invalid rnd_type {self.rnd_type}")
        _fill(arr, data)


@register
class StackedXavier(Xavier):
    """Xavier over stacked weights: the leading axis indexes independent
    matrices and is left out of the fans."""

    def _init_weight(self, name, arr):
        shape = arr.shape
        if len(shape) < 3:
            return super()._init_weight(name, arr)
        sub = shape[1:]
        hw_scale = int(onp.prod(sub[2:])) if len(sub) > 2 else 1
        self._fill(arr, shape, sub[1] * hw_scale, sub[0] * hw_scale)


@register
class MSRAPrelu(Xavier):
    """Kaiming init for a PReLU slope."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """The bilinear upsampling kernel."""

    def _init_weight(self, name, arr):
        shape = arr.shape
        weight = onp.zeros(shape, dtype="float32")
        f = onp.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(int(onp.prod(shape))):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            weight.flat[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        _fill(arr, weight)


@register
class LSTMBias(Initializer):
    """Forget-gate bias."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr):
        b = onp.zeros(arr.shape, dtype="float32")
        n = arr.shape[0] // 4
        b[n:2 * n] = self.forget_bias
        _fill(arr, b)


zeros = Zero
ones = One
