"""Optimizers (counterpart of ``mxnet_tpu/optimizer/__init__.py``): the
``Optimizer`` base, ``SGD``, ``Adam`` and ``AdamW``, and the registry.

Each optimizer defines a pure ``update_step(w, g, state, lr, wd, t)`` over
tensors that returns ``(new_w, new_state)`` and changes nothing it is
given. ``TrainStep`` and ``gluon.Trainer`` feed it f32 views (a bf16 weight,
its gradient and its state are upcast, as the JAX package's f32 scalar
hyperparameters promote them) and write the results back in place under
``torch.no_grad()``, in the parameter's and the state's own dtypes. State is
kept in the weight's dtype, as in the JAX package.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..base import MXNetError

__all__ = ["Optimizer", "register", "create", "SGD", "Adam", "AdamW"]

_REGISTRY: Dict[str, type] = {}


def register(klass=None, name: Optional[str] = None):
    """Register an optimizer class under ``name`` (default: its class name,
    lower-cased)."""
    def _do(k):
        _REGISTRY[(name or k.__name__).lower()] = k
        return k
    return _do if klass is None else _do(klass)


def create(name, **kwargs) -> "Optimizer":
    if isinstance(name, Optimizer):
        return name
    key = str(name).lower()
    if key not in _REGISTRY:
        raise MXNetError(f"optimizer registry: unknown entry {name!r}; "
                         f"known: {sorted(_REGISTRY)}")
    return _REGISTRY[key](**kwargs)


def _f32_power(base: float, t: int) -> float:
    """``base ** t`` with both in f32 (``jnp.power(beta, t.astype(f32))``)."""
    return float(torch.pow(torch.tensor(base, dtype=torch.float32),
                           torch.tensor(float(t), dtype=torch.float32)))


class Optimizer:
    """Base optimizer: learning rate, weight decay, ``rescale_grad``,
    ``clip_gradient``, per-index or per-name lr/wd multipliers and
    per-index update counts (Adam's bias-correction clock). Learning-rate
    schedulers are not ported yet."""

    def __init__(self, learning_rate: float = 0.01, wd: float = 0.0,
                 rescale_grad: float = 1.0, clip_gradient: Optional[float] = None):
        self.lr = learning_rate
        self.wd = wd
        self.rescale_grad = rescale_grad
        self.clip_gradient = clip_gradient
        self.num_update = 0
        self._index_update_count: Dict[int, int] = {}
        self.idx2name: Dict[int, str] = {}
        self.lr_mult: Dict[Any, float] = {}
        self.wd_mult: Dict[Any, float] = {}

    @property
    def learning_rate(self) -> float:
        return self.lr

    @learning_rate.setter
    def learning_rate(self, lr):
        self.lr = lr

    def set_learning_rate(self, lr):
        self.learning_rate = lr

    def set_lr_mult(self, args_lr_mult: Dict[Any, float]):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult: Dict[Any, float]):
        self.wd_mult = dict(args_wd_mult)

    @staticmethod
    def _mult(table, name, index) -> float:
        return table.get(index, table.get(name, 1.0))

    def _get_lr(self, index) -> float:
        return self.learning_rate * self._mult(self.lr_mult, self.idx2name.get(index), index)

    def _get_wd(self, index) -> float:
        return self.wd * self._mult(self.wd_mult, self.idx2name.get(index), index)

    def _update_count(self, index) -> int:
        count = self._index_update_count.get(index, 0) + 1
        self._index_update_count[index] = count
        self.num_update = max(count, self.num_update)
        return count

    def create_state(self, index, weight):
        """Per-parameter state: a tuple of tensors in the weight's dtype."""
        return ()

    def _preprocess_grad(self, g):
        """Clip only: the caller applies ``rescale_grad``."""
        if self.clip_gradient is not None:
            g = g.clamp(-self.clip_gradient, self.clip_gradient)
        return g

    def update_step(self, w, g, state, lr, wd, t):
        """Pure update: returns ``(new_w, new_state)``."""
        raise NotImplementedError


@register
class SGD(Optimizer):
    """SGD with momentum."""

    def __init__(self, learning_rate=0.01, momentum: float = 0.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return ()
        return (torch.zeros_like(weight, memory_format=torch.contiguous_format),)

    def update_step(self, w, g, state, lr, wd, t):
        g = self._preprocess_grad(g) + wd * w
        if self.momentum == 0.0:
            return w - lr * g, state
        (mom,) = state
        mom = self.momentum * mom - lr * g
        return w + mom, (mom,)


@register
class Adam(Optimizer):
    """Adam with bias correction ``1 - beta ** t`` in f32."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        z = torch.zeros_like(weight, memory_format=torch.contiguous_format)
        return (z, torch.zeros_like(z))

    def _moments(self, g, state, t):
        m, v = state
        m = self.beta1 * m + (1 - self.beta1) * g
        v = self.beta2 * v + (1 - self.beta2) * torch.square(g)
        mhat = m / (1 - _f32_power(self.beta1, t))
        vhat = v / (1 - _f32_power(self.beta2, t))
        return m, v, mhat, vhat

    def update_step(self, w, g, state, lr, wd, t):
        g = self._preprocess_grad(g) + wd * w
        m, v, mhat, vhat = self._moments(g, state, t)
        return w - lr * mhat / (torch.sqrt(vhat) + self.epsilon), (m, v)


@register
class AdamW(Adam):
    """Adam with decoupled weight decay."""

    def update_step(self, w, g, state, lr, wd, t):
        g = self._preprocess_grad(g)
        m, v, mhat, vhat = self._moments(g, state, t)
        return w - lr * (mhat / (torch.sqrt(vhat) + self.epsilon) + wd * w), (m, v)
