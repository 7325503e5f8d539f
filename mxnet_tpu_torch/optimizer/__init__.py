"""Optimizers (counterpart of ``mxnet_tpu/optimizer/__init__.py``): the
``Optimizer`` base with the registry and the eager single-parameter
``update``, and ``SGD``, ``NAG``, ``Adam``, ``AdamW``, ``Nadam``,
``RMSProp``, ``AdaGrad``, ``AdaDelta``, ``Ftrl``, ``Signum``, ``SGLD``,
``LARS``, ``LAMB``, ``DCASGD`` and ``Test`` under the JAX package's registry
names.

Each optimizer defines a pure ``update_step(w, g, state, lr, wd, t)`` over
tensors that returns ``(new_w, new_state)`` and changes nothing it is
given. ``TrainStep``, ``gluon.Trainer`` and :meth:`Optimizer.update` call
it through ``parallel.train.apply_updates`` with an f32 gradient,
Python-float rates, and the weight and its state as they are when they
are bf16 or f16 (in f32 otherwise), and write the results back in place
under ``torch.no_grad()``, in the parameter's and the state's own dtypes.
State is kept in the weight's dtype, as in the JAX package. Every step
follows the JAX step as XLA compiles it: a weak Python scalar meeting the
low-precision weight or state is rounded to their dtype (bf16(0.9) =
0.8984375: ``_weak``) and the product is kept in f32 (XLA's excess
precision inside a fused step: ``_up``), an explicit cast rounds (LAMB's
and LARS's trust ratio, SGLD's bf16 noise), and an op with the f32
gradient or a rate (an f32 array in the JAX step) is f32.

SGLD's state is one uint32 seed, ``jax.random.bits(next_key(), ())``, and
its noise ``jax.random.normal(fold_in(key(seed), t), w.shape, w.dtype) *
sqrt(lr)``; both are drawn on the host from the port's threefry
(``_prng``), so the card steps with the CPU's noise bit for bit.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import _prng
from .._random import next_key
from ..base import MXNetError

__all__ = ["Optimizer", "register", "create", "SGD", "NAG", "Adam", "AdamW", "Nadam",
           "RMSProp", "AdaGrad", "AdaDelta", "Ftrl", "Signum", "SGLD", "LARS", "LAMB",
           "DCASGD", "Test"]

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


def _f32_power(base: float, t) -> float:
    """``base ** t`` with both in f32 (``jnp.power(beta, t.astype(f32))``)."""
    return float(torch.pow(torch.tensor(base, dtype=torch.float32),
                           torch.tensor(float(t), dtype=torch.float32)))


def _f32(x) -> np.float32:
    return np.float32(x)


def _up(x):
    """``x`` in f32 when it is bf16 or f16 (what an op with an f32 array
    promotes it to in the JAX step), else as it is."""
    return x.float() if x.dtype in (torch.bfloat16, torch.float16) else x


@functools.lru_cache(maxsize=None)
def _rounded(c: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(c, dtype=torch.float32).to(dtype))


def _weak(c: float, x) -> float:
    """A weak Python scalar as it meets ``x`` in the JAX step: rounded to a
    bf16/f16 ``x``'s dtype (once per constant and dtype), else as it is."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return _rounded(c, x.dtype)
    return c


def _zeros(weight):
    return torch.zeros_like(weight, memory_format=torch.contiguous_format)


def _tensor(x):
    """The tensor of an NDArray (or the tensor itself)."""
    return getattr(x, "_data", x)


class Optimizer:
    """Base optimizer: learning rate, weight decay, ``rescale_grad``,
    ``clip_gradient``, per-index or per-name lr/wd multipliers and
    per-index update counts (Adam's bias-correction clock). With an
    ``lr_scheduler`` (``lr_scheduler.py``) the rate is
    ``lr_scheduler(num_update)``, and setting it sets the scheduler's
    ``base_lr``."""

    def __init__(self, learning_rate: float = 0.01, wd: float = 0.0,
                 rescale_grad: float = 1.0, clip_gradient: Optional[float] = None,
                 lr_scheduler=None, param_dict=None, aggregate_num: int = 0,
                 use_fused_step: bool = True, multi_precision: bool = False, **kwargs):
        """The JAX package's signature; ``aggregate_num``, ``use_fused_step``
        and ``multi_precision`` are accepted and change nothing (every step
        already runs in f32), as there."""
        self.lr = learning_rate
        self.wd = wd
        self.rescale_grad = rescale_grad
        self.clip_gradient = clip_gradient
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None and learning_rate is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.num_update = 0
        self._index_update_count: Dict[int, int] = {}
        self.idx2name: Dict[int, str] = {}
        self.lr_mult: Dict[Any, float] = {}
        self.wd_mult: Dict[Any, float] = {}
        self.param_dict = param_dict or {}
        self.multi_precision = multi_precision

    @property
    def learning_rate(self) -> float:
        if self.lr_scheduler is not None:
            return float(self.lr_scheduler(self.num_update))
        return self.lr

    @learning_rate.setter
    def learning_rate(self, lr):
        self.lr = lr
        if self.lr_scheduler is not None:
            self.lr_scheduler.base_lr = lr

    def set_learning_rate(self, lr):
        self.learning_rate = lr

    def set_lr_mult(self, args_lr_mult: Dict[Any, float]):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult: Dict[Any, float]):
        self.wd_mult = dict(args_wd_mult)

    @staticmethod
    def _mult(table, name, index) -> float:
        return table.get(index, table.get(name, 1.0))

    def _get_lr(self, index, lr: float) -> float:
        """Parameter ``index``'s rate: ``lr``, the step's rate (read once
        per step from :attr:`learning_rate`), times its multiplier (its
        ``param_dict`` entry's ``lr_mult`` first)."""
        p = self.param_dict.get(index)
        if p is not None:
            return lr * p.lr_mult
        return lr * self._mult(self.lr_mult, self.idx2name.get(index), index)

    def _get_wd(self, index) -> float:
        p = self.param_dict.get(index)
        if p is not None:
            return self.wd * p.wd_mult
        return self.wd * self._mult(self.wd_mult, self.idx2name.get(index), index)

    def _update_count(self, index) -> int:
        """Parameter ``index``'s step count after one more update; the
        largest count is :attr:`num_update`."""
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

    # lazy row-wise updates are exact for elementwise rules only; a trust
    # ratio over the whole weight (LARS, LAMB) needs the dense tensor
    lazy_rowwise = True

    @torch.no_grad()
    def update_step_rsp(self, w, uids, vals, state, lr, wd, t):
        """Row-sparse lazy update (the reference's ``lazy_update``): the
        rows ``uids`` of ``w`` and of every weight-shaped state tensor are
        gathered, stepped by :meth:`update_step` with their gradient rows
        ``vals`` and written back in place (a table-shaped result would
        double the table's memory); rows not named keep their weights and
        state. Ids outside ``[0, rows)`` (the JAX package's padding) are
        masked out, never used as an index. Dtypes as ``apply_updates``:
        f32 math for an f32 weight, the weight's own for bf16/f16. Returns
        ``(w, new_state)``."""
        keep = (uids >= 0) & (uids < w.shape[0])
        idx = uids[keep].long()
        g = vals[keep].float()
        low = w.dtype in (torch.bfloat16, torch.float16)
        rowwise = [torch.is_tensor(s) and tuple(s.shape) == tuple(w.shape) for s in state]

        def gather(x):
            rows = x.index_select(0, idx)
            return rows if low or not rows.is_floating_point() else rows.float()
        rows_state = tuple(gather(s) if rw else s for s, rw in zip(state, rowwise))
        new_rows, new_state = self.update_step(gather(w), g, rows_state, lr, wd, t)
        w.index_copy_(0, idx, new_rows.to(w.dtype))
        out = []
        for s, ns, rw in zip(state, new_state, rowwise):
            if rw:
                s.index_copy_(0, idx, ns.to(s.dtype))
                out.append(s)
            else:
                out.append(ns.to(s.dtype) if torch.is_tensor(s) else ns)
        return w, tuple(out)

    def update(self, index, weight, grad, state):
        """Eager single-parameter update (the reference ``Optimizer.update``):
        counts the update of ``index``, steps ``weight`` (an NDArray or a
        tensor, written in place) with ``grad * rescale_grad`` and returns
        the new state."""
        from ..parallel.train import apply_updates
        t = self._update_count(index)
        lr = self._get_lr(index, self.learning_rate)
        wd = self._get_wd(index)
        states = [tuple(state)]
        apply_updates(self, [(index, _tensor(weight))], states, lambda i: (lr, wd, t),
                      self.rescale_grad, grads=[_tensor(grad)])
        return states[0]

    def update_multi_precision(self, index, weight, grad, state):
        return self.update(index, weight, grad, state)

    def __repr__(self):
        return f"{type(self).__name__}(lr={self.lr}, wd={self.wd})"


@register
class SGD(Optimizer):
    """SGD with momentum."""

    def __init__(self, learning_rate=0.01, momentum: float = 0.0, lazy_update: bool = False,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return ()
        return (_zeros(weight),)

    def update_step(self, w, g, state, lr, wd, t):
        g = self._preprocess_grad(g) + wd * _up(w)
        if self.momentum == 0.0:
            return _up(w) - lr * g, state
        (mom,) = state
        mom = _weak(self.momentum, mom) * _up(mom) - lr * g
        return _up(w) + mom, (mom,)

@register
class NAG(SGD):
    """Nesterov accelerated SGD."""

    def __init__(self, learning_rate=0.01, momentum: float = 0.9, **kwargs):
        super().__init__(learning_rate=learning_rate, momentum=momentum, **kwargs)

    def create_state(self, index, weight):
        return (_zeros(weight),)

    def update_step(self, w, g, state, lr, wd, t):
        g = self._preprocess_grad(g) + wd * _up(w)
        (mom,) = state
        mom = _weak(self.momentum, mom) * _up(mom) - lr * g
        return _up(w) + self.momentum * mom - lr * g, (mom,)


@register
class Adam(Optimizer):
    """Adam with bias correction ``1 - beta ** t`` in f32."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update: bool = False, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def _moments(self, g, state, t):
        m, v = state
        m = _weak(self.beta1, m) * _up(m) + (1 - self.beta1) * g
        v = _weak(self.beta2, v) * _up(v) + (1 - self.beta2) * torch.square(g)
        mhat = m / (1 - _f32_power(self.beta1, t))
        vhat = v / (1 - _f32_power(self.beta2, t))
        return m, v, mhat, vhat

    def update_step(self, w, g, state, lr, wd, t):
        g = self._preprocess_grad(g) + wd * _up(w)
        m, v, mhat, vhat = self._moments(g, state, t)
        return _up(w) - lr * mhat / (torch.sqrt(vhat) + self.epsilon), (m, v)


@register
class AdamW(Adam):
    """Adam with decoupled weight decay."""

    def update_step(self, w, g, state, lr, wd, t):
        g = self._preprocess_grad(g)
        m, v, mhat, vhat = self._moments(g, state, t)
        return _up(w) - lr * (mhat / (torch.sqrt(vhat) + self.epsilon) + wd * _up(w)), (m, v)


@register
class Nadam(Adam):
    """Nesterov Adam: momentum schedule ``beta1 (1 - 0.5 * 0.96 ** (t *
    schedule_decay))``, its scalars in f32."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, beta1=beta1, beta2=beta2,
                         epsilon=epsilon, **kwargs)
        self.schedule_decay = schedule_decay

    def _mu(self, t):
        p = _f32(_f32_power(0.96, _f32(t) * _f32(self.schedule_decay)))
        return _f32(self.beta1) * (_f32(1) - _f32(0.5) * p)

    def update_step(self, w, g, state, lr, wd, t):
        g = self._preprocess_grad(g) + wd * _up(w)
        m, v = state
        mu_t, mu_t1 = self._mu(t), self._mu(t + 1)
        m = _weak(self.beta1, m) * _up(m) + (1 - self.beta1) * g
        v = _weak(self.beta2, v) * _up(v) + (1 - self.beta2) * torch.square(g)
        ghat = g / float(_f32(1) - mu_t)
        mhat = m / float(_f32(1) - mu_t1 * _f32(_f32_power(self.beta1, t)))
        vhat = v / float(_f32(1) - _f32(_f32_power(self.beta2, t)))
        mbar = float(_f32(1) - mu_t) * ghat + float(mu_t1) * mhat
        return _up(w) - lr * mbar / (torch.sqrt(vhat) + self.epsilon), (m, v)


@register
class RMSProp(Optimizer):
    """RMSProp with momentum; ``centered`` keeps the mean gradient too."""

    def __init__(self, learning_rate=0.001, rho=0.9, momentum=0.9,
                 epsilon=1e-8, centered=False, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.rho, self.momentum, self.epsilon = rho, momentum, epsilon
        self.centered = centered

    def create_state(self, index, weight):
        return tuple(_zeros(weight) for _ in range(3 if self.centered else 2))

    def update_step(self, w, g, state, lr, wd, t):
        g = self._preprocess_grad(g) + wd * _up(w)
        if self.centered:
            n, gbar, mom = state
            n = _weak(self.rho, n) * _up(n) + (1 - self.rho) * torch.square(g)
            gbar = _weak(self.rho, gbar) * _up(gbar) + (1 - self.rho) * g
            mom = _weak(self.momentum, mom) * _up(mom) - lr * g / torch.sqrt(
                n - torch.square(gbar) + self.epsilon)
            return _up(w) + mom, (n, gbar, mom)
        n, mom = state
        n = _weak(self.rho, n) * _up(n) + (1 - self.rho) * torch.square(g)
        mom = _weak(self.momentum, mom) * _up(mom) - lr * g / (torch.sqrt(n) + self.epsilon)
        return _up(w) + mom, (n, mom)


@register
class AdaGrad(Optimizer):
    def __init__(self, learning_rate=0.01, epsilon=1e-6, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros(weight),)

    def update_step(self, w, g, state, lr, wd, t):
        g = self._preprocess_grad(g) + wd * _up(w)
        (hist,) = state
        hist = _up(hist) + torch.square(g)
        return _up(w) - lr * g / (torch.sqrt(hist) + self.epsilon), (hist,)


@register
class AdaDelta(Optimizer):
    def __init__(self, learning_rate=1.0, rho=0.9, epsilon=1e-5, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update_step(self, w, g, state, lr, wd, t):
        g = self._preprocess_grad(g) + wd * _up(w)
        acc_g, acc_d = state
        acc_g = _weak(self.rho, acc_g) * _up(acc_g) + (1 - self.rho) * torch.square(g)
        # XLA rounds the low-precision sum before its square root
        num = _up((_up(acc_d) + _weak(self.epsilon, acc_d)).to(acc_d.dtype))
        delta = torch.sqrt(num) / torch.sqrt(acc_g + self.epsilon) * g
        acc_d = _weak(self.rho, acc_d) * _up(acc_d) + (1 - self.rho) * torch.square(delta)
        return _up(w) - lr * delta, (acc_g, acc_d)


@register
class Ftrl(Optimizer):
    """Follow the regularized leader (FTRL-proximal)."""

    def __init__(self, learning_rate=0.1, lamda1=0.01, beta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update_step(self, w, g, state, lr, wd, t):
        g = self._preprocess_grad(g)
        zs, ns = state
        sigma = (torch.sqrt(_up(ns) + torch.square(g)) - torch.sqrt(_up(ns))) / lr
        zs = _up(zs) + g - sigma * _up(w)
        ns = _up(ns) + torch.square(g)
        new_w = torch.where(zs.abs() <= self.lamda1, torch.zeros_like(zs),
                            (torch.sign(zs) * self.lamda1 - zs)
                            / ((self.beta + torch.sqrt(ns)) / lr + wd))
        return new_w, (zs, ns)


@register
class Signum(Optimizer):
    """Signed momentum SGD."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return ()
        return (_zeros(weight),)

    def update_step(self, w, g, state, lr, wd, t):
        g = self._preprocess_grad(g) + wd * _up(w)
        decay = float(_f32(1) - _f32(lr) * _f32(self.wd_lh))
        if self.momentum == 0.0:
            return _up(w) * decay - lr * torch.sign(g), state
        (mom,) = state
        mom = _weak(self.momentum, mom) * _up(mom) - (1 - self.momentum) * g
        return _up(w) * decay + lr * torch.sign(mom), (mom,)


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics: half a gradient step plus
    N(0, lr) noise from the parameter's seed and the step count."""


    def create_state(self, index, weight):
        seed = _prng.host_bits(next_key(), (), 32)
        return (torch.tensor(int(seed), dtype=torch.uint32),)

    def update_step(self, w, g, state, lr, wd, t):
        g = self._preprocess_grad(g) + wd * _up(w)
        (seed,) = state
        key = _prng.fold_in(_prng.key(int(seed)), int(t))
        if w.dtype == torch.bfloat16:
            # the fused step keeps sqrt(2) * erfinv(u) unrounded
            noise = _prng.normal_bf16(key, tuple(w.shape), round_product=False)
        else:
            noise = _prng.host_normal(key, tuple(w.shape))
        noise = torch.from_numpy(noise).to(w.device)
        noise = noise * float(np.sqrt(_f32(lr)))
        return w - 0.5 * lr * g + noise, (seed,)


@register
class LARS(Optimizer):
    """Layer-wise adaptive rate scaling: momentum SGD at ``lr`` times a
    trust ratio of f32 norms of the whole weight and gradient."""

    lazy_rowwise = False

    def __init__(self, learning_rate=0.1, momentum=0.9, eta=0.001,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum, self.eta, self.epsilon = momentum, eta, epsilon

    def create_state(self, index, weight):
        return (_zeros(weight),)

    def update_step(self, w, g, state, lr, wd, t):
        g = self._preprocess_grad(g)
        w_norm = torch.linalg.vector_norm(w.float())
        g_norm = torch.linalg.vector_norm(g.float())
        trust = torch.where((w_norm > 0) & (g_norm > 0),
                            self.eta * w_norm / (g_norm + wd * w_norm + self.epsilon), 1.0)
        g = g + wd * _up(w)
        (mom,) = state
        mom = _weak(self.momentum, mom) * _up(mom) + _up(trust.to(w.dtype)) * lr * g
        return w - mom, (mom,)


@register
class LAMB(Optimizer):
    """Layer-wise Adam for large batches: the Adam direction plus decay,
    scaled by the ratio of f32 norms ``|w| / |r|`` (``|w|`` clipped to the
    optional bounds; 1 where either norm is 0)."""

    lazy_rowwise = False

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound, self.upper_bound = lower_bound, upper_bound
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update_step(self, w, g, state, lr, wd, t):
        g = self._preprocess_grad(g)
        m, v = state
        m = _weak(self.beta1, m) * _up(m) + (1 - self.beta1) * g
        v = _weak(self.beta2, v) * _up(v) + (1 - self.beta2) * torch.square(g)
        if self.bias_correction:
            mhat = m / (1 - _f32_power(self.beta1, t))
            vhat = v / (1 - _f32_power(self.beta2, t))
        else:
            mhat, vhat = m, v
        r = mhat / (torch.sqrt(vhat) + self.epsilon) + wd * _up(w)
        w_norm = torch.linalg.vector_norm(w.float())
        r_norm = torch.linalg.vector_norm(r.float())
        if self.lower_bound is not None:
            w_norm = w_norm.clamp_min(self.lower_bound)
        if self.upper_bound is not None:
            w_norm = w_norm.clamp_max(self.upper_bound)
        ratio = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm, 1.0)
        return w - lr * _up(ratio.to(w.dtype)) * r, (m, v)


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD; its state keeps the previous
    weight."""

    def __init__(self, learning_rate=0.01, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum, self.lamda = momentum, lamda

    def create_state(self, index, weight):
        return (_zeros(weight), weight.detach().clone(memory_format=torch.contiguous_format))

    def update_step(self, w, g, state, lr, wd, t):
        g = self._preprocess_grad(g) + wd * _up(w)
        mom, prev_w = state
        mom = _weak(self.momentum, mom) * _up(mom) - lr * (
            g + self.lamda * g * g * (_up(w) - _up(prev_w)))
        return _up(w) + mom, (mom, _up(w) + mom)


@register
class Test(Optimizer):
    """Plain SGD with a never-updated state tensor (the reference's test
    optimizer)."""

    def create_state(self, index, weight):
        return (_zeros(weight),)

    def update_step(self, w, g, state, lr, wd, t):
        g = self._preprocess_grad(g) + wd * _up(w)
        return _up(w) - lr * g, state
