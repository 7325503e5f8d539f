"""Gluon basic layers with the JAX package's signatures (counterpart of
``mxnet_tpu/gluon/nn/basic_layers.py``): ``Dense``, ``Dropout``,
``Embedding``, ``Flatten``, the normalization layers (``BatchNorm`` with
its running statistics), ``Identity``, ``Lambda``/``HybridLambda`` and the
activation layers, all ``HybridBlock``s over ``mx.npx`` primitives.
Dropout and BatchNorm follow ``autograd.is_training()``."""
from __future__ import annotations

from typing import Optional

import numpy as onp

from ... import _tape
from ... import numpy_extension as npx
from ..block import Block, HybridBlock, HybridSequential, Sequential  # noqa: F401
from ..parameter import Parameter

__all__ = [
    "Dense", "Dropout", "Embedding", "Flatten", "BatchNorm", "LayerNorm", "GroupNorm",
    "InstanceNorm", "RMSNorm", "Identity", "Lambda", "HybridLambda", "Activation",
    "LeakyReLU", "PReLU", "ELU", "SELU", "GELU", "SiLU", "Swish",
]


def _finish(params, shape):
    """Set the shape of deferred parameters and initialize them, in order."""
    for p in params:
        if p is not None and p._var is None:
            p.shape = shape
            p._finish_deferred_init()


class Dense(HybridBlock):
    """``activation(x @ weight.T + bias)``; ``weight`` is (units, in_units),
    in_units inferred at the first forward when 0."""

    def __init__(self, units: int, activation: Optional[str] = None, use_bias: bool = True,
                 flatten: bool = True, dtype=onp.float32, weight_initializer=None,
                 bias_initializer="zeros", in_units: int = 0):
        super().__init__()
        self._units = units
        self._flatten = flatten
        self._activation = activation
        self.weight = Parameter("weight", shape=(units, in_units), dtype=dtype,
                                init=weight_initializer, allow_deferred_init=True)
        self.bias = Parameter("bias", shape=(units,), dtype=dtype,
                              init=bias_initializer) if use_bias else None

    def forward(self, x):
        if self.weight._var is None:
            in_units = int(onp.prod(x.shape[1:])) if self._flatten else x.shape[-1]
            _finish([self.weight], (self._units, in_units))
        out = npx.fully_connected(x, self.weight.data(),
                                  None if self.bias is None else self.bias.data(),
                                  num_hidden=self._units, no_bias=self.bias is None,
                                  flatten=self._flatten)
        if self._activation is not None:
            out = npx.activation(out, self._activation)
        return out

    def __repr__(self):
        return f"Dense({self._units}, flatten={self._flatten})"


class Dropout(HybridBlock):
    """Dropout at ``rate`` in training mode (``autograd.is_training()``)."""

    def __init__(self, rate: float, axes=()):
        super().__init__()
        self._rate = rate
        self._axes = axes

    def forward(self, x):
        return npx.dropout(x, p=self._rate, axes=self._axes)

    def __repr__(self):
        return f"Dropout(p={self._rate})"


class Embedding(HybridBlock):
    """A gather of rows of ``weight`` (input_dim, output_dim). Its gradient
    is dense (``sparse_grad`` waits for row-sparse gradients)."""

    def __init__(self, input_dim: int, output_dim: int, dtype=onp.float32,
                 weight_initializer=None, sparse_grad: bool = False):
        super().__init__()
        self._input_dim = input_dim
        self._output_dim = output_dim
        self.weight = Parameter("weight", shape=(input_dim, output_dim), dtype=dtype,
                                init=weight_initializer)

    def forward(self, x):
        return npx.embedding(x, self.weight.data())

    def __repr__(self):
        return f"Embedding({self._input_dim} -> {self._output_dim})"


class Flatten(HybridBlock):
    def forward(self, x):
        return x.reshape(x.shape[0], -1)

    def __repr__(self):
        return "Flatten"


class BatchNorm(HybridBlock):
    """Batch normalization over ``axis``; in training mode the running
    statistics (``grad_req='null'`` parameters) are written back after
    each forward, through a hybridized block's graph too."""

    def __init__(self, axis: int = 1, momentum: float = 0.9, epsilon: float = 1e-5,
                 center: bool = True, scale: bool = True, use_global_stats: bool = False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros", running_variance_initializer="ones",
                 in_channels: int = 0, dtype=onp.float32):
        super().__init__()
        self._axis = axis
        self._momentum = momentum
        self._eps = epsilon
        self._scale = scale
        self._use_global_stats = use_global_stats
        ch = in_channels or 0
        self.gamma = Parameter("gamma", shape=(ch,), dtype=dtype, init=gamma_initializer,
                               allow_deferred_init=True, differentiable=scale)
        self.beta = Parameter("beta", shape=(ch,), dtype=dtype, init=beta_initializer,
                              allow_deferred_init=True, differentiable=center)
        self.running_mean = Parameter("running_mean", shape=(ch,), dtype=dtype,
                                      init=running_mean_initializer,
                                      allow_deferred_init=True, differentiable=False)
        self.running_var = Parameter("running_var", shape=(ch,), dtype=dtype,
                                     init=running_variance_initializer,
                                     allow_deferred_init=True, differentiable=False)

    def forward(self, x):
        _finish((self.gamma, self.beta, self.running_mean, self.running_var),
                (x.shape[self._axis],))
        training = _tape.is_training() and not self._use_global_stats
        out, new_rm, new_rv = npx.batch_norm(
            x, self.gamma.data(), self.beta.data(), self.running_mean.data(),
            self.running_var.data(), eps=self._eps, momentum=self._momentum,
            fix_gamma=not self._scale, use_global_stats=self._use_global_stats,
            axis=self._axis, training=training)
        if training:
            self.running_mean.set_data(new_rm)
            self.running_var.set_data(new_rv)
        return out

    def __repr__(self):
        return f"BatchNorm(axis={self._axis}, momentum={self._momentum})"


class LayerNorm(HybridBlock):
    def __init__(self, axis: int = -1, epsilon: float = 1e-5, center: bool = True,
                 scale: bool = True, beta_initializer="zeros", gamma_initializer="ones",
                 in_channels: int = 0, dtype=onp.float32):
        super().__init__()
        self._axis = axis
        self._eps = epsilon
        ch = in_channels or 0
        self.gamma = Parameter("gamma", shape=(ch,), dtype=dtype, init=gamma_initializer,
                               allow_deferred_init=True) if scale else None
        self.beta = Parameter("beta", shape=(ch,), dtype=dtype, init=beta_initializer,
                              allow_deferred_init=True) if center else None

    def forward(self, x):
        _finish((self.gamma, self.beta), (x.shape[self._axis],))
        return npx.layer_norm(x, None if self.gamma is None else self.gamma.data(),
                              None if self.beta is None else self.beta.data(),
                              axis=self._axis, eps=self._eps)

    def __repr__(self):
        return f"LayerNorm(axis={self._axis})"


class RMSNorm(HybridBlock):
    def __init__(self, axis: int = -1, epsilon: float = 1e-6, scale: bool = True,
                 in_channels: int = 0, dtype=onp.float32):
        super().__init__()
        self._axis = axis
        self._eps = epsilon
        self.gamma = Parameter("gamma", shape=(in_channels or 0,), dtype=dtype, init="ones",
                               allow_deferred_init=True) if scale else None

    def forward(self, x):
        _finish((self.gamma,), (x.shape[self._axis],))
        return npx.rms_norm(x, None if self.gamma is None else self.gamma.data(),
                            axis=self._axis, eps=self._eps)


class GroupNorm(HybridBlock):
    def __init__(self, num_groups: int = 1, epsilon: float = 1e-5, center: bool = True,
                 scale: bool = True, in_channels: int = 0, beta_initializer="zeros",
                 gamma_initializer="ones", dtype=onp.float32):
        super().__init__()
        self._num_groups = num_groups
        self._eps = epsilon
        ch = in_channels or 0
        self.gamma = Parameter("gamma", shape=(ch,), dtype=dtype, init=gamma_initializer,
                               allow_deferred_init=True)
        self.beta = Parameter("beta", shape=(ch,), dtype=dtype, init=beta_initializer,
                              allow_deferred_init=True)

    def forward(self, x):
        _finish((self.gamma, self.beta), (x.shape[1],))
        return npx.group_norm(x, self.gamma.data(), self.beta.data(),
                              num_groups=self._num_groups, eps=self._eps)


class InstanceNorm(HybridBlock):
    def __init__(self, axis: int = 1, epsilon: float = 1e-5, center: bool = True,
                 scale: bool = True, in_channels: int = 0, beta_initializer="zeros",
                 gamma_initializer="ones", dtype=onp.float32):
        super().__init__()
        self._eps = epsilon
        ch = in_channels or 0
        self.gamma = Parameter("gamma", shape=(ch,), dtype=dtype, init=gamma_initializer,
                               allow_deferred_init=True)
        self.beta = Parameter("beta", shape=(ch,), dtype=dtype, init=beta_initializer,
                              allow_deferred_init=True)

    def forward(self, x):
        _finish((self.gamma, self.beta), (x.shape[1],))
        return npx.instance_norm(x, self.gamma.data(), self.beta.data(), eps=self._eps)


class Identity(HybridBlock):
    def forward(self, x):
        return x


class Lambda(Block):
    """An arbitrary function as a layer."""

    def __init__(self, function):
        super().__init__()
        self._fn = function

    def forward(self, *args):
        return self._fn(*args)


class HybridLambda(HybridBlock):
    def __init__(self, function):
        super().__init__()
        self._fn = function

    def forward(self, *args):
        return self._fn(*args)


class Activation(HybridBlock):
    def __init__(self, activation: str):
        super().__init__()
        self._act = activation

    def forward(self, x):
        return npx.activation(x, self._act)

    def __repr__(self):
        return f"Activation({self._act})"


class LeakyReLU(HybridBlock):
    def __init__(self, alpha: float = 0.01):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return npx.leaky_relu(x, gamma=self._alpha, act_type="leaky")


class PReLU(HybridBlock):
    def __init__(self, alpha_initializer=None, in_channels: int = 1):
        super().__init__()
        from ... import initializer as init_mod
        self.alpha = Parameter("alpha", shape=(in_channels,),
                               init=alpha_initializer or init_mod.Constant(0.25))

    def forward(self, x):
        return npx.leaky_relu(x, act_type="prelu", alpha=self.alpha.data())


class ELU(HybridBlock):
    def __init__(self, alpha: float = 1.0):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return npx.leaky_relu(x, gamma=self._alpha, act_type="elu")


class SELU(HybridBlock):
    def forward(self, x):
        return npx.leaky_relu(x, act_type="selu")


class GELU(HybridBlock):
    def __init__(self, approximate: bool = True):
        super().__init__()
        self._approx = approximate

    def forward(self, x):
        return npx.gelu(x, approximate=self._approx)


class SiLU(HybridBlock):
    def forward(self, x):
        return npx.silu(x)


Swish = SiLU
