"""The models' layers: ``Dense``, ``LayerNorm``, ``RMSNorm``, ``Embedding``
and ``Dropout`` as ``nn.Module``s with MXNet's parameter names and layouts
(the JAX package's ``gluon.nn`` layers that its GPT and Llama use):
``Dense.weight`` is (units, in). ``Dense``, ``Embedding`` and ``RMSNorm``
take the parameter dtype (bf16 models); GPT's ``LayerNorm`` keeps f32
parameters, as in the JAX package. The gluon layers with the JAX
signatures are ``gluon.nn``'s blocks."""
from __future__ import annotations

import torch
from torch import nn

from .. import autograd
from .. import numpy_extension as npx

__all__ = ["Dense", "LayerNorm", "RMSNorm", "Embedding", "Dropout"]


class Dense(nn.Module):
    """Fully connected layer, ``x @ weight.T + bias`` over the last axis."""

    def __init__(self, units: int, in_units: int, use_bias: bool = True,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(units, in_units, device=device,
                                               dtype=dtype))
        self.bias = (nn.Parameter(torch.zeros(units, device=device, dtype=dtype))
                     if use_bias else None)

    def forward(self, x):
        return torch.nn.functional.linear(x, self.weight, self.bias)


class LayerNorm(nn.Module):
    def __init__(self, in_channels: int, epsilon: float = 1e-5, device=None):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(in_channels, device=device))
        self.beta = nn.Parameter(torch.zeros(in_channels, device=device))
        self.eps = float(epsilon)

    def forward(self, x):
        return npx.layer_norm(x, self.gamma, self.beta, eps=self.eps)


class RMSNorm(nn.Module):
    """RMS normalization with a ``gamma`` gain (``npx.rms_norm``, the
    arithmetic of the gluon ``RMSNorm``): normalized in f32, rounded to x's
    dtype, then scaled."""

    def __init__(self, in_channels: int, epsilon: float = 1e-6, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(in_channels, device=device, dtype=dtype))
        self.eps = float(epsilon)

    def forward(self, x):
        return npx.rms_norm(x, self.gamma, eps=self.eps)


class Embedding(nn.Module):
    def __init__(self, input_dim: int, output_dim: int, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(input_dim, output_dim,
                                               device=device, dtype=dtype))

    def forward(self, ids):
        return torch.nn.functional.embedding(ids.long(), self.weight)


class Dropout(nn.Module):
    """Dropout at ``rate`` over the broadcast ``axes`` (``npx.dropout``):
    draws its mask from the key stream when ``module.training`` is true,
    the identity otherwise and inside :func:`autograd.predict_mode`, which
    every inference entry point enters (a model left in training mode by
    ``TrainStep`` still generates and serves without dropout)."""

    def __init__(self, rate: float, axes=()):
        super().__init__()
        self.rate = float(rate)
        self.axes = tuple(axes)

    def forward(self, x):
        return npx.dropout(x, p=self.rate, axes=self.axes,
                           training=self.training and not autograd.is_predicting())

    def extra_repr(self):
        return f"p={self.rate}"
