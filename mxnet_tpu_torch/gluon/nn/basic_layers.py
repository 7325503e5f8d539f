"""``Dense``, ``LayerNorm``, ``Embedding`` and ``Dropout`` as ``nn.Module``s
with MXNet's parameter names and layouts (counterpart of
``mxnet_tpu/gluon/nn/basic_layers.py``): ``Dense.weight`` is (units, in)."""
from __future__ import annotations

import torch
from torch import nn

from ... import numpy_extension as npx

__all__ = ["Dense", "LayerNorm", "Embedding", "Dropout"]


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


class Embedding(nn.Module):
    def __init__(self, input_dim: int, output_dim: int, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(input_dim, output_dim,
                                               device=device, dtype=dtype))

    def forward(self, ids):
        return self.weight[ids.long()]


class Dropout(nn.Module):
    """Identity: the port serves only, and dropout is off at inference."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x):
        return x
