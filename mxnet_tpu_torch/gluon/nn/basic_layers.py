"""``Dense``, ``LayerNorm``, ``Embedding`` and ``Dropout`` as ``nn.Module``s
with MXNet's parameter names and layouts (counterpart of
``mxnet_tpu/gluon/nn/basic_layers.py``): ``Dense.weight`` is (units, in).
``Dense`` and ``Embedding`` take the parameter dtype (bf16 models);
``LayerNorm`` keeps f32 parameters, as in the JAX package."""
from __future__ import annotations

import torch
from torch import nn

from ... import numpy_extension as npx
from ...base import MXNetError

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
        return torch.nn.functional.embedding(ids.long(), self.weight)


class Dropout(nn.Module):
    """Dropout at ``rate``. The identity in eval mode (``module.training``
    false) or at rate 0. The JAX package draws its training-mode masks from
    the per-site trace key stream (``numpy_extension.dropout``), which is
    not ported yet, so training mode at a rate above 0 raises instead of
    drawing other masks (ROADMAP Queue 1: the counter-hash dropout key
    stream)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x):
        if self.training and self.rate > 0.0:
            raise MXNetError(
                f"Dropout({self.rate}) in training mode needs the counter-hash "
                "dropout key stream, which is not ported yet (ROADMAP Queue 1); "
                "train at dropout 0 or call .eval()")
        return x
