"""Load parameters exported from the JAX package into a model of the port.

``named`` is what ``{n: p.data().asnumpy() for n, p in
net.collect_params().items()}`` gives for a JAX ``GPTModel``: the port's
modules carry the same names (``wte.weight``, ``blocks.0.attn_qkv.weight``
(units, in), ``blocks.0.ln_1.gamma``, ...), so the two packages then hold
the same weights and quantize them to the same int8 tables.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .base import MXNetError

__all__ = ["params_from_numpy"]


def params_from_numpy(model: torch.nn.Module, named: Dict[str, np.ndarray]):
    """Copy every array of ``named`` into the parameter of the same name.
    Raises on a missing, unexpected or differently shaped parameter. Load
    before ``quantize_net``: quantization reads the loaded weights."""
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(named))
    extra = sorted(set(named) - set(params))
    if missing or extra:
        raise MXNetError(f"params_from_numpy: missing {missing[:5]}, "
                         f"unexpected {extra[:5]}")
    with torch.no_grad():
        for name, arr in named.items():
            p = params[name]
            src = torch.from_numpy(np.array(arr, copy=True))
            if tuple(src.shape) != tuple(p.shape):
                raise MXNetError(f"params_from_numpy: {name} has shape "
                                 f"{tuple(src.shape)}, the model wants "
                                 f"{tuple(p.shape)}")
            p.copy_(src.to(p.dtype))
    return model
