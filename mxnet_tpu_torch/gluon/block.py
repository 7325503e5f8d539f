"""``save_parameters`` / ``load_parameters`` of a model (counterpart of
``mxnet_tpu/gluon/block.py``'s ``Block`` methods), as functions on an
``nn.Module``: the port has no ``Block`` yet. Names are
``named_parameters()`` names, which are the JAX model's
``collect_params()`` names (``interop``), so the two packages read each
other's ``.params`` files."""
from __future__ import annotations

import torch

from .. import serialization
from ..base import MXNetError

__all__ = ["save_parameters", "load_parameters"]


def save_parameters(net: torch.nn.Module, filename: str, deduplicate: bool = False):
    """Save every parameter of ``net`` by name. A parameter shared under
    two names is saved under both, or under its first name only with
    ``deduplicate=True``."""
    data, seen = {}, set()
    for name, p in net.named_parameters(remove_duplicate=False):
        if deduplicate and id(p) in seen:
            continue
        seen.add(id(p))
        data[name] = p.detach()
    serialization.save(filename, data)


@torch.no_grad()
def load_parameters(net: torch.nn.Module, filename: str, device=None,
                    allow_missing: bool = False, ignore_extra: bool = False,
                    cast_dtype: bool = False):
    """Load ``filename`` into ``net``'s parameters, on each parameter's
    device (``device`` is accepted for the JAX signature). A loaded array
    keeps its dtype unless ``cast_dtype``, which casts it to the
    parameter's. Raises on a missing name unless ``allow_missing``, on a
    name ``net`` lacks unless ``ignore_extra``, and on a shape mismatch."""
    loaded = serialization.load(filename)
    if isinstance(loaded, list):
        raise MXNetError(f"{filename}: expected named parameter dict")
    params = dict(net.named_parameters(remove_duplicate=False))
    for name, p in params.items():
        if name not in loaded:
            if not allow_missing:
                raise MXNetError(f"load_parameters: missing parameter {name} "
                                 f"in {filename}")
            continue
        v = loaded[name]
        if tuple(v.shape) != tuple(p.shape):
            raise MXNetError(f"Parameter {name}: loaded shape {tuple(v.shape)} != "
                             f"expected {tuple(p.shape)}")
        if cast_dtype or v.dtype == p.dtype:
            p.copy_(v.to(p.dtype))
        else:
            p.data = v.to(p.device)
    if not ignore_extra:
        extra = set(loaded) - set(params)
        if extra:
            raise MXNetError(f"load_parameters: extra parameters {sorted(extra)}")
    return net
