"""``mx.operator``: the reference's Python custom-operator API
(counterpart of ``mxnet_tpu/operator.py``): ``CustomOp`` and
``CustomOpProp`` with ``register`` and ``get``, dispatched by
``npx.Custom`` / ``nd.Custom`` with ``op_type=``.

A custom op's body is Python over numpy buffers, as in the JAX package
(whose body is a host callback): the inputs are copied to the host, the
body fills host outputs, and the results are copied back to the inputs'
device, the card included. A ``torch.autograd.Function`` stands where the
JAX package has a ``custom_vjp``: inside ``autograd.record()`` the
backward runs the Prop's operator's ``backward`` on the host the same way
(the forward is run again first, as the JAX package's does). The host
round trip syncs the card, so a custom op cannot sit inside a captured
CUDA graph (a ``hybridize(static_alloc=True)`` block on the card).
"""
from __future__ import annotations

from typing import Dict, List, Type

import numpy as onp
import torch

from .base import MXNetError

__all__ = ["CustomOp", "CustomOpProp", "register", "get"]

_REGISTRY: Dict[str, Type["CustomOpProp"]] = {}


class CustomOp:
    """The op's body: ``forward`` and ``backward`` over numpy arrays."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst, req, src):
        """Write ``src`` into ``dst`` under the request ``req``."""
        if req in ("write", "inplace", None):
            dst[...] = onp.asarray(src)
        elif req == "add":
            dst[...] = dst + onp.asarray(src)
        elif req == "null":
            pass
        else:
            raise MXNetError(f"unknown req {req!r}")


class CustomOpProp:
    """The op's description: arguments, outputs, shape and type inference
    and the operator it creates."""

    def __init__(self, need_top_grad: bool = True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self) -> List[str]:
        return ["data"]

    def list_outputs(self) -> List[str]:
        return ["output"]

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]], []

    def infer_type(self, in_type):
        return in_type, [in_type[0]] * len(self.list_outputs()), []

    def create_operator(self, ctx, shapes, dtypes) -> CustomOp:
        raise NotImplementedError


def register(op_type: str):
    """Decorator: register a ``CustomOpProp`` under ``op_type``."""
    def deco(cls):
        _REGISTRY[op_type] = cls
        return cls
    return deco


def get(op_type: str) -> Type[CustomOpProp]:
    if op_type not in _REGISTRY:
        raise MXNetError(f"Custom: op_type {op_type!r} is not registered "
                         f"(known: {sorted(_REGISTRY)})")
    return _REGISTRY[op_type]


def _host(t: torch.Tensor) -> onp.ndarray:
    return t.detach().cpu().numpy()


class _CustomFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, *vals):
        ctx.run = run
        ctx.save_for_backward(*vals)
        outs = run.forward([_host(v) for v in vals])
        return tuple(torch.from_numpy(o).to(vals[0].device) for o in outs)

    @staticmethod
    def backward(ctx, *gs):
        vals = ctx.saved_tensors
        grads = ctx.run.backward([_host(v) for v in vals], [_host(g) for g in gs])
        return (None,) + tuple(torch.from_numpy(g).to(v.device) for g, v in zip(grads, vals))


class _HostRun:
    """One call's operator and its shapes and types."""

    def __init__(self, op, in_shapes, in_types, out_shapes, out_types):
        self.op = op
        self.in_specs = list(zip(in_shapes, in_types))
        self.out_specs = list(zip(out_shapes, out_types))

    def forward(self, ins):
        outs = [onp.zeros(s, d) for s, d in self.out_specs]
        self.op.forward(True, ["write"] * len(outs), ins, outs, [])
        return outs

    def backward(self, ins, gs):
        outs = self.forward(ins)
        grads = [onp.zeros(s, d) for s, d in self.in_specs]
        self.op.backward(["write"] * len(ins), gs, ins, outs, grads, [])
        return grads


def invoke_custom(*inputs, op_type: str, **kwargs):
    """Run a registered custom op (the ``Custom`` operator's dispatch).
    Returns one output or a list."""
    from . import numpy as mnp
    from .ndarray import apply_multi

    prop = get(op_type)(**kwargs) if kwargs else get(op_type)()
    arrays = [mnp.asarray(x) for x in inputs]
    in_shapes = [list(a.shape) for a in arrays]
    _, out_shapes, _ = prop.infer_shape(in_shapes)
    in_types = [a.dtype for a in arrays]
    _, out_types, _ = prop.infer_type(in_types)
    op = prop.create_operator(None, in_shapes, in_types)
    run = _HostRun(op, in_shapes, in_types, out_shapes, out_types)
    n_out = len(prop.list_outputs())
    outs = apply_multi(lambda *vals: _CustomFunction.apply(run, *vals), arrays,
                       name=f"Custom[{op_type}]")
    if n_out == 1:
        return outs[0] if isinstance(outs, (list, tuple)) else outs
    return list(outs)
