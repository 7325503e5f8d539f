"""Gluon ``Parameter`` and ``Constant`` (counterpart of
``mxnet_tpu/gluon/parameter.py``).

A Parameter owns one NDArray with its gradient buffer; its tensor is a
leaf of the tape that requires grad. Initialization may be deferred until
the first forward infers the shape; deferred parameters draw their keys
in the order of that forward, as in the JAX package. Writes (``set_data``,
``Trainer.step``, ``load_parameters``, BatchNorm's running statistics) go
into the tensor's storage in place, so a CUDA graph that captured a
hybridized block's forward reads the new values on its next replay.

While a ``CachedOp`` infers deferred shapes (:data:`DRY`), a deferred
parameter is bound to a zero placeholder and queued instead of drawn, and
writes are dropped; the CachedOp initializes the queue afterwards. A
functional view (``parallel.functional``) binds every parameter to a value
the same way and collects its writes in ``DRY.aux`` instead. Writes
are dropped too while a forward is recomputed for its backward
(``TrainStep(remat=True)``), so BatchNorm's running statistics move once a
step.
"""
from __future__ import annotations

import threading
from typing import Optional, Tuple

import numpy as onp
import torch

from .. import _tape
from .. import initializer as init_mod
from ..base import MXNetError
from ..device import Device, current_device
from ..ndarray import NDArray, to_torch_dtype

__all__ = ["Parameter", "Constant", "DeferredInitializationError"]


class _DryRun(threading.local):
    def __init__(self):
        self.bindings = None        # {Parameter: NDArray placeholder}
        self.pending = None         # [Parameter] in first-use order
        self.aux = None             # {Parameter: value} written while bound


DRY = _DryRun()


class DeferredInitializationError(MXNetError):
    """A parameter was read before its shape was inferred."""


class Parameter:
    def __init__(self, name: Optional[str] = None, grad_req: str = "write", shape=None,
                 dtype=onp.float32, lr_mult: float = 1.0, wd_mult: float = 1.0, init=None,
                 allow_deferred_init: bool = False, differentiable: bool = True,
                 stype: str = "default", grad_stype: str = "default"):
        self._name = name or "param"
        self._shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self.grad_req = grad_req if differentiable else "null"
        self._differentiable = differentiable
        self.stype = stype
        self.grad_stype = grad_stype
        self._var: Optional[NDArray] = None
        self._deferred_init_args = None

    @property
    def name(self) -> str:
        return self._name

    @property
    def shape(self) -> Optional[Tuple[int, ...]]:
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        if new_shape is None:
            return
        new_shape = tuple(int(s) for s in new_shape)
        if self._shape is not None:
            # unknown (0 or -1) dimensions take the new size
            if len(self._shape) != len(new_shape):
                raise MXNetError(f"Parameter {self._name}: cannot reset shape "
                                 f"{self._shape} -> {new_shape}")
            merged = []
            for old, new in zip(self._shape, new_shape):
                if old in (0, -1):
                    merged.append(new)
                elif new in (0, -1) or new == old:
                    merged.append(old)
                else:
                    raise MXNetError(f"Parameter {self._name}: incompatible shape "
                                     f"{self._shape} vs {new_shape}")
            new_shape = tuple(merged)
        self._shape = new_shape

    @property
    def _shape_known(self) -> bool:
        return self._shape is not None and all(s > 0 for s in self._shape)

    # ------------------------------------------------------------------
    def initialize(self, init=None, device=None, ctx=None, default_init=None,
                   force_reinit: bool = False) -> None:
        """Allocate and initialize on ``device`` (default: the current
        device when this is called); deferred while the shape is unknown."""
        device = device or ctx
        if isinstance(device, (list, tuple)):
            device = device[0]
        device = current_device() if device is None else Device(device)
        if self._var is not None and not force_reinit:
            return
        if not self._shape_known:
            if not self.allow_deferred_init:
                raise DeferredInitializationError(
                    f"Parameter {self._name} has unknown shape {self._shape} "
                    "and allow_deferred_init=False")
            self._deferred_init_args = (init, device, default_init)
            return
        self._do_init(init, device, default_init)

    def _do_init(self, init, device: Device, default_init):
        initializer = init_mod.create(
            init if init is not None else (self.init if self.init is not None else default_init))
        arr = NDArray._new(torch.zeros(self._shape, dtype=to_torch_dtype(self.dtype),
                                       device=device.torch_device))
        initializer.init_array(init_mod.InitDesc(self._name), arr)
        arr.attach_grad(self.grad_req, stype=self.grad_stype)
        self._var = arr
        self._deferred_init_args = None

    def _finish_deferred_init(self):
        if self._var is not None or self._deferred_init_args is None:
            return
        if not self._shape_known:
            raise DeferredInitializationError(
                f"Parameter {self._name}: shape still unknown ({self._shape})")
        if DRY.bindings is not None:
            if self not in DRY.bindings:
                dev = self._deferred_init_args[1].torch_device
                DRY.bindings[self] = NDArray._new(torch.zeros(
                    self._shape, dtype=to_torch_dtype(self.dtype), device=dev))
                DRY.pending.append(self)
            return
        self._do_init(*self._deferred_init_args)

    # ------------------------------------------------------------------
    def data(self, device=None, ctx=None) -> NDArray:
        if DRY.bindings is not None and self in DRY.bindings:
            return DRY.bindings[self]
        if self._var is None:
            if self._deferred_init_args is not None:
                raise DeferredInitializationError(
                    f"Parameter {self._name} not initialized yet: shape {self._shape} "
                    "pending inference (run a forward pass)")
            raise MXNetError(f"Parameter {self._name} has not been initialized; call "
                             ".initialize() first")
        return self._var

    def list_data(self):
        return [self.data()]

    def grad(self, device=None, ctx=None) -> Optional[NDArray]:
        if self._var is None:
            raise MXNetError(f"Parameter {self._name} not initialized")
        if self._var._grad is None and self.grad_req != "null":
            raise MXNetError(f"Parameter {self._name}: grad not yet computed")
        return self._var._grad

    def list_grad(self):
        return [self.grad()]

    def list_ctx(self):
        return [self.data().device] if self._var is not None else []

    def zero_grad(self) -> None:
        if self._var is not None:
            self._var.zero_grad()

    def set_data(self, data) -> None:
        """Set the value, in place where shape and device allow. Dropped
        while a forward is recomputed for its backward
        (``_tape.STATE.recomputing``)."""
        if DRY.bindings is not None or _tape.STATE.recomputing:
            if DRY.aux is not None and self in DRY.bindings:
                DRY.aux[self] = data if isinstance(data, NDArray) else NDArray._new(data)
            return
        if self._var is None:
            arr = data if isinstance(data, NDArray) else NDArray(data)
            self.shape = arr.shape
            self._var = NDArray._new(arr._data.detach().clone())
            self._var.attach_grad(self.grad_req, stype=self.grad_stype)
            return
        self._var._write(data)

    def _load_init(self, data: NDArray, device=None, cast_dtype: bool = False):
        """Take a loaded array: its dtype unless ``cast_dtype``, written in
        place into an initialized parameter of that dtype. An initialized
        parameter keeps its device (a host array loaded into a parameter
        on the card is copied to the card)."""
        if self._shape_known and tuple(data.shape) != self._shape:
            raise MXNetError(f"Parameter {self._name}: loaded shape {tuple(data.shape)} != "
                             f"expected {self._shape}")
        self.shape = data.shape
        if cast_dtype:
            data = data.astype(self.dtype)
        else:
            self.dtype = data.dtype
        if self._var is None:
            if device is None and self._deferred_init_args is not None:
                device = self._deferred_init_args[1]
            dev = (current_device() if device is None else Device(device)).torch_device
            self._var = NDArray._new(data._data.detach().to(dev).clone())
            self._var.attach_grad(self.grad_req, stype=self.grad_stype)
            self._deferred_init_args = None
        elif data._data.dtype == self._var._data.dtype:
            self._var._write(data._data.to(self._var._data.device))
        else:
            self._var._set_data(data._data.to(self._var._data.device))

    def cast(self, dtype) -> None:
        self.dtype = dtype
        if self._var is not None:
            had_grad = self._var._grad is not None
            self._var._set_data(self._var._data.detach().to(to_torch_dtype(dtype)))
            if had_grad:
                self._var.attach_grad(self.grad_req, stype=self.grad_stype)

    def reset_ctx(self, device):
        if self._var is not None:
            self._var._set_data(self._var._data.detach().to(Device(device).torch_device))

    def var(self):
        return self.data()

    def __repr__(self):
        dt = onp.dtype(self.dtype).name if self.dtype != "bfloat16" else "bfloat16"
        return (f"Parameter {self._name} (shape={self._shape}, dtype={dt}, "
                f"grad_req={self.grad_req})")


class _ValueInit(init_mod.Initializer):
    """Restores a Constant's stored value (force_reinit round-trips)."""

    def __init__(self, value: NDArray):
        super().__init__()
        self._value = value

    def init_array(self, name, arr):
        arr._set_data(self._value._data.to(arr._data.device))


class Constant(Parameter):
    """A parameter that takes no gradient."""

    def __init__(self, value, name: Optional[str] = None):
        if not isinstance(value, NDArray):
            value = NDArray(value)
        super().__init__(name=name or "const", grad_req="null", shape=value.shape,
                         dtype=value.dtype, differentiable=False, init=_ValueInit(value))
        self._var = value
        self.value = value
