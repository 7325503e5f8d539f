"""``mx.library``: operator libraries loaded at run time (counterpart of
``mxnet_tpu/library.py``), behind the same C extension ABI
(``mxnet_tpu/src/ext_api.h``: ``MXTExtABIVersion``, ``MXTExtOpCount``,
``MXTExtOpName``, ``MXTExtOpArity``, ``MXTExtOpInferShape``,
``MXTExtOpForward`` and optionally ``MXTExtOpHasBackward`` /
``MXTExtOpBackward``), so a library built for the JAX package loads here.

A loaded op is a callable over NDArrays, also set on ``mx.npx`` under its
exported name. Its C entry points run on host buffers: the inputs are
copied to the host (from the card if they live there), the library is
called through ``ctypes``, and the outputs are copied back to the inputs'
device, where the JAX package runs the same host call as a
``pure_callback``. When the library exports a backward the op is a
``torch.autograd.Function`` whose backward makes the same round trip with
(output gradients, inputs, outputs). The round trip syncs the card, so a
loaded op cannot sit inside a captured CUDA graph.
"""
from __future__ import annotations

import ctypes
import logging
from typing import Dict, List, Tuple

import numpy as onp
import torch

from .base import MXNetError
from .ndarray import NDArray, apply_multi, asarray, to_numpy_dtype

__all__ = ["load", "loaded_libraries"]

logger = logging.getLogger(__name__)

_ABI_VERSION = 1
_MAX_NDIM = 8
_DTYPE_TO_CODE = {"float32": 0, "float64": 1, "float16": 2, "int32": 4, "int64": 5,
                  "int8": 6, "uint8": 7}
_CODE_TO_DTYPE = {v: k for k, v in _DTYPE_TO_CODE.items()}


class _ExtTensor(ctypes.Structure):
    _fields_ = [("data", ctypes.c_void_p),
                ("shape", ctypes.c_int64 * _MAX_NDIM),
                ("ndim", ctypes.c_int32),
                ("dtype", ctypes.c_int32)]


def _desc(shape, dtype, arr=None) -> _ExtTensor:
    t = _ExtTensor()
    if arr is not None:
        t.data = arr.ctypes.data_as(ctypes.c_void_p)
    for i, s in enumerate(shape):
        t.shape[i] = s
    t.ndim = len(shape)
    key = str(onp.dtype(dtype))
    if key not in _DTYPE_TO_CODE:
        raise MXNetError(f"extension ops do not support dtype {key}")
    t.dtype = _DTYPE_TO_CODE[key]
    return t


def _spec_of(t: _ExtTensor):
    return tuple(t.shape[i] for i in range(t.ndim)), onp.dtype(_CODE_TO_DTYPE[t.dtype])


class ExtensionOp:
    """One operator exported by an extension library."""

    def __init__(self, lib: "ExtensionLibrary", name: str):
        self._lib = lib
        self.name = name
        n_in, n_out = ctypes.c_int(), ctypes.c_int()
        lib._check(lib._h.MXTExtOpArity(name.encode(), ctypes.byref(n_in),
                                        ctypes.byref(n_out)), f"{name}: arity")
        self.n_in, self.n_out = n_in.value, n_out.value
        self.has_backward = bool(getattr(lib._h, "MXTExtOpHasBackward", None)
                                 and lib._h.MXTExtOpHasBackward(name.encode()))

    def _infer(self, in_specs) -> List[Tuple[Tuple[int, ...], onp.dtype]]:
        ins = (_ExtTensor * self.n_in)(*[_desc(s, d) for s, d in in_specs])
        outs = (_ExtTensor * self.n_out)()
        self._lib._check(self._lib._h.MXTExtOpInferShape(self.name.encode(), ins, self.n_in,
                                                         outs, self.n_out),
                         f"{self.name}: infer_shape")
        return [_spec_of(outs[i]) for i in range(self.n_out)]

    def _run_host(self, entry, host_ins, out_specs):
        """Call a C entry point on host numpy buffers; returns the outputs."""
        ins = [onp.ascontiguousarray(a) for a in host_ins]
        outs = [onp.empty(s, d) for s, d in out_specs]
        in_descs = (_ExtTensor * len(ins))(*[_desc(a.shape, a.dtype, a) for a in ins])
        out_descs = (_ExtTensor * len(outs))(*[_desc(a.shape, a.dtype, a) for a in outs])
        self._lib._check(entry(self.name.encode(), in_descs, len(ins), out_descs, len(outs)),
                         f"{self.name}: execute")
        return outs

    def _forward(self, vals):
        host = [v.detach().cpu().numpy() for v in vals]
        outs = self._run_host(self._lib._h.MXTExtOpForward, host,
                              self._infer([(a.shape, a.dtype) for a in host]))
        return tuple(torch.from_numpy(o).to(vals[0].device) for o in outs)

    def _backward(self, gs, vals, outs):
        args = [t.detach().cpu().numpy() for t in tuple(gs) + tuple(vals) + tuple(outs)]
        grads = self._run_host(self._lib._h.MXTExtOpBackward, args,
                               [(tuple(v.shape), to_numpy_dtype(v.dtype)) for v in vals])
        return tuple(torch.from_numpy(g).to(v.device) for g, v in zip(grads, vals))

    def __call__(self, *inputs):
        if len(inputs) != self.n_in:
            raise MXNetError(f"{self.name} expects {self.n_in} inputs, got {len(inputs)}")
        nds = [x if isinstance(x, NDArray) else asarray(x) for x in inputs]
        fn = (lambda *v: _ExtFunction.apply(self, *v)) if self.has_backward else \
            (lambda *v: self._forward(v))
        out = apply_multi(fn, nds, name=f"ext::{self.name}")
        if self.n_out == 1 and isinstance(out, tuple):
            return out[0]
        return out

    def __repr__(self):
        return (f"ExtensionOp({self.name}, n_in={self.n_in}, n_out={self.n_out}, "
                f"backward={self.has_backward})")


class _ExtFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, op, *vals):
        outs = op._forward(vals)
        ctx.op = op
        ctx.save_for_backward(*(vals + outs))
        ctx.n_in = len(vals)
        return outs

    @staticmethod
    def backward(ctx, *gs):
        saved = ctx.saved_tensors
        vals, outs = saved[:ctx.n_in], saved[ctx.n_in:]
        return (None,) + ctx.op._backward(gs, vals, outs)


class ExtensionLibrary:
    def __init__(self, path: str):
        self.path = path
        try:
            self._h = ctypes.CDLL(path)
        except OSError as e:
            raise MXNetError(f"cannot load extension {path}: {e}")
        for sym in ("MXTExtABIVersion", "MXTExtOpCount", "MXTExtOpName", "MXTExtOpArity",
                    "MXTExtOpInferShape", "MXTExtOpForward"):
            if not hasattr(self._h, sym):
                raise MXNetError(f"{path}: missing required symbol {sym}")
        self._h.MXTExtOpName.restype = ctypes.c_char_p
        ver = self._h.MXTExtABIVersion()
        if ver != _ABI_VERSION:
            raise MXNetError(f"{path}: extension ABI {ver} != framework ABI {_ABI_VERSION}")
        self.ops: Dict[str, ExtensionOp] = {}
        for i in range(self._h.MXTExtOpCount()):
            name = self._h.MXTExtOpName(i).decode()
            self.ops[name] = ExtensionOp(self, name)
            setattr(self, name, self.ops[name])
        logger.info("loaded extension %s: ops %s", path, sorted(self.ops))

    def _check(self, ret: int, what: str):
        if ret != 0:
            raise MXNetError(f"extension {self.path}: {what} failed")

    def __repr__(self):
        return f"ExtensionLibrary({self.path}, ops={sorted(self.ops)})"


_LOADED: Dict[str, ExtensionLibrary] = {}


def load(path: str, verbose: bool = True) -> ExtensionLibrary:
    """Load an extension library: a handle whose attributes are its ops,
    each also set on ``mx.npx`` unless that name is taken."""
    if path in _LOADED:
        return _LOADED[path]
    lib = ExtensionLibrary(path)
    _LOADED[path] = lib
    from . import numpy_extension as npx
    for name, op in lib.ops.items():
        if hasattr(npx, name):
            logger.warning("extension op %r shadows an existing npx attribute; keeping "
                           "the builtin", name)
            continue
        setattr(npx, name, op)
    return lib


def loaded_libraries() -> List[str]:
    return sorted(_LOADED)
