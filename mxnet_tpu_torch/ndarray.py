"""NDArray: the imperative n-dim array of the port (counterpart of
``mxnet_tpu/ndarray.py``).

An :class:`NDArray` wraps one ``torch.Tensor``. Every frontend op goes
through one funnel, :func:`apply_multi` (with :func:`apply` and
:func:`invoke` on top), which runs the op's function on the tensors under
``torch.set_grad_enabled(autograd.is_recording())``: PyTorch's graph is
the tape (``_tape.py``) and holds only what ran inside ``record()``.

Result dtypes are the JAX package's, which runs with ``jax_enable_x64``:
Python scalars are weakly typed (``int32 * 2`` stays int32, ``int32 *
2.0`` is float64), integer inputs of a float op go to float32 (float64
from a 64-bit integer), and integer sums are int64.

A call whose array arguments include a raw ``torch.Tensor`` runs in
PyTorch's own terms instead: NDArrays among the arguments give their
tensors, the result is a tensor and autograd follows the ambient grad
mode. So a gluon block called on tensors is a function of its parameters'
tensors (leaves that require grad), and PyTorch's ``backward`` fills
their ``.grad``.

Arrays are dense; ``row_sparse`` gradients wait for a later slice
(ROADMAP Queue 1).
"""
from __future__ import annotations

import operator
import weakref
from typing import Callable, Optional, Sequence, Tuple

import numpy as onp
import torch

from . import _tape
from .base import MXNetError
from .device import Device, current_device

__all__ = ["NDArray", "apply", "apply_multi", "invoke", "asarray", "waitall",
           "to_torch_dtype", "to_numpy_dtype"]

_GRAD_REQS = ("null", "write", "add")

# ------------------------------------------------------------------ dtypes

_T2N = {torch.float16: onp.float16, torch.float32: onp.float32,
        torch.float64: onp.float64, torch.int8: onp.int8, torch.int16: onp.int16,
        torch.int32: onp.int32, torch.int64: onp.int64, torch.uint8: onp.uint8,
        torch.bool: onp.bool_, torch.complex64: onp.complex64,
        torch.complex128: onp.complex128}
for _name in ("uint16", "uint32", "uint64"):
    if hasattr(torch, _name):
        _T2N[getattr(torch, _name)] = getattr(onp, _name)
_N2T = {onp.dtype(v): k for k, v in _T2N.items()}


def _ml_bf16():
    try:
        import ml_dtypes
    except ImportError:
        return None
    return onp.dtype(ml_dtypes.bfloat16)


def to_torch_dtype(dt) -> Optional[torch.dtype]:
    """A torch dtype from a torch dtype, numpy dtype or type, or a name."""
    if dt is None or isinstance(dt, torch.dtype):
        return dt
    if isinstance(dt, str) and dt == "bfloat16":
        return torch.bfloat16
    ndt = onp.dtype(dt)
    if ndt.name == "bfloat16":
        return torch.bfloat16
    if ndt not in _N2T:
        raise MXNetError(f"unsupported dtype {dt!r}")
    return _N2T[ndt]


def to_numpy_dtype(dt: torch.dtype):
    """The numpy dtype of a torch dtype (bfloat16: ``ml_dtypes``'s where it
    is installed, else the torch dtype)."""
    if dt == torch.bfloat16:
        return _ml_bf16() or torch.bfloat16
    return onp.dtype(_T2N[dt])


def _inexact(dt: torch.dtype) -> torch.dtype:
    """The dtype a float op computes in: floats keep theirs, 64-bit
    integers give float64, smaller integers and bool float32."""
    if dt.is_floating_point or dt.is_complex:
        return dt
    return torch.float64 if dt.itemsize == 8 else torch.float32


def _sum_dtype(dt: torch.dtype) -> torch.dtype:
    return torch.int64 if not (dt.is_floating_point or dt.is_complex) else dt


def _weak(dt: torch.dtype, s) -> torch.dtype:
    """Result dtype of an array of ``dt`` with the Python scalar ``s``."""
    if isinstance(s, bool):
        return dt
    if isinstance(s, int):
        return torch.int64 if dt == torch.bool else dt
    if isinstance(s, float):
        return dt if dt.is_floating_point or dt.is_complex else torch.float64
    if isinstance(s, complex):
        return dt if dt.is_complex else torch.complex128
    raise TypeError(type(s))


def _cast(t: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    return t if t.dtype == dt else t.to(dt)


_SCALARS = (bool, int, float, complex)


def _to_tensor(obj, dtype=None, device=None) -> torch.Tensor:
    """A tensor of host data (numpy, lists, scalars) on ``device``
    (default: the current device)."""
    dev = current_device().torch_device if device is None else device
    tdt = to_torch_dtype(dtype)
    a = onp.asarray(obj)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(onp.ascontiguousarray(a).view(onp.int16).copy()).view(torch.bfloat16)
    elif a.dtype == object:
        raise MXNetError(f"cannot make an array of {type(obj).__name__}")
    else:
        if tdt is not None and tdt != torch.bfloat16 and a.dtype != onp.dtype(_T2N[tdt]):
            a = a.astype(_T2N[tdt])
        t = torch.from_numpy(onp.array(a, copy=True))
    if tdt is not None:
        t = _cast(t, tdt)
    return t.to(dev)


# ------------------------------------------------------------------ the funnel

def _wrap(out):
    if isinstance(out, (tuple, list)):
        return tuple(_wrap(o) for o in out)
    if isinstance(out, torch.Tensor):
        return NDArray._new(out)
    return out


def apply_multi(fn: Callable, arrays: Sequence):
    """Run ``fn`` on the tensors of ``arrays`` and wrap its tensor outputs
    (one, or a tuple) as NDArrays, recording when ``autograd.record()`` is
    active. With a raw tensor among ``arrays`` the call is PyTorch's own:
    tensors out, the ambient grad mode."""
    datas, raw = [], False
    for a in arrays:
        if isinstance(a, NDArray):
            datas.append(a._data)
        else:
            raw = raw or isinstance(a, torch.Tensor)
            datas.append(a)
    if raw:
        return fn(*datas)
    rec = _tape.STATE.recording
    if torch.is_grad_enabled() == rec:
        return _wrap(fn(*datas))
    with torch.set_grad_enabled(rec):
        return _wrap(fn(*datas))


def apply(fn: Callable, *arrays):
    """:func:`apply_multi` for a function of the arrays given in order."""
    return apply_multi(fn, arrays)


def _lift(obj, arrays):
    """Replace arrays nested in ``obj`` by placeholders appended to
    ``arrays``; returns the spec :func:`_unlift` rebuilds from values."""
    if isinstance(obj, (NDArray, torch.Tensor)):
        arrays.append(obj)
        return ("arr", len(arrays) - 1)
    if isinstance(obj, (tuple, list)):
        return (type(obj).__name__, [_lift(o, arrays) for o in obj])
    if isinstance(obj, dict):
        return ("dict", {k: _lift(v, arrays) for k, v in obj.items()})
    return ("lit", obj)


def _unlift(spec, vals):
    kind, payload = spec
    if kind == "arr":
        return vals[payload]
    if kind == "tuple":
        return tuple(_unlift(s, vals) for s in payload)
    if kind == "list":
        return [_unlift(s, vals) for s in payload]
    if kind == "dict":
        return {k: _unlift(s, vals) for k, s in payload.items()}
    return payload


def invoke(fn: Callable, args: tuple, kwargs: dict):
    """Call ``fn(*args, **kwargs)`` with the arrays nested anywhere in them
    passed as tensors through the funnel (the JAX package's
    ``invoke_jnp``)."""
    arrays: list = []
    spec_a = _lift(tuple(args), arrays)
    spec_k = _lift(dict(kwargs), arrays)
    return apply_multi(lambda *v: fn(*_unlift(spec_a, v), **_unlift(spec_k, v)),
                       arrays)


def waitall() -> None:
    """Wait for all queued device work (``mx.nd.waitall``)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


# ------------------------------------------------------------------ indexing

def _torch_index(idx, device):
    """An index with NDArrays, numpy arrays and lists of ints turned into
    tensors on ``device``."""
    if isinstance(idx, NDArray):
        t = idx._data
        return t.to(device) if t.dtype == torch.bool else t.to(device=device, dtype=torch.int64)
    if isinstance(idx, torch.Tensor):
        return idx.to(device)
    if isinstance(idx, onp.ndarray):
        return _torch_index(NDArray(idx, device=device), device)
    if isinstance(idx, tuple):
        return tuple(_torch_index(i, device) for i in idx)
    if isinstance(idx, list):
        return torch.as_tensor(idx, device=device)
    return idx


def _axes(axis, ndim):
    if axis is None:
        return None
    if isinstance(axis, (tuple, list)):
        return tuple(a % ndim if ndim else a for a in axis)
    return (axis % ndim if ndim else axis,)


def _reduce(x, fn, axis, keepdims, dtype=None):
    """``fn(x, dim=..., keepdim=...)`` over ``axis`` (None: all axes)."""
    if dtype is not None:
        x = _cast(x, dtype)
    ax = _axes(axis, x.dim())
    if x.dim() == 0:
        return fn(x.reshape(1), dim=(0,), keepdim=False)
    if ax is None:
        ax = tuple(range(x.dim()))
    if len(ax) == 0:
        return x
    return fn(x, dim=ax, keepdim=keepdims)


def _over_axes(fn1):
    """A one-axis reduction (prod, argmax) over several axes."""
    def run(x, dim, keepdim):
        for d in sorted(dim, reverse=True):
            x = fn1(x, d, keepdim)
        return x
    return run


def _dot(a, b):
    """``jnp.dot``: a product with a 0-d operand, else the sum over a's
    last axis and b's last (1-d b) or second-to-last."""
    if a.dim() == 0 or b.dim() == 0:
        return a * b
    return torch.tensordot(a, b, dims=([a.dim() - 1], [max(b.dim() - 2, 0)]))


def t_sum(x, axis=None, dtype=None, keepdims=False):
    """``jnp.sum``: integer and bool sums are int64."""
    dt = to_torch_dtype(dtype) or _sum_dtype(x.dtype)
    return _reduce(x, torch.sum, axis, keepdims, dt)


def t_mean(x, axis=None, dtype=None, keepdims=False):
    dt = to_torch_dtype(dtype) or _inexact(x.dtype)
    return _reduce(x, torch.mean, axis, keepdims, dt)


def t_prod(x, axis=None, dtype=None, keepdims=False):
    dt = to_torch_dtype(dtype) or _sum_dtype(x.dtype)
    return _reduce(x, _over_axes(lambda t, d, k: torch.prod(t, dim=d, keepdim=k)),
                   axis, keepdims, dt)


def t_var(x, axis=None, keepdims=False, ddof=0, fn=torch.var):
    return _reduce(x, lambda t, dim, keepdim: fn(t, dim=dim, correction=ddof,
                                                   keepdim=keepdim),
                   axis, keepdims, _inexact(x.dtype))


def t_arg(fn, x, axis=None, keepdims=False):
    if axis is None:
        out = fn(x.reshape(-1))
        return out.reshape((1,) * x.dim()) if keepdims else out
    return fn(x, dim=axis, keepdim=keepdims)


def t_cum(fn, x, axis=None, dtype=None):
    dt = to_torch_dtype(dtype) or _sum_dtype(x.dtype)
    return fn(x.reshape(-1) if axis is None else x, dim=0 if axis is None else axis, dtype=dt)


class NDArray:
    """Imperative array over one ``torch.Tensor`` plus its autograd state."""

    __slots__ = ("_data", "_grad", "_grad_req", "_grad_fresh", "__weakref__")
    # numpy defers to the reflected operators (np.float64(2) * x)
    __array_priority__ = 1000
    __array_ufunc__ = None

    def __init__(self, data, device=None, dtype=None):
        dev = None
        if device is not None:
            dev = device.torch_device if isinstance(device, Device) else torch.device(device)
        if isinstance(data, NDArray):
            data = data._data
        if isinstance(data, torch.Tensor):
            data = data.detach()
            if dtype is not None:
                data = _cast(data, to_torch_dtype(dtype))
            if dev is not None:
                data = data.to(dev)
        else:
            data = _to_tensor(data, dtype, dev)
        self._data = data
        self._grad = None
        self._grad_req = "null"
        # set by backward, cleared by Trainer.update (stale-gradient check)
        self._grad_fresh = False

    @classmethod
    def _new(cls, t: torch.Tensor) -> "NDArray":
        obj = cls.__new__(cls)
        obj._data = t
        obj._grad = None
        obj._grad_req = "null"
        obj._grad_fresh = False
        return obj

    # ------------------------------------------------------------ meta
    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return to_numpy_dtype(self._data.dtype)

    @property
    def size(self) -> int:
        return self._data.numel()

    @property
    def ndim(self) -> int:
        return self._data.dim()

    @property
    def itemsize(self) -> int:
        return self._data.element_size()

    @property
    def device(self) -> Device:
        return Device.of(self._data)

    ctx = device
    context = device

    @property
    def stype(self) -> str:
        return "default"

    # ------------------------------------------------------------ transfers
    def asnumpy(self) -> onp.ndarray:
        """A host copy (waits for the device)."""
        t = self._data.detach().cpu()
        if t.dtype == torch.bfloat16:
            bf = _ml_bf16()
            if bf is None:
                return t.float().numpy()
            return t.view(torch.int16).numpy().view(bf)
        return t.numpy().copy()

    def item(self):
        return self._data.item()

    asscalar = item

    def tolist(self):
        return self.asnumpy().tolist()

    def wait_to_read(self) -> "NDArray":
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()
        return self

    def to_device(self, device) -> "NDArray":
        dev = Device(device) if isinstance(device, str) else device
        return NDArray._new(self._data.detach().to(dev.torch_device))

    as_in_ctx = to_device
    as_in_context = to_device

    def copyto(self, other):
        if isinstance(other, Device):
            return self.to_device(other)
        if isinstance(other, NDArray):
            other._set_data(self._data.detach().broadcast_to(other.shape).to(
                dtype=other._data.dtype, device=other._data.device))
            return other
        raise MXNetError(f"copyto: unsupported target {type(other)}")

    def copy(self) -> "NDArray":
        return NDArray._new(self._data.detach().clone())

    def astype(self, dtype, copy: bool = True) -> "NDArray":
        dt = to_torch_dtype(dtype)
        if not copy and dt == self._data.dtype:
            return self
        return apply(lambda x: x.to(dt), self)

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    def __dlpack__(self, **kwargs):
        return self._data.detach().__dlpack__(**kwargs)

    def __dlpack_device__(self):
        return self._data.__dlpack_device__()

    # ------------------------------------------------------------ autograd
    def attach_grad(self, grad_req: str = "write", stype=None) -> None:
        """Allocate the gradient buffer and make this array a leaf of the
        tape; it is detached from any recorded graph first, as in the JAX
        package."""
        if grad_req not in _GRAD_REQS:
            raise MXNetError(f"invalid grad_req {grad_req!r}")
        if stype not in (None, "default"):
            raise MXNetError(f"grad stype {stype!r} is not ported yet "
                             "(ROADMAP Queue 1: row-sparse gradients)")
        self._grad_req = grad_req
        self._make_leaf(self._data)
        self._grad = None if grad_req == "null" else \
            NDArray._new(torch.zeros_like(self._data, requires_grad=False))

    def _make_leaf(self, t: torch.Tensor) -> None:
        t = t.detach()
        if self._grad_req != "null" and (t.is_floating_point() or t.is_complex()):
            t.requires_grad_(True)
            t._mx_owner = weakref.ref(self)
        self._data = t

    def drop_grad(self) -> None:
        self._grad_req = "null"
        self._grad = None
        self._data = self._data.detach()

    @property
    def grad(self) -> Optional["NDArray"]:
        return self._grad

    def zero_grad(self) -> None:
        if self._grad is not None:
            with torch.no_grad():
                self._grad._data.zero_()

    def _accumulate_grad(self, g: torch.Tensor) -> None:
        """Write a gradient into the attached buffer in place ('write'
        overwrites, 'add' adds), so code that cached ``x.grad`` sees it."""
        g = g.detach()
        buf = self._grad
        with torch.no_grad():
            if buf is None or buf._data.shape != g.shape or buf._data.dtype != g.dtype:
                self._grad = NDArray._new(g.clone())
            elif self._grad_req == "add":
                buf._data.add_(g)
            else:
                buf._data.copy_(g)
        self._grad_fresh = True

    def backward(self, out_grad=None, retain_graph: bool = False,
                 train_mode: bool = True) -> None:
        _tape.backward([self], None if out_grad is None else [out_grad],
                       retain_graph=retain_graph)

    def detach(self) -> "NDArray":
        return NDArray._new(self._data.detach())

    # ------------------------------------------------------------ mutation
    def _set_data(self, data) -> None:
        """Rebind the value (detached from any recorded graph); an attached
        array stays a leaf of the tape."""
        if isinstance(data, NDArray):
            data = data._data
        if not isinstance(data, torch.Tensor):
            data = _to_tensor(data, device=self._data.device)
        if self._grad_req != "null":
            self._make_leaf(data)
        else:
            self._data = data.detach()

    def _write(self, data) -> None:
        """Write a value into the array's storage in place where shape,
        dtype and device allow (a CUDA graph that reads the storage then
        sees it), else rebind."""
        t = data._data if isinstance(data, NDArray) else data
        if not isinstance(t, torch.Tensor):
            t = _to_tensor(t, device=self._data.device)
        if t.shape == self._data.shape and t.device == self._data.device:
            with torch.no_grad():
                self._data.copy_(t)
        else:
            self._set_data(t.to(self._data.dtype))

    def _rebind(self, t: torch.Tensor) -> None:
        if self._grad_req != "null" and not t.requires_grad:
            self._make_leaf(t)
        else:
            self._data = t

    def __setitem__(self, idx, value) -> None:
        """Writes out of place (a clone with the slice set): a recorded
        graph keeps the old value, as the JAX package's rebind does."""
        tidx = _torch_index(idx, self._data.device)
        if isinstance(value, (onp.ndarray, onp.generic, list, torch.Tensor)):
            value = NDArray(value, device=self._data.device)

        def fn(x, *v):
            y = x.clone()
            y[tidx] = _cast(v[0], y.dtype) if v else value
            return y

        out = apply_multi(fn, [self] + ([value] if isinstance(value, NDArray) else []))
        self._rebind(out._data)

    def __getitem__(self, idx):
        tidx = _torch_index(idx, self._data.device)
        return apply(lambda x: x[tidx], self)

    def __len__(self) -> int:
        if self.ndim == 0:
            raise TypeError("len() of 0-d array")
        return self.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __bool__(self):
        return bool(self._data)

    def __int__(self):
        return int(self._data)

    def __float__(self):
        return float(self._data)

    def __index__(self):
        return int(self._data)

    def __hash__(self):
        return id(self)

    def __repr__(self):
        return f"{self.asnumpy()!r} @{self.device}"

    # ------------------------------------------------------------ shape
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        shape = tuple(int(s) for s in (shape or kwargs.get("shape", ())))
        return apply(lambda x: x.reshape(shape), self)

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        ax = axes or tuple(reversed(range(self.ndim)))
        return apply(lambda x: x.permute(*ax), self)

    @property
    def T(self):
        return self.transpose()

    def flatten(self):
        return self.reshape(-1)

    ravel = flatten

    def squeeze(self, axis=None):
        ax = _axes(axis, self.ndim)
        return apply(lambda x: x.squeeze() if ax is None else x.squeeze(ax), self)

    def expand_dims(self, axis):
        return apply(lambda x: x.unsqueeze(axis), self)

    def broadcast_to(self, shape):
        return apply(lambda x: x.broadcast_to(tuple(shape)), self)

    def slice(self, begin, end, step=None):
        """Legacy ``arr.slice(begin=..., end=...)``; None entries span the
        axis."""
        import builtins
        step = step or (None,) * len(begin)
        return self[tuple(builtins.slice(b, e, s) for b, e, s in zip(begin, end, step))]

    def repeat(self, repeats, axis=None):
        return apply(lambda x: torch.repeat_interleave(
            x.reshape(-1) if axis is None else x, repeats, dim=0 if axis is None else axis), self)

    def swapaxes(self, a1, a2):
        return apply(lambda x: x.transpose(a1, a2), self)

    def split(self, indices_or_sections, axis=0):
        s = indices_or_sections
        s = list(s) if isinstance(s, (tuple, list)) else int(s)
        return apply(lambda x: tuple(torch.tensor_split(x, s, dim=axis)), self)

    def take(self, indices, axis=None, mode="clip"):
        from . import numpy as _np
        return _np.take(self, indices, axis=axis, mode=mode)

    # ------------------------------------------------------------ reductions
    def sum(self, axis=None, dtype=None, keepdims=False):
        return apply(lambda x: t_sum(x, axis, dtype, keepdims), self)

    def mean(self, axis=None, dtype=None, keepdims=False):
        return apply(lambda x: t_mean(x, axis, dtype, keepdims), self)

    def max(self, axis=None, keepdims=False):
        return apply(lambda x: _reduce(x, torch.amax, axis, keepdims), self)

    def min(self, axis=None, keepdims=False):
        return apply(lambda x: _reduce(x, torch.amin, axis, keepdims), self)

    def prod(self, axis=None, dtype=None, keepdims=False):
        return apply(lambda x: t_prod(x, axis, dtype, keepdims), self)

    def std(self, axis=None, keepdims=False, ddof=0):
        return apply(lambda x: t_var(x, axis, keepdims, ddof, torch.std), self)

    def var(self, axis=None, keepdims=False, ddof=0):
        return apply(lambda x: t_var(x, axis, keepdims, ddof, torch.var), self)

    def argmax(self, axis=None, keepdims=False):
        return apply(lambda x: t_arg(torch.argmax, x, axis, keepdims), self)

    def argmin(self, axis=None, keepdims=False):
        return apply(lambda x: t_arg(torch.argmin, x, axis, keepdims), self)

    def cumsum(self, axis=None, dtype=None):
        return apply(lambda x: t_cum(torch.cumsum, x, axis, dtype), self)

    def clip(self, a_min=None, a_max=None):
        return apply(lambda x: torch.clamp(x, a_min, a_max), self)

    def round(self, decimals=0):
        return apply(lambda x: torch.round(x, decimals=decimals), self)

    def abs(self):
        return apply(torch.abs, self)

    def dot(self, other):
        return self._binop(other, _dot)

    def norm(self, ord=None, axis=None, keepdims=False):
        from .numpy import linalg
        return linalg.norm(self, ord=ord, axis=axis, keepdims=keepdims)

    def tostype(self, stype):
        if stype != "default":
            raise MXNetError("arrays are dense; row_sparse/csr storage is not ported "
                             "(ROADMAP Queue 1)")
        return self

    # ------------------------------------------------------------ arithmetic
    def _binop(self, other, fn, inexact=False, reverse=False):
        """``fn(self, other)`` (``fn(other, self)`` with ``reverse``) with the
        JAX package's result dtype (with ``inexact``, that dtype's float)."""
        if isinstance(other, (onp.ndarray, onp.generic, list, tuple)):
            other = NDArray(onp.asarray(other), device=self._data.device)
        if isinstance(other, (NDArray, torch.Tensor)):
            dt = torch.promote_types(self._data.dtype, other.dtype if isinstance(
                other, torch.Tensor) else other._data.dtype)
            if inexact:
                dt = _inexact(dt)
            if reverse:
                return apply_multi(lambda a, b: fn(_cast(b, dt), _cast(a, dt)),
                                   [self, other])
            return apply_multi(lambda a, b: fn(_cast(a, dt), _cast(b, dt)),
                               [self, other])
        if isinstance(other, _SCALARS):
            dt = _weak(self._data.dtype, other)
            if inexact:
                dt = _inexact(dt)
            if reverse:
                return apply(lambda a: fn(other, _cast(a, dt)), self)
            return apply(lambda a: fn(_cast(a, dt), other), self)
        return NotImplemented

    def __add__(self, o):
        return self._binop(o, operator.add)

    def __radd__(self, o):
        return self._binop(o, operator.add, reverse=True)

    def __sub__(self, o):
        return self._binop(o, operator.sub)

    def __rsub__(self, o):
        return self._binop(o, operator.sub, reverse=True)

    def __mul__(self, o):
        return self._binop(o, operator.mul)

    def __rmul__(self, o):
        return self._binop(o, operator.mul, reverse=True)

    def __truediv__(self, o):
        return self._binop(o, operator.truediv, True)

    def __rtruediv__(self, o):
        return self._binop(o, operator.truediv, True, reverse=True)

    def __floordiv__(self, o):
        return self._binop(o, operator.floordiv)

    def __rfloordiv__(self, o):
        return self._binop(o, operator.floordiv, reverse=True)

    def __mod__(self, o):
        return self._binop(o, operator.mod)

    def __rmod__(self, o):
        return self._binop(o, operator.mod, reverse=True)

    def __pow__(self, o):
        return self._binop(o, operator.pow)

    def __rpow__(self, o):
        return self._binop(o, operator.pow, reverse=True)

    def __matmul__(self, o):
        return self._binop(o, torch.matmul)

    def __rmatmul__(self, o):
        return self._binop(o, torch.matmul, reverse=True)

    def __neg__(self):
        return apply(torch.neg, self)

    def __pos__(self):
        return self

    def __abs__(self):
        return apply(torch.abs, self)

    def __eq__(self, o):
        return self._binop(o, operator.eq)

    def __ne__(self, o):
        return self._binop(o, operator.ne)

    def __lt__(self, o):
        return self._binop(o, operator.lt)

    def __le__(self, o):
        return self._binop(o, operator.le)

    def __gt__(self, o):
        return self._binop(o, operator.gt)

    def __ge__(self, o):
        return self._binop(o, operator.ge)

    def __invert__(self):
        return apply(torch.logical_not if self._data.dtype == torch.bool
                     else torch.bitwise_not, self)

    def __and__(self, o):
        return self._binop(o, operator.and_)

    def __or__(self, o):
        return self._binop(o, operator.or_)

    def __xor__(self, o):
        return self._binop(o, operator.xor)

    __rand__ = __and__
    __ror__ = __or__
    __rxor__ = __xor__

    def _inplace(self, o, fn, inexact=False):
        out = self._binop(o, fn, inexact)
        if out is NotImplemented:
            return NotImplemented
        self._rebind(out._data)
        return self

    def __iadd__(self, o):
        return self._inplace(o, operator.add)

    def __isub__(self, o):
        return self._inplace(o, operator.sub)

    def __imul__(self, o):
        return self._inplace(o, operator.mul)

    def __itruediv__(self, o):
        return self._inplace(o, operator.truediv, True)


def asarray(obj, dtype=None, device=None) -> NDArray:
    if isinstance(obj, NDArray):
        if dtype is not None and obj._data.dtype != to_torch_dtype(dtype):
            return obj.astype(dtype)
        return obj
    return NDArray(obj, device=device, dtype=dtype)
