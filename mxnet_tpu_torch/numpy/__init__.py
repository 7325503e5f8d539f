"""``mx.np``: the NumPy-compatible frontend of the port (counterpart of
``mxnet_tpu/numpy/__init__.py``).

Each op is a torch function run through the funnel (``ndarray.apply``), so
it is recorded inside ``autograd.record()`` and returns an ``NDArray``;
called with a raw ``torch.Tensor`` it returns a tensor. Result dtypes are
the JAX package's (``ndarray`` module docstring): creation defaults to
float32, Python lists of numbers give float32, numpy arrays keep their
dtype.
"""
from __future__ import annotations

import operator

import numpy as onp
import torch

from .. import ndarray as _nd
from ..base import MXNetError
from ..ndarray import (NDArray, _SCALARS, _cast, _inexact, _reduce, _to_tensor, apply,
                       apply_multi, to_torch_dtype, t_arg, t_cum, t_mean, t_prod, t_sum,
                       t_var)
from . import linalg, random  # noqa: F401

ndarray = NDArray

float16, float32, float64 = onp.float16, onp.float32, onp.float64
bfloat16 = "bfloat16"
int8, int16, int32, int64 = onp.int8, onp.int16, onp.int32, onp.int64
uint8, uint16, uint32, uint64 = onp.uint8, onp.uint16, onp.uint32, onp.uint64
bool_ = onp.bool_
pi, e, euler_gamma, inf, nan = onp.pi, onp.e, onp.euler_gamma, onp.inf, onp.nan
newaxis = None
integer, floating, dtype = onp.integer, onp.floating, onp.dtype


def _device(device, ctx):
    d = device or ctx
    return None if d is None else (d.torch_device if hasattr(d, "torch_device")
                                   else torch.device(d))


def _default_dtype(obj, dtype_):
    """Python numbers and lists of them default to float32 (bools stay
    bool); numpy arrays and NDArrays keep their dtype."""
    if dtype_ is not None:
        return dtype_
    if isinstance(obj, (onp.ndarray, onp.generic, NDArray, torch.Tensor)):
        return None
    leaf = obj
    while isinstance(leaf, (list, tuple)) and len(leaf):
        leaf = leaf[0]
    if isinstance(leaf, bool):
        return None
    if isinstance(leaf, (int, float)):
        return onp.float32
    return None


# ----------------------------------------------------------------- creation

def array(object, dtype=None, device=None, ctx=None):
    dev = _device(device, ctx)
    dtype = _default_dtype(object, dtype)
    if isinstance(object, NDArray):
        out = object.astype(dtype) if dtype is not None else object.copy()
        return out if dev is None else out.to_device(_nd.Device(dev))
    return NDArray(object, device=dev, dtype=dtype)


def asarray(object, dtype=None, device=None, ctx=None):
    if isinstance(object, NDArray) and (dtype is None or object.dtype == onp.dtype(dtype)):
        return object
    return array(object, dtype=dtype, device=device, ctx=ctx)


def _new(t: torch.Tensor) -> NDArray:
    return NDArray._new(t)


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(int(s) for s in shape)


def _creation(tfn):
    def op(shape, dtype=None, device=None, ctx=None, order="C"):
        dev = _device(device, ctx) or _nd.current_device().torch_device
        return _new(tfn(_shape(shape), dtype=to_torch_dtype(dtype or onp.float32), device=dev))
    op.__name__ = tfn.__name__
    return op


zeros = _creation(torch.zeros)
ones = _creation(torch.ones)
empty = _creation(torch.zeros)


def full(shape, fill_value, dtype=None, device=None, ctx=None):
    if isinstance(fill_value, NDArray):
        dt = to_torch_dtype(dtype)
        return apply(lambda v: v.to(dt or v.dtype).broadcast_to(_shape(shape)).clone(),
                     fill_value)
    if dtype is None and isinstance(fill_value, (int, float)) and not isinstance(fill_value, bool):
        dtype = onp.float32
    t = _to_tensor(onp.full(_shape(shape), fill_value, dtype=dtype), device=_device(device, ctx))
    return _new(t)


def arange(start, stop=None, step=1, dtype=None, device=None, ctx=None):
    a = onp.arange(start, stop, step, dtype=onp.float64 if dtype is None else None)
    return _new(_to_tensor(a, dtype or onp.float32, _device(device, ctx)))


def linspace(start, stop, num=50, endpoint=True, retstep=False, dtype=None, axis=0,
             device=None, ctx=None):
    out = onp.linspace(start, stop, num, endpoint=endpoint, retstep=retstep)
    arr = out[0] if retstep else out
    arr = _new(_to_tensor(arr, dtype or onp.float32, _device(device, ctx)))
    return (arr, out[1]) if retstep else arr


def logspace(start, stop, num=50, endpoint=True, base=10.0, dtype=None, axis=0,
             device=None, ctx=None):
    return _new(_to_tensor(onp.logspace(start, stop, num, endpoint=endpoint, base=base),
                           dtype or onp.float32, _device(device, ctx)))


def eye(N, M=None, k=0, dtype=None, device=None, ctx=None):
    return _new(_to_tensor(onp.eye(N, M, k), dtype or onp.float32, _device(device, ctx)))


def identity(n, dtype=None, device=None, ctx=None):
    return eye(n, dtype=dtype, device=device, ctx=ctx)


def tri(N, M=None, k=0, dtype=None, device=None, ctx=None):
    return _new(_to_tensor(onp.tri(N, M, k), dtype or onp.float32, _device(device, ctx)))


def _like(fill):
    def op(a, dtype=None, device=None):
        dt = to_torch_dtype(dtype)
        return apply(lambda x: torch.full_like(x, fill(), dtype=dt or x.dtype), _arr(a))
    return op


zeros_like = _like(lambda: 0)
ones_like = _like(lambda: 1)
empty_like = zeros_like


def full_like(a, fill_value, dtype=None, device=None):
    dt = to_torch_dtype(dtype)
    return apply(lambda x: torch.full_like(x, fill_value, dtype=dt or x.dtype), _arr(a))


def copy(a):
    return asarray(a).copy()


def from_dlpack(x):
    return NDArray(torch.from_dlpack(x))


def meshgrid(*xi, indexing="xy"):
    return apply_multi(lambda *a: tuple(torch.meshgrid(*a, indexing=indexing)),
                       [_arr(x) for x in xi])


# ------------------------------------------------------------ elementwise

def _arr(x):
    """An NDArray or tensor as it is; host data as an NDArray (a Python
    float as float64, an int as int64: the JAX package's 0-d arrays)."""
    if isinstance(x, (NDArray, torch.Tensor)):
        return x
    return NDArray(x)


def _no_out(kwargs, name):
    if kwargs.pop("out", None) is not None:
        raise MXNetError(f"mx.np.{name}: out= is not supported (arrays are functional)")


def _scalar_ok(fn):
    """``fn`` of two tensors, a Python scalar operand filled as a 0-d tensor
    of the other's dtype (on the device, so a CUDA graph can capture it)."""
    def run(a, b):
        if not torch.is_tensor(a):
            a = torch.full((), a, dtype=b.dtype, device=b.device)
        elif not torch.is_tensor(b):
            b = torch.full((), b, dtype=a.dtype, device=a.device)
        return fn(a, b)
    return run


def _binary(fn, name, inexact=False):
    """A two-operand op with the JAX package's result dtype."""
    if getattr(fn, "__module__", None) != "_operator":
        fn = _scalar_ok(fn)

    def op(x1, x2, **kwargs):
        _no_out(kwargs, name)
        if isinstance(x1, torch.Tensor) or isinstance(x2, torch.Tensor):
            return fn(x1, x2)
        if not isinstance(x1, NDArray) and isinstance(x2, NDArray):
            return x2._binop(x1, fn, inexact, reverse=True, name=name)
        if not isinstance(x1, NDArray) and isinstance(x1, _SCALARS) \
                and isinstance(x2, _SCALARS):
            x1 = NDArray(x1)
        return asarray(x1)._binop(x2, fn, inexact, name=name)
    op.__name__ = name
    return op


add = _binary(operator.add, "add")
subtract = _binary(operator.sub, "subtract")
multiply = _binary(operator.mul, "multiply")
divide = true_divide = _binary(operator.truediv, "divide", True)
floor_divide = _binary(operator.floordiv, "floor_divide")
power = _binary(operator.pow, "power")
mod = remainder = _binary(operator.mod, "mod")
maximum = _binary(torch.maximum, "maximum")
minimum = _binary(torch.minimum, "minimum")
fmax = _binary(torch.fmax, "fmax")
fmin = _binary(torch.fmin, "fmin")
arctan2 = _binary(torch.atan2, "arctan2", True)
hypot = _binary(torch.hypot, "hypot", True)
logaddexp = _binary(torch.logaddexp, "logaddexp", True)
copysign = _binary(torch.copysign, "copysign", True)
equal = _binary(operator.eq, "equal")
not_equal = _binary(operator.ne, "not_equal")
less = _binary(operator.lt, "less")
less_equal = _binary(operator.le, "less_equal")
greater = _binary(operator.gt, "greater")
greater_equal = _binary(operator.ge, "greater_equal")
logical_and = _binary(torch.logical_and, "logical_and")
logical_or = _binary(torch.logical_or, "logical_or")
logical_xor = _binary(torch.logical_xor, "logical_xor")
bitwise_and = _binary(operator.and_, "bitwise_and")
bitwise_or = _binary(operator.or_, "bitwise_or")
bitwise_xor = _binary(operator.xor, "bitwise_xor")
matmul = _binary(torch.matmul, "matmul")
dot = _binary(_nd._dot, "dot")


def _unary(fn, name, inexact=True):
    """A one-operand op, computed in the input's inexact dtype (float ops)
    or its own."""
    def op(x, **kwargs):
        _no_out(kwargs, name)
        if inexact:
            return apply(lambda t: fn(_cast(t, _inexact(t.dtype))), _arr(x), name=name)
        return apply(fn, _arr(x), name=name)
    op.__name__ = name
    return op


def _int_keep(fn):
    """Rounding ops leave integers as they are."""
    return lambda t: t if not (t.is_floating_point() or t.is_complex()) else fn(t)


for _name, _fn in (("exp", torch.exp), ("expm1", torch.expm1), ("exp2", torch.exp2),
                   ("log", torch.log), ("log2", torch.log2), ("log10", torch.log10),
                   ("log1p", torch.log1p), ("sqrt", torch.sqrt), ("cbrt",
                   lambda t: torch.sign(t) * torch.abs(t) ** (1.0 / 3.0)),
                   ("sin", torch.sin), ("cos", torch.cos), ("tan", torch.tan),
                   ("arcsin", torch.asin), ("arccos", torch.acos), ("arctan", torch.atan),
                   ("sinh", torch.sinh), ("cosh", torch.cosh), ("tanh", torch.tanh),
                   ("arcsinh", torch.asinh), ("arccosh", torch.acosh),
                   ("arctanh", torch.atanh), ("reciprocal", torch.reciprocal),
                   ("degrees", torch.rad2deg), ("radians", torch.deg2rad),
                   ("rad2deg", torch.rad2deg), ("deg2rad", torch.deg2rad),
                   ("fabs", torch.abs)):
    globals()[_name] = _unary(_fn, _name)
for _name, _fn in (("negative", torch.neg), ("positive", lambda t: t),
                   ("abs", torch.abs), ("absolute", torch.abs), ("sign", torch.sign),
                   ("square", torch.square), ("floor", _int_keep(torch.floor)),
                   ("ceil", _int_keep(torch.ceil)), ("trunc", _int_keep(torch.trunc)),
                   ("fix", _int_keep(torch.trunc)), ("rint", _int_keep(torch.round)),
                   ("bitwise_not", torch.bitwise_not), ("invert", torch.bitwise_not),
                   ("logical_not", torch.logical_not), ("isnan", torch.isnan),
                   ("isinf", torch.isinf), ("isfinite", torch.isfinite),
                   ("signbit", torch.signbit)):
    globals()[_name] = _unary(_fn, _name, False)
del _name, _fn


def around(a, decimals=0):
    return apply(_int_keep(lambda t: torch.round(t, decimals=decimals)), _arr(a))


round = round_ = around


def clip(a, a_min=None, a_max=None):
    return apply(lambda t: torch.clamp(t, a_min, a_max), _arr(a), name="clip")


def where(condition, x=None, y=None):
    """``jnp.where``: x where condition, else y (arrays promoted, a Python
    scalar weakly typed); with one argument, :func:`nonzero`."""
    if x is None and y is None:
        return nonzero(condition)
    arrs, slots = [_arr(condition)], []
    for v in (x, y):
        if isinstance(v, _SCALARS):
            slots.append(None)
        else:
            slots.append(len(arrs))
            arrs.append(_arr(v))

    def fn(c, *vals):
        xv, yv = (x if s is None else vals[s - 1] for s in slots)
        if torch.is_tensor(xv) and torch.is_tensor(yv):
            dt = torch.promote_types(xv.dtype, yv.dtype)
            xv, yv = _cast(xv, dt), _cast(yv, dt)
        elif torch.is_tensor(xv):
            xv = _cast(xv, _nd._weak(xv.dtype, yv))
        elif torch.is_tensor(yv):
            yv = _cast(yv, _nd._weak(yv.dtype, xv))
        return torch.where(_cast(c, torch.bool), xv, yv)
    return apply_multi(fn, arrs, "where")


def isclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    return apply_multi(lambda x, y: torch.isclose(x, _cast(y, x.dtype), rtol, atol, equal_nan),
                       [_arr(a), _arr(b)])


def allclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    return bool(asarray(isclose(a, b, rtol, atol, equal_nan)).all())


# ------------------------------------------------------------- reductions

def sum(a, axis=None, dtype=None, keepdims=False, **kw):
    _no_out(kw, "sum")
    return apply(lambda x: t_sum(x, axis, dtype, keepdims), _arr(a), name="sum")


def mean(a, axis=None, dtype=None, keepdims=False, **kw):
    _no_out(kw, "mean")
    return apply(lambda x: t_mean(x, axis, dtype, keepdims), _arr(a), name="mean")


def prod(a, axis=None, dtype=None, keepdims=False):
    return apply(lambda x: t_prod(x, axis, dtype, keepdims), _arr(a))


def std(a, axis=None, dtype=None, ddof=0, keepdims=False):
    return apply(lambda x: t_var(x, axis, keepdims, ddof, torch.std), _arr(a), name="std")


def var(a, axis=None, dtype=None, ddof=0, keepdims=False):
    return apply(lambda x: t_var(x, axis, keepdims, ddof, torch.var), _arr(a), name="var")


def max(a, axis=None, keepdims=False):
    return apply(lambda x: _reduce(x, torch.amax, axis, keepdims), _arr(a))


def min(a, axis=None, keepdims=False):
    return apply(lambda x: _reduce(x, torch.amin, axis, keepdims), _arr(a))


amax, amin = max, min


def argmax(a, axis=None, keepdims=False):
    return apply(lambda x: t_arg(torch.argmax, x, axis, keepdims), _arr(a))


def argmin(a, axis=None, keepdims=False):
    return apply(lambda x: t_arg(torch.argmin, x, axis, keepdims), _arr(a))


def all(a, axis=None, keepdims=False):
    return apply(lambda x: _reduce(x.bool(), torch.all, axis, keepdims), _arr(a))


def any(a, axis=None, keepdims=False):
    return apply(lambda x: _reduce(x.bool(), torch.any, axis, keepdims), _arr(a))


def cumsum(a, axis=None, dtype=None):
    return apply(lambda x: t_cum(torch.cumsum, x, axis, dtype), _arr(a), name="cumsum")


def cumprod(a, axis=None, dtype=None):
    return apply(lambda x: t_cum(torch.cumprod, x, axis, dtype), _arr(a))


def count_nonzero(a, axis=None, keepdims=False):
    return apply(lambda x: _reduce((x != 0).long(), torch.sum, axis, keepdims), _arr(a))


# -------------------------------------------------------------- products

def inner(a, b):
    return apply_multi(torch.inner, [_arr(a), _arr(b)])


def outer(a, b):
    return apply_multi(lambda x, y: torch.outer(x.reshape(-1), y.reshape(-1)),
                       [_arr(a), _arr(b)])


def tensordot(a, b, axes=2):
    return apply_multi(lambda x, y: torch.tensordot(x, y, dims=axes), [_arr(a), _arr(b)])


def einsum(subscripts, *operands):
    return apply_multi(lambda *ops: torch.einsum(subscripts, *ops),
                       [_arr(o) for o in operands], "einsum")


def trace(a, offset=0, axis1=0, axis2=1):
    return apply(lambda x: torch.diagonal(x, offset, axis1, axis2).sum(-1), _arr(a))


def diagonal(a, offset=0, axis1=0, axis2=1):
    return apply(lambda x: torch.diagonal(x, offset, axis1, axis2), _arr(a))


def diag(v, k=0):
    return apply(lambda x: torch.diag(x, k), _arr(v))


# ------------------------------------------------------------- shape ops

def reshape(a, newshape, order="C"):
    return asarray(a).reshape(newshape) if not isinstance(a, torch.Tensor) \
        else a.reshape(newshape)


def ravel(a, order="C"):
    return reshape(a, (-1,))


flatten = ravel


def transpose(a, axes=None):
    return apply(lambda x: x.permute(*(axes or tuple(reversed(range(x.dim()))))), _arr(a))


def swapaxes(a, axis1, axis2):
    return apply(lambda x: x.transpose(axis1, axis2), _arr(a))


def moveaxis(a, source, destination):
    return apply(lambda x: torch.movedim(x, source, destination), _arr(a))


def expand_dims(a, axis):
    def fn(x):
        for ax in sorted(axis if isinstance(axis, (tuple, list)) else (axis,)):
            x = x.unsqueeze(ax)
        return x
    return apply(fn, _arr(a))


def squeeze(a, axis=None):
    return apply(lambda x: x.squeeze() if axis is None else x.squeeze(axis), _arr(a))


def broadcast_to(a, shape):
    return apply(lambda x: x.broadcast_to(_shape(shape)), _arr(a))


def broadcast_arrays(*args):
    return apply_multi(lambda *a: tuple(torch.broadcast_tensors(*a)), [_arr(x) for x in args])


def _promoted(arrs):
    dt = arrs[0].dtype
    for a in arrs[1:]:
        dt = torch.promote_types(dt, a.dtype)
    return [_cast(a, dt) for a in arrs]


def concatenate(seq, axis=0):
    if axis is None:
        return apply_multi(lambda *a: torch.cat([x.reshape(-1) for x in _promoted(a)]),
                           [_arr(x) for x in seq])
    return apply_multi(lambda *a: torch.cat(_promoted(a), dim=axis),
                       [_arr(x) for x in seq])


concat = concatenate


def stack(arrays, axis=0):
    return apply_multi(lambda *a: torch.stack(_promoted(a), dim=axis),
                       [_arr(x) for x in arrays])


def vstack(tup):
    return apply_multi(lambda *a: torch.vstack(_promoted(a)), [_arr(x) for x in tup])


def hstack(tup):
    return apply_multi(lambda *a: torch.hstack(_promoted(a)), [_arr(x) for x in tup])


def dstack(tup):
    return apply_multi(lambda *a: torch.dstack(_promoted(a)), [_arr(x) for x in tup])


def column_stack(tup):
    return apply_multi(lambda *a: torch.column_stack(_promoted(a)), [_arr(x) for x in tup])


def split(ary, indices_or_sections, axis=0):
    s = indices_or_sections
    if isinstance(s, int) and ary.shape[axis] % s:
        raise MXNetError(f"split: axis of length {ary.shape[axis]} does not divide "
                         f"into {s} equal parts (use array_split)")
    return array_split(ary, s, axis)


def array_split(ary, indices_or_sections, axis=0):
    s = indices_or_sections
    s = list(s) if isinstance(s, (tuple, list)) else int(s)
    return list(apply(lambda x: tuple(torch.tensor_split(x, s, dim=axis)), _arr(ary)))


def tile(A, reps):
    return apply(lambda x: torch.tile(x, (reps,) if isinstance(reps, int) else tuple(reps)),
                 _arr(A))


def repeat(a, repeats, axis=None):
    return asarray(a).repeat(repeats, axis)


def flip(m, axis=None):
    return apply(lambda x: torch.flip(x, tuple(range(x.dim())) if axis is None else
                                      ((axis,) if isinstance(axis, int) else tuple(axis))),
                 _arr(m))


def fliplr(m):
    return flip(m, 1)


def flipud(m):
    return flip(m, 0)


def roll(a, shift, axis=None):
    return apply(lambda x: torch.roll(x, shift, axis), _arr(a))


def atleast_1d(*arys):
    out = [apply(torch.atleast_1d, _arr(a)) for a in arys]
    return out[0] if len(out) == 1 else out


def atleast_2d(*arys):
    out = [apply(torch.atleast_2d, _arr(a)) for a in arys]
    return out[0] if len(out) == 1 else out


def pad(array, pad_width, mode="constant", constant_values=0):
    if mode != "constant":
        raise MXNetError(f"pad: mode {mode!r} is not ported (constant only)")

    def fn(x):
        pw = pad_width
        if isinstance(pw, int):
            pw = [(pw, pw)] * x.dim()
        pw = [tuple(p) if isinstance(p, (tuple, list)) else (p, p) for p in pw]
        flat = [v for p in reversed(pw) for v in p]
        return torch.nn.functional.pad(x, flat, value=constant_values)
    return apply(fn, _arr(array))


# ------------------------------------------------------------- selection

def take(a, indices, axis=None, mode="clip"):
    """``jnp.take`` with ``mode='clip'`` (indices clipped into range) or
    'wrap'."""
    def fn(x, i):
        src = x.reshape(-1) if axis is None else x
        ax = 0 if axis is None else axis % x.dim()
        n = src.shape[ax]
        i = i.long()
        i = i.remainder(n) if mode == "wrap" else i.clamp(0, n - 1)
        out = torch.index_select(src, ax, i.reshape(-1))
        return out.reshape(src.shape[:ax] + tuple(i.shape) + src.shape[ax + 1:])
    return apply_multi(fn, [_arr(a), _arr(indices)])


def take_along_axis(arr, indices, axis):
    return apply_multi(lambda x, i: torch.take_along_dim(x, i.long(), dim=axis),
                       [_arr(arr), _arr(indices)])


def argsort(a, axis=-1, kind=None, order=None):
    return apply(lambda x: torch.argsort(x, dim=axis, stable=True), _arr(a))


def sort(a, axis=-1, kind=None, order=None):
    return apply(lambda x: torch.sort(x, dim=axis, stable=True)[0], _arr(a))


def searchsorted(a, v, side="left"):
    return apply_multi(lambda x, y: torch.searchsorted(x, y, right=side == "right"),
                       [_arr(a), _arr(v)])


def tril(m, k=0):
    return apply(lambda x: torch.tril(x, k), _arr(m))


def triu(m, k=0):
    return apply(lambda x: torch.triu(x, k), _arr(m))


def nonzero(a):
    return apply(lambda x: tuple(torch.nonzero(x, as_tuple=True)), _arr(a))


def argwhere(a):
    return apply(torch.argwhere, _arr(a))


def unique(ar, return_index=False, return_inverse=False, return_counts=False, axis=None):
    out = onp.unique(asarray(ar).asnumpy(), return_index, return_inverse, return_counts, axis)
    dev = asarray(ar)._data.device
    if isinstance(out, tuple):
        return tuple(NDArray(o, device=dev) for o in out)
    return NDArray(out, device=dev)


# ------------------------------------------------------------- attributes

def astype(a, dtype):
    return asarray(a).astype(dtype)


cast = astype


def shape(a):
    return tuple(asarray(a).shape)


def ndim(a):
    return asarray(a).ndim


def size(a, axis=None):
    a = asarray(a)
    return a.size if axis is None else a.shape[axis]


def isscalar(x):
    return onp.isscalar(x)


def issubdtype(a, b):
    return onp.issubdtype(a, b)


def iinfo(t):
    return onp.iinfo(t)


def finfo(t):
    return torch.finfo(to_torch_dtype(t))


def result_type(*arrays_and_dtypes):
    dts = [to_torch_dtype(a) if not isinstance(a, (NDArray, torch.Tensor)) else
           (a._data.dtype if isinstance(a, NDArray) else a.dtype) for a in arrays_and_dtypes]
    dt = dts[0]
    for d in dts[1:]:
        dt = torch.promote_types(dt, d)
    return _nd.to_numpy_dtype(dt)


def set_printoptions(*args, **kwargs):
    onp.set_printoptions(*args, **kwargs)


# ------------------------------------------------------------------- files

def save(file, arr):
    """``.npy`` file of one array."""
    onp.save(file, asarray(arr).asnumpy())


def savez(file, *args, **kwargs):
    onp.savez(file, *[asarray(a).asnumpy() for a in args],
              **{k: asarray(v).asnumpy() for k, v in kwargs.items()})


def load(file):
    """An ``.npy`` file as an NDArray, an ``.npz`` file as a dict of them."""
    out = onp.load(file, allow_pickle=False)
    if isinstance(out, onp.lib.npyio.NpzFile):
        return {k: NDArray(out[k]) for k in out.files}
    return NDArray(out)


# ===================================================================
# The rest of the JAX namespace. Each name is torch ops through the
# funnel with the JAX package's result dtype (x64 on: an integer input of
# a float op is float32, float64 from a 64-bit integer; index results
# int64 unless JAX keeps the input's); the host-NumPy tier below is a host
# round trip, as there.

from collections import namedtuple as _namedtuple  # noqa: E402

from ..device import Device, current_device  # noqa: E402,F401

UniqueAllResult = _namedtuple("UniqueAllResult",
                              ["values", "indices", "inverse_indices", "counts"])
UniqueInverseResult = _namedtuple("UniqueInverseResult", ["values", "inverse_indices"])

import builtins as _bi  # noqa: E402  (min, max, sum, range are mx.np names here)


def _f(t):
    """``t`` in the dtype a float op computes in."""
    return _cast(t, _inexact(t.dtype))


def _t(x, device=None):
    """A tensor of ``x`` (an NDArray's own, or host data on ``device``)."""
    if isinstance(x, NDArray):
        return x._data
    if isinstance(x, torch.Tensor):
        return x
    return _to_tensor(onp.asarray(x), device=device)


def _out_dev(*xs):
    for x in xs:
        if isinstance(x, NDArray):
            return x._data.device
        if isinstance(x, torch.Tensor):
            return x.device
    return None


# ------------------------------------------------------------ elementwise

def _unary_f(fn, name):
    def op(x, **kw):
        _no_out(kw, name)
        return apply(lambda t: fn(_f(t)), _arr(x), name=name)
    op.__name__ = name
    return op


def _sinc(t):
    y = torch.pi * torch.where(t == 0, torch.ones((), dtype=t.dtype, device=t.device), t)
    return torch.where(t == 0, torch.ones((), dtype=t.dtype, device=t.device), torch.sin(y) / y)


sinc = _unary_f(_sinc, "sinc")
i0 = _unary_f(torch.special.i0, "i0")
isposinf = _unary(torch.isposinf, "isposinf", False)
isneginf = _unary(torch.isneginf, "isneginf", False)


def real(val):
    return apply(lambda t: t.real if t.is_complex() else t, _arr(val))


def imag(val):
    return apply(lambda t: t.imag if t.is_complex() else torch.zeros_like(t), _arr(val))


def conj(x):
    return apply(lambda t: t.conj().resolve_conj() if t.is_complex() else t, _arr(x))


conjugate = conj


def angle(z, deg=False):
    """Complex inputs give their real dtype, floats their own, integers
    float64 (the JAX package's x64 angle)."""
    def fn(t):
        dt = t.dtype if t.is_floating_point() else torch.float64
        out = torch.angle(t) if t.is_complex() else torch.atan2(
            torch.zeros_like(t, dtype=dt), t.to(dt))
        return torch.rad2deg(out) if deg else out
    return apply(fn, _arr(z))


def nan_to_num(x, copy=True, nan=0.0, posinf=None, neginf=None):
    return apply(lambda t: torch.nan_to_num(t, nan, posinf, neginf)
                 if t.is_floating_point() else t, _arr(x))


def _binary_f(fn, name):
    """A float op of two arrays, computed in their promoted inexact dtype."""
    def op(x1, x2, **kw):
        _no_out(kw, name)

        def run(a, b):
            dt = _inexact(torch.promote_types(a.dtype, b.dtype))
            return fn(_cast(a, dt), _cast(b, dt))
        return apply_multi(run, [_arr(x1), _arr(x2)], name)
    op.__name__ = name
    return op


def _logaddexp2(a, b):
    m = torch.maximum(a, b)
    return m + torch.log2(torch.exp2(a - m) + torch.exp2(b - m))


logaddexp2 = _binary_f(_logaddexp2, "logaddexp2")
heaviside = _binary_f(torch.heaviside, "heaviside")
nextafter = _binary_f(torch.nextafter, "nextafter")
float_power = _binary_f(torch.pow, "float_power")
fmod = _binary(torch.fmod, "fmod")
gcd = _binary(torch.gcd, "gcd")
lcm = _binary(torch.lcm, "lcm")
left_shift = bitwise_left_shift = _binary(torch.bitwise_left_shift, "left_shift")
right_shift = bitwise_right_shift = _binary(torch.bitwise_right_shift, "right_shift")
bitwise_invert = invert  # noqa: F821 (defined above in the unary table)


def divmod(x1, x2):
    return floor_divide(x1, x2), mod(x1, x2)


def ldexp(x1, x2):
    return apply_multi(lambda a, b: torch.ldexp(_f(a), b), [_arr(x1), _arr(x2)])


def frexp(x):
    def fn(t):
        m, e = torch.frexp(_f(t))
        return m, e.to(torch.int32)
    return apply(fn, _arr(x))


def modf(x):
    def fn(t):
        t = _f(t)
        ip = torch.trunc(t)
        return t - ip, ip
    return apply(fn, _arr(x))


def array_equal(a1, a2, equal_nan=False):
    """A 0-d bool array: same shape and equal elements."""
    def fn(a, b):
        if a.shape != b.shape:
            return torch.zeros((), dtype=torch.bool, device=a.device)
        eq = a == b
        if equal_nan and a.is_floating_point():
            eq |= torch.isnan(a) & torch.isnan(b)
        return eq.all()
    return apply_multi(fn, [_arr(a1), _arr(a2)])


def array_equiv(a1, a2):
    """A 0-d bool array: broadcastable and equal elements."""
    def fn(a, b):
        try:
            a, b = torch.broadcast_tensors(a, b)
        except RuntimeError:
            return torch.zeros((), dtype=torch.bool, device=a.device)
        return (a == b).all()
    return apply_multi(fn, [_arr(a1), _arr(a2)])


# ------------------------------------------------------------- reductions

def _nan_fill(t, v):
    return torch.where(torch.isnan(t), torch.full((), v, dtype=t.dtype, device=t.device), t) \
        if t.is_floating_point() else t


def nansum(a, axis=None, dtype=None, keepdims=False):
    return apply(lambda x: t_sum(_nan_fill(x, 0), axis, dtype, keepdims), _arr(a))


def nanprod(a, axis=None, dtype=None, keepdims=False):
    return apply(lambda x: t_prod(_nan_fill(x, 1), axis, dtype, keepdims), _arr(a))


def _count_valid(x, axis, keepdims):
    return _reduce((~torch.isnan(x)).to(x.dtype), torch.sum, axis, keepdims)


def nanmean(a, axis=None, dtype=None, keepdims=False):
    def fn(x):
        x = _cast(x, to_torch_dtype(dtype) or _inexact(x.dtype))
        return _reduce(_nan_fill(x, 0), torch.sum, axis, keepdims) / \
            _count_valid(x, axis, keepdims)
    return apply(fn, _arr(a))


def nanvar(a, axis=None, dtype=None, ddof=0, keepdims=False):
    def fn(x):
        x = _f(x)
        n = _count_valid(x, axis, True)
        mu = _reduce(_nan_fill(x, 0), torch.sum, axis, True) / n
        d = _nan_fill(x - mu, 0)
        out = _reduce(d * d, torch.sum, axis, True) / (n - ddof)
        return out if keepdims else (out.reshape(()) if axis is None else
                                     out.squeeze(_ax_tuple(axis, x.dim())))
    return apply(fn, _arr(a))


def _ax_tuple(axis, nd):
    return tuple(a % nd for a in axis) if isinstance(axis, (tuple, list)) else (axis % nd,)


def nanstd(a, axis=None, dtype=None, ddof=0, keepdims=False):
    return apply(torch.sqrt, nanvar(a, axis, dtype, ddof, keepdims))


def nanmax(a, axis=None, keepdims=False):
    return apply(lambda x: _reduce(_nan_fill(x, -float("inf")), torch.amax, axis, keepdims)
                 if not x.is_floating_point() else torch.where(
                     _reduce(torch.isnan(x), torch.all, axis, keepdims),
                     torch.full((), float("nan"), dtype=x.dtype, device=x.device),
                     _reduce(_nan_fill(x, -float("inf")), torch.amax, axis, keepdims)),
                 _arr(a))


def nanmin(a, axis=None, keepdims=False):
    return apply(lambda x: _reduce(x, torch.amin, axis, keepdims)
                 if not x.is_floating_point() else torch.where(
                     _reduce(torch.isnan(x), torch.all, axis, keepdims),
                     torch.full((), float("nan"), dtype=x.dtype, device=x.device),
                     _reduce(_nan_fill(x, float("inf")), torch.amin, axis, keepdims)),
                 _arr(a))


def nanargmax(a, axis=None, keepdims=False):
    return apply(lambda x: t_arg(torch.argmax, _nan_fill(x, -float("inf")), axis, keepdims),
                 _arr(a))


def nanargmin(a, axis=None, keepdims=False):
    return apply(lambda x: t_arg(torch.argmin, _nan_fill(x, float("inf")), axis, keepdims),
                 _arr(a))


def nancumsum(a, axis=None, dtype=None):
    return apply(lambda x: t_cum(torch.cumsum, _nan_fill(x, 0), axis, dtype or x.dtype),
                 _arr(a))


def nancumprod(a, axis=None, dtype=None):
    return apply(lambda x: t_cum(torch.cumprod, _nan_fill(x, 1), axis, dtype or x.dtype),
                 _arr(a))


def ptp(a, axis=None, keepdims=False):
    return apply(lambda x: _reduce(x, torch.amax, axis, keepdims)
                 - _reduce(x, torch.amin, axis, keepdims), _arr(a))


def _quantile(x, q, axis, method, keepdims, nan):
    """``jnp.quantile`` with numpy's linear/lower/higher/nearest/midpoint
    interpolation over sorted values (NaNs last and skipped for the nan
    forms)."""
    x = _f(x)
    q = _cast(q, x.dtype)
    if axis is None:
        src, ax = x.reshape(-1), 0
    else:
        ax = _ax_tuple(axis, x.dim())
        keep = [d for d in range(x.dim()) if d not in ax]
        src = x.permute(*keep, *ax).reshape(*[x.shape[d] for d in keep], -1)
        src, ax = src.movedim(-1, 0), 0
    srt = torch.sort(src, dim=0).values
    n = src.shape[0]
    cnt = (~torch.isnan(src)).sum(0).to(x.dtype) if nan else \
        torch.full(src.shape[1:], n, dtype=x.dtype, device=x.device)
    qs = q.reshape((-1,) + (1,) * (src.dim() - 1))
    pos = qs * (cnt - 1)
    lo = torch.floor(pos)
    hi = torch.ceil(pos)
    if method == "lower":
        pos = lo
    elif method == "higher":
        pos = hi
    elif method == "nearest":
        pos = torch.round(pos)
    lo_i = lo.clamp(0, n - 1).long()
    hi_i = hi.clamp(0, n - 1).long()
    srt_b = srt.expand((qs.shape[0],) + srt.shape) if qs.shape[0] > 1 else srt[None]

    def take(i):
        return torch.take_along_dim(srt_b, i[:, None].expand((qs.shape[0], 1) + srt.shape[1:]),
                                    dim=1)[:, 0]
    if method in ("lower", "higher", "nearest"):
        out = take(pos.clamp(0, n - 1).long())
    elif method == "midpoint":
        out = (take(lo_i) + take(hi_i)) * 0.5
    else:
        w = pos - lo
        out = take(lo_i) * (1 - w) + take(hi_i) * w
    if not nan:
        out = torch.where(torch.isnan(srt[-1:]).expand_as(out[:1]).expand_as(out),
                          torch.full((), float("nan"), dtype=out.dtype, device=out.device), out)
    out = out.reshape(q.shape + out.shape[1:])
    if keepdims:
        shape = list(x.shape)
        for d in (range(x.dim()) if axis is None else _ax_tuple(axis, x.dim())):
            shape[d] = 1
        out = out.reshape(q.shape + tuple(shape))
    return out


def _quant_op(name, nan, scale=1.0):
    def op(a, q, axis=None, out=None, overwrite_input=False, method="linear",
           keepdims=False, interpolation=None):
        if out is not None:
            raise MXNetError(f"mx.np.{name}: out= is not supported")
        meth = interpolation or method
        return apply_multi(lambda x, qq: _quantile(x, qq / scale if scale != 1 else qq, axis,
                                                   meth, keepdims, nan),
                           [_arr(a), _arr(q) if not isinstance(q, _SCALARS)
                            else NDArray(onp.asarray(q, onp.float64))], name)
    op.__name__ = name
    return op


quantile = _quant_op("quantile", False)
nanquantile = _quant_op("nanquantile", True)
percentile = _quant_op("percentile", False, 100.0)
nanpercentile = _quant_op("nanpercentile", True, 100.0)


def median(a, axis=None, out=None, overwrite_input=False, keepdims=False):
    return quantile(a, 0.5, axis=axis, keepdims=keepdims)


def nanmedian(a, axis=None, out=None, overwrite_input=False, keepdims=False):
    return nanquantile(a, 0.5, axis=axis, keepdims=keepdims)


def average(a, axis=None, weights=None, returned=False, keepdims=False):
    if weights is None:
        avg = mean(a, axis=axis, keepdims=keepdims)

        def count(x):
            n = x.numel() if axis is None else int(onp.prod([x.shape[d] for d in _ax_tuple(
                axis, x.dim())]))
            return torch.full(avg.shape if isinstance(avg, NDArray) else avg.shape,
                              n, dtype=_inexact(x.dtype), device=x.device)
        return (avg, apply(count, _arr(a))) if returned else avg

    def fn(x, w):
        dt = _inexact(torch.promote_types(x.dtype, w.dtype))
        x, w = _cast(x, dt), _cast(w, dt)
        if axis is not None and w.dim() == 1 and x.dim() > 1:
            shape = [1] * x.dim()
            shape[axis % x.dim()] = -1
            w = w.reshape(shape)
        w = w.broadcast_to(x.shape)
        ws = _reduce(w, torch.sum, axis, keepdims)
        return _reduce(x * w, torch.sum, axis, keepdims) / ws, ws
    r = apply_multi(fn, [_arr(a), _arr(weights)])
    return r if returned else r[0]


# ------------------------------------------------------- shape and slices

def atleast_3d(*arys):
    out = [apply(torch.atleast_3d, _arr(a)) for a in arys]
    return out[0] if len(out) == 1 else out


def hsplit(ary, indices_or_sections):
    return array_split(ary, indices_or_sections, 1 if asarray(ary).ndim > 1 else 0) \
        if not isinstance(indices_or_sections, int) else split(
            ary, indices_or_sections, 1 if asarray(ary).ndim > 1 else 0)


def vsplit(ary, indices_or_sections):
    return split(ary, indices_or_sections, 0) if isinstance(indices_or_sections, int) \
        else array_split(ary, indices_or_sections, 0)


def dsplit(ary, indices_or_sections):
    return split(ary, indices_or_sections, 2) if isinstance(indices_or_sections, int) \
        else array_split(ary, indices_or_sections, 2)


def rollaxis(a, axis, start=0):
    def fn(x):
        n = x.dim()
        ax = axis % n
        st = start % (n + 1) if start < 0 else start
        if ax < st:
            st -= 1
        return torch.movedim(x, ax, st)
    return apply(fn, _arr(a))


def permute_dims(a, axes=None):
    return transpose(a, axes)


def resize(a, new_shape):
    def fn(x):
        shape = _shape(new_shape)
        n = int(onp.prod(shape))
        flat = x.reshape(-1)
        reps = -(-n // _bi.max(flat.numel(), 1))
        return flat.repeat(reps)[:n].reshape(shape)
    return apply(fn, _arr(a))


def rot90(m, k=1, axes=(0, 1)):
    return apply(lambda x: torch.rot90(x, k, list(axes)), _arr(m))


def append(arr, values, axis=None):
    return concatenate([arr, values], axis=axis) if axis is not None else concatenate(
        [ravel(_arr(arr)), ravel(_arr(values))])


def delete(arr, obj, axis=None):
    def fn(x):
        src = x.reshape(-1) if axis is None else x
        ax = 0 if axis is None else axis % x.dim()
        n = src.shape[ax]
        if isinstance(obj, slice):
            drop = onp.arange(n)[obj]
        else:
            drop = onp.asarray(obj.asnumpy() if isinstance(obj, NDArray) else obj).reshape(-1)
        keep = onp.ones(n, bool)
        keep[onp.asarray(drop, onp.int64) % _bi.max(n, 1)] = False
        idx = torch.from_numpy(onp.nonzero(keep)[0]).to(x.device)
        return torch.index_select(src, ax, idx)
    return apply(fn, _arr(arr))


def insert(arr, obj, values, axis=None):
    """numpy's insert: ``values`` before the positions ``obj`` (an int
    inserts one slice, ``values`` given the array's rank with leading axes
    and that axis moved to ``axis``)."""
    def fn(x, v):
        src = x.reshape(-1) if axis is None else x
        ax = 0 if axis is None else axis % x.dim()
        n = src.shape[ax]
        v = _cast(v, x.dtype)
        if isinstance(obj, (int, onp.integer)):
            p = int(obj) + n if obj < 0 else int(obj)
            vv = v.reshape((1,) * (src.dim() - v.dim()) + tuple(v.shape)).movedim(0, ax)
            shape = list(src.shape)
            shape[ax] = vv.shape[ax]
            vv = vv.broadcast_to(shape)
            return torch.cat([src.narrow(ax, 0, p), vv, src.narrow(ax, p, n - p)], ax)
        pos = onp.arange(n)[obj] if isinstance(obj, slice) else onp.asarray(
            obj.asnumpy() if isinstance(obj, NDArray) else obj).reshape(-1)
        pos = onp.where(pos < 0, pos + n, pos)
        k = len(pos)
        shape = list(src.shape)
        shape[ax] = k
        vv = v.broadcast_to(shape)
        order = onp.argsort(pos, kind="stable")
        new_pos = pos[order] + onp.arange(k)
        is_new = onp.zeros(n + k, bool)
        is_new[new_pos] = True
        shape[ax] = n + k
        out = torch.empty(shape, dtype=x.dtype, device=x.device)
        dev = x.device
        out = out.index_copy(ax, torch.from_numpy(onp.nonzero(~is_new)[0]).to(dev), src)
        return out.index_copy(ax, torch.from_numpy(new_pos).to(dev),
                              torch.index_select(vv, ax, torch.from_numpy(order).to(dev)))
    return apply_multi(fn, [_arr(arr), _arr(values)])


def diagflat(v, k=0):
    return apply(lambda x: torch.diagflat(x, k), _arr(v))


def row_stack(tup):
    return vstack(tup)


def trim_zeros(filt, trim="fb"):
    def fn(x):
        nz = torch.nonzero(x != 0).reshape(-1)
        if nz.numel() == 0:
            return x[:0]
        lo = int(nz[0]) if "f" in trim.lower() else 0
        hi = int(nz[-1]) + 1 if "b" in trim.lower() else x.shape[0]
        return x[lo:hi]
    return apply(fn, _arr(filt))


def flatnonzero(a):
    return apply(lambda x: torch.nonzero(x.reshape(-1)).reshape(-1), _arr(a))


def diff(a, n=1, axis=-1, prepend=None, append=None):
    arrs = [_arr(a)] + [_arr(v) for v in (prepend, append) if v is not None]

    def fn(x, *rest):
        ax = axis % x.dim()
        it = iter(rest)
        pre = next(it) if prepend is not None else None
        app = next(it) if append is not None else None

        def fit(v):
            v = _cast(v, x.dtype)
            shape = list(x.shape)
            shape[ax] = 1 if v.dim() == 0 else v.shape[ax] if v.dim() == x.dim() else 1
            return v.broadcast_to(shape) if v.dim() != x.dim() else v
        return torch.diff(x, n, ax, None if pre is None else fit(pre),
                          None if app is None else fit(app)) if x.dtype != torch.bool else \
            torch.diff(x.to(torch.uint8), n, ax).bool()
    return apply_multi(fn, arrs)


def ediff1d(ary, to_end=None, to_begin=None):
    arrs = [_arr(ary)] + [_arr(v) for v in (to_begin, to_end) if v is not None]

    def fn(x, *rest):
        d = torch.diff(x.reshape(-1))
        it = iter(rest)
        parts = []
        if to_begin is not None:
            parts.append(_cast(next(it), d.dtype).reshape(-1))
        parts.append(d)
        if to_end is not None:
            parts.append(_cast(next(it), d.dtype).reshape(-1))
        return torch.cat(parts)
    return apply_multi(fn, arrs)


def gradient(f, *varargs, axis=None, edge_order=1):
    def fn(x):
        x = _f(x)
        axes = tuple(range(x.dim())) if axis is None else _ax_tuple(axis, x.dim())
        sp = [float(v) for v in varargs] if varargs else [1.0] * len(axes)
        if len(sp) == 1 and len(axes) > 1:
            sp = sp * len(axes)
        outs = []
        for d, h in zip(axes, sp):
            n = x.shape[d]
            inner = (x.narrow(d, 2, n - 2) - x.narrow(d, 0, n - 2)) / (2 * h)
            first = (x.narrow(d, 1, 1) - x.narrow(d, 0, 1)) / h
            last = (x.narrow(d, n - 1, 1) - x.narrow(d, n - 2, 1)) / h
            outs.append(torch.cat([first, inner, last], d))
        return outs[0] if len(outs) == 1 else tuple(outs)
    r = apply(fn, _arr(f))
    return list(r) if isinstance(r, tuple) else r


def trapezoid(y, x=None, dx=1.0, axis=-1):
    arrs = [_arr(y)] + ([] if x is None else [_arr(x)])

    def fn(yy, *xx):
        yy = _f(yy)
        ax = axis % yy.dim()
        n = yy.shape[ax]
        mid = (yy.narrow(ax, 1, n - 1) + yy.narrow(ax, 0, n - 1)) * 0.5
        if xx:
            xv = _cast(xx[0], yy.dtype)
            d = torch.diff(xv, dim=ax if xv.dim() == yy.dim() else -1)
            if d.dim() == 1 and yy.dim() > 1:
                shape = [1] * yy.dim()
                shape[ax] = -1
                d = d.reshape(shape)
            return (d * mid).sum(ax)
        return (mid * dx).sum(ax)
    return apply_multi(fn, arrs)


def cross(a, b, axisa=-1, axisb=-1, axisc=-1, axis=None):
    if axis is not None:
        axisa = axisb = axisc = axis

    def fn(x, y):
        dt = torch.promote_types(x.dtype, y.dtype)
        x, y = torch.movedim(_cast(x, dt), axisa, -1), torch.movedim(_cast(y, dt), axisb, -1)
        if x.shape[-1] == 2:
            x = torch.nn.functional.pad(x, (0, 1))
        if y.shape[-1] == 2:
            y = torch.nn.functional.pad(y, (0, 1))
        x, y = torch.broadcast_tensors(x, y)
        out = torch.linalg.cross(x, y, dim=-1)
        return torch.movedim(out, -1, axisc)
    return apply_multi(fn, [_arr(a), _arr(b)])


def vdot(a, b):
    return apply_multi(lambda x, y: torch.sum(x.reshape(-1).conj() * _cast(
        y.reshape(-1), torch.promote_types(x.dtype, y.dtype))), [_arr(a), _arr(b)])


def kron(a, b):
    return apply_multi(lambda x, y: torch.kron(*_promoted([x, y])), [_arr(a), _arr(b)])


# ----------------------------------------------------- indexing, selection

def choose(a, choices, mode="raise"):
    def fn(idx, *cs):
        cs = torch.stack(torch.broadcast_tensors(*_promoted(list(cs))))
        i = idx.long()
        if mode == "wrap":
            i = i.remainder(cs.shape[0])
        else:
            i = i.clamp(0, cs.shape[0] - 1)
        i, cs0 = torch.broadcast_tensors(i, cs[0])
        return torch.gather(cs, 0, i[None]).reshape(i.shape)
    return apply_multi(fn, [_arr(a)] + [_arr(c) for c in choices])


def compress(condition, a, axis=None):
    def fn(c, x):
        src = x.reshape(-1) if axis is None else x
        ax = 0 if axis is None else axis % x.dim()
        c = c.reshape(-1).bool()
        idx = torch.nonzero(c[:src.shape[ax]]).reshape(-1)
        return torch.index_select(src, ax, idx)
    return apply_multi(fn, [_arr(condition), _arr(a)])


def extract(condition, arr):
    return apply_multi(lambda c, x: x.reshape(-1)[c.reshape(-1).bool()],
                       [_arr(condition), _arr(arr)])


def select(condlist, choicelist, default=0):
    """The first true condition's choice, ``default`` where none holds."""
    def fn(*ts):
        k = len(condlist)
        conds, chs = ts[:k], _promoted(list(ts[k:]))
        dt = chs[0].dtype
        out = torch.full((), default, device=chs[0].device).to(dt)
        for c, v in zip(reversed(conds), reversed(chs)):
            out = torch.where(c.bool(), v, out)
        return out
    return apply_multi(fn, [_arr(c) for c in condlist] + [_arr(c) for c in choicelist])


def piecewise(x, condlist, funclist, *args, **kw):
    """``funclist[i]`` (a function or a constant) where ``condlist[i]``;
    one extra function is the otherwise case. Each function sees the
    whole array (the JAX package's static-shape form)."""
    xs = asarray(x)
    conds = [asarray(c) for c in (condlist if isinstance(condlist, (list, tuple))
                                  else [condlist])]
    if len(funclist) == len(conds) + 1:
        other = asarray(logical_not(asarray(any(stack(conds), axis=0))))  # noqa: F821
        conds = conds + [other]
    out = zeros_like(xs)
    for c, f in zip(conds, funclist):
        val = f(xs, *args, **kw) if callable(f) else f
        out = where(c, val, out)
        out = out.astype(xs.dtype) if isinstance(out, NDArray) else out
    return out


def put_along_axis(arr, indices, values, axis, inplace=False, mode=None):
    def fn(x, i, v):
        i = i.long()
        v = _cast(v, x.dtype).broadcast_to(i.shape)
        return x.scatter(axis if axis is not None else 0, i, v) if axis is not None else \
            x.reshape(-1).scatter(0, i.reshape(-1), v.reshape(-1)).reshape(x.shape)
    return apply_multi(fn, [_arr(arr), _arr(indices), _arr(values)])


def argpartition(a, kth, axis=-1):
    """``jnp.argpartition``: the indices of the kth + 1 smallest in
    ascending order (ties by index), then the others by index; int32."""
    def fn(x):
        x = x.movedim(axis, -1)
        n = x.shape[-1]
        k = kth % n
        low = torch.argsort(x, dim=-1, stable=True)[..., :k + 1]
        rest = torch.ones_like(x, dtype=torch.bool).scatter(-1, low, False)
        others = torch.argsort((~rest).to(torch.uint8), dim=-1, stable=True)[..., :n - k - 1]
        return torch.cat([low, others], -1).to(torch.int32).movedim(-1, axis)
    return apply(fn, _arr(a))


def partition(a, kth, axis=-1):
    """``jnp.partition``: the kth + 1 smallest ascending, then the others
    descending."""
    def fn(x):
        x = x.movedim(axis, -1)
        n = x.shape[-1]
        k = kth % n
        srt = torch.sort(x, dim=-1, stable=True).values
        return torch.cat([srt[..., :k + 1], srt[..., k + 1:].flip(-1)], -1).movedim(-1, axis)
    return apply(fn, _arr(a))


def lexsort(keys, axis=-1):
    """Indices that sort by the last key first (stable sorts from the
    first key to the last)."""
    def fn(*ks):
        idx = None
        for k in ks:
            kk = k if idx is None else torch.take_along_dim(k, idx, dim=axis)
            o = torch.argsort(kk, dim=axis, stable=True)
            idx = o if idx is None else torch.take_along_dim(idx, o, dim=axis)
        return idx
    ks = list(keys) if isinstance(keys, (list, tuple)) else [asarray(keys)[i] for i in
                                                             range(asarray(keys).shape[0])]
    return apply_multi(fn, [_arr(k) for k in ks])


def _index_pair(rows, cols, device):
    r, c = torch.from_numpy(rows.astype(onp.int64)), torch.from_numpy(cols.astype(onp.int64))
    dev = device or current_device().torch_device
    return NDArray._new(r.to(dev)), NDArray._new(c.to(dev))


def tril_indices(n, k=0, m=None):
    return _index_pair(*onp.tril_indices(n, k, m), None)


def triu_indices(n, k=0, m=None):
    return _index_pair(*onp.triu_indices(n, k, m), None)


def tril_indices_from(arr, k=0):
    a = asarray(arr)
    return _index_pair(*onp.tril_indices(a.shape[-2], k, a.shape[-1]), a._data.device)


def triu_indices_from(arr, k=0):
    a = asarray(arr)
    return _index_pair(*onp.triu_indices(a.shape[-2], k, a.shape[-1]), a._data.device)


def diag_indices_from(arr):
    a = asarray(arr)
    i = NDArray._new(torch.arange(a.shape[0], device=a._data.device))
    return (i,) * a.ndim


def unravel_index(indices, shape):
    def fn(i):
        out, rem = [], i
        for s in reversed(shape):
            out.append(torch.remainder(rem, s))
            rem = torch.div(rem, s, rounding_mode="floor")
        return tuple(reversed(out))
    return apply(fn, _arr(indices))


def ravel_multi_index(multi_index, dims, mode="raise", order="C"):
    def fn(*ix):
        out = torch.zeros_like(ix[0])
        for i, d in zip(ix, dims):
            out = out * d + (i.clamp(0, d - 1) if mode == "clip" else i)
        return out
    return apply_multi(fn, [_arr(i) for i in multi_index])


def ix_(*args):
    n = len(args)
    return tuple(apply(lambda t, k=k: t.reshape((1,) * k + (-1,) + (1,) * (n - k - 1)), _arr(a))
                 for k, a in enumerate(args))


def indices(dimensions, dtype=None, device=None, ctx=None):
    grids = onp.indices(tuple(dimensions), dtype=onp.dtype(dtype or onp.int64))
    return _new(_to_tensor(grids, device=_device(device, ctx)))


# -------------------------------------------------------------------- sets

def _flat_unique(x):
    vals, inv, cnt = torch.unique(x.reshape(-1), sorted=True, return_inverse=True,
                                  return_counts=True)
    n = x.numel()
    first = torch.full((vals.shape[0],), n, dtype=torch.int64, device=x.device)
    first = first.scatter_reduce(0, inv, torch.arange(n, device=x.device), "amin")
    return vals, first, inv, cnt


def unique_all(x):
    a = _arr(x)
    v, i, inv, c = apply(_flat_unique, a)
    inv = apply(lambda t: t.reshape(asarray(a).shape), inv)
    return UniqueAllResult(v, i, inv, c)


def unique_inverse(x):
    r = unique_all(x)
    return UniqueInverseResult(r.values, r.inverse_indices)


def unique_values(x):
    return apply(lambda t: torch.unique(t.reshape(-1), sorted=True), _arr(x))


def union1d(ar1, ar2):
    return apply_multi(lambda a, b: torch.unique(torch.cat(_promoted([a.reshape(-1),
                                                                      b.reshape(-1)]))),
                       [_arr(ar1), _arr(ar2)])


def isin(element, test_elements, assume_unique=False, invert=False):
    return apply_multi(lambda a, b: torch.isin(*_promoted([a, b]), invert=invert),
                       [_arr(element), _arr(test_elements)])


def intersect1d(ar1, ar2, assume_unique=False, return_indices=False):
    def fn(a, b):
        a, b = _promoted([a.reshape(-1), b.reshape(-1)])
        ua, ia = _flat_unique(a)[:2]
        ub, ib = _flat_unique(b)[:2]
        m = torch.isin(ua, ub)
        vals = ua[m]
        if not return_indices:
            return vals
        pos = torch.searchsorted(ub, vals)
        return vals, ia[m], ib[pos]
    return apply_multi(fn, [_arr(ar1), _arr(ar2)])


def setdiff1d(ar1, ar2, assume_unique=False):
    return apply_multi(lambda a, b: (lambda u: u[~torch.isin(u, b.reshape(-1).to(u.dtype))])(
        torch.unique(a.reshape(-1))), [_arr(ar1), _arr(ar2)])


def setxor1d(ar1, ar2, assume_unique=False):
    def fn(a, b):
        a, b = _promoted([torch.unique(a.reshape(-1)), torch.unique(b.reshape(-1))])
        both = torch.cat([a, b])
        v, c = torch.unique(both, return_counts=True)
        return v[c == 1]
    return apply_multi(fn, [_arr(ar1), _arr(ar2)])


# ------------------------------------------------------- histograms, misc

def _edges(x, bins, rng, dt):
    if isinstance(bins, (NDArray, torch.Tensor, list, tuple, onp.ndarray)):
        return _cast(_t(bins, x.device), dt)
    lo, hi = (x.min(), x.max()) if rng is None else (
        torch.tensor(rng[0], dtype=dt, device=x.device), torch.tensor(rng[1], dtype=dt,
                                                                      device=x.device))
    lo, hi = _cast(lo, dt), _cast(hi, dt)
    same = lo == hi
    lo = torch.where(same, lo - 0.5, lo)
    hi = torch.where(same, hi + 0.5, hi)
    # jnp.linspace: start * (1 - t) + stop * t, the last edge stop itself
    t = torch.arange(bins, dtype=dt, device=x.device) / bins
    return torch.cat([lo * (1 - t) + hi * t, hi.reshape(1)])


def _bin_index(x, edges):
    nb = edges.numel() - 1
    i = torch.searchsorted(edges, x.contiguous(), right=True) - 1
    i = torch.where(x == edges[-1], torch.full_like(i, nb - 1), i)
    inside = (x >= edges[0]) & (x <= edges[-1])
    return i.clamp(0, nb - 1), inside


def histogram(a, bins=10, range=None, weights=None, density=None):
    arrs = [_arr(a)] + ([] if weights is None else [_arr(weights)])

    def fn(x, *w):
        x = x.reshape(-1)
        dt = _inexact(x.dtype)
        edges = _edges(_cast(x, dt), bins, range, dt)
        i, inside = _bin_index(_cast(x, dt), edges)
        wt = _cast(w[0].reshape(-1), dt) if w else torch.ones_like(x, dtype=dt)
        counts = torch.zeros(edges.numel() - 1, dtype=dt, device=x.device).index_add(
            0, i, torch.where(inside, wt, torch.zeros((), dtype=dt, device=x.device)))
        if density:
            counts = counts / torch.diff(edges) / counts.sum()
        return counts, edges
    return apply_multi(fn, arrs)


def histogramdd(sample, bins=10, range=None, weights=None, density=None):
    arrs = [_arr(sample)] + ([] if weights is None else [_arr(weights)])

    def fn(s, *w):
        dt = _inexact(s.dtype)
        s = _cast(s, dt)
        D = s.shape[1]
        bl = bins if isinstance(bins, (list, tuple)) else [bins] * D
        edges, flat, ok = [], torch.zeros(s.shape[0], dtype=torch.int64, device=s.device), \
            torch.ones(s.shape[0], dtype=torch.bool, device=s.device)
        for d in _bi.range(D):
            e = _edges(s[:, d], bl[d], None if range is None else range[d], dt)
            i, inside = _bin_index(s[:, d], e)
            flat = flat * (e.numel() - 1) + i
            ok &= inside
            edges.append(e)
        shape = tuple(e.numel() - 1 for e in edges)
        wt = _cast(w[0], dt) if w else torch.ones(s.shape[0], dtype=torch.int64,
                                                  device=s.device)
        wt = torch.where(ok, wt, torch.zeros((), dtype=wt.dtype, device=s.device))
        counts = torch.zeros(int(onp.prod(shape)), dtype=wt.dtype, device=s.device).index_add(
            0, flat, wt).reshape(shape)
        if density:
            counts = counts / counts.sum()
            for d, e in enumerate(edges):
                sh = [1] * D
                sh[d] = -1
                counts = counts / torch.diff(e).reshape(sh)
        return (counts,) + tuple(edges)
    r = apply_multi(fn, arrs)
    return r[0], list(r[1:])



def histogram2d(x, y, bins=10, range=None, weights=None, density=None):
    h, edges = histogramdd(stack([x, y], axis=1), bins=bins, range=range, weights=weights,
                           density=density)
    return h, edges[0], edges[1]


def bincount(x, weights=None, minlength=0, *, length=None):
    arrs = [_arr(x)] + ([] if weights is None else [_arr(weights)])

    def fn(i, *w):
        n = length if length is not None else _bi.max(int(i.max()) + 1 if i.numel() else 0,
                                                      minlength)
        i = i.long().clamp(0, _bi.max(n - 1, 0))
        if w:
            wt = _f(w[0])
            return torch.zeros(n, dtype=wt.dtype, device=i.device).index_add(0, i, wt)
        return torch.zeros(n, dtype=torch.int64, device=i.device).index_add(
            0, i, torch.ones_like(i))
    return apply_multi(fn, arrs)


def digitize(x, bins, right=False):
    def fn(v, b):
        b = _cast(b, torch.promote_types(v.dtype, b.dtype))
        v = _cast(v, b.dtype)
        if b.numel() > 1 and bool(b[-1] < b[0]):
            n = b.numel()
            return (n - torch.searchsorted(b.flip(0), v, right=not right)).to(torch.int32)
        return torch.searchsorted(b, v, right=right).to(torch.int32)
    return apply_multi(fn, [_arr(x), _arr(bins)])


def interp(x, xp, fp, left=None, right=None, period=None):
    def fn(v, xs, ys):
        dt = _inexact(torch.promote_types(torch.promote_types(v.dtype, xs.dtype), ys.dtype))
        v, xs, ys = _cast(v, dt), _cast(xs, dt), _cast(ys, dt)
        i = torch.searchsorted(xs, v.contiguous(), right=True).clamp(1, xs.numel() - 1)
        x0, x1 = xs[i - 1], xs[i]
        y0, y1 = ys[i - 1], ys[i]
        dx = x1 - x0
        t = torch.where(dx == 0, torch.zeros((), dtype=dt, device=v.device), (v - x0) / dx)
        out = y0 + t * (y1 - y0)
        lv = ys[0] if left is None else torch.full((), left, dtype=dt, device=v.device)
        rv = ys[-1] if right is None else torch.full((), right, dtype=dt, device=v.device)
        out = torch.where(v < xs[0], lv, out)
        return torch.where(v > xs[-1], rv, out)
    return apply_multi(fn, [_arr(x), _arr(xp), _arr(fp)])


def _conv1d(a, v, mode, flip):
    dt = _inexact(torch.promote_types(a.dtype, v.dtype))
    a, v = _cast(a, dt), _cast(v, dt)
    if flip:
        v = v.flip(0)
    n, m = a.numel(), v.numel()
    full = torch.nn.functional.conv1d(a.reshape(1, 1, -1), v.flip(0).reshape(1, 1, -1),
                                      padding=m - 1).reshape(-1)
    if mode == "full":
        return full
    if mode == "same":
        k = _bi.max(n, m)
        start = (m - 1) // 2 if n >= m else (n - 1) // 2
        return full[start:start + k]
    return full[_bi.min(n, m) - 1:_bi.max(n, m)]


def convolve(a, v, mode="full"):
    return apply_multi(lambda x, y: _conv1d(x, y, mode, False) if x.numel() >= y.numel()
                       else _conv1d(y, x, mode, False), [_arr(a), _arr(v)])


def correlate(a, v, mode="valid"):
    def fn(x, y):
        y = y.conj() if y.is_complex() else y
        if x.numel() >= y.numel():
            return _conv1d(x, y, mode, True)
        return _conv1d(y, x, mode, True).flip(0)
    return apply_multi(fn, [_arr(a), _arr(v)])


def polyval(p, x):
    def fn(c, v):
        dt = _inexact(torch.promote_types(c.dtype, v.dtype))
        c, v = _cast(c, dt), _cast(v, dt)
        out = torch.zeros_like(v)
        for k in _bi.range(c.shape[0]):
            out = out * v + c[k]
        return out
    return apply_multi(fn, [_arr(p), _arr(x)])


def vander(x, N=None, increasing=False):
    def fn(v):
        n = v.numel() if N is None else N
        p = torch.arange(n, device=v.device)
        if not increasing:
            p = p.flip(0)
        return torch.pow(v.reshape(-1, 1), p.to(v.dtype))
    return apply(fn, _arr(x))


def cov(m, y=None, rowvar=True, bias=False, ddof=None, fweights=None, aweights=None):
    arrs = [_arr(m)] + ([] if y is None else [_arr(y)])

    def fn(x, *yy):
        x = _f(x)
        x = x.reshape(1, -1) if x.dim() == 1 else x
        if not rowvar and x.shape[0] != 1:
            x = x.T
        if yy:
            o = _cast(yy[0], x.dtype)
            o = o.reshape(1, -1) if o.dim() == 1 else o
            if not rowvar and o.shape[0] != 1:
                o = o.T
            x = torch.cat([x, o], 0)
        d = ddof if ddof is not None else (0 if bias else 1)
        xc = x - x.mean(1, keepdim=True)
        return (xc @ xc.T.conj() / (x.shape[1] - d)).squeeze()
    return apply_multi(fn, arrs)


def corrcoef(x, y=None, rowvar=True):
    def fn(c):
        if c.dim() == 0:
            return c / c
        d = torch.sqrt(torch.diagonal(c))
        out = c / d[:, None] / d[None, :]
        return out.clamp(-1, 1)
    return apply(fn, cov(x, y, rowvar))


def can_cast(from_, to, casting="safe"):
    def npdt(d):
        if isinstance(d, (NDArray, torch.Tensor)):
            d = d.dtype
        return _nd.to_numpy_dtype(d) if isinstance(d, torch.dtype) else onp.dtype(d)
    return bool(onp.can_cast(npdt(from_), npdt(to), casting))


def promote_types(type1, type2):
    return _nd.to_numpy_dtype(torch.promote_types(to_torch_dtype(type1), to_torch_dtype(type2)))


def fill_diagonal(a, val, wrap=False):
    """The filled array (the JAX package's functional form)."""
    def fn(x, v):
        out = x.clone()
        n = _bi.min(x.shape) if x.dim() > 2 or not wrap else x.shape[1]
        if x.dim() == 2:
            rows = x.shape[0] if wrap else _bi.min(x.shape)
            step = x.shape[1] + 1
            flat = out.reshape(-1)
            idx = torch.arange(0, rows * x.shape[1], step, device=x.device)
            idx = idx[idx < flat.numel()][:n if not wrap else None]
            vals = _cast(v, x.dtype).reshape(-1)
            flat[idx] = vals.repeat(-(-idx.numel() // _bi.max(vals.numel(), 1)))[:idx.numel()]
            return flat.reshape(x.shape)
        i = torch.arange(n, device=x.device)
        out[(i,) * x.dim()] = _cast(v, x.dtype)
        return out
    return apply_multi(fn, [_arr(a), _arr(val)])


def _window(fn):
    def op(M, dtype=None):
        return _new(_to_tensor(fn(M), dtype or onp.float32))
    op.__name__ = fn.__name__
    return op


blackman, hamming, hanning = _window(onp.blackman), _window(onp.hamming), _window(onp.hanning)


def may_share_memory(a, b, max_work=None):
    """True only when the two arrays view the same storage."""
    ta, tb = _t(a) if isinstance(a, (NDArray, torch.Tensor)) else None, \
        _t(b) if isinstance(b, (NDArray, torch.Tensor)) else None
    if ta is None or tb is None:
        return a is b
    return ta.untyped_storage().data_ptr() == tb.untyped_storage().data_ptr()


shares_memory = may_share_memory


def seterr(**kwargs):
    return onp.seterr(**kwargs)


def get_include():
    return onp.get_include()


# the host-NumPy tier: a round trip through numpy, the result on the
# input's device (the JAX package's fallback tier)
def _fallback(name):
    nfn = getattr(onp, name)

    def op(*args, **kwargs):
        dev = _out_dev(*args, *kwargs.values())

        def host(v):
            return v.asnumpy() if isinstance(v, NDArray) else \
                v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
        out = nfn(*[host(a) for a in args], **{k: host(v) for k, v in kwargs.items()})

        def back(o):
            return NDArray(o, device=dev) if isinstance(o, onp.ndarray) else o
        return tuple(back(o) for o in out) if isinstance(out, tuple) else back(out)
    op.__name__ = name
    return op


for _name in ("busday_count", "is_busday", "packbits", "unpackbits", "poly", "roots",
              "polyfit", "polyadd", "polysub", "polymul", "polydiv"):
    globals()[_name] = _fallback(_name)
del _name
