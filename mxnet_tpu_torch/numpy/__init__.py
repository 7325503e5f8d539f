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
            return x2._binop(x1, fn, inexact, reverse=True)
        if not isinstance(x1, NDArray) and isinstance(x1, _SCALARS) \
                and isinstance(x2, _SCALARS):
            x1 = NDArray(x1)
        return asarray(x1)._binop(x2, fn, inexact)
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
            return apply(lambda t: fn(_cast(t, _inexact(t.dtype))), _arr(x))
        return apply(fn, _arr(x))
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
    return apply(lambda t: torch.clamp(t, a_min, a_max), _arr(a))


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
    return apply_multi(fn, arrs)


def isclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    return apply_multi(lambda x, y: torch.isclose(x, _cast(y, x.dtype), rtol, atol, equal_nan),
                       [_arr(a), _arr(b)])


def allclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    return bool(asarray(isclose(a, b, rtol, atol, equal_nan)).all())


# ------------------------------------------------------------- reductions

def sum(a, axis=None, dtype=None, keepdims=False, **kw):
    _no_out(kw, "sum")
    return apply(lambda x: t_sum(x, axis, dtype, keepdims), _arr(a))


def mean(a, axis=None, dtype=None, keepdims=False, **kw):
    _no_out(kw, "mean")
    return apply(lambda x: t_mean(x, axis, dtype, keepdims), _arr(a))


def prod(a, axis=None, dtype=None, keepdims=False):
    return apply(lambda x: t_prod(x, axis, dtype, keepdims), _arr(a))


def std(a, axis=None, dtype=None, ddof=0, keepdims=False):
    return apply(lambda x: t_var(x, axis, keepdims, ddof, torch.std), _arr(a))


def var(a, axis=None, dtype=None, ddof=0, keepdims=False):
    return apply(lambda x: t_var(x, axis, keepdims, ddof, torch.var), _arr(a))


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
    return apply(lambda x: t_cum(torch.cumsum, x, axis, dtype), _arr(a))


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
                       [_arr(o) for o in operands])


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
