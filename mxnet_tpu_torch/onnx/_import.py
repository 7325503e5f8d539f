"""ONNX import: parse a ``.onnx`` protobuf and run its graph with torch
operators on a chosen device (counterpart of ``mxnet_tpu/onnx/_import.py``,
which evaluates it with jax.numpy).

It covers the op set both exporters emit (the layer-tree converters and
the traced ATen path) plus the common feedforward surface, with the JAX
importer's semantics op by op, so files of either package run here and
export -> import round trips validate numerically with no onnx or
onnxruntime package.

``import_model(path, device=None)`` returns an :class:`OnnxModel`, a
callable whose ``__call__(*inputs)`` runs the graph eagerly on its device
(default: the current device) and returns NDArrays.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as onp
import torch

from ..base import MXNetError
from ._proto import parse_message

__all__ = ["import_model", "OnnxModel"]

_ONNX_TO_NP = {
    1: "float32", 2: "uint8", 3: "int8", 5: "int16", 6: "int32", 7: "int64",
    9: "bool", 10: "float16", 11: "float64", 16: "bfloat16",
}
_TORCH = {"float32": torch.float32, "uint8": torch.uint8, "int8": torch.int8,
          "int16": torch.int16, "int32": torch.int32, "int64": torch.int64,
          "bool": torch.bool, "float16": torch.float16, "float64": torch.float64,
          "bfloat16": torch.bfloat16}


def _s(b) -> str:
    return b.decode("utf-8")


def _parse_tensor(data: bytes):
    """(name, host tensor) of a TensorProto with raw data."""
    m = parse_message(data)
    dims = [int(d) for d in m.get(1, [])]
    dtype = _ONNX_TO_NP[int(m[2][0])]
    name = _s(m[8][0]) if 8 in m else ""
    if 9 not in m:
        raise MXNetError("ONNX import: only raw_data tensors are supported")
    raw = bytearray(m[9][0])
    if dtype == "bfloat16":
        t = torch.frombuffer(raw, dtype=torch.int16).view(torch.bfloat16) if raw \
            else torch.empty(0, dtype=torch.bfloat16)
        return name, t.reshape(dims)
    arr = onp.frombuffer(bytes(raw), dtype=onp.dtype(dtype)).reshape(dims)
    return name, torch.from_numpy(arr.copy())


def _signed(v: int) -> int:
    """A varint read as a two's-complement int64 (a negative axis)."""
    return v - (1 << 64) if v >= 1 << 63 else v


def _parse_attr(data: bytes):
    m = parse_message(data)
    name = _s(m[1][0])
    atype = int(m[20][0]) if 20 in m else None
    if atype == 1:      # FLOAT
        v = float(m[2][0])
    elif atype == 2:    # INT
        v = _signed(int(m[3][0]))
    elif atype == 3:    # STRING
        v = _s(m[4][0])
    elif atype == 4:    # TENSOR
        v = _parse_tensor(m[5][0])[1]
    elif atype == 6:    # FLOATS
        v = [float(x) for x in m.get(7, [])]
    elif atype == 7:    # INTS
        v = [_signed(int(x)) for x in m.get(8, [])]
    else:
        v = None
    return name, v


class _Node:
    __slots__ = ("op", "inputs", "outputs", "attrs", "name")

    def __init__(self, data: bytes):
        m = parse_message(data)
        self.inputs = [_s(b) for b in m.get(1, [])]
        self.outputs = [_s(b) for b in m.get(2, [])]
        self.name = _s(m[3][0]) if 3 in m else ""
        self.op = _s(m[4][0])
        self.attrs = dict(_parse_attr(a) for a in m.get(5, []))


def _parse_value_info(data: bytes) -> str:
    return _s(parse_message(data)[1][0])


class OnnxModel:
    """A parsed ONNX graph, run eagerly with torch operators on ``device``.
    Initializers are moved to the device once; shape-like initializers
    (Reshape's shape, Slice's starts, ...) are read on the host."""

    def __init__(self, model_bytes: bytes, device=None):
        from ..device import Device, current_device
        model = parse_message(model_bytes)
        graph = parse_message(model[7][0])
        self.nodes: List[_Node] = [_Node(n) for n in graph.get(1, [])]
        host = dict(_parse_tensor(t) for t in graph.get(5, []))
        inits = set(host)
        self.input_names = [n for n in
                            (_parse_value_info(v) for v in graph.get(11, []))
                            if n not in inits]
        self.output_names = [_parse_value_info(v) for v in graph.get(12, [])]
        self.device = (current_device() if device is None else Device(device)).torch_device
        self.initializers: Dict[str, torch.Tensor] = {}
        for k, v in host.items():
            t = v.to(self.device)
            t._host = v             # shape-like reads stay on the host
            self.initializers[k] = t

    def __call__(self, *inputs):
        from ..ndarray import NDArray
        arrays = [x._data if isinstance(x, NDArray) else torch.as_tensor(
            onp.asarray(x) if not isinstance(x, torch.Tensor) else x) for x in inputs]
        arrays = [a.to(self.device) for a in arrays]
        with torch.no_grad():
            outs = [NDArray._new(o) for o in self._run(arrays)]
        return outs[0] if len(outs) == 1 else outs

    def _run(self, arrays):
        env: Dict[str, object] = {"": None}
        env.update(self.initializers)
        for name, a in zip(self.input_names, arrays):
            env[name] = a
        for node in self.nodes:
            fn = _OPS.get(node.op)
            if fn is None:
                raise MXNetError(f"ONNX import: unsupported op {node.op!r}")
            out = fn(node, *[env[i] for i in node.inputs])
            outs = out if isinstance(out, (list, tuple)) else [out]
            for name, o in zip(node.outputs, outs):
                env[name] = o
        return [env[n] for n in self.output_names]


def import_model(path: str, device=None) -> OnnxModel:
    """The ONNX file at ``path`` as an :class:`OnnxModel` on ``device``
    (default: the current device)."""
    with open(path, "rb") as f:
        return OnnxModel(f.read(), device=device)


# ---------------------------------------------------------------- op impls

_OPS: Dict[str, callable] = {}


def op(*names):
    def deco(fn):
        for n in names:
            _OPS[n] = fn
        return fn
    return deco


def _ints(x) -> List[int]:
    """A shape-like input as host ints (an initializer's host copy, else the
    tensor read back)."""
    h = getattr(x, "_host", None)
    t = h if h is not None else torch.as_tensor(x).detach().cpu()
    return [int(v) for v in t.reshape(-1).tolist()]


def _all_axes(a, axes):
    return tuple(range(a.dim())) if axes is None else tuple(int(x) for x in axes)


def _unary(name, fn):
    _OPS[name] = lambda n, a: fn(a)


for _name, _fn in (("Neg", torch.neg), ("Abs", torch.abs), ("Exp", torch.exp),
                   ("Log", torch.log), ("Sqrt", torch.sqrt), ("Tanh", torch.tanh),
                   ("Erf", torch.erf), ("Sigmoid", torch.sigmoid), ("Cos", torch.cos),
                   ("Sin", torch.sin), ("IsNaN", torch.isnan), ("Identity", lambda a: a),
                   ("Reciprocal", lambda a: 1.0 / a), ("Relu", lambda a: torch.clamp_min(a, 0)),
                   ("Softsign", lambda a: a / (1 + torch.abs(a))),
                   ("Softplus", lambda a: torch.logaddexp(a, torch.zeros_like(a))),
                   ("Not", torch.logical_not)):
    _unary(_name, _fn)

for _name, _fn in (("Add", torch.add), ("Sub", torch.sub), ("Mul", torch.mul),
                   ("Div", torch.true_divide), ("Pow", torch.pow), ("Less", torch.lt),
                   ("LessOrEqual", torch.le), ("Greater", torch.gt),
                   ("GreaterOrEqual", torch.ge), ("Equal", torch.eq),
                   ("And", torch.logical_and), ("Or", torch.logical_or)):
    _OPS[_name] = (lambda f: lambda n, a, b: f(a, b))(_fn)


@op("Max")
def _max(n, *xs):
    out = xs[0]
    for x in xs[1:]:
        out = torch.maximum(out, x)
    return out


@op("Min")
def _min(n, *xs):
    out = xs[0]
    for x in xs[1:]:
        out = torch.minimum(out, x)
    return out


@op("LeakyRelu")
def _leaky(n, a):
    return torch.where(a > 0, a, n.attrs.get("alpha", 0.01) * a)


@op("Elu")
def _elu(n, a):
    return torch.where(a > 0, a, n.attrs.get("alpha", 1.0) * (torch.exp(a) - 1))


@op("Softmax")
def _softmax(n, a):
    return torch.softmax(a, dim=n.attrs.get("axis", -1))


@op("Cast")
def _cast(n, a):
    return a.to(_TORCH[_ONNX_TO_NP[int(n.attrs["to"])]])


@op("Where")
def _where(n, c, a, b):
    return torch.where(c, a, b)


@op("IsInf")
def _isinf(n, a):
    neg = n.attrs.get("detect_negative", 1)
    pos = n.attrs.get("detect_positive", 1)
    if neg and pos:
        return torch.isinf(a)
    if pos:
        return torch.isposinf(a)
    if neg:
        return torch.isneginf(a)
    return torch.zeros(a.shape, dtype=torch.bool, device=a.device)


@op("Mod")
def _mod(n, a, b):
    if n.attrs.get("fmod", 0):
        return torch.fmod(a, b)       # C fmod: truncate toward zero
    return torch.remainder(a, b)      # integer semantics: divisor's sign


@op("Reshape")
def _reshape(n, a, shape):
    shp = _ints(shape)
    # ONNX semantics: 0 = copy the corresponding input dim (allowzero=0)
    if not n.attrs.get("allowzero", 0):
        shp = [a.shape[i] if s == 0 else s for i, s in enumerate(shp)]
    return a.reshape(shp)


@op("Transpose")
def _transpose(n, a):
    perm = n.attrs.get("perm")
    return a.permute(*(perm if perm is not None else reversed(range(a.dim()))))


@op("Squeeze")
def _squeeze(n, a, axes=None):
    if axes is None:
        return a.squeeze()
    return a.squeeze(tuple(_ints(axes)))


@op("Unsqueeze")
def _unsqueeze(n, a, axes):
    out = a
    for ax in sorted(_ints(axes)):
        out = out.unsqueeze(ax)
    return out


@op("Expand")
def _expand(n, a, shape):
    return a.broadcast_to(torch.broadcast_shapes(tuple(a.shape), tuple(_ints(shape))))


@op("Concat")
def _concat(n, *xs):
    return torch.cat(xs, dim=n.attrs["axis"])


@op("Slice")
def _slice(n, a, starts, ends, axes=None, steps=None):
    starts, ends = _ints(starts), _ints(ends)
    axes_l = list(range(len(starts))) if axes is None else _ints(axes)
    steps_l = [1] * len(starts) if steps is None else _ints(steps)
    for s, e, ax, st in zip(starts, ends, axes_l, steps_l):
        ax = ax % a.dim()
        idx = range(*slice(s, e if e < onp.iinfo(onp.int32).max else None,
                           st).indices(a.shape[ax]))
        if st == 1:
            a = a.narrow(ax, idx.start, len(idx))
        else:
            a = a.index_select(ax, torch.tensor(list(idx), dtype=torch.int64,
                                                device=a.device))
    return a


@op("Pad")
def _pad(n, a, pads, value=None):
    p = _ints(pads)
    nd = a.dim()
    flat = [v for i in reversed(range(nd)) for v in (p[i], p[nd + i])]
    cv = 0 if value is None else float(torch.as_tensor(value).reshape(()).item())
    return torch.nn.functional.pad(a, flat, value=cv)


@op("Gather")
def _gather(n, a, idx):
    ax = n.attrs.get("axis", 0) % a.dim()
    idx = idx.to(torch.int64)
    out = a.index_select(ax, idx.reshape(-1))
    return out.reshape(a.shape[:ax] + idx.shape + a.shape[ax + 1:])


@op("GatherND")
def _gather_nd(n, a, idx):
    """ONNX GatherND (batch_dims=0): indices (..., k) select pointwise over
    the leading k dims; trailing dims are taken whole."""
    if int(n.attrs.get("batch_dims", 0)) != 0:
        raise MXNetError("ONNX import: GatherND batch_dims != 0 unsupported")
    return a[tuple(idx[..., i].to(torch.int64) for i in range(idx.shape[-1]))]


@op("GatherElements")
def _gather_elements(n, a, idx):
    return torch.gather(a, int(n.attrs.get("axis", 0)), idx.to(torch.int64))


@op("Flatten")
def _flatten(n, a):
    ax = n.attrs.get("axis", 1)
    lead = int(onp.prod(a.shape[:ax])) if ax else 1
    return a.reshape(lead, -1)


@op("ReduceSum")
def _rsum(n, a, axes=None):
    return torch.sum(a, dim=_all_axes(a, None if axes is None else _ints(axes)),
                     keepdim=bool(n.attrs.get("keepdims", 1)))


def _reduce_attr(fn):
    return lambda n, a: fn(a, _all_axes(a, n.attrs.get("axes")),
                           bool(n.attrs.get("keepdims", 1)))


_OPS["ReduceMax"] = _reduce_attr(lambda a, d, k: torch.amax(a, dim=d, keepdim=k))
_OPS["ReduceMin"] = _reduce_attr(lambda a, d, k: torch.amin(a, dim=d, keepdim=k))
_OPS["ReduceMean"] = _reduce_attr(lambda a, d, k: torch.mean(a, dim=d, keepdim=k))


@op("ReduceProd")
def _rprod(n, a):
    out = a
    for d in sorted(_all_axes(a, n.attrs.get("axes")), reverse=True):
        out = torch.prod(out, dim=d, keepdim=bool(n.attrs.get("keepdims", 1)))
    return out


@op("ArgMax")
def _argmax(n, a):
    ax = n.attrs.get("axis", 0)
    return torch.argmax(a, dim=ax, keepdim=bool(n.attrs.get("keepdims", 1)))


@op("Einsum")
def _einsum(n, *xs):
    return torch.einsum(n.attrs["equation"], *xs)


@op("MatMul")
def _matmul(n, a, b):
    return a @ b


@op("Gemm")
def _gemm(n, a, b, c=None):
    alpha = n.attrs.get("alpha", 1.0)
    beta = n.attrs.get("beta", 1.0)
    if n.attrs.get("transA", 0):
        a = a.T
    if n.attrs.get("transB", 0):
        b = b.T
    y = alpha * (a @ b)
    return y if c is None else y + beta * c


def _conv_fn(nd, transpose=False):
    F = torch.nn.functional
    return [F.conv1d, F.conv2d, F.conv3d][nd - 1] if not transpose \
        else [F.conv_transpose1d, F.conv_transpose2d, F.conv_transpose3d][nd - 1]


def _spatial_pad(x, pads, nd, value=0.0):
    """``x`` padded by ONNX ``pads`` (begins, then ends) on its spatial dims."""
    flat = [v for i in reversed(range(nd)) for v in (int(pads[i]), int(pads[nd + i]))]
    return torch.nn.functional.pad(x, flat, value=value) if any(flat) else x


@op("Conv")
def _conv(n, x, w, b=None):
    nd = w.dim() - 2
    x = _spatial_pad(x, n.attrs.get("pads", [0] * (2 * nd)), nd)
    y = _conv_fn(nd)(x, w, None, stride=tuple(n.attrs.get("strides", [1] * nd)),
                     dilation=tuple(n.attrs.get("dilations", [1] * nd)),
                     groups=int(n.attrs.get("group", 1)))
    return y if b is None else y + b.reshape((1, -1) + (1,) * nd)


@op("ConvTranspose")
def _conv_transpose(n, x, w, b=None):
    """The unpadded transposed convolution, ``output_padding`` appended at
    the end of each spatial dim, then the ONNX ``pads`` cropped."""
    nd = w.dim() - 2
    if n.attrs.get("auto_pad") not in (None, "NOTSET") or n.attrs.get("output_shape"):
        raise MXNetError("ONNX import: ConvTranspose auto_pad/output_shape "
                         "not supported (explicit pads only)")
    pads = n.attrs.get("pads", [0] * (2 * nd))
    out_pad = n.attrs.get("output_padding", [0] * nd)
    y = _conv_fn(nd, True)(x, w, None, stride=tuple(n.attrs.get("strides", [1] * nd)),
                           groups=int(n.attrs.get("group", 1)),
                           dilation=tuple(n.attrs.get("dilations", [1] * nd)))
    y = _spatial_pad(y, [0] * nd + [int(p) for p in out_pad], nd)
    for i in range(nd):
        L = y.shape[2 + i]
        y = y.narrow(2 + i, int(pads[i]), L - int(pads[i]) - int(pads[nd + i]))
    return y if b is None else y + b.reshape((1, -1) + (1,) * nd)


def _pool(n, x, kind):
    kernel = tuple(n.attrs["kernel_shape"])
    nd = len(kernel)
    strides = tuple(n.attrs.get("strides", [1] * nd))
    pads = n.attrs.get("pads", [0] * (2 * nd))
    F = torch.nn.functional
    if kind == "max":
        xp = _spatial_pad(x, pads, nd, value=-float("inf"))
        return [F.max_pool1d, F.max_pool2d, F.max_pool3d][nd - 1](xp, kernel, strides)
    avg = [F.avg_pool1d, F.avg_pool2d, F.avg_pool3d][nd - 1]
    size = float(onp.prod(kernel))
    s = avg(_spatial_pad(x, pads, nd), kernel, strides) * size
    if n.attrs.get("count_include_pad", 0):
        return s / size
    cnt = avg(_spatial_pad(torch.ones_like(x), pads, nd), kernel, strides) * size
    return s / cnt


@op("MaxPool")
def _maxpool(n, x):
    return _pool(n, x, "max")


@op("AveragePool")
def _avgpool(n, x):
    return _pool(n, x, "avg")


@op("GlobalMaxPool")
def _gmaxpool(n, x):
    return torch.amax(x, dim=tuple(range(2, x.dim())), keepdim=True)


@op("GlobalAveragePool")
def _gavgpool(n, x):
    return torch.mean(x, dim=tuple(range(2, x.dim())), keepdim=True)


@op("BatchNormalization")
def _bn(n, x, gamma, beta, mean, var):
    eps = n.attrs.get("epsilon", 1e-5)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    inv = 1.0 / torch.sqrt(var + eps)
    return (x - mean.reshape(shape)) * (inv * gamma).reshape(shape) + beta.reshape(shape)


@op("LayerNormalization")
def _ln(n, x, gamma, beta=None):
    eps = n.attrs.get("epsilon", 1e-5)
    ax = n.attrs.get("axis", -1)
    m = torch.mean(x, dim=ax, keepdim=True)
    v = torch.var(x, dim=ax, keepdim=True, unbiased=False)
    y = (x - m) / torch.sqrt(v + eps) * gamma
    return y if beta is None else y + beta


@op("Dropout")
def _dropout(n, x, *rest):
    return x


@op("Split")
def _split(n, x, split=None):
    axis = n.attrs.get("axis", 0)
    if split is None:
        return list(torch.split(x, x.shape[axis] // len(n.outputs), dim=axis))
    return list(torch.split(x, _ints(split), dim=axis))
