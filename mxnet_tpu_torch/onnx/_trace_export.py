"""Traced-graph ONNX export: a block's ``torch.export`` program, decomposed
to core ATen operators, translated op by op (counterpart of
``mxnet_tpu/onnx/_trace_export.py``, which translates a jaxpr).

The layer-tree exporter (``onnx/__init__.py``) covers trees of standard
layers; this path covers everything else (custom ``forward``, residual
wiring, attention). The program is :meth:`HybridBlock.export`'s: the
functional view's inference forward (dropout is identity, BatchNorm reads
its running statistics) over (parameters..., inputs...), traced with
``torch.export`` and ``run_decompositions()``. Parameters become ONNX
initializers named after their Gluon parameter paths; tensor constants of
the program (a quantized layer's tables) become initializers too.

K1's registered operator (``mxnet_tpu_torch::flash_fwd``) translates to
attention math: ``MatMul`` of q and kᵀ, the scale, a causal ``Where``,
``Softmax`` and ``MatMul`` with v (in f32, cast back to q's dtype), so a
program traced on the card exports as well as one traced on the CPU. Every
emitted op is one the JAX package's importer runs.
"""
from __future__ import annotations

import operator
from typing import Callable, Dict, List

import numpy as onp
import torch

from ..base import MXNetError
from . import _proto as P

__all__ = ["export_traced_model"]

_ONNX_DTYPE = {torch.float32: P.DataType.FLOAT, torch.float64: P.DataType.DOUBLE,
               torch.float16: P.DataType.FLOAT16, torch.bfloat16: P.DataType.BFLOAT16,
               torch.int8: P.DataType.INT8, torch.uint8: P.DataType.UINT8,
               torch.int16: P.DataType.INT16, torch.int32: P.DataType.INT32,
               torch.int64: P.DataType.INT64, torch.bool: P.DataType.BOOL}
_NP_DTYPE = {torch.float32: onp.float32, torch.float64: onp.float64,
             torch.float16: onp.float16, torch.int8: onp.int8, torch.uint8: onp.uint8,
             torch.int16: onp.int16, torch.int32: onp.int32, torch.int64: onp.int64,
             torch.bool: onp.bool_}


def _tensor_proto(name: str, t) -> bytes:
    """A TensorProto of a tensor or array (bf16 as its raw 16-bit words)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            out = b"".join(P.f_varint(1, d) for d in t.shape)
            out += P.f_varint(2, P.DataType.BFLOAT16) + P.f_string(8, name)
            return out + P.f_bytes(9, t.contiguous().view(torch.int16).numpy().tobytes())
        t = t.numpy()
    return P.make_tensor(name, onp.asarray(t))


def _value_info(name: str, dtype: torch.dtype, shape) -> bytes:
    """ValueInfoProto with an ONNX element type taken from a torch dtype."""
    tensor = P.f_varint(1, _ONNX_DTYPE[dtype])
    if shape is not None:
        dims = b"".join(P.f_message(1, P.f_string(2, d) if isinstance(d, str)
                                    else P.f_varint(1, int(d))) for d in shape)
        tensor += P.f_message(2, dims)
    return P.f_string(1, name) + P.f_message(2, P.f_message(1, tensor))


class _Ctx:
    def __init__(self):
        self.nodes: List[bytes] = []
        self.initializers: List[bytes] = []
        self._uid = 0
        #: with a symbolic batch, the example batch size: Reshape targets
        #: take -1 in their first dim, Expand keeps a batch dim it meets
        self.dynamic_batch_size = None
        self.env: Dict[object, object] = {}

    def name(self, hint: str) -> str:
        self._uid += 1
        return f"{hint}_{self._uid}"

    def const(self, array, hint: str = "const") -> str:
        n = self.name(hint)
        self.initializers.append(_tensor_proto(n, array))
        return n

    def emit(self, op: str, inputs, n_out: int = 1, **attrs):
        outs = [self.name(op.lower()) for _ in range(n_out)]
        self.nodes.append(P.make_node(op, inputs, outs, name=self.name(op), **attrs))
        return outs[0] if n_out == 1 else outs

    def ins(self, arg, like: torch.dtype = torch.float32) -> str:
        """The ONNX name of an argument: a traced value's, or a constant of
        a Python scalar in ``like``'s dtype."""
        if isinstance(arg, torch.fx.Node):
            return self.env[arg]
        return self.const(onp.asarray(arg, dtype=_NP_DTYPE.get(like, onp.float32)), "scalar")


_RULES: Dict[object, Callable] = {}
aten = torch.ops.aten


def rule(*targets):
    def deco(fn):
        for t in targets:
            _RULES[t] = fn
        return fn
    return deco


def _val(node):
    return node.meta["val"]


def _dtype(arg):
    return _val(arg).dtype if isinstance(arg, torch.fx.Node) else torch.float32


def _like(node):
    """The dtype a scalar operand of ``node`` takes: its first tensor
    argument's."""
    for a in node.args:
        if isinstance(a, torch.fx.Node):
            return _dtype(a)
    return torch.float32


def _int64(ctx, values, hint):
    return ctx.const(onp.asarray(values, onp.int64), hint)


def _binary(op):
    def r(ctx, node):
        like = _like(node)
        a, b = (ctx.ins(x, like) for x in node.args[:2])
        alpha = node.kwargs.get("alpha", 1)
        if alpha != 1:
            b = ctx.emit("Mul", [b, ctx.ins(alpha, like)])
        return ctx.emit(op, [a, b])
    return r


for _t, _op in ((aten.add.Tensor, "Add"), (aten.sub.Tensor, "Sub"), (aten.mul.Tensor, "Mul"),
                (aten.add.Scalar, "Add"), (aten.sub.Scalar, "Sub"), (aten.mul.Scalar, "Mul"),
                (aten.pow.Tensor_Tensor, "Pow"), (aten.pow.Tensor_Scalar, "Pow"),
                (aten.maximum.default, "Max"), (aten.minimum.default, "Min"),
                (aten.lt.Tensor, "Less"), (aten.lt.Scalar, "Less"),
                (aten.le.Tensor, "LessOrEqual"), (aten.le.Scalar, "LessOrEqual"),
                (aten.gt.Tensor, "Greater"), (aten.gt.Scalar, "Greater"),
                (aten.ge.Tensor, "GreaterOrEqual"), (aten.ge.Scalar, "GreaterOrEqual"),
                (aten.eq.Tensor, "Equal"), (aten.eq.Scalar, "Equal"),
                (aten.logical_and.default, "And"), (aten.logical_or.default, "Or"),
                (aten.bitwise_and.Tensor, "And"), (aten.bitwise_or.Tensor, "Or")):
    _RULES[_t] = _binary(_op)

for _t, _op in ((aten.exp.default, "Exp"), (aten.log.default, "Log"),
                (aten.tanh.default, "Tanh"), (aten.sqrt.default, "Sqrt"),
                (aten.neg.default, "Neg"), (aten.abs.default, "Abs"),
                (aten.erf.default, "Erf"), (aten.sigmoid.default, "Sigmoid"),
                (aten.relu.default, "Relu"), (aten.sin.default, "Sin"),
                (aten.cos.default, "Cos"), (aten.reciprocal.default, "Reciprocal"),
                (aten.isnan.default, "IsNaN"), (aten.isinf.default, "IsInf"),
                (aten.logical_not.default, "Not"), (aten.bitwise_not.default, "Not"),
                (aten.clone.default, "Identity"), (aten.alias.default, "Identity"),
                (aten.lift_fresh_copy.default, "Identity"),
                (aten.detach.default, "Identity")):
    _RULES[_t] = (lambda op: lambda ctx, node: ctx.emit(op, [ctx.env[node.args[0]]]))(_op)


@rule(aten.div.Tensor, aten.div.Scalar, aten.div.Tensor_mode)
def _r_div(ctx, node):
    if node.kwargs.get("rounding_mode") is not None:
        raise MXNetError("ONNX export: rounded division is not translated")
    like = _like(node)
    return ctx.emit("Div", [ctx.ins(node.args[0], like), ctx.ins(node.args[1], like)])


@rule(aten.ne.Tensor, aten.ne.Scalar)
def _r_ne(ctx, node):
    like = _like(node)
    return ctx.emit("Not", [ctx.emit("Equal", [ctx.ins(a, like) for a in node.args[:2]])])


@rule(aten.fmod.Tensor, aten.fmod.Scalar)
def _r_fmod(ctx, node):
    # truncating toward zero (C fmod) = ONNX Mod with fmod=1
    like = _like(node)
    return ctx.emit("Mod", [ctx.ins(a, like) for a in node.args[:2]], fmod=1)


@rule(aten.remainder.Tensor, aten.remainder.Scalar)
def _r_remainder(ctx, node):
    like = _like(node)
    return ctx.emit("Mod", [ctx.ins(a, like) for a in node.args[:2]])


@rule(aten.rsqrt.default)
def _r_rsqrt(ctx, node):
    return ctx.emit("Reciprocal", [ctx.emit("Sqrt", [ctx.env[node.args[0]]])])


@rule(aten.clamp.default, aten.clamp_min.default, aten.clamp_max.default)
def _r_clamp(ctx, node):
    like = _like(node)
    x = ctx.env[node.args[0]]
    lo, hi = (node.args + (None, None))[1:3]
    if node.target == aten.clamp_max.default:
        lo, hi = None, node.args[1]
    if lo is not None:
        x = ctx.emit("Max", [x, ctx.ins(lo, like)])
    if hi is not None:
        x = ctx.emit("Min", [x, ctx.ins(hi, like)])
    return x


@rule(aten.where.self)
def _r_where(ctx, node):
    like = _dtype(node)
    c, a, b = node.args
    return ctx.emit("Where", [ctx.env[c], ctx.ins(a, like), ctx.ins(b, like)])


@rule(aten._to_copy.default)
def _r_to_copy(ctx, node):
    dtype = node.kwargs.get("dtype")
    x = ctx.env[node.args[0]]
    if dtype is None or dtype == _dtype(node.args[0]):
        return ctx.emit("Identity", [x])
    return ctx.emit("Cast", [x], to=_ONNX_DTYPE[dtype])


@rule(aten.gelu.default)
def _r_gelu(ctx, node):
    x = ctx.env[node.args[0]]
    like = _like(node)
    if node.kwargs.get("approximate", "none") != "none":
        raise MXNetError("ONNX export: tanh-approximated gelu is not translated")
    e = ctx.emit("Erf", [ctx.emit("Mul", [x, ctx.ins(0.7071067811865476, like)])])
    return ctx.emit("Mul", [ctx.emit("Mul", [x, ctx.ins(0.5, like)]),
                            ctx.emit("Add", [e, ctx.ins(1.0, like)])])


def _axis(node, dim):
    """``dim`` of ``node``'s first argument as a non-negative axis (the
    JAX package's importer reads integer attributes unsigned)."""
    return int(dim) % max(_val(node.args[0]).dim(), 1)


@rule(aten._softmax.default, aten.softmax.int)
def _r_softmax(ctx, node):
    return ctx.emit("Softmax", [ctx.env[node.args[0]]], axis=_axis(node, node.args[1]))


@rule(aten._log_softmax.default)
def _r_log_softmax(ctx, node):
    x = ctx.env[node.args[0]]
    return ctx.emit("Sub", [x, _logsumexp(ctx, x, _axis(node, node.args[1]), keepdims=1)])


def _logsumexp(ctx, s, axis, keepdims):
    """log(sum(exp(s - max))) + max over ``axis`` (non-negative)."""
    m = ctx.emit("ReduceMax", [s], axes=[axis], keepdims=1)
    total = ctx.emit("ReduceSum", [ctx.emit("Exp", [ctx.emit("Sub", [s, m])]),
                                   _int64(ctx, [axis], "axes")], keepdims=keepdims)
    if not keepdims:
        m = ctx.emit("Squeeze", [m, _int64(ctx, [axis], "axes")])
    return ctx.emit("Add", [ctx.emit("Log", [total]), m])


# ------------------------------------------------------------ shape ops
@rule(aten.view.default, aten._unsafe_view.default, aten.reshape.default)
def _r_view(ctx, node):
    sizes = [int(s) for s in _val(node).shape]
    if ctx.dynamic_batch_size is not None and sizes:
        # symbolic batch: the first dim is whatever the element count
        # leaves (a static tensor keeps its shape either way)
        sizes[0] = -1
    return ctx.emit("Reshape", [ctx.env[node.args[0]], _int64(ctx, sizes, "shape")])


@rule(aten.permute.default)
def _r_permute(ctx, node):
    rank = _val(node).dim()
    return ctx.emit("Transpose", [ctx.env[node.args[0]]],
                    perm=[int(d) % rank for d in node.args[1]])


@rule(aten.t.default)
def _r_t(ctx, node):
    return ctx.emit("Transpose", [ctx.env[node.args[0]]], perm=[1, 0])


@rule(aten.unsqueeze.default)
def _r_unsqueeze(ctx, node):
    rank = _val(node).dim()
    return ctx.emit("Unsqueeze", [ctx.env[node.args[0]],
                                  _int64(ctx, [int(node.args[1]) % rank], "axes")])


@rule(aten.squeeze.dim, aten.squeeze.dims)
def _r_squeeze(ctx, node):
    rank = _val(node.args[0]).dim()
    dims = node.args[1] if isinstance(node.args[1], (list, tuple)) else [node.args[1]]
    dims = [int(d) % rank for d in dims if _val(node.args[0]).shape[int(d)] == 1]
    if not dims:
        return ctx.emit("Identity", [ctx.env[node.args[0]]])
    return ctx.emit("Squeeze", [ctx.env[node.args[0]], _int64(ctx, dims, "axes")])


@rule(aten.expand.default)
def _r_expand(ctx, node):
    src = _val(node.args[0]).shape
    sizes = [int(s) for s in node.args[1]]
    lead = len(sizes) - len(src)
    sizes = [1 if (s == -1 or (i >= lead and src[i - lead] == s)) else s
             for i, s in enumerate(sizes)]
    return ctx.emit("Expand", [ctx.env[node.args[0]], _int64(ctx, sizes, "shape")])


@rule(aten.cat.default)
def _r_cat(ctx, node):
    rank = _val(node).dim()
    dim = int(node.args[1]) if len(node.args) > 1 else 0
    return ctx.emit("Concat", [ctx.env[t] for t in node.args[0]], axis=dim % rank)


@rule(aten.split_with_sizes.default, aten.split.Tensor)
def _r_split(ctx, node):
    x = node.args[0]
    dim = int(node.args[2]) if len(node.args) > 2 else 0
    n = _val(x).shape[dim]
    if node.target == aten.split.Tensor:
        step = int(node.args[1])
        sizes = [min(step, n - i) for i in range(0, n, step)]
    else:
        sizes = [int(s) for s in node.args[1]]
    outs = ctx.emit("Split", [ctx.env[x], _int64(ctx, sizes, "split")], n_out=len(sizes),
                    axis=dim % _val(x).dim())
    return outs if isinstance(outs, list) else [outs]


@rule(aten.select.int)
def _r_select(ctx, node):
    x, dim, index = node.args
    n = _val(x).shape[int(dim)]
    axis = int(dim) % _val(x).dim()
    # a one-element index, then the axis squeezed: the emitter writes a
    # 0-dim array as a 1-element tensor
    g = ctx.emit("Gather", [ctx.env[x], _int64(ctx, [int(index) % n], "index")], axis=axis)
    return ctx.emit("Squeeze", [g, _int64(ctx, [axis], "axes")])


@rule(aten.slice.Tensor)
def _r_slice(ctx, node):
    x = node.args[0]
    dim, start, end, step = (list(node.args[1:]) + [0, None, None, 1][len(node.args) - 1:])[:4]
    n = _val(x).shape[int(dim)]
    start, end, _ = slice(start, end, step).indices(n)
    return ctx.emit("Slice", [ctx.env[x], _int64(ctx, [start], "starts"),
                              _int64(ctx, [end], "ends"),
                              _int64(ctx, [int(dim) % _val(x).dim()], "axes"),
                              _int64(ctx, [int(step or 1)], "steps")])


@rule(aten.constant_pad_nd.default)
def _r_pad(ctx, node):
    x, pad = node.args[0], [int(p) for p in node.args[1]]
    value = node.args[2] if len(node.args) > 2 else 0.0
    rank = _val(x).dim()
    begins, ends = [0] * rank, [0] * rank
    for i in range(len(pad) // 2):
        begins[rank - 1 - i], ends[rank - 1 - i] = pad[2 * i], pad[2 * i + 1]
    return ctx.emit("Pad", [ctx.env[x], _int64(ctx, begins + ends, "pads"),
                            ctx.ins(value, _dtype(x))])


# ------------------------------------------------------------ constants
def _const_node(ctx, node, array):
    return ctx.const(array, "const")


@rule(aten.arange.start_step, aten.arange.default, aten.arange.start)
def _r_arange(ctx, node):
    return _const_node(ctx, node, torch.arange(*node.args, dtype=_dtype(node)))


@rule(aten.full.default)
def _r_full(ctx, node):
    return _const_node(ctx, node, torch.full(tuple(node.args[0]), node.args[1],
                                             dtype=_dtype(node)))


@rule(aten.scalar_tensor.default)
def _r_scalar_tensor(ctx, node):
    return _const_node(ctx, node, torch.scalar_tensor(node.args[0], dtype=_dtype(node)))


# ------------------------------------------------------------ reductions
def _dims(node, x):
    """A reduction's axes, non-negative; none given (or an empty list, as
    ATen spells a full reduction) is every axis."""
    dims = node.args[1] if len(node.args) > 1 and node.args[1] else range(_val(x).dim())
    return [int(d) % max(_val(x).dim(), 1) for d in dims]


def _keep(node, pos=2):
    return int(bool(node.args[pos] if len(node.args) > pos else node.kwargs.get("keepdim", False)))


@rule(aten.sum.dim_IntList, aten.sum.default)
def _r_sum(ctx, node):
    x = node.args[0]
    return ctx.emit("ReduceSum", [ctx.env[x], _int64(ctx, _dims(node, x), "axes")],
                    keepdims=_keep(node))


def _reduce_attr(op):
    def r(ctx, node):
        x = node.args[0]
        return ctx.emit(op, [ctx.env[x]], axes=_dims(node, x), keepdims=_keep(node))
    return r


for _t, _op in ((aten.mean.dim, "ReduceMean"), (aten.mean.default, "ReduceMean"),
                (aten.amax.default, "ReduceMax"), (aten.amin.default, "ReduceMin"),
                (aten.prod.dim_int, "ReduceProd")):
    _RULES[_t] = _reduce_attr(_op)


@rule(aten.argmax.default)
def _r_argmax(ctx, node):
    x = node.args[0]
    if len(node.args) < 2 or node.args[1] is None:
        raise MXNetError("ONNX export: argmax over all axes is not translated")
    return ctx.emit("ArgMax", [ctx.env[x]], axis=int(node.args[1]) % _val(x).dim(),
                    keepdims=_keep(node))


# ------------------------------------------------------------ contractions
@rule(aten.mm.default, aten.bmm.default, aten.matmul.default)
def _r_matmul(ctx, node):
    return ctx.emit("MatMul", [ctx.env[a] for a in node.args[:2]])


@rule(aten.addmm.default)
def _r_addmm(ctx, node):
    bias, a, b = (ctx.env[x] for x in node.args[:3])
    return ctx.emit("Gemm", [a, b, bias], alpha=float(node.kwargs.get("alpha", 1.0)),
                    beta=float(node.kwargs.get("beta", 1.0)))


@rule(aten.convolution.default)
def _r_conv(ctx, node):
    x, w, b, stride, padding, dilation, transposed, output_padding, groups = node.args
    ins = [ctx.env[x], ctx.env[w]] + ([] if b is None else [ctx.env[b]])
    attrs = dict(strides=[int(s) for s in stride], pads=[int(p) for p in padding] * 2,
                 dilations=[int(d) for d in dilation], group=int(groups))
    if transposed:
        # torch's transposed weight (C_in, C_out/g, k...) is ONNX's layout
        return ctx.emit("ConvTranspose", ins,
                        output_padding=[int(p) for p in output_padding], **attrs)
    return ctx.emit("Conv", ins, **attrs)


@rule(aten.max_pool2d_with_indices.default, aten.max_pool3d_with_indices.default,
      aten.max_pool1d.default, aten.max_pool2d.default)
def _r_maxpool(ctx, node):
    x, kernel = node.args[0], [int(k) for k in node.args[1]]
    nd = len(kernel)
    stride = [int(s) for s in (node.args[2] if len(node.args) > 2 and node.args[2]
                               else kernel)]
    padding = [int(p) for p in (node.args[3] if len(node.args) > 3 else [0] * nd)]
    dilation = node.args[4] if len(node.args) > 4 else [1] * nd
    ceil = node.args[5] if len(node.args) > 5 else False
    if any(int(d) != 1 for d in dilation) or ceil:
        raise MXNetError("ONNX export: dilated or ceil-mode max pooling is not translated")
    y = ctx.emit("MaxPool", [ctx.env[x]], kernel_shape=kernel, strides=stride,
                 pads=padding * 2)
    return [y, None] if "with_indices" in str(node.target) else y


@rule(aten.avg_pool2d.default, aten.avg_pool3d.default, aten.avg_pool1d.default)
def _r_avgpool(ctx, node):
    args = list(node.args) + [None] * 8
    x, kernel = args[0], [int(k) for k in args[1]]
    nd = len(kernel)
    stride = [int(s) for s in (args[2] or kernel)]
    padding = [int(p) for p in (args[3] or [0] * nd)]
    if args[4] or args[6] is not None:
        raise MXNetError("ONNX export: ceil-mode or divisor-override average pooling "
                         "is not translated")
    include = True if args[5] is None else bool(args[5])
    return ctx.emit("AveragePool", [ctx.env[x]], kernel_shape=kernel, strides=stride,
                    pads=padding * 2, count_include_pad=int(include))


@rule(aten._native_batch_norm_legit_no_training.default)
def _r_bn(ctx, node):
    x, w, b, mean, var, _momentum, eps = node.args
    y = ctx.emit("BatchNormalization", [ctx.env[a] for a in (x, w, b, mean, var)],
                 epsilon=float(eps))
    return [y, None, None]


@rule(aten.native_layer_norm.default)
def _r_layer_norm(ctx, node):
    x, shape, w, b, eps = node.args
    if len(shape) != 1:
        raise MXNetError("ONNX export: layer norm over several axes is not translated")
    y = ctx.emit("LayerNormalization", [ctx.env[x], ctx.env[w]] +
                 ([] if b is None else [ctx.env[b]]), axis=_val(x).dim() - 1,
                 epsilon=float(eps))
    return [y, None, None]


# ------------------------------------------------------------ gathers
@rule(aten.embedding.default)
def _r_embedding(ctx, node):
    w, idx = node.args[:2]
    i = ctx.emit("Cast", [ctx.env[idx]], to=P.DataType.INT64)
    return ctx.emit("Gather", [ctx.env[w], i], axis=0)


@rule(aten.index.Tensor)
def _r_index(ctx, node):
    """``x[..., i, ...]`` with one index tensor -> ``Gather(axis)``; ``x[i,
    j, ...]`` with k leading index tensors -> ``GatherND``."""
    x, indices = node.args
    present = [k for k, t in enumerate(indices) if t is not None]
    if len(present) == 1:
        i = ctx.emit("Cast", [ctx.env[indices[present[0]]]], to=P.DataType.INT64)
        return ctx.emit("Gather", [ctx.env[x], i], axis=present[0])
    if present != list(range(len(present))):
        raise MXNetError("ONNX export: unrecognized advanced indexing (supported: one "
                         "index tensor, or index tensors on the leading dims)")
    last = _val(indices[0]).dim()
    cols = [ctx.emit("Unsqueeze", [ctx.emit("Cast", [ctx.env[indices[k]]],
                                            to=P.DataType.INT64),
                                   _int64(ctx, [last], "axes")]) for k in present]
    idx = cols[0] if len(cols) == 1 else ctx.emit("Concat", cols, axis=last)
    return ctx.emit("GatherND", [ctx.env[x], idx])


@rule(aten.gather.default)
def _r_gather(ctx, node):
    x, dim, idx = node.args[:3]
    i = ctx.emit("Cast", [ctx.env[idx]], to=P.DataType.INT64)
    return ctx.emit("GatherElements", [ctx.env[x], i], axis=int(dim) % _val(x).dim())


# ------------------------------------------------------------ K1
@rule(torch.ops.mxnet_tpu_torch.flash_fwd.default)
def _r_flash(ctx, node):
    """K1 as attention math: s = q kᵀ scale (f32), causal entries (query i
    sees keys j <= i + S - T) at f32's lowest, p = softmax(s), o = p v
    cast to q's dtype; lse = log-sum-exp of s where the program reads it."""
    q, k, v, causal, scale = node.args
    dtype = _dtype(q)
    qf, kf, vf = (ctx.env[t] if dtype == torch.float32 else
                  ctx.emit("Cast", [ctx.env[t]], to=P.DataType.FLOAT) for t in (q, k, v))
    T, S = _val(q).shape[2], _val(k).shape[2]
    kt = ctx.emit("Transpose", [kf], perm=[0, 1, 3, 2])
    s = ctx.emit("Mul", [ctx.emit("MatMul", [qf, kt]),
                         ctx.const(onp.float32(scale), "scale")])
    if causal:
        mask = onp.tril(onp.ones((T, S), dtype=bool), S - T)
        s = ctx.emit("Where", [ctx.const(mask, "causal"), s,
                               ctx.const(onp.float32(onp.finfo(onp.float32).min), "lowest")])
    o = ctx.emit("MatMul", [ctx.emit("Softmax", [s], axis=3), vf])
    if dtype != torch.float32:
        o = ctx.emit("Cast", [o], to=_ONNX_DTYPE[dtype])
    read = {u.args[1] for u in node.users if u.target is operator.getitem}
    lse = _logsumexp(ctx, s, 3, keepdims=0) if 1 in read else None
    return [o, lse]


# ------------------------------------------------------------ the graph walk
def _translate(ctx, graph):
    for node in graph.nodes:
        if node.op != "call_function":
            continue
        if node.target is operator.getitem:
            src = ctx.env[node.args[0]]
            ctx.env[node] = src[node.args[1]]
            continue
        if node.target == aten._assert_tensor_metadata.default:
            continue
        r = _RULES.get(node.target)
        if r is None:
            raise MXNetError(f"ONNX export: no translation for ATen op {node.target} "
                             "(traced path)")
        ctx.env[node] = r(ctx, node)


def export_traced_model(net, onnx_file: str, example_inputs, opset: int = 17,
                        dynamic_batch: bool = False):
    """Export ``net``'s inference forward on ``example_inputs`` through
    ``torch.export`` and write an ONNX model. ``dynamic_batch=True`` marks
    the leading input and output dim as the symbolic 'N' (and lets every
    Reshape's first dim follow it), so the file accepts any batch size.
    Returns the path."""
    from ..gluon.block import _Program
    from ..ndarray import NDArray
    from ..parallel.functional import functionalize

    example_inputs = [x if isinstance(x, NDArray) else NDArray(x) for x in example_inputs]
    model = functionalize(net, *example_inputs, training=False)
    values = [v.detach() for v in model.values()]
    xs = [x._data for x in example_inputs]
    program = _Program(model, len(values))
    with torch.no_grad():
        exported = torch.export.export(program, tuple(values + xs), strict=False)
        exported = exported.run_decompositions()

    ctx = _Ctx()
    if dynamic_batch:
        ctx.dynamic_batch_size = int(xs[0].shape[0])
    kinds = torch.export.graph_signature.InputKind
    placeholders = [n for n in exported.graph.nodes if n.op == "placeholder"]
    graph_inputs, user = [], 0
    for node, spec in zip(placeholders, exported.graph_signature.input_specs):
        if spec.kind == kinds.USER_INPUT:
            if user < len(values):
                ctx.env[node] = ctx.const(values[user], model.names[user])
            else:
                k = user - len(values)
                name = f"data{k}" if k else "data"
                shape = list(xs[k].shape)
                if dynamic_batch and shape:
                    shape[0] = "N"
                graph_inputs.append(_value_info(name, xs[k].dtype, shape))
                ctx.env[node] = name
            user += 1
        elif spec.kind in (kinds.CONSTANT_TENSOR, kinds.BUFFER, kinds.PARAMETER):
            t = exported.constants.get(spec.target) if spec.kind == kinds.CONSTANT_TENSOR \
                else exported.state_dict[spec.target]
            ctx.env[node] = ctx.const(t, spec.target)
        else:
            raise MXNetError(f"ONNX export: program input of kind {spec.kind} "
                             "is not translated")
    _translate(ctx, exported.graph)

    out_node = next(n for n in exported.graph.nodes if n.op == "output")
    outputs = []
    for k, src in enumerate(out_node.args[0]):
        name = f"output{k}" if k else "output"
        ctx.nodes.append(P.make_node("Identity", [ctx.env[src]], [name], name=ctx.name("out")))
        outputs.append(_value_info(name, _dtype(src), None))
    graph = P.make_graph(ctx.nodes, "mxnet_tpu_traced", graph_inputs, outputs,
                         ctx.initializers)
    with open(onnx_file, "wb") as f:
        f.write(P.make_model(graph, opset=opset))
    return onnx_file
