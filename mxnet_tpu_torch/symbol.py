"""``mx.sym``, the legacy symbolic graph API (counterpart of
``mxnet_tpu/symbol.py``).

A Symbol is a lazy expression DAG (op name, inputs, attrs). ``bind`` walks
it once, mapping each node onto the port's imperative ``np``/``npx`` ops,
which run on the tape: ``Executor.forward`` records, ``Executor.backward``
is the tape's backward. There is no graph IR of its own: the DAG is a
recipe for an eager program, on the card or on the CPU as its arrays lie.

The op table has two tiers, as in the JAX package: hand-written legacy ops
with classic semantics (FullyConnected, Convolution, BatchNorm, Pooling,
SoftmaxOutput with its implicit cross-entropy gradient, SliceChannel,
UpSampling, RNN, ...), and a generated tier with every public ``np`` and
``npx`` function of the port. ``tojson`` writes the JAX package's JSON, so
a graph built the same way serializes to the same string, and
``load_json`` reads either package's.
"""
from __future__ import annotations

import json
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as onp
import torch

from .base import MXNetError
from .ndarray import NDArray

__all__ = ["Symbol", "Variable", "var", "Group", "load_json"]

_OP_TABLE: Dict[str, Callable] = {}


def register_op(name):
    def deco(fn):
        _OP_TABLE[name] = fn
        return fn
    return deco


class Symbol:
    """A node in the lazy expression DAG."""

    def __init__(self, op: Optional[str], inputs: Sequence["Symbol"] = (),
                 attrs: Optional[dict] = None, name: Optional[str] = None,
                 outputs: Optional[Sequence["Symbol"]] = None):
        self.op = op                  # None for variables / groups
        self.inputs = list(inputs)
        self.attrs = dict(attrs or {})
        self.name = name or (op.lower() if op else "sym")
        self._group = list(outputs) if outputs is not None else None

    # ------------------------------------------------------------ graph
    def _walk(self, seen=None, order=None):
        if seen is None:
            seen, order = set(), []
        if id(self) in seen:
            return order
        seen.add(id(self))
        if self._group is not None:
            for s in self._group:
                s._walk(seen, order)
            return order
        for i in self.inputs:
            i._walk(seen, order)
        order.append(self)
        return order

    def list_arguments(self) -> List[str]:
        """Variable names in topological order (reference symbol.py:769);
        internal constants are not arguments."""
        return [s.name for s in self._walk()
                if s.op is None and "__const__" not in s.attrs]

    def list_outputs(self) -> List[str]:
        if self._group is not None:
            return [o.name + "_output" for o in self._group]
        return [self.name + "_output"]

    def get_internals(self):
        return Group([s for s in self._walk()])

    # ------------------------------------------------------- evaluation
    def _eval_node(self, values: Dict[int, NDArray], is_train: bool):
        if id(self) in values:
            return values[id(self)]
        if self.op is None:
            raise MXNetError(f"unbound variable {self.name!r}")
        fn = _OP_TABLE.get(self.op)
        if fn is None:
            raise MXNetError(f"symbol op {self.op!r} not supported")
        args = [i._eval_node(values, is_train) for i in self.inputs]
        out = fn(*args, is_train=is_train, **self.attrs)
        values[id(self)] = out
        return out

    def eval(self, ctx=None, device=None, **kwargs) -> List[NDArray]:
        """One-shot evaluation from named arguments (reference
        symbol.py:1909)."""
        ex = self.bind(device or ctx, kwargs)
        return ex.forward()

    def bind(self, device=None, args=None, args_grad=None,
             grad_req: str = "write", ctx=None, **_ignored) -> "Executor":
        return Executor(self, args or {}, args_grad, grad_req)

    def _infer_shapes(self, shapes: Dict[str, Tuple[int, ...]]):
        """PARTIAL shape inference (reference symbol.py:1074 /
        simple_bind): walk the DAG evaluating on zeros; when a layer op
        (Convolution/FullyConnected/BatchNorm/Embedding...) meets an
        unbound parameter input, its shape is derived from the op attrs +
        data shape (the reference's per-op InferShape role), so callers
        only provide data/label shapes. Returns (all_arg_shapes,
        out_shapes)."""
        known = dict(shapes)
        values: Dict[int, NDArray] = {}
        order = self._walk()

        def zeros(shape):
            return NDArray(onp.zeros(shape, onp.float32))

        for s in order:
            if s.op is None:
                if "__const__" in s.attrs:
                    values[id(s)] = NDArray(onp.float32(s.attrs["__const__"]))
                elif s.name in known:
                    values[id(s)] = zeros(known[s.name])
                elif "__shape__" in s.attrs:
                    known[s.name] = tuple(s.attrs["__shape__"])
                    values[id(s)] = zeros(known[s.name])
                continue
            rule = _PARAM_SHAPE_RULES.get(s.op)
            if rule is not None:
                missing = {i: inp for i, inp in enumerate(s.inputs)
                           if id(inp) not in values and inp.op is None}
                if missing:
                    data_val = values.get(id(s.inputs[0]))
                    if data_val is None:
                        raise MXNetError(
                            f"infer_shape: data input of {s.name!r} unknown")
                    derived = rule(tuple(data_val.shape), s.attrs)
                    for i, inp in missing.items():
                        if i in derived:
                            known[inp.name] = derived[i]
                            values[id(inp)] = zeros(derived[i])
            unresolved = [inp.name for inp in s.inputs
                          if id(inp) not in values]
            if unresolved:
                raise MXNetError(
                    f"infer_shape: missing shapes for {unresolved}")
            fn = _OP_TABLE.get(s.op)
            if fn is None:
                raise MXNetError(f"symbol op {s.op!r} not supported")
            args = [values[id(i)] for i in s.inputs]
            values[id(s)] = fn(*args, is_train=False, **s.attrs)
        heads = self._group if self._group is not None else [self]
        outs = []
        for h in heads:
            r = values[id(h)]
            outs.extend(r) if isinstance(r, list) else outs.append(r)
        return known, [tuple(o.shape) for o in outs]

    def simple_bind(self, device=None, grad_req: str = "write", ctx=None,
                    **shapes) -> "Executor":
        """Allocate zero-initialized argument arrays; parameter shapes are
        INFERRED from the data/label shapes (reference simple_bind
        contract — executor allocation + InferShape)."""
        known, _ = self._infer_shapes(shapes)
        args = {}
        for name in self.list_arguments():
            if name not in known:
                raise MXNetError(f"simple_bind: could not infer shape for "
                                 f"{name!r}; pass it explicitly")
            args[name] = NDArray(onp.zeros(known[name], onp.float32))
        return Executor(self, args, None, grad_req)

    def infer_shape(self, **shapes):
        """Partial shape inference (see ``_infer_shapes``). Returns
        (arg_shapes, out_shapes, aux_shapes) in list_arguments order."""
        known, out_shapes = self._infer_shapes(shapes)
        missing = [n for n in self.list_arguments() if n not in known]
        if missing:
            raise MXNetError(f"infer_shape: missing shapes for {missing}")
        return ([tuple(known[n]) for n in self.list_arguments()],
                out_shapes, [])

    # ----------------------------------------------------------- compose
    def __getitem__(self, index):
        """Select one output of a multi-output op (reference Symbol
        indexing, e.g. SliceChannel/split results)."""
        if self._group is not None:
            return self._group[index]
        return Symbol("_item", [self], {"index": int(index)},
                      name=f"{self.name}[{index}]")

    def _binop(self, other, op):
        other = other if isinstance(other, Symbol) else _const(other)
        return Symbol(op, [self, other])

    def __add__(self, other):
        return self._binop(other, "elemwise_add")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binop(other, "elemwise_sub")

    def __mul__(self, other):
        return self._binop(other, "elemwise_mul")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binop(other, "elemwise_div")

    def __repr__(self):
        return f"<Symbol {self.name}>"

    # --------------------------------------------------------------- io
    def tojson(self, remove_amp_cast: bool = True) -> str:
        """Serialize the DAG (reference symbol.py:1398 model-symbol.json
        role; node schema mirrors the reference's nodes/heads layout)."""
        order = self._walk()
        index = {id(s): i for i, s in enumerate(order)}
        nodes = []
        for s in order:
            nodes.append({
                "op": s.op or "null",
                "name": s.name,
                "attrs": {k: str(v) for k, v in s.attrs.items()},
                "inputs": [[index[id(i)], 0, 0] for i in s.inputs],
            })
        heads = ([[index[id(o)], 0, 0] for o in self._group]
                 if self._group is not None else [[len(nodes) - 1, 0, 0]])
        return json.dumps({"nodes": nodes, "heads": heads,
                           "attrs": {"mxnet_version": ["int", 20000]}},
                          indent=2)


_CONST_COUNTER = [0]


def _const(value):
    _CONST_COUNTER[0] += 1
    s = Symbol(None, name=f"_const{_CONST_COUNTER[0]}")
    s.attrs["__const__"] = float(value)
    return s


def Variable(name: str, shape=None, **kwargs) -> Symbol:
    s = Symbol(None, name=name)
    if shape is not None:
        s.attrs["__shape__"] = tuple(shape)
    return s


var = Variable


def Group(symbols: Sequence[Symbol]) -> Symbol:
    return Symbol(None, outputs=list(symbols), name="group")


def load_json(text: str) -> Symbol:
    """Rebuild a Symbol from :meth:`Symbol.tojson` output."""
    doc = json.loads(text)
    built: List[Symbol] = []
    for node in doc["nodes"]:
        inputs = [built[i] for i, _, _ in node["inputs"]]
        import ast
        attrs = {}
        for k, v in node.get("attrs", {}).items():
            try:
                attrs[k] = ast.literal_eval(v)  # literals only, no exec
            except (ValueError, SyntaxError):
                attrs[k] = v
        if node["op"] == "null":
            s = Symbol(None, name=node["name"])
            s.attrs = attrs
        else:
            s = Symbol(node["op"], inputs, attrs, name=node["name"])
        built.append(s)
    heads = [built[i] for i, _, _ in doc["heads"]]
    return heads[0] if len(heads) == 1 else Group(heads)


class Executor:
    """Bound computation (reference python/mxnet/executor.py): holds the
    argument arrays; forward evaluates the DAG on the tape, backward is
    autograd."""

    def __init__(self, symbol: Symbol, args: Dict[str, NDArray],
                 args_grad, grad_req: str):
        self.symbol = symbol
        self.arg_dict: Dict[str, NDArray] = {}
        var_nodes = [s for s in symbol._walk() if s.op is None]
        for node in var_nodes:
            if "__const__" in node.attrs:
                self.arg_dict[node.name] = NDArray(
                    onp.float32(node.attrs["__const__"]))
                continue
            if node.name not in args:
                raise MXNetError(f"bind: missing argument {node.name!r}")
            arr = args[node.name]
            self.arg_dict[node.name] = arr if isinstance(arr, NDArray) \
                else NDArray(arr)
        self.grad_req = grad_req
        # caller-provided gradient buffers are filled after backward
        # (reference executor bind args_grad contract)
        self._args_grad = {
            k: (v if isinstance(v, NDArray) else NDArray(v))
            for k, v in (args_grad or {}).items()}
        if grad_req != "null":
            for name, arr in self.arg_dict.items():
                if not name.startswith("_const"):
                    arr.attach_grad(grad_req)
        self.grad_dict = {n: a.grad for n, a in self.arg_dict.items()}
        self.outputs: List[NDArray] = []
        self._heads: List[NDArray] = []

    def forward(self, is_train: bool = False, **kwargs) -> List[NDArray]:
        from . import autograd
        for k, v in kwargs.items():  # update bound args (reference API)
            if k in self.arg_dict:
                self.arg_dict[k]._set_data(
                    v._data if isinstance(v, NDArray) else v)
        values = {}
        sym = self.symbol
        heads = sym._group if sym._group is not None else [sym]
        for s in sym._walk():
            if s.op is None:
                values[id(s)] = self.arg_dict[s.name]
        with autograd.record(train_mode=is_train):
            outs = []
            for h in heads:
                r = h._eval_node(values, is_train)
                outs.extend(r) if isinstance(r, list) else outs.append(r)
        self._heads = outs
        self.outputs = outs
        self.grad_dict = {n: a.grad for n, a in self.arg_dict.items()}
        return outs

    def backward(self, out_grads=None):
        from . import autograd
        if not self._heads:
            raise MXNetError("backward before forward")
        if out_grads is not None and not isinstance(out_grads, (list, tuple)):
            out_grads = [out_grads]
        autograd.backward(self._heads, head_grads=out_grads)
        self.grad_dict = {n: a.grad for n, a in self.arg_dict.items()}
        for name, buf in self._args_grad.items():
            g = self.grad_dict.get(name)
            if g is not None:
                buf._set_data(g._data)


# ---------------------------------------------- parameter shape rules
#
# Per-op InferShape for the classic layer ops: given the DATA shape and the
# node attrs, derive the parameter-input shapes (reference
# src/operator/nn/*.cc InferShape). Keyed by input position.

def _tup_attr(v):
    return (v,) if isinstance(v, int) else tuple(v)


def _rule_fc(data_shape, attrs):
    nh = int(attrs["num_hidden"])
    flatten = bool(attrs.get("flatten", True))
    in_units = int(onp.prod(data_shape[1:])) if flatten else data_shape[-1]
    out = {1: (nh, in_units)}
    if not attrs.get("no_bias", False):
        out[2] = (nh,)
    return out


def _rule_conv(data_shape, attrs):
    nf = int(attrs["num_filter"])
    ng = int(attrs.get("num_group", 1))
    kernel = _tup_attr(attrs["kernel"])
    out = {1: (nf, data_shape[1] // ng) + kernel}
    if not attrs.get("no_bias", False):
        out[2] = (nf,)
    return out


def _rule_bn(data_shape, attrs):
    c = data_shape[int(attrs.get("axis", 1))]
    return {1: (c,), 2: (c,), 3: (c,), 4: (c,)}


def _rule_embedding(data_shape, attrs):
    return {1: (int(attrs["input_dim"]), int(attrs["output_dim"]))}


_PARAM_SHAPE_RULES: Dict[str, Callable] = {
    "FullyConnected": _rule_fc,
    "Convolution": _rule_conv,
    "BatchNorm": _rule_bn,
    "Embedding": _rule_embedding,
    # loss layers: the label input mirrors the data batch dim
    "SoftmaxOutput": lambda ds, attrs: {1: (ds[0],)},
    "LinearRegressionOutput": lambda ds, attrs: {1: ds},
}


# ----------------------------------------------------------------- ops

def _npx():
    from . import numpy_extension as npx
    return npx


def _np():
    from . import numpy as np_mod
    return np_mod


@register_op("elemwise_add")
def _op_add(a, b, is_train=False, **_):
    return a + b


@register_op("elemwise_sub")
def _op_sub(a, b, is_train=False, **_):
    return a - b


@register_op("elemwise_mul")
def _op_mul(a, b, is_train=False, **_):
    return a * b


@register_op("elemwise_div")
def _op_div(a, b, is_train=False, **_):
    return a / b


@register_op("FullyConnected")
def _op_fc(x, weight, bias=None, num_hidden=None, no_bias=False,
           flatten=True, is_train=False, **_):
    return _npx().fully_connected(x, weight, bias,
                                  num_hidden=int(num_hidden),
                                  no_bias=bool(no_bias),
                                  flatten=bool(flatten))


@register_op("Convolution")
def _op_conv(x, weight, bias=None, kernel=None, stride=(1, 1), pad=(0, 0),
             dilate=(1, 1), num_filter=None, num_group=1, no_bias=False,
             is_train=False, **_):
    return _npx().convolution(x, weight, bias, kernel=kernel, stride=stride,
                              pad=pad, dilate=dilate,
                              num_filter=int(num_filter),
                              num_group=int(num_group),
                              no_bias=bool(no_bias))


@register_op("Activation")
def _op_act(x, act_type="relu", is_train=False, **_):
    return _npx().activation(x, act_type)


@register_op("BatchNorm")
def _op_bn(x, gamma, beta, moving_mean, moving_var, eps=1e-5, momentum=0.9,
           fix_gamma=False, use_global_stats=False, is_train=False, **_):
    out = _npx().batch_norm(x, gamma, beta, moving_mean, moving_var,
                            eps=float(eps), momentum=float(momentum),
                            fix_gamma=bool(fix_gamma),
                            use_global_stats=bool(use_global_stats),
                            training=bool(is_train))
    return out[0] if isinstance(out, (tuple, list)) else out


@register_op("Pooling")
def _op_pool(x, kernel=(2, 2), pool_type="max", stride=None, pad=(0, 0),
             global_pool=False, pooling_convention="valid",
             count_include_pad=True, cudnn_off=False, layout=None,
             p_value=None, is_train=False):
    return _npx().pooling(x, kernel=kernel, pool_type=pool_type,
                          stride=stride, pad=pad,
                          global_pool=bool(global_pool),
                          pooling_convention=pooling_convention,
                          count_include_pad=bool(count_include_pad))


@register_op("Flatten")
def _op_flatten(x, is_train=False, **_):
    return x.reshape(x.shape[0], -1)


@register_op("Dropout")
def _op_dropout(x, p=0.5, is_train=False, **_):
    if not is_train:
        return x
    return _npx().dropout(x, p=float(p))


@register_op("Concat")
def _op_concat(*args, dim=1, num_args=None, is_train=False, **_):
    return _np().concatenate(list(args), axis=int(dim))


class _SoftmaxOutputFn(torch.autograd.Function):
    """Forward softmax; backward ``(p - onehot(label)) * grad_scale``,
    ignoring the incoming head gradient (the classic loss layer), and no
    gradient to the label."""

    @staticmethod
    def forward(ctx, x, label, grad_scale):
        p = torch.softmax(x, dim=-1)
        ctx.save_for_backward(p, label)
        ctx.grad_scale = grad_scale
        return p

    @staticmethod
    def backward(ctx, g):
        p, label = ctx.saved_tensors
        onehot = torch.nn.functional.one_hot(label.to(torch.int64), p.shape[-1]).to(p.dtype)
        return (p - onehot) * ctx.grad_scale, torch.zeros_like(label), None


@register_op("SoftmaxOutput")
def _op_softmax_output(x, label=None, grad_scale=1.0, is_train=False,
                       **attrs):
    """Classic loss layer: forward = softmax, backward = the implicit
    cross-entropy gradient (p - onehot(label)) * grad_scale, IGNORING the
    incoming head gradient (:class:`_SoftmaxOutputFn`)."""
    if label is None:
        return _npx().softmax(x, axis=-1)
    from .ndarray import apply_multi
    gs = float(grad_scale)
    return apply_multi(lambda xv, lv: _SoftmaxOutputFn.apply(xv, lv, gs), [x, label],
                       name="SoftmaxOutput")


@register_op("LinearRegressionOutput")
def _op_linreg_output(x, label=None, is_train=False, **attrs):
    return x


@register_op("reshape")
def _op_reshape(x, shape=None, is_train=False, **_):
    return x.reshape(tuple(shape))


@register_op("dot")
def _op_dot(a, b, is_train=False):
    return _np().dot(a, b)


@register_op("_item")
def _op_item(x, index=0, is_train=False):
    return x[int(index)]


@register_op("SliceChannel")
def _op_slice_channel(x, num_outputs=None, axis=1, squeeze_axis=False,
                      is_train=False):
    """Reference SliceChannel (slice_channel-inl.h): split into
    ``num_outputs`` equal parts along ``axis``; multi-output (index the
    result symbol)."""
    parts = _np().split(x, int(num_outputs), axis=int(axis))
    if squeeze_axis:
        parts = [p.squeeze(int(axis)) for p in parts]
    return list(parts)


@register_op("UpSampling")
def _op_upsampling(x, scale=None, sample_type="nearest", num_filter=0,
                   is_train=False, **_):
    return _nd().UpSampling(x, scale=int(scale), sample_type=sample_type)


@register_op("LeakyReLU")
def _op_leaky(x, act_type="leaky", slope=0.25, is_train=False):
    return _npx().leaky_relu(x, gamma=float(slope), act_type=act_type)


@register_op("Embedding")
def _op_embedding(data, weight, input_dim=None, output_dim=None,
                  is_train=False, **_):
    return _npx().embedding(data, weight, input_dim=input_dim,
                            output_dim=output_dim)


@register_op("RNN")
def _op_rnn(data, parameters, state, state_cell=None, state_size=None,
            num_layers=1, mode="lstm", bidirectional=False, p=0.0,
            state_outputs=False, is_train=False, **_):
    """Reference fused RNN symbol → npx.rnn flat-param facade."""
    args = [data, parameters, state]
    if state_cell is not None:
        args.append(state_cell)
    out = _npx().rnn(*args, state_size=int(state_size),
                     num_layers=int(num_layers), mode=mode,
                     bidirectional=bool(bidirectional), p=float(p),
                     state_outputs=bool(state_outputs))
    return list(out) if isinstance(out, (tuple, list)) else out


def _nd():
    from . import nd as nd_mod
    return nd_mod


def _make_symbol_op(op_name):
    def make(*inputs, name=None, **attrs):
        syms = [i if isinstance(i, Symbol) else _const(i) for i in inputs]
        return Symbol(op_name, syms, attrs, name=name)
    make.__name__ = op_name
    return make


# module-level builders: sym.FullyConnected(data=..., ...) style also
# accepts keyword data/weight/bias like the reference; missing parameter
# inputs are AUTO-CREATED as named Variables ("convolution0_weight",
# "softmax_label", ...) exactly like the reference's NNVM composition
# (python/mxnet/symbol/register.py generated signatures).
_NAME_COUNTER: Dict[str, int] = {}
# ops whose trailing inputs auto-create variables when omitted
_AUTO_PARAM_OPS = {"FullyConnected", "Convolution", "BatchNorm",
                   "SoftmaxOutput", "LinearRegressionOutput", "Embedding"}


def _auto_name(op_name):
    n = _NAME_COUNTER.get(op_name, 0)
    _NAME_COUNTER[op_name] = n + 1
    return f"{op_name.lower()}{n}"


def _kw_builder(op_name, input_order):
    def make(*args, name=None, **kwargs):
        inputs = list(args)
        for key in input_order[len(inputs):]:
            if key in kwargs:
                inputs.append(kwargs.pop(key))
            else:
                break
        node_name = name or _auto_name(op_name)
        if op_name in _AUTO_PARAM_OPS:
            no_bias = bool(kwargs.get("no_bias", False))
            for slot in input_order[len(inputs):]:
                if slot == "bias" and no_bias:
                    continue
                if slot == "label":
                    # the classic convention: loss labels bind by the
                    # LAYER name + _label (e.g. 'softmax_label')
                    inputs.append(Variable(f"{node_name}_label"))
                else:
                    inputs.append(Variable(f"{node_name}_{slot}"))
        syms = [i if isinstance(i, Symbol) else _const(i) for i in inputs]
        return Symbol(op_name, syms, kwargs, name=node_name)
    make.__name__ = op_name
    return make


FullyConnected = _kw_builder("FullyConnected", ["data", "weight", "bias"])
Convolution = _kw_builder("Convolution", ["data", "weight", "bias"])
Activation = _kw_builder("Activation", ["data"])
BatchNorm = _kw_builder("BatchNorm", ["data", "gamma", "beta",
                                      "moving_mean", "moving_var"])
Pooling = _kw_builder("Pooling", ["data"])
Flatten = _kw_builder("Flatten", ["data"])
Dropout = _kw_builder("Dropout", ["data"])
Concat = _make_symbol_op("Concat")
SoftmaxOutput = _kw_builder("SoftmaxOutput", ["data", "label"])
LinearRegressionOutput = _kw_builder("LinearRegressionOutput",
                                     ["data", "label"])
reshape = _kw_builder("reshape", ["data"])
dot = _make_symbol_op("dot")
SliceChannel = _kw_builder("SliceChannel", ["data"])
split = SliceChannel
UpSampling = _kw_builder("UpSampling", ["data"])
LeakyReLU = _kw_builder("LeakyReLU", ["data"])
Embedding = _kw_builder("Embedding", ["data", "weight"])
RNN = _kw_builder("RNN", ["data", "parameters", "state", "state_cell"])


# ------------------------------------------------- generated op table
#
# Every public array function of the port's np/npx namespaces becomes a
# symbol op evaluated by the imperative implementation (so it runs on the
# tape and differentiates like eager code). Hand-written entries above keep
# their legacy semantics and are never overwritten.

def _generic_eval(fn):
    def run(*args, is_train=False, **attrs):
        return fn(*args, **attrs)
    run.__name__ = getattr(fn, "__name__", "op")
    return run


def _snake_builder(op_name):
    """Module-level builder for generated ops: positional Symbol inputs,
    plus the conventional data/label/weight/bias keyword inputs; everything
    else becomes a node attr."""
    def make(*inputs, name=None, **kwargs):
        ins = list(inputs)
        for key in ("data", "label", "weight", "bias"):
            if key in kwargs and isinstance(kwargs[key], Symbol):
                ins.append(kwargs.pop(key))
        extra = [k for k, v in kwargs.items() if isinstance(v, Symbol)]
        for k in extra:
            ins.append(kwargs.pop(k))
        syms = [i if isinstance(i, Symbol) else _const(i) for i in ins]
        return Symbol(op_name, syms, kwargs, name=name)
    make.__name__ = op_name
    return make


def _register_from_namespaces():
    import inspect
    from . import numpy as np_mod
    from . import numpy_extension as npx_mod
    g = globals()
    count = 0
    for mod in (np_mod, npx_mod):
        names = [n for n in dir(mod) if not n.startswith("_")]
        for n in names:
            fn = getattr(mod, n, None)
            if not callable(fn) or inspect.isclass(fn) or n in _OP_TABLE:
                continue
            _OP_TABLE[n] = _generic_eval(fn)
            if n not in g:
                g[n] = _snake_builder(n)
            count += 1
    return count


_GENERATED_OPS = _register_from_namespaces()
