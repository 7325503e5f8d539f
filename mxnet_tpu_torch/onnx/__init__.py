"""ONNX export and import (counterpart of ``mxnet_tpu/onnx``), opset 17,
with no ``onnx`` package: files are written by the protobuf emitter of
``_proto.py`` (the JAX package's, byte for byte).

``export_model`` walks the Gluon block tree with a converter per layer
type, as the JAX package does, and writes the same bytes for the same
layer tree and weights. A tree with a block no converter takes (a custom
``forward``, residual wiring, attention) falls back to the traced path
(``_trace_export.py``): the block's ``torch.export`` program, decomposed
to core ATen operators and translated op by op; K1's registered operator
becomes ONNX attention math. ``import_model`` (``_import.py``) runs an
ONNX file's graph with torch operators on a chosen device.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Type

import numpy as onp

from ..base import MXNetError
from ..gluon import nn
from ..gluon.block import Block, HybridSequential, Sequential
from . import _proto as P

__all__ = ["export_model", "ONNX_OPSET"]

ONNX_OPSET = 17

_CONVERTERS: Dict[Type, Callable] = {}


def register_converter(*types):
    def deco(fn):
        for t in types:
            _CONVERTERS[t] = fn
        return fn
    return deco


class _GraphCtx:
    def __init__(self):
        self.nodes: List[bytes] = []
        self.initializers: List[bytes] = []
        self._uid = 0

    def name(self, hint: str) -> str:
        self._uid += 1
        return f"{hint}_{self._uid}"

    def add_init(self, hint: str, array) -> str:
        name = self.name(hint)
        self.initializers.append(P.make_tensor(name, onp.asarray(array)))
        return name

    def add_node(self, op_type: str, inputs, n_out: int = 1, **attrs):
        outs = [self.name(op_type.lower())]
        if n_out > 1:
            outs += [self.name(op_type.lower()) for _ in range(n_out - 1)]
        self.nodes.append(P.make_node(op_type, inputs, outs,
                                      name=self.name(op_type), **attrs))
        return outs[0] if n_out == 1 else outs


_ACT_OP = {"relu": "Relu", "sigmoid": "Sigmoid", "tanh": "Tanh",
           "softrelu": "Softplus", "softsign": "Softsign"}


def _emit_activation(ctx, x, act: Optional[str]) -> str:
    if act is None:
        return x
    if act not in _ACT_OP:
        raise MXNetError(f"ONNX export: unsupported activation {act!r}")
    return ctx.add_node(_ACT_OP[act], [x])


@register_converter(nn.Dense)
def _conv_dense(block: nn.Dense, ctx: _GraphCtx, x: str) -> str:
    if block._flatten:
        x = ctx.add_node("Flatten", [x], axis=1)
    w = ctx.add_init("weight", block.weight.data().asnumpy())  # (units, in)
    inputs = [x, w]
    if block.bias is not None:
        inputs.append(ctx.add_init("bias", block.bias.data().asnumpy()))
    y = ctx.add_node("Gemm", inputs, alpha=1.0, beta=1.0, transB=1)
    return _emit_activation(ctx, y, block._activation)


@register_converter(nn.Conv1D, nn.Conv2D, nn.Conv3D)
def _conv_conv(block, ctx: _GraphCtx, x: str) -> str:
    if block._transpose:
        raise MXNetError("ONNX export: transposed conv not supported yet")
    w = ctx.add_init("conv_weight", block.weight.data().asnumpy())
    inputs = [x, w]
    if block.bias is not None:
        inputs.append(ctx.add_init("conv_bias", block.bias.data().asnumpy()))
    pads = list(block._padding) * 2  # symmetric begin+end
    y = ctx.add_node("Conv", inputs,
                     kernel_shape=list(block._kernel),
                     strides=list(block._strides),
                     dilations=list(block._dilation),
                     group=block._groups, pads=pads)
    return _emit_activation(ctx, y, block._activation)


@register_converter(nn.MaxPool1D, nn.MaxPool2D, nn.MaxPool3D,
                    nn.AvgPool1D, nn.AvgPool2D, nn.AvgPool3D,
                    nn.GlobalMaxPool1D, nn.GlobalMaxPool2D,
                    nn.GlobalMaxPool3D, nn.GlobalAvgPool1D,
                    nn.GlobalAvgPool2D, nn.GlobalAvgPool3D)
def _conv_pool(block, ctx: _GraphCtx, x: str) -> str:
    if block._global:
        op = "GlobalMaxPool" if block._type == "max" else "GlobalAveragePool"
        return ctx.add_node(op, [x])
    op = "MaxPool" if block._type == "max" else "AveragePool"
    kwargs = dict(kernel_shape=list(block._size),
                  strides=list(block._strides),
                  pads=list(block._padding) * 2,
                  ceil_mode=int(getattr(block, "_ceil_mode", False)))
    if op == "AveragePool":
        kwargs["count_include_pad"] = int(block._count_include_pad)
    return ctx.add_node(op, [x], **kwargs)


@register_converter(nn.BatchNorm)
def _conv_bn(block: nn.BatchNorm, ctx: _GraphCtx, x: str) -> str:
    if block._axis != 1:
        raise MXNetError("ONNX export: BatchNorm axis must be 1 (channels)")
    y = ctx.add_node(
        "BatchNormalization",
        [x,
         ctx.add_init("gamma", block.gamma.data().asnumpy()),
         ctx.add_init("beta", block.beta.data().asnumpy()),
         ctx.add_init("mean", block.running_mean.data().asnumpy()),
         ctx.add_init("var", block.running_var.data().asnumpy())],
        epsilon=float(block._eps), momentum=float(block._momentum))
    return y


@register_converter(nn.LayerNorm)
def _conv_ln(block: nn.LayerNorm, ctx: _GraphCtx, x: str) -> str:
    return ctx.add_node(
        "LayerNormalization",
        [x,
         ctx.add_init("ln_gamma", block.gamma.data().asnumpy()),
         ctx.add_init("ln_beta", block.beta.data().asnumpy())],
        axis=int(block._axis), epsilon=float(block._eps))


@register_converter(nn.Flatten)
def _conv_flatten(block, ctx: _GraphCtx, x: str) -> str:
    return ctx.add_node("Flatten", [x], axis=1)


@register_converter(nn.Dropout)
def _conv_dropout(block, ctx: _GraphCtx, x: str) -> str:
    return x  # inference graph: dropout is identity


@register_converter(nn.Identity)
def _conv_identity(block, ctx: _GraphCtx, x: str) -> str:
    return x


@register_converter(nn.Activation)
def _conv_act(block: nn.Activation, ctx: _GraphCtx, x: str) -> str:
    return _emit_activation(ctx, x, block._act)


@register_converter(nn.LeakyReLU)
def _conv_leaky(block: nn.LeakyReLU, ctx: _GraphCtx, x: str) -> str:
    return ctx.add_node("LeakyRelu", [x], alpha=float(block._alpha))


@register_converter(nn.ELU)
def _conv_elu(block: nn.ELU, ctx: _GraphCtx, x: str) -> str:
    return ctx.add_node("Elu", [x], alpha=float(block._alpha))


@register_converter(nn.GELU)
def _conv_gelu(block, ctx: _GraphCtx, x: str) -> str:
    # Gelu only entered the default ONNX domain at opset 20; decompose to
    # the erf form (Erf is opset 9): x * 0.5 * (1 + erf(x / sqrt(2)))
    inv_sqrt2 = ctx.add_init("inv_sqrt2", onp.float32(0.7071067811865476))
    half = ctx.add_init("half", onp.float32(0.5))
    one = ctx.add_init("one", onp.float32(1.0))
    e = ctx.add_node("Erf", [ctx.add_node("Mul", [x, inv_sqrt2])])
    return ctx.add_node(
        "Mul", [ctx.add_node("Mul", [x, half]),
                ctx.add_node("Add", [e, one])])


@register_converter(nn.SiLU)
def _conv_silu(block, ctx: _GraphCtx, x: str) -> str:
    s = ctx.add_node("Sigmoid", [x])
    return ctx.add_node("Mul", [x, s])


@register_converter(nn.Embedding)
def _conv_embedding(block: nn.Embedding, ctx: _GraphCtx, x: str) -> str:
    w = ctx.add_init("embed_weight", block.weight.data().asnumpy())
    xi = ctx.add_node("Cast", [x], to=P.DataType.INT64)
    return ctx.add_node("Gather", [w, xi], axis=0)


@register_converter(Sequential, HybridSequential)
def _conv_sequential(block, ctx: _GraphCtx, x: str) -> str:
    for child in block._children.values():
        x = _convert_block(child, ctx, x)
    return x


def _convert_block(block: Block, ctx: _GraphCtx, x: str) -> str:
    conv = _CONVERTERS.get(type(block))
    if conv is None:
        for t, fn in _CONVERTERS.items():
            if isinstance(block, t):
                conv = fn
                break
    if conv is None:
        raise MXNetError(
            f"ONNX export: no converter for {type(block).__name__}; models "
            "with custom forward() cannot be exported to ONNX — use "
            "HybridBlock.export (torch.export) for full-fidelity artifacts")
    return conv(block, ctx, x)


def export_model(net, onnx_file: str, input_shapes: Optional[List] = None,
                 input_types=onp.float32, dynamic_batch: bool = False,
                 run_shape_inference: bool = False, verbose: bool = False):
    """Export an initialized Gluon network to an ONNX file (reference
    mx.onnx.export_model signature role, _export_model.py:51).

    Layer-tree models (Sequential nests of standard layers) export through
    the per-layer converters below — exact ONNX layer idioms. Anything
    else — custom ``forward()`` python, transformer blocks — automatically
    falls back to the TRACED path (onnx/_trace_export.py): the forward is
    exported with ``torch.export`` and translated ATen op by ATen op.
    The example inputs are zeros on the device of the block's parameters.

    Returns the path written. ``input_shapes``: list with one shape tuple
    per network input. ``dynamic_batch=True`` exports a symbolic batch
    dimension (both the layer-tree and traced paths).
    """
    if not isinstance(net, Block):
        raise MXNetError("export_model expects a Gluon Block; symbol-file "
                         "export is not ported")
    if not input_shapes:
        raise MXNetError("export_model: provide input_shapes=[(...)]")
    dtypes = input_types if isinstance(input_types, (list, tuple)) \
        else [input_types] * len(input_shapes)
    from ..ndarray import NDArray
    dev = next((p.data()._data.device for p in net.collect_params().values()
                if p._var is not None), None)
    examples = [NDArray(onp.zeros(list(s), onp.dtype(t)), device=dev)
                for s, t in zip(input_shapes, dtypes)]
    if len(input_shapes) == 1:
        in_shape = list(input_shapes[0])
        dtype = onp.dtype(dtypes[0])
        try:
            # complete any deferred parameter shapes with a zeros forward
            net(examples[0])
            ctx = _GraphCtx()
            out_name = _convert_block(net, ctx, "data")
            shape_repr = (["N"] + in_shape[1:]) if dynamic_batch else in_shape
            # final node's output renamed via Identity to a stable name
            ctx.nodes.append(P.make_node("Identity", [out_name], ["output"],
                                         name="output_identity"))
            graph = P.make_graph(
                ctx.nodes, "mxnet_tpu_graph",
                inputs=[P.make_value_info("data", dtype, shape_repr)],
                # unknown rank: shape inference derives it (declaring []
                # would pin the output to rank 0 and break checkers)
                outputs=[P.make_value_info("output", onp.float32, None)],
                initializers=ctx.initializers)
            model = P.make_model(graph, opset=ONNX_OPSET)
            with open(onnx_file, "wb") as f:
                f.write(model)
            return onnx_file
        except MXNetError:
            pass  # not a pure layer tree — trace it
    from ._trace_export import export_traced_model
    return export_traced_model(net, onnx_file, examples, opset=ONNX_OPSET,
                               dynamic_batch=dynamic_batch)


from ._import import import_model, OnnxModel  # noqa: E402
from ._trace_export import export_traced_model  # noqa: E402

__all__ += ["import_model", "OnnxModel", "export_traced_model"]


# reference namespace alias: mx.onnx.mx2onnx.export_model
class mx2onnx:  # noqa: N801
    export_model = staticmethod(export_model)
