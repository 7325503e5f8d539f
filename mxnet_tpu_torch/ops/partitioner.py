"""Graph-level subgraph partitioner (counterpart of
``mxnet_tpu/ops/partitioner.py``, the role of the reference's
``SubgraphProperty``): carve subgraphs of a traced computation by an
operator predicate and hand each to a backend for substitution, without
touching model code.

The port's graph is the FX graph that ``make_fx`` traces from a function
of tensors: ATen operators, and the port's registered kernels as
``mxnet_tpu_torch::`` operators. ``partition(fn, example_args, prop)``
traces ``fn``, groups maximal runs of nodes that ``prop.match`` selects
(the graph is in topological order, so a contiguous run is a
dependency-closed subgraph), builds each run as a ``GraphModule`` and asks
the property for a replacement callable. The result is a Python callable
that interprets the graph node by node on real tensors, differentiable by
PyTorch's autograd wherever its operators are.

Differentiability contract (the JAX package's): a graph without an
operator that carries a hand-written gradient differentiates through the
partitioned callable. The flash-attention forward (K1's operator, whose
gradient is K2 inside ``_FlashAttention``) is traced as its primal only,
so differentiating a partitioned graph that holds it raises
``MXNetError`` rather than silently dropping K2.

Client: :func:`int8_dot_property`, dynamically quantized int8 products
(the JAX package computes them with XLA's int8 dot, not in a Pallas
kernel; here the exact integer sums are formed in float64).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ..base import MXNetError

__all__ = ["SubgraphProperty", "partition", "int8_dot_property"]

# operators whose gradient is hand-written: traced as their primal only
_CUSTOM_GRADIENT = ("mxnet_tpu_torch.flash_fwd",)


class SubgraphProperty:
    """Backend contract (SelectSubgraphNode / CreateSubgraphNode split)."""

    def match(self, node: torch.fx.Node) -> bool:
        """Should this node join a subgraph?"""
        raise NotImplementedError

    def make_subgraph_fn(self, gm: torch.fx.GraphModule) -> Optional[Callable]:
        """Replacement for a carved subgraph: a callable taking the
        subgraph's inputs and returning a tuple of its outputs. ``None``
        keeps the original nodes (the property can decline after seeing the
        whole subgraph)."""
        raise NotImplementedError


def _segment(nodes, match):
    """Maximal contiguous runs of matching nodes: [('seg'|'node', x)]."""
    plan, cur = [], []
    for node in nodes:
        if match(node):
            cur.append(node)
            continue
        if cur:
            plan.append(("seg", cur))
            cur = []
        plan.append(("node", node))
    if cur:
        plan.append(("seg", cur))
    return plan


def _subgraph(seg, used_after):
    """(inputs, outputs, GraphModule) of a run of nodes: inputs are the
    values it reads from outside, outputs the values it defines that later
    nodes (or the graph's outputs) read, in order."""
    graph = torch.fx.Graph()
    env, inputs, inside = {}, [], set(seg)
    for node in seg:
        for a in node.all_input_nodes:
            if a not in inside and a not in env:
                env[a] = graph.placeholder(f"in{len(inputs)}")
                inputs.append(a)
        env[node] = graph.node_copy(node, lambda a: env[a])
    outs = [n for n in seg if n in used_after]
    graph.output(tuple(env[o] for o in outs))
    return inputs, outs, torch.fx.GraphModule(torch.nn.Module(), graph)


class _PrimalOnly(torch.autograd.Function):
    """An operator with a hand-written gradient, evaluated as its primal:
    differentiating through it raises."""

    @staticmethod
    def forward(ctx, name, fn, *xs):
        ctx.name = name
        out = fn(*xs)
        return tuple(out) if isinstance(out, (tuple, list)) else out

    @staticmethod
    def backward(ctx, *grads):
        raise MXNetError(
            f"partition(): differentiating a partitioned graph through a {ctx.name} op "
            "would silently ignore its hand-written derivative rule (the flash-attention "
            "backward, K2). Differentiate the original (unpartitioned) callable, or "
            "partition only inference graphs.")


def _call(node: torch.fx.Node, read):
    args = torch.fx.node.map_arg(node.args, read)
    kwargs = torch.fx.node.map_arg(node.kwargs, read)
    name = str(node.target).rsplit(".", 1)[0]
    if name in _CUSTOM_GRADIENT:
        if kwargs:
            raise MXNetError(f"partition(): keyword arguments of {name} are not passed")
        tensors = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor)]
        rest = list(args)

        def primal(*xs):
            for i, x in zip(tensors, xs):
                rest[i] = x
            return node.target(*rest)
        return _PrimalOnly.apply(name, primal, *[args[i] for i in tensors])
    return node.target(*args, **kwargs)


def partition(fn: Callable, example_args: Sequence, prop: SubgraphProperty):
    """Trace ``fn`` (a function of tensors) on ``example_args``,
    substitute matching subgraphs via ``prop``, and return ``(new_fn,
    report)``: ``new_fn(*args)`` returns the tuple of ``fn``'s flat
    outputs, ``report`` lists the carved subgraphs as (n_nodes, [operator
    names])."""
    from torch.fx.experimental.proxy_tensor import make_fx
    with torch.no_grad():
        gm = make_fx(fn)(*[a.detach() if isinstance(a, torch.Tensor) else a
                           for a in example_args])
    graph = gm.graph
    placeholders = [n for n in graph.nodes if n.op == "placeholder"]
    out_node = next(n for n in graph.nodes if n.op == "output")
    calls = [n for n in graph.nodes if n.op == "call_function"]
    plan_raw = _segment(calls, prop.match)

    # values read after each plan position (a suffix scan), so a segment
    # returns only what the rest of the graph or its outputs read
    suffix = [set(out_node.all_input_nodes)]
    for kind, item in reversed(plan_raw):
        used = set(suffix[-1])
        for node in ([item] if kind == "node" else item):
            used.update(node.all_input_nodes)
        suffix.append(used)
    suffix.reverse()

    plan, report = [], []
    for pos, (kind, item) in enumerate(plan_raw):
        if kind == "node":
            plan.append(("node", item))
            continue
        inputs, outs, sub = _subgraph(item, suffix[pos + 1])
        repl = prop.make_subgraph_fn(sub)
        if repl is None:
            plan.extend(("node", n) for n in item)
            continue
        plan.append(("sub", (inputs, outs, repl)))
        report.append((len(item), [str(n.target) for n in item]))
    attrs = {n: getattr(gm, n.target) for n in graph.nodes if n.op == "get_attr"}

    def run(*args):
        env = dict(attrs)
        flat = torch.utils._pytree.tree_leaves(args)
        for ph, a in zip(placeholders, flat):
            env[ph] = a
        read = env.__getitem__
        for kind, item in plan:
            if kind == "node":
                env[item] = _call(item, read)
                continue
            inputs, outs, repl = item
            res = repl(*[env[v] for v in inputs])
            res = res if isinstance(res, (tuple, list)) else (res,)
            for node, value in zip(outs, res):
                env[node] = value
        result = torch.fx.node.map_arg(out_node.args[0], read)
        return tuple(torch.utils._pytree.tree_leaves(result))

    return run, report


# ---------------------------------------------------------------- clients

_MATMULS = ("aten.mm.default", "aten.addmm.default", "aten.bmm.default",
            "aten.matmul.default")


def _int8_quantize(x):
    """Per-tensor symmetric int8 codes and f32 scale of ``x``: amax / 127
    (1 where x is all zero), codes ``clip(round(x / scale), -127, 127)``."""
    amax = x.abs().max().float()
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    return torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8), scale


def _int8_dot(a, b):
    """``a @ b`` through int8 codes: the integer sums (exact in float64,
    as an int32 accumulator holds them), to f32, times both scales, in
    a's dtype."""
    ai, sa = _int8_quantize(a)
    bi, sb = _int8_quantize(b)
    acc = torch.matmul(ai.double(), bi.double()).float()
    return (acc * (sa * sb)).to(a.dtype)


def int8_dot_property() -> SubgraphProperty:
    """INT8 backend over the partitioner: every matrix product (``mm``,
    ``addmm``, ``bmm``, ``matmul``) subgraph is replaced with a dynamically
    quantized int8 product (per-tensor symmetric scales computed per call,
    int8 x int8 summed exactly, dequantized) — the traced-graph form of
    ``contrib.quantization``'s block rewrite."""

    class Int8Dots(SubgraphProperty):
        def match(self, node):
            return str(node.target) in _MATMULS

        def make_subgraph_fn(self, gm):
            nodes = [n for n in gm.graph.nodes if n.op == "call_function"]
            phs = [n for n in gm.graph.nodes if n.op == "placeholder"]
            out = next(n for n in gm.graph.nodes if n.op == "output")

            def run(*vals):
                env = dict(zip(phs, vals))
                read = env.__getitem__
                for node in nodes:
                    args = torch.fx.node.map_arg(node.args, read)
                    if str(node.target) == "aten.addmm.default":
                        bias, a, b = args[:3]
                        beta = node.kwargs.get("beta", 1)
                        alpha = node.kwargs.get("alpha", 1)
                        env[node] = beta * bias + alpha * _int8_dot(a, b)
                    else:
                        env[node] = _int8_dot(args[0], args[1])
                return tuple(torch.fx.node.map_arg(out.args[0], read))

            return run

    return Int8Dots()
