"""Network visualization (counterpart of ``mxnet_tpu/visualization.py``):
``print_summary`` and ``plot_network``.

Both views run one forward of the live block tree with forward hooks
(``Block._forward_hooks``) on every block, recording each block's output
shape and parameter count in call order, so blocks with a custom
``forward`` show their children too. A hybridized block runs that forward
with its cached executor suspended (its cache is kept). ``plot_network``
returns DOT source text; rendering needs a graphviz ``dot`` binary."""
from __future__ import annotations

from typing import List, Optional

import numpy as onp

from .base import MXNetError
from .gluon.block import Block
from .ndarray import NDArray

__all__ = ["print_summary", "plot_network"]


def _param_count(block: Block, own_only: bool = True) -> int:
    params = block._reg_params.values() if own_only \
        else block.collect_params().values()
    total = 0
    for p in params:
        if p._var is not None:
            total += int(onp.prod(p.shape))
        elif p.shape is not None and all(s > 0 for s in p.shape):
            total += int(onp.prod(p.shape))
    return total


def _example_inputs(inputs) -> list:
    """Shapes (tuples) become f32 zero arrays on the current device; a list
    (a recurrent block's states) is passed as it is; anything else becomes
    an array."""
    return [NDArray(onp.zeros(x, onp.float32)) if isinstance(x, tuple) else
            x if isinstance(x, (NDArray, list)) else NDArray(x) for x in inputs]


def _record_calls(net: Block, *inputs):
    """Run a forward, recording (path, type, out_shape, n_params, is_leaf)
    per block in call order."""
    records: List[tuple] = []
    paths = {}

    def assign_paths(b, prefix=""):
        paths[id(b)] = prefix or type(b).__name__.lower()
        for name, c in b._children.items():
            assign_paths(c, f"{prefix}.{name}" if prefix else name)

    assign_paths(net)
    handles = []

    def make_hook(b):
        def hook(block, args, out):
            shape = getattr(out[0] if isinstance(out, tuple) else out,
                            "shape", None)
            records.append((paths.get(id(b), "?"), type(b).__name__,
                            tuple(shape) if shape is not None else None,
                            _param_count(b), len(b._children) == 0))
        return hook

    def walk(b):
        h = make_hook(b)
        b._forward_hooks.append(h)
        handles.append((b, h))
        for c in b._children.values():
            walk(c)

    # run the recording forward with every cached executor suspended (its
    # entries and graphs are kept)
    deactivated = []

    def suspend(b):
        if getattr(b, "_active", False):
            b._active = False
            deactivated.append(b)
        for c in b._children.values():
            suspend(c)

    walk(net)
    suspend(net)
    try:
        net(*inputs)
    finally:
        for b in deactivated:
            b._active = True
        for b, h in handles:
            b._forward_hooks.remove(h)
    return records


def print_summary(net: Block, *inputs, line_length: int = 76):
    """Print and return a table of each block's output shape and parameter
    count. ``inputs`` are the forward's example arguments: arrays, shapes
    (tuples become f32 zero arrays on the current device) or lists of
    state arrays."""
    arrays = _example_inputs(inputs)
    if not arrays:
        raise MXNetError("print_summary needs an example input or shape")
    records = _record_calls(net, *arrays)
    hdr = f"{'Layer (type)':<34}{'Output Shape':<24}{'Param #':>12}"
    lines = ["-" * line_length, hdr, "=" * line_length]
    seen_paths = set()
    total = 0
    for path, tname, shape, n, _is_leaf in records:
        label = f"{path} ({tname})"
        if len(label) > 33:
            label = label[:30] + "..."
        lines.append(f"{label:<34}{str(shape):<24}{n:>12,}")
        if path not in seen_paths:      # a reused block's parameters count once
            seen_paths.add(path)
            total += n
    lines += ["=" * line_length,
              f"Total params: {total:,}",
              f"Input shape(s): {[tuple(a.shape) for a in arrays if hasattr(a, 'shape')]}",
              "-" * line_length]
    out = "\n".join(lines)
    print(out)
    return out


class Digraph:
    """DOT source with graphviz's ``Digraph`` surface: ``save``, and
    ``render`` where a ``dot`` binary is installed."""

    def __init__(self, source: str, name: str = "plot"):
        self.source = source
        self.name = name

    def save(self, filename: str):
        with open(filename, "w") as f:
            f.write(self.source)
        return filename

    def render(self, filename: Optional[str] = None, format: str = "pdf"):
        import shutil
        import subprocess
        import tempfile
        if shutil.which("dot") is None:
            raise MXNetError("graphviz 'dot' binary not found; use .source "
                             "or .save() and render elsewhere")
        src = filename or self.name
        self.save(src + ".dot")
        out = f"{src}.{format}"
        subprocess.run(["dot", f"-T{format}", src + ".dot", "-o", out],
                       check=True)
        return out

    def _repr_svg_(self):  # notebooks, where dot is installed
        try:
            import subprocess
            return subprocess.run(
                ["dot", "-Tsvg"], input=self.source.encode(),
                capture_output=True, check=True).stdout.decode()
        except Exception:
            return None


_NODE_STYLE = {
    "Conv": ("#fb8072", "box"), "Dense": ("#fb8072", "box"),
    "BatchNorm": ("#bebada", "box"), "LayerNorm": ("#bebada", "box"),
    "Activation": ("#ffffb3", "ellipse"), "ReLU": ("#ffffb3", "ellipse"),
    "Pool": ("#80b1d3", "box"), "Flatten": ("#fdb462", "box"),
    "Dropout": ("#b3de69", "ellipse"), "Embedding": ("#fccde5", "box"),
}


def _style_for(tname: str):
    for key, style in _NODE_STYLE.items():
        if key in tname:
            return style
    return ("#8dd3c7", "box")


def plot_network(net: Block, *inputs, title: str = "plot",
                 hide_weights: bool = True) -> Digraph:
    """A DOT graph of the forward: the leaf blocks in call order, chained
    from the input; returns a ``Digraph`` whose ``.source`` is the text."""
    arrays = _example_inputs(inputs)
    if not arrays:
        raise MXNetError("plot_network needs an example input or shape")
    records = _record_calls(net, *arrays)
    leaf = [r for r in records if r[4]]
    lines = [f'digraph "{title}" {{', "  rankdir=TB;",
             '  node [fontsize=10, height=0.3];',
             f'  data [label="data\\n{tuple(arrays[0].shape)}", '
             'shape=oval, style=filled, fillcolor="#d9d9d9"];']
    prev = "data"
    for i, (path, tname, shape, n, _) in enumerate(leaf):
        color, shape_kind = _style_for(tname)
        label = f"{path}\\n{tname}"
        if shape is not None:
            label += f"\\n{shape}"
        if not hide_weights and n:
            label += f"\\nparams: {n:,}"
        node = f"n{i}"
        lines.append(f'  {node} [label="{label}", shape={shape_kind}, '
                     f'style=filled, fillcolor="{color}"];')
        lines.append(f"  {prev} -> {node};")
        prev = node
    lines.append("}")
    return Digraph("\n".join(lines), name=title)
