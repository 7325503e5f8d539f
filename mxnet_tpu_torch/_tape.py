"""The autograd tape on PyTorch's autograd (counterpart of
``mxnet_tpu/_tape.py``).

The JAX package records a node per op inside ``autograd.record()`` and
differentiates a replay of the recorded subgraph with ``jax.vjp``. Here
the funnel (``ndarray.apply_multi``) runs every op of an ``NDArray`` under
``torch.set_grad_enabled(is_recording())``, so PyTorch's own graph is the
tape and it holds exactly the ops run inside ``record()``: an op outside
it builds no graph, even on an array with a gradient attached.
``attach_grad`` makes the array's tensor a leaf that requires grad and
points back at its array (``_mx_owner``, a weak reference).

:func:`backward` walks the graph from the heads to the leaves it reaches,
takes their gradients with ``torch.autograd.grad`` and writes them into
each array's gradient buffer under its ``grad_req``: ``'write'``
overwrites the buffer in place (code that cached ``x.grad`` sees the new
value), ``'add'`` adds to it. Without ``retain_graph`` the heads are cut
from the graph afterwards, so a second ``backward`` on them raises, as in
the JAX package. :func:`tape_grad` is the functional form, recorded
itself with ``create_graph`` inside ``record()`` (higher-order gradients).
"""
from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import torch

from .base import MXNetError

__all__ = ["STATE", "is_recording", "is_training", "is_predicting", "backward",
           "tape_grad"]


class _AutogradState(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False
        # inside predict_mode(): the port's GPT layers follow their module's
        # mode, and every inference entry point enters this scope to turn
        # their dropout off whatever that mode is
        self.predicting = False


STATE = _AutogradState()


def is_recording() -> bool:
    return STATE.recording


def is_training() -> bool:
    return STATE.training


def is_predicting() -> bool:
    return STATE.predicting


def _owner(t):
    ref = getattr(t, "_mx_owner", None)
    return None if ref is None else ref()


def _check_head(h) -> torch.Tensor:
    t = h._data
    if t.grad_fn is None and not (t.requires_grad and h._grad_req != "null"):
        raise MXNetError("cannot differentiate: output was not computed inside "
                         "autograd.record() and has no grad attached")
    return t


def _reached_leaves(heads: Sequence[torch.Tensor]):
    """[(array, leaf tensor)] of the attached arrays the graph of ``heads``
    reaches, in the order found. An array rebound after recording may
    appear with its old tensor: the gradient still goes to the array."""
    out, seen_t = [], set()

    def take(t):
        nd = _owner(t)
        if nd is not None and nd._grad_req != "null" and id(t) not in seen_t:
            seen_t.add(id(t))
            out.append((nd, t))

    stack, seen = [], set()
    for t in heads:
        if t.grad_fn is None:
            take(t)
        else:
            stack.append(t.grad_fn)
    while stack:
        fn = stack.pop()
        if fn in seen:
            continue
        seen.add(fn)
        var = getattr(fn, "variable", None)
        if var is not None:
            take(var)
        for nxt, _ in fn.next_functions:
            if nxt is not None:
                stack.append(nxt)
    return out


def _cotangents(hs, head_grads):
    if head_grads is None:
        return [torch.ones_like(t) for t in hs]
    out = []
    for t, g in zip(hs, head_grads):
        if g is None:
            out.append(torch.ones_like(t))
        else:
            g = g._data if hasattr(g, "_data") else torch.as_tensor(g)
            out.append(g.detach().to(device=t.device, dtype=t.dtype).expand_as(t))
    return out


def _autograd_grad(hs, inputs, cts, **kw):
    try:
        return torch.autograd.grad(hs, inputs, cts, allow_unused=True, **kw)
    except RuntimeError as e:
        if "second time" in str(e) or "freed" in str(e):
            raise MXNetError("backward: the graph was already freed; pass "
                             "retain_graph=True to the first backward") from e
        raise


def backward(heads: Sequence, head_grads: Optional[Sequence] = None,
             retain_graph: bool = False) -> None:
    """Gradients of ``heads`` into every reachable attached array."""
    hs = [_check_head(h) for h in heads]
    pairs = _reached_leaves(hs)
    if not pairs:
        raise MXNetError("backward: no arrays with attached gradients are reachable")
    with torch.enable_grad():
        grads = _autograd_grad(hs, [t for _, t in pairs], _cotangents(hs, head_grads),
                               retain_graph=retain_graph)
    per: dict = {}
    for (nd, _), g in zip(pairs, grads):
        if g is not None:
            prev = per.get(id(nd))
            per[id(nd)] = (nd, g if prev is None else prev[1] + g)
    for nd, g in per.values():
        nd._accumulate_grad(g)
    if not retain_graph:
        for h in heads:
            if h._data.grad_fn is not None:
                h._data = h._data.detach()


def tape_grad(heads: Sequence, variables: Sequence, head_grads: Optional[Sequence] = None,
              create_graph: bool = False, retain_graph: Optional[bool] = None) -> List:
    """Gradients of ``heads`` with respect to ``variables`` (attached arrays
    or recorded intermediates), as tensors; recorded themselves when
    ``create_graph`` is given inside ``record()``. The graph is kept unless
    ``retain_graph=False``, as the JAX package's replay keeps it."""
    hs = [_check_head(h) for h in heads]
    create = bool(create_graph) and STATE.recording
    live = [i for i, v in enumerate(variables) if v._data.requires_grad]
    out = [torch.zeros_like(v._data).detach() for v in variables]
    if live:
        with torch.enable_grad():
            grads = _autograd_grad(
                hs, [variables[i]._data for i in live], _cotangents(hs, head_grads),
                retain_graph=create or retain_graph is None or bool(retain_graph),
                create_graph=create)
        for i, g in zip(live, grads):
            if g is not None:
                out[i] = g if create else g.detach()
    return out
