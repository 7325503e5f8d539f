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

The embedding cut. An array with ``grad_stype='row_sparse'`` whose every
use the heads reach is an embedding gather of it (``npx.embedding`` tags
the gather's node with its ids, ``EMBED_IDS``) and that is not itself a
head gets its gradient as the gathers' output cotangents: ``backward``
asks ``torch.autograd.grad`` for the gradient at each gather's output
edge instead of at the table, so the gather's backward, the [V, D]
scatter, never runs. The rows and ids go to the array as one row-sparse
gradient (``NDArray._accumulate_grad_rsp``). Any other use of the table
keeps the dense path, as in the JAX package.
"""
from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import torch
from torch.autograd.graph import GradientEdge

from .base import MXNetError

__all__ = ["STATE", "is_recording", "is_training", "is_predicting", "backward",
           "tape_grad", "effective_amp_policy"]


class _AutogradState(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False
        # inside predict_mode(): the port's GPT layers follow their module's
        # mode, and every inference entry point enters this scope to turn
        # their dropout off whatever that mode is
        self.predicting = False
        # this thread's AMP autocast policy (``amp.autocast``, a converted
        # block's forward), over the process-wide one of ``amp.init()``
        self.amp_policy = None
        # set while TrainStep(remat=True) recomputes a forward for its
        # backward: parameter writes (running statistics) are dropped
        self.recomputing = False
        # engine.set_engine_type('NaiveEngine'): every op of the funnel
        # waits for the card before it returns
        self.sync_execution = False


STATE = _AutogradState()

# the process-wide policy of ``amp.init()``; the funnel consults the
# effective policy by op name (``ndarray.apply_multi``)
GLOBAL_AMP_POLICY = None

# STATE.amp_policy value of ``autocast(enabled=False)``: shadows the global
# policy rather than deferring to it
AMP_OFF = object()


def effective_amp_policy():
    pol = STATE.amp_policy
    if pol is None:
        pol = GLOBAL_AMP_POLICY
    return None if pol is AMP_OFF else pol


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


# the key of a gather node's metadata that holds its ids (the embedding cut)
EMBED_IDS = "mx_embedding_ids"


def _reached_leaves(heads: Sequence[torch.Tensor], consumers: Optional[dict] = None):
    """[(array, leaf tensor)] of the attached arrays the graph of ``heads``
    reaches, in the order found. An array rebound after recording may
    appear with its old tensor: the gradient still goes to the array.
    ``consumers``, if given, collects id(leaf tensor) -> [nodes using it]."""
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
                if consumers is not None:
                    leaf = getattr(nxt, "variable", None)
                    if leaf is not None:
                        consumers.setdefault(id(leaf), []).append(fn)
                stack.append(nxt)
    return out


def _cut_sites(pairs, consumers, hs):
    """Split ``pairs`` into dense pairs and row-sparse sites: [(array,
    [gather nodes])] for the leaves the embedding cut applies to."""
    head_ids = {id(t) for t in hs}
    dense, sites = [], []
    for nd, t in pairs:
        if getattr(nd, "_grad_stype", "default") == "row_sparse" and id(t) not in head_ids:
            users = consumers.get(id(t), [])
            if users and all(EMBED_IDS in fn.metadata for fn in users):
                sites.append((nd, users))
                continue
        dense.append((nd, t))
    return dense, sites


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
    consumers: dict = {}
    pairs = _reached_leaves(hs, consumers)
    if not pairs:
        raise MXNetError("backward: no arrays with attached gradients are reachable")
    dense, sites = _cut_sites(pairs, consumers, hs)
    edges = [(nd, fn) for nd, users in sites for fn in users]
    with torch.enable_grad():
        grads = _autograd_grad(hs, [t for _, t in dense] + [GradientEdge(fn, 0) for _, fn in edges],
                               _cotangents(hs, head_grads), retain_graph=retain_graph)
    per: dict = {}
    for (nd, _), g in zip(dense, grads):
        if g is not None:
            prev = per.get(id(nd))
            per[id(nd)] = (nd, g if prev is None else prev[1] + g)
    rows: dict = {}
    for (nd, fn), g in zip(edges, grads[len(dense):]):
        if g is not None:
            rows.setdefault(id(nd), (nd, []))[1].append((fn.metadata[EMBED_IDS], g))
    for key, (nd, parts) in rows.items():
        ids = torch.cat([i.reshape(-1) for i, _ in parts])
        vals = torch.cat([g.reshape((-1,) + tuple(g.shape[i.dim():])) for i, g in parts])
        if key in per:       # the same array also reached densely (a rebound tensor)
            per[key][1].index_add_(0, ids.long(), vals.to(per[key][1].dtype))
        else:
            nd._accumulate_grad_rsp(ids, vals)
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
