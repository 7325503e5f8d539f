"""Control-flow operators (counterpart of
``mxnet_tpu/numpy_extension/control_flow.py``): ``foreach``,
``while_loop`` and ``cond``.

The JAX package runs a recorded loop eagerly and an unrecorded one as one
``lax.scan``. Here both are eager Python loops over the data's device:
every body op goes through the funnel, so inside ``autograd.record()`` the
loop is on the tape and gradients reach closed-over parameters, as in the
JAX package's recorded path. The JAX package's contracts are kept:

- ``while_loop`` needs ``max_iterations``; its outputs are stacked to
  ``max_iterations`` rows, zero after the loop ended, and a loop whose
  condition is false at once returns zero rows shaped by one call of
  ``func`` under ``autograd.pause()``. Each iteration reads the condition
  on the host (one sync an iteration).
- ``cond`` evaluates both branches and selects with ``where``.
- A zero-length ``foreach`` returns ``[0, ...]`` outputs shaped by one call
  of ``body`` on a zero slice under ``autograd.pause()``, and the initial
  states.
"""
from __future__ import annotations

from typing import Callable

import torch

from .. import autograd
from ..base import MXNetError
from ..ndarray import NDArray, apply, apply_multi

__all__ = ["foreach", "while_loop", "cond"]


def _flatten(tree):
    """Leaves of nested lists, tuples and dicts, and the structure to put
    them back (:func:`_unflatten`)."""
    if isinstance(tree, (list, tuple)):
        leaves, specs = [], []
        for x in tree:
            lv, sp = _flatten(x)
            leaves += lv
            specs.append(sp)
        return leaves, (type(tree), specs)
    if isinstance(tree, dict):
        leaves, specs = [], []
        for k in tree:
            lv, sp = _flatten(tree[k])
            leaves += lv
            specs.append((k, sp))
        return leaves, (dict, specs)
    return [tree], None


def _unflatten(spec, leaves):
    it = iter(leaves)

    def build(sp):
        if sp is None:
            return next(it)
        kind, subs = sp
        if kind is dict:
            return {k: build(s) for k, s in subs}
        return kind(build(s) for s in subs)
    return build(spec)


def _arr(x):
    return x if isinstance(x, (NDArray, torch.Tensor)) else NDArray(x)


def _stack(col):
    return apply_multi(lambda *ts: torch.stack(ts), [_arr(c) for c in col])


def _zeros_rows(template, rows: int):
    """``rows`` zero rows shaped and typed as ``template``."""
    return apply(lambda t: torch.zeros((rows,) + tuple(t.shape), dtype=t.dtype,
                                       device=t.device), _arr(template))


def _stacked(outs_seq, pad_to=None):
    """Stack the steps' outputs leaf by leaf along a new axis 0, zero rows
    appended up to ``pad_to``."""
    flats = [_flatten(o)[0] for o in outs_seq]
    tree = _flatten(outs_seq[0])[1]
    cols = []
    for j in range(len(flats[0])):
        col = [f[j] for f in flats]
        if pad_to is not None and pad_to > len(col):
            zero = apply(torch.zeros_like, _arr(col[-1]))
            col = col + [zero] * (pad_to - len(col))
        cols.append(_stack(col))
    return _unflatten(tree, cols)


def foreach(body: Callable, data, init_states):
    """Run ``out, states = body(data[i], states)`` over axis 0 of ``data``
    (an array, or a list of arrays sliced together); returns the outputs
    stacked along axis 0 and the final states."""
    single = not isinstance(data, (list, tuple))
    data_list = [_arr(data)] if single else [_arr(d) for d in data]
    n = data_list[0].shape[0]
    if n == 0:
        with autograd.pause():
            zs = [apply(lambda t: torch.zeros(t.shape[1:], dtype=t.dtype, device=t.device), d)
                  for d in data_list]
            template, _ = body(zs[0] if single else zs, init_states)
        leaves, tree = _flatten(template)
        return _unflatten(tree, [_zeros_rows(t, 0) for t in leaves]), init_states
    states, outs_seq = init_states, []
    for i in range(n):
        sl = data_list[0][i] if single else [d[i] for d in data_list]
        out, states = body(sl, states)
        outs_seq.append(out)
    return _stacked(outs_seq), states


def while_loop(cond_fn: Callable, func: Callable, loop_vars, max_iterations: int = None):
    """Iterate ``out, loop_vars = func(*loop_vars)`` while
    ``cond_fn(*loop_vars)`` holds, at most ``max_iterations`` times;
    returns the outputs stacked to ``max_iterations`` rows (zero after the
    last iteration) and the final loop variables."""
    if max_iterations is None:
        raise MXNetError("while_loop requires max_iterations (the JAX package's loop "
                         "needs a static trip bound)")
    variadic = isinstance(loop_vars, (list, tuple))
    vars_ = list(loop_vars) if variadic else [loop_vars]
    outs_seq = []
    for _ in range(max_iterations):
        pred = cond_fn(*vars_)
        if not bool(pred.item() if isinstance(pred, (NDArray, torch.Tensor)) else pred):
            break
        out, new_vars = func(*vars_)
        new_list = list(new_vars) if isinstance(new_vars, (list, tuple)) else [new_vars]
        if len(_flatten(new_list)[0]) != len(_flatten(vars_)[0]):
            raise MXNetError("while_loop: func must return new_loop_vars matching "
                             f"loop_vars ({len(vars_)} items, got {len(new_list)})")
        outs_seq.append(out)
        vars_ = new_list
    final = vars_ if variadic else vars_[0]
    if not outs_seq:
        with autograd.pause():
            template, _ = func(*vars_)
        leaves, tree = _flatten(template)
        return _unflatten(tree, [_zeros_rows(t, max_iterations) for t in leaves]), final
    return _stacked(outs_seq, pad_to=max_iterations), final


def cond(pred, then_func: Callable, else_func: Callable):
    """Evaluate both branches (functions of no arguments) and select each
    output leaf with ``where(pred, then, else)``."""
    then_flat, tree = _flatten(then_func())
    else_flat, _ = _flatten(else_func())
    if len(then_flat) != len(else_flat):
        raise MXNetError("cond: branches must produce the same number of outputs")

    def select(p, a, b):
        dt = torch.promote_types(a.dtype, b.dtype)
        return torch.where(p.reshape(()).bool(), a.to(dt), b.to(dt))
    out = [apply_multi(select, [_arr(pred), _arr(a), _arr(b)], "cond")
           for a, b in zip(then_flat, else_flat)]
    return _unflatten(tree, out)
