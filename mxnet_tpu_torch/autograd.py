"""Public autograd API: record/pause scopes, backward, grad and custom
``Function`` (counterpart of ``mxnet_tpu/autograd.py``), on the tape of
``_tape.py``.

Gluon layers follow ``is_training()`` as in the JAX package. The port's
GPT layers (``models/_layers.py``) follow their module's ``training``
flag instead, which ``TrainStep`` turns on and leaves on; so every
inference entry point (``generate``, the serving engine's cached
forwards, ``quantize_net``'s calibration) runs inside
:func:`predict_mode`, where those layers' dropout is the identity
whatever their module's mode (:func:`is_predicting`). Scopes are per
thread.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Union

import torch

from . import _tape
from ._tape import is_predicting, is_recording, is_training
from .base import MXNetError
from .ndarray import NDArray, apply_multi

__all__ = [
    "record", "pause", "train_mode", "predict_mode", "is_recording", "is_training",
    "is_predicting", "set_recording", "set_training", "backward", "grad",
    "mark_variables", "Function",
]


class _Scope(contextlib.ContextDecorator):
    """A mode scope; also a decorator (each call enters a fresh scope)."""

    def __init__(self, recording: Optional[bool], training: Optional[bool],
                 predicting: Optional[bool] = None):
        self._set = (recording, training, predicting)

    def _recreate_cm(self):
        return _Scope(*self._set)

    def __enter__(self):
        st = _tape.STATE
        self._prev = (st.recording, st.training, st.predicting)
        rec, train, pred = self._set
        if rec is not None:
            st.recording = rec
        if train is not None:
            st.training = train
        if pred is not None:
            st.predicting = pred
        return self

    def __exit__(self, *exc):
        st = _tape.STATE
        st.recording, st.training, st.predicting = self._prev
        return False


def record(train_mode: bool = True) -> _Scope:
    """Scope whose ops are recorded for differentiation."""
    return _Scope(True, train_mode, False if train_mode else None)


def pause(train_mode: bool = False) -> _Scope:
    """Scope in which recording is suspended."""
    return _Scope(False, train_mode)


def train_mode() -> _Scope:
    return _Scope(None, True, False)


def predict_mode() -> _Scope:
    """Training off for gluon layers, and dropout off for the GPT layers
    whatever their module's mode."""
    return _Scope(None, False, True)


def set_recording(flag: bool) -> bool:
    prev = _tape.STATE.recording
    _tape.STATE.recording = bool(flag)
    return prev


def set_training(flag: bool) -> bool:
    prev = _tape.STATE.training
    _tape.STATE.training = bool(flag)
    return prev


def mark_variables(variables: Sequence[NDArray], gradients: Sequence[NDArray],
                   grad_reqs: Union[str, Sequence[str]] = "write") -> None:
    """Make arrays leaves of the tape with the given gradient buffers."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        v._grad_req = req
        v._make_leaf(v._data)
        v._grad = g


def _listify(x):
    return [x] if isinstance(x, NDArray) else x


def backward(heads, head_grads=None, retain_graph: bool = False,
             train_mode: bool = True) -> None:
    heads = _listify(heads)
    if head_grads is not None:
        head_grads = _listify(head_grads)
    _tape.backward(heads, head_grads, retain_graph=retain_graph)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph: bool = False, train_mode: bool = True) -> List[NDArray]:
    """Gradients of ``heads`` with respect to ``variables``; recorded for a
    higher-order gradient with ``create_graph=True`` inside ``record()``."""
    heads, variables = _listify(heads), _listify(variables)
    if head_grads is not None:
        head_grads = _listify(head_grads)
    if not variables:
        raise MXNetError("autograd.grad: empty variables")
    return [NDArray._new(g) for g in _tape.tape_grad(
        heads, variables, head_grads, create_graph=create_graph,
        retain_graph=retain_graph)]


class _UserFunction(torch.autograd.Function):
    """Runs a :class:`Function`'s forward and backward on NDArrays, paused."""

    @staticmethod
    def forward(ctx, fobj, *datas):
        ctx.fobj = fobj
        with pause():
            outs = fobj.forward(*[NDArray._new(d) for d in datas])
        ctx.single = isinstance(outs, NDArray)
        return outs._data if ctx.single else tuple(o._data for o in outs)

    @staticmethod
    def backward(ctx, *cts):
        with pause():
            grads = ctx.fobj.backward(*[NDArray._new(c) for c in cts])
        if isinstance(grads, NDArray):
            grads = (grads,)
        return (None,) + tuple(g._data for g in grads)


class Function:
    """User-defined differentiable function: subclasses override
    ``forward`` and ``backward`` (on NDArrays); it runs as a
    ``torch.autograd.Function`` on the tape."""

    def __init__(self):
        self._saved = ()

    def save_for_backward(self, *arrays):
        self._saved = tuple(a._data.detach() if isinstance(a, NDArray) else a
                            for a in arrays)

    @property
    def saved_tensors(self):
        return tuple(NDArray._new(s) for s in self._saved)

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        arrays = [a if isinstance(a, NDArray) else NDArray(a) for a in inputs]
        return apply_multi(lambda *d: _UserFunction.apply(self, *d), arrays)
