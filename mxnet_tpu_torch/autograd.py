"""Predict mode (the mode half of ``mxnet_tpu/autograd.py``).

The JAX package's dropout is active only in train mode, and its inference
entry points trace with ``training=False``. The port's layers follow their
module's ``training`` flag, which ``TrainStep`` turns on and leaves on; so
every inference entry point (``generate``, the serving engine's cached
forwards, ``quantize_net``'s calibration) runs inside :func:`predict_mode`,
where ``gluon.nn.Dropout`` is the identity whatever its module's mode. The
scope is per thread: it is entered on the thread that runs the forward.
"""
from __future__ import annotations

import contextlib
import threading

__all__ = ["predict_mode", "is_predicting"]


class _ModeState(threading.local):
    def __init__(self):
        self.depth = 0


_STATE = _ModeState()


@contextlib.contextmanager
def predict_mode():
    """Run the body with dropout off, whatever the modules' modes."""
    _STATE.depth += 1
    try:
        yield
    finally:
        _STATE.depth -= 1


def is_predicting() -> bool:
    return _STATE.depth > 0
