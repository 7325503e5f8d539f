"""Updater: an optimizer applied by index to weights held elsewhere
(counterpart of ``mxnet_tpu/optimizer/updater.py``, the reference's
update-on-kvstore role). ``get_states`` pickles the states as numpy arrays
in the JAX package's layout ({index: tuple of arrays}, optionally with the
optimizer), so either package's states load in the other."""
from __future__ import annotations

import pickle
from typing import Any, Dict

from . import _tensor

__all__ = ["Updater", "get_updater"]


class Updater:
    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states: Dict[Any, Any] = {}

    def __call__(self, index, grad, weight):
        """Step ``weight`` (an NDArray or a tensor, in place) with ``grad``
        under the state of ``index``, created on first use."""
        w = _tensor(weight)
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, w)
        # states loaded by set_states arrive on the host
        state = tuple(s.to(w.device) if s.is_floating_point() else s
                      for s in self.states[index])
        self.states[index] = self.optimizer.update(index, weight, grad, state)

    def get_states(self, dump_optimizer: bool = False) -> bytes:
        from ..gluon.trainer import _leaf_to_numpy
        host = {i: tuple(_leaf_to_numpy(s.detach().cpu()) for s in st)
                for i, st in self.states.items()}
        return pickle.dumps((host, self.optimizer) if dump_optimizer else host)

    def set_states(self, states: bytes):
        """Load what :meth:`get_states` of either package wrote (only bytes
        this program or a trusted peer wrote: unpickling runs code)."""
        from ..gluon.trainer import _leaf_from_numpy
        obj = pickle.loads(states)
        if isinstance(obj, tuple) and len(obj) == 2:
            obj, self.optimizer = obj
        self.states = {i: tuple(_leaf_from_numpy(a, "cpu") for a in st)
                       for i, st in obj.items()}


def get_updater(optimizer) -> Updater:
    return Updater(optimizer)
