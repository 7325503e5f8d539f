"""Functionalize a Gluon block (counterpart of
``mxnet_tpu/parallel/functional.py``): a pure ``apply(param_values,
inputs)`` view of a stateful block.

The view reuses the ``CachedOp``'s parameter discovery (deferred shapes
inferred, parameters in ``collect_params()`` order) and the parameter
bindings of ``gluon.parameter.DRY``: while ``apply`` runs, every
parameter reads its bound value and a write (BatchNorm's running
statistics) is collected instead of stored. Inputs go in as torch
tensors, so the forward is plain PyTorch in the ambient grad mode (a
block called on tensors is a function of its parameters' tensors):
``torch.export`` traces it, and gradients flow to values that require
them.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .. import _prng, autograd
from .._random import KeySupply
from ..gluon.block import _INLINE, CachedOp
from ..gluon.parameter import DRY, Parameter
from ..ndarray import NDArray

__all__ = ["functionalize", "FunctionalModel"]


def _tensor(x):
    if isinstance(x, NDArray):
        return x._data
    return x if isinstance(x, torch.Tensor) else NDArray(x)._data


def _tensors_of(out):
    """``out``'s nesting with every NDArray replaced by its tensor."""
    if isinstance(out, NDArray):
        return out._data
    if isinstance(out, (tuple, list)):
        return type(out)(_tensors_of(o) for o in out)
    if isinstance(out, dict):
        return {k: _tensors_of(v) for k, v in out.items()}
    return out


class FunctionalModel:
    """Pure view of a Gluon block.

    - ``param_items``: ordered [(structural_name, Parameter)]
    - ``values()``: current parameter values (list of tensors)
    - ``apply(values, *inputs, seed, training)`` -> (outputs, aux_updates)
      where aux_updates maps a parameter's slot to its new value
      (BatchNorm's running statistics)
    - ``write_back(values)``: store values into the live Parameters
    """

    def __init__(self, block, example_inputs: Sequence, training: bool = True):
        self.block = block
        op = CachedOp(block)
        op._ensure_params(tuple(x if isinstance(x, NDArray) else NDArray(x)
                                for x in example_inputs))
        self.param_items: List[Tuple[str, Parameter]] = op._param_items
        self.params = [p for _, p in self.param_items]
        self.names = [n for n, _ in self.param_items]
        self.training = training
        #: slots that require gradients
        self.diff_slots = [i for i, p in enumerate(self.params) if p.grad_req != "null"]
        self.aux_slots = [i for i, p in enumerate(self.params) if p.grad_req == "null"]

    def values(self) -> List[torch.Tensor]:
        return [p.data()._data for p in self.params]

    def apply(self, values: Sequence[torch.Tensor], *inputs, seed: Optional[int] = None,
              training: Optional[bool] = None, method: str = "forward"):
        """Pure forward: ``(outputs, aux_updates)``, the outputs' nesting
        over tensors. Draws come from ``KeySupply(key(seed))`` (seed 0 when
        None). ``method`` names another entry point of the block, over the
        parameters the regular forward discovered."""
        training = self.training if training is None else training
        bindings = {p: NDArray._new(v) for p, v in zip(self.params, values)}
        aux: Dict[Parameter, NDArray] = {}
        prev = (DRY.bindings, DRY.pending, DRY.aux)
        DRY.bindings, DRY.pending, DRY.aux = bindings, [], aux
        _INLINE.depth += 1
        try:
            with KeySupply(_prng.key(0 if seed is None else int(seed))), \
                    autograd.pause(train_mode=training), self.block._amp_scope():
                outs = getattr(self.block, method)(*[_tensor(x) for x in inputs])
        finally:
            _INLINE.depth -= 1
            DRY.bindings, DRY.pending, DRY.aux = prev
        slot_of = {id(p): i for i, p in enumerate(self.params)}
        updates = {slot_of[id(p)]: v._data.detach() for p, v in aux.items()
                   if id(p) in slot_of}
        return _tensors_of(outs), updates

    def write_back(self, values: Sequence[torch.Tensor]) -> None:
        for p, v in zip(self.params, values):
            p.data()._write(v)


def functionalize(block, *example_inputs, training: bool = True) -> FunctionalModel:
    return FunctionalModel(block, example_inputs, training=training)
