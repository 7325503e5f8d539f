"""Gluon of the port (counterpart of ``mxnet_tpu/gluon``): ``Parameter``,
``Block``/``HybridBlock`` and their ``CachedOp``, the basic layers, the
losses, the ``Trainer`` and parameter files."""
from . import block, loss, nn, parameter
from .block import (Block, HybridBlock, HybridSequential, Sequential, SymbolBlock,
                    load_parameters, save_parameters)
from .parameter import Constant, Parameter
from .trainer import Trainer

__all__ = ["Block", "Constant", "HybridBlock", "HybridSequential", "Parameter",
           "Sequential", "SymbolBlock", "Trainer", "block", "load_parameters", "loss",
           "nn", "parameter", "save_parameters"]
