"""Gluon of the port (counterpart of ``mxnet_tpu/gluon``): ``Parameter``,
``Block``/``HybridBlock`` and their ``CachedOp``, the basic, convolution
and pooling layers, the losses, the ``Trainer``, parameter files and the
vision model zoo, the evaluation metrics, ``data`` (datasets and the
``DataLoader``), ``utils``, ``contrib`` (the ``Estimator``), ``rnn``
(the recurrent layers and cells) and ``probability`` (distributions,
transformations, stochastic blocks)."""
from . import (block, contrib, data, loss, metric, model_zoo, nn, parameter, probability,
               rnn, utils)
from .block import (Block, HybridBlock, HybridSequential, Sequential, SymbolBlock,
                    load_parameters, save_parameters)
from .parameter import Constant, Parameter
from .trainer import Trainer

__all__ = ["Block", "Constant", "HybridBlock", "HybridSequential", "Parameter",
           "Sequential", "SymbolBlock", "Trainer", "block", "contrib", "data",
           "load_parameters", "loss", "metric", "model_zoo", "nn", "parameter", "probability",
           "rnn", "save_parameters", "utils"]
