"""``gluon.nn`` of the port (counterpart of ``mxnet_tpu/gluon/nn``): the
basic layers; the convolution and pooling layers wait for a later slice
(ROADMAP Queue 1)."""
from ..block import Block, HybridBlock, HybridSequential, Sequential, SymbolBlock  # noqa: F401
from .basic_layers import *  # noqa: F401,F403
from .basic_layers import __all__ as _layers

__all__ = ["Block", "HybridBlock", "Sequential", "HybridSequential", "SymbolBlock"] + _layers
