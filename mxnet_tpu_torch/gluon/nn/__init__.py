"""``gluon.nn`` of the port (counterpart of ``mxnet_tpu/gluon/nn``): the
basic layers, and the convolution and pooling layers."""
from ..block import Block, HybridBlock, HybridSequential, Sequential, SymbolBlock  # noqa: F401
from .basic_layers import *  # noqa: F401,F403
from .basic_layers import __all__ as _layers
from .conv_layers import *  # noqa: F401,F403
from .conv_layers import __all__ as _conv_layers

__all__ = ["Block", "HybridBlock", "Sequential", "HybridSequential", "SymbolBlock"] \
    + _layers + _conv_layers
