"""Gluon layers of the port (counterpart of ``mxnet_tpu/gluon``)."""
from . import nn

__all__ = ["nn"]
