"""Gluon layers, losses and the single-device ``Trainer`` of the port
(counterpart of ``mxnet_tpu/gluon``)."""
from . import loss, nn
from .trainer import Trainer

__all__ = ["Trainer", "loss", "nn"]
