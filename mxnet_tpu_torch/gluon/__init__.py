"""Gluon layers, losses, the single-device ``Trainer`` and parameter files
of the port (counterpart of ``mxnet_tpu/gluon``)."""
from . import loss, nn
from .block import load_parameters, save_parameters
from .trainer import Trainer

__all__ = ["Trainer", "load_parameters", "loss", "nn", "save_parameters"]
