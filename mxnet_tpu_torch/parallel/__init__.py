"""Training steps of the port (counterpart of ``mxnet_tpu/parallel``): a
single-device ``TrainStep``. Meshes, ZeRO and the collectives come later."""
from .train import TrainStep

__all__ = ["TrainStep"]
