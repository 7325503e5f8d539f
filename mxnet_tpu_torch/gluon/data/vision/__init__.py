"""gluon.data.vision (counterpart of ``mxnet_tpu/gluon/data/vision``)."""
from . import transforms
from .datasets import *  # noqa: F401,F403
