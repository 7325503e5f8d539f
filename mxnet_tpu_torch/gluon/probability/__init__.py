"""gluon.probability — distributions, transformations, stochastic blocks
(counterpart of ``mxnet_tpu/gluon/probability``)."""
from .distributions import *  # noqa: F401,F403
from .transformation import *  # noqa: F401,F403
from .block import StochasticBlock, DeterministicBlock  # noqa: F401
from .distributions import kl_divergence, register_kl  # noqa: F401
