"""gluon.contrib (counterpart of ``mxnet_tpu/gluon/contrib``)."""
from . import estimator  # noqa: F401
