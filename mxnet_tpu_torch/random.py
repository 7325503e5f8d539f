"""``mx.random`` of the port: the global key stream's seed and state, and
the JAX package's ``mx.random`` spellings of ``np.random``'s draws
(``size=`` or ``shape=``)."""
from ._random import get_state, seed, set_state

__all__ = ["seed", "get_state", "set_state", "uniform", "normal", "randint"]


def _size(kwargs):
    if "shape" in kwargs:
        kwargs = dict(kwargs)
        kwargs["size"] = kwargs.pop("shape")
    return kwargs


def uniform(low=0.0, high=1.0, *args, **kwargs):
    from .numpy import random as npr
    return npr.uniform(low, high, *args, **_size(kwargs))


def normal(loc=0.0, scale=1.0, *args, **kwargs):
    from .numpy import random as npr
    return npr.normal(loc, scale, *args, **_size(kwargs))


def randint(low, high=None, *args, **kwargs):
    from .numpy import random as npr
    return npr.randint(low, high, *args, **_size(kwargs))
