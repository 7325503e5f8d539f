"""``mx.random`` of the port: seeding the global key stream (the JAX
package's ``mx.random.seed``)."""
from ._random import get_state, seed, set_state

__all__ = ["seed", "get_state", "set_state"]
