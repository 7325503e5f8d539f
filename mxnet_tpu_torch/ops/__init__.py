"""Hand-written Hopper kernels of the port, each beside its plain version.
``ops.attention`` is also callable: ``mx.ops.attention(q, k, v,
causal=True)``, the JAX package's NDArray-level fused attention."""
from . import attention  # noqa: F401
