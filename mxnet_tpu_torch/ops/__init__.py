"""Hand-written Hopper kernels of the port, each beside its plain version.
``ops.attention`` is also callable: ``mx.ops.attention(q, k, v,
causal=True)``, the JAX package's NDArray-level fused attention;
``mx.ops.flash_attention`` is the tensor-level entry."""
from . import attention  # noqa: F401
from .attention import flash_attention

__all__ = ["flash_attention", "attention"]
