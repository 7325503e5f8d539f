"""mxnet_tpu_torch: the PyTorch / CUDA port of ``mxnet_tpu`` for NVIDIA
Hopper (H100).

The port imports torch and numpy only, never jax and never ``mxnet_tpu``.
Entry points run on the CUDA card unless the caller passes
``device="cpu"``. Every kernel the JAX package wrote in Pallas for the TPU
is a hand-written CUDA kernel here (``csrc/``), built at first use; each
wrapper dispatches by the tensor's device: a CPU tensor takes the plain
PyTorch version beside the kernel, a CUDA tensor launches the kernel or
raises.

This slice serves int8 GPT-2 through ``InferenceEngine`` with kernels K3
(int8 GEMV), K5 (one-launch block decode) and K8 (fused LM-head sampler).
"""
from . import base, device
from .base import MXNetError

__all__ = ["MXNetError", "base", "device"]
