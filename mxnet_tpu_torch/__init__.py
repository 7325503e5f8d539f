"""mxnet_tpu_torch: the PyTorch / CUDA port of ``mxnet_tpu`` for NVIDIA
Hopper (H100).

The port imports torch and numpy only, never jax and never ``mxnet_tpu``.
Entry points run on the CUDA card unless the caller passes
``device="cpu"``. Every kernel the JAX package wrote in Pallas for the TPU
is a hand-written CUDA kernel here (``csrc/``), built at first use; each
wrapper dispatches by the tensor's device: a CPU tensor takes the plain
PyTorch version beside the kernel, a CUDA tensor launches the kernel or
raises.

Slice 1 serves int8 GPT-2 through ``InferenceEngine`` with kernels K3
(int8 GEMV), K5 (one-launch block decode) and K8 (fused LM-head sampler).
Slice 2 trains GPT-2 through ``parallel.TrainStep`` and ``gluon.Trainer``,
its attention carried by K1 (flash-attention forward) and K2 (backward).
Slice 3 serves GPT-2 from the paged KV pool (``serve.paging``,
``InferenceEngine(paged=True)``) with K6 (paged block decode, pages
gathered into shared memory) and K7 (pages streamed by TMA bulk copies).
Slice 4 serves GPT-2 with packed int4 weights (``quantize_net(bits=4)``,
the ``kvstore.quant`` codec) through K4 (int4 GEMV) and the int4 weight
lanes of K5, K6, K7 and K8.
Slice 12 trains the default GPT-2 config (dropout 0.1, masks from the JAX
package's counter-hash stream: ``random``, ``_random``,
``numpy_extension.dropout``) with ``lr_scheduler``s, and keeps and resumes
runs in the JAX package's files (``serialization``, ``gluon``'s parameter
files, ``Trainer`` states, ``checkpoint.CheckpointManager``).
Slice 14 serves over HTTP (``serve.HTTPFrontend``) with the JAX package's
metric families (``metrics``), request traces and the flight recorder
(``observability``), teacher-forced scoring, drains and live weight swaps
from published versions (``serve.registry``).
"""
from . import base, device
from .base import MXNetError

__all__ = ["MXNetError", "base", "device"]
