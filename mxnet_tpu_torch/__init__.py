"""mxnet_tpu_torch: the PyTorch / CUDA port of ``mxnet_tpu`` for NVIDIA
Hopper (H100).

The port imports torch and numpy only, never jax and never ``mxnet_tpu``.
Entry points run on the CUDA card unless the caller asks for the CPU
(``with mx.cpu():`` or ``device="cpu"``). Every kernel the JAX package
wrote in Pallas for the TPU is a hand-written CUDA kernel here
(``csrc/``), built at first use; each wrapper dispatches by the tensor's
device: a CPU tensor takes the plain PyTorch version beside the kernel, a
CUDA tensor launches the kernel or raises.

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
Slice 15 is the Gluon substrate: ``NDArray`` (``ndarray``), ``mx.np`` and
``mx.npx``, the autograd tape on PyTorch's autograd (``autograd``,
``_tape``), initializers, ``gluon.Parameter``, ``Block``/``HybridBlock``
with their ``CachedOp`` (CUDA-graph replay on the card), the basic layers
and the losses, so the classic Gluon training loop runs on the card;
``mx.ops.attention`` on the tape runs K1 forward and K2 backward.
"""
import os as _os

from . import base, device
from . import numpy as np
from . import numpy_extension as npx
from . import autograd, random
from .base import MXNetError
from .device import Context, Device, cpu, current_device, gpu, num_gpus
from .ndarray import NDArray, waitall

__all__ = ["MXNetError", "NDArray", "Context", "Device", "autograd", "base", "cpu",
           "current_device", "device", "gpu", "init", "initializer", "gluon", "load",
           "np", "npx", "num_gpus", "ops", "random", "save", "waitall"]

# stack traces on fatal signals, as the JAX package (MXNET_USE_SIGNAL_HANDLER)
if _os.environ.get("MXNET_USE_SIGNAL_HANDLER", "1") not in ("0", "false"):
    import faulthandler as _faulthandler
    try:
        _faulthandler.enable()
    except (AttributeError, OSError, RuntimeError, ValueError):
        pass     # stderr without a file descriptor (captured output)

_LAZY = {"gluon": ".gluon", "init": ".initializer", "initializer": ".initializer",
         "optimizer": ".optimizer", "lr_scheduler": ".lr_scheduler", "ops": ".ops",
         "metrics": ".metrics", "models": ".models", "parallel": ".parallel",
         "serve": ".serve", "serialization": ".serialization", "interop": ".interop"}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(_LAZY[name], __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def save(fname: str, data):
    """Save an NDArray (or tensor), a list or a dict of them in the
    ``.params`` container both packages read."""
    from . import serialization

    def t(a):
        return a._data.detach() if isinstance(a, NDArray) else a
    if isinstance(data, dict):
        data = {k: t(v) for k, v in data.items()}
    elif isinstance(data, (list, tuple)):
        data = [t(v) for v in data]
    else:
        data = t(data)
    serialization.save(fname, data)


def load(fname: str):
    """What :func:`save` (of either package) wrote, as NDArrays on the
    current device: a dict or a list."""
    from . import serialization
    out = serialization.load(fname)
    if isinstance(out, dict):
        return {k: NDArray(v) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return [NDArray(v) for v in out]
    return NDArray(out)
