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
Slice 17 trains Llama, dense and MoE, through a single-device ``TrainStep``.
Slice 18 is the conv path: ``npx.convolution``/``deconvolution``/``pooling``,
the conv and pool layers, the fused conv + BN composites
(``ops.fused_conv``), ``amp``, the vision model zoo
(``gluon.model_zoo``) and ``models.ViTModel``, so ResNet-50 and ViT train
on the card.
Slice 19 trains BERT (``models.BertForSequenceClassification``,
``BertForPretraining``; ``ops.attention.flash_attention_bthd`` with its
key-mask and attention-dropout routes) and T5 (``models.T5Model``), with
the rest of the optimizer registry (LAMB among it), ``optimizer.updater``
and the evaluation metrics (``mx.metric``, ``gluon.metric``).
Slice 20 serves from a fleet of replicas: the router (``serve.Router``:
affinity, tenants, drains), the autoscale controller (``serve.
FleetController``), KV-page migration between replicas and packages
(``serve.cachefleet``, ``kvstore.comm``) and prefill / decode tiers,
with ``observability.aggregate`` merging the replicas' metrics.
Slice 21 is the input path: ``gluon.data`` (datasets, samplers, batchify,
the ``DataLoader`` with thread and forked process workers over shared
memory, pinned uploads; vision datasets and transforms), ``pipeline``
(``DevicePrefetcher``: staging on a CUDA stream of its own), ``io`` and
``recordio``, ``image``, ``gluon.utils`` and ``gluon.contrib.estimator``.
Row-sparse gradients and lazy sparse training (``sparse``,
``Embedding(sparse_grad=True)``, ``Optimizer.update_step_rsp``) came with
the rejection samplers of ``np.random``, the legacy ``nd`` namespace,
custom operators (``operator``), loaded operator libraries (``library``),
and ``engine``, ``runtime``, ``util``, ``test_utils`` and
``visualization``.
Slice 16 serves Llama (``models.LlamaForCausalLM``: GQA, RoPE, RMSNorm,
SwiGLU, per-layer and stacked decoders) from the same engine at
Llama-3-8B's width: K1 at head dim 128, K3/K4 at its widths and K8 on a
tied head.
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
           "current_device", "device", "gpu", "init", "initializer", "gluon", "load", "amp",
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
         "kv": ".kvstore", "kvstore": ".kvstore", "metrics": ".metrics",
         "models": ".models", "parallel": ".parallel", "profiler": ".profiler",
         "serve": ".serve", "observability": ".observability", "contrib": ".contrib",
         "checkpoint": ".checkpoint", "serialization": ".serialization",
         "interop": ".interop", "amp": ".amp", "metric": ".gluon.metric",
         "pipeline": ".pipeline", "io": ".io", "recordio": ".io.recordio", "image": ".image",
         "nd": ".nd", "sparse": ".sparse", "engine": ".engine", "util": ".util",
         "test_utils": ".test_utils", "visualization": ".visualization",
         "viz": ".visualization", "library": ".library", "runtime": ".runtime",
         "operator": ".operator", "sym": ".symbol", "symbol": ".symbol", "onnx": ".onnx"}


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
    dev = current_device()
    if isinstance(out, dict):
        return {k: NDArray(v, device=dev) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return [NDArray(v, device=dev) for v in out]
    return NDArray(out, device=dev)
