"""What this build has (counterpart of ``mxnet_tpu/runtime.py``,
``mx.runtime.Features``): the CUDA card, cuDNN, NCCL, Triton, whether
the port's hand-written kernels are built for this checkout, the host
libraries. Nothing is assumed: each feature is probed when ``Features()``
is made."""
from __future__ import annotations

import importlib.util
from collections import OrderedDict

import torch

__all__ = ["Feature", "Features", "feature_list"]


class Feature:
    def __init__(self, name: str, enabled: bool):
        self.name = name
        self.enabled = enabled

    def __repr__(self):
        return f"[{'✔' if self.enabled else '✖'} {self.name}]"


def _has(mod: str) -> bool:
    return importlib.util.find_spec(mod) is not None


def _kernels_built() -> bool:
    from . import _build
    return all(_build._target(name).exists() for name in _build.SOURCES)


def _detect() -> "OrderedDict[str, Feature]":
    feats: "OrderedDict[str, Feature]" = OrderedDict()

    def add(name, enabled):
        feats[name] = Feature(name, bool(enabled))

    cuda = torch.cuda.is_available()
    add("CPU", True)
    add("CUDA", cuda)
    add("CUDNN", cuda and torch.backends.cudnn.is_available())
    add("NCCL", torch.distributed.is_available() and torch.distributed.is_nccl_available())
    add("TRITON", _has("triton"))
    add("CUDA_KERNELS", cuda and _kernels_built())
    add("BF16", not cuda or torch.cuda.is_bf16_supported())
    add("INT64_TENSOR_SIZE", True)
    add("DIST", torch.distributed.is_available())
    add("NATIVE_CORE", False)    # the host C++ core is not bound (ROADMAP Queue 1 item 8)
    add("OPENCV", _has("cv2"))
    add("PIL", _has("PIL"))
    add("SIGNAL_HANDLER", True)
    return feats


class Features:
    """Feature name -> :class:`Feature` (names case-insensitive)."""

    def __init__(self):
        self._feats = _detect()

    def __getitem__(self, name: str) -> Feature:
        return self._feats[name.upper()]

    def __contains__(self, name):
        return name.upper() in self._feats

    def keys(self):
        return self._feats.keys()

    def values(self):
        return self._feats.values()

    def items(self):
        return self._feats.items()

    def is_enabled(self, name: str) -> bool:
        return self._feats[name.upper()].enabled

    def __repr__(self):
        return ", ".join(repr(f) for f in self._feats.values())


def feature_list():
    return list(Features().values())
