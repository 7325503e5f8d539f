"""Devices (counterpart of ``mxnet_tpu/device.py``).

Entry points of this package run on the CUDA card unless the caller asks
for the CPU. There is no silent CPU path: asking for CUDA on a machine
without a card raises.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from .base import MXNetError

__all__ = ["gpu", "cpu", "default_device", "resolve"]


def gpu(device_id: int = 0) -> torch.device:
    """The CUDA card ``device_id``; raises if there is none."""
    if not torch.cuda.is_available():
        raise MXNetError("no CUDA device is available; pass device='cpu' to "
                         "run the plain PyTorch path on the CPU")
    return torch.device("cuda", device_id)


def cpu() -> torch.device:
    return torch.device("cpu")


def default_device() -> torch.device:
    """The device entry points use when the caller names none: CUDA."""
    return gpu(0)


def resolve(device: Optional[Union[str, torch.device]]) -> torch.device:
    """``None`` -> :func:`default_device`; a CUDA name is checked to exist."""
    if device is None:
        return default_device()
    dev = torch.device(device)
    if dev.type == "cuda":
        return gpu(dev.index or 0)
    if dev.type != "cpu":
        raise MXNetError(f"unsupported device {dev}")
    return dev
