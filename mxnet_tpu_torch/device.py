"""Devices (counterpart of ``mxnet_tpu/device.py``).

A :class:`Device` names where arrays live and ops run: ``mx.gpu(i)`` is
CUDA card ``i``, ``mx.cpu()`` the host. ``with mx.cpu():`` (any device
is a scope) makes it the current device of the thread; outside every
scope the current device is the card. Entry points of this package run
on the current device unless the caller names one, and there is no silent
CPU path: asking for the card on a machine without one raises.
"""
from __future__ import annotations

import threading
from typing import Optional, Union

import torch

from .base import MXNetError

__all__ = ["Device", "Context", "gpu", "cpu", "current_device", "default_device",
           "num_gpus", "resolve"]


class Device:
    """A compute device, ``device_type`` 'cpu' or 'gpu' (the JAX package's
    'tpu' and 'cpu_pinned' names map onto them)."""

    _thread_local = threading.local()

    def __init__(self, device_type="gpu", device_id: int = 0):
        if isinstance(device_type, Device):
            device_type, device_id = device_type.device_type, device_type.device_id
        elif isinstance(device_type, torch.device):
            device_type, device_id = device_type.type, device_type.index or 0
        device_type = str(device_type).lower()
        device_type = {"tpu": "gpu", "cuda": "gpu", "cpu_pinned": "cpu",
                       "cpu_shared": "cpu"}.get(device_type, device_type)
        if device_type not in ("cpu", "gpu"):
            raise MXNetError(f"unknown device type {device_type!r}")
        self.device_type = device_type
        self.device_id = int(device_id)

    @property
    def torch_device(self) -> torch.device:
        """The torch device; raises for a card on a machine without one."""
        if self.device_type == "cpu":
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise MXNetError("no CUDA device is available; run under `with mx.cpu():` "
                             "or pass device='cpu' to take the plain PyTorch path")
        return torch.device("cuda", self.device_id)

    def __eq__(self, other):
        return (isinstance(other, Device) and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"

    def __enter__(self):
        stack = getattr(Device._thread_local, "stack", None)
        if stack is None:
            stack = Device._thread_local.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc):
        Device._thread_local.stack.pop()
        return False

    @classmethod
    def current(cls) -> "Device":
        stack = getattr(cls._thread_local, "stack", None)
        return stack[-1] if stack else Device("gpu", 0)

    @classmethod
    def of(cls, t: torch.Tensor) -> "Device":
        """The device a tensor lives on."""
        if t.device.type == "cpu":
            return Device("cpu", 0)
        return Device("gpu", t.device.index or 0)


#: the JAX package's alias (its ``Context``)
Context = Device


def gpu(device_id: int = 0) -> Device:
    """CUDA card ``device_id`` (checked when an array is placed on it)."""
    return Device("gpu", device_id)


def cpu(device_id: int = 0) -> Device:
    return Device("cpu", device_id)


def current_device() -> Device:
    """The innermost ``with`` scope's device of this thread, else the card."""
    return Device.current()


def num_gpus() -> int:
    return torch.cuda.device_count()


def default_device() -> torch.device:
    """The torch device entry points use when the caller names none."""
    return current_device().torch_device


def resolve(device: Optional[Union[str, torch.device, Device]]) -> torch.device:
    """``None`` -> the current device; a :class:`Device`, a name or a torch
    device -> its torch device, a CUDA one checked to exist."""
    if device is None:
        return default_device()
    if isinstance(device, Device):
        return device.torch_device
    dev = torch.device(device)
    if dev.type == "cuda":
        return Device("gpu", dev.index or 0).torch_device
    if dev.type != "cpu":
        raise MXNetError(f"unsupported device {dev}")
    return dev
