"""The global key stream (counterpart of ``mxnet_tpu/_random.py``).

A thread-local global key that stateful calls (``random.seed``, eager
dropout) split from, and a :class:`KeySupply` that, while installed, hands
out ``fold_in(base_key, counter)`` instead: ``TrainStep`` installs one per
step over ``key(t)``, so the masks of step ``t`` are the JAX package's
(whose traced step gets its keys from ``TraceKeySupply(key(seed))``).

Keys are int64 ``[2]`` tensors (``_prng``). The global key lives on the
host; a supply draws on its base key's device, and with a device base key
drawing a key is device work only (no host sync, no host copy), so a step
can later be captured as a CUDA graph.
"""
from __future__ import annotations

import os
import threading
from typing import List, Optional

import torch

from . import _prng

__all__ = ["seed", "next_key", "get_state", "set_state", "KeySupply"]


class _RandomState(threading.local):
    def __init__(self):
        self.key: Optional[torch.Tensor] = None
        self.supply: Optional["KeySupply"] = None


STATE = _RandomState()


def seed(seed_state: int, device=None) -> None:
    """Seed the global generator (``mx.random.seed``): ``key(seed_state)``.
    ``device`` is accepted for the JAX signature; the key stays on the
    host."""
    STATE.key = _prng.key(int(seed_state))


def _ensure_key() -> torch.Tensor:
    if STATE.key is None:
        STATE.key = _prng.key(int.from_bytes(os.urandom(4), "little"))
    return STATE.key


def next_key() -> torch.Tensor:
    """The next key: from the installed supply, else split the global key
    (keep key 0, return key 1)."""
    if STATE.supply is not None:
        return STATE.supply.next()
    pair = _prng.split(_ensure_key())
    STATE.key = pair[0]
    return pair[1]


class KeySupply:
    """Keys ``fold_in(base_key, 0)``, ``fold_in(base_key, 1)``, ... for
    every :func:`next_key` while installed (a context manager)."""

    def __init__(self, base_key: torch.Tensor):
        self.base_key = base_key
        self.counter = 0

    def next(self) -> torch.Tensor:
        k = _prng.fold_in(self.base_key, self.counter)
        self.counter += 1
        return k

    def __enter__(self):
        self._prev = STATE.supply
        STATE.supply = self
        return self

    def __exit__(self, *exc):
        STATE.supply = self._prev
        return False


def get_state() -> List[int]:
    """The global key's two words as a list (the checkpoint manifest's
    ``seed_state``)."""
    return [int(v) for v in _ensure_key().tolist()]


def set_state(state) -> None:
    """Restore a snapshot from :func:`get_state`."""
    words = [int(v) & _prng.M32 for v in state]
    if len(words) != 2:
        raise ValueError(f"seed state holds two key words, got {state!r}")
    STATE.key = torch.tensor(words, dtype=torch.int64)
