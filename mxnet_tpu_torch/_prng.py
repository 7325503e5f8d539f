"""JAX's threefry2x32 random stream, on tensors (counterpart of the parts of
``jax.random`` that the JAX package's sampling draws).

A key is an int64 tensor ``[..., 2]`` holding the two uint32 words of
``jax.random.key_data``; leading dimensions are a batch of keys (JAX's
``vmap`` over a key array). Every function runs on the tensor's own
device: the integer work is int64 masked to 32 bits, which the CPU and
CUDA both compute exactly (torch's uint32 support is partial), so the
card draws the same bits as the CPU. :func:`fold_keys`, a few rows per
decode step, hashes on the host with numpy (the same operator-only code)
and copies its result once; :func:`step_keys` writes a whole decode
dispatch's keys into a host buffer (the serving engine's pinned staging,
copied with the dispatch's other inputs before a CUDA-graph replay); the
hash over a vocab runs on the device.

The layout is jax 0.9.0's, with ``jax_threefry_partitionable`` on (its
default):

- ``key(seed)`` is the 64-bit seed's two words, ``(seed >> 32, seed mod
  2**32)`` (the JAX package enables x64; a uint32 seed has high word 0);
- ``fold_in(key, d)`` hashes the counts ``(0, d)`` under the key;
- ``split(key, n)`` hashes the counts ``(0, i)`` for ``i < n`` and the two
  output words of count ``i`` are key ``i``;
- ``random_bits(key, shape)`` hashes the 64-bit iota over ``shape`` (high
  word, low word) and xors the two output words;
- ``uniform`` sets the top 23 bits as the mantissa of a float in [1, 2),
  subtracts 1 and maps onto [minval, maxval);
- ``gumbel`` is ``-log(-log(uniform(tiny, 1)))`` (the "low" mode);
- ``categorical`` is the argmax of ``logits + gumbel`` (ties to the lowest
  index).

The logs are the device's own: XLA's CPU log and torch's differ in the
last place for about one value in seven, so gumbel noise agrees with
JAX's to about 2^-23 in absolute terms, not bit for bit; the tokens agree
unless two perturbed logits lie that close.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

__all__ = ["key", "keys", "fold_in", "fold_keys", "step_keys", "split", "random_bits",
           "uniform", "gumbel", "categorical", "threefry2x32"]

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(np.finfo(np.float32).tiny)


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0, k1, x0, x1):
    """The 20-round Threefry-2x32 hash of ``jax._src.prng`` under key
    ``(k0, k1)`` of the counts ``(x0, x1)``; int64 tensors or numpy arrays
    holding uint32 values, broadcast together. Returns the two output
    words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def _as_int64(x, device=None):
    if isinstance(x, torch.Tensor):
        return x.to(device=device or x.device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(x).astype(np.int64), device=device)


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key_data(jax.random.key(seed))`` as a [2] tensor."""
    s = int(seed)
    return torch.tensor([(s >> 32) & M32, s & M32], dtype=torch.int64, device=device)


def keys(seeds, device=None) -> torch.Tensor:
    """One key per seed (``vmap`` of ``key``): [..., 2]."""
    s = _as_int64(seeds, device)
    return torch.stack([(s >> 32) & M32, s & M32], dim=-1)


def _host_hash(k: torch.Tensor, x0, x1) -> torch.Tensor:
    """threefry of host counts under host keys ``k`` [..., 2], in numpy (a
    key's 20 rounds as torch CPU ops cost far more in dispatch)."""
    kn = k.numpy()
    y0, y1 = np.broadcast_arrays(*threefry2x32(kn[..., 0], kn[..., 1], x0, x1))
    return torch.from_numpy(np.stack([y0, y1], axis=-1).astype(np.int64))


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``fold_in`` of the keys ``k`` [..., 2] with ``data`` (an int or a
    tensor that broadcasts against the key batch). A host key folds an int
    in numpy; a device key folds it on its device without a host copy."""
    if isinstance(data, int):
        if k.device.type == "cpu":
            return _host_hash(k, np.int64(0), np.int64(data & M32))
        d = torch.full((), data & M32, dtype=torch.int64, device=k.device)
    else:
        d = _as_int64(data, k.device) & M32
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def _host_ints(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x).astype(np.int64)


def fold_keys(seeds, counters, device=None) -> torch.Tensor:
    """[B, 2] keys ``fold_in(key(seed), counter)`` per row on ``device``:
    the per-request sampling streams of the serving engine and of
    ``generate(multi_token > 1)``. Hashed on the host."""
    return torch.from_numpy(step_keys(seeds, counters, 1)[0]).to(device)


def step_keys(seeds, counters, steps: int, out=None) -> np.ndarray:
    """The [steps, B, 2] int64 keys of one decode dispatch, ``fold_in(
    key(seed), counter + j)`` for substep j of row b: ``fold_keys`` of the
    rows at each substep's counter, hashed on the host into ``out`` (a
    numpy array of that shape, e.g. a view of pinned memory) or a new
    array."""
    s = _host_ints(seeds).reshape(1, -1)
    c = (_host_ints(counters).reshape(1, -1) + np.arange(steps).reshape(-1, 1)) & M32
    y0, y1 = np.broadcast_arrays(*threefry2x32((s >> 32) & M32, s & M32,
                                               np.zeros_like(c), c))
    if out is None:
        out = np.empty(y0.shape + (2,), np.int64)
    out[..., 0] = y0
    out[..., 1] = y1
    return out


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` of one key [2] into ``num`` keys [num, 2]
    (a host key in numpy)."""
    if k.device.type == "cpu":
        i = np.arange(num, dtype=np.int64)
        return _host_hash(k.reshape(1, 2), np.zeros_like(i), i)
    i = torch.arange(num, dtype=torch.int64, device=k.device)
    y0, y1 = threefry2x32(k[0], k[1], torch.zeros_like(i), i)
    return torch.stack([y0, y1], dim=-1)


def random_bits(k: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element of ``shape`` for each key of ``k``
    [..., 2]: an int64 tensor of shape ``k.shape[:-1] + shape``."""
    shape = tuple(int(n) for n in shape)
    n = int(np.prod(shape, dtype=np.int64))
    idx = torch.arange(n, dtype=torch.int64, device=k.device)
    lead = k.shape[:-1]
    k0 = k[..., 0].reshape(*lead, 1)
    k1 = k[..., 1].reshape(*lead, 1)
    y0, y1 = threefry2x32(k0, k1, idx >> 32, idx & M32)
    return (y0 ^ y1).reshape(*lead, *shape)


def uniform(k: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """f32 uniform in [minval, maxval) by ``jax.random.uniform``'s
    mantissa construction."""
    bits = random_bits(k, shape)
    one = (bits >> 9) | 0x3F800000
    floats = one.to(torch.int32).view(torch.float32) - 1.0
    # filled on the device (no host copy, so a CUDA graph can capture it)
    lo = torch.full((), minval, dtype=torch.float32, device=k.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=k.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(k: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Standard Gumbel noise, ``jax.random.gumbel``'s default mode."""
    return -torch.log(-torch.log(uniform(k, shape, _TINY, 1.0)))


def categorical(k: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` along the last axis of f32 ``logits``.
    One key [2] draws the noise over the whole of ``logits``; a batch of
    keys [B, 2] draws row b of [B, V] logits with key b (JAX's ``vmap``).
    Returns int64 indices of shape ``logits.shape[:-1]``."""
    if k.dim() == 1:
        noise = gumbel(k, logits.shape)
    else:
        noise = gumbel(k, logits.shape[k.dim() - 1:])
    return torch.argmax(noise + logits, dim=-1)
