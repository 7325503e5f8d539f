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
    (a host key with Python ints, the same arithmetic as numpy's and a
    fraction of its per-call cost)."""
    if k.device.type == "cpu":
        k0, k1 = (int(w) for w in k.tolist())
        return torch.tensor([threefry2x32(k0, k1, 0, i) for i in range(num)],
                            dtype=torch.int64)
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


# ---------------------------------------------------------------- host draws
#
# ``mx.np.random`` and the initializers draw from host keys (the global key
# stream) with numpy, in jax.random's exact arithmetic: 64-bit draws need
# unsigned 64-bit remainders, which numpy has and torch lacks. Callers move
# the result to their device.

_F32 = np.dtype(np.float32)
_F64 = np.dtype(np.float64)


def _words(k: torch.Tensor):
    kd = [int(w) for w in k.reshape(-1).tolist()]
    return np.int64(kd[0]), np.int64(kd[-1])


def host_bits(k: torch.Tensor, shape: Sequence[int], width: int = 32) -> np.ndarray:
    """``jax.random.bits`` of ``width`` 8/16/32/64 over ``shape`` (numpy
    unsigned): the hash of the 64-bit iota, its two words xored (64 bits:
    high word, then low word)."""
    shape = tuple(int(n) for n in shape)
    n = int(np.prod(shape, dtype=np.int64))
    i = np.arange(n, dtype=np.int64)
    # uint32 operands: numpy's wrapping uint32 arithmetic is the hash's, at
    # half the bytes of the masked int64 form (initializers draw millions)
    k0, k1 = (np.uint32(w) for w in _words(k))
    y0, y1 = threefry2x32(k0, k1, (i >> 32).astype(np.uint32), (i & M32).astype(np.uint32))
    if width == 64:
        out = (y0.astype(np.uint64) << np.uint64(32)) | y1.astype(np.uint64)
    else:
        out = (y0 ^ y1).astype(np.uint32).astype({8: np.uint8, 16: np.uint16,
                                                  32: np.uint32}[width])
    return out.reshape(shape)


def host_uniform(k: torch.Tensor, shape: Sequence[int], minval=0.0, maxval=1.0,
                 dtype=np.float32) -> np.ndarray:
    """``jax.random.uniform`` in f32 or f64: random mantissa bits under
    exponent 0, minus 1, scaled onto [minval, maxval). XLA fuses the scale
    into one fused multiply-add: in f32 it is computed here in f64 and
    rounded once (in f64 as a multiply and an add, which may differ from
    XLA's in the last place)."""
    dt = np.dtype(dtype)
    lo, hi = dt.type(minval), dt.type(maxval)
    if dt == _F32:
        bits = host_bits(k, shape, 32)
        fl = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)
        scaled = (fl.astype(np.float64) * np.float64(hi - lo) + np.float64(lo)).astype(_F32)
    elif dt == _F64:
        bits = host_bits(k, shape, 64)
        fl = ((bits >> np.uint64(12)) | np.uint64(0x3FF0000000000000)).view(np.float64) - 1.0
        scaled = fl * (hi - lo) + lo
    else:
        raise ValueError(f"uniform draws f32 or f64, not {dt}")
    return np.maximum(lo, scaled)


# XLA's f32 erfinv (Giles' approximation): coefficients for w < 5 and w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _erfinv_f32(x: np.ndarray) -> np.ndarray:
    """XLA's f32 erfinv with its fused multiply-adds (each Horner step
    computed in f64 and rounded once); the log1p is torch's, which may
    differ from XLA's in the last place."""
    w = -torch.log1p(torch.from_numpy(-(x * x))).numpy()
    lt = w < np.float32(5)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3)).astype(np.float64)
    p = np.where(lt, np.float32(_ERFINV_LT5[0]), np.float32(_ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = np.where(lt, np.float32(a), np.float32(b)).astype(np.float64)
        p = (c + p.astype(np.float64) * w).astype(_F32)
    out = p * x
    return np.where(np.abs(x) == np.float32(1), x * np.finfo(_F32).max, out)


def _round_bf16(x: np.ndarray) -> np.ndarray:
    """f32 ``x`` rounded to bf16 (nearest even), as f32."""
    return torch.from_numpy(np.ascontiguousarray(x, dtype=_F32)).to(torch.bfloat16).float().numpy()


def normal_bf16(k: torch.Tensor, shape: Sequence[int], round_product: bool = True) -> np.ndarray:
    """``jax.random.normal(k, shape, bfloat16)`` as f32: u from 8 random
    bits (bf16 has 7 mantissa bits), exactly representable on (-1, 1);
    XLA's f32 erfinv rounded to bf16, times bf16(sqrt 2). The product is
    rounded to bf16 as the draw alone returns it; ``round_product=False``
    keeps it in f32, as XLA computes it inside a fused step that upcasts
    the draw (SGLD's)."""
    bits = host_bits(k, shape, 8).astype(np.uint32)
    fl = (((bits >> np.uint32(1)) << np.uint32(16)) | np.uint32(0x3F800000)).view(_F32)
    lo = np.float32(-0.99609375)        # nextafter(-1, 0) in bf16
    u = np.maximum(lo, (fl - np.float32(1)) * np.float32(2) + lo)
    out = _round_bf16(_erfinv_f32(u)) * _round_bf16(np.float32(np.sqrt(2)))
    return _round_bf16(out) if round_product else out


def host_normal(k: torch.Tensor, shape: Sequence[int], dtype=np.float32) -> np.ndarray:
    """``jax.random.normal``: ``sqrt(2) * erfinv(u)``, u uniform on
    (-1, 1) bit for bit. The f32 erfinv is XLA's polynomial
    (:func:`_erfinv_f32`), the f64 one torch's; either may differ from
    XLA's in the last place."""
    dt = np.dtype(dtype)
    lo = np.nextafter(dt.type(-1.0), dt.type(0.0))
    u = host_uniform(k, shape, lo, 1.0, dt)
    e = _erfinv_f32(u) if dt == _F32 else torch.erfinv(torch.from_numpy(u)).numpy()
    return e * dt.type(np.sqrt(2))


def host_randint(k: torch.Tensor, shape: Sequence[int], minval: int, maxval: int,
                 dtype=np.int64) -> np.ndarray:
    """``jax.random.randint`` over [minval, maxval): two draws of the
    dtype's width from ``split(k)``, combined modulo the span in unsigned
    arithmetic (the JAX package's default dtype is int64)."""
    dt = np.dtype(dtype)
    nbits = dt.itemsize * 8
    udt = np.dtype(f"uint{nbits}")
    info = np.iinfo(dt)
    k1, k2 = split(k)
    higher, lower = host_bits(k1, shape, nbits), host_bits(k2, shape, nbits)
    mn = min(max(int(minval), info.min), info.max)
    mx = min(max(int(maxval), info.min), info.max)
    span = 1 if mx <= mn else mx - mn
    if int(maxval) > info.max and mx > mn:
        span += 1
    if span >= 1 << nbits:
        raise ValueError("randint over the dtype's whole range is not ported")
    mult = (1 << (nbits // 2)) % span
    mult = (mult * mult) % (1 << nbits) % span
    s, m = udt.type(span), udt.type(mult)
    with np.errstate(over="ignore"):
        off = ((higher % s) * m + (lower % s)) % s
        return off.astype(dt) + dt.type(mn)


def cachedop_seed(k: torch.Tensor) -> int:
    """The JAX ``CachedOp``'s per-call seed, ``jax.random.randint(k, (), 0,
    2**31 - 1, int32)``, with Python ints: ``split(k)``, one 32-bit draw of
    each half; at this span the higher draw's multiplier is
    ``(2**16)**2 mod 2**32 = 0``, so the seed is the lower draw modulo the
    span (:func:`host_randint`'s arithmetic)."""
    k2 = split(k)[1].tolist()
    y0, y1 = threefry2x32(k2[0], k2[1], 0, 0)
    return (y0 ^ y1) % (2 ** 31 - 1)


def host_permutation(k: torch.Tensor, n: int) -> np.ndarray:
    """``jax.random.permutation`` of ``arange(n)``: rounds of stable sorts
    by fresh 32-bit keys, as many as jax takes for n."""
    x = np.arange(n, dtype=np.int64)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        k, sub = split(k)
        x = x[np.argsort(host_bits(sub, (n,), 32), kind="stable")]
    return x
