"""The ``numpy_extension`` ops GPT uses (counterpart of
``mxnet_tpu/numpy_extension/__init__.py``), written with the same op
sequence as the JAX functions so that the plain path stays close to them."""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from . import _random
from ._prng import M32

__all__ = ["layer_norm", "gelu", "log_softmax", "pick", "softmax_cross_entropy",
           "dropout"]

_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


def layer_norm(x, gamma=None, beta=None, axis: int = -1, eps: float = 1e-5):
    """LayerNorm with f32 statistics: mean, E[x^2] - mean^2 clamped at 0,
    rsqrt (``fused_block_gemv._ln``; ``numpy_extension.layer_norm``)."""
    xf = x.float()
    mean = xf.mean(dim=axis, keepdim=True)
    var = (xf * xf).mean(dim=axis, keepdim=True) - mean * mean
    var = var.clamp_min(0.0)
    inv = torch.rsqrt(var + eps)
    out = ((xf - mean) * inv).to(x.dtype)
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    if gamma is not None:
        out = out * gamma.to(out.dtype).reshape(shape)
    if beta is not None:
        out = out + beta.to(out.dtype).reshape(shape)
    return out


def gelu(x, approximate: bool = True):
    """GeLU; ``approximate=True`` is the tanh form of ``jax.nn.gelu``, its
    two constants rounded to x's dtype first as JAX rounds them (a torch
    Python scalar would stay exact in a bf16 product)."""
    if not approximate:
        return torch.nn.functional.gelu(x)
    c = torch.tensor(0.044715, dtype=x.dtype)
    k = torch.tensor(_SQRT_2_OVER_PI, dtype=x.dtype)
    cdf = 0.5 * (1.0 + torch.tanh(k * (x + c * (x * x * x))))
    return x * cdf


def log_softmax(data, axis: int = -1):
    return torch.log_softmax(data, dim=axis)


def pick(data, index, axis: int = -1, keepdims: bool = False):
    """Select one element along ``axis`` per position, indices clipped into
    range (the JAX package's default ``mode='clip'``)."""
    ax = axis if axis >= 0 else data.dim() + axis
    idx = index.long().clamp(0, data.shape[ax] - 1).unsqueeze(ax)
    out = torch.gather(data, ax, idx)
    return out if keepdims else out.squeeze(ax)


class _FusedCE(torch.autograd.Function):
    """Sparse softmax cross-entropy over the last axis with f32 statistics
    (the JAX package's ``_fused_ce``): loss = lse(logits) - logits[label]
    in the logits' dtype; the backward recomputes softmax from the saved
    f32 lse, so no log-softmax tensor is kept."""

    @staticmethod
    def forward(ctx, logits, labels):
        labels = labels.long()
        m = logits.amax(dim=-1, keepdim=True)
        diff = logits.float() - m.float()
        lse = m.float() + torch.log(torch.exp(diff).sum(dim=-1, keepdim=True))
        ll = torch.gather(logits, -1, labels[..., None]).float()
        ctx.save_for_backward(logits, lse[..., 0], labels)
        return (lse - ll)[..., 0].to(logits.dtype)

    @staticmethod
    def backward(ctx, dl):
        logits, lse, labels = ctx.saved_tensors
        p = torch.exp(logits.float() - lse[..., None])
        p.scatter_add_(-1, labels[..., None],
                       torch.full_like(lse[..., None], -1.0))
        return (p * dl.float()[..., None]).to(logits.dtype), None


def softmax_cross_entropy(pred, label):
    """Fused sparse softmax cross-entropy over the last axis:
    ``lse(pred) - pred[label]``, statistics in f32, the loss in pred's
    dtype. An XLA composite in the JAX package (no Pallas kernel), plain
    PyTorch here."""
    return _FusedCE.apply(pred, label)


# ----------------------------------------------------------------- dropout

def _mul32(x, c: int):
    """``x * c`` modulo 2**32 on int64 holding uint32 values, in place."""
    return x.mul_(c).bitwise_and_(M32)


def _keep_bits_at(key, idx, keep_prob: float, idx_hi=None):
    """Keep bit of each position in ``idx`` (an int64 tensor of values in
    [0, 2**32)): the JAX package's murmur3-finalizer mix of the index
    under the key's two words, with ``idx_hi`` the optional high word of
    positions past 2**32. uint32 arithmetic as int64 masked to 32 bits
    after every multiply and add; shifts act on masked values, so they are
    logical. Runs on ``idx``'s device: a host key's words go to the
    kernels as scalars, a device key's stay on the device (no copy, no
    sync either way)."""
    if key.device.type == "cpu":
        kd = [int(w) for w in key.reshape(-1).tolist()]
    else:
        kd = key.to(device=idx.device, dtype=torch.int64).reshape(-1)
    k0, k1 = kd[0], kd[-1]
    lo = idx.to(torch.int64)
    if idx_hi is not None:
        h = _mul32(idx_hi.to(torch.int64) ^ k0, 0x85EBCA6B)
        h ^= h >> 15
        lo = lo ^ h
    x = _mul32(lo ^ k1, 0x9E3779B9).add_(k0).bitwise_and_(M32)
    x ^= x >> 16
    x = _mul32(x, 0x85EBCA6B)
    x ^= x >> 13
    x = _mul32(x, 0xC2B2AE35)
    x ^= x >> 16
    thresh = min(int(keep_prob * 4294967296.0), 4294967295)
    return x < thresh


def _cheap_keep_mask(key, shape: Sequence[int], keep_prob: float, device=None):
    """Bool keep mask over ``shape``, position i of the flat shape keyed by
    :func:`_keep_bits_at`; an empty shape keeps all. Built on ``device``
    (default: the key's); the int64 intermediates live only inside this
    call."""
    shape = tuple(int(d) for d in shape)
    dev = key.device if device is None else torch.device(device)
    n = math.prod(shape)
    if n == 0:
        return torch.ones(shape, dtype=torch.bool, device=dev)
    i = torch.arange(n, dtype=torch.int64, device=dev)
    return _keep_bits_at(key, i, keep_prob).reshape(shape)


def _dtype_scalar(c: float, dtype, device):
    """``c`` rounded to ``dtype`` as JAX rounds a weak-typed Python scalar
    (bf16 x divides by bf16(0.9) = 0.8984375), as a 0-d tensor on
    ``device``: CUDA divides by a host scalar as a product with its
    reciprocal, which is not the division's bits."""
    return torch.full((), c, dtype=dtype, device=device)


class _Dropout(torch.autograd.Function):
    """``where(keep, x / c, 0)`` with c = 1 - p in x's dtype; the backward
    is ``where(keep, g / c, 0)`` in g's dtype. Only the bool mask is kept
    for the backward."""

    @staticmethod
    def forward(ctx, x, keep, c: float):
        ctx.save_for_backward(keep)
        ctx.c = c
        return torch.where(keep, x / _dtype_scalar(c, x.dtype, x.device),
                           torch.zeros((), dtype=x.dtype, device=x.device))

    @staticmethod
    def backward(ctx, g):
        (keep,) = ctx.saved_tensors
        return (torch.where(keep, g / _dtype_scalar(ctx.c, g.dtype, g.device),
                            torch.zeros((), dtype=g.dtype, device=g.device)),
                None, None)


def dropout(data, p: float = 0.5, mode: str = "training", axes=None,
            training: Optional[bool] = None):
    """Dropout at rate ``p`` (``npx.dropout``). Active when ``training`` is
    true or ``mode == 'always'``; ``training=None`` is inference (the port
    has no recording scope: ``gluon.nn.Dropout`` passes its module's mode).
    Consumes one key of the stream (:func:`_random.next_key`) when active
    and ``p > 0``, none otherwise. ``axes`` are broadcast axes: the mask
    has size 1 along each, so one mask is shared across it. The mask is
    computed on ``data``'s device, the same bits on the CPU and the card."""
    if not training and mode != "always":
        return data
    if p <= 0.0:
        return data
    key = _random.next_key()
    shape = list(data.shape)
    for ax in axes or ():
        shape[ax] = 1
    keep = _cheap_keep_mask(key, shape, 1.0 - p, device=data.device)
    return _Dropout.apply(data, keep, 1.0 - p)
