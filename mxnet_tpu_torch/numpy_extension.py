"""The ``numpy_extension`` ops GPT uses (counterpart of
``mxnet_tpu/numpy_extension/__init__.py``), written with the same op
sequence as the JAX functions so that the plain path stays close to them."""
from __future__ import annotations

import math

import torch

__all__ = ["layer_norm", "gelu", "log_softmax", "pick", "softmax_cross_entropy"]

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
