"""``mx.npx``: the NN primitives of the port (counterpart of
``mxnet_tpu/numpy_extension/__init__.py``).

Every function takes NDArrays, and then runs through the funnel
(``ndarray.apply``, recorded inside ``autograd.record()``), or torch
tensors, and then returns tensors in PyTorch's own autograd. The
tensor-level functions GPT, generation and the engine call
(``layer_norm``, ``gelu``, ``log_softmax``, ``pick``,
``softmax_cross_entropy``, ``dropout``) take a tensor straight to their
tensor body, at the cost of one type check. Each is written with the same
op sequence as the JAX function so that the plain path stays close to it.
Convolution and pooling are the library's (``F.conv*``, cuDNN on the card:
the JAX package's are XLA's, not Pallas kernels); the fused conv + BN
composites are ``ops/fused_conv.py``. ``foreach``, ``while_loop`` and
``cond`` are eager loops (``control_flow``); the contrib detection ops are
``ops/contrib.py``, whose greedy NMS sweep is a hand-written CUDA kernel
on the card; ``rnn`` is a facade over ``gluon.rnn``.
"""
from __future__ import annotations

import math
import os
from typing import Optional, Sequence, Tuple  # noqa: F401 (Tuple: the JAX namespace's)

import numpy as onp
import torch

from .. import _random, _tape
from .._prng import M32
from .._random import next_key  # noqa: F401 (the JAX namespace's)
from ..base import MXNetError
from ..ndarray import (NDArray, _cast, _inexact, apply, apply_multi, asarray,  # noqa: F401
                       waitall)

__all__ = [
    "set_np", "reset_np", "is_np_array", "is_np_shape", "use_np", "relu", "leaky_relu",
    "sigmoid", "log_sigmoid", "softsign", "softmax", "log_softmax", "masked_softmax",
    "masked_log_softmax", "gelu", "silu", "mish", "erf", "erfinv", "activation",
    "fully_connected", "batch_norm", "layer_norm", "group_norm", "instance_norm",
    "rms_norm", "dropout", "embedding", "convolution", "deconvolution", "pooling",
    "fused_conv_bn_relu", "fused_resnet_block", "one_hot", "pick", "topk", "arange_like",
    "reshape_like", "sequence_mask", "slice_axis", "clip_global_norm", "batch_dot",
    "smooth_l1", "index_update", "index_add", "gather_nd", "scatter_nd",
    "softmax_cross_entropy", "broadcast_like", "seed", "save", "load", "waitall",
    "gamma", "gammaln", "digamma", "multibox_prior", "gamma_sampling_stub",
    "foreach", "while_loop", "cond", "bernoulli", "uniform_n", "normal_n", "savez", "rnn",
    "roi_align", "roi_pooling", "box_iou", "box_nms", "bipartite_matching",
    "multibox_target", "multibox_detection", "deformable_convolution",
]

from .control_flow import cond, foreach, while_loop  # noqa: E402

_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)
_np_flags = {"array": True, "shape": True}


def set_np(shape: bool = True, array: bool = True, dtype=None):
    """The port has numpy semantics only; kept for the JAX signature."""
    _np_flags["array"] = array
    _np_flags["shape"] = shape


def reset_np():
    set_np()


def is_np_array() -> bool:
    return _np_flags["array"]


def is_np_shape() -> bool:
    return _np_flags["shape"]


def use_np(func):
    return func


def _nd(x) -> bool:
    return isinstance(x, NDArray)


# ------------------------------------------------------ tensor-level bodies

def _layer_norm(x, gamma=None, beta=None, axis: int = -1, eps: float = 1e-5):
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


def _gelu(x, approximate: bool = True):
    """GeLU; ``approximate=True`` is the tanh form of ``jax.nn.gelu``, its
    two constants rounded to x's dtype first as JAX rounds them (a torch
    Python scalar would stay exact in a bf16 product)."""
    if not approximate:
        return torch.nn.functional.gelu(x)
    c = torch.tensor(0.044715, dtype=x.dtype)
    k = torch.tensor(_SQRT_2_OVER_PI, dtype=x.dtype)
    cdf = 0.5 * (1.0 + torch.tanh(k * (x + c * (x * x * x))))
    return x * cdf


def _log_softmax(data, axis: int = -1):
    return torch.log_softmax(data, dim=axis)


def _pick(data, index, axis: int = -1, keepdims: bool = False):
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


# ----------------------------------------------------------------- dropout

def _check_dropout_rng():
    """Raise where the JAX package would draw ``jax.random.bernoulli``
    masks (``MXTPU_DROPOUT_RNG=threefry``): the port draws the counter
    hash only. Called by every active dropout site, as the JAX package
    reads the variable there."""
    if os.environ.get("MXTPU_DROPOUT_RNG") == "threefry":
        raise MXNetError("MXTPU_DROPOUT_RNG=threefry is not ported (ROADMAP Queue 3): "
                         "the port draws the counter-hash dropout masks only; unset the "
                         "variable or set it to 'counter'")


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


def _dropout(data, p, mode, axes, training):
    if not training and mode != "always":
        return data
    if p <= 0.0:
        return data
    _check_dropout_rng()
    key = _random.next_key()
    shape = list(data.shape)
    for ax in axes or ():
        shape[ax] = 1
    keep = _cheap_keep_mask(key, shape, 1.0 - p, device=data.device)
    return _Dropout.apply(data, keep, 1.0 - p)


# ------------------------------------------------------------- activations

def _logistic(x):
    return torch.sigmoid(x)


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _elu(x, alpha):
    return torch.where(x > 0, x, alpha * torch.expm1(torch.where(x > 0, torch.zeros_like(x), x)))


_ACTIVATIONS = {
    "relu": torch.relu,
    "relu6": lambda x: torch.clamp(x, 0.0, 6.0),
    "sigmoid": _logistic,
    "log_sigmoid": lambda x: -_softplus(-x),
    "tanh": torch.tanh,
    "softrelu": _softplus,
    "softsign": lambda x: x / (torch.abs(x) + 1),
    "mish": lambda x: x * torch.tanh(_softplus(x)),
    "gelu": _gelu,
    "silu": lambda x: x * _logistic(x),
}


def activation(data, act_type: str = "relu"):
    if act_type not in _ACTIVATIONS:
        raise MXNetError(f"unknown activation {act_type}")
    return apply(_ACTIVATIONS[act_type], data, name=act_type)


def relu(data):
    return apply(torch.relu, data, name="relu")


def sigmoid(data):
    return apply(_logistic, data, name="sigmoid")


def log_sigmoid(data):
    return activation(data, "log_sigmoid")


def softsign(data):
    return activation(data, "softsign")


def silu(data):
    return apply(_ACTIVATIONS["silu"], data, name="silu")


def mish(data):
    return activation(data, "mish")


def gelu(x, approximate: bool = True):
    """GeLU; ``approximate=True`` is the tanh form of ``jax.nn.gelu``, its
    two constants rounded to x's dtype first as JAX rounds them."""
    if _nd(x):
        return apply(lambda t: _gelu(t, approximate), x)
    return _gelu(x, approximate)


def erf(data):
    return apply(torch.erf, data)


def erfinv(data):
    return apply(torch.erfinv, data)


def _special(fn):
    return lambda data: apply(lambda t: fn(_cast(t, _inexact(t.dtype))), data)


gammaln = _special(torch.lgamma)
digamma = _special(torch.digamma)
# exp(gammaln(x)), as the JAX package writes it: |Gamma(x)| at negative x
gamma = _special(lambda t: torch.exp(torch.lgamma(t)))
gammaln.__name__, digamma.__name__, gamma.__name__ = "gammaln", "digamma", "gamma"


_SELU_SCALE = 1.0507009873554804934193349852946
_SELU_ALPHA = 1.6732632423543772848170429916717


def leaky_relu(data, gamma: float = 0.01, act_type: str = "leaky", **kwargs):
    if act_type == "leaky":
        return apply(lambda x: torch.where(x >= 0, x, gamma * x), data)
    if act_type == "elu":
        return apply(lambda x: _elu(x, gamma), data)
    if act_type == "selu":
        return apply(lambda x: _SELU_SCALE * _elu(x, _SELU_ALPHA), data)
    if act_type == "gelu":
        return apply(_gelu, data, name="gelu")
    if act_type == "prelu":
        def prelu(x, a):
            if x.dim() > 1 and a.dim() == 1 and a.shape[0] > 1:
                # a per-channel slope broadcasts along axis 1
                a = a.reshape((1, -1) + (1,) * (x.dim() - 2))
            return torch.where(x >= 0, x, a * x)
        return apply(prelu, data, kwargs.get("alpha"))
    raise MXNetError(f"unknown leaky_relu act_type {act_type}")


def softmax(data, axis: int = -1, length=None, temperature=None, use_length=False):
    if length is not None or use_length:
        n = data.shape[axis]

        def mask_of(ln):
            return torch.arange(n, device=ln.device) < ln.unsqueeze(-1)
        return masked_softmax(data, apply(mask_of, length), axis=axis,
                              temperature=temperature)
    t = 1.0 if temperature is None else temperature
    return apply(lambda x: torch.softmax(x / t, dim=axis), data, name="softmax")


def log_softmax(data, axis: int = -1, temperature=None):
    if _nd(data):
        t = 1.0 if temperature is None else temperature
        return apply(lambda x: _log_softmax(x / t, axis), data, name="log_softmax")
    return _log_softmax(data if temperature is None else data / temperature, axis)


def _masked(fn, fill):
    def run(x, m, axis, t):
        neg = torch.finfo(x.dtype if x.is_floating_point() else torch.float32).min
        y = torch.where(m, x / t, torch.full((), neg, dtype=x.dtype, device=x.device))
        return torch.where(m, fn(y, dim=axis), torch.full((), fill, dtype=x.dtype,
                                                            device=x.device))
    return run


def masked_softmax(data, mask, axis: int = -1, temperature=None, normalize=True):
    t = 1.0 if temperature is None else temperature
    run = _masked(torch.softmax, 0.0)
    return apply(lambda x, m: run(x, m.bool(), axis, t), data, mask, name="masked_softmax")


def masked_log_softmax(data, mask, axis: int = -1, temperature=None):
    t = 1.0 if temperature is None else temperature
    run = _masked(torch.log_softmax, -math.inf)
    return apply(lambda x, m: run(x, m.bool(), axis, t), data, mask,
                 name="masked_log_softmax")


# ------------------------------------------------------------- dense

def fully_connected(x, weight, bias=None, num_hidden: Optional[int] = None,
                    no_bias: bool = False, flatten: bool = True):
    """``x @ weight.T + bias`` (a matmul, then the add, as in the JAX
    package); ``flatten`` collapses all axes after the first."""
    arrays = [x, weight] + ([] if bias is None or no_bias else [bias])

    def fn(xv, wv, *rest):
        y = torch.matmul(xv.reshape(xv.shape[0], -1) if flatten else xv, wv.t())
        return y + rest[0] if rest else y
    return apply_multi(fn, arrays, "fully_connected")


def batch_dot(lhs, rhs, transpose_a: bool = False, transpose_b: bool = False):
    def fn(a, b):
        a = a.transpose(-1, -2) if transpose_a else a
        b = b.transpose(-1, -2) if transpose_b else b
        return torch.matmul(a, b)
    return apply(fn, lhs, rhs, name="batch_dot")


# ------------------------------------------------------------- conv and pool

def _tuplize(v, n):
    if isinstance(v, int):
        return (v,) * n
    return tuple(v)


def _channels_last(layout: Optional[str]) -> bool:
    """True for the NHWC family of layouts (NWC, NHWC, NDHWC)."""
    return layout is not None and layout.endswith("C")


def _to_nc(t):
    """(N, *spatial, C) -> (N, C, *spatial) as a view: for 2-D and 3-D
    images this is the channels-last memory format, which cuDNN convolves
    and pools in its NHWC kernels without a copy."""
    return t.permute(0, t.dim() - 1, *range(1, t.dim() - 1))


def _from_nc(t):
    """(N, C, *spatial) -> (N, *spatial, C) as a view."""
    return t.permute(0, *range(2, t.dim()), 1)


_CONV = {1: torch.nn.functional.conv1d, 2: torch.nn.functional.conv2d,
         3: torch.nn.functional.conv3d}
_CONV_T = {1: torch.nn.functional.conv_transpose1d, 2: torch.nn.functional.conv_transpose2d,
           3: torch.nn.functional.conv_transpose3d}


def _rank(a) -> int:
    return a.dim() if isinstance(a, torch.Tensor) else asarray(a).ndim


def _conv(xv, wv, bv, stride, pad, dilate, groups, ch_last):
    """``lax.conv_general_dilated`` with symmetric padding, NC* / OI* or,
    with ``ch_last``, N*C / O*I: the channel-last operands are permuted
    views (no copy) and the result is permuted back."""
    nd = wv.dim() - 2
    if ch_last:
        return _from_nc(_CONV[nd](_to_nc(xv), _to_nc(wv), bv, stride, pad, dilate, groups))
    return _CONV[nd](xv, wv, bv, stride, pad, dilate, groups)


def convolution(data, weight, bias=None, kernel=None, stride=1, dilate=1, pad=0,
                num_filter=None, num_group: int = 1, no_bias: bool = False,
                layout: Optional[str] = None):
    """N-d convolution (1-D, 2-D or 3-D by the weight's rank): NC*/OI* by
    default, N*C/O*I (the weight ``(out, *kernel, in/groups)``) for an
    NHWC-family ``layout``. Channel-last data reaches the library
    convolution as a channels-last view (cuDNN's NHWC kernels on the
    card), with no copy. The JAX package's convolution is XLA's, not a
    Pallas kernel; this is ``F.conv{1,2,3}d``."""
    nd = _rank(weight) - 2
    stride, dilate, pad = (_tuplize(v, nd) for v in (stride, dilate, pad))
    ch_last = _channels_last(layout)
    arrays = [data, weight] + ([] if bias is None or no_bias else [bias])

    def fn(xv, wv, *rest):
        return _conv(xv, wv, rest[0] if rest else None, stride, pad, dilate, num_group,
                     ch_last)
    return apply_multi(fn, arrays, "convolution")


def deconvolution(data, weight, bias=None, kernel=None, stride=1, dilate=1, pad=0, adj=0,
                  num_filter=None, num_group: int = 1, no_bias: bool = True,
                  layout: Optional[str] = None):
    """Transposed convolution over NC* data, the weight ``(in, out/groups,
    *kernel)``; ``adj`` pads the output's high side. The output is the JAX
    package's input-dilated convolution of the flipped kernel. Where torch
    takes ``adj`` as its ``output_padding`` (below ``max(stride,
    dilate)``) that is one ``F.conv_transpose``; otherwise the full
    transposed convolution is cut by ``pad`` and padded by ``adj`` with
    zeros: the same output shape and values."""
    nd = _rank(weight) - 2
    stride, dilate, pad, adj = (_tuplize(v, nd) for v in (stride, dilate, pad, adj))
    arrays = [data, weight] + ([] if bias is None or no_bias else [bias])
    direct = all(a < max(s, d) for a, s, d in zip(adj, stride, dilate))

    def fn(xv, wv, *rest):
        bv = rest[0] if rest else None
        if direct:
            return _CONV_T[nd](xv, wv, bv, stride, pad, adj, num_group, dilate)
        full = _CONV_T[nd](xv, wv, None, stride, 0, 0, num_group, dilate)
        cut = [v for p, a in zip(reversed(pad), reversed(adj)) for v in (-p, a - p)]
        y = torch.nn.functional.pad(full, cut)
        return y if bv is None else y + bv.reshape((1, -1) + (1,) * nd)
    return apply_multi(fn, arrays, "deconvolution")


def _full_extra(sizes, kernel, stride, pad):
    """The ``'full'`` (ceil) convention's extra high-side padding, per
    spatial axis: enough that a partial window at the edge gives an output."""
    extra = []
    for size, k, s, p in zip(sizes, kernel, stride, pad):
        span = size + 2 * p - k
        out_full = -(-span // s) + 1
        extra.append(max(0, (out_full - 1) * s + k - (size + 2 * p)))
    return tuple(extra)


def _pad_nc(x, lo, hi, value=0.0):
    """Pad the spatial axes of an (N, C, *spatial) tensor by ``lo`` below
    and ``hi`` above."""
    flat = [v for a, b in zip(reversed(lo), reversed(hi)) for v in (a, b)]
    if not any(flat):
        return x
    return torch.nn.functional.pad(x, flat, value=value)


def _window_sum(x, kernel, stride):
    """Sum over every whole window of an (N, C, *spatial) float tensor, no
    padding (a 1-D window runs as a 1 x k 2-D one)."""
    F = torch.nn.functional
    if len(kernel) == 1:
        return F.avg_pool2d(x.unsqueeze(2), (1,) + kernel, (1,) + stride,
                            divisor_override=1).squeeze(2)
    pool = F.avg_pool2d if len(kernel) == 2 else F.avg_pool3d
    return pool(x, kernel, stride, divisor_override=1)


def _window_max(x, kernel, stride, pad, hi):
    """Max over every window of an (N, C, *spatial) tensor padded by ``pad``
    below and ``pad + hi`` above with the dtype's lowest value. Float data
    with no extra padding takes the library pooling's own -inf padding."""
    F = torch.nn.functional
    nd = len(kernel)
    pad_hi = tuple(p + e for p, e in zip(pad, hi))
    if x.is_floating_point():
        pool = (F.max_pool1d, F.max_pool2d, F.max_pool3d)[nd - 1]
        if not any(hi) and all(2 * p <= k for p, k in zip(pad, kernel)):
            return pool(x, kernel, stride, pad)
        return pool(_pad_nc(x, pad, pad_hi, -math.inf), kernel, stride)
    x = _pad_nc(x, pad, pad_hi, torch.iinfo(x.dtype).min)
    for ax, (k, s) in enumerate(zip(kernel, stride)):
        x = x.unfold(2 + ax, k, s)
    return x.amax(dim=tuple(range(-nd, 0)))


def _inbounds_count(shape, kernel, stride, lo, hi, device):
    """Per-output-window count of the in-bounds cells of an (N, C, *spatial)
    input padded by ``lo`` / ``hi``: the ``count_include_pad=False``
    divisor, f32, broadcasting over N and C."""
    ones = torch.ones((1, 1) + tuple(shape[2:]), dtype=torch.float32, device=device)
    return _window_sum(_pad_nc(ones, lo, hi), kernel, stride)


def _pool_nc(x, kernel, stride, pad, pool_type, count_include_pad, full):
    """Pooling of an (N, C, *spatial) tensor with explicit windows, so that
    every output shape is ``lax.reduce_window``'s: ``full`` pads the high
    side further by :func:`_full_extra` (torch's ``ceil_mode`` would drop a
    window that starts in the padding). avg divides in f32, as the JAX
    package divides by an f32 count."""
    hi = _full_extra(x.shape[2:], kernel, stride, pad) if full else (0,) * len(kernel)
    if pool_type == "max":
        return _window_max(x, kernel, stride, pad, hi)
    pad_hi = tuple(p + e for p, e in zip(pad, hi))
    if pool_type == "lp":
        return _window_sum(_pad_nc(torch.abs(x) ** 2, pad, pad_hi), kernel, stride) ** 0.5
    s = _window_sum(_pad_nc(x, pad, pad_hi), kernel, stride)
    if pool_type == "sum":
        return s
    sf = s.to(torch.promote_types(s.dtype, torch.float32))
    if count_include_pad and full:
        # explicit padding counts, the ceil overhang does not
        shape = x.shape[:2] + tuple(n + 2 * p for n, p in zip(x.shape[2:], pad))
        return sf / _inbounds_count(shape, kernel, stride, (0,) * len(pad), hi, x.device)
    if count_include_pad:
        return sf / torch.full((), float(math.prod(kernel)), dtype=sf.dtype, device=x.device)
    return sf / _inbounds_count(x.shape, kernel, stride, pad, pad_hi, x.device)


def pooling(data, kernel=None, pool_type: str = "max", stride=None, pad=0,
            global_pool: bool = False, count_include_pad: bool = True,
            pooling_convention: str = "valid", layout=None):
    """max / avg / sum / lp pooling over the spatial axes (``layout``
    NHWC-family: axes 1..nd, channel last). ``pooling_convention='full'``
    is the ceil convention, with the JAX package's windows and divisors;
    avg returns f32 or wider. Channel-last data pools as a channels-last
    view."""
    nd = _rank(data) - 2
    ch_last = _channels_last(layout)
    if global_pool:
        axes = tuple(range(1, 1 + nd)) if ch_last else tuple(range(2, 2 + nd))
        if pool_type == "max":
            return apply(lambda x: x.amax(dim=axes, keepdim=True), data)
        return apply(lambda x: x.mean(dim=axes, keepdim=True), data)
    if pool_type not in ("max", "avg", "sum", "lp"):
        raise MXNetError(f"unknown pool_type {pool_type}")
    kernel = _tuplize(kernel, nd)
    stride = _tuplize(stride if stride is not None else kernel, nd)
    pad = _tuplize(pad, nd)
    full = pooling_convention == "full"

    def fn(x):
        if ch_last:
            return _from_nc(_pool_nc(_to_nc(x), kernel, stride, pad, pool_type,
                                     count_include_pad, full))
        return _pool_nc(x, kernel, stride, pad, pool_type, count_include_pad, full)
    return apply(fn, data, name=f"pool_{pool_type}")


# ------------------------------------------------------------- normalization

def layer_norm(x, gamma=None, beta=None, axis: int = -1, eps: float = 1e-5):
    """LayerNorm with f32 statistics: mean, E[x^2] - mean^2 clamped at 0,
    rsqrt; normalized in x's dtype."""
    if not (_nd(x) or _nd(gamma) or _nd(beta)):
        return _layer_norm(x, gamma, beta, axis, eps)
    g, b = gamma is not None, beta is not None
    return apply_multi(lambda xv, *r: _layer_norm(xv, r[0] if g else None,
                                                  r[int(g)] if b else None, axis, eps),
                       [x] + [v for v in (gamma, beta) if v is not None])


def _stats(xf, red):
    mean = xf.mean(dim=red, keepdim=True)
    var = (xf * xf).mean(dim=red, keepdim=True) - mean * mean
    return mean, var.clamp_min(0.0)


def _batch_norm(xv, g, b, rm, rv, eps, momentum, fix_gamma, use_global_stats, axis,
                training):
    if not -xv.dim() <= axis < xv.dim():
        raise MXNetError(f"batch_norm: axis {axis} out of range for ndim {xv.dim()}")
    ax = axis % xv.dim()
    shape = [1] * xv.dim()
    shape[ax] = xv.shape[ax]
    red = tuple(i for i in range(xv.dim()) if i != ax)
    if fix_gamma:
        g = torch.ones_like(g)
    if training and not use_global_stats:
        xf = xv.float()
        mean = xf.mean(dim=red)
        var = ((xf * xf).mean(dim=red) - mean * mean).clamp_min(0.0)
        new_rm = momentum * rm + (1 - momentum) * mean.to(rm.dtype)
        new_rv = momentum * rv + (1 - momentum) * var.to(rv.dtype)
    else:
        mean, var = rm.float(), rv.float()
        new_rm, new_rv = rm, rv
    inv = torch.rsqrt(var + eps)
    gf = g.float()
    scale = (gf * inv).to(xv.dtype)
    shift = (b.float() - gf * mean * inv).to(xv.dtype)
    out = xv * scale.reshape(shape) + shift.reshape(shape)
    return out, new_rm.detach(), new_rv.detach()


def batch_norm(x, gamma, beta, running_mean, running_var, eps: float = 1e-5,
               momentum: float = 0.9, fix_gamma: bool = False, use_global_stats: bool = False,
               output_mean_var: bool = False, axis: int = 1, training: Optional[bool] = None):
    """Returns ``(out, new_running_mean, new_running_var)``; the layer
    writes the statistics back. Statistics in f32, the normalization one
    ``x * scale + shift`` in x's dtype."""
    if training is None:
        training = _tape.is_training()
    return apply_multi(lambda *v: _batch_norm(*v, eps, momentum, fix_gamma, use_global_stats,
                                              axis, training),
                       [x, gamma, beta, running_mean, running_var])


def _blend(rm, rv, mean, var, momentum, bias=None):
    """The running-statistics update ``momentum * r + (1 - momentum) *
    batch``, detached; a conv bias shifts the batch mean."""
    if bias is not None:
        mean = mean + bias.float()
    with torch.no_grad():
        return (momentum * rm + (1 - momentum) * mean.to(rm.dtype),
                momentum * rv + (1 - momentum) * var.to(rv.dtype))


def fused_conv_bn_relu(x, weight, gamma, beta, running_mean, running_var, bias=None,
                       residual=None, stride=(1, 1), pad=(0, 0), eps: float = 1e-5,
                       momentum: float = 0.9, relu: bool = True,
                       use_global_stats: bool = False, training: Optional[bool] = None):
    """Fused NHWC Conv2D + BatchNorm (+ residual add) (+ ReLU) with a
    hand-written backward (``ops/fused_conv.py``). Returns ``(out,
    new_running_mean, new_running_var)`` like :func:`batch_norm`. A conv
    bias feeding the BN cancels out of the output: it only shifts the
    reported batch mean, and its gradient is exactly zero."""
    from ..ops.fused_conv import conv2d_bn_infer, conv2d_bn_relu_train
    if training is None:
        training = _tape.is_training()
    training = training and not use_global_stats
    arrays = [x, weight, gamma, beta, running_mean, running_var]
    arrays += [a for a in (bias, residual) if a is not None]
    has_bias, has_res = bias is not None, residual is not None

    def fn(xv, wv, g, b, rm, rv, *rest):
        bv = rest[0] if has_bias else None
        res = rest[int(has_bias)] if has_res else None
        if training:
            z, mean, var = conv2d_bn_relu_train(xv, wv, g, b, stride=stride, pad=pad, eps=eps,
                                                relu=relu, residual=res, bias=bv)
            return (z, *_blend(rm, rv, mean, var, momentum, bv))
        z = conv2d_bn_infer(xv, wv, g, b, rm, rv, bias=bv, stride=stride, pad=pad, eps=eps,
                            relu=relu, residual=res)
        return z, rm, rv
    return apply_multi(fn, arrays, "fused_conv_bn_relu")


def fused_resnet_block(x, conv_params, bn_params, kind: str = "bottleneck", stride=(1, 1),
                       eps: float = 1e-5, momentum: float = 0.9):
    """Training-mode fused ResNet V1 block (``ops/fused_conv.py``): convs,
    BNs, ReLUs and the residual add as one ``autograd.Function``.
    ``conv_params`` is a list of (weight, bias or None), ``bn_params`` of
    (gamma, beta, running_mean, running_var), the downsample pair last when
    present. Returns ``(z, [(new_rm, new_rv), ...])``."""
    from ..ops.fused_conv import basic_v1_train, bottleneck_v1_train
    n = len(conv_params)
    has_bias = [b is not None for _, b in conv_params]
    arrays = [x]
    for (w, b), (g, be, rm, rv) in zip(conv_params, bn_params):
        arrays += [w, g, be, rm, rv] + ([b] if b is not None else [])

    def fn(xv, *flat):
        packs, biases, i = [], [], 0
        for k in range(n):
            packs.append(flat[i:i + 5])
            i += 5
            biases.append(flat[i] if has_bias[k] else None)
            i += int(has_bias[k])
        run = bottleneck_v1_train if kind == "bottleneck" else basic_v1_train
        z, stats = run(xv, [p[:3] for p in packs], stride=stride, eps=eps, biases=biases)
        ups = []
        for k in range(n):
            ups += _blend(packs[k][3], packs[k][4], stats[2 * k], stats[2 * k + 1], momentum,
                          biases[k])
        return (z, *ups)
    out = apply_multi(fn, arrays, "fused_resnet_block")
    return out[0], [(out[1 + 2 * k], out[2 + 2 * k]) for k in range(n)]


def rms_norm(x, gamma=None, axis: int = -1, eps: float = 1e-6):
    def fn(xv, *rest):
        ms = (xv.float() * xv.float()).mean(dim=axis, keepdim=True)
        out = (xv * torch.rsqrt(ms + eps)).to(xv.dtype)
        if rest:
            shape = [1] * xv.dim()
            shape[axis] = xv.shape[axis]
            out = out * rest[0].reshape(shape)
        return out
    return apply_multi(fn, [x] + ([gamma] if gamma is not None else []))


def _norm_affine(out, g, b, c):
    shape = (1, c) + (1,) * (out.dim() - 2)
    return out * g.to(out.dtype).reshape(shape) + b.to(out.dtype).reshape(shape)


def group_norm(x, gamma, beta, num_groups: int, eps: float = 1e-5):
    def fn(xv, g, b):
        n, c = xv.shape[:2]
        xg = xv.reshape((n, num_groups, c // num_groups) + tuple(xv.shape[2:]))
        mean, var = _stats(xg.float(), tuple(range(2, xg.dim())))
        out = ((xg.float() - mean) * torch.rsqrt(var + eps)).to(xv.dtype).reshape(xv.shape)
        return _norm_affine(out, g, b, c)
    return apply(fn, x, gamma, beta)


def instance_norm(x, gamma, beta, eps: float = 1e-5):
    def fn(xv, g, b):
        mean, var = _stats(xv.float(), tuple(range(2, xv.dim())))
        out = ((xv.float() - mean) * torch.rsqrt(var + eps)).to(xv.dtype)
        return _norm_affine(out, g, b, xv.shape[1])
    return apply(fn, x, gamma, beta)


# ------------------------------------------------------------- dropout

def dropout(data, p: float = 0.5, mode: str = "training", axes=None,
            training: Optional[bool] = None):
    """Dropout at rate ``p`` (``npx.dropout``). Active when ``training``
    (default: ``autograd.is_training()``) is true or ``mode == 'always'``.
    Consumes one key of the stream (:func:`_random.next_key`) when active
    and ``p > 0``, none otherwise. ``axes`` are broadcast axes: the mask
    has size 1 along each, so one mask is shared across it. The mask is
    computed on ``data``'s device, the same bits on the CPU and the card."""
    if training is None:
        training = _tape.is_training()
    if _nd(data):
        return apply(lambda x: _dropout(x, p, mode, axes, training), data)
    return _dropout(data, p, mode, axes, training)


# ------------------------------------------------------------- indexing

def embedding(data, weight, input_dim=None, output_dim=None, dtype=None,
              sparse_grad: bool = False):
    """Rows ``data`` of ``weight``. ``sparse_grad`` is accepted, as in the
    JAX package: a row-sparse gradient comes from the weight's
    ``grad_stype`` (``attach_grad(stype='row_sparse')``); a recorded gather
    of such a weight tags its node with the ids for the tape's cut."""
    def fn(i, w):
        ids = i.long()
        out = torch.nn.functional.embedding(ids, w)
        if out.grad_fn is not None and getattr(weight, "_grad_stype", None) == "row_sparse":
            out.grad_fn.metadata[_tape.EMBED_IDS] = ids
        return out
    return apply(fn, data, weight, name="embedding")


def one_hot(indices, depth: int, on_value=1.0, off_value=0.0, dtype=None):
    from ..ndarray import to_torch_dtype
    dt = to_torch_dtype(dtype) or torch.float32

    def fn(i):
        hot = (i.long().unsqueeze(-1) == torch.arange(depth, device=i.device)).to(dt)
        return hot * (on_value - off_value) + off_value
    return apply(fn, indices)


def pick(data, index, axis: int = -1, mode: str = "clip", keepdims: bool = False):
    """Select one element along ``axis`` per position, indices clipped into
    range (``mode='clip'``)."""
    if _nd(data):
        return apply(lambda x, i: _pick(x, i, axis, keepdims), data, index)
    return _pick(data, index, axis, keepdims)


def topk(data, axis: int = -1, k: int = 1, ret_typ: str = "indices", is_ascend: bool = False,
         dtype=None):
    """The k largest (smallest with ``is_ascend``) along ``axis``, ties to
    the lower index; indices as float32 unless ``dtype``."""
    from ..ndarray import to_torch_dtype
    idt = to_torch_dtype(dtype) or torch.float32

    def fn(x):
        vals, idxs = torch.sort(x, dim=axis, descending=not is_ascend, stable=True)
        vals, idxs = vals.narrow(axis, 0, k), idxs.narrow(axis, 0, k)
        if ret_typ == "value":
            return vals
        if ret_typ == "both":
            return vals, idxs.to(idt)
        return idxs.to(idt)
    return apply(fn, data)


def _nd_index(idx):
    idx = idx.long()
    return tuple(idx[i] for i in range(idx.shape[0]))


def gather_nd(data, indices):
    return apply(lambda x, i: x[_nd_index(i)], data, indices)


def scatter_nd(data, indices, shape):
    def fn(d, i):
        return torch.zeros(tuple(shape), dtype=d.dtype, device=d.device).index_put(
            _nd_index(i), d)
    return apply(fn, data, indices)


def index_update(data, indices, val):
    def fn(x, v):
        y = x.clone()
        y[indices] = v
        return y
    return apply(fn, data, val)


def index_add(data, indices, val):
    def fn(x, v):
        y = x.clone()
        y[indices] = y[indices] + v
        return y
    return apply(fn, data, val)


# ------------------------------------------------------------- utilities

def arange_like(data, start: float = 0.0, step: float = 1.0, axis=None):
    def fn(x):
        n = x.numel() if axis is None else x.shape[axis]
        out = start + step * torch.arange(n, dtype=torch.float32, device=x.device)
        return out.reshape(x.shape) if axis is None else out
    return apply(fn, data)


def reshape_like(lhs, rhs):
    return apply(lambda a, b: a.reshape(b.shape), lhs, rhs)


def broadcast_like(lhs, rhs, lhs_axes=None, rhs_axes=None):
    if (lhs_axes is None) != (rhs_axes is None):
        raise MXNetError("broadcast_like: lhs_axes and rhs_axes must be given together")
    if lhs_axes is None:
        return apply(lambda a, b: a.broadcast_to(b.shape), lhs, rhs)
    target = list(lhs.shape)
    for la, ra in zip(lhs_axes, rhs_axes):
        target[la % len(target)] = rhs.shape[ra % len(rhs.shape)]
    return apply(lambda a, b: a.broadcast_to(tuple(target)), lhs, rhs)


def slice_axis(data, axis: int, begin: int, end: Optional[int]):
    def fn(x):
        sl = [slice(None)] * x.dim()
        sl[axis] = slice(begin, end)
        return x[tuple(sl)]
    return apply(fn, data)


def sequence_mask(data, sequence_length=None, use_sequence_length: bool = False,
                  value: float = 0.0, axis: int = 0):
    if sequence_length is None or not use_sequence_length:
        return data

    def fn(x, ln):
        steps = torch.arange(x.shape[axis], device=x.device)
        mask = steps.reshape((-1, 1) if axis == 0 else (1, -1)) < \
            ln.reshape((1, -1) if axis == 0 else (-1, 1))
        mask = mask.reshape(mask.shape + (1,) * (x.dim() - 2))
        return torch.where(mask, x, torch.full((), value, dtype=x.dtype, device=x.device))
    return apply(fn, data, sequence_length)


def smooth_l1(data, scalar: float = 1.0):
    s2 = scalar * scalar

    def fn(x):
        return torch.where(torch.abs(x) < 1.0 / s2, 0.5 * s2 * x * x, torch.abs(x) - 0.5 / s2)
    return apply(fn, data)


def clip_global_norm(arrays, max_norm: float, check_isfinite: bool = True):
    """Scale ``arrays`` in place so their global 2-norm is at most
    ``max_norm``; returns the norm before scaling."""
    with torch.no_grad():
        total = torch.sqrt(sum(torch.sum(torch.square(a._data.float())) for a in arrays))
        scale = torch.clamp(max_norm / torch.clamp(total, min=1e-12), max=1.0)
        for a in arrays:
            a._set_data(a._data * scale.to(a._data.dtype))
    return float(total)


def softmax_cross_entropy(pred, label):
    """Fused sparse softmax cross-entropy over the last axis:
    ``lse(pred) - pred[label]``, statistics in f32, the loss in pred's
    dtype. An XLA composite in the JAX package (no Pallas kernel), plain
    PyTorch here."""
    if _nd(pred):
        return apply(_FusedCE.apply, pred, label)
    return _FusedCE.apply(pred, label)


def seed(seed_state, device="all"):
    _random.seed(int(seed_state))


def save(file, arrays):
    from .. import save as _save
    _save(file, arrays)


def load(file):
    from .. import load as _load
    return _load(file)


def multibox_prior(*args, **kwargs):
    raise MXNetError("multibox_prior: not implemented (the JAX package raises too)")


def Custom(*inputs, op_type: str = None, **kwargs):
    """Run the custom op registered under ``op_type`` (``mx.operator``)."""
    if op_type is None:
        raise MXNetError("Custom: op_type is required")
    from ..operator import invoke_custom
    return invoke_custom(*inputs, op_type=op_type, **kwargs)


def gamma_sampling_stub(*a, **k):
    raise MXNetError("use mx.np.random.gamma")


def bernoulli(prob=None, logit=None, size=None, dtype=None, device=None, ctx=None):
    from ..numpy import random as _rnd
    return _rnd.bernoulli(prob=prob, logit=logit, size=size, dtype=dtype)


def _param_shape(a, b):
    shp = [tuple(getattr(x, "shape", onp.shape(x))) for x in (a, b)]
    return tuple(onp.broadcast_shapes(*shp))


def uniform_n(low=0.0, high=1.0, batch_shape=None, dtype=None, device=None):
    """A draw of shape ``batch_shape + broadcast(param shapes)``."""
    from ..numpy import random as _rnd
    size = tuple(batch_shape or ()) + _param_shape(low, high)
    return _rnd.uniform(low, high, size=size or None, dtype=dtype)


def normal_n(loc=0.0, scale=1.0, batch_shape=None, dtype=None, device=None):
    from ..numpy import random as _rnd
    size = tuple(batch_shape or ()) + _param_shape(loc, scale)
    return _rnd.normal(loc, scale, size=size or None, dtype=dtype)


def savez(file, *args, **kwargs):
    from ..numpy import savez as _savez
    _savez(file, *args, **kwargs)


def rnn(data=None, parameters=None, state=None, state_cell=None, sequence_length=None,
        mode="lstm", state_size=None, num_layers=1, bidirectional=False,
        state_outputs=True, p=0.0, use_sequence_length=False, projection_size=None,
        **kwargs):
    """The fused RNN op's facade over ``gluon.rnn``: ``parameters`` is the
    reference's flat vector, every weight first and then every bias."""
    from ..gluon import rnn as rnn_mod
    if projection_size is not None:
        raise MXNetError("npx.rnn: projection_size not supported")
    if use_sequence_length or sequence_length is not None:
        raise MXNetError("npx.rnn: use_sequence_length not supported; "
                         "mask with npx.sequence_mask instead")
    if p:
        raise MXNetError("npx.rnn: inter-layer dropout p>0 not supported "
                         "through this facade; use gluon.rnn layers")
    cls = {"rnn_tanh": rnn_mod.RNN, "rnn_relu": rnn_mod.RNN,
           "lstm": rnn_mod.LSTM, "gru": rnn_mod.GRU}.get(mode)
    if cls is None:
        raise MXNetError(f"npx.rnn: unknown mode {mode!r}")
    kw = dict(hidden_size=int(state_size), num_layers=int(num_layers),
              bidirectional=bool(bidirectional), layout="TNC")
    if mode.startswith("rnn_"):
        kw["activation"] = mode.split("_")[1]
    d0 = asarray(data)
    layer = cls(input_size=d0.shape[-1], **kw)
    layer.initialize(device=d0.device)
    items = list(layer.collect_params().items())
    ordered = ([q for n, q in items if "weight" in n] + [q for n, q in items if "bias" in n])
    flat = asarray(parameters)._data.reshape(-1)
    need = sum(int(onp.prod(q.shape)) for q in ordered)
    if need != flat.numel():
        raise MXNetError(f"npx.rnn: parameter vector has {flat.numel()} values, layer "
                         f"needs {need}")
    offset = 0
    for q in ordered:
        n = int(onp.prod(q.shape))
        q.set_data(NDArray._new(flat[offset:offset + n].reshape(q.shape).detach().clone()))
        offset += n
    states = [state] if state_cell is None else [state, state_cell]
    out, out_states = layer(d0, states)
    if not state_outputs:
        return out
    return (out, *out_states)


# the contrib detection ops (the JAX namespace re-exports them)
from ..ops.contrib import (  # noqa: E402,F401
    bipartite_matching, box_iou, box_nms, deformable_convolution, multibox_detection,
    multibox_target, roi_align, roi_pooling)
