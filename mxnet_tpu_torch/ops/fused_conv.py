"""Fused NHWC Conv2D + BatchNorm (+ residual) (+ ReLU) with hand-written
backwards (counterpart of ``mxnet_tpu/ops/fused_conv.py``).

The JAX package's composites are ``jax.custom_vjp``s over XLA convolutions,
not Pallas kernels; here each is a ``torch.autograd.Function`` over the
library's convolutions (``F.conv2d``, cuDNN's NHWC kernels on the card:
the NHWC operands reach it as channels-last views). Each keeps the JAX
design:

- the forward saves only ``(x, w, y = conv output, mean, rstd, gamma[,
  residual])``: the normalized and activated tensors are never kept;
- the backward recomputes the ReLU mask from ``y``;
- BN's backward takes two reductions, ``sum(da)`` and ``sum(da * y)``, and
  rewrites ``dy`` as ``c1 * da + c2 * y + c3`` with per-channel f32
  coefficients (:func:`_bn_bwd_coeffs`);
- dgrad and wgrad are the convolution's own backward
  (``aten.convolution_backward``, channels-last).

Statistics are f32 whatever the activation dtype; the normalization is
applied as one ``y * scale + shift`` in y's dtype. The whole-block
composites (:func:`bottleneck_v1_train`, :func:`basic_v1_train`) keep only
the convolutions' outputs and recompute the post-ReLU intermediates in the
backward. A conv bias that feeds a BN cancels out of the normalized
output: it is an input of the ``Function`` whose gradient is exactly zero,
and it only shifts the running mean (``numpy_extension``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["conv2d_bn_relu_train", "conv2d_bn_infer", "bottleneck_v1_train",
           "basic_v1_train"]

_NO_PAD = (0, 0)


def _conv(x, w, stride, pad):
    """NHWC x, OHWI w -> NHWC, through channels-last views."""
    return F.conv2d(x.permute(0, 3, 1, 2), w.permute(0, 3, 1, 2), None, stride,
                    pad).permute(0, 2, 3, 1)


def _conv_bwd(dy, x, w, stride, pad, need_dx=True):
    """(dx, dw) of :func:`_conv` for the output gradient ``dy``, in x's and
    w's layouts (dx None unless ``need_dx``)."""
    dx, dw, _ = torch.ops.aten.convolution_backward(
        dy.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w.permute(0, 3, 1, 2), None,
        list(stride), list(pad), [1, 1], False, [0, 0], 1, [need_dx, True, False])
    return (None if dx is None else dx.permute(0, 2, 3, 1)), dw.permute(0, 2, 3, 1)


def _stats_of(y):
    """f32 (mean, biased var) per channel of an NHWC tensor: E[y], then
    E[y^2] - mean^2 clamped at 0."""
    n = y.shape[0] * y.shape[1] * y.shape[2]
    yf = y.float()
    mean = yf.sum(dim=(0, 1, 2)) / n
    var = ((yf * yf).sum(dim=(0, 1, 2)) / n - mean * mean).clamp_min(0.0)
    return mean, var


def _apply_coeffs(mean, rstd, gamma, beta):
    """Per-channel f32 (scale, shift) of ``yhat * gamma + beta``."""
    scale = gamma.float() * rstd
    return scale, beta.float() - mean * scale


def _norm_relu(y, mean, rstd, gamma, beta, relu=True):
    scale, shift = _apply_coeffs(mean, rstd, gamma, beta)
    a = y * scale.to(y.dtype) + shift.to(y.dtype)
    return torch.relu(a) if relu else a


def _bn_bwd_coeffs(t1, u2, mean, rstd, gamma, n):
    """BN's backward as per-channel algebra: with t1 = sum(da), u2 =
    sum(da * y) and t2 = sum(da * yhat) = rstd * (u2 - mean * t1),
    dy = c1 * da + c2 * y + c3. Returns (c1, c2, c3, dgamma = t2,
    dbeta = t1)."""
    t2 = rstd * (u2 - mean * t1)
    scale = gamma.float() * rstd
    c2 = -scale * rstd * t2 / n
    c3 = -scale * t1 / n - c2 * mean
    return scale, c2, c3, t2, t1


def _bn_layer_bwd(dz, y, mean, rstd, gamma, beta, relu=True, extra=None):
    """Backward through ``relu(yhat * gamma + beta [+ extra])``: the mask
    recomputed from y (and ``extra``); returns (dy in y's dtype, da,
    dgamma, dbeta)."""
    n = y.shape[0] * y.shape[1] * y.shape[2]
    if relu:
        a = _norm_relu(y, mean, rstd, gamma, beta, relu=False)
        if extra is not None:
            a = a + extra
        da = torch.where(a > 0, dz, torch.zeros((), dtype=dz.dtype, device=dz.device))
    else:
        da = dz
    daf = da.float()
    t1 = daf.sum(dim=(0, 1, 2))
    u2 = (daf * y.float()).sum(dim=(0, 1, 2))
    c1, c2, c3, dgamma, dbeta = _bn_bwd_coeffs(t1, u2, mean, rstd, gamma, n)
    dy = da * c1.to(y.dtype) + y * c2.to(y.dtype) + c3.to(y.dtype)
    return dy, da, dgamma.to(gamma.dtype), dbeta.to(beta.dtype)


def _zero_or_none(b):
    return None if b is None else torch.zeros_like(b)


class _ConvBN(torch.autograd.Function):
    """relu?(bn(conv(x, w)) [+ residual]) with batch statistics; returns
    (z, mean, var)."""

    @staticmethod
    def forward(ctx, x, w, gamma, beta, residual, bias, stride, pad, eps, relu):
        y = _conv(x, w, stride, pad)
        mean, var = _stats_of(y)
        rstd = torch.rsqrt(var + eps)
        a = _norm_relu(y, mean, rstd, gamma, beta, relu=False)
        if residual is not None:
            a = a + residual
        z = torch.relu(a) if relu else a
        keep_res = residual if (residual is not None and relu) else None
        ctx.save_for_backward(x, w, y, mean, rstd, gamma, beta, keep_res, bias)
        ctx.cfg = (stride, pad, relu, residual is not None)
        ctx.mark_non_differentiable(mean, var)
        return z, mean, var

    @staticmethod
    def backward(ctx, dz, _dmean, _dvar):
        x, w, y, mean, rstd, gamma, beta, residual, bias = ctx.saved_tensors
        stride, pad, relu, with_res = ctx.cfg
        dy, da, dgamma, dbeta = _bn_layer_bwd(dz, y, mean, rstd, gamma, beta, relu=relu,
                                              extra=residual)
        dx, dw = _conv_bwd(dy, x, w, stride, pad, ctx.needs_input_grad[0])
        return (dx, dw, dgamma, dbeta, da if with_res else None, _zero_or_none(bias),
                None, None, None, None)


def conv2d_bn_relu_train(x, w, gamma, beta, *, stride=(1, 1), pad=(0, 0), eps: float = 1e-5,
                         relu: bool = True, residual: Optional[torch.Tensor] = None,
                         bias: Optional[torch.Tensor] = None):
    """Training-mode fused NHWC conv + BN (+ residual) (+ ReLU). Returns
    ``(z, batch_mean, batch_var)`` (biased variance, f32); the caller blends
    the running statistics. ``bias`` is taken only for its zero gradient."""
    return _ConvBN.apply(x, w, gamma, beta, residual, bias, tuple(stride),
                         tuple(int(p) for p in pad), float(eps), bool(relu))


def conv2d_bn_infer(x, w, gamma, beta, running_mean, running_var, *,
                    bias: Optional[torch.Tensor] = None, stride=(1, 1), pad=(0, 0),
                    eps: float = 1e-5, relu: bool = True,
                    residual: Optional[torch.Tensor] = None):
    """Inference-mode conv + BN (+ residual) (+ ReLU) with the running
    statistics, plain ops; a conv bias folds into the shift."""
    y = _conv(x, w, tuple(stride), tuple(int(p) for p in pad))
    rstd = torch.rsqrt(running_var.float() + eps)
    scale_f = gamma.float() * rstd
    shift_f = beta.float() - running_mean.float() * scale_f
    if bias is not None:
        shift_f = shift_f + bias.float() * scale_f
    a = y * scale_f.to(y.dtype) + shift_f.to(y.dtype)
    if residual is not None:
        a = a + residual
    return torch.relu(a) if relu else a


def _bn_fwd(y, g, b, eps, relu=True):
    """(out, mean, var, rstd) of training-mode BN (+ ReLU) on a conv output."""
    m, v = _stats_of(y)
    r = torch.rsqrt(v + eps)
    return _norm_relu(y, m, r, g, b, relu), m, v, r


class _Block(torch.autograd.Function):
    """A whole ResNet V1 block, bottleneck (three convs) or basic (two), and
    its downsample pair when present:

        z_i = relu(bn_i(conv_i(z_{i-1}))), z_0 = x, for all but the last;
        z = relu(bn_last(conv_last(z_{n-1})) + r), r = bn_d(conv_d(x)) or x.

    The forward keeps the conv outputs and statistics; the backward
    recomputes each z_i from its conv output for the next conv's wgrad.
    Inputs: x, then per conv (w, gamma, beta, bias or None), main convs
    first, the downsample last. Outputs: z, then (mean, var) per conv."""

    @staticmethod
    def forward(ctx, x, strides, pads, eps, has_ds, *flat):
        n = len(strides)
        convs = [flat[4 * i:4 * i + 4] for i in range(n)]
        n_main = n - 1 if has_ds else n
        h, saved, stats = x, [], []
        for i in range(n_main):
            w, g, b, _ = convs[i]
            y = _conv(h, w, strides[i], pads[i])
            last = i == n_main - 1
            h, m, v, r = _bn_fwd(y, g, b, eps, relu=not last)
            saved += [y, m, r]
            stats += [m, v]
        if has_ds:
            wd, gd, bd, _ = convs[-1]
            yd = _conv(x, wd, strides[-1], pads[-1])
            res, md, vd, rd = _bn_fwd(yd, gd, bd, eps, relu=False)
            saved += [yd, md, rd]
            stats += [md, vd]
        else:
            res = x
        z = torch.relu(h + res)
        biases = [c[3] for c in convs]
        ctx.save_for_backward(x, *[t for c in convs for t in c[:3]], *saved,
                              *[b for b in biases if b is not None])
        ctx.cfg = (strides, pads, has_ds, n, [b is not None for b in biases])
        ctx.mark_non_differentiable(*stats)
        return (z, *stats)

    @staticmethod
    def backward(ctx, dz, *_dstats):
        strides, pads, has_ds, n, has_bias = ctx.cfg
        t = ctx.saved_tensors
        x = t[0]
        wgb = [t[1 + 3 * i:4 + 3 * i] for i in range(n)]
        ys = [t[1 + 3 * n + 3 * i:4 + 3 * n + 3 * i] for i in range(n)]
        bias_ts = iter(t[1 + 6 * n:])
        n_main = n - 1 if has_ds else n
        if has_ds:
            (_, gd, bd), (yd, md, rd) = wgb[-1], ys[-1]
            r = _norm_relu(yd, md, rd, gd, bd, relu=False)
        else:
            r = x
        (_, gl, bl), (yl, ml, rl) = wgb[n_main - 1], ys[n_main - 1]
        a = _norm_relu(yl, ml, rl, gl, bl, relu=False) + r
        dr = torch.where(a > 0, dz, torch.zeros((), dtype=dz.dtype, device=dz.device))
        grads = [None] * n
        dh, relu = dr, False
        for i in reversed(range(n_main)):
            w, g, b = wgb[i]
            y, m, rs = ys[i]
            dy, _, dg, db = _bn_layer_bwd(dh, y, m, rs, g, b, relu=relu)
            if i:
                yp, mp, rp = ys[i - 1]
                gp, bp = wgb[i - 1][1:]
                h_in = _norm_relu(yp, mp, rp, gp, bp)
            else:
                h_in = x
            dh, dw = _conv_bwd(dy, h_in, w, strides[i], pads[i])
            grads[i] = [dw, dg, db]
            relu = True
        dx = dh
        if has_ds:
            wd, gd, bd = wgb[-1]
            yd, md, rd = ys[-1]
            dyd, _, dgd, dbd = _bn_layer_bwd(dr, yd, md, rd, gd, bd, relu=False)
            dxd, dwd = _conv_bwd(dyd, x, wd, strides[-1], pads[-1])
            dx = dx + dxd
            grads[-1] = [dwd, dgd, dbd]
        else:
            dx = dx + dr
        flat = []
        for i in range(n):
            flat += grads[i] + [torch.zeros_like(next(bias_ts)) if has_bias[i] else None]
        return (dx, None, None, None, None, *flat)


def _run_block(x, convs, biases, strides, pads, eps, has_ds):
    flat = [t for (w, g, b), bias in zip(convs, biases) for t in (w, g, b, bias)]
    out = _Block.apply(x, strides, pads, float(eps), has_ds, *flat)
    return out[0], tuple(out[1:])


def bottleneck_v1_train(x, convs, stride=(1, 1), eps: float = 1e-5, biases=None):
    """Training-mode fused BottleneckV1 block. ``convs`` is ((w1, g1, b1),
    (w2, g2, b2), (w3, g3, b3)[, (wd, gd, bd)]), ``biases`` the convs'
    biases or None each. Returns (z, (m1, v1, m2, v2, m3, v3[, md, vd]))."""
    stride = tuple(stride)
    strides = [stride, (1, 1), (1, 1)]
    pads = [_NO_PAD, (1, 1), _NO_PAD]
    if len(convs) == 4:
        strides.append(stride)
        pads.append(_NO_PAD)
    biases = biases or [None] * len(convs)
    return _run_block(x, convs, biases, tuple(strides), tuple(pads), eps, len(convs) == 4)


def basic_v1_train(x, convs, stride=(1, 1), eps: float = 1e-5, biases=None):
    """Training-mode fused BasicBlockV1 block. ``convs`` is ((w1, g1, b1),
    (w2, g2, b2)[, (wd, gd, bd)])."""
    stride = tuple(stride)
    strides = [stride, (1, 1)]
    pads = [(1, 1), (1, 1)]
    if len(convs) == 3:
        strides.append(stride)
        pads.append(_NO_PAD)
    biases = biases or [None] * len(convs)
    return _run_block(x, convs, biases, tuple(strides), tuple(pads), eps, len(convs) == 3)
