"""Weight-only int8 quantization of Dense layers and of the tied LM head
(counterpart of ``mxnet_tpu/contrib/quantization.py``, ``bits=8`` with
``calib_mode='none'``).

The weight tables are bit-for-bit the JAX package's: per-output-channel
``scale = max(amax, 1e-8) / 127`` and ``w_q = clip(round(w / scale), -127,
127)`` with the same division order (``torch.round`` and ``jnp.round``
both round half to even).
"""
from __future__ import annotations

import torch
from torch import nn

from ..base import MXNetError
from ..gluon.nn import Dense
from ..ops.fused_block_gemv import pad_vocab
from ..ops.int8_gemv import gemv_max_m, int8_weight_matmul

__all__ = ["QuantizedDense", "quantize_net"]

_QMAX = 127.0  # symmetric int8


def _quantize_rows(w):
    """(int8 table, f32 per-row scales) of a (rows, in) f32 weight."""
    w = w.detach().float()
    amax = torch.clamp_min(w.abs().amax(dim=1), 1e-8)
    scale = amax / _QMAX
    w_q = torch.clamp(torch.round(w / scale[:, None]), -_QMAX, _QMAX).to(torch.int8)
    return w_q, scale


class QuantizedDense(nn.Module):
    """int8 weight-only Dense with dynamic activation scales.

    Up to ``gemv_max_m()`` rows stream the int8 weights through K3
    (:func:`~mxnet_tpu_torch.ops.int8_gemv.int8_weight_matmul`) with f32
    activations. More rows take the activation-quantized int8 x int8
    product of the JAX package: the activation scale is the abs-max of the
    whole input over 127, and the integer product is formed exactly. The
    sums reach 127 * 127 * K (about 5e7 at K = 3072), past what f32 holds
    exactly, so the product runs in float64, exact for integers below
    2**53 on the CPU and on the card alike; rounding that exact integer to
    f32 gives the bits JAX's int32 -> f32 conversion gives.
    """

    def __init__(self, inner: Dense):
        super().__init__()
        self.inner = inner
        w_q, w_scale = _quantize_rows(inner.weight)
        self.register_buffer("w_q", w_q)
        self.register_buffer("w_scale", w_scale)

    def forward(self, x):
        rows = x.numel() // x.shape[-1]
        K = x.shape[-1]
        N = self.w_q.shape[0]
        if rows <= gemv_max_m():
            y = int8_weight_matmul(x.reshape(rows, K), self.w_q, self.w_scale)
        else:
            amax = x.abs().max()
            s_x = torch.where(amax > 0, amax / _QMAX,
                              torch.ones_like(amax)).float()
            x_q = torch.clamp(torch.round(x.reshape(rows, K) / s_x), -_QMAX, _QMAX)
            y = (x_q.double() @ self.w_q.double().T).float()
            y = y * (s_x * self.w_scale)
        y = y.reshape(*x.shape[:-1], N)
        bias = self.inner.bias
        return y if bias is None else y + bias


def _replace_dense(module):
    replaced = []
    for name, child in list(module.named_children()):
        if isinstance(child, Dense):
            q = QuantizedDense(child)
            setattr(module, name, q)
            replaced.append(q)
        elif not isinstance(child, QuantizedDense):
            replaced += _replace_dense(child)
    return replaced


def _quantize_tied_lm_head(network):
    """Weight-only int8 for a tied LM head (GPT-style ``wte``): the table's
    vocab dim is padded to a multiple of 128 (50257 -> 50304) with zero
    rows of scale 1, so pad lanes are exact zeros. Stores ``(table [Vp, D]
    int8, scales [Vp] f32, vocab)`` as ``network._q_lm_head``; the
    embedding lookup keeps the original table."""
    wte = getattr(network, "wte", None)
    if wte is None:
        return
    w_q, scale = _quantize_rows(wte.weight)
    V = w_q.shape[0]
    Vp = pad_vocab(V)
    if Vp != V:
        w_q = torch.nn.functional.pad(w_q, (0, 0, 0, Vp - V))
        scale = torch.nn.functional.pad(scale, (0, Vp - V), value=1.0)
    network._q_lm_head = (w_q.contiguous(), scale.contiguous(), V)


def quantize_net(network, quantized_dtype: str = "auto",
                 calib_mode: str = "none", quantize_tied_head: bool = True,
                 fused_decode: bool = False, bits: int = 8):
    """Quantize every Dense of ``network`` to int8 weight-only in place and
    return it (``mxnet_tpu.contrib.quantization.quantize_net`` with
    ``calib_mode='none'``). ``quantize_tied_head`` quantizes the tied LM
    head; ``fused_decode`` opts the model's blocks into the one-launch
    block decode kernel. ``bits=4`` and calibrated modes are later slices."""
    if quantized_dtype not in ("auto", "int8"):
        raise MXNetError(f"quantized_dtype={quantized_dtype!r}: the port "
                         "quantizes symmetric int8")
    if bits == 4:
        raise MXNetError("bits=4 (packed int4 weights, kernel K4 and the int4 "
                         "lanes of K5/K8) is a later slice of the port")
    if bits != 8:
        raise MXNetError(f"bits={bits!r}: supported weight width is 8")
    if calib_mode != "none":
        raise MXNetError(f"calib_mode={calib_mode!r}: the port supports "
                         "dynamic activation scales ('none') only")
    with torch.no_grad():
        _replace_dense(network)
        if quantize_tied_head:
            _quantize_tied_lm_head(network)
    if fused_decode and hasattr(network, "enable_fused_decode"):
        network.enable_fused_decode()
    return network
