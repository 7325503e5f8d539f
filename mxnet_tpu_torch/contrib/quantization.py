"""Weight-only int8 and int4 quantization of Dense layers and of the tied
LM head (counterpart of ``mxnet_tpu/contrib/quantization.py``, ``bits=8``
or ``bits=4`` with ``calib_mode='none'``).

The weight tables are bit-for-bit the JAX package's. int8: per-output-channel
``scale = max(amax, 1e-8) / 127`` and ``w_q = clip(round(w / scale), -127,
127)`` with the same division order (``torch.round`` and ``jnp.round``
both round half to even). int4: the ``kvstore.quant`` codec's wire format,
packed nibble pairs (``w_q`` uint8 [N, K/2]) with f32 block scales
(``w_scale`` [N, K/block]). The table's dtype is the dispatch everywhere
downstream.
"""
from __future__ import annotations

import torch
from torch import nn

from ..base import MXNetError
from ..gluon.nn import Dense
from ..kvstore.quant import pack_codes, quantize_blocks
from ..ops.fused_block_gemv import pad_vocab
from ..ops.int8_gemv import (GEMV_INT4_BLOCK, dequantize_int4_table, gemv_max_m,
                             weight_matmul)

__all__ = ["QuantizedDense", "quantize_net"]

_QMAX = 127.0  # symmetric int8


def _quantize_rows(w):
    """(int8 table, f32 per-row scales) of a (rows, in) f32 weight."""
    w = w.detach().float()
    amax = torch.clamp_min(w.abs().amax(dim=1), 1e-8)
    scale = amax / _QMAX
    w_q = torch.clamp(torch.round(w / scale[:, None]), -_QMAX, _QMAX).to(torch.int8)
    return w_q, scale


def _int4_block(K: int) -> int:
    """Codes per scale: ``GEMV_INT4_BLOCK`` where it tiles K, else one
    block per row (a block never straddles two output channels)."""
    return GEMV_INT4_BLOCK if K % GEMV_INT4_BLOCK == 0 else K


def _quantize_int4(w):
    """(packed table [N, K/2] uint8, block scales [N, K/block] f32) of an
    (N, K) weight with even K, through the codec."""
    N, K = w.shape
    block = _int4_block(K)
    codes, scales = quantize_blocks(w.detach().float().reshape(-1), 4, block)
    return pack_codes(codes, 4).reshape(N, K // 2), scales.reshape(N, K // block)


class QuantizedDense(nn.Module):
    """Weight-only Dense: int8 with dynamic activation scales, or (``bits=4``
    and an even input dim) packed int4 with block scales. A layer whose
    input dim is odd cannot pack nibble pairs and keeps int8.

    Up to ``gemv_max_m()`` rows stream the weights through K3
    (:func:`~mxnet_tpu_torch.ops.int8_gemv.int8_weight_matmul`) or K4
    (:func:`~mxnet_tpu_torch.ops.int8_gemv.int4_weight_matmul`) with f32
    activations. More rows of an int4 layer dequantize the table through
    the codec and run the f32 matmul (correct, and slow: the whole table is
    dequantized on every call). More rows of an int8 layer take the
    activation-quantized int8 x int8 product of the JAX package: the
    activation scale is the abs-max of the whole input over 127, and the
    integer product is formed exactly. The sums reach 127 * 127 * K (about
    5e7 at K = 3072), past what f32 holds exactly, so the product runs in
    float64, exact for integers below 2**53 on the CPU and on the card
    alike; rounding that exact integer to f32 gives the bits JAX's int32 ->
    f32 conversion gives.
    """

    def __init__(self, inner: Dense, bits: int = 8):
        super().__init__()
        self.inner = inner
        K = inner.weight.shape[1]
        if bits == 4 and K % 2 == 0:
            w_q, w_scale = _quantize_int4(inner.weight)
        else:
            w_q, w_scale = _quantize_rows(inner.weight)
        self.register_buffer("w_q", w_q)
        self.register_buffer("w_scale", w_scale)

    def forward(self, x):
        rows = x.numel() // x.shape[-1]
        K = x.shape[-1]
        N = self.w_q.shape[0]
        if rows <= gemv_max_m():
            y = weight_matmul(x.reshape(rows, K), self.w_q, self.w_scale)
        elif self.w_q.dtype == torch.uint8:
            # the codec's dequantized table, then the f32 matmul: on any
            # device, as the JAX package runs it outside any kernel
            y = x.reshape(rows, K).float() @ dequantize_int4_table(self.w_q, self.w_scale).T
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


def _replace_dense(module, bits):
    replaced = []
    for name, child in list(module.named_children()):
        if isinstance(child, Dense):
            q = QuantizedDense(child, bits)
            setattr(module, name, q)
            replaced.append(q)
        elif not isinstance(child, QuantizedDense):
            replaced += _replace_dense(child, bits)
    return replaced


def _quantize_tied_lm_head(network, bits=8):
    """Weight-only quantization of a tied LM head (GPT-style ``wte``): the
    table's vocab dim is padded to a multiple of 128 (50257 -> 50304).
    int8: zero rows of scale 1 are appended to the quantized table,
    ``(table [Vp, D] int8, scales [Vp] f32, vocab)``. ``bits=4`` (even D):
    the f32 table is padded FIRST with zero rows, which quantize to
    all-zero blocks of scale 1.0, then packed, ``(table [Vp, D/2] uint8,
    scales [Vp, D/block] f32, vocab)``. Either way pad lanes dequantize to
    exact zeros. Stored as ``network._q_lm_head``; the embedding lookup
    keeps the original table."""
    wte = getattr(network, "wte", None)
    if wte is None:
        return
    V, D = wte.weight.shape
    Vp = pad_vocab(V)
    if bits == 4 and D % 2 == 0:
        w = torch.nn.functional.pad(wte.weight.detach().float(), (0, 0, 0, Vp - V))
        w_q, scale = _quantize_int4(w)
        network._q_lm_head = (w_q.contiguous(), scale.contiguous(), V)
        return
    w_q, scale = _quantize_rows(wte.weight)
    if Vp != V:
        w_q = torch.nn.functional.pad(w_q, (0, 0, 0, Vp - V))
        scale = torch.nn.functional.pad(scale, (0, Vp - V), value=1.0)
    network._q_lm_head = (w_q.contiguous(), scale.contiguous(), V)


def quantize_net(network, quantized_dtype: str = "auto",
                 calib_mode: str = "none", quantize_tied_head: bool = True,
                 fused_decode: bool = False, bits: int = 8):
    """Quantize every Dense of ``network`` to weight-only int8 (``bits=8``)
    or packed int4 (``bits=4``; odd-input-dim layers keep int8) in place
    and return it (``mxnet_tpu.contrib.quantization.quantize_net`` with
    ``calib_mode='none'``). ``quantize_tied_head`` quantizes the tied LM
    head at the same width; ``fused_decode`` opts the model's blocks into
    the one-launch block decode kernel. Calibrated modes are a later
    slice."""
    if quantized_dtype not in ("auto", "int8"):
        raise MXNetError(f"quantized_dtype={quantized_dtype!r}: the port "
                         "quantizes symmetric int8")
    if bits not in (4, 8):
        raise MXNetError(f"bits={bits!r}: supported weight codec widths are 8 "
                         "(int8) and 4 (packed block-scaled nibbles)")
    if calib_mode != "none":
        raise MXNetError(f"calib_mode={calib_mode!r}: the port supports "
                         "dynamic activation scales ('none') only")
    with torch.no_grad():
        _replace_dense(network, bits)
        if quantize_tied_head:
            _quantize_tied_lm_head(network, bits)
    if fused_decode and hasattr(network, "enable_fused_decode"):
        network.enable_fused_decode()
    return network
