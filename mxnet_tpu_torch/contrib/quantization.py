"""Weight-only int8 and int4 quantization of Dense layers and of the tied
LM head (counterpart of ``mxnet_tpu/contrib/quantization.py``, ``bits=8``
or ``bits=4``, with dynamic activation scales (``calib_mode='none'``) or
scales calibrated on sample batches (``'naive'``: the abs-max;
``'entropy'``: the KL-optimal clip of a 2048-bin histogram)).

The weight tables are bit-for-bit the JAX package's. int8: per-output-channel
``scale = max(amax, 1e-8) / 127`` and ``w_q = clip(round(w / scale), -127,
127)`` with the same division order (``torch.round`` and ``jnp.round``
both round half to even). int4: the ``kvstore.quant`` codec's wire format,
packed nibble pairs (``w_q`` uint8 [N, K/2]) with f32 block scales
(``w_scale`` [N, K/block]). The table's dtype is the dispatch everywhere
downstream.

Calibration is the JAX package's observe -> freeze lifecycle: every
QuantizedDense first observes the inputs of its unquantized layer while
the calibration batches run forward (a running abs-max and a re-binned
|x| histogram, :class:`_Calibrator`, in numpy as in JAX), then freezes the
activation scale that its product of more than ``gemv_max_m()`` rows
uses. Up to ``gemv_max_m()`` rows stream the weights (K3, K4) and take
no activation scale, calibrated or not.
"""
from __future__ import annotations

import logging

import numpy as np
import torch
from torch import nn

from ..autograd import predict_mode
from ..base import MXNetError
from ..models._layers import Dense
from ..kvstore.quant import pack_codes, quantize_blocks
from ..ops.fused_block_gemv import pad_vocab
from ..ops.int8_gemv import (GEMV_INT4_BLOCK, dequantize_int4_table, gemv_max_m,
                             weight_matmul)

__all__ = ["QuantizedDense", "quantize_net", "optimal_kl_threshold"]

_QMAX = 127.0  # symmetric int8
_LOG = logging.getLogger(__name__)


def _quantize_rows(w, own_dtype=False):
    """(int8 table, f32 per-row scales) of a (rows, in) weight. The tied
    head forms the abs-max and the scale in f32; a Dense layer
    (``own_dtype``) in the weight's own dtype, as the JAX package's
    QuantizedDense does (a bf16 weight's scale is bf16(amax / 127), then
    widened). The codes divide the f32 weight by the f32 scale either way."""
    w = w.detach()
    wf = w.float()
    amax = torch.clamp_min((w if own_dtype else wf).abs().amax(dim=1), 1e-8)
    scale = (amax / _QMAX).float()
    w_q = torch.clamp(torch.round(wf / scale[:, None]), -_QMAX, _QMAX).to(torch.int8)
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


def optimal_kl_threshold(hist: np.ndarray, edges: np.ndarray,
                         num_quantized_bins: int = 255) -> float:
    """KL-divergence-minimising clip threshold over an |x| histogram (the
    JAX package's ``optimal_kl_threshold``, copied op for op). For each
    candidate threshold (right edge of bin ``i``): P = the first ``i``
    bins with the outlier mass collapsed into bin i-1; Q = P re-binned to
    ``num_quantized_bins`` levels then expanded back, zero where the source
    bin was empty. Returns the edge minimising KL(P||Q). ``edges`` are the
    RIGHT edges of the bins (len(edges) == len(hist))."""
    hist = hist.astype(np.float64)
    n = len(hist)
    if n <= num_quantized_bins or hist.sum() == 0:
        return float(edges[-1])
    eps = 1e-10
    best_kl, best_i = np.inf, n
    for i in range(num_quantized_bins, n + 1, 4):
        p = hist[:i].copy()
        p[-1] += hist[i:].sum()
        src = hist[:i]
        qbin = np.arange(i) * num_quantized_bins // i   # source -> level
        level_mass = np.bincount(qbin, weights=src, minlength=num_quantized_bins)
        nz = src > 0
        level_nz = np.bincount(qbin, weights=nz.astype(np.float64),
                               minlength=num_quantized_bins)
        q = np.where(nz, level_mass[qbin] / np.maximum(level_nz[qbin], 1), 0.0)
        psum, qsum = p.sum(), q.sum()
        if psum == 0 or qsum == 0:
            continue
        # smooth both so KL stays finite and a sparse histogram does not
        # give a spurious zero divergence at the smallest threshold
        p = p / psum + eps
        q = q / qsum + eps
        p /= p.sum()
        q /= q.sum()
        kl = float(np.sum(p * np.log(p / q)))
        if kl < best_kl:
            best_kl, best_i = kl, i
    return float(edges[best_i - 1])


class _Calibrator:
    """One layer's activation-range observer (the JAX package's
    ``_Calibrator``): a running abs-max, and a ``NUM_BINS``-bin histogram
    of |x| over [0, abs-max] whose old counts are re-binned by bin centre
    when the range grows."""

    NUM_BINS = 2048

    def __init__(self):
        self.amax = 0.0
        self.hist = None
        self.edges = None

    def observe(self, x: np.ndarray):
        amax = float(np.max(np.abs(x))) if x.size else 0.0
        if self.hist is None:
            self.amax = amax
        else:
            self.amax = max(self.amax, amax)
        h, edges = np.histogram(np.abs(x), bins=self.NUM_BINS,
                                range=(0, max(self.amax, 1e-8)))
        if self.edges is not None and self.edges[-1] == edges[-1]:
            self.hist += h
        else:
            # the range grew: re-bin the old histogram into the new edges
            if self.hist is not None:
                centers = (self.edges[:-1] + self.edges[1:]) / 2
                idx = np.clip(np.searchsorted(edges, centers) - 1,
                              0, self.NUM_BINS - 1)
                nh = np.zeros(self.NUM_BINS)
                np.add.at(nh, idx, self.hist)
                h = h + nh
            self.hist = h
            self.edges = edges
            return
        if self.hist is None:
            self.hist, self.edges = h, edges

    def threshold(self, mode: str) -> float:
        if mode == "entropy" and self.hist is not None:
            return optimal_kl_threshold(self.hist, self.edges[1:])
        return self.amax


class QuantizedDense(nn.Module):
    """Weight-only Dense: int8 with dynamic or calibrated activation
    scales, or (``bits=4`` and an even input dim) packed int4 with block
    scales. A layer whose input dim is odd cannot pack nibble pairs and
    keeps int8.

    Up to ``gemv_max_m()`` rows stream the weights through K3
    (:func:`~mxnet_tpu_torch.ops.int8_gemv.int8_weight_matmul`) or K4
    (:func:`~mxnet_tpu_torch.ops.int8_gemv.int4_weight_matmul`) with the
    activations as they come (f32 or bf16). More rows of an int4 layer
    dequantize the table through the codec and run the f32 matmul
    (correct, and slow: the whole table is dequantized on every call). More
    rows of an int8 layer take the activation-quantized int8 x int8
    product of the JAX package: the activation scale is the frozen
    calibrated one (:meth:`freeze`), else the abs-max of the whole input
    over 127, and ``x / s_x`` is divided in f32 whatever x's dtype (JAX's
    f32 scale promotes a bf16 x; a 0-dim f32 tensor does not promote one in
    torch). The integer product is formed exactly: its sums reach 127 * 127
    * K (about 5e7 at K = 3072), past what f32 holds exactly, so it runs in
    float64, exact for integers below 2**53 on the CPU and on the card
    alike; rounding that exact integer to f32 gives the bits JAX's int32 ->
    f32 conversion gives.

    Lifecycle (the JAX package's ``_QuantizedLayer``): ``dynamic`` at
    construction; :meth:`begin_observe` makes the forward record its input
    in the layer's :class:`_Calibrator` and return the unquantized layer's
    output; :meth:`freeze` turns the observations into ``_act_scale``.
    """

    def __init__(self, inner: Dense, bits: int = 8):
        super().__init__()
        self.inner = inner
        K = inner.weight.shape[1]
        if bits == 4 and K % 2 == 0:
            w_q, w_scale = _quantize_int4(inner.weight)
        else:
            w_q, w_scale = _quantize_rows(inner.weight, own_dtype=True)
        self.register_buffer("w_q", w_q)
        self.register_buffer("w_scale", w_scale)
        self._mode = "dynamic"      # dynamic | observe | frozen
        self._calib = _Calibrator()
        self._act_scale = None

    def begin_observe(self):
        self._mode = "observe"

    def freeze(self, calib_mode: str):
        """End observation: under ``'naive'`` or ``'entropy'`` the layer's
        activation scale becomes the observed threshold over 127 (1 where
        it is 0)."""
        if self._mode == "observe" and calib_mode in ("naive", "entropy"):
            amax = self._calib.threshold(calib_mode)
            self._act_scale = (amax / _QMAX) if amax > 0 else 1.0
        self._mode = "frozen" if self._act_scale is not None else "dynamic"

    def _input_qscale(self, x):
        """The 0-dim f32 activation scale: the frozen one, else the input's
        abs-max over 127 in x's dtype (JAX's weakly typed arithmetic), then
        f32."""
        if self._act_scale is not None:
            # a fill, not a copy from the host: capturable in a CUDA graph
            return torch.full((), self._act_scale, dtype=torch.float32, device=x.device)
        amax = x.abs().max()
        return torch.where(amax > 0, amax / _QMAX, torch.ones_like(amax)).float()

    def forward(self, x):
        if self._mode == "observe":
            self._calib.observe(x.detach().float().cpu().numpy())
            # the unquantized layer in the JAX package's op order: the
            # product rounded to the dtype, then the bias added
            y = torch.nn.functional.linear(x, self.inner.weight)
            return y if self.inner.bias is None else y + self.inner.bias
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
            s_x = self._input_qscale(x)
            x_q = torch.clamp(torch.round(x.reshape(rows, K).float() / s_x), -_QMAX, _QMAX)
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


@torch.no_grad()
def requantize_(network):
    """Derive every :class:`QuantizedDense` table and the quantized tied
    head again from the network's current float weights, in place: the
    tables keep their tensors (a captured CUDA graph reads the new values)
    and equal what :func:`quantize_net` derives from the same weights, in
    each layer's lane. Frozen activation scales stay as calibrated. The
    engine's live weight swap calls it after copying the new weights."""
    for m in network.modules():
        if isinstance(m, QuantizedDense):
            if m.w_q.dtype == torch.uint8:
                w_q, w_scale = _quantize_int4(m.inner.weight)
            else:
                w_q, w_scale = _quantize_rows(m.inner.weight, own_dtype=True)
            m.w_q.copy_(w_q)
            m.w_scale.copy_(w_scale)
    head = getattr(network, "_q_lm_head", None)
    if head is not None:
        _quantize_tied_lm_head(network, 4 if head[0].dtype == torch.uint8 else 8)
        new = network._q_lm_head
        head[0].copy_(new[0])
        head[1].copy_(new[1])
        network._q_lm_head = head


def _tied_table(network):
    """The embedding table a tied head reads: GPT's ``wte``, or a
    ``tie_embeddings`` Llama's ``model.embed_tokens``; None for an untied
    head (an ``lm_head`` is set: nothing reads the table)."""
    wte = getattr(network, "wte", None)
    if wte is not None and hasattr(wte, "weight"):
        return wte
    emb = getattr(getattr(network, "model", None), "embed_tokens", None)
    if emb is None or not hasattr(emb, "weight") or getattr(network, "lm_head", 0) is not None:
        return None
    return emb


def _quantize_tied_lm_head(network, bits=8):
    """Weight-only quantization of a tied LM head (GPT's ``wte``, a tied
    Llama's ``model.embed_tokens``; an untied head is left alone): the
    table's vocab dim is padded to a multiple of 128 (50257 -> 50304).
    int8: zero rows of scale 1 are appended to the quantized table,
    ``(table [Vp, D] int8, scales [Vp] f32, vocab)``. ``bits=4`` (even D):
    the f32 table is padded FIRST with zero rows, which quantize to
    all-zero blocks of scale 1.0, then packed, ``(table [Vp, D/2] uint8,
    scales [Vp, D/block] f32, vocab)``. Either way pad lanes dequantize to
    exact zeros. Stored as ``network._q_lm_head``; the embedding lookup
    keeps the original table."""
    wte = _tied_table(network)
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


def _calibrate(network, replaced, calib_data, num_calib_batches):
    """Run the calibration batches forward with every replaced layer
    observing (the unquantized layers compute, in plain PyTorch on the
    model's device); each batch is a token array or a tuple/list whose
    first item is one. Runs in ``autograd.predict_mode`` (no dropout)."""
    with predict_mode():
        _run_calibration(network, replaced, calib_data, num_calib_batches)


def _run_calibration(network, replaced, calib_data, num_calib_batches):
    for q in replaced:
        q.begin_observe()
    dev = next(network.parameters()).device
    n = 0
    for batch in calib_data:
        data = batch[0] if isinstance(batch, (tuple, list)) else batch
        if not torch.is_tensor(data):
            data = torch.as_tensor(np.asarray(data))
        network(data.to(dev))
        n += 1
        if num_calib_batches is not None and n >= num_calib_batches:
            break
    if n == 0:
        raise MXNetError("calib_data yielded no batches")


def quantize_net(network, quantized_dtype: str = "auto",
                 calib_mode: str = "none", calib_data=None,
                 num_calib_batches=None, quantize_tied_head: bool = True,
                 fused_decode: bool = False, bits: int = 8):
    """Quantize every Dense of ``network`` to weight-only int8 (``bits=8``)
    or packed int4 (``bits=4``; odd-input-dim layers keep int8) in place
    and return it (``mxnet_tpu.contrib.quantization.quantize_net``).
    ``calib_mode='none'`` gives every layer dynamic activation scales;
    ``'naive'`` and ``'entropy'`` need ``calib_data``, an iterable of
    token batches (at most ``num_calib_batches`` of them run), and freeze
    each layer's scale from its observed inputs. ``quantize_tied_head``
    quantizes the tied LM head (GPT's, a tied Llama's) at the same width;
    ``fused_decode`` opts the model's blocks into the one-launch block
    decode kernel. A network with no Dense layer (the stacked Llama
    decoder) is returned unchanged, tied head included, as in the JAX
    package."""
    if quantized_dtype not in ("auto", "int8"):
        raise MXNetError(f"quantized_dtype={quantized_dtype!r}: the port "
                         "quantizes symmetric int8")
    if bits not in (4, 8):
        raise MXNetError(f"bits={bits!r}: supported weight codec widths are 8 "
                         "(int8) and 4 (packed block-scaled nibbles)")
    if calib_mode in ("naive", "entropy"):
        if calib_data is None:
            raise MXNetError(f"calib_data required for calib_mode={calib_mode!r}")
    elif calib_mode != "none":
        raise MXNetError(f"unknown calib_mode {calib_mode!r}")
    with torch.no_grad():
        replaced = _replace_dense(network, bits)
        if not replaced:
            # as the JAX package: a network without Dense layers (the
            # stacked Llama decoder) is returned as it is, tied head too
            _LOG.warning("quantize_net: no quantizable layers found")
            return network
        if calib_mode != "none":
            _calibrate(network, replaced, calib_data, num_calib_batches)
        for q in replaced:
            q.freeze(calib_mode)
        if quantize_tied_head:
            _quantize_tied_lm_head(network, bits)
    if fused_decode and hasattr(network, "enable_fused_decode"):
        network.enable_fused_decode()
    return network
