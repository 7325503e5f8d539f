"""Gluon losses (counterpart of ``mxnet_tpu/gluon/loss.py``): the 13 losses
of the JAX package as ``HybridBlock``s over ``mx.np``/``mx.npx``. Called on
NDArrays they run through the funnel; called on torch tensors (as
``parallel.TrainStep`` calls ``SoftmaxCrossEntropyLoss`` on GPT's logits)
they are plain PyTorch. Sparse softmax cross-entropy over the last axis
takes the fused ``npx.softmax_cross_entropy`` (f32 statistics, no
log-softmax tensor kept for the backward)."""
from __future__ import annotations

import math
from typing import Optional

import torch

from .. import numpy as np
from .. import numpy_extension as npx
from ..base import MXNetError
from ..ndarray import apply
from .block import HybridBlock

__all__ = [
    "Loss", "L2Loss", "L1Loss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
    "SigmoidBinaryCrossEntropyLoss", "SigmoidBCELoss", "KLDivLoss", "HuberLoss",
    "HingeLoss", "SquaredHingeLoss", "LogisticLoss", "TripletLoss", "CosineEmbeddingLoss",
    "PoissonNLLLoss", "CTCLoss",
]


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        loss = loss * weight
    return loss


def _mean_all_but_batch(loss, batch_axis: int):
    axes = tuple(i for i in range(loss.ndim) if i != batch_axis)
    return loss.mean(axis=axes) if axes else loss


def _softplus_ce(p, lab):
    """``max(p, 0) - p * l + log1p(exp(-|p|))``."""
    return torch.clamp_min(p, 0) - p * lab + torch.log1p(torch.exp(-torch.abs(p)))


class Loss(HybridBlock):
    """Base loss: a per-sample loss averaged over the non-batch axes."""

    def __init__(self, weight: Optional[float] = None, batch_axis: int = 0):
        super().__init__()
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        return f"{type(self).__name__}(batch_axis={self._batch_axis}, w={self._weight})"


class L2Loss(Loss):
    def __init__(self, weight=1.0, batch_axis=0):
        super().__init__(weight, batch_axis)

    def forward(self, pred, label, sample_weight=None):
        loss = np.square(label.reshape(pred.shape) - pred) / 2.0
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_all_but_batch(loss, self._batch_axis)


class L1Loss(Loss):
    def __init__(self, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)

    def forward(self, pred, label, sample_weight=None):
        loss = np.abs(label.reshape(pred.shape) - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_all_but_batch(loss, self._batch_axis)


class SoftmaxCrossEntropyLoss(Loss):
    """Softmax cross-entropy with sparse or dense labels, optionally from
    log-probabilities."""

    def __init__(self, axis: int = -1, sparse_label: bool = True, from_logits: bool = False,
                 weight=None, batch_axis: int = 0):
        super().__init__(weight, batch_axis)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits and self._sparse_label \
                and self._axis in (-1, pred.ndim - 1):
            loss = npx.softmax_cross_entropy(pred, label)
        elif self._sparse_label:
            p = pred if self._from_logits else npx.log_softmax(pred, axis=self._axis)
            loss = -npx.pick(p, label, axis=self._axis, keepdims=False)
        else:
            p = pred if self._from_logits else npx.log_softmax(pred, axis=self._axis)
            loss = -np.sum(label.reshape(pred.shape) * p, axis=self._axis)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_all_but_batch(loss, self._batch_axis)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class SigmoidBinaryCrossEntropyLoss(Loss):
    def __init__(self, from_sigmoid: bool = False, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._from_sigmoid = from_sigmoid

    def forward(self, pred, label, sample_weight=None, pos_weight=None):
        label = label.reshape(pred.shape)
        if not self._from_sigmoid:
            if pos_weight is None:
                loss = apply(_softplus_ce, pred, label)
            else:
                loss = apply(lambda p, lab, pw: torch.clamp_min(p, 0) - p * lab
                             + torch.log1p(torch.exp(-torch.abs(p))) * (lab * (pw - 1.0) + 1.0),
                             pred, label, pos_weight)
        else:
            eps = 1e-12
            if pos_weight is None:
                loss = -(np.log(pred + eps) * label + np.log(1.0 - pred + eps) * (1.0 - label))
            else:
                loss = -(np.log(pred + eps) * label * pos_weight
                         + np.log(1.0 - pred + eps) * (1.0 - label))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_all_but_batch(loss, self._batch_axis)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class KLDivLoss(Loss):
    def __init__(self, from_logits: bool = True, axis: int = -1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._from_logits = from_logits
        self._axis = axis

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = npx.log_softmax(pred, axis=self._axis)
        loss = label * (np.log(label + 1e-12) - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_all_but_batch(loss, self._batch_axis)


class HuberLoss(Loss):
    def __init__(self, rho: float = 1.0, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._rho = rho

    def forward(self, pred, label, sample_weight=None):
        rho = self._rho

        def fn(p, lab):
            d = torch.abs(lab - p)
            return torch.where(d > rho, d - 0.5 * rho, 0.5 / rho * torch.square(d))
        loss = apply(fn, pred, label.reshape(pred.shape))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_all_but_batch(loss, self._batch_axis)


class HingeLoss(Loss):
    def __init__(self, margin: float = 1.0, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        loss = np.maximum(self._margin - pred * label.reshape(pred.shape), 0.0)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_all_but_batch(loss, self._batch_axis)


class SquaredHingeLoss(Loss):
    def __init__(self, margin: float = 1.0, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        loss = np.square(np.maximum(self._margin - pred * label.reshape(pred.shape), 0.0))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_all_but_batch(loss, self._batch_axis)


class LogisticLoss(Loss):
    def __init__(self, weight=None, batch_axis=0, label_format: str = "signed"):
        super().__init__(weight, batch_axis)
        if label_format not in ("signed", "binary"):
            raise MXNetError(f"bad label_format {label_format}")
        self._label_format = label_format

    def forward(self, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = apply(_softplus_ce, pred, label)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_all_but_batch(loss, self._batch_axis)


class TripletLoss(Loss):
    def __init__(self, margin: float = 1.0, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, pred, positive, negative, sample_weight=None):
        positive = positive.reshape(pred.shape)
        negative = negative.reshape(pred.shape)
        axes = tuple(range(1, pred.ndim))
        loss = np.sum(np.square(pred - positive) - np.square(pred - negative), axis=axes)
        loss = np.maximum(loss + self._margin, 0.0)
        return _apply_weighting(loss, self._weight, sample_weight)


class CosineEmbeddingLoss(Loss):
    def __init__(self, weight=None, batch_axis=0, margin: float = 0.0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, input1, input2, label, sample_weight=None):
        def fn(a, b):
            num = torch.sum(a * b, dim=-1)
            den = torch.linalg.vector_norm(a, dim=-1) * torch.linalg.vector_norm(b, dim=-1) \
                + 1e-12
            return num / den
        cos = apply(fn, input1, input2)
        label = label.reshape(cos.shape)
        loss = np.where(label == 1, 1.0 - cos, np.maximum(cos - self._margin, 0.0))
        return _apply_weighting(loss, self._weight, sample_weight)


class PoissonNLLLoss(Loss):
    def __init__(self, weight=None, from_logits: bool = True, batch_axis=0,
                 compute_full: bool = False):
        super().__init__(weight, batch_axis)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def forward(self, pred, target, sample_weight=None, epsilon: float = 1e-08):
        target = target.reshape(pred.shape)
        if self._from_logits:
            loss = np.exp(pred) - target * pred
        else:
            loss = pred - target * np.log(pred + epsilon)
        if self._compute_full:
            stirling = (target * np.log(target + 1e-12) - target
                        + 0.5 * np.log(2.0 * math.pi * (target + 1e-12)))
            loss = loss + np.where(target > 1.0, stirling, np.zeros_like(target))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return loss.mean()


def _ctc(logits, labels, plen, llen, blank_first):
    """CTC negative log-likelihood per sample (N,) from logits (N, T, C)
    and labels (N, L) padded with -1: the alpha recursion in log space over
    the blank-extended label sequence, in the logits' dtype."""
    logp = torch.log_softmax(logits, dim=-1)
    N, T, C = logp.shape
    L = labels.shape[1]
    blank = 0 if blank_first else C - 1
    dev = logp.device
    lab = labels.long()
    if llen is not None:
        lab = torch.where(torch.arange(L, device=dev)[None, :] < llen.long()[:, None], lab,
                          torch.full((), -1, dtype=torch.int64, device=dev))
    S = 2 * L + 1
    ext = torch.full((N, S), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = torch.where(lab >= 0, lab, torch.full((), blank, device=dev))
    lab_len = (lab >= 0).sum(dim=1)
    s_n = 2 * lab_len + 1
    neg_inf = torch.full((), -1e30, dtype=logp.dtype, device=dev)
    ext_m2 = torch.nn.functional.pad(ext, (2, 0), value=-2)[:, :S]
    can_skip = (ext != blank) & (ext != ext_m2)
    first = logp[:, 0, :]
    alpha = torch.cat([first[:, blank:blank + 1],
                       torch.where(lab_len > 0, first.gather(1, ext[:, 1:2])[:, 0],
                                   neg_inf)[:, None],
                       neg_inf.expand(N, S - 2)], dim=1)
    alphas = [alpha]
    for t in range(1, T):
        a_m1 = torch.cat([neg_inf.expand(N, 1), alpha[:, :S - 1]], dim=1)
        a_m2 = torch.cat([neg_inf.expand(N, 2), alpha[:, :S - 2]], dim=1)
        a_m2 = torch.where(can_skip, a_m2, neg_inf)
        merged = torch.logaddexp(torch.logaddexp(alpha, a_m1), a_m2)
        alpha = merged + logp[:, t, :].gather(1, ext)
        alphas.append(alpha)
    if plen is not None:
        t_idx = (plen.long() - 1).clamp(0, T - 1)
        alpha = torch.stack(alphas)[t_idx, torch.arange(N, device=dev)]
    last = alpha.gather(1, (s_n - 1)[:, None])[:, 0]
    prev = alpha.gather(1, (s_n - 2).clamp_min(0)[:, None])[:, 0]
    return -torch.logaddexp(last, prev)


class CTCLoss(Loss):
    """Connectionist temporal classification loss; ``layout`` NTC or TNC,
    labels padded with -1, optional per-sample lengths."""

    def __init__(self, layout: str = "NTC", label_layout: str = "NT", weight=None,
                 blank_label: str = "first"):
        super().__init__(weight, 0)
        if layout not in ("NTC", "TNC"):
            raise MXNetError(f"bad layout {layout}")
        self._layout = layout
        self._label_layout = label_layout
        self._blank = blank_label

    def forward(self, pred, label, pred_lengths=None, label_lengths=None,
                sample_weight=None):
        if self._layout == "TNC":
            pred = np.swapaxes(pred, 0, 1)
        arrays = [pred, label] + [a for a in (pred_lengths, label_lengths) if a is not None]
        has_p, has_l = pred_lengths is not None, label_lengths is not None

        def fn(p, lab, *lens):
            return _ctc(p, lab, lens[0] if has_p else None, lens[int(has_p)] if has_l else None,
                        self._blank == "first")
        loss = apply(fn, *arrays)
        return _apply_weighting(loss, self._weight, sample_weight)
