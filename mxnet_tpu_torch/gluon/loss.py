"""Gluon losses (counterpart of ``mxnet_tpu/gluon/loss.py``): ``Loss`` and
``SoftmaxCrossEntropyLoss``. The other losses come with later slices."""
from __future__ import annotations

from typing import Optional

from torch import nn

from .. import numpy_extension as npx

__all__ = ["Loss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        loss = loss * weight
    return loss


class Loss(nn.Module):
    """Base loss: per-sample loss averaged over all non-batch axes."""

    def __init__(self, weight: Optional[float] = None, batch_axis: int = 0):
        super().__init__()
        self._weight = weight
        self._batch_axis = batch_axis


def _mean_all_but_batch(loss, batch_axis: int):
    axes = tuple(i for i in range(loss.dim()) if i != batch_axis)
    return loss.mean(dim=axes) if axes else loss


class SoftmaxCrossEntropyLoss(Loss):
    """Softmax cross-entropy with sparse or dense labels, optionally from
    log-probabilities. Sparse labels over the last axis take the fused
    ``numpy_extension.softmax_cross_entropy`` (f32 statistics, no
    log-softmax tensor kept for the backward)."""

    def __init__(self, axis: int = -1, sparse_label: bool = True,
                 from_logits: bool = False, weight=None, batch_axis: int = 0):
        super().__init__(weight, batch_axis)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits and self._sparse_label \
                and self._axis in (-1, pred.dim() - 1):
            loss = npx.softmax_cross_entropy(pred, label)
        elif self._sparse_label:
            p = pred if self._from_logits else npx.log_softmax(pred, axis=self._axis)
            loss = -npx.pick(p, label, axis=self._axis, keepdims=False)
        else:
            p = pred if self._from_logits else npx.log_softmax(pred, axis=self._axis)
            loss = -(label.reshape(pred.shape) * p).sum(dim=self._axis)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_all_but_batch(loss, self._batch_axis)


SoftmaxCELoss = SoftmaxCrossEntropyLoss
