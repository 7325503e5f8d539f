"""Evaluation metrics (counterpart of ``mxnet_tpu/gluon/metric.py``): the
``EvalMetric`` registry with its aliases, ``create``, ``np`` and the
metrics of classification (Accuracy, TopKAccuracy, F1, Fbeta,
BinaryAccuracy, MCC, PCC), regression (MAE, MSE, RMSE,
MeanPairwiseDistance, MeanCosineSimilarity, PearsonCorrelation) and
language modelling (CrossEntropy, Perplexity), Loss and CustomMetric.

Metrics accumulate on the host in numpy, as in the JAX package: labels and
predictions may be NDArrays, tensors on the CPU or the card (copied to the
host; bf16 read as f32) or numpy arrays.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as onp
import torch

from ..base import MXNetError
from ..ndarray import NDArray

__all__ = [
    "EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy", "F1",
    "Fbeta", "BinaryAccuracy", "MCC", "PCC", "MAE", "MSE", "RMSE",
    "MeanPairwiseDistance", "MeanCosineSimilarity", "CrossEntropy",
    "Perplexity", "PearsonCorrelation", "Loss", "CustomMetric", "np",
    "create", "register",
]

# lower-cased name or alias -> metric class
_REGISTRY: Dict[str, type] = {}


def register(klass=None, name=None, aliases=()):
    """Register a metric class under ``name`` (default: its class name) and
    ``aliases``, all lower-cased."""
    def _do(k):
        for key in ((name or k.__name__), *aliases):
            _REGISTRY[key.lower()] = k
        return k
    return _do if klass is None else _do(klass)


def create(metric, *args, **kwargs) -> "EvalMetric":
    """A metric from an instance (returned as is), a list of specs (a
    composite), a ``feval(label, pred)`` callable (a CustomMetric) or a
    registered name."""
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, (list, tuple)):
        out = CompositeEvalMetric()
        for m in metric:
            out.add(create(m))
        return out
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    key = str(metric).lower()
    if key not in _REGISTRY:
        raise MXNetError(f"metric registry: unknown entry {metric!r}; "
                         f"known: {sorted(_REGISTRY)}")
    return _REGISTRY[key](*args, **kwargs)


def _to_numpy(x) -> onp.ndarray:
    if isinstance(x, NDArray):
        x = x._data
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return onp.asarray(x)


class EvalMetric:
    """Base metric (reference metric.py EvalMetric)."""

    def __init__(self, name: str, output_names=None, label_names=None):
        self.name = name
        self.output_names = output_names
        self.label_names = label_names
        self.reset()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        raise NotImplementedError

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, self.sum_metric / self.num_inst

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def __str__(self):
        return f"EvalMetric: {dict(self.get_name_value())}"


class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name: str = "composite"):
        super().__init__(name)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def get(self):
        names, values = [], []
        for m in self.metrics:
            n, v = m.get()
            names.append(n)
            values.append(v)
        return names, values


def _as_pair(labels, preds):
    if isinstance(labels, (list, tuple)):
        labels = labels[0]
    if isinstance(preds, (list, tuple)):
        preds = preds[0]
    return _to_numpy(labels), _to_numpy(preds)


@register
class Accuracy(EvalMetric):
    def __init__(self, axis: int = -1, name: str = "accuracy", **kwargs):
        super().__init__(name, **kwargs)
        self.axis = axis

    def update(self, labels, preds):
        label, pred = _as_pair(labels, preds)
        if pred.ndim > label.ndim:
            pred = pred.argmax(axis=self.axis)
        pred = pred.astype(onp.int64).ravel()
        label = label.astype(onp.int64).ravel()
        self.sum_metric += float((pred == label).sum())
        self.num_inst += label.size


acc = Accuracy  # the reference's alias: mx.metric.create('acc')
register(Accuracy, name="acc")


@register
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k: int = 1, name: str = "top_k_accuracy", **kwargs):
        super().__init__(f"{name}_{top_k}", **kwargs)
        self.top_k = top_k

    def update(self, labels, preds):
        label, pred = _as_pair(labels, preds)
        argsorted = onp.argsort(pred, axis=-1)[..., ::-1][..., :self.top_k]
        label = label.astype(onp.int64).reshape(label.shape + (1,))
        self.sum_metric += float((argsorted == label).any(axis=-1).sum())
        self.num_inst += label.size


@register
class F1(EvalMetric):
    def __init__(self, name: str = "f1", average: str = "macro", **kwargs):
        self.average = average
        self._tp = self._fp = self._fn = 0.0
        super().__init__(name, **kwargs)

    def reset(self):
        super().reset()
        self._tp = self._fp = self._fn = 0.0

    def update(self, labels, preds):
        label, pred = _as_pair(labels, preds)
        if pred.ndim > 1 and pred.shape[-1] > 1:
            pred = pred.argmax(axis=-1)
        else:
            pred = (pred.ravel() > 0.5).astype(onp.int64)
        label = label.astype(onp.int64).ravel()
        pred = pred.astype(onp.int64).ravel()
        self._tp += float(((pred == 1) & (label == 1)).sum())
        self._fp += float(((pred == 1) & (label == 0)).sum())
        self._fn += float(((pred == 0) & (label == 1)).sum())
        self.num_inst = 1  # get() computes from counters

    def get(self):
        prec = self._tp / max(self._tp + self._fp, 1e-12)
        rec = self._tp / max(self._tp + self._fn, 1e-12)
        f1 = 2 * prec * rec / max(prec + rec, 1e-12)
        return self.name, f1


@register
class MCC(EvalMetric):
    """Matthews correlation coefficient."""

    def __init__(self, name: str = "mcc", **kwargs):
        self._c = onp.zeros((2, 2))
        super().__init__(name, **kwargs)

    def reset(self):
        super().reset()
        self._c = onp.zeros((2, 2))

    def update(self, labels, preds):
        label, pred = _as_pair(labels, preds)
        if pred.ndim > 1 and pred.shape[-1] > 1:
            pred = pred.argmax(axis=-1)
        else:
            pred = (pred.ravel() > 0.5).astype(onp.int64)
        label = label.astype(onp.int64).ravel()
        pred = pred.astype(onp.int64).ravel()
        for l, p in ((0, 0), (0, 1), (1, 0), (1, 1)):
            self._c[l, p] += float(((label == l) & (pred == p)).sum())
        self.num_inst = 1

    def get(self):
        tn, fp, fn, tp = self._c[0, 0], self._c[0, 1], self._c[1, 0], self._c[1, 1]
        denom = onp.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
        mcc = (tp * tn - fp * fn) / denom if denom > 0 else 0.0
        return self.name, float(mcc)


@register
class MAE(EvalMetric):
    def __init__(self, name: str = "mae", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        label, pred = _as_pair(labels, preds)
        self.sum_metric += float(onp.abs(label.reshape(pred.shape) - pred).mean()) * label.shape[0]
        self.num_inst += label.shape[0]


@register
class MSE(EvalMetric):
    def __init__(self, name: str = "mse", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        label, pred = _as_pair(labels, preds)
        self.sum_metric += float(((label.reshape(pred.shape) - pred) ** 2).mean()) * label.shape[0]
        self.num_inst += label.shape[0]


@register
class RMSE(MSE):
    def __init__(self, name: str = "rmse", **kwargs):
        EvalMetric.__init__(self, name)

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, float(onp.sqrt(self.sum_metric / self.num_inst))


@register
class CrossEntropy(EvalMetric):
    def __init__(self, eps: float = 1e-12, name: str = "cross-entropy", **kwargs):
        super().__init__(name, **kwargs)
        self.eps = eps

    def update(self, labels, preds):
        label, pred = _as_pair(labels, preds)
        label = label.astype(onp.int64).ravel()
        prob = pred[onp.arange(label.size), label]
        self.sum_metric += float(-onp.log(prob + self.eps).sum())
        self.num_inst += label.size


@register
class Perplexity(CrossEntropy):
    def __init__(self, ignore_label=None, axis=-1, name: str = "perplexity", **kwargs):
        super().__init__(name=name, **kwargs)
        self.ignore_label = ignore_label

    def update(self, labels, preds):
        label, pred = _as_pair(labels, preds)
        label = label.astype(onp.int64).ravel()
        prob = pred.reshape(-1, pred.shape[-1])[onp.arange(label.size), label]
        if self.ignore_label is not None:
            keep = label != self.ignore_label
            prob = prob[keep]
            label = label[keep]
        self.sum_metric += float(-onp.log(prob + self.eps).sum())
        self.num_inst += label.size

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, float(onp.exp(self.sum_metric / self.num_inst))


@register
class PearsonCorrelation(EvalMetric):
    def __init__(self, name: str = "pearsonr", **kwargs):
        self._x: List[onp.ndarray] = []
        self._y: List[onp.ndarray] = []
        super().__init__(name, **kwargs)

    def reset(self):
        super().reset()
        self._x, self._y = [], []

    def update(self, labels, preds):
        label, pred = _as_pair(labels, preds)
        self._x.append(label.ravel())
        self._y.append(pred.ravel())
        self.num_inst = 1

    def get(self):
        if not self._x:
            return self.name, float("nan")
        x = onp.concatenate(self._x)
        y = onp.concatenate(self._y)
        return self.name, float(onp.corrcoef(x, y)[0, 1])


@register
class Loss(EvalMetric):
    """Running mean of loss values (reference metric.Loss)."""

    def __init__(self, name: str = "loss", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, _, preds):
        if isinstance(preds, (list, tuple)):
            for p in preds:
                arr = _to_numpy(p)
                self.sum_metric += float(arr.sum())
                self.num_inst += arr.size
        else:
            arr = _to_numpy(preds)
            self.sum_metric += float(arr.sum())
            self.num_inst += arr.size


class CustomMetric(EvalMetric):
    def __init__(self, feval, name: str = "custom", allow_extra_outputs=False):
        super().__init__(name)
        self._feval = feval

    def update(self, labels, preds):
        label, pred = _as_pair(labels, preds)
        self.sum_metric += float(self._feval(label, pred))
        self.num_inst += 1


@register
class Fbeta(F1):
    """F-beta score (reference metric.Fbeta): recall weighted beta² over
    precision."""

    def __init__(self, name: str = "fbeta", beta: float = 1.0, **kwargs):
        super().__init__(name=name, **kwargs)
        self.beta = beta

    def get(self):
        prec = self._tp / max(self._tp + self._fp, 1e-12)
        rec = self._tp / max(self._tp + self._fn, 1e-12)
        b2 = self.beta * self.beta
        f = (1 + b2) * prec * rec / max(b2 * prec + rec, 1e-12)
        return self.name, f


@register
class BinaryAccuracy(EvalMetric):
    """Accuracy of thresholded binary predictions (reference
    metric.BinaryAccuracy)."""

    def __init__(self, name: str = "binary_accuracy", threshold: float = 0.5,
                 **kwargs):
        super().__init__(name, **kwargs)
        self.threshold = threshold

    def update(self, labels, preds):
        label, pred = _as_pair(labels, preds)
        pred = (pred.ravel() > self.threshold).astype(onp.int64)
        label = label.astype(onp.int64).ravel()
        self.sum_metric += float((pred == label).sum())
        self.num_inst += label.size


@register
class MeanPairwiseDistance(EvalMetric):
    """Mean p-norm distance between predictions and labels (reference
    metric.MeanPairwiseDistance)."""

    def __init__(self, name: str = "mpd", p: float = 2.0, **kwargs):
        super().__init__(name, **kwargs)
        self.p = p

    def update(self, labels, preds):
        label, pred = _as_pair(labels, preds)
        label = label.reshape(pred.shape)
        d = (onp.abs(pred - label) ** self.p).sum(axis=-1) ** (1.0 / self.p)
        self.sum_metric += float(d.sum())
        self.num_inst += d.size


@register
class MeanCosineSimilarity(EvalMetric):
    """Mean cosine similarity along the last axis (reference
    metric.MeanCosineSimilarity)."""

    def __init__(self, name: str = "cos_sim", eps: float = 1e-8, **kwargs):
        super().__init__(name, **kwargs)
        self.eps = eps

    def update(self, labels, preds):
        label, pred = _as_pair(labels, preds)
        label = label.reshape(pred.shape)
        num = (pred * label).sum(axis=-1)
        den = onp.linalg.norm(pred, axis=-1) * onp.linalg.norm(label, axis=-1)
        sim = num / onp.maximum(den, self.eps)
        self.sum_metric += float(sim.sum())
        self.num_inst += sim.size


@register
class PCC(EvalMetric):
    """Multiclass Pearson correlation over a running confusion matrix
    (reference metric.PCC — the k-class generalization of MCC)."""

    def __init__(self, name: str = "pcc", **kwargs):
        self._k = 0
        self._c = onp.zeros((0, 0))
        super().__init__(name, **kwargs)

    def reset(self):
        super().reset()
        self._k = 0
        self._c = onp.zeros((0, 0))

    def _grow(self, k: int):
        if k > self._k:
            c = onp.zeros((k, k))
            c[:self._k, :self._k] = self._c
            self._c, self._k = c, k

    def update(self, labels, preds):
        label, pred = _as_pair(labels, preds)
        if pred.ndim > 1 and pred.shape[-1] > 1:
            pred = pred.argmax(axis=-1)
        label = label.astype(onp.int64).ravel()
        pred = pred.astype(onp.int64).ravel()
        self._grow(int(max(label.max(initial=0), pred.max(initial=0))) + 1)
        onp.add.at(self._c, (label, pred), 1)
        self.num_inst = 1

    def get(self):
        c = self._c
        n = c.sum()
        if n == 0:
            return self.name, float("nan")
        t = c.sum(axis=1)  # true counts
        p = c.sum(axis=0)  # predicted counts
        cov_tp = (onp.trace(c) * n - (t * p).sum())
        cov_tt = n * n - (t * t).sum()
        cov_pp = n * n - (p * p).sum()
        denom = onp.sqrt(cov_tt * cov_pp)
        return self.name, float(cov_tp / denom) if denom > 0 else 0.0


def np(numpy_feval, name: str = "custom", allow_extra_outputs: bool = False):
    """Wrap a ``feval(label, pred)`` numpy function as a metric (reference
    metric.np decorator)."""

    def feval(label, pred):
        return numpy_feval(label, pred)

    feval.__name__ = getattr(numpy_feval, "__name__", name)
    return CustomMetric(feval, name=feval.__name__,
                        allow_extra_outputs=allow_extra_outputs)
