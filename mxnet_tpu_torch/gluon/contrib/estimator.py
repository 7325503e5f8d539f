"""Estimator: a train loop with event handlers (counterpart of
``mxnet_tpu/gluon/contrib/estimator.py``; the reference's
python/mxnet/gluon/contrib/estimator/estimator.py:42 Estimator.fit and
event_handler.py's mixins).

``fit`` is the reference's imperative loop (record, backward,
``trainer.step``) over the port's ``Trainer``, ``metric`` and ``loss``, so
every handler hook fires at the same points; batches come from any
iterable of ``(data, label)`` pairs, e.g. a ``DataLoader`` or its
``as_device_iterator``."""
from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence

from ...base import MXNetError, logger
from ...ndarray import NDArray
from .. import metric as metric_mod
from ..loss import Loss as GluonLoss
from ..trainer import Trainer

__all__ = [
    "Estimator", "EventHandler", "TrainBegin", "TrainEnd", "EpochBegin",
    "EpochEnd", "BatchBegin", "BatchEnd", "StoppingHandler", "MetricHandler",
    "ValidationHandler", "LoggingHandler", "CheckpointHandler",
    "EarlyStoppingHandler",
]


# ------------------------------------------------------------- handlers
class EventHandler:
    pass


class TrainBegin(EventHandler):
    def train_begin(self, estimator, *args, **kwargs):
        pass


class TrainEnd(EventHandler):
    def train_end(self, estimator, *args, **kwargs):
        pass


class EpochBegin(EventHandler):
    def epoch_begin(self, estimator, *args, **kwargs):
        pass


class EpochEnd(EventHandler):
    def epoch_end(self, estimator, *args, **kwargs):
        pass


class BatchBegin(EventHandler):
    def batch_begin(self, estimator, *args, **kwargs):
        pass


class BatchEnd(EventHandler):
    def batch_end(self, estimator, *args, **kwargs):
        pass


class StoppingHandler(TrainBegin, BatchEnd, EpochEnd):
    """Stop on max_epoch/max_batch (reference event_handler.py:82)."""

    def __init__(self, max_epoch: Optional[int] = None,
                 max_batch: Optional[int] = None):
        self.max_epoch = max_epoch
        self.max_batch = max_batch
        self.current_batch = 0
        self.current_epoch = 0

    def train_begin(self, estimator, *args, **kwargs):
        self.current_batch = 0
        self.current_epoch = 0

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.max_batch and self.current_batch >= self.max_batch:
            estimator.stop_training = True

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.max_epoch and self.current_epoch >= self.max_epoch:
            estimator.stop_training = True


class MetricHandler(EpochBegin, BatchEnd):
    """Reset train metrics per epoch; update per batch (reference
    event_handler.py:122)."""

    def __init__(self, metrics):
        self.metrics = metrics

    def epoch_begin(self, estimator, *args, **kwargs):
        for m in self.metrics:
            m.reset()

    def batch_end(self, estimator, pred=None, label=None, loss=None,
                  **kwargs):
        for m in self.metrics:
            if isinstance(m, metric_mod.Loss):
                m.update(0, loss)
            else:
                m.update(label, pred)


class ValidationHandler(TrainBegin, BatchEnd, EpochEnd):
    """Run validation every N epochs/batches (reference
    event_handler.py:160)."""

    def __init__(self, val_data, eval_fn: Callable, val_metrics=None,
                 epoch_period: Optional[int] = 1,
                 batch_period: Optional[int] = None):
        self.val_data = val_data
        self.eval_fn = eval_fn
        self.val_metrics = val_metrics or []
        self.epoch_period = epoch_period
        self.batch_period = batch_period
        self.current_batch = 0
        self.current_epoch = 0

    def train_begin(self, estimator, *args, **kwargs):
        self.current_batch = 0
        self.current_epoch = 0

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.batch_period and self.current_batch % self.batch_period == 0:
            self.eval_fn(val_data=self.val_data,
                         val_metrics=self.val_metrics)

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.epoch_period and self.current_epoch % self.epoch_period == 0:
            self.eval_fn(val_data=self.val_data,
                         val_metrics=self.val_metrics)


class LoggingHandler(TrainBegin, TrainEnd, EpochBegin, EpochEnd, BatchBegin,
                     BatchEnd):
    """Log progress (reference event_handler.py:226)."""

    def __init__(self, log_interval: Optional[int] = None, metrics=None):
        self.log_interval = log_interval
        self.metrics = metrics or []
        self.batch_index = 0
        self.current_epoch = 0

    def _fmt(self):
        return " ".join(f"{n}: {v:.4f}" for m in self.metrics
                        for n, v in m.get_name_value())

    def train_begin(self, estimator, *args, **kwargs):
        self._start = time.time()
        logger.info("Training begin")

    def train_end(self, estimator, *args, **kwargs):
        logger.info("Training done in %.1fs; %s",
                    time.time() - self._start, self._fmt())

    def epoch_begin(self, estimator, *args, **kwargs):
        self._epoch_start = time.time()
        self.batch_index = 0

    def epoch_end(self, estimator, *args, **kwargs):
        logger.info("[Epoch %d] %.1fs %s", self.current_epoch,
                    time.time() - self._epoch_start, self._fmt())
        self.current_epoch += 1

    def batch_end(self, estimator, *args, **kwargs):
        self.batch_index += 1
        if self.log_interval and self.batch_index % self.log_interval == 0:
            logger.info("[Epoch %d][Batch %d] %s", self.current_epoch,
                        self.batch_index, self._fmt())


class CheckpointHandler(TrainBegin, BatchEnd, EpochEnd):
    """Save params (+trainer states) periodically, optionally only on
    monitored-metric improvement (reference event_handler.py:336)."""

    def __init__(self, model_dir: str, model_prefix: str = "model",
                 monitor=None, mode: str = "min", epoch_period: int = 1,
                 max_checkpoints: Optional[int] = None,
                 save_best: bool = False, resume_from_checkpoint=False):
        import os
        self.model_dir = model_dir
        os.makedirs(model_dir, exist_ok=True)
        self.model_prefix = model_prefix
        self.monitor = monitor
        self.epoch_period = epoch_period
        self.save_best = save_best
        self.max_checkpoints = max_checkpoints
        self._saved: List[str] = []
        if mode not in ("min", "max"):
            raise MXNetError("mode must be 'min' or 'max'")
        self.mode = mode
        self.best = float("inf") if mode == "min" else -float("inf")
        self.current_epoch = 0
        self.resume_from_checkpoint = resume_from_checkpoint

    def train_begin(self, estimator, *args, **kwargs):
        if not self.resume_from_checkpoint:
            return
        import glob
        import os
        import re
        def epoch_of(p):
            m = re.search(r"epoch(\d+)", p)
            return int(m.group(1)) if m else -1

        cands = sorted(glob.glob(os.path.join(
            self.model_dir, f"{self.model_prefix}-epoch*.params")),
            key=epoch_of)  # numeric, not lexicographic
        if not cands:
            return
        latest = cands[-1]
        estimator.net.load_parameters(latest)
        m = re.search(r"epoch(\d+)", latest)
        if m:
            self.current_epoch = int(m.group(1))
        self._saved = cands[-self.max_checkpoints:] \
            if self.max_checkpoints else cands

    def _improved(self, value: float) -> bool:
        return value < self.best if self.mode == "min" else value > self.best

    def epoch_end(self, estimator, *args, **kwargs):
        import os
        self.current_epoch += 1
        if self.current_epoch % self.epoch_period:
            return
        path = os.path.join(
            self.model_dir,
            f"{self.model_prefix}-epoch{self.current_epoch:04d}.params")
        estimator.net.save_parameters(path)
        self._saved.append(path)
        if self.max_checkpoints and len(self._saved) > self.max_checkpoints:
            old = self._saved.pop(0)
            if os.path.exists(old):
                os.remove(old)
        if self.save_best and self.monitor is not None:
            _, value = self.monitor.get()
            if self._improved(value):
                self.best = value
                estimator.net.save_parameters(os.path.join(
                    self.model_dir, f"{self.model_prefix}-best.params"))


class EarlyStoppingHandler(TrainBegin, EpochEnd):
    """Stop when the monitored metric stops improving (reference
    event_handler.py EarlyStoppingHandler)."""

    def __init__(self, monitor, mode: str = "min", patience: int = 0,
                 min_delta: float = 0.0, baseline: Optional[float] = None):
        self.monitor = monitor
        if mode not in ("min", "max"):
            raise MXNetError("mode must be 'min' or 'max'")
        self.mode = mode
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.wait = 0
        self.best = None
        self.stopped_epoch = None
        self.current_epoch = 0

    def _improved(self, value: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "min":
            return value < self.best - self.min_delta
        return value > self.best + self.min_delta

    def train_begin(self, estimator, *args, **kwargs):
        self.wait = 0
        self.best = self.baseline
        self.current_epoch = 0

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        _, value = self.monitor.get()
        if self._improved(value):
            self.best = value
            self.wait = 0
        else:
            self.wait += 1
            if self.wait > self.patience:
                self.stopped_epoch = self.current_epoch
                estimator.stop_training = True


# ------------------------------------------------------------ estimator
class Estimator:
    """Train/validate a Gluon net with handler hooks (reference
    estimator.py:42). ``fit`` is the reference's imperative loop; handlers
    fire at train/epoch/batch boundaries."""

    def __init__(self, net, loss, train_metrics=None, trainer=None,
                 device=None, ctx=None, val_metrics=None, val_loss=None,
                 batch_axis: int = 0):
        if not isinstance(loss, GluonLoss):
            raise MXNetError("loss must be a gluon Loss")
        self.net = net
        self.loss = loss
        self.val_loss = val_loss or loss
        self.batch_axis = batch_axis
        self.train_metrics = [metric_mod.create(m)
                              for m in (train_metrics or [])]
        if not any(isinstance(m, metric_mod.Loss) for m in self.train_metrics):
            self.train_metrics.append(metric_mod.Loss("train_loss"))
        if val_metrics is not None:
            self.val_metrics = [metric_mod.create(m) for m in val_metrics]
        else:
            # independent mirrors of the train metrics, configuration and
            # all (deepcopy keeps e.g. TopKAccuracy's top_k)
            import copy
            self.val_metrics = []
            for m in self.train_metrics:
                if isinstance(m, metric_mod.Loss):
                    continue
                m2 = copy.deepcopy(m)
                m2.name = f"val_{m2.name}"
                m2.reset()
                self.val_metrics.append(m2)
            self.val_metrics.append(metric_mod.Loss("val_loss"))
        self.trainer = trainer or Trainer(
            net.collect_params(), "sgd", {"learning_rate": 0.01})
        self.stop_training = False

    # ----------------------------------------------------------- internals
    def _split_batch(self, batch):
        if isinstance(batch, (list, tuple)) and len(batch) >= 2:
            return batch[0], batch[1]
        raise MXNetError("batches must be (data, label) pairs")

    def evaluate(self, val_data, val_metrics=None,
                 batch_axis: Optional[int] = None):
        """One pass over val_data updating ``val_metrics`` (reference
        estimator.py evaluate). ``batch_axis`` accepted for API parity;
        metrics are batch-axis agnostic here."""
        metrics = val_metrics if val_metrics is not None else self.val_metrics
        for m in metrics:
            m.reset()
        for batch in val_data:
            data, label = self._split_batch(batch)
            pred = self.net(data)
            loss = self.val_loss(pred, label)
            for m in metrics:
                if isinstance(m, metric_mod.Loss):
                    m.update(0, loss)
                else:
                    m.update(label, pred)
        return metrics

    def _default_handlers(self, val_data, epochs, batches):
        handlers: List[EventHandler] = [
            StoppingHandler(max_epoch=epochs, max_batch=batches),
            MetricHandler(self.train_metrics),
        ]
        if val_data is not None:
            handlers.append(ValidationHandler(
                val_data, eval_fn=self.evaluate,
                val_metrics=self.val_metrics))
        handlers.append(LoggingHandler(metrics=self.train_metrics
                                       + self.val_metrics))
        return handlers

    def fit(self, train_data, val_data=None, epochs: Optional[int] = None,
            event_handlers: Optional[Sequence[EventHandler]] = None,
            batches: Optional[int] = None,
            batch_axis: Optional[int] = None):
        """Reference estimator.py:333 fit."""
        if batch_axis is not None:
            self.batch_axis = batch_axis
        from ... import autograd
        if epochs is None and batches is None:
            raise MXNetError("provide epochs or batches")
        handlers = list(event_handlers or [])
        for h in self._default_handlers(val_data, epochs, batches):
            # user handlers (including subclasses) replace same-role
            # defaults — no double logging / double validation
            if any(isinstance(u, type(h)) for u in handlers):
                continue
            handlers.append(h)

        def fire(event, *args, **kwargs):
            for h in handlers:
                fn = getattr(h, event, None)
                if fn is not None and isinstance(h, _EVENT_BASE[event]):
                    fn(self, *args, **kwargs)

        self.stop_training = False
        fire("train_begin")
        while not self.stop_training:
            fire("epoch_begin")
            for batch in train_data:
                if self.stop_training:
                    break
                fire("batch_begin")
                data, label = self._split_batch(batch)
                with autograd.record():
                    pred = self.net(data)
                    loss = self.loss(pred, label)
                loss.backward()
                bs = data.shape[self.batch_axis]
                self.trainer.step(bs)
                fire("batch_end", pred=pred, label=label, loss=loss)
            fire("epoch_end")
        fire("train_end")
        return self


_EVENT_BASE = {
    "train_begin": TrainBegin, "train_end": TrainEnd,
    "epoch_begin": EpochBegin, "epoch_end": EpochEnd,
    "batch_begin": BatchBegin, "batch_end": BatchEnd,
}
