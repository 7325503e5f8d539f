"""Port parity of ``mxnet_tpu_torch.gluon.contrib.estimator`` on the CPU:
``Estimator.fit`` over a ``DataLoader`` from the JAX package's initial
weights (``interop.params_from_numpy``) gives the JAX package's per-batch
losses, train metrics and ``evaluate`` results; the stopping, metric,
validation, logging, checkpoint and early-stopping handlers fire as in
the JAX package (the same epochs stopped, the same checkpoint files, a
resume from the JAX package's own checkpoint).

Tolerance: losses, metrics and parameters within 1e-5 relative (XLA's and
torch's f32 matmuls sum in other orders); epochs, batch counts and file
names exact."""
import logging
import os

import numpy as onp
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.gluon import Trainer as JTrainer
from mxnet_tpu.gluon import data as jdata
from mxnet_tpu.gluon import metric as jmetric
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.contrib import estimator as jest
from mxnet_tpu.gluon.loss import SoftmaxCrossEntropyLoss as JSCE

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import Trainer
from mxnet_tpu_torch.gluon import data as tdata
from mxnet_tpu_torch.gluon import metric as tmetric
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.contrib import estimator as test_
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.interop import params_from_numpy

TOL = 1e-5

JAX = dict(mx=jmx, nn=jnn, data=jdata, metric=jmetric, est=jest, Trainer=JTrainer, loss=JSCE)
PORT = dict(mx=mx, nn=nn, data=tdata, metric=tmetric, est=test_, Trainer=Trainer,
            loss=SoftmaxCrossEntropyLoss)


@pytest.fixture(autouse=True)
def on_cpu():
    with mx.cpu():
        yield


def _data(n=48, seed=0):
    rng = onp.random.RandomState(seed)
    X = rng.rand(n, 10).astype("float32")
    Y = (X @ rng.randn(10, 3).astype("float32")).argmax(1).astype("int32")
    return X, Y


def _nets():
    jmx.random.seed(4)
    jnet = jnn.HybridSequential()
    jnet.add(jnn.Dense(16, in_units=10, activation="relu"), jnn.Dense(3, in_units=16))
    jnet.initialize(jmx.init.Xavier())
    tnet = nn.HybridSequential()
    tnet.add(nn.Dense(16, in_units=10, activation="relu"), nn.Dense(3, in_units=16))
    tnet.initialize()
    params_from_numpy(tnet, {k: p.data().asnumpy() for k, p in jnet.collect_params().items()})
    return jnet, tnet


class _Record:
    """A batch-end handler of either package that keeps every loss."""

    @staticmethod
    def make(est_mod):
        class Rec(est_mod.BatchEnd, est_mod.EpochEnd):
            def __init__(self):
                self.losses, self.epochs = [], 0

            def batch_end(self, estimator, *args, loss=None, **kw):
                self.losses.append(loss.asnumpy().copy())

            def epoch_end(self, estimator, *args, **kw):
                self.epochs += 1
        return Rec()


def _fit(side, net, epochs=3, handlers=(), opt="adam", val=True, **fit_kw):
    X, Y = _data()
    loader = side["data"].DataLoader(side["data"].ArrayDataset(X, Y), batch_size=16)
    vX, vY = _data(24, seed=1)
    vloader = side["data"].DataLoader(side["data"].ArrayDataset(vX, vY), batch_size=8)
    est = side["est"].Estimator(net, side["loss"](), train_metrics=[side["metric"].Accuracy()],
                                trainer=side["Trainer"](net.collect_params(), opt,
                                                        {"learning_rate": 0.05}))
    rec = _Record.make(side["est"])
    est.fit(loader, val_data=vloader if val else None, epochs=epochs,
            event_handlers=[rec, *handlers], **fit_kw)
    return est, rec, vloader


def _close(a, b):
    a, b = onp.asarray(a, onp.float64), onp.asarray(b, onp.float64)
    assert a.shape == b.shape
    assert onp.abs(a - b).max() <= TOL * max(1.0, onp.abs(b).max())


def test_fit_matches_jax():
    jnet, tnet = _nets()
    jest_, jrec, jval = _fit(JAX, jnet)
    test_e, trec, tval = _fit(PORT, tnet)
    assert len(trec.losses) == len(jrec.losses) == 9 and trec.epochs == jrec.epochs == 3
    for t, j in zip(trec.losses, jrec.losses):
        _close(t, j)
    for tm, jm in zip(test_e.train_metrics + test_e.val_metrics,
                      jest_.train_metrics + jest_.val_metrics):
        (tn, tv), (jn, jv) = tm.get(), jm.get()
        assert tn == jn
        _close(tv, jv)
    for (k, tp), (_, jp) in zip(sorted(tnet.collect_params().items()),
                                sorted(jnet.collect_params().items())):
        _close(tp.data().asnumpy(), jp.data().asnumpy())
    tres = [m.get() for m in test_e.evaluate(tval)]
    jres = [m.get() for m in jest_.evaluate(jval)]
    for (tn, tv), (jn, jv) in zip(tres, jres):
        assert tn == jn
        _close(tv, jv)


def test_stopping_and_early_stopping_match_jax():
    out = []
    for side, net in zip((JAX, PORT), _nets()):
        acc = side["metric"].Loss("train_loss")
        early = side["est"].EarlyStoppingHandler(monitor=acc, mode="max", patience=1)
        est, rec, _ = _fit(side, net, epochs=10, handlers=[early, side["est"].MetricHandler([acc])],
                           val=False)
        stop = side["est"].StoppingHandler(max_batch=5)
        _, rec2, _ = _fit(side, _nets()[0 if side is JAX else 1], epochs=None, batches=5,
                          handlers=[stop], val=False)
        out.append((early.stopped_epoch, rec.epochs, len(rec.losses), len(rec2.losses),
                    stop.current_batch))
    assert out[0] == out[1], out
    assert out[1][0] is not None and out[1][0] < 10


def test_checkpoint_handler_matches_jax_and_resumes_its_files(tmp_path, caplog):
    names = []
    for tag, side, net in zip(("jax", "port"), (JAX, PORT), _nets()):
        d = str(tmp_path / tag)
        loss = side["metric"].Loss("train_loss")
        ck = side["est"].CheckpointHandler(d, model_prefix="m", monitor=loss, mode="min",
                                           max_checkpoints=2, save_best=True)
        log = side["est"].LoggingHandler(log_interval=1, metrics=[loss])
        with caplog.at_level(logging.INFO):
            _fit(side, net, epochs=4, handlers=[ck, log, side["est"].MetricHandler([loss])])
        names.append(sorted(os.listdir(d)))
    assert names[0] == names[1] == ["m-best.params", "m-epoch0003.params", "m-epoch0004.params"]
    # the port resumes from the JAX package's newest checkpoint
    _, tnet = _nets()
    ck = test_.CheckpointHandler(str(tmp_path / "jax"), model_prefix="m",
                                 resume_from_checkpoint=True)
    est = test_.Estimator(tnet, SoftmaxCrossEntropyLoss(),
                          trainer=Trainer(tnet.collect_params(), "sgd", {"learning_rate": 0.0}))
    ck.train_begin(est)
    assert ck.current_epoch == 4
    jnet, _ = _nets()
    jnet.load_parameters(str(tmp_path / "jax" / "m-epoch0004.params"))
    for (_, tp), (_, jp) in zip(sorted(tnet.collect_params().items()),
                                sorted(jnet.collect_params().items())):
        assert onp.array_equal(tp.data().asnumpy(), jp.data().asnumpy())


def test_estimator_argument_checks():
    _, tnet = _nets()
    with pytest.raises(MXNetError, match="gluon Loss"):
        test_.Estimator(tnet, lambda p, y: p)
    est = test_.Estimator(tnet, SoftmaxCrossEntropyLoss())
    with pytest.raises(MXNetError, match="epochs or batches"):
        est.fit([])
    with pytest.raises(MXNetError, match="pairs"):
        est.fit([onp.zeros((2, 10), onp.float32)], epochs=1)
    with pytest.raises(MXNetError, match="mode"):
        test_.EarlyStoppingHandler(tmetric.Loss(), mode="up")
