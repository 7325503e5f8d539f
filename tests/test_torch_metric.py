"""Port parity of ``gluon.metric`` on the CPU: every metric class of the
JAX package's ``__all__``, updated twice with the same numpy labels and
predictions on both packages (the port's given as NDArrays, as CPU tensors
and as bf16 tensors), and ``get()`` / ``get_name_value()`` compared; the
registry's names and aliases, ``create`` from a name, a list, a callable
and an instance, ``np()``, and ``mx.metric`` / ``mx.gluon.metric``.

Tolerance: values within 1e-6 relative (both accumulate in numpy f64 from
the same f32 inputs); from bf16 predictions, the JAX package's values on
the same bf16-rounded inputs within 1e-6.
"""
import math

import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.gluon import metric as jm

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import metric as tm

TOL = 1e-6


@pytest.fixture(autouse=True)
def on_cpu():
    with mx.cpu():
        yield


def batches(kind, seed):
    """Two (labels, preds) batches of numpy arrays for a metric kind."""
    rng = onp.random.RandomState(seed)
    out = []
    for _ in range(2):
        if kind == "class":
            logits = rng.randn(12, 4).astype("float32")
            probs = onp.exp(logits) / onp.exp(logits).sum(-1, keepdims=True)
            out.append((rng.randint(0, 4, 12).astype("int32"), probs.astype("float32")))
        elif kind == "binary":
            out.append((rng.randint(0, 2, 16).astype("int32"),
                        rng.rand(16, 2).astype("float32")))
        elif kind == "binary_prob":
            out.append((rng.randint(0, 2, 16).astype("int32"), rng.rand(16).astype("float32")))
        elif kind == "seq":
            p = rng.rand(3, 5, 6).astype("float32")
            p /= p.sum(-1, keepdims=True)
            out.append((rng.randint(0, 6, (3, 5)).astype("int32"), p))
        else:                                   # regression
            out.append((rng.randn(8, 3).astype("float32"), rng.randn(8, 3).astype("float32")))
    return out


# (class name, constructor kwargs, batch kind)
CASES = [("Accuracy", {}, "class"), ("TopKAccuracy", {"top_k": 2}, "class"),
         ("F1", {}, "binary"), ("F1", {}, "binary_prob"), ("Fbeta", {"beta": 2.0}, "binary"),
         ("BinaryAccuracy", {"threshold": 0.4}, "binary_prob"), ("MCC", {}, "binary"),
         ("MCC", {}, "binary_prob"), ("PCC", {}, "class"), ("MAE", {}, "reg"),
         ("MSE", {}, "reg"), ("RMSE", {}, "reg"), ("MeanPairwiseDistance", {"p": 3.0}, "reg"),
         ("MeanCosineSimilarity", {}, "reg"), ("CrossEntropy", {}, "class"),
         ("Perplexity", {"ignore_label": 2}, "seq"), ("PearsonCorrelation", {}, "reg"),
         ("Loss", {}, "reg")]


def as_port(a, how):
    if how == "ndarray":
        return mx.np.array(a)
    t = torch.from_numpy(a)
    return t.bfloat16() if how == "bf16" and t.is_floating_point() else t


def bf16_round(a):
    if not onp.issubdtype(a.dtype, onp.floating):
        return a
    return torch.from_numpy(a).bfloat16().float().numpy()


def values_close(got, want):
    (gn, gv), (wn, wv) = got, want
    assert gn == wn
    gv, wv = onp.atleast_1d(gv), onp.atleast_1d(wv)
    for a, b in zip(gv, wv):
        if math.isnan(b):
            assert math.isnan(a)
        else:
            assert abs(a - b) <= TOL * max(1.0, abs(b)), (a, b)


@pytest.mark.parametrize("how", ["ndarray", "tensor", "bf16"])
@pytest.mark.parametrize("name,kw,kind", CASES, ids=[f"{c[0]}-{c[2]}" for c in CASES])
def test_metric_matches_jax(name, kw, kind, how):
    j, t = getattr(jm, name)(**kw), getattr(tm, name)(**kw)
    values_close(t.get(), j.get())           # empty: nan (or the counters' 0)
    for labels, preds in batches(kind, seed=len(name)):
        if how == "bf16":
            preds = bf16_round(preds)
            labels = bf16_round(labels)
        j.update([jmx.np.array(labels)], [jmx.np.array(preds)])
        t.update([as_port(labels, how)], [as_port(preds, how)])
    values_close(t.get(), j.get())
    for got, want in zip(t.get_name_value(), j.get_name_value()):
        values_close(got, want)
    t.reset()
    j.reset()
    values_close(t.get(), j.get())


def test_registry_and_aliases():
    """Every JAX registry name and alias creates the port's class of the
    same name; ``acc`` is ``Accuracy``; names are case-insensitive."""
    for name in jm._REGISTRY.list():
        assert type(tm.create(name)).__name__ == type(jm.create(name)).__name__
    assert isinstance(tm.create("ACC"), tm.Accuracy) and tm.acc is tm.Accuracy
    with pytest.raises(MXNetError):
        tm.create("no_such_metric")
    assert sorted(tm.__all__) == sorted(jm.__all__)


def test_create_composite_custom_and_np():
    labels, preds = batches("class", 0)[0]

    def feval(label, pred):
        return float((pred.argmax(-1) == label).mean())
    for spec in (["acc", "crossentropy"], feval):
        t, j = tm.create(spec), jm.create(spec)
        t.update([mx.np.array(labels)], [mx.np.array(preds)])
        j.update([jmx.np.array(labels)], [jmx.np.array(preds)])
        values_close(t.get(), j.get())
    acc = tm.Accuracy()
    assert tm.create(acc) is acc
    c = tm.CompositeEvalMetric(["acc", tm.F1()])
    c.add("mae")
    assert [m.name for m in c.metrics] == ["accuracy", "f1", "mae"]
    wrapped_t, wrapped_j = tm.np(feval), jm.np(feval)
    assert wrapped_t.name == wrapped_j.name == "feval"
    wrapped_t.update(labels, preds)
    wrapped_j.update(labels, preds)
    values_close(wrapped_t.get(), wrapped_j.get())
    assert str(wrapped_t) == str(wrapped_j)


def test_namespaces():
    assert mx.metric is tm and mx.gluon.metric is tm
