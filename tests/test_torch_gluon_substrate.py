"""Port parity of the Gluon substrate: the non-convolution cases of
``tests/test_gluon.py``, the 19 basic layers, the 13 losses, the
initializers after ``mx.random.seed``, hybridized blocks (their dropout
masks against the JAX ``CachedOp``'s, their cache and counters), parameter
and trainer-state files read across packages, and the README's first
program, all on the same numpy inputs through ``mxnet_tpu`` (JAX on the
CPU) and ``mxnet_tpu_torch`` under ``with mx.cpu():``.

Tolerances: uniform-based initializers and dropout masks are bit for bit;
normal-based initializers within 4 f32 ulp at max(|x|, sigma); layer and
loss outputs and gradients within 1e-5 relative and 1e-6 absolute, layer
gradients 1e-5 absolute (torch's and XLA's matmul, transcendental and
reduction orders differ in the last place, and a saturated tanh in GeLU's
gradient magnifies that); the README MLP's five Adam losses within 1e-5
relative.
"""
import logging
import os
import re

import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import np as jnp_
from mxnet_tpu.gluon import Trainer as JTrainer
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.gluon import nn as jnn

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, metrics, np, npx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import Trainer, nn
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.interop import params_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def on_cpu():
    with mx.cpu():
        yield


def close(t, j, rtol=RTOL, atol=ATOL):
    ta, ja = (a.asnumpy() if hasattr(a, "asnumpy") else onp.asarray(a) for a in (t, j))
    assert ta.dtype == ja.dtype, (ta.dtype, ja.dtype)
    assert ta.shape == ja.shape, (ta.shape, ja.shape)
    onp.testing.assert_allclose(ta, ja, rtol=rtol, atol=atol)


def params_np(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def mlp(nnm, hidden=16, out=4, **kw):
    net = nnm.HybridSequential()
    net.add(nnm.Dense(hidden, activation="relu", **kw), nnm.Dense(out))
    return net


# ------------------------------------------------------- tests/test_gluon.py

def test_dense_deferred_init_and_forward():
    outs = []
    for mxm, m, nnm in ((mx, np, nn), (jmx, jnp_, jnn)):
        mxm.random.seed(1)
        net = nnm.Dense(4)
        net.initialize()
        y = net(m.ones((2, 3)))
        assert net.weight.shape == (4, 3) and set(net.collect_params()) == {"weight", "bias"}
        outs.append(y)
    close(*outs, rtol=0, atol=0)


def test_uninitialized_error_message():
    net = nn.Dense(4, in_units=3)
    with pytest.raises(MXNetError, match="initialize"):
        net(np.ones((2, 3)))


def test_sequential_param_paths():
    net = nn.HybridSequential()
    net.add(nn.Dense(5))
    net.add(nn.Dense(3))
    net.initialize()
    net(np.ones((1, 4)))
    assert list(net.collect_params()) == ["0.weight", "0.bias", "1.weight", "1.bias"]
    assert list(net.collect_params(".*bias")) == ["0.bias", "1.bias"]


def _bn_input(seed, shape):
    return onp.random.RandomState(seed).normal(5.0, 2.0, size=shape).astype("float32")


def test_batchnorm_running_stats_update():
    x = _bn_input(0, (2, 4, 3))
    stats = []
    for m, ag, nnm in ((np, autograd, nn), (jnp_, jag, jnn)):
        bn = nnm.BatchNorm()
        bn.initialize()
        with ag.record():
            y = bn(m.array(x))
        rm = bn.running_mean.data().asnumpy().copy()
        bn(m.array(x))      # predict mode: no update
        assert onp.array_equal(bn.running_mean.data().asnumpy(), rm)
        stats.append([y, bn.running_mean.data(), bn.running_var.data()])
    for t, j in zip(*stats):
        close(t, j)


def test_batchnorm_nhwc_training_parity():
    x = _bn_input(1, (4, 3, 5, 5))
    for m, ag, nnm in ((np, autograd, nn), (jnp_, jag, jnn)):
        bn_c, bn_l = nnm.BatchNorm(axis=1), nnm.BatchNorm(axis=-1)
        bn_c.initialize()
        bn_l.initialize()
        with ag.record():
            y_c = bn_c(m.array(x))
            y_l = bn_l(m.array(x.transpose(0, 2, 3, 1)))
        onp.testing.assert_allclose(y_l.asnumpy().transpose(0, 3, 1, 2), y_c.asnumpy(),
                                    rtol=1e-4, atol=1e-4)
        onp.testing.assert_allclose(bn_l.running_var.data().asnumpy(),
                                    bn_c.running_var.data().asnumpy(), rtol=1e-4)


def test_hybridize_matches_eager():
    """Hybridized equals eager bit for bit in the port (the same ops), and
    the JAX package's within tolerance; the second call hits the cache."""
    x = onp.random.RandomState(2).rand(4, 10).astype("float32")
    outs = []
    for mxm, m, nnm in ((mx, np, nn), (jmx, jnp_, jnn)):
        mxm.random.seed(2)
        net = mlp(nnm)
        net.initialize()
        y_eager = net(m.array(x))
        net.hybridize()
        y_hyb = net(m.array(x))
        y2 = net(m.array(x))
        outs.append((y_eager, y_hyb, y2))
    (te, th, t2), (je, jh, _) = outs
    assert onp.array_equal(te.asnumpy(), th.asnumpy())
    assert onp.array_equal(th.asnumpy(), t2.asnumpy())
    close(th, jh)


def test_hybridize_batchnorm_aux_state():
    x = _bn_input(3, (8, 6))
    outs = []
    for m, ag, nnm in ((np, autograd, nn), (jnp_, jag, jnn)):
        net = nnm.HybridSequential()
        net.add(nnm.Dense(5, in_units=6, weight_initializer="ones"), nnm.BatchNorm())
        net.initialize()
        net.hybridize()
        with ag.record():
            net(m.array(x))
        outs.append(net[1].running_mean.data())
    assert (outs[0].asnumpy() != 0).any()
    close(*outs)


def test_save_load_parameters(tmp_path):
    """``.params`` files: byte-identical for the same weights, and each
    package loads the other's."""
    x = onp.random.RandomState(4).rand(4, 10).astype("float32")
    mx.random.seed(4)
    tnet = mlp(nn)
    tnet.initialize()
    y1 = tnet(np.array(x))
    jnet = mlp(jnn)
    jnet.initialize()
    jnet(jnp_.array(x))
    jnet.load_dict({k: jnp_.array(v) for k, v in params_np(tnet).items()})
    tnet.save_parameters(str(tmp_path / "t.params"))
    jnet.save_parameters(str(tmp_path / "j.params"))
    assert (tmp_path / "t.params").read_bytes() == (tmp_path / "j.params").read_bytes()
    net2 = mlp(nn)
    net2.load_parameters(str(tmp_path / "j.params"))
    assert onp.array_equal(net2(np.array(x)).asnumpy(), y1.asnumpy())
    jnet2 = mlp(jnn)
    jnet2.load_parameters(str(tmp_path / "t.params"))
    close(jnet2(jnp_.array(x)), y1.asnumpy())


def test_trainer_sgd_regression():
    rng = onp.random.RandomState(5)
    X = rng.normal(size=(64, 2)).astype("float32")
    Y = (X @ onp.array([[2.0], [-3.0]], "float32") + 1.5).astype("float32")
    ws = []
    for mxm, m, ag, nnm, Tr, L2 in ((mx, np, autograd, nn, Trainer, tloss.L2Loss),
                                    (jmx, jnp_, jag, jnn, JTrainer, jloss.L2Loss)):
        mxm.random.seed(5)
        net = nnm.Dense(1)
        net.initialize(mxm.init.Normal(0.01))
        tr = Tr(net.collect_params(), "sgd", {"learning_rate": 0.5})
        for _ in range(15):
            with ag.record():
                loss = L2()(net(m.array(X)), m.array(Y))
            loss.backward()
            tr.step(64)
        ws.append(params_np(net))
    for k in ws[0]:
        onp.testing.assert_allclose(ws[0][k], ws[1][k], rtol=1e-4, atol=1e-5)
    onp.testing.assert_allclose(ws[0]["weight"].ravel(), [2.0, -3.0], atol=0.1)


def test_trainer_save_load_states(tmp_path):
    """``.states`` files of either package resume in the other."""
    x = onp.ones((4, 3), "float32")
    nets = {}
    for key, mxm, m, ag, nnm, Tr in (("t", mx, np, autograd, nn, Trainer),
                                     ("j", jmx, jnp_, jag, jnn, JTrainer)):
        mxm.random.seed(6)
        net = nnm.Dense(2, in_units=3)
        net.initialize()
        tr = Tr(net.collect_params(), "adam", {"learning_rate": 0.01})
        with ag.record():
            loss = (net(m.array(x)) ** 2).sum()
        loss.backward()
        tr.step(4)
        tr.save_states(str(tmp_path / f"{key}.states"))
        nets[key] = (net, Tr)
    tr2 = Trainer(nets["t"][0].collect_params(), "adam", {"learning_rate": 0.01})
    tr2.load_states(str(tmp_path / "j.states"))
    assert tr2._step_count == 1
    jtr2 = JTrainer(nets["j"][0].collect_params(), "adam", {"learning_rate": 0.01})
    jtr2.load_states(str(tmp_path / "t.states"))
    assert jtr2._step_count == 1
    for a, b in zip(tr2._states[0], jtr2._states[0]):
        close(a.numpy(), onp.asarray(b))


def test_stale_gradient_rule():
    net = nn.Dense(2, in_units=3)
    net.initialize()
    tr = Trainer(net.collect_params(), "sgd")
    with autograd.record():
        loss = net(np.ones((1, 3))).sum()
    loss.backward()
    tr.step(1)
    with pytest.raises(MXNetError, match="has not been updated"):
        tr.step(1)
    tr.step(1, ignore_stale_grad=True)


def test_fused_softmax_ce_matches_unfused():
    rng = onp.random.RandomState(7)
    logits = rng.randn(4, 5, 11).astype("float32") * 3
    labels = rng.randint(0, 11, (4, 5)).astype("int32")
    a = np.array(logits)
    a.attach_grad()
    with autograd.record():
        lf = tloss.SoftmaxCrossEntropyLoss()(a, np.array(labels)).mean()
    lf.backward()
    b = np.array(logits)
    b.attach_grad()
    with autograd.record():
        ls = npx.log_softmax(b, axis=-1)
        lr = (-npx.pick(ls, np.array(labels), axis=-1, keepdims=False)).mean(axis=1).mean()
    lr.backward()
    close(lf, lr)
    close(a.grad, b.grad, rtol=1e-4)


# ------------------------------------------------------------- the 19 layers

LAYERS = {
    "Dense": (lambda n: n.Dense(5, activation="tanh"), (3, 4), False),
    "Dropout": (lambda n: n.Dropout(0.5), (3, 4), True),
    "Embedding": (lambda n: n.Embedding(10, 4), (3, 4), False),
    "Flatten": (lambda n: n.Flatten(), (2, 4, 3), False),
    "BatchNorm": (lambda n: n.BatchNorm(), (2, 4, 3), True),
    "LayerNorm": (lambda n: n.LayerNorm(), (3, 4), False),
    "GroupNorm": (lambda n: n.GroupNorm(num_groups=2), (2, 4, 3), False),
    "InstanceNorm": (lambda n: n.InstanceNorm(), (2, 4, 3), False),
    "RMSNorm": (lambda n: n.RMSNorm(), (3, 4), False),
    "Identity": (lambda n: n.Identity(), (3, 4), False),
    "Lambda": (lambda n: n.Lambda(lambda x: x * 2 + 1), (3, 4), False),
    "HybridLambda": (lambda n: n.HybridLambda(lambda x: x * x), (3, 4), False),
    "Activation": (lambda n: n.Activation("softrelu"), (3, 4), False),
    "LeakyReLU": (lambda n: n.LeakyReLU(0.2), (3, 4), False),
    "PReLU": (lambda n: n.PReLU(in_channels=4), (3, 4), False),
    "ELU": (lambda n: n.ELU(), (3, 4), False),
    "SELU": (lambda n: n.SELU(), (3, 4), False),
    "GELU": (lambda n: n.GELU(), (3, 4), False),
    "SiLU": (lambda n: n.Swish(), (3, 4), False),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_jax(name):
    """Forward and input gradient (float inputs) of each layer after the
    same seed; in training mode inside ``record()`` where marked."""
    make, shape, train = LAYERS[name]
    rng = onp.random.RandomState(8)
    x = rng.randint(0, 10, shape).astype("int32") if name == "Embedding" else \
        (rng.randn(*shape) * 2).astype("float32")
    res = []
    for mxm, m, ag, nnm in ((mx, np, autograd, nn), (jmx, jnp_, jag, jnn)):
        mxm.random.seed(9)
        layer = make(nnm)
        layer.initialize()
        xa = m.array(x)
        if name != "Embedding":
            xa.attach_grad()
        with ag.record(train_mode=train):
            y = layer(xa)
            r = onp.random.RandomState(9).randn(*y.shape).astype("float32")
            s = (y * m.array(r)).sum()
        s.backward()
        res.append([y] + ([xa.grad] if name != "Embedding" else []) +
                   [p.grad() for p in layer.collect_params().values() if p.grad_req != "null"])
    for i, (t, j) in enumerate(zip(*res)):
        close(t, j, atol=ATOL if i == 0 else 1e-5)


# ------------------------------------------------------------- the 13 losses

def _loss_inputs(rng):
    p = rng.randn(4, 6).astype("float32")
    return {
        "pred": p, "label": rng.randn(4, 6).astype("float32"),
        "sparse": rng.randint(0, 6, (4,)).astype("int32"),
        "prob": rng.rand(4, 6).astype("float32") * 0.8 + 0.1,
        "binary": (rng.rand(4, 6) > 0.5).astype("float32"),
        "signed": onp.where(rng.rand(4, 6) > 0.5, 1.0, -1.0).astype("float32"),
        "pos": rng.randn(4, 6).astype("float32"), "neg": rng.randn(4, 6).astype("float32"),
        "cos_label": onp.array([1, -1, 1, -1], "float32"),
        "counts": rng.poisson(2.0, (4, 6)).astype("float32"),
        "ctc_pred": rng.randn(2, 4, 5).astype("float32"),
        "ctc_label": onp.array([[1, 2], [3, -1]], "float32"),
    }


LOSSES = {
    "L2Loss": (lambda L: L.L2Loss(), ("pred", "label")),
    "L1Loss": (lambda L: L.L1Loss(), ("pred", "label")),
    "SoftmaxCrossEntropyLoss": (lambda L: L.SoftmaxCrossEntropyLoss(), ("pred", "sparse")),
    "SoftmaxCELoss_dense": (lambda L: L.SoftmaxCELoss(sparse_label=False), ("pred", "prob")),
    "SigmoidBinaryCrossEntropyLoss": (lambda L: L.SigmoidBinaryCrossEntropyLoss(),
                                      ("pred", "binary")),
    "KLDivLoss": (lambda L: L.KLDivLoss(from_logits=False), ("pred", "prob")),
    "HuberLoss": (lambda L: L.HuberLoss(rho=0.5), ("pred", "label")),
    "HingeLoss": (lambda L: L.HingeLoss(), ("pred", "signed")),
    "SquaredHingeLoss": (lambda L: L.SquaredHingeLoss(), ("pred", "signed")),
    "LogisticLoss": (lambda L: L.LogisticLoss(), ("pred", "signed")),
    "TripletLoss": (lambda L: L.TripletLoss(), ("pred", "pos", "neg")),
    "CosineEmbeddingLoss": (lambda L: L.CosineEmbeddingLoss(margin=0.1),
                            ("pred", "pos", "cos_label")),
    "PoissonNLLLoss": (lambda L: L.PoissonNLLLoss(compute_full=True), ("pred", "counts")),
    "CTCLoss": (lambda L: L.CTCLoss(), ("ctc_pred", "ctc_label")),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_matches_jax(name):
    make, keys = LOSSES[name]
    inputs = _loss_inputs(onp.random.RandomState(10))
    res = []
    for m, ag, L in ((np, autograd, tloss), (jnp_, jag, jloss)):
        args = [m.array(inputs[k]) for k in keys]
        args[0].attach_grad()
        with ag.record():
            out = make(L)(*args)
            total = out.sum()
        total.backward()
        res.append([out, args[0].grad])
    for t, j in zip(*res):
        close(t, j)


def test_losses_take_tensors():
    """A loss called on torch tensors is plain PyTorch (``TrainStep``'s
    form): the same values as on NDArrays."""
    inputs = _loss_inputs(onp.random.RandomState(11))
    for name, (make, keys) in LOSSES.items():
        nd = make(tloss)(*[np.array(inputs[k]) for k in keys])
        t = make(tloss)(*[torch.from_numpy(inputs[k]) for k in keys])
        assert isinstance(t, torch.Tensor), name
        onp.testing.assert_array_equal(t.detach().numpy(), nd.asnumpy())


# ------------------------------------------------------------- initializers

INITS = {
    "Uniform": lambda i: i.Uniform(0.3), "Xavier": lambda i: i.Xavier(),
    "Xavier_in": lambda i: i.Xavier(factor_type="in", magnitude=2),
    "StackedXavier": lambda i: i.StackedXavier(), "Zero": lambda i: i.Zero(),
    "One": lambda i: i.One(), "Constant": lambda i: i.Constant(0.7),
    "Bilinear": lambda i: i.Bilinear(), "LSTMBias": lambda i: i.LSTMBias(),
    "Normal": lambda i: i.Normal(0.5), "Xavier_gaussian": lambda i: i.Xavier("gaussian"),
    "MSRAPrelu": lambda i: i.MSRAPrelu(),
}
BITWISE_INITS = {"Uniform", "Xavier", "Xavier_in", "StackedXavier", "Zero", "One", "Constant",
                 "Bilinear", "LSTMBias"}


@pytest.mark.parametrize("name", sorted(INITS))
def test_initializer_matches_jax(name):
    shape = (2, 2, 3, 3) if name in ("Bilinear", "StackedXavier") else (2, 2, 9)
    vals = []
    for mxm in (mx, jmx):
        mxm.random.seed(12)
        p = (mxm.gluon.Parameter("weight", shape=shape))
        p.initialize(init=INITS[name](mxm.init))
        vals.append(p.data().asnumpy())
    t, j = vals
    assert t.dtype == j.dtype
    if name in BITWISE_INITS:
        assert onp.array_equal(t, j)
    else:
        assert (onp.abs(t - j) <= 4 * onp.spacing(onp.maximum(onp.abs(j), 0.5))).all()


def test_orthogonal_is_orthogonal():
    """The same draws through an SVD (whose signs are the library's)."""
    vals = []
    for mxm in (mx, jmx):
        mxm.random.seed(14)
        p = mxm.gluon.Parameter("weight", shape=(4, 6))
        p.initialize(init=mxm.init.Orthogonal(scale=1.0))
        vals.append(p.data().asnumpy())
    t, j = vals
    onp.testing.assert_allclose(t @ t.T, onp.eye(4), atol=1e-5)
    onp.testing.assert_allclose(onp.abs(t), onp.abs(j), atol=1e-5)


def test_initializer_registry():
    assert isinstance(mx.init.create("xavier"), mx.init.Xavier)
    assert mx.init.Xavier(magnitude=2).dumps() == jmx.init.Xavier(magnitude=2).dumps()
    with pytest.raises(MXNetError, match="unknown entry"):
        mx.init.create("nope")


# -------------------------------------------------------- hybridized blocks

def test_hybridized_dropout_masks_match_jax_cachedop():
    """The per-call seed keys the block's dropout as the JAX CachedOp's
    does: the same masks on two calls, and the same key stream after."""
    x = onp.random.RandomState(15).rand(6, 5).astype("float32") + 0.5
    res = []
    for mxm, m, ag, nnm in ((mx, np, autograd, nn), (jmx, jnp_, jag, jnn)):
        mxm.random.seed(16)
        net = nnm.HybridSequential()
        net.add(nnm.Dense(12, in_units=5, weight_initializer="ones"), nnm.Dropout(0.5),
                nnm.Dropout(0.3))
        net.initialize()
        net.hybridize()
        outs = []
        for _ in range(2):
            with ag.record():
                outs.append(net(m.array(x)))
        outs.append(m.random.uniform(size=(4,)))
        res.append(outs)
    for t, j in zip(*res):
        assert onp.array_equal(t.asnumpy() == 0, j.asnumpy() == 0)
        close(t, j)


def test_cachedop_counters_and_warning(caplog):
    """One entry per (shapes, dtypes, training); a warning for every new
    signature after the first; recompilations and cache hits counted as
    the JAX package counts them."""
    was = metrics.enabled()
    metrics.enable()
    try:
        h0 = metrics.get_sample_value("mxnet_cachedop_cache_hits_total",
                                      {"block": "HybridSequential"}) or 0
        net = mlp(nn)
        net.initialize()
        net.hybridize()
        with caplog.at_level(logging.WARNING, logger="mxnet_tpu_torch"):
            net(np.ones((2, 3)))
            net(np.ones((2, 3)))
            net(np.ones((5, 3)))
            with autograd.record():
                net(np.ones((2, 3)))
        assert net._cached_op.cache_size == 3
        assert sum("recompilation" in r.message for r in caplog.records) == 2
        hits = metrics.get_sample_value("mxnet_cachedop_cache_hits_total",
                                        {"block": "HybridSequential"})
        assert hits - h0 == 1
    finally:
        (metrics.enable if was else metrics.disable)()


def test_block_on_tensors_is_pytorch():
    """A block called on torch tensors computes the NDArray call's values
    and PyTorch's backward fills its parameters' ``.grad``."""
    net = mlp(nn)
    net.initialize()
    x = onp.random.RandomState(17).rand(3, 5).astype("float32")
    nd = net(np.array(x))
    t = net(torch.from_numpy(x))
    assert isinstance(t, torch.Tensor)
    onp.testing.assert_array_equal(t.detach().numpy(), nd.asnumpy())
    t.sum().backward()
    assert all(p.grad is not None for p in net.parameters())


def test_block_api():
    net = mlp(nn, in_units=3)
    net.initialize()
    calls = []
    net.register_forward_pre_hook(lambda b, a: calls.append("pre"))
    net.register_forward_hook(lambda b, a, o: calls.append("post"))
    net(np.ones((1, 3)))
    assert calls == ["pre", "post"]
    other = mlp(nn, in_units=3)
    other.initialize()
    other.share_parameters({"0.weight": net.collect_params()["0.weight"]})
    assert other.collect_params()["0.weight"] is net.collect_params()["0.weight"]
    seen = []
    net.apply(lambda b: seen.append(type(b).__name__))
    assert seen == ["Dense", "Dense", "HybridSequential"]
    assert net.summary(np.ones((1, 3))) == 3 * 16 + 16 + 16 * 4 + 4
    deferred = mlp(nn)
    deferred.initialize()
    deferred.infer_shape(np.ones((2, 7)))
    assert deferred[0].weight.shape == (16, 7)
    net.cast("float64")
    assert net(np.ones((1, 3), dtype="float64")).dtype == onp.float64


def test_params_from_numpy_into_a_block():
    jmx.random.seed(18)
    jnet = mlp(jnn, in_units=10)
    jnet.initialize()
    jnet(jnp_.ones((4, 10)))
    tnet = mlp(nn)
    params_from_numpy(tnet, params_np(jnet))
    x = onp.random.RandomState(18).rand(4, 10).astype("float32")
    close(tnet(np.array(x)), jnet(jnp_.array(x)))


# ------------------------------------------------------------- the README

def _readme_program():
    text = open(os.path.join(REPO, "README.md")).read()
    block = re.search(r"```python\n(.*?)```", text, re.S).group(1)
    return block.replace("mxnet_tpu", "mxnet_tpu_torch")


def _readme_env():
    rng = onp.random.RandomState(19)
    return {"x": np.array(rng.rand(8, 784).astype("float32")),
            "y": np.array(rng.randint(0, 10, 8).astype("int32")),
            "loss_fn": tloss.SoftmaxCrossEntropyLoss(), "batch_size": 8}


def test_readme_program_runs_verbatim_on_the_cpu():
    env = _readme_env()
    exec(compile(_readme_program(), "README.md", "exec"), env)
    net = env["net"]
    assert onp.isfinite(env["loss"].asnumpy()).all() and env["loss"].shape == (8,)
    assert net._cached_op is not None and net[0].weight.shape == (128, 784)
    assert env["trainer"]._step_count == 1


def test_readme_program_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = _readme_env()
    with mx.gpu():
        with pytest.raises(MXNetError, match="no CUDA device"):
            exec(compile(_readme_program(), "README.md", "exec"), env)


def test_readme_mlp_five_steps_match_jax():
    rng = onp.random.RandomState(20)
    X, Y = rng.rand(16, 784).astype("float32"), rng.randint(0, 10, 16).astype("int32")
    runs = []
    for mxm, m, ag, nnm, Tr, L in ((mx, np, autograd, nn, Trainer, tloss),
                                   (jmx, jnp_, jag, jnn, JTrainer, jloss)):
        mxm.random.seed(3)
        net = mlp(nnm, hidden=128, out=10)
        net.initialize(mxm.init.Xavier())
        net.hybridize()
        tr = Tr(net.collect_params(), "adam", {"learning_rate": 1e-3})
        losses = []
        for _ in range(5):
            with ag.record():
                loss = L.SoftmaxCrossEntropyLoss()(net(m.array(X)), m.array(Y))
            loss.backward()
            tr.step(16)
            losses.append(loss.asnumpy())
        runs.append(losses)
    for t, j in zip(*runs):
        assert t.dtype == j.dtype
        onp.testing.assert_allclose(t, j, rtol=1e-5)


def test_mnist_example_loop():
    """``examples/train_mnist_gluon.py``'s loop on its synthetic data from
    numpy batches (no ``gluon.data``): the loss falls, accuracy rises."""
    rs = onp.random.RandomState(0)
    X = rs.rand(512, 784).astype("float32")
    Y = (X @ rs.randn(784, 10).astype("float32")).argmax(1).astype("int32")
    mx.random.seed(42)
    net = nn.HybridSequential()
    net.add(nn.Dense(128, activation="relu"), nn.Dense(64, activation="relu"), nn.Dense(10))
    net.initialize(mx.init.Xavier())
    net.hybridize()
    trainer = Trainer(net.collect_params(), "adam", {"learning_rate": 1e-3})
    loss_fn = tloss.SoftmaxCrossEntropyLoss()
    epoch_loss, acc = [], 0.0
    for _ in range(3):
        total, correct = 0.0, 0
        for i in range(0, 512, 128):
            data, label = np.array(X[i:i + 128]), np.array(Y[i:i + 128])
            with autograd.record():
                out = net(data)
                loss = loss_fn(out, label)
            loss.backward()
            trainer.step(data.shape[0])
            total += float(loss.mean().item())
            correct += int((out.argmax(axis=1) == label).sum().item())
        epoch_loss.append(total / 4)
        acc = correct / 512
    assert epoch_loss[-1] < epoch_loss[0] and acc > 0.2
