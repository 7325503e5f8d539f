"""Port parity of ResNet on the CPU: ``model_zoo`` ResNet-18 and ResNet-50,
v1 and v2, thumbnail, 10 classes, 32 x 32 images, with the JAX package's
weights (``load_dict`` of its ``collect_params()``): the inference
forward, and one SGD-momentum ``TrainStep`` against the JAX package's
recorded training forward and backward (its loss, its gradients, its
running statistics, and the step ``w - lr * g`` that SGD with momentum
takes from a zero state); NHWC (the fused route) against NCHW (layer by
layer); the space-to-depth stem against the 7 x 7 / 2 conv it rewrites;
and ``TrainStep(remat=True)`` bit for bit ``remat=False``, losses,
parameters and running statistics.

Tolerances: outputs within 1e-4 of the JAX output's max-abs scale,
running statistics within 1e-4 of max(their max-abs, 1); losses within 1e-5 relative; the parameters after
the step within 1e-6 of their scale of ``w - lr * g`` with the port's own
gradient g; whole-network gradients against the JAX package's within
5e-2 relative L2 as one vector and 1e-1 leaf by leaf, with a floor of
1e-4 of the largest leaf's norm (a conv bias that feeds a BatchNorm has
an exact gradient of 0, which each package reads as rounding noise); the
port's NHWC and NCHW routes against each other within 1e-2 leaf by leaf.
Both packages take BatchNorm's variance as the f32 E[y^2] - mean^2, which
cancels where a channel's mean is large against its spread (after every
ReLU): on ResNet-50 v2 here, taking the statistics in two passes instead
moves the port's gradients by 7.7e-3 and the JAX package's by 1.5e-2
(relative L2 as one vector), and the two packages sit 1.5e-2 apart;
ResNet-50 v1's NHWC gradients sit 4.1e-2 apart. The per-op gradients of
``tests/test_torch_conv.py`` hold 1e-4.
"""
import functools

import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import np as jnp_
from mxnet_tpu.gluon.loss import SoftmaxCrossEntropyLoss as JaxCELoss
from mxnet_tpu.gluon.model_zoo import get_model as jget

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, np, npx, optimizer, parallel
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.gluon.model_zoo import get_model, vision

OUT_TOL = 1e-4
LOSS_TOL = 1e-5
GRAD_TOL = 1e-1          # against the JAX package, leaf by leaf (see the docstring)
GLOBAL_TOL = 5e-2        # against the JAX package, all leaves as one vector
ROUTE_TOL = 1e-2         # the port's NHWC route against its NCHW route
GRAD_FLOOR = 1e-4
PARAM_TOL = 1e-5
STEP_TOL = 1e-6
LR = 0.05
B = 2


@pytest.fixture(autouse=True)
def on_cpu():
    with mx.cpu():
        yield


def scaled_err(got, want, floor=1e-30):
    got, want = (onp.asarray(a, onp.float64) for a in (got, want))
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(onp.abs(got - want).max() / max(onp.abs(want).max(), floor))


def rel_l2(got, want, floor=0.0):
    got, want = (onp.asarray(a, onp.float64) for a in (got, want))
    return float(onp.linalg.norm(got - want) / max(onp.linalg.norm(want), floor, 1e-30))


def grads_close(got, want, tol=GRAD_TOL):
    """Leaf by leaf within ``tol`` relative L2, floored at GRAD_FLOOR of
    the largest leaf's norm."""
    floor = GRAD_FLOOR * max(onp.linalg.norm(w) for w in want.values())
    assert set(got) == set(want)
    for k in want:
        assert rel_l2(got[k], want[k], floor) <= tol, k
    keys = sorted(want)
    flat = [onp.concatenate([onp.ravel(d[k]) for k in keys]) for d in (got, want)]
    assert rel_l2(*flat) <= min(tol, GLOBAL_TOL)


def images(layout, seed=0, size=32):
    x = onp.random.RandomState(seed).rand(B, 3, size, size).astype("float32")
    return x.transpose(0, 2, 3, 1).copy() if layout == "NHWC" else x


def labels(seed=1):
    return onp.random.RandomState(seed).randint(0, 10, B).astype("int32")


@functools.lru_cache(maxsize=None)
def jax_ref(name, layout):
    """The JAX package's thumbnail model after ``mx.random.seed(0)`` and
    Xavier: its parameters, its inference output on ``images(seed=2)``,
    then one recorded training forward and backward on ``images(seed=3)``:
    loss, gradients and the running statistics it wrote."""
    jmx.random.seed(0)
    net = jget(name, classes=10, thumbnail=True, layout=layout)
    net.initialize(jmx.init.Xavier())
    net(jnp_.array(images(layout)))
    params = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    with jag.predict_mode():
        infer = net(jnp_.array(images(layout, seed=2))).asnumpy()
    with jag.record(train_mode=True):
        loss = JaxCELoss()(net(jnp_.array(images(layout, seed=3))),
                           jnp_.array(labels())).mean()
    loss.backward()
    grads = {k: p.grad().asnumpy() for k, p in net.collect_params().items()
             if p.grad_req != "null"}
    stats = {k: p.data().asnumpy() for k, p in net.collect_params().items()
             if k.endswith(("running_mean", "running_var"))}
    return params, infer, float(loss.item()), grads, stats


def port_net(name, layout, named, thumbnail=True):
    net = get_model(name, classes=10, thumbnail=thumbnail, layout=layout)
    net.initialize(mx.init.Xavier())
    return net.load_dict(named)


def nchw_named(named):
    """NHWC parameters as the NCHW twin's: OHWI weights to OIHW."""
    return {k: v.transpose(0, 3, 1, 2) if v.ndim == 4 else v for k, v in named.items()}


MODELS = [("resnet18_v1", "NHWC"), ("resnet50_v1", "NHWC"), ("resnet50_v2", None)]


@pytest.mark.parametrize("name,layout", MODELS)
def test_forward_and_train_step_match_jax(name, layout):
    """The inference forward, then one ``TrainStep``: loss, each gradient,
    the parameters after the step and the running statistics."""
    params, infer, loss, grads, stats = jax_ref(name, layout)
    tnet = port_net(name, layout, params)
    with autograd.predict_mode():
        assert scaled_err(tnet(np.array(images(layout, seed=2))).asnumpy(), infer) <= OUT_TOL
    step = parallel.TrainStep(tnet, SoftmaxCrossEntropyLoss(),
                              optimizer.SGD(learning_rate=LR, momentum=0.9),
                              example_inputs=[images(layout)])
    got = float(step(images(layout, seed=3), labels()))
    assert abs(got - loss) <= LOSS_TOL * abs(loss)
    got_grads = {n: p.grad.numpy() for n, p in step._params}
    grads_close(got_grads, grads)
    for k, p in tnet.collect_params().items():
        if k in stats:      # on the unit scale of the initial running_var
            assert scaled_err(p.data().asnumpy(), stats[k], 1.0) <= OUT_TOL, k
        else:       # a parameter without a gradient (BN with scale=False) stays
            want = params[k] - onp.float32(LR) * got_grads[k] if k in got_grads \
                else params[k]
            assert scaled_err(p.data().asnumpy(), want) <= STEP_TOL, k


def test_nhwc_fused_matches_nchw():
    """The fused NHWC route against the NCHW layers on the same weights:
    forward in both modes and the gradients of one training forward."""
    name = "resnet50_v1"
    named = jax_ref(name, "NHWC")[0]
    fused = port_net(name, "NHWC", named)
    plain = port_net(name, None, nchw_named(named))
    x = images("NHWC", seed=4)
    y = labels()
    for train in (False, True):
        with (autograd.train_mode() if train else autograd.predict_mode()):
            a = fused(np.array(x)).asnumpy()
            b = plain(np.array(x.transpose(0, 3, 1, 2))).asnumpy()
        assert scaled_err(a, b) <= OUT_TOL
    loss = SoftmaxCrossEntropyLoss()
    grads = []
    for net, xi in ((fused, x), (plain, x.transpose(0, 3, 1, 2).copy())):
        with autograd.train_mode():
            out = loss(net(torch.from_numpy(xi)), torch.from_numpy(y)).mean()
        params = {k: p for k, p in net.named_parameters() if p.requires_grad}
        gs = torch.autograd.grad(out, [params[k] for k in sorted(params)])
        grads.append({k: g.numpy() for k, g in zip(sorted(params), gs)})
    grads_close({k: g.transpose(0, 3, 1, 2) if g.ndim == 4 else g
                 for k, g in grads[0].items()}, grads[1], ROUTE_TOL)


def test_s2d_stem_is_the_7x7_conv():
    """The space-to-depth stem (4 x 4 / 1 over 12 channels, the stored
    [64, 7, 7, 3] weight rearranged inside the graph) computes the 7 x 7 / 2
    conv + BN + ReLU, and its weight gradient is the conv's."""
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet
    rng = onp.random.RandomState(5)
    x = torch.from_numpy(rng.rand(B, 16, 16, 3).astype("float32"))
    w = torch.from_numpy(rng.randn(8, 7, 7, 3).astype("float32") * 0.1).requires_grad_()
    conv = nn.Conv2D(8, 7, 2, 3, use_bias=False, layout="NHWC", in_channels=3)
    bn = nn.BatchNorm(axis=-1, in_channels=8)
    conv.initialize()
    bn.initialize()
    conv.weight.data()._data.data.copy_(w.detach())
    with autograd.train_mode():
        got = resnet._stem_s2d(conv, bn, x)
        gm, gv = bn.running_mean.data().asnumpy(), bn.running_var.data().asnumpy()
        bn2 = nn.BatchNorm(axis=-1, in_channels=8)
        bn2.initialize()
        want = npx.activation(bn2(npx.convolution(x, w, stride=2, pad=3, layout="NHWC")),
                              "relu")
    assert scaled_err(got.detach().numpy(), want.detach().numpy()) <= OUT_TOL
    assert scaled_err(gm, bn2.running_mean.data().asnumpy()) <= PARAM_TOL
    assert scaled_err(gv, bn2.running_var.data().asnumpy()) <= PARAM_TOL
    ct = torch.from_numpy(rng.randn(*want.shape).astype("float32"))
    (g_stem,) = torch.autograd.grad((got * ct).sum(), [conv.weight.data()._data])
    (g_conv,) = torch.autograd.grad((want * ct).sum(), [w])
    assert rel_l2(g_stem.numpy(), g_conv.numpy()) <= 1e-4


def test_fused_route_is_taken(monkeypatch):
    """A training forward of NHWC ResNet-18 runs each of its 8 blocks as
    one fused composite and its stem through the s2d rewrite; NCHW runs
    neither."""
    calls = {"block": 0, "conv_bn": 0}
    real_block, real_cbr = npx.fused_resnet_block, npx.fused_conv_bn_relu

    def block(*a, **k):
        calls["block"] += 1
        return real_block(*a, **k)

    def cbr(*a, **k):
        calls["conv_bn"] += 1
        return real_cbr(*a, **k)
    monkeypatch.setattr(npx, "fused_resnet_block", block)
    monkeypatch.setattr(npx, "fused_conv_bn_relu", cbr)
    for layout, want in (("NHWC", {"block": 8, "conv_bn": 1}),
                         (None, {"block": 0, "conv_bn": 0})):
        net = get_model("resnet18_v1", classes=10, layout=layout)
        net.initialize()
        calls.update(block=0, conv_bn=0)
        with autograd.train_mode():
            net(np.array(images(layout, size=64)))
        assert calls == want, layout


@pytest.mark.parametrize("layout", ["NHWC", None])
def test_remat_is_bitwise(layout):
    """``TrainStep(remat=True)`` recomputes the forward in the backward,
    where BatchNorm's writes are dropped: two steps give ``remat=False``'s
    losses, parameters and running statistics bit for bit."""
    named = jax_ref("resnet18_v1", layout)[0]
    x, y = images(layout, seed=6), labels()
    results = []
    for remat in (False, True):
        net = port_net("resnet18_v1", layout, named)
        step = parallel.TrainStep(net, SoftmaxCrossEntropyLoss(),
                                  optimizer.SGD(learning_rate=0.05, momentum=0.9),
                                  example_inputs=[x], remat=remat)
        losses = [step(x, y) for _ in range(2)]
        results.append((losses, {k: p.data()._data.clone()
                                 for k, p in net.collect_params().items()}))
    (la, pa), (lb, pb) = results
    assert all(torch.equal(a, b) for a, b in zip(la, lb))
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k


def test_deferred_train_step_initializes_in_training_order():
    """A deferred NHWC ResNet given to ``TrainStep`` is initialized by one
    training-mode forward of the example inputs, as the JAX package traces
    its step, and then trains."""
    net = get_model("resnet18_v1", classes=10, thumbnail=True, layout="NHWC")
    net.initialize(mx.init.Xavier())
    x, y = images("NHWC"), labels()
    step = parallel.TrainStep(net, SoftmaxCrossEntropyLoss(), "sgd", example_inputs=[x])
    assert all(p._var is not None for p in net.collect_params().values())
    assert onp.isfinite(float(step(x, y)))


def test_resnet_errors():
    """The JAX package's words for a depth it lacks and for pretrained
    weights."""
    with pytest.raises(MXNetError, match="pretrained weights unavailable"):
        get_model("resnet18_v1", pretrained=True)
    with pytest.raises(MXNetError, match="invalid resnet depth 19"):
        vision.get_resnet(1, 19)
