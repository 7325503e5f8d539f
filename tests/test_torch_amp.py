"""Port parity of AMP (``mxnet_tpu_torch.amp`` against ``mxnet_tpu.amp``)
on the CPU: the op lists, the policy's casts by op name at the funnel,
``convert_hybrid_block`` (parameters cast but the norm ones, the forward
under the block's policy, the CachedOp key's ``amp`` slot), BatchNorm and
LayerNorm on bf16 activations with f32 parameters and statistics, bf16
ResNet and MLP forwards and a bf16 ``TrainStep``, and dynamic loss scaling
through ``Trainer.step``.

Tolerances: bf16 results within 2e-2 of the JAX result's max-abs scale
(one rounding of a bf16 product or conv differs between the two
packages); BatchNorm and LayerNorm on bf16 inputs within one bf16 ulp at
the output's scale; f32 within 1e-5 relative.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import amp as jamp
from mxnet_tpu import autograd as jag
from mxnet_tpu import np as jnp_
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.model_zoo import vision as jvision

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import _tape, amp, autograd, np, optimizer, parallel
from mxnet_tpu_torch.gluon import Trainer, nn
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.gluon.model_zoo import vision

BF16_TOL = 2e-2
BF16_ULP = 2.0 ** -8


@pytest.fixture(autouse=True)
def on_cpu():
    with mx.cpu():
        yield
    _tape.GLOBAL_AMP_POLICY = None


def scaled_err(got, want):
    got, want = (onp.asarray(a.asnumpy() if hasattr(a, "asnumpy") else a, onp.float64)
                 for a in (got, want))
    assert got.shape == want.shape
    return float(onp.abs(got - want).max() / max(onp.abs(want).max(), 1e-30))


def test_lists_match_jax():
    for name in ("TARGET_DTYPE_OPS", "FP32_OPS", "WIDEST_TYPE_CASTS"):
        assert getattr(amp.lists, name) == getattr(jamp.lists, name)


@pytest.mark.parametrize("op", ["dense", "matmul", "add", "softmax", "sum", "mul"])
def test_autocast_casts_by_op_name(op):
    """Under ``autocast`` each op's result dtype is the JAX package's:
    products in bf16, softmax and sums in f32, ``+`` to the widest input,
    an op in no list (``*``) left alone."""
    rng = onp.random.RandomState(0)
    a = rng.randn(4, 8).astype("float32")
    b = rng.randn(8, 8).astype("float32")
    outs = []
    for m, mxm, am in ((np, mx, amp), (jnp_, jmx, jamp)):
        x, w = m.array(a), m.array(b)
        xb = x.astype("bfloat16")
        with am.autocast("bfloat16"):
            out = {"dense": lambda: mxm.npx.fully_connected(x, w, num_hidden=8, no_bias=True),
                   "matmul": lambda: x @ w,
                   "add": lambda: xb + x,
                   "softmax": lambda: mxm.npx.softmax(xb),
                   "sum": lambda: m.sum(xb),
                   "mul": lambda: xb * xb}[op]()
        outs.append(out)
    assert str(outs[0].dtype) == str(outs[1].dtype)
    assert scaled_err(outs[0].astype("float32"), outs[1].astype("float32")) <= BF16_TOL


def test_autocast_disabled_shadows_global_policy():
    amp.init("bfloat16")
    x = np.ones((2, 2))
    assert (x @ x).dtype == "bfloat16"
    with amp.autocast(enabled=False):
        assert (x @ x).dtype == onp.float32


@pytest.mark.parametrize("axis,shape", [(1, (4, 6, 5, 5)), (-1, (4, 5, 5, 6))])
@pytest.mark.parametrize("training", [True, False])
def test_batch_norm_bf16_matches_jax(axis, shape, training):
    """bf16 x with f32 gamma, beta and statistics: f32 statistics, one
    ``x * scale + shift`` in bf16, bf16 out; new statistics f32."""
    rng = onp.random.RandomState(1)
    x = (rng.randn(*shape) * 2 + 1).astype("float32")
    c = shape[axis]
    g, b = rng.rand(c).astype("float32") + 0.5, rng.randn(c).astype("float32")
    rm, rv = rng.randn(c).astype("float32"), rng.rand(c).astype("float32") + 0.5
    outs = []
    for m, mxm in ((np, mx), (jnp_, jmx)):
        args = [m.array(x).astype("bfloat16")] + [m.array(v) for v in (g, b, rm, rv)]
        outs.append(mxm.npx.batch_norm(*args, axis=axis, training=training))
    for got, want in zip(*outs):
        assert str(got.dtype) == str(want.dtype)
        assert scaled_err(got.astype("float32"), want.astype("float32")) <= BF16_ULP


def test_layer_norm_bf16_matches_jax():
    rng = onp.random.RandomState(2)
    x = (rng.randn(4, 16) * 3).astype("float32")
    g, b = rng.rand(16).astype("float32"), rng.randn(16).astype("float32")
    outs = [mxm.npx.layer_norm(m.array(x).astype("bfloat16"), m.array(g), m.array(b))
            for m, mxm in ((np, mx), (jnp_, jmx))]
    assert str(outs[0].dtype) == str(outs[1].dtype) == "bfloat16"
    assert scaled_err(outs[0].astype("float32"), outs[1].astype("float32")) <= BF16_ULP


def _mlp(nnm):
    net = nnm.HybridSequential()
    net.add(nnm.Dense(16, activation="relu", in_units=8), nnm.BatchNorm(in_channels=16),
            nnm.Dense(4, in_units=16))
    return net


def test_convert_hybrid_block_matches_jax():
    """Parameters cast but the norm ones; the forward runs under the
    block's policy (a f32 input meets bf16 weights in bf16), eager and
    hybridized, whose cache key carries the policy."""
    rng = onp.random.RandomState(3)
    x = rng.randn(4, 8).astype("float32")
    jmx.random.seed(0)
    jnet = _mlp(jnn)
    jnet.initialize()
    named = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    tnet = _mlp(nn)
    tnet.initialize()
    tnet.load_dict(named)
    jamp.convert_hybrid_block(jnet, "bfloat16")
    amp.convert_hybrid_block(tnet, "bfloat16")
    for k, p in tnet.collect_params().items():
        want = "float32" if k.endswith(("gamma", "beta", "running_mean", "running_var")) \
            else "bfloat16"
        assert str(p.data().dtype) == want == str(jnet.collect_params()[k].data().dtype), k
    want = jnet(jnp_.array(x))
    got = tnet(np.array(x))
    assert str(got.dtype) == str(want.dtype) == "bfloat16"
    assert scaled_err(got.astype("float32"), want.astype("float32")) <= BF16_TOL
    tnet.hybridize()
    hyb = tnet(np.array(x))
    assert onp.array_equal(hyb.astype("float32").asnumpy(), got.astype("float32").asnumpy())
    (key,) = tnet._cached_op._cache
    assert key[-1] == "bfloat16"


def _small_resnet(vision):
    """A thumbnail ResNet V1 cut down from the zoo's own classes (one basic
    block a stage, 16-128 channels), NHWC: the fused route at a CPU size."""
    return vision.ResNetV1(vision.BasicBlockV1, [1, 1, 1, 1], [16, 16, 32, 64, 128],
                           classes=10, thumbnail=True, layout="NHWC")


@pytest.mark.parametrize("train", [False, True])
def test_resnet_bf16_matches_jax(train):
    """``convert_hybrid_block`` on an NHWC ResNet V1: bf16 images through
    the fused route, inference and training forwards."""
    x = onp.random.RandomState(4).rand(2, 32, 32, 3).astype("float32")
    jmx.random.seed(0)
    jnet = _small_resnet(jvision)
    jnet.initialize(jmx.init.Xavier())
    jnet(jnp_.array(x))
    tnet = _small_resnet(vision)
    tnet.load_dict({k: p.data().asnumpy() for k, p in jnet.collect_params().items()})
    jamp.convert_hybrid_block(jnet, "bfloat16")
    amp.convert_hybrid_block(tnet, "bfloat16")
    with (jag.train_mode() if train else jag.predict_mode()):
        want = jnet(jnp_.array(x).astype("bfloat16"))
    with (autograd.train_mode() if train else autograd.predict_mode()):
        got = tnet(np.array(x).astype("bfloat16"))
    assert str(got.dtype) == str(want.dtype)
    assert scaled_err(got.astype("float32"), want.astype("float32")) <= BF16_TOL


def test_bf16_train_step_casts_and_trains():
    """A converted NHWC ResNet V1 in ``TrainStep``: bf16 weights and
    gradients, f32 BN parameters and statistics, finite losses that fall."""
    mx.random.seed(0)
    net = _small_resnet(vision)
    net.initialize(mx.init.Xavier())
    amp.convert_hybrid_block(net, "bfloat16")
    rng = onp.random.RandomState(5)
    x = torch.from_numpy(rng.rand(4, 32, 32, 3).astype("float32")).bfloat16()
    y = rng.randint(0, 10, 4).astype("int32")
    step = parallel.TrainStep(net, SoftmaxCrossEntropyLoss(),
                              optimizer.SGD(learning_rate=0.05, momentum=0.9),
                              example_inputs=[x])
    losses = [float(step(x, y)) for _ in range(4)]
    # B 4 under batch statistics: the loss falls, not monotonically
    assert all(onp.isfinite(losses)) and min(losses[1:]) < losses[0]
    for n, p in step._params:
        want = torch.float32 if n.endswith(("gamma", "beta")) else torch.bfloat16
        assert p.dtype == p.grad.dtype == want, n
    assert net.collect_params()["features.1.0.body.1.running_mean"].data().dtype == "float32"


def test_loss_scaler_skips_overflow_and_rescales():
    """``init_trainer`` + ``scale_loss``: a step whose gradients overflowed
    is skipped and halves the scale; a clean one folds 1/scale into the
    rescale, giving the unscaled step."""
    net = nn.Dense(2, in_units=3)
    net.initialize()
    w0 = net.weight.data().asnumpy().copy()
    tr = Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    amp.init_trainer(tr, amp.LossScaler(init_scale=2.0 ** 10))
    x = np.array(onp.ones((1, 3), "float32"))
    with autograd.record():
        loss = net(x).sum()
        with amp.scale_loss(loss, tr) as scaled:
            big = scaled * 1e38
    big.backward()
    tr.step(1)
    assert onp.array_equal(net.weight.data().asnumpy(), w0)
    assert tr._amp_loss_scaler.loss_scale == 2.0 ** 9
    with autograd.record():
        loss = net(x).sum()
        with amp.scale_loss(loss, tr) as scaled:
            pass
    scaled.backward()
    tr.step(1)
    onp.testing.assert_allclose(net.weight.data().asnumpy(), w0 - 0.1, rtol=1e-6)
