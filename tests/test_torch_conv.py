"""Port parity of the conv path on the CPU: ``npx.convolution``,
``npx.deconvolution`` and ``npx.pooling`` (1-D, 2-D and 3-D, groups,
dilation, NC* and N*C layouts, the ``'full'`` convention with and without
``count_include_pad``, lp, global), the 18 conv and pool layer classes
with their deferred shapes, ``npx.fused_conv_bn_relu`` and
``npx.fused_resnet_block`` (outputs, gradients and running-statistics
updates, training and inference, with bias and residual), and every
model-zoo family's forward, against ``mxnet_tpu`` on the same numpy
inputs under ``with mx.cpu():``.

Tolerances: f32 outputs within 1e-4 of the JAX output's max-abs scale;
gradients within 1e-4 relative L2, input by input; bf16 within 2e-2;
result dtypes equal.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import np as jnp_
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.model_zoo import get_model as jget

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, np, npx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.model_zoo import get_model

OUT_TOL = 1e-4
GRAD_TOL = 1e-4
PKGS = ((mx, np, autograd), (jmx, jnp_, jag))


@pytest.fixture(autouse=True)
def on_cpu():
    with mx.cpu():
        yield


def scaled_err(got, want):
    got, want = (onp.asarray(a, onp.float64) for a in (got, want))
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(onp.abs(got - want).max() / max(onp.abs(want).max(), 1e-30))


def rel_l2(got, want):
    got, want = (onp.asarray(a, onp.float64) for a in (got, want))
    return float(onp.linalg.norm(got - want) / max(onp.linalg.norm(want), 1e-30))


def run(pkg, fn, arrays, seed=7):
    """``fn(mx, inputs)`` recorded in training mode, then the backward of
    ``sum(out[0] * ct)``: returns (outputs, input gradients)."""
    mxm, m, ag = pkg
    xs = [m.array(a) for a in arrays]
    for x in xs:
        x.attach_grad()
    with ag.record(train_mode=True):
        outs = fn(mxm, xs)
        outs = list(outs) if isinstance(outs, (tuple, list)) else [outs]
        ct = onp.random.RandomState(seed).randn(*outs[0].shape).astype("float32")
        loss = (outs[0] * m.array(ct)).sum()
    loss.backward()
    return [o.asnumpy() for o in outs], [x.grad.asnumpy() for x in xs]


def check(fn, arrays, grads=True):
    (to, tg), (jo, jg) = (run(p, fn, arrays) for p in PKGS)
    for a, b in zip(to, jo):
        assert a.dtype == b.dtype
        assert scaled_err(a, b) <= OUT_TOL
    if grads:
        for i, (a, b) in enumerate(zip(tg, jg)):
            assert rel_l2(a, b) <= GRAD_TOL, i


LAYOUTS = {1: "NWC", 2: "NHWC", 3: "NDHWC"}


@pytest.mark.parametrize("nd", [1, 2, 3])
@pytest.mark.parametrize("channel_last", [False, True])
@pytest.mark.parametrize("groups,dilate,stride,pad", [(1, 1, 1, 0), (2, 2, 2, 1), (1, 1, 2, 2)])
def test_convolution(nd, channel_last, groups, dilate, stride, pad):
    rng = onp.random.RandomState(nd)
    C, O, k, sp = 4, 6, (3,) * nd, (7,) * nd
    layout = LAYOUTS[nd] if channel_last else None
    x = rng.randn(2, *(sp + (C,) if channel_last else (C,) + sp)).astype("float32")
    w = rng.randn(*((O,) + k + (C // groups,) if channel_last else (O, C // groups) + k))
    b = rng.randn(O)
    check(lambda mxm, v: mxm.npx.convolution(v[0], v[1], v[2], stride=stride, dilate=dilate,
                                             pad=pad, num_group=groups, layout=layout),
          [x, w.astype("float32"), b.astype("float32")])


def test_channel_last_convolution_takes_no_copy(monkeypatch):
    """NHWC data and OHWI weights reach the library convolution as
    channels-last views, and the NHWC result comes back as a contiguous
    view of its channels-last output: no hidden copy on either side."""
    seen = []
    real = npx._CONV[2]

    def spy(x, w, *a):
        seen.append((x.is_contiguous(memory_format=torch.channels_last),
                     w.is_contiguous(memory_format=torch.channels_last)))
        return real(x, w, *a)
    monkeypatch.setitem(npx._CONV, 2, spy)
    x = torch.randn(2, 8, 8, 4)
    w = torch.randn(6, 3, 3, 4)
    out = npx.convolution(x, w, pad=1, layout="NHWC")
    assert seen == [(True, True)]
    assert out.shape == (2, 8, 8, 6) and out.is_contiguous()
    pooled = npx.pooling(out, kernel=3, stride=2, pad=1, layout="NHWC")
    assert pooled.is_contiguous()


@pytest.mark.parametrize("nd", [1, 2, 3])
@pytest.mark.parametrize("groups,stride,dilate,pad,adj", [
    (1, 2, 1, 1, 1), (2, 2, 1, 0, 0), (1, 1, 2, 0, 1),
    # adj >= max(stride, dilate): torch's output_padding refuses it
    (1, 2, 1, 1, 2), (2, 3, 1, 2, 3)])
def test_deconvolution(nd, groups, stride, dilate, pad, adj):
    rng = onp.random.RandomState(10 + nd)
    C, O, k = 4, 6, (3,) * nd
    x = rng.randn(2, C, *(5,) * nd).astype("float32")
    w = rng.randn(C, O // groups, *k).astype("float32")
    b = rng.randn(O).astype("float32")
    check(lambda mxm, v: mxm.npx.deconvolution(v[0], v[1], v[2], stride=stride, dilate=dilate,
                                               pad=pad, adj=adj, num_group=groups,
                                               no_bias=False), [x, w, b])


@pytest.mark.parametrize("nd", [1, 2, 3])
@pytest.mark.parametrize("channel_last", [False, True])
@pytest.mark.parametrize("pool_type", ["max", "avg", "sum", "lp"])
@pytest.mark.parametrize("convention,count_include_pad", [("valid", True), ("full", True),
                                                         ("full", False)])
def test_pooling(nd, channel_last, pool_type, convention, count_include_pad):
    rng = onp.random.RandomState(20 + nd)
    layout = LAYOUTS[nd] if channel_last else None
    sp, C = (7,) * nd, 3
    x = rng.randn(2, *(sp + (C,) if channel_last else (C,) + sp)).astype("float32")
    for k, s, p in ((3, 2, 1), (2, 2, 0), (3, 3, 1)):
        check(lambda mxm, v: mxm.npx.pooling(v[0], kernel=k, pool_type=pool_type, stride=s,
                                             pad=p, count_include_pad=count_include_pad,
                                             pooling_convention=convention, layout=layout),
              [x], grads=pool_type != "max")


@pytest.mark.parametrize("nd", [1, 2, 3])
@pytest.mark.parametrize("pool_type", ["max", "avg"])
@pytest.mark.parametrize("channel_last", [False, True])
def test_global_pooling(nd, pool_type, channel_last):
    layout = LAYOUTS[nd] if channel_last else None
    x = onp.random.RandomState(30 + nd).randn(2, 3, *(5,) * nd).astype("float32")
    check(lambda mxm, v: mxm.npx.pooling(v[0], pool_type=pool_type, global_pool=True,
                                         layout=layout), [x])


def test_pooling_of_integers_and_bf16():
    """Max pooling of integer data pads with the integer minimum; bf16 avg
    pooling returns f32 as the JAX package's f32 divisor makes it (its
    window sum rounds in bf16 there, in f32 here)."""
    rng = onp.random.RandomState(40)
    xi = rng.randint(-50, 50, (2, 3, 7, 7)).astype("int64")
    outs = [mxm.npx.pooling(m.array(xi), kernel=3, stride=2, pad=1,
                            pooling_convention="full") for mxm, m, _ in PKGS]
    assert onp.array_equal(outs[0].asnumpy(), outs[1].asnumpy())
    xb = rng.randn(2, 3, 7, 7).astype("float32")
    outs = [mxm.npx.pooling(m.array(xb).astype("bfloat16"), kernel=3, stride=2,
                            pool_type="avg") for mxm, m, _ in PKGS]
    assert str(outs[0].dtype) == str(outs[1].dtype) == "float32"
    assert scaled_err(outs[0].asnumpy(), outs[1].asnumpy()) <= 2e-2


LAYERS = [
    ("Conv1D", dict(channels=4, kernel_size=3, padding=1), (2, 3, 9)),
    ("Conv2D", dict(channels=4, kernel_size=3, strides=2, groups=1), (2, 3, 9, 9)),
    ("Conv3D", dict(channels=4, kernel_size=2, dilation=2), (2, 3, 6, 6, 6)),
    ("Conv2D", dict(channels=4, kernel_size=3, layout="NHWC", activation="relu"), (2, 9, 9, 3)),
    ("Conv1DTranspose", dict(channels=4, kernel_size=3, strides=2, output_padding=1),
     (2, 3, 5)),
    ("Conv2DTranspose", dict(channels=4, kernel_size=3, strides=2, padding=1), (2, 2, 5, 5)),
    ("Conv3DTranspose", dict(channels=4, kernel_size=2, groups=2), (2, 2, 3, 3, 3)),
    ("MaxPool1D", dict(pool_size=3, strides=2, ceil_mode=True), (2, 3, 9)),
    ("MaxPool2D", dict(pool_size=3, strides=2, padding=1), (2, 3, 9, 9)),
    ("MaxPool3D", dict(), (2, 3, 4, 4, 4)),
    ("AvgPool1D", dict(pool_size=2), (2, 3, 9)),
    ("AvgPool2D", dict(pool_size=3, padding=1, ceil_mode=True, count_include_pad=False),
     (2, 3, 9, 9)),
    ("AvgPool3D", dict(layout="NDHWC"), (2, 4, 4, 4, 3)),
    ("GlobalMaxPool1D", dict(), (2, 3, 9)),
    ("GlobalMaxPool2D", dict(layout="NHWC"), (2, 9, 9, 3)),
    ("GlobalMaxPool3D", dict(), (2, 3, 4, 4, 4)),
    ("GlobalAvgPool1D", dict(), (2, 3, 9)),
    ("GlobalAvgPool2D", dict(), (2, 3, 9, 9)),
    ("GlobalAvgPool3D", dict(), (2, 3, 4, 4, 4)),
]


@pytest.mark.parametrize("cls,kw,shape", LAYERS, ids=[f"{c}{i}" for i, (c, _, _) in
                                                      enumerate(LAYERS)])
def test_layer_matches_jax(cls, kw, shape):
    """Each class with its deferred weight shape inferred at the first
    forward, the JAX weights loaded, then forward and gradients; the
    repr is the JAX package's."""
    x = onp.random.RandomState(50).randn(*shape).astype("float32")
    jmx.random.seed(0)
    jl, tl = getattr(jnn, cls)(**kw), getattr(nn, cls)(**kw)
    jl.initialize()
    tl.initialize()
    jl(jnp_.array(x))
    tl(np.array(x))
    named = {k: p.data().asnumpy() for k, p in jl.collect_params().items()}
    assert {k: v.shape for k, v in named.items()} == \
        {k: tuple(p.shape) for k, p in tl.collect_params().items()}
    tl.load_dict(named)
    assert repr(tl) == repr(jl)
    layers = {id(mx): tl, id(jmx): jl}
    check(lambda mxm, v: layers[id(mxm)](v[0]), [x])


def test_conv_layer_errors():
    with pytest.raises(MXNetError, match="channel-last layout is not supported"):
        nn.Conv2DTranspose(4, 3, layout="NHWC")
    with pytest.raises(MXNetError, match="unknown pool_type"):
        npx.pooling(np.ones((1, 1, 4, 4)), kernel=2, pool_type="median")


def _conv_bn_arrays(rng, bias, res):
    C, O = 4, 6
    arrays = [rng.randn(2, 6, 6, C), rng.randn(O, 3, 3, C) * 0.3, rng.rand(O) + 0.5,
              rng.randn(O), rng.randn(O), rng.rand(O) + 0.5]
    if bias:
        arrays.append(rng.randn(O))
    if res:
        arrays.append(rng.randn(2, 3, 3, O))
    return [a.astype("float32") for a in arrays]


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("res", [False, True])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("training", [True, False])
def test_fused_conv_bn_relu(relu, res, bias, training):
    """Output, gradients of every input (a conv bias's is exactly 0 in
    training), and the running-statistics updates."""
    arrays = _conv_bn_arrays(onp.random.RandomState(60), bias, res)

    def fn(mxm, v):
        return mxm.npx.fused_conv_bn_relu(
            *v[:6], bias=v[6] if bias else None, residual=v[6 + bias] if res else None,
            stride=(2, 2), pad=(1, 1), relu=relu, training=training)
    check(fn, arrays)
    if bias and training:
        _, grads = run(PKGS[0], fn, arrays)
        assert not grads[6].any()


@pytest.mark.parametrize("kind,downsample", [("bottleneck", True), ("bottleneck", False),
                                             ("basic", True), ("basic", False)])
def test_fused_resnet_block(kind, downsample):
    """A whole block's output, every gradient and every pair's running
    statistics, conv biases on the first and third convs."""
    rng = onp.random.RandomState(70)
    C = 8
    cout = 12 if downsample else 8
    mid = cout // 4 if kind == "bottleneck" else cout
    shapes = [(mid, 1, 1, C), (mid, 3, 3, mid), (cout, 1, 1, mid)] if kind == "bottleneck" \
        else [(cout, 3, 3, C), (cout, 3, 3, cout)]
    if downsample:
        shapes.append((cout, 1, 1, C))
    arrays, has_bias = [rng.randn(2, 6, 6, C)], []
    for i, sh in enumerate(shapes):
        o = sh[0]
        arrays += [rng.randn(*sh) * 0.3, rng.rand(o) + 0.5, rng.randn(o), rng.randn(o),
                   rng.rand(o) + 0.5]
        has_bias.append(i % 2 == 0)
        if has_bias[-1]:
            arrays.append(rng.randn(o))
    arrays = [a.astype("float32") for a in arrays]

    def fn(mxm, v):
        i, cp, bp = 1, [], []
        for k in range(len(shapes)):
            w, g, b, rm, rv = v[i:i + 5]
            i += 5
            cp.append((w, v[i] if has_bias[k] else None))
            i += int(has_bias[k])
            bp.append((g, b, rm, rv))
        z, ups = mxm.npx.fused_resnet_block(v[0], cp, bp, kind=kind,
                                            stride=(2, 2) if downsample else (1, 1))
        return [z] + [u for pair in ups for u in pair]
    check(fn, arrays)


def _zoo(pkg_vision):
    """Each family at a small size, one variant each (VGG with BN, the
    SqueezeNet 1.1 layout): the registered builders where they are small,
    the family's own classes cut down where they are not (DenseNet's
    dense and transition layers over two short blocks; Inception V3's five
    block kinds, each on its own)."""
    v = pkg_vision
    inc = v.inception
    blocks = [inc._inception_a(8), inc._reduction_a(), inc._inception_b(8),
              inc._reduction_b(), inc._inception_c()]
    return {
        "alexnet": (lambda: v.alexnet(classes=10), (1, 3, 64, 64)),
        "vgg11_bn": (lambda: v.vgg11_bn(classes=10), (1, 3, 32, 32)),
        "mobilenet0.25": (lambda: v.mobilenet0_25(classes=10), (1, 3, 32, 32)),
        "mobilenetv2_0.25": (lambda: v.mobilenet_v2_0_25(classes=10), (1, 3, 32, 32)),
        "densenet": (lambda: v.DenseNet(8, 4, (2, 2), classes=10), (1, 3, 32, 32)),
        "squeezenet1.1": (lambda: v.squeezenet1_1(classes=10), (1, 3, 64, 64)),
        "inception_a": (lambda: blocks[0], (1, 16, 9, 9)),
        "inception_reduction_a": (lambda: blocks[1], (1, 16, 9, 9)),
        "inception_b": (lambda: blocks[2], (1, 16, 9, 9)),
        "inception_reduction_b": (lambda: blocks[3], (1, 16, 9, 9)),
        "inception_c": (lambda: blocks[4], (1, 16, 5, 5)),
    }


ZOO = ["alexnet", "vgg11_bn", "mobilenet0.25", "mobilenetv2_0.25", "densenet", "squeezenet1.1",
       "inception_a", "inception_reduction_a", "inception_b", "inception_reduction_b",
       "inception_c"]


@pytest.mark.parametrize("name", ZOO)
def test_zoo_family_forward(name):
    """Each family's inference forward with the JAX package's weights (the
    JAX block hybridized: one compile)."""
    from mxnet_tpu.gluon.model_zoo import vision as jvision
    from mxnet_tpu_torch.gluon.model_zoo import vision
    make_j, shape = _zoo(jvision)[name]
    make_t, _ = _zoo(vision)[name]
    x = onp.random.RandomState(80).rand(*shape).astype("float32")
    jmx.random.seed(0)
    jnet = make_j()
    jnet.initialize()
    jnet.hybridize()
    with jag.predict_mode():
        want = jnet(jnp_.array(x)).asnumpy()
    tnet = make_t()
    tnet.load_dict({k: p.data().asnumpy() for k, p in jnet.collect_params().items()})
    with autograd.predict_mode():
        got = tnet(np.array(x)).asnumpy()
    assert scaled_err(got, want) <= OUT_TOL


def test_zoo_registry_matches_jax():
    """``get_model`` knows every name the JAX package's registry knows,
    builds the full-size model, and refuses an unknown name in its words."""
    from mxnet_tpu.gluon.model_zoo import vision as jvision
    from mxnet_tpu_torch.gluon.model_zoo import vision
    jvision._register_models()
    vision._register_models()
    assert sorted(vision._models) == sorted(jvision._models)
    net = get_model("InceptionV3", classes=10)
    assert len(net.features) == len(jget("inceptionv3", classes=10).features)
    with pytest.raises(MXNetError, match="unknown model 'lenet'"):
        get_model("lenet")

