"""Port parity of the legacy ``mx.nd`` namespace: the cases of
``tests/test_legacy_ops.py`` and the rest of ``mxnet_tpu/nd.py``'s
legacy-only spellings, each run on the same numpy inputs through
``mxnet_tpu.nd`` (JAX on the CPU) and ``mxnet_tpu_torch.nd`` under ``with
mx.cpu():``. Dtype and shape exact; values within 1e-5 relative (1e-6
absolute) unless a case states otherwise: CTC losses within 1e-4 (optax's
forward recursion against torch's), ``sample_multinomial``'s draws equal
(its gumbel noise agrees to a few f32 ulps, far from any tie here).
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, np

R = onp.random.RandomState(0)
X4 = R.rand(2, 8, 4, 4).astype("float32")
X3 = onp.arange(12).reshape(3, 2, 2).astype("float32")
LN = onp.array([2, 3], "float32")
W = R.randn(4).astype("float32")
G = R.randn(4).astype("float32")
S = onp.abs(R.randn(4)).astype("float32")
A = R.rand(2, 3).astype("float32")
B = R.rand(4, 3).astype("float32")
P = onp.array([[0.2, 0.5, 0.3], [0.7, 0.1, 0.2]], "float32")
ACTS = R.rand(10, 2, 5).astype("float32")
LABELS = onp.array([[1, 2], [3, 4]], "float32")
LOGITS = onp.array([[2.0, 1.0, 0.1], [0.5, 2.5, 0.3]], "float32")


@pytest.fixture(autouse=True)
def on_cpu():
    """The CPU device, and one torch thread (the suite runs in parallel
    workers that share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with mx.cpu():
            yield
    finally:
        torch.set_num_threads(threads)


def test_audit_names_resolve():
    """The names ``test_legacy_ops.py`` audits, and every public name of the
    JAX package's ``mx.nd``, resolve in the port's."""
    names = [n for n in dir(jmx.nd) if not n.startswith("_")]
    missing = [n for n in names if not hasattr(mx.nd, n)]
    assert not missing, missing
    assert mx.nd.sparse is mx.sparse
    assert mx.nd.Custom is not None and mx.nd.ctc_loss is mx.nd.CTCLoss


def _a(nd, x):
    return nd.array(x)


CASES = {
    "space_to_depth": lambda nd: nd.space_to_depth(_a(nd, X4), 2),
    "depth_roundtrip": lambda nd: nd.depth_to_space(nd.space_to_depth(_a(nd, X4), 2), 2),
    "im2col": lambda nd: nd.im2col(_a(nd, X4), (3, 3), pad=(1, 1)),
    "col2im": lambda nd: nd.col2im(nd.im2col(_a(nd, X4), (3, 3), pad=(1, 1)), (4, 4), (3, 3),
                                   pad=(1, 1)),
    "seq_reverse": lambda nd: nd.SequenceReverse(_a(nd, X3), _a(nd, LN),
                                                 use_sequence_length=True),
    "seq_last": lambda nd: nd.SequenceLast(_a(nd, X3), _a(nd, LN), use_sequence_length=True),
    "seq_last_plain": lambda nd: nd.SequenceLast(_a(nd, X3)),
    "lrn": lambda nd: nd.LRN(_a(nd, X4), nsize=5),
    "moments": lambda nd: nd.moments(_a(nd, X4), axes=(0, 2, 3)),
    "moments_keep": lambda nd: nd.moments(_a(nd, X4), axes=(1,), keepdims=True),
    "khatri_rao": lambda nd: nd.khatri_rao(_a(nd, A), _a(nd, B)),
    "sgd_update": lambda nd: nd.sgd_update(_a(nd, W), _a(nd, G), lr=0.1, wd=0.01),
    "sgd_mom_update": lambda nd: nd.sgd_mom_update(_a(nd, W), _a(nd, G), _a(nd, S), lr=0.1,
                                                   momentum=0.9),
    "adam_update": lambda nd: nd.adam_update(_a(nd, W), _a(nd, G), _a(nd, S), _a(nd, S),
                                             lr=0.1),
    "rmsprop_update": lambda nd: nd.rmsprop_update(_a(nd, W), _a(nd, G), _a(nd, S), lr=0.01),
    "signsgd_update": lambda nd: nd.signsgd_update(_a(nd, W), _a(nd, G), lr=0.1),
    "nag_mom_update": lambda nd: nd.nag_mom_update(_a(nd, W), _a(nd, G), _a(nd, S), lr=0.1,
                                                   momentum=0.9),
    "signum_update": lambda nd: nd.signum_update(_a(nd, W), _a(nd, G), _a(nd, S), lr=0.1,
                                                 momentum=0.9),
    "ftrl_update": lambda nd: nd.ftrl_update(_a(nd, W), _a(nd, G), _a(nd, S), _a(nd, S),
                                             lr=0.1),
    "ftml_update": lambda nd: nd.ftml_update(_a(nd, W), _a(nd, G), _a(nd, S), _a(nd, S),
                                             _a(nd, S), lr=0.1, t=2),
    "rmspropalex_update": lambda nd: nd.rmspropalex_update(
        _a(nd, W), _a(nd, G), _a(nd, S + 1), _a(nd, S * 0.1), _a(nd, S), lr=0.01),
    "multi_sgd_update": lambda nd: nd.multi_sgd_update(_a(nd, W), _a(nd, G), _a(nd, S),
                                                       _a(nd, G), lrs=[0.1, 0.2]),
    "multi_sgd_mom_update": lambda nd: nd.multi_sgd_mom_update(
        _a(nd, W), _a(nd, G), _a(nd, S), lrs=[0.1], momentum=0.5),
    "multi_mp_sgd_update": lambda nd: nd.multi_mp_sgd_update(_a(nd, W), _a(nd, G), _a(nd, W),
                                                             lrs=[0.1]),
    "preloaded_multi_sgd_update": lambda nd: nd.preloaded_multi_sgd_update(
        _a(nd, W), _a(nd, G), _a(nd, onp.array([0.1], "f4")), _a(nd, onp.array([0.0], "f4"))),
    "multi_lars": lambda nd: nd.multi_lars(_a(nd, S), _a(nd, S + 1), _a(nd, S + 2),
                                           _a(nd, S * 0.01)),
    "ctc_loss": lambda nd: nd.ctc_loss(_a(nd, ACTS), _a(nd, LABELS)),
    "softmax_cross_entropy": lambda nd: nd.softmax_cross_entropy(_a(nd, LOGITS),
                                                                 _a(nd, onp.array([0, 1], "f4"))),
    "pad_constant": lambda nd: nd.Pad(_a(nd, X4), mode="constant",
                                      pad_width=(0, 0, 0, 0, 1, 2, 2, 1), constant_value=0.5),
    "pad_edge": lambda nd: nd.Pad(_a(nd, X4), mode="edge", pad_width=(0, 0, 0, 0, 1, 2, 2, 1)),
    "pad_reflect": lambda nd: nd.Pad(_a(nd, X4), mode="reflect",
                                     pad_width=(0, 0, 0, 0, 2, 3, 3, 1)),
    "upsampling": lambda nd: nd.UpSampling(_a(nd, X4), scale=2),
    "l2norm": lambda nd: [nd.L2Normalization(_a(nd, X4), mode=m)
                          for m in ("instance", "channel", "spatial")],
    "softmax_activation": lambda nd: [nd.SoftmaxActivation(_a(nd, X4), mode=m)
                                      for m in ("instance", "channel")],
    "slice_channel": lambda nd: nd.SliceChannel(_a(nd, X4), 2, axis=1, squeeze_axis=False),
    "add_n": lambda nd: nd.add_n(_a(nd, A), _a(nd, A), _a(nd, A * 2)),
    "slice_like": lambda nd: nd.slice_like(_a(nd, X4), _a(nd, X4[:1, :3])),
    "slice": lambda nd: nd.slice(_a(nd, X4), (0, 1), (2, 5)),
    "broadcast_axis": lambda nd: nd.broadcast_axis(_a(nd, A[:1]), axis=0, size=3),
    "all_finite": lambda nd: nd.all_finite(_a(nd, A)),
    "multi_all_finite": lambda nd: nd.multi_all_finite(_a(nd, A), _a(nd, onp.array([onp.inf]))),
    "multi_sum_sq": lambda nd: nd.multi_sum_sq(_a(nd, A), _a(nd, B)),
    "shape_size_array": lambda nd: [nd.shape_array(_a(nd, X4)), nd.size_array(_a(nd, X4))],
    "rsqrt_rcbrt": lambda nd: [nd.rsqrt(_a(nd, S + 0.5)), nd.rcbrt(_a(nd, S + 0.5))],
    "hard_sigmoid_softmin": lambda nd: [nd.hard_sigmoid(_a(nd, G)), nd.softmin(_a(nd, A))],
    "batch_take": lambda nd: nd.batch_take(_a(nd, A), _a(nd, onp.array([2, 0], "int32"))),
    "flatten_norm": lambda nd: [nd.flatten(_a(nd, X4)), nd.norm(_a(nd, A))],
    "random_gamma": lambda nd: nd.random_gamma(2.0, 1.5, shape=(6,)),
    "random_poisson": lambda nd: nd.random_poisson(3.0, shape=(6,)),
    "uniform_normal": lambda nd: [nd.uniform(shape=(5,)), nd.normal(shape=(3,))],
    "sample_multinomial": lambda nd: nd.sample_multinomial(_a(nd, P), shape=4),
    "sample_multinomial_prob": lambda nd: nd.sample_multinomial(_a(nd, P), get_prob=True),
    "concat_elemwise": lambda nd: [nd.concat([_a(nd, A), _a(nd, B)], axis=0),
                                   nd.elemwise_add(_a(nd, A), _a(nd, A)),
                                   nd.broadcast_greater(_a(nd, A), _a(nd, A[:1]))],
}


def _host(out):
    if isinstance(out, (list, tuple)):
        return [v for o in out for v in _host(o)]
    return [out.asnumpy()]


@pytest.mark.parametrize("name", sorted(CASES))
def test_legacy_op_matches_jax(name):
    outs = []
    for nd, mxm in ((mx.nd, mx), (jmx.nd, jmx)):
        mxm.random.seed(7)
        outs.append(_host(CASES[name](nd)))
    t, j = outs
    assert len(t) == len(j)
    rtol, atol = (1e-4, 1e-4) if name == "ctc_loss" else (1e-5, 1e-6)
    for a, b in zip(t, j):
        assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
        onp.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def test_adam_update_has_no_bias_correction():
    """The reference op's Adam: repeated calls keep the same step scale."""
    w, g = mx.nd.array(onp.ones(4, "f4")), mx.nd.array(onp.full(4, 0.5, "f4"))
    new_w, new_m, new_v = mx.nd.adam_update(w, g, mx.nd.zeros(4), mx.nd.zeros(4), lr=0.1)
    onp.testing.assert_allclose(new_w.asnumpy(), onp.full(4, 1 - 0.31623, "f4"), rtol=1e-3)
    w2, _, _ = mx.nd.adam_update(new_w, g, new_m, new_v, lr=0.1)
    assert 0.3 < float((new_w.asnumpy() - w2.asnumpy())[0]) < 0.5


def test_amp_multicast_widest_float():
    """Floating inputs cast to the widest float among them (narrowest with
    ``cast_narrow``). The JAX package's raises: its module's ``max`` is
    ``mx.np.max``."""
    outs = mx.nd.amp_multicast(mx.nd.array(A), mx.nd.array(A.astype("f2")),
                               mx.nd.array(onp.arange(2)))
    assert [o.dtype for o in outs] == [onp.float32, onp.float32, onp.int64]
    narrow = mx.nd.amp_multicast(mx.nd.array(A), mx.nd.array(A.astype("f2")), cast_narrow=True)
    assert [o.dtype for o in narrow] == [onp.float16, onp.float16]


def _grads(pkg, ag, make):
    x = pkg.np.array(onp.array([0.3, -1.2, 2.0, 0.5], "f4"))
    x.attach_grad()
    with ag.record():
        out = make(pkg, x)
    out.backward()
    return out.asnumpy(), x.grad.asnumpy()


GRAD_CASES = {
    "logistic": lambda pkg, x: pkg.nd.LogisticRegressionOutput(
        x, pkg.np.array(onp.ones(4, "f4"))),
    "linear_2d": lambda pkg, x: pkg.nd.LinearRegressionOutput(
        x.reshape(2, 2), pkg.np.array(onp.ones((2, 2), "f4")), grad_scale=2.0),
    "mae": lambda pkg, x: pkg.nd.MAERegressionOutput(x, pkg.np.array(onp.zeros(4, "f4"))),
    "make_loss": lambda pkg, x: pkg.nd.MakeLoss(x * x, grad_scale=0.5),
    "block_grad": lambda pkg, x: (pkg.nd.BlockGrad(x) * x).sum(),
}


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_loss_heads_gradients_match_jax(name):
    """The regression heads' gradient is (act(x) - label) * grad_scale /
    outputs per sample, whatever the cotangent; MakeLoss scales only the
    gradient; BlockGrad stops it."""
    (to, tg), (jo, jg) = (_grads(mx, autograd, GRAD_CASES[name]),
                          _grads(jmx, jag, GRAD_CASES[name]))
    onp.testing.assert_allclose(to, jo, rtol=1e-6)
    onp.testing.assert_allclose(tg, jg, rtol=1e-6)


def test_nd_save_load_roundtrip(tmp_path):
    f = str(tmp_path / "arrays.params")
    mx.nd.save(f, {"a": mx.nd.array(A), "b": mx.nd.array(X3)})
    back = jmx.nd.load(f)
    onp.testing.assert_array_equal(back["a"].asnumpy(), A)
    jmx.nd.save(f, [jmx.nd.array(B)])
    onp.testing.assert_array_equal(mx.nd.load(f)[0].asnumpy(), B)
