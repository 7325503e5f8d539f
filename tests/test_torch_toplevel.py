"""Port parity of the small top-level modules: ``runtime``, ``util``,
``engine``, ``test_utils`` and ``visualization`` (the cases of
``tests/test_visualization.py`` and of ``tests/test_native_and_io.py``'s
engine, runtime and test-utility tests), against ``mxnet_tpu`` (JAX on
the CPU) under ``with mx.cpu():``. ``print_summary``'s table and
``plot_network``'s DOT text equal the JAX package's character for
character; ``runtime.Features`` names what this build has (no TPU
feature) and shares the reference's feature names with the JAX package.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import engine, np, runtime, test_utils, util


@pytest.fixture(autouse=True)
def on_cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with mx.cpu():
            yield
    finally:
        torch.set_num_threads(threads)


# ------------------------------------------------------------ runtime

def test_runtime_features():
    feats, jfeats = runtime.Features(), jmx.runtime.Features()
    assert feats.is_enabled("cpu") and "CUDA" in feats
    assert feats.is_enabled("CUDA") == torch.cuda.is_available()
    assert not {"TPU", "XLA", "PALLAS"} & set(feats.keys())
    shared = {"CPU", "CUDA", "CUDNN", "NCCL", "BF16", "INT64_TENSOR_SIZE", "DIST",
              "NATIVE_CORE", "OPENCV", "PIL", "SIGNAL_HANDLER"}
    assert shared <= set(feats.keys()) and shared <= set(jfeats.keys())
    for name in ("CPU", "OPENCV", "PIL", "SIGNAL_HANDLER", "INT64_TENSOR_SIZE"):
        assert feats.is_enabled(name) == jfeats.is_enabled(name), name
    assert [f.name for f in runtime.feature_list()] == list(feats.keys())
    assert "✔ CPU" in repr(feats)


# ------------------------------------------------------------ util

def test_util_matches_jax():
    for name in ("is_np_shape", "is_np_array"):
        assert getattr(util, name)() == getattr(jmx.util, name)()
    util.set_np()
    util.reset_np()
    with util.np_shape(True), util.np_array(True):
        pass
    assert util.use_np(len) is len
    util.setenv("MXNET_TEST_TOPLEVEL", "7")
    assert util.getenv("MXNET_TEST_TOPLEVEL") == jmx.util.getenv("MXNET_TEST_TOPLEVEL") == "7"
    a, j = util.default_array([1.5, 2.5]), jmx.util.default_array([1.5, 2.5])
    assert a.dtype == j.dtype and a.shape == j.shape
    onp.testing.assert_array_equal(a.asnumpy(), j.asnumpy())


# ------------------------------------------------------------ engine

def test_naive_engine_mode():
    assert engine.engine_type() == jmx.engine.engine_type() == "ThreadedEngine"
    engine.set_engine_type("NaiveEngine")
    try:
        assert engine.is_naive()
        a = np.ones((4,)) * 3
        assert a.sum().item() == 12.0
    finally:
        engine.set_engine_type("ThreadedEngine")
    assert not engine.is_naive()
    with pytest.raises(mx.MXNetError, match="unknown engine type"):
        engine.set_engine_type("Turbo")
    with engine.bulk(4):
        assert engine.set_bulk_size(4) == 4
    assert engine.set_bulk_size(15) == 15


# ------------------------------------------------------------ test_utils

def test_test_utils_numeric_gradient():
    def f(x, y):
        return (x * y + np.tanh(x)).sum()

    test_utils.check_numeric_gradient(f, [np.array([[0.5, -0.3]]), np.array([[1.2, 0.7]])])
    with pytest.raises(AssertionError, match="analytic"):
        test_utils.check_numeric_gradient(lambda x: mx.nd.BlockGrad(x * x).sum() + x.sum(),
                                          [np.array([[0.5, 2.0]])])


def test_assert_almost_equal_reports_like_jax():
    a, b = onp.array([1.0, 2.0, 3.5]), onp.array([1.0, 2.0, 3.0])
    msgs = []
    for tu in (test_utils, jmx.test_utils):
        with pytest.raises(AssertionError) as e:
            tu.assert_almost_equal(a, b)
        msgs.append(str(e.value))
        assert tu.almost_equal(a, a) and tu.same(b, b) and not tu.same(a, b)
    assert msgs[0] == msgs[1]
    with pytest.raises(AssertionError, match="shape mismatch"):
        test_utils.assert_almost_equal(a, b[:2])


def test_check_consistency_and_environment():
    x = onp.random.RandomState(0).randn(3, 4).astype("float32")
    test_utils.check_consistency(lambda t: (t * 2).sum(axis=0), [x],
                                 devices=[mx.cpu(), mx.cpu()])
    test_utils.check_consistency(lambda t: np.tanh(t), [x])
    with test_utils.environment({"MXNET_TEST_A": "1", "MXNET_TEST_B": None}):
        assert util.getenv("MXNET_TEST_A") == "1" and util.getenv("MXNET_TEST_B") is None
    assert util.getenv("MXNET_TEST_A") is None
    with test_utils.environment("MXNET_TEST_A", "2"):
        assert util.getenv("MXNET_TEST_A") == "2"


@pytest.mark.parametrize("stype", ["default", "row_sparse", "csr"])
def test_rand_ndarray_stypes(stype):
    onp.random.seed(3)
    a = test_utils.rand_ndarray((6, 5), stype=stype, density=0.5)
    assert a.shape == (6, 5) and a.stype == stype
    dense = a.asnumpy() if stype == "default" else a.todense().asnumpy()
    if stype == "row_sparse":
        assert sorted(a.indices.asnumpy().tolist()) == \
            onp.nonzero(onp.any(dense != 0, axis=1))[0].tolist()
    if stype == "csr":
        onp.testing.assert_array_equal(mx.sparse.csr_matrix(dense).asnumpy(), dense)


# ------------------------------------------------------------ visualization

def _net(pkg):
    pkg.random.seed(0)
    nn = pkg.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Conv2D(8, 3, padding=1, in_channels=3), nn.BatchNorm(in_channels=8),
            nn.Activation("relu"), nn.MaxPool2D(2), nn.Flatten(), nn.Dense(10))
    net.initialize()
    return net


def test_print_summary_shapes_and_params(capsys):
    out = mx.visualization.print_summary(_net(mx), (2, 3, 8, 8))
    assert "Conv2D" in out and "(2, 8, 8, 8)" in out
    assert "Dense" in out and "(2, 10)" in out
    assert "224" in out and "1,290" in out and "Total params" in out
    assert capsys.readouterr().out
    assert out == jmx.visualization.print_summary(_net(jmx), (2, 3, 8, 8))


def test_plot_network_dot(tmp_path):
    g = mx.viz.plot_network(_net(mx), (2, 3, 8, 8), title="testnet")
    src = g.source
    assert src.startswith('digraph "testnet"') and src.rstrip().endswith("}")
    assert src.count("->") == 6
    assert src == jmx.viz.plot_network(_net(jmx), (2, 3, 8, 8), title="testnet").source
    f = g.save(str(tmp_path / "net.dot"))
    assert open(f).read() == src


def test_summary_on_hybridized_net():
    """Hooks see the children of a hybridized net that has run; its cached
    executor is back afterwards."""
    net = _net(mx)
    net.hybridize()
    x = np.array(onp.zeros((1, 3, 8, 8), "float32"))
    net(x)
    out = mx.visualization.print_summary(net, x)
    assert "Conv2D" in out and "1,290" in out and "MaxPool2D" in out
    assert net._active


def test_works_with_custom_forward():
    outs = []
    for pkg in (mx, jmx):
        nn = pkg.gluon.nn

        class Residual(nn.HybridBlock):
            def __init__(self):
                super().__init__()
                self.fc1 = nn.Dense(8, in_units=8)
                self.fc2 = nn.Dense(8, in_units=8)

            def forward(self, x):
                return x + self.fc2(self.fc1(x))

        pkg.random.seed(0)
        net = Residual()
        net.initialize()
        outs.append(pkg.visualization.print_summary(net, (2, 8)))
    assert outs[0].count("Dense") == 2
    assert outs[0] == outs[1]
