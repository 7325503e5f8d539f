"""Port parity of ``mx.operator`` (custom ops in Python) and
``mx.library`` (operator libraries behind the C extension ABI): the cases
of ``tests/test_extension_ops.py`` and ``tests/test_legacy_ops.py``'s
custom op, run through ``mxnet_tpu`` (JAX on the CPU) and
``mxnet_tpu_torch`` under ``with mx.cpu():``. The library is
``tests/ext/myops.cc``, compiled with ``g++`` into this module's
temporary directory (``tests/ext/libmyops.so`` is left as it is). Values
are exact: both packages run the same host code on the same inputs.
"""
import os
import shutil
import subprocess

import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import library as jlibrary
from mxnet_tpu import operator as joperator

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, library, np, npx
from mxnet_tpu_torch import operator as toperator
from mxnet_tpu_torch.gluon import nn

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ext", "myops.cc")
X = onp.array([[1.0, -2.0], [3.0, 0.5]], "float32")


@pytest.fixture(autouse=True)
def on_cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with mx.cpu():
            yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def so_path(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the extension library")
    out = str(tmp_path_factory.mktemp("ext") / "libmyops.so")
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", out, _SRC], check=True)
    return out


@pytest.fixture(scope="module")
def libs(so_path):
    return library.load(so_path), jlibrary.load(so_path)


def test_load_and_introspect(libs, so_path):
    lib, jlib = libs
    assert sorted(lib.ops) == sorted(jlib.ops) == ["ext_outer", "ext_square"]
    for name in lib.ops:
        assert lib.ops[name].has_backward == jlib.ops[name].has_backward
        assert (lib.ops[name].n_in, lib.ops[name].n_out) == \
            (jlib.ops[name].n_in, jlib.ops[name].n_out)
    assert so_path in library.loaded_libraries()
    assert library.load(so_path) is lib


def test_forward_eager(libs):
    lib, jlib = libs
    y, jy = lib.ext_square(np.array(X)), jlib.ext_square(jmx.np.array(X))
    onp.testing.assert_array_equal(y.asnumpy(), jy.asnumpy())
    onp.testing.assert_array_equal(npx.ext_square(np.array(X)).asnumpy(), y.asnumpy())


def test_shape_inference_op(libs):
    lib, jlib = libs
    a, b = onp.array([1.0, 2.0, 3.0], "f4"), onp.array([10.0, 20.0], "f4")
    out = lib.ext_outer(np.array(a), np.array(b))
    assert out.shape == (3, 2)
    onp.testing.assert_array_equal(out.asnumpy(),
                                   jlib.ext_outer(jmx.np.array(a), jmx.np.array(b)).asnumpy())


def test_backward_through_autograd(libs):
    lib, jlib = libs
    grads = []
    for l, pkg, ag in ((lib, mx, autograd), (jlib, jmx, jag)):
        x = pkg.np.array(onp.array([1.0, -2.0, 3.0], "f4"))
        x.attach_grad()
        with ag.record():
            y = l.ext_square(x)
            (y * pkg.np.array(onp.array([1.0, 2.0, 3.0], "f4"))).sum().backward()
        grads.append(x.grad.asnumpy())
    onp.testing.assert_array_equal(grads[0], [2.0, -8.0, 18.0])
    onp.testing.assert_array_equal(*grads)


def test_inside_hybridized_block(libs):
    lib, _ = libs

    class Net(nn.HybridBlock):
        def forward(self, x):
            return lib.ext_square(x) + 1.0

    net = Net()
    net.hybridize()
    x = np.array(onp.array([2.0, 3.0], "f4"))
    for _ in range(2):                  # the second call takes the cached entry
        onp.testing.assert_array_equal(net(x).asnumpy(), [5.0, 10.0])


def test_arity_errors(libs):
    lib, _ = libs
    with pytest.raises(mx.MXNetError, match="expects 1 inputs"):
        lib.ext_square(np.array([1.0]), np.array([2.0]))


def _register(mod, name):
    @mod.register(name)
    class SquareProp(mod.CustomOpProp):
        def list_outputs(self):
            return ["sq", "cube"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0], in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            class Sq(mod.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    x = onp.asarray(in_data[0])
                    self.assign(out_data[0], req[0], x ** 2)
                    self.assign(out_data[1], req[1], x ** 3)

                def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
                    x = onp.asarray(in_data[0])
                    in_grad[0][...] = 2 * x * onp.asarray(out_grad[0]) \
                        + 3 * x * x * onp.asarray(out_grad[1])
            return Sq()
    return SquareProp


def test_custom_op_forward_backward():
    """A registered CustomOp with two outputs, recorded: outputs and the
    input's gradient equal the JAX package's; an unknown op_type raises."""
    _register(toperator, "sq_cube_test")
    _register(joperator, "sq_cube_test")
    outs = []
    for pkg, ag in ((mx, autograd), (jmx, jag)):
        x = pkg.np.array(onp.array([1.0, 2.0, -3.0], "f4"))
        x.attach_grad()
        with ag.record():
            sq, cube = pkg.nd.Custom(x, op_type="sq_cube_test")
            (sq.sum() + 2 * cube.sum()).backward()
        outs.append([sq.asnumpy(), cube.asnumpy(), x.grad.asnumpy()])
    for t, j in zip(*outs):
        onp.testing.assert_array_equal(t, j)
    onp.testing.assert_array_equal(outs[0][2], [8.0, 28.0, 48.0])
    x = np.array(onp.array([1.0, 2.0], "f4"))
    onp.testing.assert_array_equal(npx.Custom(x, op_type="sq_cube_test")[0].asnumpy(), [1, 4])
    with pytest.raises(mx.MXNetError, match="not registered"):
        mx.nd.Custom(x, op_type="nope_never")
    assert toperator.get("sq_cube_test").__name__ == "SquareProp"
