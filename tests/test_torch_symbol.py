"""``mx.sym`` parity on the CPU: the port's ``symbol`` against the JAX
package's: the same graphs built in both serialize to the same ``tojson``
string (the example program's and a generated-tier op's), each
package's ``load_json`` reads the other's, and ``Executor`` forward
outputs and backward gradients agree within 1e-6 of the JAX output's
scale (f32; the same op sequence in both). ``examples/symbol_api.py``
runs unedited with the port as ``mxnet_tpu``: its printed accuracy and
graph equal the JAX package's run.
"""
import contextlib
import io
import runpy
import sys

import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import np as jnp_
from mxnet_tpu import symbol as jsym

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import np
from mxnet_tpu_torch import symbol as tsym

TOL = 1e-6


@pytest.fixture(autouse=True)
def on_cpu():
    torch.set_num_threads(1)
    with mx.cpu():
        yield


def fresh_names():
    """Both packages' auto-name and constant counters from zero, so graphs
    built the same way get the same node names."""
    for mod in (jsym, tsym):
        mod._NAME_COUNTER.clear()
        mod._CONST_COUNTER[0] = 0


def scaled_err(got, want):
    got, want = (onp.asarray(a, onp.float64) for a in (got, want))
    assert got.shape == want.shape
    return float(onp.abs(got - want).max() / max(onp.abs(want).max(), 1.0))


def _example_graph(sym):
    data = sym.Variable("data")
    w1, b1 = sym.Variable("w1"), sym.Variable("b1")
    w2 = sym.Variable("w2")
    net = sym.Activation(sym.FullyConnected(data, w1, b1, num_hidden=32), act_type="relu")
    net = sym.FullyConnected(net, w2, num_hidden=3, no_bias=True)
    return sym.SoftmaxOutput(net, sym.Variable("label"))


def _generated_graph(sym):
    a = sym.Variable("a")
    return sym.tanh(sym.exp(a * 0.5)) + 1.0


def _auto_params_graph(sym):
    data = sym.Variable("data")
    h = sym.FullyConnected(data, num_hidden=4)
    h = sym.BatchNorm(h)
    return sym.SoftmaxOutput(h)


GRAPHS = {"example": _example_graph, "generated": _generated_graph,
          "auto_params": _auto_params_graph}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_tojson_equal_and_cross_load(name):
    """Same graph, same JSON; each package's ``load_json`` reads the
    other's string back to the same JSON."""
    fresh_names()
    text_j = GRAPHS[name](jsym).tojson()
    fresh_names()
    text_t = GRAPHS[name](tsym).tojson()
    assert text_t == text_j
    assert tsym.load_json(text_j).tojson() == text_j
    assert jsym.load_json(text_t).tojson() == text_t


def _bind_run(sym, npmod, graph_fn, args, is_train, head_grad=None):
    fresh_names()
    out = graph_fn(sym)
    ex = out.bind(args={k: npmod.array(v) for k, v in args.items()})
    outs = ex.forward(is_train=is_train)
    grads = {}
    if is_train:
        ex.backward(None if head_grad is None else npmod.array(head_grad))
        grads = {k: g.asnumpy() for k, g in ex.grad_dict.items() if g is not None}
    return [o.asnumpy() for o in outs], grads, out.list_arguments(), out.list_outputs()


def _cases():
    rs = onp.random.RandomState(0)
    f = lambda *s: rs.randn(*s).astype("float32")  # noqa: E731
    X = f(6, 16)
    return {
        "example": (_example_graph, {"data": X, "label": onp.array([0, 1, 2, 0, 1, 2], "f4"),
                                     "w1": f(32, 16) * 0.2, "b1": f(32) * 0.1,
                                     "w2": f(3, 32) * 0.2}, None),
        "generated": (_generated_graph, {"a": f(3, 4)}, onp.ones((3, 4), "f4")),
        "conv_pool": (lambda s: s.Flatten(s.Pooling(s.Convolution(
            s.Variable("data"), s.Variable("w"), kernel=(3, 3), num_filter=4, pad=(1, 1),
            no_bias=True), kernel=(2, 2), stride=(2, 2), pool_type="max")),
            {"data": f(2, 3, 8, 8), "w": f(4, 3, 3, 3)}, onp.ones((2, 64), "f4")),
        "batchnorm": (lambda s: s.BatchNorm(s.Variable("x"), s.Variable("g"), s.Variable("b"),
                                            s.Variable("m"), s.Variable("v")),
                      {"x": f(4, 3, 2, 2), "g": f(3), "b": f(3),
                       "m": onp.zeros(3, "f4"), "v": onp.ones(3, "f4")},
                      f(4, 3, 2, 2)),
        "slice_group": (lambda s: s.Group([s.SliceChannel(s.Variable("x"), num_outputs=2)[1],
                                           s.Variable("x") * 2.0]),
                        {"x": f(2, 4)}, None),
        "leaky_concat": (lambda s: s.Concat(s.LeakyReLU(s.Variable("a"), slope=0.1),
                                            s.Variable("b"), dim=1),
                         {"a": f(2, 3), "b": f(2, 2)}, onp.ones((2, 5), "f4")),
    }


@pytest.mark.parametrize("name", sorted(_cases()))
def test_executor_matches_jax(name):
    """Forward outputs, and after backward every argument's gradient
    (``SoftmaxOutput``'s implicit cross-entropy gradient included), equal
    the JAX package's."""
    graph_fn, args, head = _cases()[name]
    train = head is not None or name == "example"
    jo, jg, jargs, jouts = _bind_run(jsym, jnp_, graph_fn, args, train, head)
    to, tg, targs, touts = _bind_run(tsym, np, graph_fn, args, train, head)
    assert (targs, touts) == (jargs, jouts)
    assert len(to) == len(jo)
    for a, b in zip(to, jo):
        assert scaled_err(a, b) <= TOL
    assert sorted(tg) == sorted(jg)
    for k in jg:
        assert scaled_err(tg[k], jg[k]) <= TOL, k


def test_infer_shape_simple_bind_and_eval():
    """Partial shape inference from the data shape, ``simple_bind`` and
    one-shot ``eval`` agree with the JAX package's."""
    for sym, npmod in ((jsym, jnp_), (tsym, np)):
        fresh_names()
        out = sym.FullyConnected(sym.Variable("data"), num_hidden=7)
        args, outs, aux = out.infer_shape(data=(4, 10))
        assert (args, outs, aux) == ([(4, 10), (7, 10), (7,)], [(4, 7)], [])
        assert out.simple_bind(data=(4, 10)).forward()[0].shape == (4, 7)
        a, b = sym.Variable("a"), sym.Variable("b")
        (y,) = (a * 2.0 + b).eval(a=npmod.array([1.0, 2.0]), b=npmod.array([10.0, 20.0]))
        onp.testing.assert_allclose(y.asnumpy(), [12.0, 24.0])


def test_args_grad_buffers_and_literal_attrs():
    """Caller gradient buffers are filled after backward; ``load_json``
    keeps a non-literal attribute as a string and never evaluates it."""
    data, w = tsym.Variable("data"), tsym.Variable("w")
    out = tsym.FullyConnected(data, w, num_hidden=2, no_bias=True)
    gw = np.array(onp.zeros((2, 4), "float32"))
    ex = out.bind(args={"data": np.array(onp.ones((3, 4), "float32")),
                        "w": np.array(onp.ones((2, 4), "float32"))}, args_grad={"w": gw})
    ex.forward(is_train=True)
    ex.backward(np.array(onp.ones((3, 2), "float32")))
    onp.testing.assert_allclose(gw.asnumpy(), onp.full((2, 4), 3.0))
    import json
    doc = {"nodes": [{"op": "null", "name": "a",
                      "attrs": {"evil": "__import__('os').system('true')"}, "inputs": []}],
           "heads": [[0, 0, 0]]}
    assert tsym.load_json(json.dumps(doc)).attrs["evil"].startswith("__import__")
    assert mx.sym is tsym and mx.symbol.FullyConnected is tsym.FullyConnected


def _run_example(pkg):
    """``examples/symbol_api.py``'s ``main()`` with ``pkg`` imported as
    ``mxnet_tpu``: its printed lines and every forward's output."""
    outs = []
    forward = pkg.symbol.Executor.forward

    def spy(self, *a, **kw):
        res = forward(self, *a, **kw)
        outs.append(res[0].asnumpy())
        return res
    saved = sys.modules["mxnet_tpu"]
    sys.modules["mxnet_tpu"] = pkg
    pkg.symbol.Executor.forward = spy
    buf = io.StringIO()
    try:
        fresh_names()
        g = runpy.run_path("examples/symbol_api.py", run_name="example")
        with contextlib.redirect_stdout(buf):
            g["main"]()
    finally:
        pkg.symbol.Executor.forward = forward
        sys.modules["mxnet_tpu"] = saved
    return buf.getvalue(), outs


def test_symbol_api_example_matches_jax():
    """The example trains 80 manual-SGD steps; every step's softmax output
    is within 1e-5 of the JAX package's, and the printed accuracy and
    graph JSON are equal."""
    jtext, jouts = _run_example(jmx)
    ttext, touts = _run_example(mx)
    assert len(touts) == len(jouts) == 80
    for a, b in zip(touts, jouts):
        assert onp.abs(a - b).max() <= 1e-5
    assert ttext == jtext
