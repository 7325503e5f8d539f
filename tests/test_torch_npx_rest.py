"""The rest of ``npx`` in the port against the JAX package on the CPU:
``foreach``, ``while_loop`` and ``cond`` case for case as
``tests/test_dynamic_and_controlflow.py`` holds them in the JAX package,
the special functions, the samplers, ``savez`` and the stubs that raise.

Tolerances: control-flow outputs and gradients within 1e-6 (relative, a
0.1 floor), the special functions within 5e-6 relative (0.1 floor) in
f32, where XLA's f32 lgamma and digamma approximations differ from
torch's by up to 48 ulps near lgamma's zeros (2.4e-6 relative at the
floor, read on this test's inputs), and 1e-12 in f64; the samplers bit
for bit for one seed, except ``normal_n``: the same uniform bits, through
an erfinv whose f32 log1p is torch's and not XLA's, within 2 ulps.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag, np as jnp_, npx as jnpx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd as tag, np as tnp, npx as tnpx
from mxnet_tpu_torch.base import MXNetError


@pytest.fixture(autouse=True)
def on_cpu():
    """The CPU device, and one torch thread: these tensors are tiny, and
    the suite runs in parallel workers that share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with mx.cpu():
            yield
    finally:
        torch.set_num_threads(threads)


def close(got, want, tol=1e-6):
    got, want = onp.asarray(got, onp.float64), onp.asarray(want, onp.float64)
    assert got.shape == want.shape
    assert onp.all(onp.abs(got - want) <= tol * onp.maximum(onp.abs(want), 1e-1))


# ---------------------------------------------------------------- control flow
def _both(fn):
    """``fn(np, npx, autograd)`` run on each package."""
    return fn(jnp_, jnpx, jag), fn(tnp, tnpx, tag)


def test_foreach_single_array():
    def run(np, npx, ag):
        data = np.array(onp.arange(6, dtype="float32").reshape(3, 2))

        def body(x, state):
            new = state + x
            return new * 2.0, new
        outs, final = npx.foreach(body, data, np.zeros((2,)))
        return outs.asnumpy(), final.asnumpy()
    (jo, jf), (to, tf) = _both(run)
    close(to, jo)
    close(tf, jf)
    assert to.dtype == jo.dtype and onp.allclose(tf, [6.0, 9.0])


def test_foreach_multi_data_and_states():
    def run(np, npx, ag):
        d1 = np.array(onp.ones((4, 2), dtype="float32"))
        d2 = np.array(onp.full((4, 2), 2.0, dtype="float32"))

        def body(data, states):
            a, b = data
            x, y = states
            return [a + b, a - b], [x + a, y * 1.0]
        outs, states = npx.foreach(body, [d1, d2], [np.zeros((2,)), np.ones((2,))])
        return [o.asnumpy() for o in outs] + [s.asnumpy() for s in states]
    for a, b in zip(*_both(run)):
        close(b, a)


@pytest.mark.parametrize("record", [True, False], ids=["recorded", "unrecorded"])
def test_foreach_grad(record):
    def run(np, npx, ag):
        data = np.array(onp.array([[1.0], [2.0], [3.0]], dtype="float32"))
        w = np.array(onp.array([2.0], dtype="float32"))
        w.attach_grad()

        def body(x, state):
            new = state + x * w
            return new, new
        if not record:
            outs, final = npx.foreach(body, data, np.zeros((1,)))
            return outs.asnumpy(), final.asnumpy(), None
        with ag.record():
            outs, final = npx.foreach(body, data, np.zeros((1,)))
            loss = (final * final).sum() + outs.sum()
        loss.backward()
        return outs.asnumpy(), final.asnumpy(), w.grad.asnumpy()
    j, t = _both(run)
    close(t[0], j[0])
    close(t[1], j[1])
    if record:
        close(t[2], j[2])


def test_while_loop():
    def run(np, npx, ag):
        outs, states = npx.while_loop(
            lambda i, s: i <= 5, lambda i, s: (i + s, [i + 1, s + i]),
            [np.array(onp.array([0], dtype="int64")), np.array(onp.array([1], dtype="int64"))],
            max_iterations=10)
        return outs.asnumpy(), [s.asnumpy() for s in states]
    (jo, js), (to, ts) = _both(run)
    assert to.dtype == jo.dtype and to.tolist() == jo.tolist()
    assert [s.tolist() for s in ts] == [s.tolist() for s in js] == [[6], [16]]
    assert to[6:].tolist() == [[0]] * 4


def test_while_loop_recorded_grad():
    def run(np, npx, ag):
        w = np.array(onp.array([0.5], dtype="float32"))
        w.attach_grad()
        with ag.record():
            outs, states = npx.while_loop(
                lambda x: x.sum() < 10.0, lambda x: (x, [x * 2.0 + w]),
                [np.array(onp.array([1.0], dtype="float32"))], max_iterations=20)
            loss = states[0].sum() + outs.sum()
        loss.backward()
        return outs.asnumpy(), states[0].asnumpy(), w.grad.asnumpy()
    for a, b in zip(*_both(run)):
        close(b, a)


@pytest.mark.parametrize("record", [True, False], ids=["recorded", "unrecorded"])
def test_while_loop_cond_false_at_start(record):
    def run(np, npx, ag):
        def go():
            return npx.while_loop(lambda x: x.sum() < 0.0, lambda x: (x * 2.0, [x + 1.0]),
                                  [np.array(onp.array([1.0], dtype="float32"))],
                                  max_iterations=3)
        if record:
            with ag.record():
                outs, states = go()
        else:
            outs, states = go()
        return outs.asnumpy(), states[0].asnumpy()
    (jo, js), (to, ts) = _both(run)
    assert to.shape == jo.shape == (3, 1) and to.dtype == jo.dtype
    close(to, jo)
    close(ts, js)


def test_foreach_zero_length_recorded():
    def run(np, npx, ag):
        with ag.record():
            outs, states = npx.foreach(lambda xi, s: (s + xi, s + xi),
                                       np.array(onp.zeros((0, 2), dtype="float32")),
                                       np.zeros((2,)))
        return outs.asnumpy(), states.asnumpy()
    (jo, js), (to, ts) = _both(run)
    assert to.shape == jo.shape == (0, 2) and to.dtype == jo.dtype
    close(ts, js)


def test_while_loop_requires_max_iterations():
    with pytest.raises(MXNetError):
        tnpx.while_loop(lambda x: x < 3, lambda x: (x, [x]), [tnp.ones((1,))],
                        max_iterations=None)


def test_cond():
    def run(np, npx, ag):
        a, b = np.array([1.0]), np.array([2.0])
        return [npx.cond(np.array([p]), lambda: a * 2, lambda: b * 10).asnumpy()
                for p in (1.0, 0.0)]
    (j1, j0), (t1, t0) = _both(run)
    assert t1.tolist() == j1.tolist() == [2.0] and t0.tolist() == j0.tolist() == [20.0]


def test_cond_gradient_reaches_both_branches():
    def run(np, npx, ag):
        w = np.array(onp.array([1.5, -2.0], dtype="float32"))
        w.attach_grad()
        with ag.record():
            out = npx.cond(np.array([1.0]), lambda: w * w, lambda: w * 3.0)
            out.sum().backward()
        return out.asnumpy(), w.grad.asnumpy()
    for a, b in zip(*_both(run)):
        close(b, a)


def test_foreach_in_hybridized_block():
    from mxnet_tpu.gluon.block import HybridBlock as JBlock
    from mxnet_tpu_torch.gluon.block import HybridBlock as TBlock

    def make(base, np, npx):
        class Net(base):
            def forward(self, x):
                outs, _ = npx.foreach(lambda xi, s: (s + xi, s + xi), x,
                                      np.zeros((x.shape[1],), dtype="float32"))
                return outs
        net = Net()
        net.hybridize()
        x = np.array(onp.ones((3, 2), dtype="float32"))
        return net(x).asnumpy(), net(x).asnumpy()
    j1, j2 = make(JBlock, jnp_, jnpx)
    t1, t2 = make(TBlock, tnp, tnpx)
    close(t1, j1)
    close(t2, j2)
    assert onp.allclose(t1, [[1, 1], [2, 2], [3, 3]])


# ------------------------------------------------------------ special functions
@pytest.mark.parametrize("name", ["gamma", "gammaln", "digamma"])
@pytest.mark.parametrize("dtype", ["float32", "float64", "int32"])
def test_special_functions(name, dtype):
    rng = onp.random.RandomState(0)
    x = onp.concatenate([rng.uniform(0.1, 8.0, 20), [-2.5, -0.5, -1.3, 3.0, 0.7]])
    x = (onp.abs(onp.round(x)) + 1 if dtype == "int32" else x).astype(dtype)
    want = getattr(jnpx, name)(jnp_.array(x)).asnumpy()
    got = getattr(tnpx, name)(tnp.array(x)).asnumpy()
    assert got.dtype == want.dtype
    finite = onp.isfinite(want)
    assert (onp.isfinite(got) == finite).all()
    close(got[finite], want[finite], 1e-12 if want.dtype == onp.float64 else 5e-6)


# ------------------------------------------------------------------- samplers
def test_samplers_against_jax():
    def run(mod, np, npx):
        mod.random.seed(7)
        return [npx.uniform_n(0.0, 2.0, batch_shape=(3, 2)).asnumpy(),
                npx.uniform_n(np.array(onp.zeros(4, "float32")), 1.0,
                              batch_shape=(2,)).asnumpy(),
                npx.normal_n(0.5, 2.0, batch_shape=(5,)).asnumpy(),
                npx.normal_n(np.array(onp.zeros(4, "float32")), 1.0,
                             batch_shape=(2,)).asnumpy(),
                npx.bernoulli(prob=0.3, size=(16,)).asnumpy(),
                npx.bernoulli(logit=np.array(onp.linspace(-2, 2, 8).astype("float32"))
                              ).asnumpy()]
    for i, (j, t) in enumerate(zip(run(jmx, jnp_, jnpx), run(mx, tnp, tnpx))):
        assert t.dtype == j.dtype and t.shape == j.shape
        if i in (2, 3):
            # normal: the same uniform bits through XLA's erfinv, whose f32
            # log1p differs from torch's in the last place (np.random's
            # contract): within 2 ulps
            assert (onp.abs(t.view(onp.int32) - j.view(onp.int32)) <= 2).all()
        else:
            assert t.tobytes() == j.tobytes()


def test_savez_round_trip(tmp_path):
    a, b = onp.arange(6, dtype="float32").reshape(2, 3), onp.array([1, 2], "int32")
    tnpx.savez(str(tmp_path / "t.npz"), tnp.array(a), extra=tnp.array(b))
    jnpx.savez(str(tmp_path / "j.npz"), jnp_.array(a), extra=jnp_.array(b))
    t, j = onp.load(tmp_path / "t.npz"), onp.load(tmp_path / "j.npz")
    assert sorted(t.files) == sorted(j.files)
    for k in t.files:
        assert t[k].dtype == j[k].dtype and t[k].tobytes() == j[k].tobytes()


@pytest.mark.parametrize("name", ["multibox_prior", "gamma_sampling_stub"])
def test_stubs_raise_as_jax(name):
    with pytest.raises(jmx.MXNetError):
        getattr(jnpx, name)()
    with pytest.raises(MXNetError):
        getattr(tnpx, name)()


def test_namespace_extras():
    assert tnpx.next_key().shape == (2,)
    from typing import Tuple
    assert tnpx.Tuple is Tuple
