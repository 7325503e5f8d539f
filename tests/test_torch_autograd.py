"""Port parity of the autograd tape: the cases of ``tests/test_autograd.py``
on the same inputs through ``mxnet_tpu`` (JAX on the CPU) and
``mxnet_tpu_torch`` under ``with mx.cpu():``, gradients and their dtypes
asserted equal to the JAX package's (exact for these polynomial graphs;
through tanh 1e-5 relative and 1e-7 absolute: 1 - tanh^2 magnifies the
last-place difference of the two tanh). Then the port's own contract: only ops inside
``record()`` are on the tape, ``grad_req='write'`` overwrites the buffer
in place, a second ``backward`` without ``retain_graph`` raises, writes
are out of place, and ``mx.ops.attention`` on the tape reaches the flash
route's backward (the plain K2 on the CPU), its gradients within 1e-4 of
the JAX package's."""
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import np as jnp_

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, np
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import int8_gemv


@pytest.fixture(autouse=True)
def on_cpu():
    with mx.cpu():
        yield


PORT, JAX = (np, autograd, mx), (jnp_, jag, jmx)


def same(t, j, rtol=0.0):
    ta, ja = t.asnumpy(), j.asnumpy()
    assert ta.dtype == ja.dtype, (ta.dtype, ja.dtype)
    if rtol:
        onp.testing.assert_allclose(ta, ja, rtol=rtol, atol=1e-7)
    else:
        onp.testing.assert_array_equal(ta, ja)


def both(fn, rtol=0.0):
    outs_t, outs_j = fn(*PORT), fn(*JAX)
    for t, j in zip(outs_t, outs_j):
        same(t, j, rtol)


def test_simple_backward():
    def run(m, ag, _):
        x = m.array([1.0, 2.0, 3.0])
        x.attach_grad()
        with ag.record():
            y = (x * x).sum()
        y.backward()
        return [x.grad, y]
    both(run)


def test_chain_and_broadcast():
    def run(m, ag, _):
        x = m.array([[1.0, 2.0], [3.0, 4.0]])
        w = m.array([[0.5, -0.5], [1.0, 1.0]])
        x.attach_grad()
        w.attach_grad()
        with ag.record():
            z = m.tanh(x @ w).sum()
        z.backward()
        return [x.grad, w.grad]
    both(run, rtol=1e-5)


def test_grad_req_add_and_zero():
    def run(m, ag, _):
        x = m.array([2.0])
        x.attach_grad(grad_req="add")
        for _ in range(3):
            with ag.record():
                y = x * x
            y.backward()
        g = x.grad.copy()
        x.zero_grad()
        return [g, x.grad]
    both(run)


def test_backward_out_grad():
    def run(m, ag, _):
        x = m.array([1.0, 2.0])
        x.attach_grad()
        with ag.record():
            y = 3.0 * x
        y.backward(m.array([10.0, 100.0]))
        return [x.grad]
    both(run)


def test_detach_stops_gradient():
    def run(m, ag, _):
        x = m.array([3.0])
        x.attach_grad()
        with ag.record():
            y = x * x
            z = y.detach() * x
        z.backward()
        return [x.grad]
    both(run)


def test_pause_scope():
    def run(m, ag, _):
        x = m.array([1.0])
        x.attach_grad()
        with ag.record():
            y = x * 2
            with ag.pause():
                w = x * 100
            z = y + w.detach()
        z.backward()
        return [x.grad, z]
    both(run)


def test_training_modes():
    for ag in (autograd, jag):
        assert not ag.is_training() and not ag.is_recording()
        with ag.record():
            assert ag.is_training() and ag.is_recording()
            with ag.predict_mode():
                assert not ag.is_training() and ag.is_recording()
        with ag.record(train_mode=False):
            assert not ag.is_training()
        with ag.train_mode():
            assert ag.is_training() and not ag.is_recording()


def test_autograd_grad_function():
    def run(m, ag, _):
        x = m.array([2.0])
        x.attach_grad()
        with ag.record():
            y = x * x * x
        (g,) = ag.grad([y], [x], create_graph=False)
        return [g]
    both(run)


def test_higher_order_grad():
    def run(m, ag, _):
        x = m.array([2.0])
        x.attach_grad()
        with ag.record():
            y = x * x * x
            (g,) = ag.grad([y], [x], create_graph=True)
            z = g.sum()
        z.backward()
        return [g, x.grad]
    both(run)


def test_getitem_setitem_grad():
    """Slices on the tape, and an out-of-place write: the recorded product
    keeps the value it read."""
    def run(m, ag, _):
        x = m.array([1.0, 2.0, 3.0])
        x.attach_grad()
        with ag.record():
            y = x[1:] * 2
            s = y.sum()
        s.backward()
        g1 = x.grad.copy()
        a = m.array([1.0, 2.0, 3.0])
        a.attach_grad()
        with ag.record():
            b = a * 1.0
            c = b * b
            b[0] = 10.0
            d = (c + b).sum()
        d.backward()
        return [g1, a.grad, d]
    both(run)


def test_custom_function():
    results = []
    for m, ag, _ in (PORT, JAX):
        class MySquare(ag.Function):
            def forward(self, x):
                self.save_for_backward(x)
                return x * x

            def backward(self, dy):
                (x,) = self.saved_tensors
                return dy * 7.0 * x     # a wrong constant proves the custom path

        x = m.array([3.0])
        x.attach_grad()
        with ag.record():
            y = MySquare()(x)
        y.backward()
        results.append(x.grad)
    same(*results)
    assert results[0].asnumpy().tolist() == [21.0]


def test_multi_output_op_grad():
    def run(m, ag, _):
        x = m.arange(6)
        x.attach_grad()
        with ag.record():
            parts = m.split(x, 3)
            z = parts[0].sum() + (parts[2] * 2).sum()
        z.backward()
        return [x.grad]
    both(run)


# -------------------------------------------------------- the port's contract

def test_ops_outside_record_build_no_graph():
    x = np.array([1.0, 2.0])
    x.attach_grad()
    y = x * 2
    assert y._data.grad_fn is None and not y._data.requires_grad
    with pytest.raises(MXNetError, match="cannot differentiate"):
        y.backward()
    with autograd.record():
        z = x * 3
    assert z._data.grad_fn is not None


def test_write_overwrites_cached_grad_buffer():
    x = np.array([1.0, 2.0])
    x.attach_grad()
    g = x.grad
    for k in (2.0, 5.0):
        with autograd.record():
            y = (x * k).sum()
        y.backward()
        assert x.grad is g and g.asnumpy().tolist() == [k, k]


def test_second_backward_needs_retain_graph():
    for m, ag, jm in (PORT, JAX):
        x = m.array([1.0, 2.0])
        x.attach_grad()
        with ag.record():
            y = (x * x).sum()
        y.backward(retain_graph=True)
        y.backward()
        with pytest.raises(jm.MXNetError):
            y.backward()


def test_attach_grad_detaches():
    x = np.array([1.0, 2.0])
    x.attach_grad()
    with autograd.record():
        y = x * 3
    y.attach_grad()
    with autograd.record():
        z = (y * y).sum()
    z.backward()
    assert y.grad.asnumpy().tolist() == [6.0, 12.0]
    assert x.grad.asnumpy().tolist() == [0.0, 0.0]


def test_mark_variables():
    x = np.array([1.0, 2.0])
    g = np.zeros((2,))
    autograd.mark_variables([x], [g])
    with autograd.record():
        y = (x * x).sum()
    autograd.backward(y)
    assert g.asnumpy().tolist() == [2.0, 4.0]


def test_attention_on_the_tape():
    """``mx.ops.attention`` inside ``record()`` at T 256 takes the flash
    route (the plain K1/K2 on the CPU, counted as launches); gradients
    within 1e-4 of the JAX package's."""
    T = 256
    rng = onp.random.RandomState(T)
    q, k, v = (rng.randn(1, 2, T, 16).astype("float32") * 0.5 for _ in range(3))
    do = rng.randn(1, 2, T, 16).astype("float32")
    grads = []
    for m, ag, mxm in (PORT, JAX):
        arrs = [m.array(a) for a in (q, k, v)]
        for a in arrs:
            a.attach_grad()
        int8_gemv.reset_launches()
        with ag.record():
            o = mxm.ops.attention(*arrs, causal=True)
            loss = (o * m.array(do)).sum()
        loss.backward()
        grads.append([o] + [a.grad for a in arrs])
        if mxm is mx:
            assert int8_gemv.launches().get("flash_fwd") == 1
            assert int8_gemv.launches().get("flash_bwd") == 1
    for t, j in zip(*grads):
        assert t.dtype == j.dtype
        onp.testing.assert_allclose(t.asnumpy(), j.asnumpy(), rtol=1e-4, atol=1e-4)
