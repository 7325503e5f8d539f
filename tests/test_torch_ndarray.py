"""Port parity of ``NDArray``, ``mx.np`` and ``mx.np.random``: the cases of
``tests/test_ndarray.py`` run on the same numpy inputs through
``mxnet_tpu`` (JAX on the CPU) and ``mxnet_tpu_torch`` under
``with mx.cpu():``, with the dtype of every result asserted equal to the
JAX package's. Values are exact unless a tolerance is stated: 1e-6
relative for float transcendental ops (torch's and XLA's last place
differ); ``np.random``'s uniform, integer, choice, permutation and
bernoulli draws bit for bit; normal draws within 4 f32 ulp at
max(|x|, scale) (XLA's erfinv polynomial over torch's log1p, which differs
from XLA's in the last place); the f64 transforms within 1e-12
relative."""
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import np as jnp_

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import np
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ndarray import NDArray


@pytest.fixture(autouse=True)
def on_cpu():
    with mx.cpu():
        yield


def same(t, j, rtol=0.0, atol=0.0):
    """Port result ``t`` against JAX result ``j``: dtype, shape and values."""
    ta, ja = t.asnumpy(), j.asnumpy()
    assert ta.dtype == ja.dtype, (ta.dtype, ja.dtype)
    assert ta.shape == ja.shape
    if rtol or atol:
        onp.testing.assert_allclose(ta, ja, rtol=rtol, atol=atol)
    else:
        onp.testing.assert_array_equal(ta, ja)


def both(fn):
    """``fn(np_module)`` for the JAX package and the port."""
    return fn(np), fn(jnp_)


def test_array_creation_defaults():
    for make in (lambda m: m.array([1, 2, 3]), lambda m: m.array(onp.array([1, 2], "int64")),
                 lambda m: m.zeros((2, 3)), lambda m: m.ones((4,), dtype=onp.int32),
                 lambda m: m.array(3), lambda m: m.array(True), lambda m: m.arange(5),
                 lambda m: m.full((2,), 7), lambda m: m.eye(3), lambda m: m.array([1.5, 2.5]),
                 lambda m: m.linspace(0, 1, 5), lambda m: m.arange(3, dtype="int32")):
        same(*both(make))


def test_arithmetic_and_broadcast():
    a = onp.array([[1.0, 2.0], [3.0, 4.0]], "float32")
    b = onp.array([10.0, 20.0], "float32")
    i = onp.array([1, 2, 3], "int32")
    for fn in (lambda m: m.array(a) + m.array(b) * 2 - 1,
               lambda m: m.array(a) @ m.array(a).T, lambda m: (m.array(a) ** 2).sum(),
               lambda m: 2.0 / m.array(a), lambda m: m.array(i) * 2.0,
               lambda m: m.array(i) / m.array(i), lambda m: m.array(i) * 2,
               lambda m: m.array(i) // 2, lambda m: m.array(i) % 2, lambda m: -m.array(i),
               lambda m: m.array(i) > 1, lambda m: m.array(a) * onp.float64(2),
               lambda m: m.maximum(m.array(a), 2.5), lambda m: m.array(a) == m.array(a)):
        same(*both(fn))
    same(*both(lambda m: m.sqrt(m.array(i))), rtol=1e-6)
    same(*both(lambda m: m.exp(m.array(a))), rtol=1e-6)


def test_indexing_get_set():
    base = onp.arange(12, dtype="float32").reshape(3, 4)

    def run(m):
        a = m.array(base)
        out = [a[1, 2], a[1], a[:, 1:3]]
        a[0, :] = 9.0
        a[2, 3] = m.array(0.5)
        out += [a, a[a > 8.0], a[m.array([0, 2], dtype=onp.int32)]]
        return out
    for t, j in zip(*both(run)):
        same(t, j)


def test_reductions_and_methods():
    base = onp.arange(6, dtype="float32").reshape(2, 3)

    def run(m):
        a = m.array(base)
        s = m.split(a, 3, axis=1)
        return [a.sum(), a.mean(axis=0), a.max(axis=1), a.argmax(axis=1), a.T,
                a.reshape(-1), m.concatenate([a, a], axis=0), m.stack([a, a]), s[0],
                a.std(), a.prod(axis=1), a.cumsum(), m.sum(a, axis=1, keepdims=True),
                a.astype("int32").sum(), a.min(), m.argmin(a)]
    for t, j in zip(*both(run)):
        same(t, j, rtol=1e-6)


def test_dtype_astype_copy():
    def run(m):
        a = m.array([1.5, 2.5])
        b = a.astype(onp.int32)
        c = a.copy()
        c[0] = 99.0
        d = m.array(a)
        d[0] = 7.0
        return [a, b, c, d]
    for t, j in zip(*both(run)):
        same(t, j)


def test_inplace_ops():
    def run(m):
        a = m.ones((3,))
        b = a
        a += 2.0
        a *= 2.0
        assert b is a
        return [b, a.sum()]
    for t, j in zip(*both(run)):
        same(t, j)


def test_device_roundtrip():
    a = np.ones((2, 2), ctx=mx.cpu())
    assert a.device.device_type == "cpu" and a.device == mx.cpu(0)
    b = a.as_in_ctx(mx.cpu(0))
    same(b, jnp_.ones((2, 2), ctx=jmx.cpu()).as_in_ctx(jmx.cpu(0)))


def test_save_load_roundtrip(tmp_path):
    """``mx.save``/``mx.load``: each package reads the other's file."""
    arrs = {"w": onp.arange(6, dtype="float32").reshape(2, 3), "b": onp.ones(4, "float32")}
    f_t, f_j = str(tmp_path / "t.params"), str(tmp_path / "j.params")
    mx.save(f_t, {k: np.array(v) for k, v in arrs.items()})
    jmx.save(f_j, {k: jnp_.array(v) for k, v in arrs.items()})
    assert open(f_t, "rb").read() == open(f_j, "rb").read()
    for k, v in jmx.load(f_t).items():
        same(mx.load(f_j)[k], v)
    mx.save(f_t, [np.ones((2,))])
    out = mx.load(f_t)
    assert isinstance(out, list) and out[0].shape == (2,)


def test_random_ops_seeded():
    def run(m, mxm):
        mxm.random.seed(42)
        a = m.random.uniform(0, 1, size=(60,))
        mxm.random.seed(42)
        b = m.random.uniform(0, 1, size=(60,))
        d = m.random.randint(0, 10, size=(60,))
        return [a, b, d]
    for t, j in zip(run(np, mx), run(jnp_, jmx)):
        same(t, j)


def test_invoke_lifts_nested_arrays():
    """The funnel's generic bridge (the JAX package's ``invoke_jnp``):
    arrays nested in arguments reach the function as tensors, and the call
    is recorded."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.ndarray import invoke
    a, b = np.array([1.0, 2.0]), np.array([3.0, 4.0])
    a.attach_grad()
    with autograd.record():
        out = invoke(lambda xs, scale: (xs[0] * xs[1] * scale).sum(), ([a, b],), {"scale": 2.0})
    out.backward()
    assert out.item() == 22.0 and a.grad.asnumpy().tolist() == [6.0, 8.0]


def test_waitall_and_wait_to_read():
    b = (np.ones((8, 8)) @ np.ones((8, 8))).wait_to_read()
    mx.waitall()
    assert b[0, 0].item() == 8.0 and b.dtype == onp.float32


def test_failure_surfaces_at_the_call():
    """An op that fails raises (the port runs each op as it is called; a
    card op's error surfaces at the latest at ``waitall``)."""
    with pytest.raises(RuntimeError):
        np.ones((2, 3)) @ np.ones((2, 3))
    mx.waitall()
    with pytest.raises(Exception):
        jnp_.ones((2, 3)) @ jnp_.ones((2, 3))


def test_dlpack_torch_interop():
    x = np.array(onp.arange(6, dtype="float32").reshape(2, 3))
    t = torch.from_dlpack(x)
    onp.testing.assert_array_equal(t.numpy(), x.asnumpy())
    back = np.from_dlpack(torch.arange(4, dtype=torch.float32) * 2)
    assert isinstance(back, NDArray)
    same(back, jnp_.from_dlpack(torch.arange(4, dtype=torch.float32) * 2))


def test_signal_handler_enabled():
    import faulthandler
    assert faulthandler.is_enabled()


def test_without_card_raises_outside_cpu_scope():
    """No silent CPU path: outside ``with mx.cpu():`` arrays go to the card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with mx.gpu():
        with pytest.raises(MXNetError, match="no CUDA device"):
            np.ones((2,))
    assert mx.current_device() == mx.cpu()


# ------------------------------------------------------------------ np.random

BITWISE_DRAWS = {
    "uniform": lambda m: m.random.uniform(-2.0, 3.0, size=(60,)),
    "uniform_f64": lambda m: m.random.uniform(size=(60,), dtype="float64"),
    "rand": lambda m: m.random.rand(60),
    "randint": lambda m: m.random.randint(-5, 1000, size=(60,)),
    "randint_int32": lambda m: m.random.randint(7, size=(60,), dtype="int32"),
    "choice": lambda m: m.random.choice(10, size=(60,)),
    "choice_noreplace": lambda m: m.random.choice(30, size=(6,), replace=False),
    "choice_p": lambda m: m.random.choice(5, size=(60,), p=[0.1, 0.2, 0.3, 0.15, 0.25]),
    "permutation": lambda m: m.random.permutation(40),
    "permutation_array": lambda m: m.random.permutation(m.array(onp.arange(12.0).reshape(6, 2))),
    "bernoulli": lambda m: m.random.bernoulli(0.3, size=(60,)),
    "bernoulli_array": lambda m: m.random.bernoulli(m.array(onp.full(60, 0.6, "float32"))),
}


@pytest.mark.parametrize("name", sorted(BITWISE_DRAWS))
def test_random_draws_bitwise(name):
    outs = []
    for m, mxm in ((np, mx), (jnp_, jmx)):
        mxm.random.seed(11)
        outs.append(BITWISE_DRAWS[name](m))
    if name == "uniform_f64":
        # one fused multiply-add in XLA, a multiply and an add here
        same(*outs, rtol=1e-15)
    else:
        same(*outs)


def test_shuffle_bitwise():
    outs = []
    for m, mxm in ((np, mx), (jnp_, jmx)):
        mxm.random.seed(5)
        a = m.array(onp.arange(24, dtype="float32").reshape(8, 3))
        m.random.shuffle(a)
        outs.append(a)
    same(*outs)


TOLERANT_DRAWS = {
    "normal": (lambda m: m.random.normal(1.0, 2.0, size=(60,)), 2.0),
    "randn": (lambda m: m.random.randn(60), 1.0),
    "exponential": (lambda m: m.random.exponential(2.0, size=(60,)), 0),
    "laplace": (lambda m: m.random.laplace(size=(60,)), 0),
    "gumbel": (lambda m: m.random.gumbel(size=(60,)), 0),
    "logistic": (lambda m: m.random.logistic(size=(60,)), 0),
    "lognormal": (lambda m: m.random.lognormal(size=(60,)), 0),
    "pareto": (lambda m: m.random.pareto(3.0, size=(60,)), 0),
    "power": (lambda m: m.random.power(3.0, size=(60,)), 0),
    "rayleigh": (lambda m: m.random.rayleigh(size=(60,)), 0),
    "weibull": (lambda m: m.random.weibull(2.0, size=(60,)), 0),
}


@pytest.mark.parametrize("name", sorted(TOLERANT_DRAWS))
def test_random_draws_within_tolerance(name):
    fn, scale = TOLERANT_DRAWS[name]
    outs = []
    for m, mxm in ((np, mx), (jnp_, jmx)):
        mxm.random.seed(13)
        outs.append(fn(m).asnumpy())
    t, j = outs
    assert t.dtype == j.dtype and t.shape == j.shape
    if scale:
        assert (onp.abs(t - j) <= 4 * onp.spacing(onp.maximum(onp.abs(j), scale))).all()
    else:
        onp.testing.assert_allclose(t, j, rtol=1e-12, atol=1e-300)


def test_rejection_samplers_wait():
    """The rejection samplers no longer wait for a later slice: a gamma
    draw is the JAX package's (f64, within 1e-12 relative;
    ``tests/test_torch_random_rejection.py`` holds all of them)."""
    outs = []
    for m, mxm in ((np, mx), (jnp_, jmx)):
        mxm.random.seed(3)
        outs.append(m.random.gamma(2.0, size=(3,)))
    same(*outs, rtol=1e-12)
