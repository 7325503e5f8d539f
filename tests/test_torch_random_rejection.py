"""Port parity of ``np.random``'s rejection samplers: ``gamma``, ``beta``,
``chisquare``, ``f``, ``binomial``, ``multinomial``, ``poisson``,
``multivariate_normal`` and ``choice(p=, replace=False)``, each drawn by
``mxnet_tpu`` (JAX on the CPU) and ``mxnet_tpu_torch`` under ``with
mx.cpu():`` after the same ``random.seed``; dtype and shape exact.

Tolerance. Both packages run jax.random's algorithms on the same key
splits, so the uniform bits and every accept or reject decision are the
same, and integer draws are equal. Continuous values are held within
1e-5 relative (at max(|x|, 1)): the transcendental functions are
numpy's and torch's, which may differ from XLA's in the last place (f64
gamma draws agree to about 1e-15). Where such a last-place difference
lands on an accept or reject boundary, that element's draw differs
altogether: the test counts those elements as flipped decisions and
allows at most 0.1% of the draws (none occur at these seeds).
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import np as jnp_

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import np

N = 4000
PV = [0.1, 0.2, 0.3, 0.4]
PV20 = (onp.arange(1, 21) / onp.arange(1, 21).sum()).tolist()
MEAN = onp.array([0.5, -1.0, 2.0], "float32")
COV = onp.array([[2.0, 0.3, 0.1], [0.3, 1.0, -0.2], [0.1, -0.2, 0.5]], "float32")
PCHOICE = (onp.linspace(1.0, 3.0, 64) / onp.linspace(1.0, 3.0, 64).sum()).astype("float32")


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


DRAWS = {
    "gamma": lambda m: m.random.gamma(2.5, 2.0, size=(N,)),
    "gamma_boosted": lambda m: m.random.gamma(0.3, size=(N,)),
    "gamma_array": lambda m: m.random.gamma(m.array(onp.array([0.5, 1.0, 4.0, 9.5], "float32"))),
    "beta": lambda m: m.random.beta(2.0, 3.0, size=(N,)),
    "beta_small": lambda m: m.random.beta(0.5, 0.4, size=(N,)),
    "chisquare": lambda m: m.random.chisquare(3.0, size=(N,)),
    "f": lambda m: m.random.f(3.0, 5.0, size=(N,)),
    "binomial_inversion": lambda m: m.random.binomial(10, 0.3, size=(N,)),
    "binomial_btrs": lambda m: m.random.binomial(100, 0.4, size=(N,)),
    "binomial_upper": lambda m: m.random.binomial(60, 0.85, size=(N,)),
    "multinomial": lambda m: m.random.multinomial(100, PV),
    "multinomial_batch": lambda m: m.random.multinomial(1000, PV20, size=(50, 20)),
    "multinomial_f32": lambda m: m.random.multinomial(30, m.array(onp.array(PV, "float32")),
                                                      size=(40, 4)),
    "poisson_knuth": lambda m: m.random.poisson(3.0, size=(N,)),
    "poisson_rejection": lambda m: m.random.poisson(30.0, size=(N,)),
    "multivariate_normal": lambda m: m.random.multivariate_normal(
        m.array(MEAN), m.array(COV), size=(N // 4,)),
    "choice_p_noreplace": lambda m: m.random.choice(64, size=(16,), replace=False,
                                                    p=m.array(PCHOICE)),
}


def _draw(name, seed=17):
    outs = []
    for m, mxm in ((np, mx), (jnp_, jmx)):
        mxm.random.seed(seed)
        outs.append(DRAWS[name](m).asnumpy())
    return outs


@pytest.mark.parametrize("name", sorted(DRAWS))
def test_rejection_sampler_matches_jax(name):
    t, j = _draw(name)
    assert t.dtype == j.dtype and t.shape == j.shape, (t.dtype, j.dtype, t.shape, j.shape)
    if onp.issubdtype(j.dtype, onp.integer) or name.startswith(("binomial", "multinomial")):
        flipped = t != j
    else:
        scale = onp.maximum(onp.abs(j.astype(onp.float64)), 1.0)
        flipped = onp.abs(t.astype(onp.float64) - j) > 1e-5 * scale
    assert flipped.sum() <= 1e-3 * j.size, (int(flipped.sum()), j.size)


def test_choice_noreplace_draws_distinct_items():
    t, j = _draw("choice_p_noreplace", seed=3)
    assert len(set(t.tolist())) == t.size
    onp.testing.assert_array_equal(t, j)


def test_samplers_follow_the_global_stream():
    """A sampler takes one key from the stream, as the JAX package's: the
    draw after it is the JAX package's next draw."""
    for m, mxm in ((np, mx), (jnp_, jmx)):
        mxm.random.seed(5)
        m.random.poisson(4.0, size=(3,))
        m.random.gamma(1.5, size=(3,))
    after = [m.random.uniform(size=(8,)).asnumpy() for m in (np, jnp_)]
    onp.testing.assert_array_equal(*after)


def test_draws_land_on_the_requested_device():
    mx.random.seed(1)
    a = np.random.gamma(2.0, size=(4,), device="cpu")
    assert a.device == mx.cpu()
    mx.random.seed(1)
    b = np.random.gamma(2.0, size=(4,))
    onp.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
