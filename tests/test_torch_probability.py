"""``gluon.probability`` parity on the CPU: every distribution of the
port's ``distributions.py`` against the JAX package's on the same numpy
parameters, and the draws of one key (``mx.random.seed``) against JAX's.

Tolerances: densities, statistics and draws within 1e-6 of max(1, |JAX|)
(1e-5 where ``lgamma`` / ``digamma`` enter: Gamma, Chi2, Beta, Dirichlet,
StudentT, Poisson, Binomial, the relaxed one-hot and their KL terms: torch's
and XLA's special functions differ in the last places); draws follow
``_samplers``' contract (JAX's uniform bits, the same accept / reject
decisions), dtypes and shapes exact (the JAX package enables x64:
continuous draws are f64). Also: the KL pairs of JAX's registry, the
transformations' maps and log-det-Jacobians, ``StochasticBlock``, a
reparameterized sample's gradient, and one step of ``chip_smoke``'s VAE
(pytorch/examples' widths) whose loss and gradients are within 1e-5 of
JAX's.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon import probability as JP

import chip_smoke
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon import probability as TP

TOL, SPECIAL_TOL = 1e-6, 1e-5
SPECIAL = {"Gamma", "Chi2", "Beta", "Dirichlet", "StudentT", "Poisson", "PoissonLarge",
           "Binomial", "RelaxedOneHot"}


@pytest.fixture(autouse=True)
def on_cpu():
    torch.set_num_threads(1)
    with mx.cpu():
        yield


def _pos(rng, *shape):
    return (rng.rand(*shape) + 0.5).astype("float32")


def _simplex(rng, *shape):
    x = _pos(rng, *shape)
    return x / x.sum(-1, keepdims=True)


# name -> (build(P, arr, rng), value(rng))
CASES = {
    "Normal": (lambda P, a, r: P.Normal(a(_pos(r, 3)), a(_pos(r, 3))), lambda r: _pos(r, 3)),
    "HalfNormal": (lambda P, a, r: P.HalfNormal(a(_pos(r, 3))), lambda r: _pos(r, 3)),
    "Laplace": (lambda P, a, r: P.Laplace(a(_pos(r, 3)), a(_pos(r, 3))), lambda r: _pos(r, 3)),
    "Cauchy": (lambda P, a, r: P.Cauchy(a(_pos(r, 3)), a(_pos(r, 3))), lambda r: _pos(r, 3)),
    "HalfCauchy": (lambda P, a, r: P.HalfCauchy(a(_pos(r, 3))), lambda r: _pos(r, 3)),
    "Uniform": (lambda P, a, r: P.Uniform(a(_pos(r, 3) - 1), a(_pos(r, 3) + 1)),
                lambda r: _pos(r, 3)),
    "Exponential": (lambda P, a, r: P.Exponential(a(_pos(r, 3))), lambda r: _pos(r, 3)),
    "Gamma": (lambda P, a, r: P.Gamma(a(_pos(r, 3) * 2), a(_pos(r, 3))), lambda r: _pos(r, 3)),
    "Beta": (lambda P, a, r: P.Beta(a(_pos(r, 3)), a(_pos(r, 3))), lambda r: _pos(r, 3) / 2),
    "Chi2": (lambda P, a, r: P.Chi2(a(_pos(r, 3) * 3)), lambda r: _pos(r, 3)),
    "Dirichlet": (lambda P, a, r: P.Dirichlet(a(_pos(r, 2, 4))), lambda r: _simplex(r, 2, 4)),
    "StudentT": (lambda P, a, r: P.StudentT(a(_pos(r, 3) * 4), a(_pos(r, 3)), a(_pos(r, 3))),
                 lambda r: _pos(r, 3)),
    "Gumbel": (lambda P, a, r: P.Gumbel(a(_pos(r, 3)), a(_pos(r, 3))), lambda r: _pos(r, 3)),
    "Pareto": (lambda P, a, r: P.Pareto(a(_pos(r, 3) * 2), a(_pos(r, 3) / 2)),
               lambda r: _pos(r, 3) + 1),
    "MultivariateNormal": (lambda P, a, r: P.MultivariateNormal(
        a(_pos(r, 3)), cov=a(onp.eye(3, dtype="float32") * 2 + 0.3)), lambda r: _pos(r, 3)),
    "Bernoulli": (lambda P, a, r: P.Bernoulli(prob=a(_pos(r, 3) / 2)),
                  lambda r: onp.array([0.0, 1.0, 1.0], "float32")),
    "BernoulliLogit": (lambda P, a, r: P.Bernoulli(logit=a(_pos(r, 3) - 1)),
                       lambda r: onp.array([1.0, 0.0, 1.0], "float32")),
    "Geometric": (lambda P, a, r: P.Geometric(prob=a(_pos(r, 3) / 2)),
                  lambda r: onp.array([0.0, 2.0, 3.0], "float32")),
    "Poisson": (lambda P, a, r: P.Poisson(a(_pos(r, 3) * 5)),
                lambda r: onp.array([0.0, 2.0, 3.0], "float32")),
    "PoissonLarge": (lambda P, a, r: P.Poisson(a(_pos(r, 3) * 20 + 10)),
                     lambda r: onp.array([10.0, 20.0, 31.0], "float32")),
    "Binomial": (lambda P, a, r: P.Binomial(a(onp.array([5.0, 7.0, 3.0], "float32")),
                                            prob=a(_pos(r, 3) / 2)),
                 lambda r: onp.array([1.0, 2.0, 3.0], "float32")),
    "Categorical": (lambda P, a, r: P.Categorical(prob=a(_simplex(r, 2, 4))),
                    lambda r: onp.array([1.0, 3.0], "float32")),
    "OneHotCategorical": (lambda P, a, r: P.OneHotCategorical(logit=a(_pos(r, 2, 4))),
                          lambda r: onp.eye(4, dtype="float32")[[1, 3]]),
    "RelaxedBernoulli": (lambda P, a, r: P.RelaxedBernoulli(a(onp.float32(0.5)),
                                                            logit=a(_pos(r, 3))),
                         lambda r: _pos(r, 3) / 2),
    "RelaxedOneHot": (lambda P, a, r: P.RelaxedOneHotCategorical(a(onp.float32(0.7)),
                                                                 logit=a(_pos(r, 2, 4))),
                      lambda r: _simplex(r, 2, 4)),
}


def _props(d, value, npmod):
    out = {}
    for name in ("log_prob", "prob", "cdf", "icdf"):
        arg = value if name != "icdf" else onp.clip(value / 2, 0.05, 0.95).astype("float32")
        fn = getattr(d, name)
        if not callable(fn):        # a parameter of that name (Bernoulli's prob)
            continue
        try:
            out[name] = fn(npmod.array(arg)).asnumpy()
        except NotImplementedError:
            pass
    for name in ("mean", "variance", "stddev"):
        try:
            out[name] = getattr(d, name).asnumpy()
        except NotImplementedError:
            pass
    try:
        out["entropy"] = d.entropy().asnumpy()
    except NotImplementedError:
        pass
    out["sample"] = d.sample((2,)).asnumpy()
    out["sample_n"] = d.sample_n(2).asnumpy()
    return out


def _both(build, value_fn=None, seed=7):
    rng = onp.random.RandomState(1)
    jmx.random.seed(seed)
    jd = build(JP, jmx.np.array, rng)
    rng = onp.random.RandomState(1)
    mx.random.seed(seed)
    td = build(TP, mx.np.array, rng)
    return jd, td


def _close(got, want, tol, what):
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (what, got.shape, got.dtype, want.shape, want.dtype)
    g, w = got.astype("float64"), want.astype("float64")
    assert (onp.isnan(g) == onp.isnan(w)).all(), what
    fin = onp.isfinite(w)
    assert (g[~fin] == w[~fin]).all(), what
    err = onp.abs(g[fin] - w[fin]) / onp.maximum(1.0, onp.abs(w[fin]))
    assert err.size == 0 or err.max() <= tol, (what, float(err.max()))


@pytest.mark.parametrize("name", sorted(CASES))
def test_distribution_matches_jax(name):
    """Every density, statistic and draw of the distribution."""
    build, value_fn = CASES[name]
    jd, td = _both(build)
    value = value_fn(onp.random.RandomState(2))
    jmx.random.seed(3)
    want = _props(jd, value, jmx.np)
    mx.random.seed(3)
    got = _props(td, value, mx.np)
    assert sorted(got) == sorted(want)
    tol = SPECIAL_TOL if name in SPECIAL else TOL
    for key in want:
        _close(got[key], want[key], tol, f"{name}.{key}")


KL_PAIRS = {
    "Normal": lambda P, a, r: P.Normal(a(_pos(r, 3)), a(_pos(r, 3))),
    "Bernoulli": lambda P, a, r: P.Bernoulli(prob=a(_pos(r, 3) / 2)),
    "Categorical": lambda P, a, r: P.Categorical(logit=a(_pos(r, 2, 4))),
    "Uniform": lambda P, a, r: P.Uniform(a(_pos(r, 3) - 1.5), a(_pos(r, 3) + 1.5)),
    "Exponential": lambda P, a, r: P.Exponential(a(_pos(r, 3))),
    "Gamma": lambda P, a, r: P.Gamma(a(_pos(r, 3) * 2), a(_pos(r, 3))),
    "Laplace": lambda P, a, r: P.Laplace(a(_pos(r, 3)), a(_pos(r, 3))),
    "Beta": lambda P, a, r: P.Beta(a(_pos(r, 3)), a(_pos(r, 3))),
    "Dirichlet": lambda P, a, r: P.Dirichlet(a(_pos(r, 2, 4))),
    "Gumbel": lambda P, a, r: P.Gumbel(a(_pos(r, 3)), a(_pos(r, 3))),
}


def test_kl_registry_covers_jax():
    from mxnet_tpu.gluon.probability import distributions as jdist
    from mxnet_tpu_torch.gluon.probability import distributions as tdist
    names = sorted(a.__name__ for a, _ in jdist._KL_REGISTRY)
    assert names == sorted(a.__name__ for a, _ in tdist._KL_REGISTRY)
    assert names == sorted(KL_PAIRS)


@pytest.mark.parametrize("name", sorted(KL_PAIRS))
def test_kl_divergence_matches_jax(name):
    build = KL_PAIRS[name]
    jp, tp = _both(build)
    rng = onp.random.RandomState(5)
    jq = build(JP, jmx.np.array, rng)
    rng = onp.random.RandomState(5)
    tq = build(TP, mx.np.array, rng)
    want = JP.kl_divergence(jp, jq).asnumpy()
    got = TP.kl_divergence(tp, tq).asnumpy()
    _close(got, want, SPECIAL_TOL if name in SPECIAL else TOL, name)
    with pytest.raises(MXNetError, match="no KL"):
        TP.kl_divergence(tp, TP.Cauchy(0.0, 1.0))


TRANSFORMS = {
    "Exp": lambda P: P.ExpTransform(),
    "Affine": lambda P: P.AffineTransform(2.0, 3.0),
    "Power": lambda P: P.PowerTransform(2.0),
    "Sigmoid": lambda P: P.SigmoidTransform(),
    "Compose": lambda P: P.ComposeTransform([P.AffineTransform(0.5, 2.0), P.ExpTransform()]),
    "Abs": lambda P: P.AbsTransform(),
    "Softmax": lambda P: P.SoftmaxTransform(),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transformation_matches_jax(name):
    """The map, its inverse and (where defined) log |det J|."""
    x = _pos(onp.random.RandomState(4), 2, 3)
    jt, tt = TRANSFORMS[name](JP), TRANSFORMS[name](TP)
    y = jt(jmx.np.array(x)).asnumpy()
    _close(tt(mx.np.array(x)).asnumpy(), y, TOL, "forward")
    _close(tt.inv(mx.np.array(y)).asnumpy(), jt.inv(jmx.np.array(y)).asnumpy(), TOL, "inv")
    if name not in ("Abs", "Softmax"):
        _close(tt.log_det_jacobian(mx.np.array(x)).asnumpy(),
               jt.log_det_jacobian(jmx.np.array(x)).asnumpy(), TOL, "ldj")
    assert (tt.bijective, tt.event_dim) == (jt.bijective, jt.event_dim)


def test_transformed_and_independent_match_jax():
    def build(P, a, r):
        base = P.Normal(a(_pos(r, 3)), a(_pos(r, 3)))
        return (P.TransformedDistribution(base, [P.AffineTransform(1.0, 2.0),
                                                 P.ExpTransform()]),
                P.Independent(P.Normal(a(_pos(r, 2, 3)), a(_pos(r, 2, 3))), 1))
    (jtd, jind), (ttd, tind) = _both(build)
    v = _pos(onp.random.RandomState(6), 3) * 3
    _close(ttd.log_prob(mx.np.array(v)).asnumpy(), jtd.log_prob(jmx.np.array(v)).asnumpy(),
           TOL, "transformed.log_prob")
    jmx.random.seed(9)
    mx.random.seed(9)
    _close(ttd.sample((2,)).asnumpy(), jtd.sample((2,)).asnumpy(), TOL, "transformed.sample")
    w = _pos(onp.random.RandomState(6), 2, 3)
    _close(tind.log_prob(mx.np.array(w)).asnumpy(), jind.log_prob(jmx.np.array(w)).asnumpy(),
           TOL, "independent.log_prob")
    assert tind.event_dim == jind.event_dim == 1


def test_reparameterized_sample_differentiates_on_the_tape():
    """d sample / d loc and d scale of a Normal draw, recorded, equal the
    JAX package's."""
    grads = []
    for pkg, P in ((jmx, JP), (mx, TP)):
        ad = jautograd if pkg is jmx else autograd
        pkg.random.seed(11)
        loc = pkg.np.array(onp.array([0.5, -1.0, 2.0], "float32"))
        scale = pkg.np.array(onp.array([1.0, 0.5, 2.0], "float32"))
        loc.attach_grad()
        scale.attach_grad()
        with ad.record():
            s = P.Normal(loc, scale).sample((4,))
            total = (s * s).sum()
        total.backward()
        grads.append((loc.grad.asnumpy(), scale.grad.asnumpy()))
    for got, want in zip(grads[1], grads[0]):
        _close(got, want, TOL, "grad")


def test_stochastic_block_losses_and_hybridize():
    net = chip_smoke.vae_block(TP, nn, mx.np, (12, 8, 3))
    net.initialize()
    with pytest.raises(MXNetError, match="collect losses"):
        net.losses
    net(mx.np.array(onp.random.RandomState(0).rand(2, 12).astype("float32")))
    assert len(net.losses) == 1 and net.losses[0].shape == (2,)
    with pytest.raises(MXNetError, match="cannot be hybridized"):
        net.hybridize()
    assert issubclass(TP.DeterministicBlock, mx.gluon.HybridBlock)


def test_vae_step_matches_jax():
    """One step of ``chip_smoke``'s VAE at pytorch/examples' widths (784-
    400-20-400-784), B 8, from the same weights, data and keys: the loss
    and every parameter's gradient within 1e-5 of JAX's."""
    from mxnet_tpu_torch import interop
    x = chip_smoke.vae_data(0, 8, 1)[0]
    out = {}
    for pkg, P, m, ad in ((jmx, JP, jnn, jautograd), (mx, TP, nn, autograd)):
        pkg.random.seed(0)
        net = chip_smoke.vae_block(P, m, pkg.np)
        net.initialize()
        if pkg is mx:
            interop.params_from_numpy(net, out["jax_weights"])
        else:
            out["jax_weights"] = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
        pkg.random.seed(1)
        xa = pkg.np.array(x)
        with ad.record():
            logits = net(xa)
            loss = chip_smoke.vae_loss(pkg.np, logits, xa, net.losses[0])
        loss.backward()
        out[pkg.__name__] = (float(loss.asnumpy()), {k: p.grad().asnumpy() for k, p in
                                                      net.collect_params().items()})
    (jl, jg), (tl, tg) = out["mxnet_tpu"], out["mxnet_tpu_torch"]
    assert abs(tl - jl) <= SPECIAL_TOL * max(1.0, abs(jl))
    assert sorted(tg) == sorted(jg)
    for k in jg:
        assert onp.abs(tg[k] - jg[k]).max() <= SPECIAL_TOL * max(1.0, onp.abs(jg[k]).max()), k


def test_namespace_matches_jax():
    import mxnet_tpu.gluon.probability as jprob
    names = {n for n in dir(jprob) if not n.startswith("_") and n[0].isupper()}
    assert names <= set(dir(TP))
    assert mx.gluon.probability is TP
