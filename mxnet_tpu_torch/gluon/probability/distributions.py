"""Distributions (counterpart of
``mxnet_tpu/gluon/probability/distributions.py``): one module, every
density and statistic a torch computation over the parameters' tensors
through the funnel (so it records on the tape), the KL registry beside.

Sampling takes one key per call from the global key stream
(``_random.next_key``) and draws with jax.random's algorithms on the host
(``_prng``, ``_samplers``), in the JAX package's dtypes (it enables x64:
continuous draws are f64), then moves the noise to the parameters'
device: the card's draws are the CPU's. Uniform bits are JAX's bit for
bit; the transforms of them use torch's transcendental functions, which
may differ from XLA's in the last place, and a rejection decision on
values within an ulp may go the other way (``_samplers``).
Reparameterized samples (``has_grad``) are funnel ops of the parameters,
so they differentiate on the tape.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import numpy as onp
import torch
import torch.nn.functional as F

from ... import _prng, _samplers
from ..._random import next_key
from ...base import MXNetError
from ...ndarray import NDArray, apply_multi, asarray
from .transformation import _combine

__all__ = [
    "Distribution", "Normal", "HalfNormal", "Laplace", "Cauchy",
    "HalfCauchy", "Uniform", "Exponential", "Gamma", "Beta", "Chi2",
    "Dirichlet", "Poisson", "Geometric", "Bernoulli", "Binomial",
    "Categorical", "OneHotCategorical", "MultivariateNormal", "StudentT",
    "Gumbel", "Pareto", "Independent", "TransformedDistribution",
    "RelaxedBernoulli", "RelaxedOneHotCategorical",
    "kl_divergence", "register_kl",
]

_F64 = onp.float64
_gammaln = torch.special.gammaln
_digamma = torch.special.digamma


def _val(x) -> torch.Tensor:
    return (x if isinstance(x, NDArray) else asarray(x))._data


def _wrap(fn, *arrays):
    """Run a torch computation over NDArrays / values through the funnel."""
    return apply_multi(fn, [a if isinstance(a, NDArray) else asarray(a) for a in arrays])


def _noise(draw: onp.ndarray, like) -> torch.Tensor:
    """A host draw on the device of the parameter ``like``."""
    return torch.from_numpy(onp.ascontiguousarray(draw)).to(_val(like).device)


def _np_dtype(t: torch.Tensor):
    return {torch.float64: onp.float64, torch.float32: onp.float32}.get(t.dtype, onp.float32)


def _uniform(key, shape, lo=0.0, hi=1.0, dtype=_F64) -> onp.ndarray:
    return _prng.host_uniform(key, shape, lo, hi, dtype)


def _normal(key, shape, dtype=_F64) -> onp.ndarray:
    return _prng.host_normal(key, shape, dtype)


def _gumbel(key, shape, dtype=_F64) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low") in ``dtype``."""
    u = torch.from_numpy(_uniform(key, shape, onp.finfo(dtype).tiny, 1.0, dtype))
    return -torch.log(-torch.log(u))


def _cauchy(key, shape) -> torch.Tensor:
    u = torch.from_numpy(_uniform(key, shape, onp.finfo(_F64).eps, 1.0))
    return torch.tan(math.pi * (u - 0.5))


def _exponential(key, shape) -> torch.Tensor:
    return -torch.log1p(-torch.from_numpy(_uniform(key, shape)))


class Distribution:
    """Base distribution: ``has_grad`` marks reparameterized sampling,
    ``event_dim`` counts trailing event dimensions."""

    has_grad = False
    has_enumerate_support = False
    event_dim = 0

    def __init__(self, **params):
        self._params = {k: (v if v is None else asarray(v)) for k, v in params.items()}
        for k, v in self._params.items():
            setattr(self, k, v)

    def log_prob(self, value) -> NDArray:
        raise NotImplementedError

    def prob(self, value) -> NDArray:
        return _wrap(torch.exp, self.log_prob(value))

    def sample(self, size=()) -> NDArray:
        raise NotImplementedError

    def sample_n(self, n) -> NDArray:
        size = (n,) if isinstance(n, int) else tuple(n)
        return self.sample(size)

    def cdf(self, value) -> NDArray:
        raise NotImplementedError

    def icdf(self, value) -> NDArray:
        raise NotImplementedError

    @property
    def mean(self) -> NDArray:
        raise NotImplementedError

    @property
    def variance(self) -> NDArray:
        raise NotImplementedError

    @property
    def stddev(self) -> NDArray:
        return _wrap(torch.sqrt, self.variance)

    def entropy(self) -> NDArray:
        raise NotImplementedError

    def _batch_shape(self, *vals) -> Tuple[int, ...]:
        return tuple(torch.broadcast_shapes(*(v.shape for v in vals)))

    def _sample_shape(self, size) -> Tuple[int, ...]:
        return (size,) if isinstance(size, int) else tuple(size)

    def __repr__(self):
        ps = ", ".join(f"{k}={v.shape if v is not None else None}"
                       for k, v in self._params.items())
        return f"{type(self).__name__}({ps})"


# ----------------------------------------------------------- continuous

class Normal(Distribution):
    has_grad = True

    def __init__(self, loc=0.0, scale=1.0):
        super().__init__(loc=loc, scale=scale)

    def log_prob(self, value):
        return _wrap(lambda v, mu, s: -((v - mu) ** 2) / (2 * s ** 2) - torch.log(s)
                     - 0.5 * math.log(2 * math.pi), value, self.loc, self.scale)

    def sample(self, size=()):
        shape = self._sample_shape(size) + self._batch_shape(_val(self.loc), _val(self.scale))
        z = _noise(_normal(next_key(), shape), self.loc)
        return _wrap(lambda mu, s: mu + s * z, self.loc, self.scale)

    def cdf(self, value):
        return _wrap(lambda v, mu, s: 0.5 * (1 + torch.special.erf((v - mu) / (s * math.sqrt(2)))),
                     value, self.loc, self.scale)

    def icdf(self, value):
        return _wrap(lambda q, mu, s: mu + s * math.sqrt(2) * torch.special.erfinv(2 * q - 1),
                     value, self.loc, self.scale)

    @property
    def mean(self):
        return self.loc

    @property
    def variance(self):
        return _wrap(lambda s: s ** 2, self.scale)

    def entropy(self):
        return _wrap(lambda s: 0.5 + 0.5 * math.log(2 * math.pi) + torch.log(s), self.scale)


class HalfNormal(Distribution):
    """|X|, X ~ N(0, scale)."""

    has_grad = True

    def __init__(self, scale=1.0):
        super().__init__(scale=scale)

    def log_prob(self, value):
        return _wrap(lambda v, s: torch.where(
            v >= 0, 0.5 * math.log(2 / math.pi) - torch.log(s) - v ** 2 / (2 * s ** 2),
            -math.inf), value, self.scale)

    def sample(self, size=()):
        shape = self._sample_shape(size) + tuple(_val(self.scale).shape)
        z = _noise(_normal(next_key(), shape), self.scale)
        return _wrap(lambda s: torch.abs(z) * s, self.scale)

    def cdf(self, value):
        return _wrap(lambda v, s: torch.special.erf(v / (s * math.sqrt(2))), value, self.scale)

    @property
    def mean(self):
        return _wrap(lambda s: s * math.sqrt(2 / math.pi), self.scale)

    @property
    def variance(self):
        return _wrap(lambda s: s ** 2 * (1 - 2 / math.pi), self.scale)


class Laplace(Distribution):
    has_grad = True

    def __init__(self, loc=0.0, scale=1.0):
        super().__init__(loc=loc, scale=scale)

    def log_prob(self, value):
        return _wrap(lambda v, mu, b: -torch.abs(v - mu) / b - torch.log(2 * b),
                     value, self.loc, self.scale)

    def sample(self, size=()):
        shape = self._sample_shape(size) + self._batch_shape(_val(self.loc), _val(self.scale))
        u = torch.from_numpy(_uniform(next_key(), shape, -1.0 + onp.finfo(_F64).epsneg, 1.0))
        z = (torch.sign(u) * torch.log1p(-torch.abs(u))).to(_val(self.loc).device)
        return _wrap(lambda mu, b: mu + b * z, self.loc, self.scale)

    @property
    def mean(self):
        return self.loc

    @property
    def variance(self):
        return _wrap(lambda b: 2 * b ** 2, self.scale)

    def entropy(self):
        return _wrap(lambda b: 1 + torch.log(2 * b), self.scale)


class Cauchy(Distribution):
    has_grad = True

    def __init__(self, loc=0.0, scale=1.0):
        super().__init__(loc=loc, scale=scale)

    def log_prob(self, value):
        return _wrap(lambda v, mu, g: -torch.log(math.pi * g * (1 + ((v - mu) / g) ** 2)),
                     value, self.loc, self.scale)

    def sample(self, size=()):
        shape = self._sample_shape(size) + self._batch_shape(_val(self.loc), _val(self.scale))
        z = _cauchy(next_key(), shape).to(_val(self.loc).device)
        return _wrap(lambda mu, g: mu + g * z, self.loc, self.scale)

    def cdf(self, value):
        return _wrap(lambda v, mu, g: torch.atan((v - mu) / g) / math.pi + 0.5,
                     value, self.loc, self.scale)

    def entropy(self):
        return _wrap(lambda g: torch.log(4 * math.pi * g), self.scale)


class HalfCauchy(Distribution):
    has_grad = True

    def __init__(self, scale=1.0):
        super().__init__(scale=scale)

    def log_prob(self, value):
        return _wrap(lambda v, g: torch.where(
            v >= 0, math.log(2 / math.pi) - torch.log(g) - torch.log1p((v / g) ** 2),
            -math.inf), value, self.scale)

    def sample(self, size=()):
        shape = self._sample_shape(size) + tuple(_val(self.scale).shape)
        z = _cauchy(next_key(), shape).to(_val(self.scale).device)
        return _wrap(lambda g: torch.abs(z) * g, self.scale)


class Uniform(Distribution):
    has_grad = True

    def __init__(self, low=0.0, high=1.0):
        super().__init__(low=low, high=high)

    def log_prob(self, value):
        return _wrap(lambda v, lo, hi: torch.where((v >= lo) & (v <= hi), -torch.log(hi - lo),
                                                   -math.inf), value, self.low, self.high)

    def sample(self, size=()):
        shape = self._sample_shape(size) + self._batch_shape(_val(self.low), _val(self.high))
        u = _noise(_uniform(next_key(), shape), self.low)
        return _wrap(lambda lo, hi: lo + (hi - lo) * u, self.low, self.high)

    def cdf(self, value):
        return _wrap(lambda v, lo, hi: torch.clamp((v - lo) / (hi - lo), 0, 1),
                     value, self.low, self.high)

    @property
    def mean(self):
        return _wrap(lambda lo, hi: (lo + hi) / 2, self.low, self.high)

    @property
    def variance(self):
        return _wrap(lambda lo, hi: (hi - lo) ** 2 / 12, self.low, self.high)

    def entropy(self):
        return _wrap(lambda lo, hi: torch.log(hi - lo), self.low, self.high)


class Exponential(Distribution):
    has_grad = True

    def __init__(self, scale=1.0):
        super().__init__(scale=scale)  # scale = 1 / rate

    def log_prob(self, value):
        return _wrap(lambda v, s: torch.where(v >= 0, -v / s - torch.log(s), -math.inf),
                     value, self.scale)

    def sample(self, size=()):
        shape = self._sample_shape(size) + tuple(_val(self.scale).shape)
        e = _exponential(next_key(), shape).to(_val(self.scale).device)
        return _wrap(lambda s: s * e, self.scale)

    def cdf(self, value):
        return _wrap(lambda v, s: 1 - torch.exp(-v / s), value, self.scale)

    def icdf(self, value):
        return _wrap(lambda q, s: -s * torch.log1p(-q), value, self.scale)

    @property
    def mean(self):
        return self.scale

    @property
    def variance(self):
        return _wrap(lambda s: s ** 2, self.scale)

    def entropy(self):
        return _wrap(lambda s: 1 + torch.log(s), self.scale)


class Gamma(Distribution):
    def __init__(self, shape, scale=1.0):
        super().__init__(shape=shape, scale=scale)

    def log_prob(self, value):
        return _wrap(lambda v, a, s: (a - 1) * torch.log(v) - v / s - _gammaln(a)
                     - a * torch.log(s), value, self.shape, self.scale)

    def sample(self, size=()):
        shp = self._sample_shape(size) + self._batch_shape(_val(self.shape), _val(self.scale))
        a = onp.broadcast_to(self.shape.asnumpy(), shp)
        g = _noise(_samplers.gamma(next_key(), a), self.shape)
        return _wrap(lambda s: g * s, self.scale)

    @property
    def mean(self):
        return _wrap(lambda a, s: a * s, self.shape, self.scale)

    @property
    def variance(self):
        return _wrap(lambda a, s: a * s ** 2, self.shape, self.scale)

    def entropy(self):
        return _wrap(lambda a, s: a + torch.log(s) + _gammaln(a) + (1 - a) * _digamma(a),
                     self.shape, self.scale)


class Chi2(Gamma):
    def __init__(self, df):
        df = asarray(df)
        self.df = df
        super().__init__(shape=_wrap(lambda d: d / 2, df), scale=2.0)


class Beta(Distribution):
    def __init__(self, alpha, beta):
        super().__init__(alpha=alpha, beta=beta)

    def log_prob(self, value):
        return _wrap(lambda v, a, b: (a - 1) * torch.log(v) + (b - 1) * torch.log1p(-v)
                     - (_gammaln(a) + _gammaln(b) - _gammaln(a + b)),
                     value, self.alpha, self.beta)

    def sample(self, size=()):
        shape = self._sample_shape(size) + self._batch_shape(_val(self.alpha), _val(self.beta))
        draw = _samplers.beta(next_key(), onp.broadcast_to(self.alpha.asnumpy(), shape),
                              onp.broadcast_to(self.beta.asnumpy(), shape))
        return NDArray._new(_noise(draw, self.alpha))

    @property
    def mean(self):
        return _wrap(lambda a, b: a / (a + b), self.alpha, self.beta)

    @property
    def variance(self):
        return _wrap(lambda a, b: a * b / ((a + b) ** 2 * (a + b + 1)), self.alpha, self.beta)


class Dirichlet(Distribution):
    event_dim = 1

    def __init__(self, alpha):
        super().__init__(alpha=alpha)

    def log_prob(self, value):
        return _wrap(lambda v, a: (torch.sum((a - 1) * torch.log(v), -1)
                                   + _gammaln(torch.sum(a, -1))
                                   - torch.sum(_gammaln(a), -1)), value, self.alpha)

    def sample(self, size=()):
        a = self.alpha.asnumpy()
        shape = self._sample_shape(size) + a.shape[:-1]
        # jax.random.dirichlet: log-gammas of shape + (k,), then softmax
        lg = _samplers.loggamma(next_key(), a, shape + a.shape[-1:])
        return NDArray._new(_noise(torch.softmax(torch.from_numpy(lg), -1).numpy(), self.alpha))

    @property
    def mean(self):
        return _wrap(lambda a: a / torch.sum(a, -1, keepdim=True), self.alpha)


class StudentT(Distribution):
    def __init__(self, df, loc=0.0, scale=1.0):
        super().__init__(df=df, loc=loc, scale=scale)

    def log_prob(self, value):
        def fn(v, df, mu, s):
            y = (v - mu) / s
            return (_gammaln((df + 1) / 2) - _gammaln(df / 2) - 0.5 * torch.log(df * math.pi)
                    - torch.log(s) - (df + 1) / 2 * torch.log1p(y ** 2 / df))
        return _wrap(fn, value, self.df, self.loc, self.scale)

    def sample(self, size=()):
        shape = self._sample_shape(size) + self._batch_shape(
            _val(self.df), _val(self.loc), _val(self.scale))
        # jax.random.t: a normal and a gamma under split(key)
        key_n, key_g = _prng.split(next_key())
        half_df = onp.broadcast_to(self.df.asnumpy(), shape).astype(_F64) / 2.0
        n = _normal(key_n, shape)
        g = _samplers.gamma(key_g, half_df, shape)
        t = _noise(n * onp.sqrt(half_df / g), self.loc)
        return _wrap(lambda mu, s: mu + s * t, self.loc, self.scale)

    @property
    def mean(self):
        return self.loc

    @property
    def variance(self):
        return _wrap(lambda df, s: torch.where(df > 2, s ** 2 * df / (df - 2), math.inf),
                     self.df, self.scale)


class Gumbel(Distribution):
    has_grad = True

    def __init__(self, loc=0.0, scale=1.0):
        super().__init__(loc=loc, scale=scale)

    def log_prob(self, value):
        def fn(v, mu, b):
            z = (v - mu) / b
            return -(z + torch.exp(-z)) - torch.log(b)
        return _wrap(fn, value, self.loc, self.scale)

    def sample(self, size=()):
        shape = self._sample_shape(size) + self._batch_shape(_val(self.loc), _val(self.scale))
        g = _gumbel(next_key(), shape).to(_val(self.loc).device)
        return _wrap(lambda mu, b: mu + b * g, self.loc, self.scale)

    @property
    def mean(self):
        return _wrap(lambda mu, b: mu + 0.5772156649015329 * b, self.loc, self.scale)

    @property
    def variance(self):
        return _wrap(lambda b: (math.pi * b) ** 2 / 6, self.scale)


class Pareto(Distribution):
    def __init__(self, alpha, scale=1.0):
        super().__init__(alpha=alpha, scale=scale)

    def log_prob(self, value):
        return _wrap(lambda v, a, m: torch.where(
            v >= m, torch.log(a) + a * torch.log(m) - (a + 1) * torch.log(v), -math.inf),
            value, self.alpha, self.scale)

    def sample(self, size=()):
        shape = self._sample_shape(size) + self._batch_shape(_val(self.alpha), _val(self.scale))
        e = _exponential(next_key(), shape).to(_val(self.alpha).device)
        return _wrap(lambda a, m: m * torch.exp(e / a), self.alpha, self.scale)


class MultivariateNormal(Distribution):
    """Parameterized by loc and one of cov / scale_tril."""

    has_grad = True
    event_dim = 1

    def __init__(self, loc, cov=None, scale_tril=None):
        if (cov is None) == (scale_tril is None):
            raise MXNetError("provide exactly one of cov / scale_tril")
        if scale_tril is None:
            scale_tril = _wrap(torch.linalg.cholesky, asarray(cov))
        super().__init__(loc=loc, scale_tril=scale_tril)

    def log_prob(self, value):
        def fn(v, mu, L):
            d = mu.shape[-1]
            diff = (v - mu).to(torch.promote_types(v.dtype, L.dtype))
            sol = torch.linalg.solve_triangular(L.to(diff.dtype), diff[..., None],
                                                upper=False)[..., 0]
            logdet = torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), -1)
            return -0.5 * torch.sum(sol ** 2, -1) - logdet - d / 2 * math.log(2 * math.pi)
        return _wrap(fn, value, self.loc, self.scale_tril)

    def sample(self, size=()):
        shape = self._sample_shape(size) + tuple(_val(self.loc).shape)
        z = _noise(_normal(next_key(), shape), self.loc)
        return _wrap(lambda m, L: m + torch.einsum("...ij,...j->...i", L.to(z.dtype), z),
                     self.loc, self.scale_tril)

    @property
    def mean(self):
        return self.loc

    @property
    def variance(self):
        return _wrap(lambda L: torch.sum(L ** 2, -1), self.scale_tril)


# ------------------------------------------------------------- discrete

def _probs_or_logits(prob, logit):
    if (prob is None) == (logit is None):
        raise MXNetError("provide exactly one of prob / logit")


class Bernoulli(Distribution):
    def __init__(self, prob=None, logit=None):
        _probs_or_logits(prob, logit)
        super().__init__(prob=prob, logit=logit)

    def _logit(self):
        if self.logit is not None:
            return self.logit
        return _wrap(lambda p: torch.log(p) - torch.log1p(-p), self.prob)

    @property
    def _prob(self):
        if self.prob is not None:
            return self.prob
        return _wrap(torch.sigmoid, self.logit)

    def log_prob(self, value):
        return _wrap(lambda v, lg: v * F.logsigmoid(lg) + (1 - v) * F.logsigmoid(-lg),
                     value, self._logit())

    def sample(self, size=()):
        p = self._prob
        pv = _val(p)
        shape = self._sample_shape(size) + tuple(pv.shape)
        # jax.random.bernoulli: a uniform in p's dtype below p
        u = _noise(_uniform(next_key(), shape, dtype=_np_dtype(pv)), p)
        return _wrap(lambda pp: (u < pp).to(torch.float32), p)

    @property
    def mean(self):
        return self._prob

    @property
    def variance(self):
        return _wrap(lambda p: p * (1 - p), self._prob)

    def entropy(self):
        return _wrap(lambda p: -(p * torch.log(p) + (1 - p) * torch.log1p(-p)), self._prob)


class Geometric(Distribution):
    """P(X=k) = (1-p)^k p, k >= 0."""

    def __init__(self, prob=None, logit=None):
        _probs_or_logits(prob, logit)
        if prob is None:
            prob = _wrap(torch.sigmoid, asarray(logit))
        super().__init__(prob=prob)

    def log_prob(self, value):
        return _wrap(lambda v, p: v * torch.log1p(-p) + torch.log(p), value, self.prob)

    def sample(self, size=()):
        shape = self._sample_shape(size) + tuple(_val(self.prob).shape)
        u = _noise(_uniform(next_key(), shape), self.prob)
        return _wrap(lambda pp: torch.floor(torch.log1p(-u) / torch.log1p(-pp)), self.prob)

    @property
    def mean(self):
        return _wrap(lambda p: (1 - p) / p, self.prob)

    @property
    def variance(self):
        return _wrap(lambda p: (1 - p) / p ** 2, self.prob)


class Poisson(Distribution):
    def __init__(self, rate):
        super().__init__(rate=rate)

    def log_prob(self, value):
        return _wrap(lambda v, lam: v * torch.log(lam) - lam - _gammaln(v + 1),
                     value, self.rate)

    def sample(self, size=()):
        lam = self.rate.asnumpy()
        shape = self._sample_shape(size) + lam.shape
        draw = _samplers.poisson(next_key(), lam, shape).astype(onp.float32)
        return NDArray._new(_noise(draw, self.rate))

    @property
    def mean(self):
        return self.rate

    @property
    def variance(self):
        return self.rate


class Binomial(Distribution):
    def __init__(self, n, prob=None, logit=None):
        _probs_or_logits(prob, logit)
        if prob is None:
            prob = _wrap(torch.sigmoid, asarray(logit))
        super().__init__(n=n, prob=prob)

    def log_prob(self, value):
        def fn(v, n, p):
            logc = _gammaln(n + 1) - _gammaln(v + 1) - _gammaln(n - v + 1)
            return logc + v * torch.log(p) + (n - v) * torch.log1p(-p)
        return _wrap(fn, value, self.n, self.prob)

    def sample(self, size=()):
        n_max = int(self.n.asnumpy().max())
        pv = _val(self.prob)
        shape = self._sample_shape(size) + self._batch_shape(_val(self.n), pv)
        # n_max Bernoulli trials an element (uniforms in p's dtype); only the
        # first n of an element count
        u = _noise(_uniform(next_key(), (n_max,) + shape, dtype=_np_dtype(pv)), self.prob)

        def draw(nn, pp):
            mask = torch.arange(n_max, device=pp.device).reshape((n_max,) + (1,) * len(shape)) < nn
            return torch.sum((u < pp) & mask, dim=0).to(torch.float32)
        return _wrap(draw, self.n, self.prob)

    @property
    def mean(self):
        return _wrap(lambda n, p: n * p, self.n, self.prob)

    @property
    def variance(self):
        return _wrap(lambda n, p: n * p * (1 - p), self.n, self.prob)


def _categorical(key, logits: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.categorical(key, logits, -1, shape=shape)``: argmax of
    Gumbel noise of ``shape + (K,)`` in the logits' dtype plus the logits."""
    g = _gumbel(key, tuple(shape) + tuple(logits.shape[-1:]), _np_dtype(logits))
    return torch.argmax(g.to(logits.device) + logits, dim=-1)


class Categorical(Distribution):
    def __init__(self, num_events=None, prob=None, logit=None):
        _probs_or_logits(prob, logit)
        if logit is None:
            logit = _wrap(torch.log, asarray(prob))
        super().__init__(logit=logit)
        self.num_events = num_events or _val(self.logit).shape[-1]

    @property
    def prob(self):
        return _wrap(lambda lg: torch.softmax(lg, -1), self.logit)

    def log_prob(self, value):
        def fn(v, lg):
            batch = torch.broadcast_shapes(v.shape, lg.shape[:-1])
            return torch.gather(torch.log_softmax(lg, -1).broadcast_to(batch + lg.shape[-1:]),
                                -1, v.to(torch.int64).broadcast_to(batch)[..., None])[..., 0]
        return _wrap(fn, value, self.logit)

    def sample(self, size=()):
        lg = _val(self.logit)
        shape = self._sample_shape(size) + tuple(lg.shape[:-1])
        key = next_key()
        return _wrap(lambda l: _categorical(key, l.detach(), shape).to(torch.float32), self.logit)

    def enumerate_support(self):
        return NDArray._new(torch.arange(self.num_events, dtype=torch.float32,
                                         device=_val(self.logit).device))


class OneHotCategorical(Categorical):
    event_dim = 1

    def log_prob(self, value):
        return _wrap(lambda v, lg: torch.sum(v * torch.log_softmax(lg, -1), -1),
                     value, self.logit)

    def sample(self, size=()):
        lg = _val(self.logit)
        shape = self._sample_shape(size) + tuple(lg.shape[:-1])
        key = next_key()
        # jax.nn.one_hot's default dtype: f64 under the JAX package's x64
        return _wrap(lambda l: F.one_hot(_categorical(key, l.detach(), shape),
                                         l.shape[-1]).to(torch.float64), self.logit)


class RelaxedBernoulli(Distribution):
    """Concrete / Gumbel-sigmoid relaxation (Maddison et al. 2017):
    differentiable samples in (0, 1) that sharpen toward {0, 1} as the
    temperature goes to 0."""

    has_grad = True

    def __init__(self, T, prob=None, logit=None):
        _probs_or_logits(prob, logit)
        if logit is None:
            logit = _wrap(lambda p: torch.log(p) - torch.log1p(-p), asarray(prob))
        super().__init__(T=T, logit=logit)

    def sample(self, size=()):
        shape = self._sample_shape(size) + self._batch_shape(_val(self.T), _val(self.logit))
        u = torch.from_numpy(_uniform(next_key(), shape, onp.finfo(_F64).tiny, 1.0))
        z = (torch.log(u) - torch.log1p(-u)).to(_val(self.logit).device)
        return _wrap(lambda t, l: torch.sigmoid((l + z) / t), self.T, self.logit)

    def log_prob(self, value):
        # the logistic density through the sigmoid change of variables
        def fn(v, t, l):
            d = l - t * (torch.log(v) - torch.log1p(-v))
            return (torch.log(t) + F.logsigmoid(d) + F.logsigmoid(-d) - torch.log(v)
                    - torch.log1p(-v))
        return _wrap(fn, value, self.T, self.logit)


class RelaxedOneHotCategorical(Distribution):
    """Gumbel-softmax relaxation of OneHotCategorical (Jang et al. 2017)."""

    has_grad = True
    event_dim = 1

    def __init__(self, T, prob=None, logit=None):
        _probs_or_logits(prob, logit)
        if logit is None:
            logit = _wrap(torch.log, asarray(prob))
        super().__init__(T=T, logit=logit)

    def sample(self, size=()):
        t = _val(self.T)
        shape = self._sample_shape(size) + self._batch_shape(
            t[..., None] if t.dim() else t, _val(self.logit))
        g = _gumbel(next_key(), shape).to(_val(self.logit).device)
        return _wrap(lambda t, l: torch.softmax((l + g) / t, dim=-1), self.T, self.logit)

    def log_prob(self, value):
        def fn(v, t, l):
            k = l.shape[-1]
            score = l - t * torch.log(v)
            lse = torch.logsumexp(score, dim=-1)
            return (math.lgamma(float(k)) + (k - 1) * torch.log(t) + torch.sum(score, -1)
                    - k * lse - torch.sum(torch.log(v), -1))
        return _wrap(fn, value, self.T, self.logit)


# ------------------------------------------------------------ wrappers

class Independent(Distribution):
    """Reinterpret trailing batch dims as event dims: log_prob sums over
    them."""

    def __init__(self, base: Distribution, reinterpreted_batch_ndims: int):
        self.base = base
        self.n = reinterpreted_batch_ndims
        self.event_dim = base.event_dim + reinterpreted_batch_ndims
        self._params = {}

    def log_prob(self, value):
        n = self.n
        return _wrap(lambda x: torch.sum(x, dim=tuple(range(-n, 0))), self.base.log_prob(value))

    def sample(self, size=()):
        return self.base.sample(size)

    @property
    def mean(self):
        return self.base.mean

    @property
    def variance(self):
        return self.base.variance


class TransformedDistribution(Distribution):
    """Pushforward through a chain of bijectors: log_prob via the inverse
    and log|det J|."""

    def __init__(self, base: Distribution, transforms):
        self.base = base
        if not isinstance(transforms, (list, tuple)):
            transforms = [transforms]
        self.transforms = list(transforms)
        self._params = {}

    def sample(self, size=()):
        x = self.base.sample(size)
        for t in self.transforms:
            x = t(x)
        return x

    def log_prob(self, value):
        lp = None
        y = value
        for t in reversed(self.transforms):
            x = t.inv(y)
            term = t.log_det_jacobian(x, y)
            lp = term if lp is None else _combine(torch.add, lp, term)
            y = x
        return _combine(torch.sub, self.base.log_prob(y), lp)


# ------------------------------------------------------------------ KL

_KL_REGISTRY: Dict[Tuple[type, type], Callable] = {}


def register_kl(type_p, type_q):
    """Decorator registering an exact KL(p || q)."""
    def deco(fn):
        _KL_REGISTRY[(type_p, type_q)] = fn
        return fn
    return deco


def kl_divergence(p: Distribution, q: Distribution) -> NDArray:
    for (tp, tq), fn in _KL_REGISTRY.items():
        if isinstance(p, tp) and isinstance(q, tq):
            return fn(p, q)
    raise MXNetError(f"no KL registered for ({type(p).__name__}, {type(q).__name__})")


@register_kl(Normal, Normal)
def _kl_normal_normal(p, q):
    return _wrap(lambda m1, s1, m2, s2: (torch.log(s2 / s1)
                                         + (s1 ** 2 + (m1 - m2) ** 2) / (2 * s2 ** 2) - 0.5),
                 p.loc, p.scale, q.loc, q.scale)


@register_kl(Bernoulli, Bernoulli)
def _kl_bern_bern(p, q):
    return _wrap(lambda a, b: a * (torch.log(a) - torch.log(b))
                 + (1 - a) * (torch.log1p(-a) - torch.log1p(-b)), p._prob, q._prob)


@register_kl(Categorical, Categorical)
def _kl_cat_cat(p, q):
    return _wrap(lambda lp, lq: torch.sum(
        torch.softmax(lp, -1) * (torch.log_softmax(lp, -1) - torch.log_softmax(lq, -1)), -1),
        p.logit, q.logit)


@register_kl(Uniform, Uniform)
def _kl_unif_unif(p, q):
    return _wrap(lambda pl, ph, ql, qh: torch.where(
        (ql <= pl) & (ph <= qh), torch.log((qh - ql) / (ph - pl)), math.inf),
        p.low, p.high, q.low, q.high)


@register_kl(Exponential, Exponential)
def _kl_exp_exp(p, q):
    return _wrap(lambda sp, sq: torch.log(sq / sp) + sp / sq - 1, p.scale, q.scale)


@register_kl(Gamma, Gamma)
def _kl_gamma_gamma(p, q):
    def fn(ap, sp, aq, sq):
        return ((ap - aq) * _digamma(ap) - _gammaln(ap) + _gammaln(aq)
                + aq * (torch.log(sq) - torch.log(sp)) + ap * (sp / sq - 1))
    return _wrap(fn, p.shape, p.scale, q.shape, q.scale)


@register_kl(Laplace, Laplace)
def _kl_laplace_laplace(p, q):
    def fn(m1, b1, m2, b2):
        d = torch.abs(m1 - m2)
        return torch.log(b2 / b1) + d / b2 + b1 / b2 * torch.exp(-d / b1) - 1
    return _wrap(fn, p.loc, p.scale, q.loc, q.scale)


@register_kl(Beta, Beta)
def _kl_beta_beta(p, q):
    def fn(a1, b1, a2, b2):
        def log_b(a, b):
            return _gammaln(a) + _gammaln(b) - _gammaln(a + b)
        return (log_b(a2, b2) - log_b(a1, b1) + (a1 - a2) * _digamma(a1)
                + (b1 - b2) * _digamma(b1) + (a2 - a1 + b2 - b1) * _digamma(a1 + b1))
    return _wrap(fn, p.alpha, p.beta, q.alpha, q.beta)


@register_kl(Dirichlet, Dirichlet)
def _kl_dirichlet_dirichlet(p, q):
    def fn(a1, a2):
        s1 = torch.sum(a1, -1)
        return (_gammaln(s1) - torch.sum(_gammaln(a1), -1) - _gammaln(torch.sum(a2, -1))
                + torch.sum(_gammaln(a2), -1)
                + torch.sum((a1 - a2) * (_digamma(a1) - _digamma(s1)[..., None]), -1))
    return _wrap(fn, p.alpha, q.alpha)


@register_kl(Gumbel, Gumbel)
def _kl_gumbel_gumbel(p, q):
    # E_p[log p - log q]; closed form through the Gumbel moment function
    def fn(m1, b1, m2, b2):
        euler = 0.5772156649015329
        z = (m1 - m2) / b2
        return (torch.log(b2 / b1) + euler * (b1 / b2 - 1) + z
                + torch.exp(-z) * torch.exp(_gammaln(1 + b1 / b2)) - 1)
    return _wrap(fn, p.loc, p.scale, q.loc, q.scale)
