"""``mx.np.random``: stateful sampling from the global key stream
(counterpart of ``mxnet_tpu/numpy/random.py``).

Each call takes one key (``_random.next_key()``) and draws with
jax.random's algorithms (``_prng``'s host draws): ``uniform``, ``rand``,
``randint``, ``choice``, ``permutation``, ``shuffle`` and ``bernoulli``
give the JAX package's values bit for bit; ``normal`` and the one-draw
transforms (``exponential`` ... ``weibull``) take the same uniform bits
through torch's transcendental functions, which may differ from XLA's in
the last place. Draws default to the JAX package's dtypes (which enables
x64: the transforms draw f64, ``randint`` int64). The rejection samplers
(``gamma``, ``beta``, ``chisquare``, ``f``, ``poisson``, ``binomial``,
``multinomial``, ``multivariate_normal`` and ``choice(p=,
replace=False)``) run jax.random's algorithms with its key splits on the
host (``_samplers``): a decision whose two sides lie within an ulp of
each other may go the other way where numpy's log differs from XLA's.
Every draw is made on the host and lands on ``device``, so the card's
draws are the CPU's.
"""
from __future__ import annotations

import numpy as onp
import torch

from .. import _prng, _samplers
from .._random import next_key, seed  # noqa: F401 (seed re-exported)
from ..base import MXNetError
from ..ndarray import NDArray, _cast, apply_multi, asarray, to_torch_dtype  # noqa: F401

__all__ = [
    "seed", "uniform", "normal", "randn", "rand", "randint", "choice", "shuffle",
    "permutation", "gamma", "beta", "exponential", "laplace", "bernoulli", "binomial",
    "multinomial", "poisson", "gumbel", "logistic", "lognormal", "pareto", "power",
    "rayleigh", "weibull", "chisquare", "f", "standard_normal", "multivariate_normal",
]

_TINY32 = float(onp.finfo(onp.float32).tiny)


def _shape(size):
    if size is None:
        return ()
    if isinstance(size, int):
        return (size,)
    return tuple(int(s) for s in size)


def _out(a: onp.ndarray, device=None, ctx=None) -> NDArray:
    return NDArray(a, device=device or ctx)


def _np_dtype(dtype, default):
    dt = to_torch_dtype(dtype)
    return onp.dtype(default) if dt is None else onp.dtype(
        {torch.float32: onp.float32, torch.float64: onp.float64,
         torch.float16: onp.float32, torch.bfloat16: onp.float32}.get(dt, onp.float32))


def _param(lo, hi, u01: onp.ndarray, dt, fn):
    """``fn(u, lo, hi)`` with NDArray parameters through the funnel (so it
    is recorded): ``u01`` drawn on the host, broadcast against them."""
    arrs = [p if isinstance(p, NDArray) else NDArray(onp.asarray(p, dtype=dt))
            for p in (lo, hi)]
    dev = arrs[0]._data.device
    u = torch.from_numpy(u01).to(dev)
    return apply_multi(lambda a, b: fn(u, _cast(a, u.dtype), _cast(b, u.dtype)), arrs)


def _bshape(shape, *params):
    if shape:
        return shape
    return tuple(onp.broadcast_shapes(*[p.shape if isinstance(p, NDArray) else ()
                                        for p in params]))


def uniform(low=0.0, high=1.0, size=None, dtype=None, device=None, ctx=None):
    dt = _np_dtype(dtype, onp.float32)
    shape = _shape(size)
    if isinstance(low, NDArray) or isinstance(high, NDArray):
        shape = _bshape(shape, low, high)
        u = _prng.host_uniform(next_key(), shape, 0.0, 1.0, dt)
        return _param(low, high, u, dt, lambda v, lo, hi: torch.maximum(lo, v * (hi - lo) + lo))
    return _out(_prng.host_uniform(next_key(), shape, low, high, dt), device, ctx)


def normal(loc=0.0, scale=1.0, size=None, dtype=None, device=None, ctx=None):
    dt = _np_dtype(dtype, onp.float32)
    shape = _shape(size)
    if isinstance(loc, NDArray) or isinstance(scale, NDArray):
        shape = _bshape(shape, loc, scale)
        z = _prng.host_normal(next_key(), shape, dt)
        return _param(loc, scale, z, dt, lambda v, m, s: m + s * v)
    z = _prng.host_normal(next_key(), shape, dt)
    # XLA fuses loc + scale * z into one multiply-add: one rounding (the
    # f32 product is exact in f64)
    return _out((onp.float64(dt.type(loc)) + onp.float64(dt.type(scale))
                 * z.astype(onp.float64)).astype(dt), device, ctx)


def standard_normal(size=None, dtype=None):
    return normal(0.0, 1.0, size=size, dtype=dtype)


def randn(*shape, dtype=None):
    return normal(0.0, 1.0, size=shape, dtype=dtype)


def rand(*shape, dtype=None):
    return uniform(0.0, 1.0, size=shape, dtype=dtype)


def randint(low, high=None, size=None, dtype=None, device=None, ctx=None):
    """Integers in [low, high) (the JAX package draws them as int64, then
    casts to ``dtype``)."""
    if high is None:
        low, high = 0, low
    out = _prng.host_randint(next_key(), _shape(size), int(low), int(high))
    return _out(out.astype(onp.dtype(dtype or onp.int64)), device, ctx)


def choice(a, size=None, replace=True, p=None, device=None, ctx=None):
    key = next_key()
    arr = onp.arange(a) if isinstance(a, int) else NDArray(a).asnumpy() \
        if not isinstance(a, NDArray) else a.asnumpy()
    shape = _shape(size)
    n = arr.shape[0]
    n_draws = int(onp.prod(shape, dtype=onp.int64))
    if p is None:
        if replace:
            ind = _prng.host_randint(key, shape, 0, n)
        else:
            if n_draws > n:
                raise MXNetError("choice: a larger sample than the population "
                                 "without replacement")
            ind = _prng.host_permutation(key, n)[:n_draws].reshape(shape)
    else:
        pv = p.asnumpy() if isinstance(p, NDArray) else onp.asarray(p)
        if not onp.issubdtype(pv.dtype, onp.floating):
            pv = pv.astype(onp.float64)
        if not replace:
            if n_draws > n:
                raise MXNetError("choice: a larger sample than the population "
                                 "without replacement")
            ind = _samplers.choice_without_replacement(key, pv, n_draws).reshape(shape)
            return _out(onp.take(arr, ind, axis=0), device, ctx)
        cum = onp.cumsum(pv, dtype=pv.dtype)
        r = cum[-1] * (pv.dtype.type(1) - _prng.host_uniform(key, shape, 0.0, 1.0, pv.dtype))
        ind = onp.searchsorted(cum, r, side="left").astype(onp.int64)
    return _out(onp.take(arr, ind, axis=0), device, ctx)


def permutation(x):
    key = next_key()
    if isinstance(x, int):
        return _out(_prng.host_permutation(key, x))
    x = x if isinstance(x, NDArray) else NDArray(x)
    idx = torch.from_numpy(_prng.host_permutation(key, x.shape[0])).to(x._data.device)
    return apply_multi(lambda v: v[idx], [x])


def shuffle(x):
    """Shuffles ``x`` along axis 0 (the array is rebound to the result)."""
    x._set_data(permutation(x)._data)


def bernoulli(prob=None, logit=None, size=None, dtype=None, device=None, ctx=None):
    """1 with probability ``prob`` (or ``sigmoid(logit)``): ``uniform < p``
    in p's dtype (a Python float is f64, as in the JAX package)."""
    out_dt = onp.dtype(_np_dtype(dtype, onp.float32))
    if prob is None:
        if isinstance(logit, NDArray):
            prob = NDArray._new(torch.sigmoid(logit._data))
        else:
            prob = 1.0 / (1.0 + onp.exp(-logit))
    key = next_key()
    if isinstance(prob, NDArray):
        pv = prob.asnumpy()
        shape = _shape(size) or pv.shape
        u = _prng.host_uniform(key, shape, 0.0, 1.0, pv.dtype)
        return _out((u < pv).astype(out_dt), device, ctx)
    u = _prng.host_uniform(key, _shape(size), 0.0, 1.0, onp.float64)
    return _out((u < onp.float64(prob)).astype(out_dt), device, ctx)


def _u64(shape, minval=0.0, maxval=1.0):
    return torch.from_numpy(_prng.host_uniform(next_key(), shape, minval, maxval, onp.float64))


def exponential(scale=1.0, size=None, dtype=None, device=None, ctx=None):
    u = _u64(_shape(size))
    return _out((-torch.log1p(-u) * scale).numpy(), device, ctx)


def laplace(loc=0.0, scale=1.0, size=None, dtype=None, device=None, ctx=None):
    u = _u64(_shape(size), -1.0 + onp.finfo(onp.float64).epsneg, 1.0)
    return _out((loc + scale * (torch.sign(u) * torch.log1p(-torch.abs(u)))).numpy(),
                device, ctx)


def gumbel(loc=0.0, scale=1.0, size=None, dtype=None, device=None, ctx=None):
    u = _u64(_shape(size), onp.finfo(onp.float64).tiny, 1.0)
    return _out((loc + scale * -torch.log(-torch.log(u))).numpy(), device, ctx)


def logistic(loc=0.0, scale=1.0, size=None, dtype=None, device=None, ctx=None):
    u = _u64(_shape(size), onp.finfo(onp.float64).tiny, 1.0)
    return _out((loc + scale * (torch.log(u) - torch.log1p(-u))).numpy(), device, ctx)


def lognormal(mean=0.0, sigma=1.0, size=None, dtype=None, device=None, ctx=None):
    z = torch.from_numpy(_prng.host_normal(next_key(), _shape(size), onp.float64))
    return _out(torch.exp(mean + sigma * z).numpy(), device, ctx)


def pareto(a, size=None, device=None, ctx=None):
    e = -torch.log1p(-_u64(_shape(size)))
    return _out(torch.exp(e / a).numpy(), device, ctx)


def power(a, size=None, device=None, ctx=None):
    return _out((_u64(_shape(size)) ** (1.0 / a)).numpy(), device, ctx)


def rayleigh(scale=1.0, size=None, device=None, ctx=None):
    u = _u64(_shape(size), _TINY32, 1.0)
    return _out((scale * torch.sqrt(-2.0 * torch.log(u))).numpy(), device, ctx)


def weibull(a, size=None, device=None, ctx=None):
    u = _u64(_shape(size))
    return _out(torch.pow(-torch.log1p(-u), 1.0 / a).numpy(), device, ctx)


def _host(a) -> onp.ndarray:
    return a.asnumpy() if isinstance(a, NDArray) else onp.asarray(a)


def gamma(shape, scale=1.0, size=None, dtype=None, device=None, ctx=None):
    """Gamma(shape, scale): ``shape`` rounded to ``dtype`` (f32) first, the
    draw in f64, as the JAX package's x64 ``jax.random.gamma``."""
    a = _host(shape) if isinstance(shape, NDArray) else \
        onp.asarray(shape, dtype=_np_dtype(dtype, onp.float32))
    out = _samplers.gamma(next_key(), a, _shape(size) or None) * scale
    return _out(out, device, ctx)


def beta(a, b, size=None, dtype=None, device=None, ctx=None):
    out = _samplers.beta(next_key(), _host(a), _host(b), _shape(size) or None)
    return _out(out.astype(_np_dtype(dtype, onp.float32)), device, ctx)


def chisquare(df, size=None, dtype=None, device=None, ctx=None):
    out = 2.0 * _samplers.gamma(next_key(), _host(df) / 2.0, _shape(size) or None)
    return _out(out, device, ctx)


def f(dfnum, dfden, size=None, dtype=None, device=None, ctx=None):
    """F-distribution: the ratio of two scaled chi-squares drawn under
    ``split(key)``."""
    k1, k2 = _prng.split(next_key())
    shp = _shape(size) or None
    num = _samplers.gamma(k1, _host(dfnum) / 2.0, shp) / dfnum
    den = _samplers.gamma(k2, _host(dfden) / 2.0, shp) / dfden
    return _out(num / den, device, ctx)


def binomial(n, p, size=None, dtype=None, device=None, ctx=None):
    return _out(_samplers.binomial(next_key(), _host(n), _host(p), _shape(size) or None),
                device, ctx)


def multinomial(n, pvals, size=None, device=None, ctx=None):
    """Counts over the outcomes of ``pvals`` (``size`` is the whole result
    shape, outcomes last, as the JAX package passes it)."""
    return _out(_samplers.multinomial(next_key(), _host(n), _host(pvals),
                                      _shape(size) or None), device, ctx)


def poisson(lam=1.0, size=None, dtype=None, device=None, ctx=None):
    return _out(_samplers.poisson(next_key(), _host(lam), _shape(size) or None),
                device, ctx)


def multivariate_normal(mean, cov, size=None, check_valid=None, tol=None, device=None,
                        ctx=None):
    out = _samplers.multivariate_normal(next_key(), asarray(mean).asnumpy(),
                                        asarray(cov).asnumpy(), _shape(size) or None)
    return _out(out, device, ctx)
