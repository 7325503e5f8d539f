"""jax.random's rejection samplers on the host (the draws behind
``mx.np.random.gamma`` ... ``multivariate_normal`` and ``choice(p=,
replace=False)``; counterpart of what ``mxnet_tpu/numpy/random.py`` calls
in ``jax.random``).

Each function takes a host key ([2] int64 tensor, ``_prng``'s layout) and
runs jax 0.9.0's algorithm with its key splits in numpy, so the draws are
JAX's: the uniform and normal draws bit for bit (``_prng``), and every
accept or reject decision on them. Where JAX's loop is over a whole array
(Knuth's Poisson, transformed rejection, BTRS, binomial inversion) the
loop here is too, and runs as many rounds: an element accepted twice
keeps its last draw, as there. Where JAX maps a scalar loop over the
elements (Marsaglia-Tsang's gamma, one key per element from
``split(key, n)``), the loop runs over every element still drawing.

The transcendental functions are numpy's and torch's. XLA's differ in
the last place for some arguments, so a decision whose two sides lie
within an ulp or two may go the other way: that element's draw then
differs, and in a whole-array loop possibly the round count. Such flips
are rare (none among the parity tests' draws); continuous values
otherwise agree to about 1e-15 (f64) or a few f32 ulps.
"""
from __future__ import annotations

import numpy as np
import torch

from ._prng import M32, _erfinv_f32, _words, threefry2x32

__all__ = ["gamma", "loggamma", "beta", "poisson", "binomial", "multinomial",
           "multivariate_normal", "choice_without_replacement"]

_U32 = np.uint32
_F32 = np.dtype(np.float32)
_F64 = np.dtype(np.float64)


# ------------------------------------------------------------ batched keys
#
# A batch of keys is a pair of uint32 arrays (k0, k1) of one shape.

def _key(k: torch.Tensor):
    a, b = _words(k)
    return np.asarray(a, dtype=_U32), np.asarray(b, dtype=_U32)


def _split(k0, k1, n: int):
    """``jax.random.split`` of every key into ``n``: a list of ``n``
    (k0, k1) pairs."""
    out = []
    k0, k1 = np.asarray(k0, _U32), np.asarray(k1, _U32)
    with np.errstate(over="ignore"):
        for i in range(n):
            y0, y1 = threefry2x32(k0, k1, np.zeros_like(k0), np.full_like(k0, i))
            out.append((np.asarray(y0, _U32), np.asarray(y1, _U32)))
    return out


def _bits(k0, k1, shape, width: int):
    """``random_bits`` of ``shape`` under each key: k0.shape + shape."""
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape, dtype=np.int64))
    i = np.arange(n, dtype=np.int64)
    k0 = np.asarray(k0, _U32)[..., None]
    k1 = np.asarray(k1, _U32)[..., None]
    y0, y1 = threefry2x32(k0, k1, (i >> 32).astype(_U32), (i & M32).astype(_U32))
    if width == 64:
        out = (y0.astype(np.uint64) << np.uint64(32)) | y1.astype(np.uint64)
    else:
        out = (y0 ^ y1).astype(_U32)
    return out.reshape(k0.shape[:-1] + shape)


def _uniform(k0, k1, shape, dtype, minval=0.0, maxval=1.0):
    """``jax.random.uniform`` under each key (f32 scaled in f64 and
    rounded once, as XLA's fused multiply-add)."""
    dt = np.dtype(dtype)
    lo, hi = dt.type(minval), dt.type(maxval)
    if dt == _F32:
        bits = _bits(k0, k1, shape, 32)
        fl = ((bits >> _U32(9)) | _U32(0x3F800000)).view(np.float32) - np.float32(1)
        scaled = (fl.astype(np.float64) * np.float64(hi - lo) + np.float64(lo)).astype(_F32)
    else:
        bits = _bits(k0, k1, shape, 64)
        fl = ((bits >> np.uint64(12)) | np.uint64(0x3FF0000000000000)).view(np.float64) - 1.0
        scaled = fl * (hi - lo) + lo
    return np.maximum(lo, scaled)


def _normal(k0, k1, shape, dtype):
    """``jax.random.normal``: sqrt(2) erfinv(u), u uniform on (-1, 1)."""
    dt = np.dtype(dtype)
    lo = np.nextafter(dt.type(-1.0), dt.type(0.0))
    u = _uniform(k0, k1, shape, dt, lo, 1.0)
    if dt == _F32:
        e = _erfinv_f32(u)
    else:
        e = torch.erfinv(torch.from_numpy(np.ascontiguousarray(u))).numpy()
    return (e * dt.type(np.sqrt(2))).astype(dt)


def _log(x):
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.log(x)


# ------------------------------------------------------------ gamma

def _gamma_one(k0, k1, alpha, log_space: bool):
    """Marsaglia-Tsang under one key per element (``_gamma_one`` mapped
    over the elements): a normal redrawn while ``v <= 0``, then accepted
    on the squeeze or the log test; ``alpha < 1`` is boosted to
    ``alpha + 1`` and scaled by ``u ** (1 / alpha)``."""
    dt = alpha.dtype.type
    one = dt(1)
    boost = alpha >= one
    a = np.where(boost, alpha, alpha + one)
    d = a - dt(1.0 / 3.0)
    c = dt(1.0 / 3.0) / np.sqrt(d)
    (key0, key1), (sub0, sub1) = _split(k0, k1, 2)
    n = alpha.shape[0]
    X = np.zeros(n, alpha.dtype)
    V = np.ones(n, alpha.dtype)
    U = np.full(n, 2, alpha.dtype)
    todo = np.ones(n, bool)
    while todo.any():
        j = np.nonzero(todo)[0]
        (nk0, nk1), (xk0, xk1), (uk0, uk1) = _split(key0[j], key1[j], 3)
        x = np.zeros(len(j), alpha.dtype)
        v = np.full(len(j), -1, alpha.dtype)
        redraw = np.ones(len(j), bool)
        while redraw.any():
            r = np.nonzero(redraw)[0]
            (xk0[r], xk1[r]), (s0, s1) = _split(xk0[r], xk1[r], 2)
            xr = _normal(s0, s1, (), alpha.dtype)
            x[r] = xr
            v[r] = one + xr * c[j][r]
            redraw = v <= 0
        key0[j], key1[j] = nk0, nk1
        X[j] = x * x
        V[j] = (v * v) * v
        U[j] = _uniform(uk0, uk1, (), alpha.dtype)
        Xj, Vj, Uj, dj = X[j], V[j], U[j], d[j]
        again = (Uj >= one - dt(0.0331) * (Xj * Xj)) & \
            (_log(Uj) >= Xj * dt(0.5) + dj * ((one - Vj) + _log(Vj)))
        todo[:] = False
        todo[j] = again
    if log_space:
        u = _uniform(sub0, sub1, (), alpha.dtype)
        with np.errstate(divide="ignore"):
            log_samples = -(-np.log1p(-u))
            log_boost = np.where(boost | (log_samples == 0), dt(0),
                                 log_samples * (one / alpha))
        return (_log(d) + _log(V)) + log_boost
    samples = one - _uniform(sub0, sub1, (), alpha.dtype)
    with np.errstate(divide="ignore", over="ignore"):
        scale = np.where(boost, one, np.power(samples, one / alpha))
    return (d * V) * scale


def _gamma(k: torch.Tensor, a, shape, dtype, log_space: bool) -> np.ndarray:
    """``jax.random.gamma`` / ``loggamma``: ``a`` in ``dtype`` broadcast to
    ``shape``, element i drawn under ``split(key, n)[i]``."""
    dt = np.dtype(dtype)
    a = np.asarray(a).astype(dt)
    shape = a.shape if shape is None else tuple(shape)
    a = np.broadcast_to(a, shape).reshape(-1).copy()
    k0, k1 = _key(k)
    n = a.shape[0]
    if n == 0:
        return np.zeros(shape, dt)
    i = np.arange(n, dtype=np.int64)
    y0, y1 = threefry2x32(k0, k1, np.zeros(n, _U32), i.astype(_U32))
    keys0, keys1 = np.asarray(y0, _U32), np.asarray(y1, _U32)
    return _gamma_one(keys0, keys1, a, log_space).astype(dt).reshape(shape)


def gamma(k, a, shape=None, dtype=np.float64) -> np.ndarray:
    return _gamma(k, a, shape, dtype, False)


def loggamma(k, a, shape=None, dtype=np.float64) -> np.ndarray:
    return _gamma(k, a, shape, dtype, True)


def beta(k, a, b, shape=None, dtype=np.float64) -> np.ndarray:
    """``jax.random.beta``: two log-gammas under ``split(key)``, their
    ratio taken after subtracting the larger."""
    dt = np.dtype(dtype)
    a = np.asarray(a).astype(dt)
    b = np.asarray(b).astype(dt)
    shape = np.broadcast_shapes(a.shape, b.shape) if shape is None else tuple(shape)
    ka, kb = torch.from_numpy(_split_host(k, 2))
    la = loggamma(ka, np.broadcast_to(a, shape), shape, dt)
    lb = loggamma(kb, np.broadcast_to(b, shape), shape, dt)
    m = np.maximum(la, lb)
    ga, gb = np.exp(la - m), np.exp(lb - m)
    return ga / (ga + gb)


def _split_host(k: torch.Tensor, n: int) -> np.ndarray:
    k0, k1 = _key(k)
    return np.array([[int(a), int(b)] for a, b in _split(k0, k1, n)], np.int64)


# ------------------------------------------------------------ poisson

def _poisson_knuth(k0, k1, lam, shape):
    """Knuth's: count uniforms until their log-sum drops below -lam (f32,
    one split per round: ``rng, subkey = split(rng)``)."""
    count = np.zeros(shape, np.int64)
    log_prod = np.zeros(shape, np.float32)
    while (log_prod > -lam).any():
        (k0, k1), (s0, s1) = _split(k0, k1, 2)
        count = np.where(log_prod > -lam, count + 1, count)
        u = _uniform(s0, s1, shape, np.float32)
        log_prod = log_prod + _log(u)
    return count - 1


def _lgamma_f32(x):
    return torch.lgamma(torch.from_numpy(np.ascontiguousarray(x, np.float32))).numpy()


def _poisson_rejection(k0, k1, lam, shape):
    """Hormann's transformed rejection over the whole array (f32); an
    element accepted in a later round takes that round's draw."""
    f = np.float32
    log_lam = _log(lam)
    b = f(0.931) + f(2.53) * np.sqrt(lam)
    a = f(-0.059) + f(0.02483) * b
    inv_alpha = f(1.1239) + f(1.1328) / (b - f(3.4))
    v_r = f(0.9277) - f(3.6224) / (b - f(2))
    k_out = np.full(shape, -1, np.float32)
    accepted = np.zeros(shape, bool)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        while (~accepted).any():
            (k0, k1), (s0, s1), (t0, t1) = _split(k0, k1, 3)
            u = _uniform(s0, s1, shape, np.float32) - f(0.5)
            v = _uniform(t0, t1, shape, np.float32)
            us = f(0.5) - np.abs(u)
            k = np.floor((f(2) * a / us + b) * u + lam + f(0.43))
            s = np.log(v * inv_alpha / (a / (us * us) + b))
            t = -lam + k * log_lam - _lgamma_f32(k + f(1))
            accept1 = (us >= f(0.07)) & (v <= v_r)
            reject = (k < 0) | ((us < f(0.013)) & (v > us))
            accept = accept1 | (~reject & (s <= t))
            k_out = np.where(accept, k, k_out)
            accepted |= accept
    return k_out


def poisson(k: torch.Tensor, lam, shape=None, dtype=np.int64) -> np.ndarray:
    """``jax.random.poisson``: ``lam`` as f32; Knuth's below 10, the
    transformed rejection from 10 (both loops run on the same key, each
    element takes its branch's draw), 0 where ``lam == 0``."""
    lam = np.asarray(lam)
    shape = lam.shape if shape is None else tuple(shape)
    lam = np.broadcast_to(lam, shape).astype(np.float32)
    use_knuth = np.isnan(lam) | (lam < 10)
    lam_knuth = np.where(use_knuth, lam, np.float32(0))
    lam_rej = np.where(use_knuth, np.float32(1e5), lam)
    k0, k1 = _key(k)
    out = np.where(use_knuth, _poisson_knuth(k0, k1, lam_knuth, shape).astype(dtype),
                   _poisson_rejection(k0, k1, lam_rej, shape).astype(dtype))
    return np.where(lam == 0, np.zeros_like(out), out).astype(dtype)


# ------------------------------------------------------------ binomial

_STIRLING_TAIL = (0.0810614667953272, 0.0413406959554092, 0.0276779256849983,
                  0.02079067210376509, 0.0166446911898211, 0.0138761288230707,
                  0.0118967099458917, 0.0104112652619720, 0.00925546218271273,
                  0.00833056343336287)


def _stirling_tail(k):
    """JAX's ``_stirling_approx_tail``: the table below 10; past it the
    series, evaluated at k clamped to 9 as JAX evaluates it."""
    dt = k.dtype.type
    table = np.asarray(_STIRLING_TAIL, k.dtype)
    use_table = k <= 9
    kc = np.clip(k, dt(0), dt(9))
    kp1sq = (kc + 1) * (kc + 1)
    approx = (dt(1.0 / 12) - (dt(1.0 / 360) - dt(1.0 / 1260) / kp1sq) / kp1sq) / (kc + 1)
    return np.where(use_table, table[np.floor(kc).astype(np.int32)], approx)


def _binomial_inversion(k0, k1, count, prob, shape):
    dt = prob.dtype.type
    log1mp = np.log1p(-prob)
    num_geom = np.zeros(shape, prob.dtype)
    geom_sum = np.zeros(shape, prob.dtype)
    with np.errstate(divide="ignore", invalid="ignore"):
        while (geom_sum <= count).any():
            (s0, s1), (k0, k1) = _split(k0, k1, 2)
            num_geom = np.where(geom_sum <= count, num_geom + dt(1), num_geom)
            u = _uniform(s0, s1, shape, prob.dtype)
            geom_sum = geom_sum + np.ceil(np.log(u) / log1mp)
    return num_geom - dt(1)


def _btrs(k0, k1, count, prob, shape):
    """BTRS (Hormann) over the whole array; an element accepted in a later
    round takes that round's draw."""
    dt = prob.dtype.type
    one = dt(1)
    stddev = np.sqrt(count * prob * (one - prob))
    b = dt(1.15) + dt(2.53) * stddev
    a = dt(-0.0873) + dt(0.0248) * b + dt(0.01) * prob
    c = count * prob + dt(0.5)
    v_r = dt(0.92) - dt(4.2) / b
    r = prob / (one - prob)
    alpha = (dt(2.83) + dt(5.1) / b) * stddev
    m = np.floor((count + one) * prob)
    k_out = np.full(shape, -1, prob.dtype)
    accepted = np.zeros(shape, bool)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        while (~accepted).any():
            (k0, k1), (s0, s1), (t0, t1) = _split(k0, k1, 3)
            u = _uniform(s0, s1, shape, prob.dtype)
            v = _uniform(t0, t1, shape, prob.dtype)
            u = u - dt(0.5)
            us = dt(0.5) - np.abs(u)
            accept1 = (us >= dt(0.07)) & (v <= v_r)
            k = np.floor((dt(2) * a / us + b) * u + c)
            reject = (k < 0) | (k > count)
            v = np.log(v * alpha / (a / (us * us) + b))
            ub = ((m + dt(0.5)) * np.log((m + one) / (r * (count - m + one)))
                  + (count + one) * np.log((count - m + one) / (count - k + one))
                  + (k + dt(0.5)) * np.log(r * (count - k + one) / (k + one))
                  + _stirling_tail(m) + _stirling_tail(count - m)
                  - _stirling_tail(k) - _stirling_tail(count - k))
            accept = accept1 | (~reject & (v <= ub))
            k_out = np.where(accept, k, k_out)
            accepted |= accept
    return k_out


def binomial(k: torch.Tensor, n, p, shape=None, dtype=np.float64) -> np.ndarray:
    """``jax.random.binomial``: inversion where ``n * q <= 10`` (q the
    smaller of p and 1 - p), BTRS elsewhere, both on the same key; in
    p's float dtype (a Python float is f64, the JAX package's x64)."""
    p = np.asarray(p)
    if not np.issubdtype(p.dtype, np.floating):
        p = p.astype(np.float64)
    count = np.asarray(n).astype(p.dtype)
    shape = np.broadcast_shapes(count.shape, p.shape) if shape is None else tuple(shape)
    ft = p.dtype.type
    count = np.broadcast_to(count, shape)
    prob = np.broadcast_to(p, shape)
    p_lt_half = prob < 0.5
    q = np.where(p_lt_half, prob, ft(1) - prob)
    count_bad = np.isnan(count) | (count < 0)
    count_inf = np.isinf(count)
    q_nan = np.isnan(q)
    q_neg = q < 0
    q = np.where(q_nan | q_neg, ft(0.01), q).astype(p.dtype)
    use_inv = count_bad | (count * q <= 10)
    count = np.floor(count)
    count_inv = np.where(use_inv, count, ft(0)).astype(p.dtype)
    count_btrs = np.where(use_inv, ft(1e4), count).astype(p.dtype)
    q_btrs = np.where(use_inv, ft(0.5), q).astype(p.dtype)
    k0, k1 = _key(k)
    samples = np.where(use_inv, _binomial_inversion(k0, k1, count_inv, q, shape),
                       _btrs(k0, k1, count_btrs, q_btrs, shape)).astype(dtype)
    invalid = q_neg | q_nan | count_bad
    samples = np.where(invalid, np.nan, samples)
    samples = np.where(count_inf & ~invalid, np.inf, samples)
    keep = p_lt_half | count_bad | q_nan | count_inf
    return np.where(keep, samples, count.astype(dtype) - samples).astype(dtype)


def _tail_sums(p):
    """XLA's reverse cumulative sum along axis 0, in its order: up to 16
    elements, element i sums p[i], p[i + 1], ... from the left; longer
    axes go in blocks of 16 (zero-padded at the end), each element's sum
    within its block plus the tail sum of the later blocks' totals."""
    n = p.shape[0]
    if n <= 16:
        out = np.empty_like(p)
        for i in range(n):
            acc = p[i].copy()
            for j in range(i + 1, n):
                acc = acc + p[j]
            out[i] = acc
        return out
    nb = -(-n // 16)
    padded = np.concatenate([p, np.zeros((nb * 16 - n,) + p.shape[1:], p.dtype)])
    blocks = padded.reshape((nb, 16) + p.shape[1:])
    within = np.moveaxis(_tail_sums(np.moveaxis(blocks, 1, 0)), 0, 1)
    later = np.concatenate([_tail_sums(within[:, 0])[1:],
                            np.zeros((1,) + p.shape[1:], p.dtype)])
    return (within + later[:, None]).reshape((nb * 16,) + p.shape[1:])[:n]


def multinomial(k: torch.Tensor, n, p, shape=None, dtype=np.float64) -> np.ndarray:
    """``jax.random.multinomial``: a binomial per outcome (``split(key,
    K)``) of the remaining count at the outcome's share of the remaining
    probability."""
    p = np.asarray(p)
    if not np.issubdtype(p.dtype, np.floating):
        p = p.astype(np.float64)
    n = np.asarray(n).astype(p.dtype)
    shape = p.shape if shape is None else tuple(shape)
    n = np.broadcast_to(n, shape[:-1])
    p = np.moveaxis(np.broadcast_to(p, shape), -1, 0)
    remaining = _tail_sums(p)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratios = p / np.where(remaining == 0, p.dtype.type(1), remaining)
    keys = _split_host(k, ratios.shape[0])
    remainder, counts = n, []
    for ratio, kk in zip(ratios, keys):
        c = binomial(torch.from_numpy(kk), remainder, np.clip(ratio, 0, 1),
                     dtype=remainder.dtype)
        remainder = remainder - c
        counts.append(c)
    return np.moveaxis(np.stack(counts), 0, -1).astype(dtype)


def multivariate_normal(k: torch.Tensor, mean, cov, shape=None) -> np.ndarray:
    """``jax.random.multivariate_normal`` (the Cholesky factor times
    normals of the mean's dtype)."""
    dt = np.result_type(mean.dtype, cov.dtype, np.float32)
    mean, cov = mean.astype(dt), cov.astype(dt)
    if shape is None:
        shape = np.broadcast_shapes(mean.shape[:-1], cov.shape[:-2])
    factor = torch.linalg.cholesky(torch.from_numpy(np.ascontiguousarray(cov))).numpy()
    k0, k1 = _key(k)
    z = _normal(k0, k1, tuple(shape) + mean.shape[-1:], dt)
    return (mean + np.einsum("...ij,...j->...i", factor, z)).astype(dt)


def choice_without_replacement(k: torch.Tensor, p, n_draws: int) -> np.ndarray:
    """``jax.random.choice(p=, replace=False)``: Gumbel top-k, the top
    ``n_draws`` of ``gumbel + log(p)`` (ties to the lower index)."""
    dt = p.dtype
    info = np.finfo(dt)
    k0, k1 = _key(k)
    u = _uniform(k0, k1, p.shape, dt, info.tiny, 1.0)
    g = -torch.log(-torch.log(torch.from_numpy(np.ascontiguousarray(u)))).numpy()
    with np.errstate(divide="ignore"):
        g = g + np.log(p)
    return np.argsort(-g, kind="stable")[:n_draws].astype(np.int64)
