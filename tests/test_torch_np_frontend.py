"""The rest of ``mx.np`` and ``mx.np.linalg`` in the port against the JAX
package on the CPU, one case per name (and a few per name where the
options change the arithmetic): the same inputs, made with numpy from a
seed, through both; the result's dtype and shape must be the JAX
package's (which runs with x64).

Tolerances: integer, bool and index results exact; floats within 1e-6
relative (a 1e-6 floor) in f32 and 1e-12 in f64; complex the same on
their parts. Decompositions are compared by invariants: ``eig`` by its
residual ``|A v - v diag(w)|`` (1e-5 of ``|A|``) and its eigenvalues
sorted; ``lstsq`` by its solution and residuals (1e-5, the SVDs of LAPACK
and XLA differ in the last places).
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu.numpy as jnp_
import mxnet_tpu_torch as mx
import mxnet_tpu_torch.numpy as tnp

R = onp.random.RandomState(0)
F = R.randn(4, 5).astype("float32")
F2 = R.randn(4, 5).astype("float32")
FN = F.copy()
FN[1, 2] = FN[3, 0] = onp.nan
V = R.randn(7).astype("float32")
I = R.randint(-5, 9, (4, 5)).astype("int32")
IP = R.randint(0, 7, (9,)).astype("int32")
D = R.randn(6).astype("float64")
SQ = (R.randn(4, 4) + 4 * onp.eye(4)).astype("float32")
B8 = R.randint(0, 255, (3, 4)).astype("uint8")


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


def _host(x):
    if isinstance(x, (tuple, list)):
        return [_host(o) for o in x]
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    return x


def _same(got, want):
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    if not isinstance(want, onp.ndarray):
        assert got == want or (onp.isnan(got) and onp.isnan(want)), (got, want)
        return
    assert isinstance(got, onp.ndarray), type(got)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.dtype.kind in "biu":
        assert (got == want).all()
        return
    tol = 1e-12 if want.dtype in (onp.float64, onp.complex128) else 1e-6
    g, w = got.astype(onp.complex128), want.astype(onp.complex128)
    nan = onp.isnan(w)
    assert (onp.isnan(g) == nan).all()
    err = onp.abs(g[~nan] - w[~nan]) / onp.maximum(onp.abs(w[~nan]), 1e-6)
    assert err.size == 0 or err.max() <= tol, err.max()


CASES = {
    # elementwise
    "angle": lambda np: np.angle(np.array(F)),
    "conj": lambda np: np.conj(np.array(F)),
    "conjugate": lambda np: np.conjugate(np.array(I)),
    "real": lambda np: np.real(np.array(F)),
    "imag": lambda np: np.imag(np.array(F)),
    "fmod": lambda np: np.fmod(np.array(I), np.array(onp.full((4, 5), 3, "int32"))),
    "fmod_f": lambda np: np.fmod(np.array(F), np.array(F2)),
    "float_power": lambda np: np.float_power(np.array(onp.abs(F)), np.array(F2)),
    "heaviside": lambda np: np.heaviside(np.array(F), np.array(F2)),
    "nextafter": lambda np: np.nextafter(np.array(F), np.array(F2)),
    "logaddexp2": lambda np: np.logaddexp2(np.array(F), np.array(F2)),
    "i0": lambda np: np.i0(np.array(F)),
    "sinc": lambda np: np.sinc(np.array(onp.concatenate([V, [0.0]]).astype("float32"))),
    "isposinf": lambda np: np.isposinf(np.array(onp.array([1, onp.inf, -onp.inf], "float32"))),
    "isneginf": lambda np: np.isneginf(np.array(onp.array([1, onp.inf, -onp.inf], "float32"))),
    "nan_to_num": lambda np: np.nan_to_num(np.array(FN)),
    "gcd": lambda np: np.gcd(np.array(I), np.array(onp.full((4, 5), 6, "int32"))),
    "lcm": lambda np: np.lcm(np.array(I), np.array(onp.full((4, 5), 4, "int32"))),
    "ldexp": lambda np: np.ldexp(np.array(F), np.array(onp.full((4, 5), 3, "int32"))),
    "frexp": lambda np: np.frexp(np.array(F)),
    "modf": lambda np: np.modf(np.array(F * 3)),
    "divmod": lambda np: np.divmod(np.array(I), np.array(onp.full((4, 5), 3, "int32"))),
    "left_shift": lambda np: np.left_shift(np.array(IP), np.array(onp.full(9, 2, "int32"))),
    "right_shift": lambda np: np.right_shift(np.array(IP), np.array(onp.full(9, 1, "int32"))),
    "bitwise_left_shift": lambda np: np.bitwise_left_shift(np.array(IP), np.array(
        onp.full(9, 3, "int32"))),
    "bitwise_right_shift": lambda np: np.bitwise_right_shift(np.array(IP), np.array(
        onp.full(9, 1, "int32"))),
    "bitwise_invert": lambda np: np.bitwise_invert(np.array(I)),
    "array_equal": lambda np: [np.array_equal(np.array(F), np.array(F)),
                               np.array_equal(np.array(F), np.array(F2))],
    "array_equiv": lambda np: [np.array_equiv(np.array(F[0]), np.array(onp.tile(F[0], (3, 1)))),
                               np.array_equiv(np.array(F), np.array(F2))],
    # reductions
    "nansum": lambda np: [np.nansum(np.array(FN)), np.nansum(np.array(FN), axis=0)],
    "nansum_i": lambda np: np.nansum(np.array(I)),
    "nanprod": lambda np: np.nanprod(np.array(FN), axis=1),
    "nanmean": lambda np: [np.nanmean(np.array(FN)), np.nanmean(np.array(FN), axis=1)],
    "nanmean_i": lambda np: np.nanmean(np.array(I), axis=0),
    "nanstd": lambda np: np.nanstd(np.array(FN), axis=0),
    "nanvar": lambda np: [np.nanvar(np.array(FN)), np.nanvar(np.array(FN), axis=1, ddof=1)],
    "nanmin": lambda np: np.nanmin(np.array(FN), axis=0),
    "nanmax": lambda np: [np.nanmax(np.array(FN)), np.nanmax(np.array(FN), axis=1)],
    "nanargmin": lambda np: np.nanargmin(np.array(FN), axis=0),
    "nanargmax": lambda np: [np.nanargmax(np.array(FN)), np.nanargmax(np.array(FN), axis=1)],
    "nancumsum": lambda np: [np.nancumsum(np.array(FN)), np.nancumsum(np.array(I), axis=1)],
    "nancumprod": lambda np: np.nancumprod(np.array(FN), axis=0),
    "median": lambda np: [np.median(np.array(F)), np.median(np.array(F), axis=0)],
    "median_i": lambda np: np.median(np.array(I), axis=1),
    "nanmedian": lambda np: np.nanmedian(np.array(FN), axis=0),
    "percentile": lambda np: [np.percentile(np.array(F), 30.0),
                              np.percentile(np.array(F), onp.array([10.0, 90.0]), axis=1)],
    "nanpercentile": lambda np: np.nanpercentile(np.array(FN), 75.0, axis=0),
    "quantile": lambda np: [np.quantile(np.array(F), 0.3, axis=1, keepdims=True),
                            np.quantile(np.array(V), 0.4, method="lower"),
                            np.quantile(np.array(V), 0.4, method="higher"),
                            np.quantile(np.array(V), 0.45, method="nearest"),
                            np.quantile(np.array(V), 0.4, method="midpoint")],
    "nanquantile": lambda np: np.nanquantile(np.array(FN), 0.6),
    "average": lambda np: [np.average(np.array(F)),
                           np.average(np.array(F), axis=1, weights=np.array(onp.arange(
                               1, 6).astype("float32")))],
    "average_i": lambda np: np.average(np.array(I), axis=0),
    "ptp": lambda np: [np.ptp(np.array(I)), np.ptp(np.array(F), axis=0)],
    # shapes
    "atleast_3d": lambda np: np.atleast_3d(np.array(V)),
    "hsplit": lambda np: np.hsplit(np.array(onp.arange(12.0).reshape(2, 6).astype("float32")), 3),
    "vsplit": lambda np: np.vsplit(np.array(onp.arange(12.0).reshape(4, 3).astype("float32")), 2),
    "dsplit": lambda np: np.dsplit(np.array(onp.arange(16.0).reshape(2, 2, 4).astype(
        "float32")), [1, 3]),
    "rollaxis": lambda np: np.rollaxis(np.array(onp.zeros((2, 3, 4), "float32")), 2),
    "permute_dims": lambda np: np.permute_dims(np.array(F), (1, 0)),
    "resize": lambda np: np.resize(np.array(V), (3, 4)),
    "rot90": lambda np: [np.rot90(np.array(F)), np.rot90(np.array(F), 3)],
    "append": lambda np: [np.append(np.array(F), np.array(F2), axis=0),
                          np.append(np.array(I), np.array(IP))],
    "insert": lambda np: [np.insert(np.array(V), onp.array([1, 5]), 0.5),
                          np.insert(np.array(F), 1, np.array(onp.ones(5, "float32")), axis=0)],
    "delete": lambda np: [np.delete(np.array(V), 3),
                          np.delete(np.array(F), onp.array([0, 2]), axis=1)],
    "diagflat": lambda np: np.diagflat(np.array(V[:3]), 1),
    "row_stack": lambda np: np.row_stack([np.array(V), np.array(V)]),
    "trim_zeros": lambda np: np.trim_zeros(np.array(onp.array([0, 0, 1, 2, 0, 3, 0], "float32"))),
    "flatnonzero": lambda np: np.flatnonzero(np.array(I)),
    "diff": lambda np: [np.diff(np.array(I)), np.diff(np.array(F), n=2, axis=0)],
    "ediff1d": lambda np: np.ediff1d(np.array(IP)),
    "gradient": lambda np: np.gradient(np.array(V)),
    "gradient_2d": lambda np: np.gradient(np.array(F)),
    "trapezoid": lambda np: [np.trapezoid(np.array(F)), np.trapezoid(np.array(I), dx=0.5, axis=0)],
    "cross": lambda np: np.cross(np.array(F[:, :3]), np.array(F2[:, :3])),
    "vdot": lambda np: np.vdot(np.array(F), np.array(F2)),
    "kron": lambda np: [np.kron(np.array(F[:2, :2]), np.array(F2[:3, :2])),
                        np.kron(np.array(I[:2, :2]), np.array(I[:2, :3]))],
    # indexing and selection
    "choose": lambda np: np.choose(np.array(onp.array([0, 2, 1, 0], "int32")),
                                   [np.array(F[:, 0]), np.array(F[:, 1]), np.array(F[:, 2])]),
    "compress": lambda np: np.compress(np.array(onp.array([True, False, True])),
                                       np.array(F), axis=1),
    "extract": lambda np: np.extract(np.array(F > 0), np.array(F)),
    "select": lambda np: np.select([np.array(F < -0.5), np.array(F > 0.5)],
                                   [np.array(F * 2), np.array(F2)], 7.0),
    "piecewise": lambda np: np.piecewise(np.array(V), [np.array(V < 0), np.array(V >= 0)],
                                         [lambda x: -x, lambda x: x * 2]),
    "put_along_axis": lambda np: np.put_along_axis(
        np.array(F), np.array(onp.array([[1], [0], [4], [2]], "int64")), 9.0, axis=1,
        inplace=False),
    "partition": lambda np: np.partition(np.array(V), 3),
    "argpartition": lambda np: np.argpartition(np.array(V), 3),
    "lexsort": lambda np: np.lexsort((np.array(onp.array([1, 5, 1, 4, 3], "int32")),
                                      np.array(onp.array([9, 4, 0, 4, 0], "int32")))),
    "tril_indices": lambda np: np.tril_indices(4, 1),
    "triu_indices": lambda np: np.triu_indices(4, -1, 5),
    "tril_indices_from": lambda np: np.tril_indices_from(np.array(F)),
    "triu_indices_from": lambda np: np.triu_indices_from(np.array(F), 1),
    "diag_indices_from": lambda np: np.diag_indices_from(np.array(SQ)),
    "unravel_index": lambda np: np.unravel_index(np.array(onp.array([3, 17, 5], "int32")), (4, 5)),
    "ravel_multi_index": lambda np: np.ravel_multi_index(
        (np.array(onp.array([1, 3], "int32")), np.array(onp.array([4, 0], "int32"))), (4, 5)),
    "ix_": lambda np: np.ix_(np.array(onp.array([0, 2], "int32")),
                             np.array(onp.array([1, 3, 4], "int32"))),
    "indices": lambda np: np.indices((2, 3)),
    # sets
    "unique_all": lambda np: list(np.unique_all(np.array(IP))),
    "unique_inverse": lambda np: list(np.unique_inverse(np.array(I))),
    "unique_values": lambda np: np.unique_values(np.array(I)),
    "union1d": lambda np: np.union1d(np.array(IP), np.array(I)),
    "intersect1d": lambda np: np.intersect1d(np.array(IP), np.array(I)),
    "setdiff1d": lambda np: np.setdiff1d(np.array(IP), np.array(I[0])),
    "setxor1d": lambda np: np.setxor1d(np.array(IP), np.array(I[0])),
    "isin": lambda np: np.isin(np.array(I), np.array(IP)),
    # histograms and the rest
    "histogram": lambda np: list(np.histogram(np.array(V), bins=4)),
    "histogram_i": lambda np: list(np.histogram(np.array(IP), bins=3, range=(0, 6))),
    "histogram2d": lambda np: list(np.histogram2d(np.array(V), np.array(V[::-1]), bins=3)),
    "histogramdd": lambda np: (lambda r: [r[0]] + list(r[1]))(
        np.histogramdd(np.array(F[:, :3]), bins=2)),
    "bincount": lambda np: [np.bincount(np.array(IP)), np.bincount(np.array(IP), minlength=12)],
    "bincount_w": lambda np: np.bincount(np.array(IP), weights=np.array(D[:1].repeat(9))),
    "digitize": lambda np: [np.digitize(np.array(V), np.array(onp.array([-1, 0, 1], "float32"))),
                            np.digitize(np.array(V), np.array(onp.array([-1, 0, 1], "float32")),
                                        right=True)],
    "interp": lambda np: np.interp(np.array(V), np.array(onp.array([-1, 0, 1], "float32")),
                                   np.array(onp.array([2, 0, 5], "float32"))),
    "convolve": lambda np: [np.convolve(np.array(V), np.array(V[:3])),
                            np.convolve(np.array(V), np.array(V[:3]), "same"),
                            np.convolve(np.array(V), np.array(V[:3]), "valid")],
    "correlate": lambda np: [np.correlate(np.array(V), np.array(V[:3])),
                             np.correlate(np.array(V), np.array(V[:3]), "full")],
    "polyval": lambda np: np.polyval(np.array(V[:3]), np.array(F)),
    "vander": lambda np: [np.vander(np.array(IP[:4])), np.vander(np.array(V[:3]), 4, True)],
    "cov": lambda np: [np.cov(np.array(F)), np.cov(np.array(F), rowvar=False, bias=True)],
    "corrcoef": lambda np: np.corrcoef(np.array(F)),
    # the same array, and two of different data (two arrays made from one
    # numpy buffer may alias it in JAX, depending on its alignment)
    "may_share_memory": lambda np: (lambda x: [np.may_share_memory(x, x),
                                               np.may_share_memory(x, np.array(F2))])(
        np.array(F)),
    "shares_memory": lambda np: [np.shares_memory(np.array(F), np.array(F2))],
    "fill_diagonal": lambda np: np.fill_diagonal(np.array(F), 5.0),
    "blackman": lambda np: np.blackman(6),
    "hamming": lambda np: np.hamming(6),
    "hanning": lambda np: np.hanning(6),
    "get_include": lambda np: [np.get_include()],
    # the host-NumPy tier
    "packbits": lambda np: np.packbits(np.array(B8 > 100)),
    "unpackbits": lambda np: np.unpackbits(np.array(B8)),
    "poly": lambda np: np.poly(np.array(onp.array([1.0, 2.0, 3.0]))),
    "roots": lambda np: np.roots(np.array(onp.array([1.0, -3.0, 2.0]))),
    "polyfit": lambda np: np.polyfit(np.array(D), np.array(D ** 2), 2),
    "polyadd": lambda np: np.polyadd(np.array(D[:3]), np.array(D[:2])),
    "polysub": lambda np: np.polysub(np.array(D[:3]), np.array(D[:2])),
    "polymul": lambda np: np.polymul(np.array(D[:3]), np.array(D[:2])),
    "polydiv": lambda np: list(np.polydiv(np.array(D[:3]), np.array(D[:2]))),
    "busday_count": lambda np: [int(np.busday_count("2026-01-01", "2026-02-01"))],
    "is_busday": lambda np: [bool(np.is_busday("2026-01-03"))],
    # linalg
    "linalg.svdvals": lambda np: np.linalg.svdvals(np.array(F)),
    "linalg.cond": lambda np: [np.linalg.cond(np.array(SQ)), np.linalg.cond(np.array(SQ), "fro"),
                               np.linalg.cond(np.array(SQ), 1), np.linalg.cond(np.array(SQ), -2)],
    "linalg.matrix_norm": lambda np: [np.linalg.matrix_norm(np.array(F)),
                                      np.linalg.matrix_norm(np.array(F), ord=1),
                                      np.linalg.matrix_norm(np.array(SQ), ord="nuc",
                                                            keepdims=True)],
    "linalg.vector_norm": lambda np: [np.linalg.vector_norm(np.array(F)),
                                      np.linalg.vector_norm(np.array(F), axis=1, ord=1),
                                      np.linalg.vector_norm(np.array(F), ord=onp.inf,
                                                            keepdims=True)],
    "linalg.vecdot": lambda np: np.linalg.vecdot(np.array(F), np.array(F2)),
    "linalg.matrix_transpose": lambda np: np.linalg.matrix_transpose(np.array(F)),
    "linalg.matmul": lambda np: np.linalg.matmul(np.array(F), np.array(F2.T)),
    "linalg.outer": lambda np: np.linalg.outer(np.array(V), np.array(V[:3])),
    "linalg.cross": lambda np: np.linalg.cross(np.array(F[:, :3]), np.array(F2[:, :3])),
    "linalg.trace": lambda np: [np.linalg.trace(np.array(F)), np.linalg.trace(np.array(I), offset=1)],
    "linalg.diagonal": lambda np: np.linalg.diagonal(np.array(F), offset=-1),
    "linalg.tensorinv": lambda np: np.linalg.tensorinv(np.array(
        (onp.eye(4, dtype="float32") + 0.1 * SQ).reshape(2, 2, 4)), ind=2),
    "linalg.tensorsolve": lambda np: np.linalg.tensorsolve(
        np.array((onp.eye(6) * 3 + 0.1).reshape(2, 3, 6).astype("float32")),
        np.array(onp.arange(6.0).reshape(2, 3).astype("float32"))),
}


def _run(name, np):
    return _host(CASES[name](np))


@pytest.mark.parametrize("name", sorted(CASES))
def test_name_against_jax(name):
    _same(_run(name, tnp), _run(name, jnp_))


def _cplx_sorted(w):
    return w[onp.lexsort((w.imag, w.real))]


def test_linalg_eig_by_invariants():
    a = R.randn(5, 5).astype("float32")
    jw, jv = _host(jnp_.linalg.eig(jnp_.array(a)))
    tw, tv = _host(tnp.linalg.eig(tnp.array(a)))
    assert tw.dtype == jw.dtype == onp.complex64 and tv.dtype == jv.dtype
    res = onp.abs(a.astype(onp.complex128) @ tv - tv * tw).max()
    assert res <= 1e-5 * onp.abs(a).sum()
    onp.testing.assert_allclose(_cplx_sorted(tw), _cplx_sorted(jw), rtol=1e-5, atol=1e-5)
    ev = _host(tnp.linalg.eigvals(tnp.array(a)))
    assert ev.dtype == _host(jnp_.linalg.eigvals(jnp_.array(a))).dtype
    onp.testing.assert_allclose(_cplx_sorted(ev), _cplx_sorted(jw), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rcond", [None, 0.3])
def test_linalg_lstsq(rcond):
    a = R.randn(6, 3).astype("float32")
    a[:, 2] = a[:, 1] * 1e-3 + a[:, 0]
    b = R.randn(6, 2).astype("float32")
    want = _host(jnp_.linalg.lstsq(jnp_.array(a), jnp_.array(b), rcond=rcond))
    got = _host(tnp.linalg.lstsq(tnp.array(a), tnp.array(b), rcond=rcond))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        onp.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_unique_results_are_named_tuples():
    r = tnp.unique_all(tnp.array(IP))
    assert type(r).__name__ == "UniqueAllResult" and r._fields == jnp_.UniqueAllResult._fields
    r = tnp.unique_inverse(tnp.array(IP))
    assert r._fields == jnp_.UniqueInverseResult._fields


def test_can_cast_and_promote_types():
    """Host dtype queries: the JAX package's ``promote_types`` wrapper
    takes array arguments only, so it is held against ``jnp``'s answer."""
    import jax.numpy as jnp
    assert tnp.can_cast("int32", "float64") and not tnp.can_cast("float64", "int8")
    assert bool(jnp_.can_cast("int32", "float64").asnumpy())
    for a, b in (("int32", "float32"), ("uint8", "int8"), ("float16", "float64")):
        assert tnp.promote_types(a, b) == onp.dtype(jnp.promote_types(a, b))


def test_device_names():
    assert tnp.current_device() == mx.cpu() and tnp.Device("cpu") == mx.cpu()
    out = tnp.polyadd(tnp.array(D[:3]), tnp.array(D[:2]))
    assert out.device == mx.cpu()
