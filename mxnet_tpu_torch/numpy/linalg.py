"""``mx.np.linalg`` (counterpart of ``mxnet_tpu/numpy/linalg.py``) on
``torch.linalg``, through the funnel."""
from __future__ import annotations

import torch

from ..ndarray import NDArray, _cast, _inexact, apply, apply_multi

__all__ = ["norm", "svd", "cholesky", "qr", "inv", "pinv", "det", "slogdet", "eigh",
           "eigvalsh", "solve", "matrix_rank", "matrix_power", "multi_dot"]


def _arr(x):
    return x if isinstance(x, (NDArray, torch.Tensor)) else NDArray(x)


def _f(x):
    return _cast(x, _inexact(x.dtype))


def norm(x, ord=None, axis=None, keepdims=False):
    """``jnp.linalg.norm``: with ``ord=None`` the 2-norm of the flattened
    array (axis None) or of vectors along ``axis``; an ``ord`` with axis
    None is a vector norm of a 1-D array, a matrix norm of a 2-D one."""
    def fn(t):
        t = _f(t)
        if axis is None and ord is None:
            out = torch.linalg.vector_norm(t.reshape(-1))
            return out.reshape((1,) * t.dim()) if keepdims else out
        if axis is None and t.dim() == 2:
            return torch.linalg.matrix_norm(t, ord, dim=(0, 1), keepdim=keepdims)
        if isinstance(axis, (tuple, list)) and len(axis) == 2:
            return torch.linalg.matrix_norm(t, "fro" if ord is None else ord, dim=tuple(axis),
                                            keepdim=keepdims)
        return torch.linalg.vector_norm(t, 2 if ord is None else ord,
                                        dim=-1 if axis is None else axis, keepdim=keepdims)
    return apply(fn, _arr(x))


def svd(a, full_matrices=True, compute_uv=True):
    if not compute_uv:
        return apply(lambda t: torch.linalg.svdvals(_f(t)), _arr(a))
    return apply(lambda t: tuple(torch.linalg.svd(_f(t), full_matrices=full_matrices)), _arr(a))


def cholesky(a):
    return apply(lambda t: torch.linalg.cholesky(_f(t)), _arr(a))


def qr(a, mode="reduced"):
    return apply(lambda t: tuple(torch.linalg.qr(_f(t), mode=mode)), _arr(a))


def inv(a):
    return apply(lambda t: torch.linalg.inv(_f(t)), _arr(a))


def pinv(a):
    return apply(lambda t: torch.linalg.pinv(_f(t)), _arr(a))


def det(a):
    return apply(lambda t: torch.linalg.det(_f(t)), _arr(a))


def slogdet(a):
    return apply(lambda t: tuple(torch.linalg.slogdet(_f(t))), _arr(a))


def eigh(a, UPLO="L"):
    return apply(lambda t: tuple(torch.linalg.eigh(_f(t), UPLO=UPLO)), _arr(a))


def eigvalsh(a, UPLO="L"):
    return apply(lambda t: torch.linalg.eigvalsh(_f(t), UPLO=UPLO), _arr(a))


def solve(a, b):
    return apply_multi(lambda x, y: torch.linalg.solve(_f(x), _cast(y, _f(x).dtype)),
                       [_arr(a), _arr(b)])


def matrix_rank(a):
    return apply(lambda t: torch.linalg.matrix_rank(_f(t)), _arr(a))


def matrix_power(a, n):
    return apply(lambda t: torch.linalg.matrix_power(t, n), _arr(a))


def multi_dot(arrays):
    return apply_multi(lambda *ts: torch.linalg.multi_dot(list(ts)), [_arr(x) for x in arrays])


__all__ += ["eig", "eigvals", "lstsq", "cond", "tensorinv", "tensorsolve", "matrix_norm",
            "vector_norm", "svdvals", "vecdot", "matrix_transpose", "matmul", "outer", "cross",
            "trace", "diagonal"]


def eig(a):
    """Eigenvalues and right eigenvectors, complex (complex64 from f32)."""
    return apply(lambda t: tuple(torch.linalg.eig(_f(t))), _arr(a))


def eigvals(a):
    return apply(lambda t: torch.linalg.eigvals(_f(t)), _arr(a))


def svdvals(x):
    return apply(lambda t: torch.linalg.svdvals(_f(t)), _arr(x))


def lstsq(a, b, rcond=None, *, numpy_resid=False):
    """``(x, resid, rank, s)`` by the SVD, singular values below ``rcond *
    s[0]`` dropped (default ``eps * max(M, N)``), residuals always
    computed (the JAX package's default)."""
    def fn(x, y):
        dt = _inexact(torch.promote_types(x.dtype, y.dtype))
        x, y = _cast(x, dt), _cast(y, dt)
        one = y.dim() == 1
        y = y[:, None] if one else y
        m, n = x.shape
        rc = torch.finfo(dt).eps * max(n, m) if rcond is None else \
            (torch.finfo(dt).eps if rcond < 0 else rcond)
        u, s, vt = torch.linalg.svd(x, full_matrices=False)
        mask = (s > 0) & (s >= torch.tensor(rc, dtype=s.dtype) * s[0])
        rank = mask.sum()
        safe = torch.where(mask, s, torch.ones((), dtype=s.dtype, device=s.device))
        s_inv = torch.where(mask, 1 / safe, torch.zeros((), dtype=s.dtype, device=s.device))
        sol = vt.conj().T @ (s_inv[:, None] * (u.conj().T @ y))
        resid = torch.linalg.vector_norm(y - x @ sol, dim=0) ** 2
        return (sol.reshape(-1) if one else sol), resid, rank, s
    return apply_multi(fn, [_arr(a), _arr(b)])


def cond(x, p=None):
    def fn(t):
        t = _f(t)
        if p is None or p == 2:
            s = torch.linalg.svdvals(t)
            return s[..., 0] / s[..., -1]
        if p == -2:
            s = torch.linalg.svdvals(t)
            r = s[..., -1] / s[..., 0]
        else:
            r = torch.linalg.matrix_norm(t, p) * torch.linalg.matrix_norm(torch.linalg.inv(t), p)
        bad = torch.isnan(r) & ~torch.isnan(t).any(-1).any(-1)
        return torch.where(bad, torch.full((), float("inf"), dtype=r.dtype, device=r.device), r)
    return apply(fn, _arr(x))


def matrix_norm(x, /, *, keepdims=False, ord="fro"):
    return apply(lambda t: torch.linalg.matrix_norm(_f(t), ord, keepdim=keepdims), _arr(x))


def vector_norm(x, /, *, axis=None, keepdims=False, ord=2):
    def fn(t):
        t = _f(t)
        if axis is None:
            out = torch.linalg.vector_norm(t.reshape(-1), ord)
            return out.reshape((1,) * t.dim()) if keepdims else out
        return torch.linalg.vector_norm(t, ord, dim=axis, keepdim=keepdims)
    return apply(fn, _arr(x))


def vecdot(x1, x2, /, *, axis=-1):
    def fn(a, b):
        dt = torch.promote_types(a.dtype, b.dtype)
        a, b = torch.broadcast_tensors(_cast(a, dt), _cast(b, dt))
        return (a.conj() * b).sum(axis) if dt.is_complex else (a * b).sum(axis)
    return apply_multi(fn, [_arr(x1), _arr(x2)])


def matrix_transpose(x, /):
    return apply(lambda t: t.transpose(-1, -2), _arr(x))


def matmul(x1, x2, /):
    return apply_multi(lambda a, b: torch.matmul(*_same([a, b])), [_arr(x1), _arr(x2)])


def outer(x1, x2, /):
    return apply_multi(lambda a, b: torch.outer(*_same([a, b])), [_arr(x1), _arr(x2)])


def cross(x1, x2, /, *, axis=-1):
    return apply_multi(lambda a, b: torch.linalg.cross(*torch.broadcast_tensors(*_same([a, b])),
                                                       dim=axis), [_arr(x1), _arr(x2)])


def trace(x, /, *, offset=0, dtype=None):
    from ..ndarray import t_sum, to_torch_dtype
    return apply(lambda t: t_sum(torch.diagonal(t, offset, -2, -1), -1,
                                 to_torch_dtype(dtype)), _arr(x))


def diagonal(x, /, *, offset=0):
    return apply(lambda t: torch.diagonal(t, offset, -2, -1), _arr(x))


def _same(ts):
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [_cast(t, dt) for t in ts]


def tensorinv(a, ind=2):
    def fn(t):
        t = _f(t)
        out_shape = t.shape[ind:] + t.shape[:ind]
        n = int(torch.tensor(t.shape[:ind]).prod())
        return torch.linalg.inv(t.reshape(n, -1)).reshape(out_shape)
    return apply(fn, _arr(a))


def tensorsolve(a, b, axes=None):
    def fn(x, y):
        dt = _inexact(torch.promote_types(x.dtype, y.dtype))
        x, y = _cast(x, dt), _cast(y, dt)
        if axes is not None:
            allax = list(range(x.dim()))
            for k in axes:
                allax.remove(k % x.dim())
                allax.append(k % x.dim())
            x = x.permute(*allax)
        out_shape = x.shape[y.dim():]
        sol = torch.linalg.solve(x.reshape(y.numel(), -1), y.reshape(-1))
        return sol.reshape(out_shape)
    return apply_multi(fn, [_arr(a), _arr(b)])
