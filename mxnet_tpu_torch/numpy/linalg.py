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
    array (axis None) or of vectors along ``axis``."""
    def fn(t):
        t = _f(t)
        if axis is None and ord is None:
            out = torch.linalg.vector_norm(t.reshape(-1))
            return out.reshape((1,) * t.dim()) if keepdims else out
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
