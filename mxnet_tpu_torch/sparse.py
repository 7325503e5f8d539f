"""Row-sparse and CSR arrays (counterpart of ``mxnet_tpu/sparse.py``).

Both keep the reference's storage (row ids plus their rows; CSR's data,
column indices and row pointers) in dense tensors on the arrays' device,
and their ops are gathers and scatters through the funnel, so they record
on the tape as the JAX package's do.

A ``RowSparseNDArray`` is what a table with ``grad_stype='row_sparse'``
gets as its gradient (``Embedding(sparse_grad=True)``): the tape cuts the
backward at the embedding gather (``_tape.backward``), and the rows
arrive deduplicated, ids sorted ascending. The JAX package pads the ids
to a static length with ``num_rows`` and leans on XLA's clamped gathers
and dropped scatters; here the gradient's ids are trimmed to the distinct
ones, and wherever padded ids can reach an op (``dedup_rows``' output,
a CSR union's tail, ``todense``, the lazy optimizer step) they are masked
out explicitly, never used as an index.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as onp
import torch

from .base import MXNetError
from .ndarray import NDArray, apply_multi, asarray

__all__ = ["RowSparseNDArray", "CSRNDArray", "row_sparse_array", "csr_matrix",
           "cast_storage", "dedup_rows"]


def _dedup(ids: torch.Tensor, vals: torch.Tensor):
    """(distinct ids ascending [u], their summed rows [u, ...]) of ``ids``
    [n] and ``vals`` [n, ...]."""
    uids, inv = torch.unique(ids, sorted=True, return_inverse=True)
    agg = torch.zeros((uids.shape[0],) + tuple(vals.shape[1:]), dtype=vals.dtype,
                      device=vals.device)
    return uids, agg.index_add_(0, inv, vals)


def dedup_rows(ids, vals, num_rows: int):
    """The JAX package's static-shape form: (the distinct ids ascending,
    padded to ``len(ids)`` with ``num_rows``, as int32; the summed rows,
    padded with zero rows)."""
    def fn(i, v):
        uids, agg = _dedup(i.reshape(-1).long(), v)
        n = i.numel()
        pad = torch.full((n - uids.shape[0],), num_rows, dtype=uids.dtype, device=uids.device)
        zeros = torch.zeros((n - agg.shape[0],) + tuple(v.shape[1:]), dtype=v.dtype,
                            device=v.device)
        return torch.cat([uids, pad]).int(), torch.cat([agg, zeros])
    return apply_multi(fn, [asarray(ids), asarray(vals)])


def _in_range(idx: torch.Tensor, n: int):
    """The mask of ids that name a row of an n-row table."""
    return (idx >= 0) & (idx < n)


class RowSparseNDArray:
    """Rows ``indices`` hold ``data``; every other row is zero."""

    stype = "row_sparse"

    def __init__(self, data, indices, shape: Tuple[int, ...]):
        self.data = asarray(data)
        self.indices = asarray(indices, dtype=onp.int32)
        self._shape = tuple(shape)

    @property
    def shape(self):
        return self._shape

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    def tostype(self, stype: str):
        if stype == "row_sparse":
            return self
        if stype == "default":
            return self.todense()
        raise MXNetError(f"cannot convert row_sparse to {stype}")

    def todense(self) -> NDArray:
        shape = self._shape

        def fn(d, i):
            keep = _in_range(i, shape[0])
            out = torch.zeros(shape, dtype=d.dtype, device=d.device)
            out[i[keep].long()] = d[keep]
            return out
        return apply_multi(fn, [self.data, self.indices], name="rsp_todense")

    def asnumpy(self):
        return self.todense().asnumpy()

    def __repr__(self):
        return f"RowSparseNDArray(shape={self._shape}, nnz_rows={self.indices.shape[0]})"

    def retain(self, indices) -> "RowSparseNDArray":
        """The rows ``indices`` (the kvstore's row-sparse pull)."""
        indices = asarray(indices, dtype=onp.int32)
        vals = apply_multi(lambda d, i: d[i.long()], [self.todense(), indices])
        return RowSparseNDArray(vals, indices, self._shape)


def _rows_of(indptr: torch.Tensor, nnz: int) -> torch.Tensor:
    """The row of each stored value (``nrows`` for slots past the last row
    pointer)."""
    pos = torch.arange(nnz, dtype=indptr.dtype, device=indptr.device)
    return torch.searchsorted(indptr, pos, right=True) - 1


class CSRNDArray:
    """Compressed sparse rows."""

    stype = "csr"

    def __init__(self, data, indices, indptr, shape: Tuple[int, ...]):
        self.data = asarray(data)
        self.indices = asarray(indices, dtype=onp.int32)
        self.indptr = asarray(indptr, dtype=onp.int32)
        self._shape = tuple(shape)

    @property
    def shape(self):
        return self._shape

    @property
    def dtype(self):
        return self.data.dtype

    def todense(self) -> NDArray:
        shape = self._shape

        def fn(data, indices, indptr):
            rows = _rows_of(indptr, data.shape[0])
            keep = rows < shape[0]
            out = torch.zeros(shape, dtype=data.dtype, device=data.device)
            return out.index_put((rows[keep].long(), indices[keep].long()), data[keep],
                                 accumulate=True)
        return apply_multi(fn, [self.data, self.indices, self.indptr], name="csr_todense")

    def tostype(self, stype: str):
        if stype == "csr":
            return self
        if stype == "default":
            return self.todense()
        raise MXNetError(f"cannot convert csr to {stype}")

    def asnumpy(self):
        return self.todense().asnumpy()

    def dot(self, rhs) -> NDArray:
        """csr @ dense: gathered rows of ``rhs`` scaled by the stored values,
        summed per row."""
        nrows = self._shape[0]

        def fn(data, indices, indptr, dense):
            rows = _rows_of(indptr, data.shape[0])
            keep = rows < nrows
            contrib = data[keep, None] * dense[indices[keep].long()]
            out = torch.zeros((nrows,) + tuple(dense.shape[1:]), dtype=contrib.dtype,
                              device=contrib.device)
            return out.index_add_(0, rows[keep].long(), contrib)
        return apply_multi(fn, [self.data, self.indices, self.indptr, asarray(rhs)],
                           name="csr_dot")

    def _rows(self) -> NDArray:
        return apply_multi(lambda d, p: _rows_of(p, d.shape[0]), [self.data, self.indptr],
                           name="csr_rows")

    def _elemwise_union(self, other: "CSRNDArray", sign: float) -> "CSRNDArray":
        """``self + sign * other`` over the union of the structures, in the
        JAX package's layout: nnz_a + nnz_b slots, the distinct (row, col)
        cells first in order, zero padding past the last row pointer."""
        if self._shape != other._shape:
            raise MXNetError(f"csr elemwise: shape mismatch {self._shape} vs {other._shape}")
        nrows, ncols = self._shape

        def fn(da, ia, pa, db, ib, pb):
            ra, rb = _rows_of(pa, da.shape[0]), _rows_of(pb, db.shape[0])
            lin = torch.cat([ra.long() * ncols + ia.long(), rb.long() * ncols + ib.long()])
            vals = torch.cat([da.float(), sign * db.float()])
            n, fill = lin.shape[0], nrows * ncols
            ulin, inv = torch.unique(lin, sorted=True, return_inverse=True)
            merged = torch.zeros(n, dtype=torch.float32, device=da.device)
            merged.index_add_(0, inv, vals)
            ulin = torch.cat([ulin, torch.full((n - ulin.shape[0],), fill,
                                               dtype=ulin.dtype, device=ulin.device)])
            rows = torch.clamp(ulin // ncols, max=nrows)
            cols = torch.where(ulin < fill, ulin % ncols, torch.zeros_like(ulin))
            counts = torch.bincount(rows, minlength=nrows + 1)[:nrows]
            indptr = torch.cat([torch.zeros(1, dtype=torch.int32, device=da.device),
                                torch.cumsum(counts, 0).int()])
            return merged.to(da.dtype), cols.int(), indptr
        data, cols, indptr = apply_multi(
            fn, [self.data, self.indices, self.indptr, other.data, other.indices,
                 other.indptr], name="csr_elemwise")
        return CSRNDArray(data, cols, indptr, self._shape)

    def __add__(self, other):
        if isinstance(other, CSRNDArray):
            return self._elemwise_union(other, 1.0)
        return self.todense() + asarray(other)

    def __sub__(self, other):
        if isinstance(other, CSRNDArray):
            return self._elemwise_union(other, -1.0)
        return self.todense() - asarray(other)

    def __mul__(self, other):
        """csr * scalar scales the values; csr * csr keeps this structure,
        zero where ``other`` has no cell; csr * dense multiplies each stored
        value by its dense cell."""
        if isinstance(other, (int, float)):
            return CSRNDArray(self.data * float(other), self.indices, self.indptr, self._shape)
        nrows, ncols = self._shape
        if isinstance(other, CSRNDArray):
            def fn(da, ia, pa, db, ib, pb):
                ra, rb = _rows_of(pa, da.shape[0]), _rows_of(pb, db.shape[0])
                lin_a = ra.long() * ncols + ia.long()
                lin_b = rb.long() * ncols + ib.long()
                sorted_b, order = torch.sort(lin_b, stable=True)
                pos = torch.clamp(torch.searchsorted(sorted_b, lin_a), 0, db.shape[0] - 1)
                match = sorted_b[pos] == lin_a
                return torch.where(match, da * db[order][pos], torch.zeros_like(da))
            data = apply_multi(fn, [self.data, self.indices, self.indptr, other.data,
                                    other.indices, other.indptr], name="csr_mul_csr")
            return CSRNDArray(data, self.indices, self.indptr, self._shape)

        def fn2(da, ia, pa, dn):
            rows = _rows_of(pa, da.shape[0])
            keep = rows < nrows
            cell = dn[torch.where(keep, rows, torch.zeros_like(rows)).long(), ia.long()]
            return torch.where(keep, da * cell, torch.zeros_like(da))
        data = apply_multi(fn2, [self.data, self.indices, self.indptr, asarray(other)],
                           name="csr_mul_dense")
        return CSRNDArray(data, self.indices, self.indptr, self._shape)

    __rmul__ = __mul__

    def __repr__(self):
        return f"CSRNDArray(shape={self._shape}, nnz={self.data.shape[0]})"


def row_sparse_array(arg, shape: Optional[Tuple[int, ...]] = None,
                     dtype=None) -> RowSparseNDArray:
    """From ``(data, indices)`` with ``shape``, or from a dense array (its
    rows with any non-zero)."""
    if isinstance(arg, tuple) and len(arg) == 2:
        data, indices = arg
        if shape is None:
            raise MXNetError("shape required with (data, indices)")
        return RowSparseNDArray(NDArray(data, dtype=dtype), NDArray(indices), shape)
    dense = asarray(arg, dtype=dtype)
    arr = dense.asnumpy()
    nz_rows = onp.where(onp.any(arr != 0, axis=tuple(range(1, arr.ndim))))[0]
    dev = dense.device
    return RowSparseNDArray(NDArray(arr[nz_rows], device=dev),
                            NDArray(nz_rows.astype(onp.int32), device=dev), arr.shape)


def csr_matrix(arg, shape: Optional[Tuple[int, ...]] = None, dtype=None) -> CSRNDArray:
    """From ``(data, indices, indptr)`` with ``shape``, or from a dense 2-D
    array."""
    if isinstance(arg, tuple) and len(arg) == 3:
        data, indices, indptr = arg
        if shape is None:
            raise MXNetError("shape required with (data, indices, indptr)")
        return CSRNDArray(NDArray(data, dtype=dtype), NDArray(indices), NDArray(indptr), shape)
    dense_nd = asarray(arg, dtype=dtype)
    dense = dense_nd.asnumpy()
    if dense.ndim != 2:
        raise MXNetError("csr_matrix needs 2-D input")
    rows, cols = onp.nonzero(dense)
    indptr = onp.concatenate([[0], onp.cumsum(onp.bincount(rows, minlength=dense.shape[0]))])
    dev = dense_nd.device
    return CSRNDArray(NDArray(dense[rows, cols], device=dev),
                      NDArray(cols.astype(onp.int32), device=dev),
                      NDArray(indptr.astype(onp.int32), device=dev), dense.shape)


def cast_storage(arr, stype: str):
    """The storage ``stype`` ('default', 'row_sparse' or 'csr') of ``arr``."""
    if isinstance(arr, (RowSparseNDArray, CSRNDArray)):
        return arr.tostype(stype)
    if stype == "default":
        return asarray(arr)
    if stype == "row_sparse":
        return row_sparse_array(arr)
    if stype == "csr":
        return csr_matrix(arr)
    raise MXNetError(f"unknown stype {stype}")
