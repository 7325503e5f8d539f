"""Port parity of row-sparse gradients, lazy optimizer steps and the
sparse arrays: the cases of ``tests/test_sparse_grad.py`` (all but the
kvstore's ``row_sparse_pull``, which waits with the kvstore) run through
``mxnet_tpu`` (JAX on the CPU) and ``mxnet_tpu_torch`` under ``with
mx.cpu():`` on the same numpy ids, targets and table.

Tolerances: a row-sparse gradient's ids equal JAX's (JAX's padding,
``num_rows``, stripped: the port trims its ids to the distinct ones) and
its rows within 1e-6; weights after SGD and Adam lazy steps within 1e-6
relative (plus 1e-7 absolute) of JAX's; rows no batch touched, and their
Adam moments, bit for bit their start; sparse against dense within the
port as ``test_sparse_grad.py`` holds it (2e-5); CSR results within 1e-6.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import np as jnp_
from mxnet_tpu.gluon import Trainer as JTrainer
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.sparse import RowSparseNDArray as JRsp

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, np
from mxnet_tpu_torch.gluon import Trainer, nn
from mxnet_tpu_torch.sparse import RowSparseNDArray

VOCAB, DIM = 50, 8
TABLE = onp.random.RandomState(42).randn(VOCAB, DIM).astype("float32")
PORT = (mx, np, nn, autograd, Trainer, RowSparseNDArray)
JAX = (jmx, jnp_, jnn, jautograd, JTrainer, JRsp)


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


def _build(pkg, sparse):
    _, m_np, m_nn = pkg[:3]
    emb = m_nn.Embedding(VOCAB, DIM, sparse_grad=sparse)
    emb.initialize()
    emb.weight.set_data(m_np.array(TABLE))
    return emb


def _ids(m_np, a):
    return m_np.array(onp.asarray(a, "int32"), dtype=onp.int32)


def _rsp(g):
    """(ids, rows) of a row-sparse gradient, JAX's padding stripped."""
    ids, rows = g.indices.asnumpy(), g.data.asnumpy()
    keep = ids < VOCAB
    return ids[keep], rows[keep]


def _grad_np(g):
    return g.todense().asnumpy() if hasattr(g, "todense") else g.asnumpy()


def test_rsp_grad_matches_dense():
    rs = onp.random.RandomState(0)
    ids = rs.randint(0, VOCAB, (4, 6))
    grads = []
    for pkg in (PORT, JAX):
        _, m_np, _, m_ag, _, Rsp = pkg
        emb = _build(pkg, True)
        with m_ag.record():
            (emb(_ids(m_np, ids)) ** 2).sum().backward()
        g = emb.weight.grad()
        assert isinstance(g, Rsp)
        grads.append(g)
    (ti, tr), (ji, jr) = _rsp(grads[0]), _rsp(grads[1])
    onp.testing.assert_array_equal(ti, ji)
    onp.testing.assert_array_equal(ti, onp.unique(ids))
    onp.testing.assert_allclose(tr, jr, rtol=1e-6, atol=1e-7)
    dense = _build(PORT, False)
    with autograd.record():
        (dense(_ids(np, ids)) ** 2).sum().backward()
    onp.testing.assert_allclose(grads[0].todense().asnumpy(), dense.weight.grad().asnumpy(),
                                rtol=1e-5)


@pytest.mark.parametrize("optim,kw", [("sgd", {"learning_rate": 0.1}),
                                      ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
                                      ("adam", {"learning_rate": 0.01})])
def test_sparse_training_matches_dense(optim, kw):
    """Five lazy steps touching every row: equal to the port's dense steps
    and to the JAX package's lazy steps."""
    rs = onp.random.RandomState(1)
    batches = [(rs.permutation(VOCAB).reshape(5, 10), rs.randn(5, 10, DIM).astype("float32"))
               for _ in range(5)]
    out = []
    for pkg, sparse in ((PORT, True), (PORT, False), (JAX, True)):
        _, m_np, _, m_ag, m_tr, _ = pkg
        emb = _build(pkg, sparse)
        tr = m_tr(emb.collect_params(), optim, dict(kw))
        for ids, tgt in batches:
            with m_ag.record():
                loss = ((emb(_ids(m_np, ids)) - m_np.array(tgt)) ** 2).mean()
            loss.backward()
            tr.step(1)
        out.append(emb.weight.data().asnumpy())
    onp.testing.assert_allclose(out[0], out[1], rtol=2e-5, atol=2e-6)
    onp.testing.assert_allclose(out[0], out[2], rtol=1e-6, atol=1e-7)


def test_lazy_update_untouched_rows_keep_state():
    """Adam with weight decay: rows never looked up keep their weights and
    both moments bit for bit; looked-up rows move as the JAX package's."""
    ids = [[1, 2, 3]]
    out = []
    for pkg in (PORT, JAX):
        _, m_np, _, m_ag, m_tr, _ = pkg
        emb = _build(pkg, True)
        tr = m_tr(emb.collect_params(), "adam", {"learning_rate": 0.05, "wd": 0.1})
        for _ in range(3):
            with m_ag.record():
                loss = (emb(_ids(m_np, ids)) ** 2).sum()
            loss.backward()
            tr.step(1)
        out.append(emb.weight.data().asnumpy())
        if pkg is PORT:
            moments = [s.numpy() for s in tr._states[0]]
    touched = onp.zeros(VOCAB, bool)
    touched[[1, 2, 3]] = True
    onp.testing.assert_array_equal(out[0][~touched], TABLE[~touched])
    for m in moments:
        onp.testing.assert_array_equal(m[~touched], 0.0)
        assert (m[touched] != 0).any()
    assert not onp.allclose(out[0][touched], TABLE[touched])
    onp.testing.assert_allclose(out[0], out[1], rtol=1e-6, atol=1e-7)


def test_multiple_lookups_merge():
    """Two lookups of one table in one graph give one row-sparse gradient."""
    rs = onp.random.RandomState(2)
    a, b = rs.randint(0, VOCAB, (2, 3)), rs.randint(0, VOCAB, (4,))
    grads = []
    for pkg in (PORT, JAX):
        _, m_np, _, m_ag, _, Rsp = pkg
        emb = _build(pkg, True)
        with m_ag.record():
            (emb(_ids(m_np, a)).sum() + (emb(_ids(m_np, b)) * 3).sum()).backward()
        assert isinstance(emb.weight.grad(), Rsp)
        grads.append(_rsp(emb.weight.grad()))
    onp.testing.assert_array_equal(grads[0][0], grads[1][0])
    onp.testing.assert_allclose(grads[0][1], grads[1][1], rtol=1e-6)


def test_dense_fallback_when_weight_used_elsewhere():
    """A table also used by another op gets a dense gradient, the JAX
    package's."""
    grads = []
    for pkg in (PORT, JAX):
        _, m_np, _, m_ag, _, Rsp = pkg
        emb = _build(pkg, True)
        with m_ag.record():
            loss = emb(_ids(m_np, [[0, 1]])).sum() + (emb.weight.data() * 0.5).sum()
        loss.backward()
        g = emb.weight.grad()
        assert not isinstance(g, Rsp) and g.shape == (VOCAB, DIM)
        grads.append(g.asnumpy())
    onp.testing.assert_allclose(grads[0], grads[1], rtol=1e-6)


def test_grad_add_survives_storage_flip():
    """Under grad_req='add' a row-sparse deposit, a dense one and a
    row-sparse one again all accumulate (the storage flips to dense)."""
    grads = []
    for pkg in (PORT, JAX):
        _, m_np, _, m_ag, _, Rsp = pkg
        emb = _build(pkg, True)
        emb.weight.grad_req = "add"
        emb.weight.data().attach_grad("add", stype="row_sparse")
        ids = _ids(m_np, [0, 1])
        with m_ag.record():
            emb(ids).sum().backward()
        assert isinstance(emb.weight.grad(), Rsp)
        with m_ag.record():
            (emb.weight.data() * 1.0).sum().backward()
        with m_ag.record():
            emb(ids).sum().backward()
        g = emb.weight.grad()
        assert not isinstance(g, Rsp)
        grads.append(g.asnumpy())
    exp = onp.ones((VOCAB, DIM), onp.float32)
    exp[:2] += 2
    onp.testing.assert_allclose(grads[0], exp)
    onp.testing.assert_allclose(grads[0], grads[1])


def test_rsp_leaf_as_head_falls_back_dense():
    grads = []
    for pkg in (PORT, JAX):
        _, m_np, _, m_ag, _, Rsp = pkg
        emb = _build(pkg, True)
        w = emb.weight.data()
        with m_ag.record():
            y = emb(_ids(m_np, [2, 3])).sum()
        m_ag.backward([y, w])
        g = emb.weight.grad()
        assert not isinstance(g, Rsp)
        grads.append(g.asnumpy())
    exp = onp.ones((VOCAB, DIM), onp.float32)
    exp[2:4] += 1
    onp.testing.assert_allclose(grads[0], exp)
    onp.testing.assert_allclose(grads[0], grads[1])


def test_lars_densifies_rsp_grad():
    """LARS needs whole-weight norms: the trainer densifies, and the step
    equals a dense-gradient LARS step and the JAX package's."""
    out = []
    for pkg, sparse in ((PORT, True), (PORT, False), (JAX, True)):
        _, m_np, _, m_ag, m_tr, _ = pkg
        emb = _build(pkg, sparse)
        tr = m_tr(emb.collect_params(), "lars", {"learning_rate": 0.05, "momentum": 0.9})
        with m_ag.record():
            loss = (emb(_ids(m_np, [[5, 6, 7, 5]])) ** 2).sum()
        loss.backward()
        tr.step(1)
        out.append(emb.weight.data().asnumpy())
    onp.testing.assert_allclose(out[0], out[1], rtol=1e-6)
    onp.testing.assert_allclose(out[0], out[2], rtol=1e-6)


def test_retain_graph_rebackward_sees_mutated_weight():
    """A second backward with ``retain_graph`` after ``set_data`` gives the
    sparse table what it gives the dense one. (The port's graph keeps the
    values the forward saw, in both; the JAX package's replay reads the
    mutated weight in both: a declared difference of the port's tape.)"""
    grads = []
    for sparse in (True, False):
        emb = _build(PORT, sparse)
        ids = _ids(np, [1, 2])
        with autograd.record():
            y = (emb(ids) ** 2).sum()
        y.backward(retain_graph=True)
        emb.weight.set_data(emb.weight.data() * 2.0)
        y.backward()
        grads.append(_grad_np(emb.weight.grad()))
    onp.testing.assert_allclose(grads[0], grads[1], rtol=1e-5)


def test_dedup_rows_matches_jax():
    """``dedup_rows``' static-shape form: ids padded with num_rows, rows
    summed, padding rows zero."""
    from mxnet_tpu.sparse import dedup_rows as jdedup
    from mxnet_tpu_torch.sparse import dedup_rows
    rs = onp.random.RandomState(4)
    ids = rs.randint(0, VOCAB, (12,)).astype("int32")
    vals = rs.randn(12, DIM).astype("float32")
    (tu, ta), (ju, ja) = dedup_rows(ids, vals, VOCAB), jdedup(ids, vals, VOCAB)
    onp.testing.assert_array_equal(tu.asnumpy(), onp.asarray(ju))
    assert tu.dtype == onp.int32
    onp.testing.assert_allclose(ta.asnumpy(), onp.asarray(ja), rtol=1e-6)
    rsp = RowSparseNDArray(ta, tu, (VOCAB, DIM))
    dense = onp.zeros((VOCAB, DIM), "float32")
    onp.add.at(dense, ids, vals)
    onp.testing.assert_allclose(rsp.todense().asnumpy(), dense, rtol=1e-6, atol=1e-6)


def _csr_pair(seed, shape, p):
    rs = onp.random.RandomState(seed)
    a = onp.where(rs.rand(*shape) > p, rs.randn(*shape), 0).astype("float32")
    b = onp.where(rs.rand(*shape) > p, rs.randn(*shape), 0).astype("float32")
    return a, b


def _csr_parts(c):
    return [c.data.asnumpy(), c.indices.asnumpy(), c.indptr.asnumpy()]


@pytest.mark.parametrize("op", ["add", "sub"])
def test_csr_elemwise_add_sub_union(op):
    """csr +/- csr over the union of the structures, in the JAX package's
    static layout (nnz_a + nnz_b slots)."""
    from mxnet_tpu.sparse import csr_matrix as jcsr
    from mxnet_tpu_torch.sparse import csr_matrix
    A, B = _csr_pair(0, (5, 7), 0.6)
    fn = (lambda x, y: x + y) if op == "add" else (lambda x, y: x - y)
    t, j = fn(csr_matrix(A), csr_matrix(B)), fn(jcsr(A), jcsr(B))
    assert t.stype == "csr" and t.data.shape[0] == csr_matrix(A).data.shape[0] + \
        csr_matrix(B).data.shape[0]
    for x, y in zip(_csr_parts(t), _csr_parts(j)):
        onp.testing.assert_allclose(x, y, atol=1e-6)
    onp.testing.assert_allclose(t.asnumpy(), fn(A, B), atol=1e-6)


def test_csr_mul_paths():
    from mxnet_tpu.sparse import csr_matrix as jcsr
    from mxnet_tpu_torch.sparse import csr_matrix
    A, B = _csr_pair(1, (4, 6), 0.5)
    D = onp.random.RandomState(9).randn(4, 6).astype("float32")
    ta, tb, ja, jb = csr_matrix(A), csr_matrix(B), jcsr(A), jcsr(B)
    for t, j, want in ((ta * 2.5, ja * 2.5, A * 2.5), (ta * tb, ja * jb, A * B),
                       (ta * np.array(D), ja * jnp_.array(D), A * D)):
        onp.testing.assert_allclose(t.data.asnumpy(), j.data.asnumpy(), rtol=1e-6, atol=1e-7)
        onp.testing.assert_allclose(t.asnumpy(), want, rtol=1e-6, atol=1e-6)


def test_csr_dot_and_cast_storage():
    from mxnet_tpu.sparse import cast_storage as jcast
    from mxnet_tpu.sparse import csr_matrix as jcsr
    from mxnet_tpu_torch.sparse import cast_storage, csr_matrix
    rs = onp.random.RandomState(2)
    A = onp.where(rs.rand(6, 4) > 0.5, rs.randn(6, 4), 0).astype("float32")
    X = rs.randn(4, 3).astype("float32")
    t, j = csr_matrix(A), jcsr(A)
    for x, y in zip(_csr_parts(t), _csr_parts(j)):
        onp.testing.assert_array_equal(x, y)
    onp.testing.assert_allclose(t.dot(np.array(X)).asnumpy(), j.dot(jnp_.array(X)).asnumpy(),
                                rtol=1e-6, atol=1e-6)
    onp.testing.assert_allclose(cast_storage(t, "default").asnumpy(), A)
    again = cast_storage(np.array(A), "csr")
    assert again.stype == "csr"
    for x, y in zip(_csr_parts(again), _csr_parts(jcast(jnp_.array(A), "csr"))):
        onp.testing.assert_array_equal(x, y)
    rsp = cast_storage(np.array(A), "row_sparse")
    onp.testing.assert_array_equal(rsp.indices.asnumpy(),
                                   jcast(jnp_.array(A), "row_sparse").indices.asnumpy())
    onp.testing.assert_array_equal(rsp.todense().asnumpy(), A)
    # the port's NDArray.tostype converts (the JAX package's raises)
    onp.testing.assert_array_equal(np.array(A).tostype("csr").asnumpy(), A)
    onp.testing.assert_array_equal(np.array(A).tostype("row_sparse").retain(
        np.array(onp.array([0, 3], "int32"))).todense().asnumpy()[[0, 3]], A[[0, 3]])


def _legacy_sparse_file(path, dense_rsp, dense_csr):
    """A reference legacy list file (dmlc V2) holding a row-sparse and a
    CSR array: storage shape, aux descriptors, the values, then the aux
    arrays (row ids; indptr and column ids)."""
    import struct

    def entry(stype, shape, data, aux):
        out = [struct.pack("<Ii", 0xF993FAC9, stype), struct.pack("<i", data.ndim),
               struct.pack(f"<{data.ndim}q", *data.shape), struct.pack("<i", len(shape)),
               struct.pack(f"<{len(shape)}q", *shape), struct.pack("<iii", 1, 0, 0)]
        for a in aux:
            out.append(struct.pack("<ii", 6, a.ndim) + struct.pack(f"<{a.ndim}q", *a.shape))
        out.append(data.astype("<f4").tobytes())
        out += [a.astype("<i8").tobytes() for a in aux]
        return b"".join(out)

    rows = onp.nonzero(dense_rsp.any(axis=1))[0]
    r, c = onp.nonzero(dense_csr)
    indptr = onp.concatenate([[0], onp.cumsum(onp.bincount(r, minlength=dense_csr.shape[0]))])
    blob = struct.pack("<QQQ", 0x112, 0, 2) + \
        entry(1, dense_rsp.shape, dense_rsp[rows], [rows]) + \
        entry(2, dense_csr.shape, dense_csr[r, c], [indptr, c])
    names = [b"rsp", b"csr"]
    blob += struct.pack("<Q", len(names)) + b"".join(struct.pack("<Q", len(n)) + n for n in names)
    with open(path, "wb") as f:
        f.write(blob)


def test_legacy_sparse_payloads_load_dense(tmp_path):
    """Row-sparse and CSR payloads of a reference file load as dense arrays
    in both packages."""
    rs = onp.random.RandomState(5)
    dense_rsp = onp.where(rs.rand(6, 3) > 0.5, rs.randn(6, 3), 0).astype("float32")
    dense_rsp[2] = 0
    dense_csr = onp.where(rs.rand(4, 5) > 0.6, rs.randn(4, 5), 0).astype("float32")
    f = str(tmp_path / "sparse.params")
    _legacy_sparse_file(f, dense_rsp, dense_csr)
    got, want = mx.load(f), jmx.load(f)
    for k, dense in (("rsp", dense_rsp), ("csr", dense_csr)):
        onp.testing.assert_array_equal(got[k].asnumpy(), dense)
        onp.testing.assert_array_equal(got[k].asnumpy(), want[k].asnumpy())
