"""The graph partitioner on the CPU (``ops/partitioner.py``) against the
JAX package's jaxpr partitioner (``mxnet_tpu/ops/partitioner.py``), on the
same numpy weights and inputs:

- ``int8_dot_property`` carves every matrix product, quantizes both
  operands to the same int8 codes as the JAX package's (its codes are read
  where its ``dot_general`` receives them), and gives outputs within
  1e-6 x max(1, |ref|) of the JAX package's partitioned function (the
  integer sums are exact in both; only the final f32 scaling rounds);
- a custom property fuses an exp -> add pair; a property may decline;
- a Gluon Dense stack through ``functionalize`` partitions as in JAX;
- the differentiability contract: a graph without a hand-written
  gradient differentiates through the partitioned callable (gradients
  equal the original's within 1e-6), while one holding K1's operator
  (flash attention at T 256, whose gradient is K2) raises ``MXNetError``
  when differentiated.
"""
import numpy as onp
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu import np as jnp_
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.ops import partitioner as jpart
from mxnet_tpu.parallel.functional import functionalize as jfunctionalize

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import interop, np
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.ops import partitioner as tpart
from mxnet_tpu_torch.ops.attention import flash_attention
from mxnet_tpu_torch.parallel.functional import functionalize

TOL = 1e-6


@pytest.fixture(autouse=True)
def on_cpu():
    torch.set_num_threads(1)
    with mx.cpu():
        yield


def floored_err(got, want):
    got, want = (onp.asarray(a, onp.float64) for a in (got, want))
    assert got.shape == want.shape
    return float((onp.abs(got - want) / onp.maximum(1.0, onp.abs(want))).max())


def _mlp_weights():
    rng = onp.random.RandomState(0)
    return [rng.randn(16, 32).astype("f4") * 0.2, rng.randn(32).astype("f4") * 0.1,
            rng.randn(32, 8).astype("f4") * 0.2, rng.randn(8).astype("f4") * 0.1,
            rng.randn(4, 16).astype("f4")]


def test_int8_codes_and_outputs_match_jax(monkeypatch):
    w1, b1, w2, b2, x = _mlp_weights()
    jw = [jnp.asarray(a) for a in (w1, b1, w2, b2)]
    tw = [torch.from_numpy(a) for a in (w1, b1, w2, b2)]

    def jfn(v):
        return jnp.maximum(v @ jw[0] + jw[1], 0) @ jw[2] + jw[3]

    def tfn(v):
        return torch.relu(v @ tw[0] + tw[1]) @ tw[2] + tw[3]

    jcodes, tcodes = [], []
    dot = jax.lax.dot_general

    def spy(a, b, *args, **kw):
        if a.dtype == jnp.int8:
            jcodes.extend([onp.asarray(a), onp.asarray(b)])
        return dot(a, b, *args, **kw)
    monkeypatch.setattr(jax.lax, "dot_general", spy)
    jnew, jreport = jpart.partition(jfn, [jnp.asarray(x)], jpart.int8_dot_property())
    want = onp.asarray(jnew(jnp.asarray(x))[0])
    monkeypatch.setattr(jax.lax, "dot_general", dot)
    quantize = tpart._int8_quantize

    def tspy(v):
        q, s = quantize(v)
        tcodes.append(q.numpy())
        return q, s
    monkeypatch.setattr(tpart, "_int8_quantize", tspy)
    tnew, treport = tpart.partition(tfn, [torch.from_numpy(x)], tpart.int8_dot_property())
    got = tnew(torch.from_numpy(x))[0].numpy()
    assert len(treport) == len(jreport) == 2
    assert all(n == 1 for n, _ in treport)
    assert len(tcodes) == len(jcodes) == 4
    for a, b in zip(tcodes, jcodes):
        assert a.dtype == onp.int8 and onp.array_equal(a, b)
    assert floored_err(got, want) <= TOL
    ref = tfn(torch.from_numpy(x)).numpy()
    assert onp.abs(got - ref).max() / onp.abs(ref).max() < 0.05


def test_custom_backend_fuses_and_declines():
    """A property that carves exp -> add pairs substitutes its own
    implementation; one that declines keeps the nodes."""
    calls = []

    class FuseExpAdd(tpart.SubgraphProperty):
        def match(self, node):
            return str(node.target) in ("aten.exp.default", "aten.add.Tensor")

        def make_subgraph_fn(self, gm):
            names = [str(n.target) for n in gm.graph.nodes if n.op == "call_function"]
            if names != ["aten.exp.default", "aten.add.Tensor"]:
                return None
            calls.append(names)
            return lambda a, b: (torch.exp(a) + b,)

    class Decline(tpart.SubgraphProperty):
        def match(self, node):
            return True

        def make_subgraph_fn(self, gm):
            return None

    x, y = torch.tensor([0.0, 1.0]), torch.tensor([2.0, 3.0])
    new, report = tpart.partition(lambda a, b: torch.exp(a) + b, [x, y], FuseExpAdd())
    assert report and calls
    assert torch.allclose(new(x, y)[0], torch.exp(x) + y)
    new, report = tpart.partition(lambda a: torch.sin(a) * 2.0, [x], Decline())
    assert report == [] and torch.allclose(new(x)[0], torch.sin(x) * 2.0)


def test_functionalized_dense_stack_matches_jax():
    """The int8 property over a Gluon Dense stack's functional form, in
    both packages, on the same weights."""
    x = onp.random.RandomState(0).rand(4, 16).astype("f4")

    def build(m):
        net = m.HybridSequential()
        net.add(m.Dense(32, activation="relu", in_units=16), m.Dense(8))
        return net
    jmx.random.seed(0)
    jnet = build(jnn)
    jnet.initialize()
    jnet(jnp_.array(x))
    tnet = build(nn)
    tnet.initialize()
    interop.params_from_numpy(tnet, {k: p.data().asnumpy()
                                     for k, p in jnet.collect_params().items()})
    jfm = jfunctionalize(jnet, jnp_.array(x), training=False)
    jvals = jfm.values()
    jnew, jreport = jpart.partition(
        lambda v: jfm.apply(list(jvals), v, seed=0, training=False)[0],
        [jnp.asarray(x)], jpart.int8_dot_property())
    fm = functionalize(tnet, np.array(x), training=False)
    vals = fm.values()
    tnew, treport = tpart.partition(
        lambda v: fm.apply(list(vals), v, seed=0, training=False)[0],
        [torch.from_numpy(x)], tpart.int8_dot_property())
    assert len(treport) == len(jreport) == 2
    got = tnew(torch.from_numpy(x))[0].detach().numpy()
    assert floored_err(got, onp.asarray(jnew(jnp.asarray(x))[0])) <= TOL


def test_partition_without_custom_gradient_differentiates():
    rng = onp.random.RandomState(1)
    w = torch.from_numpy(rng.randn(8, 8).astype("f4"))

    def fn(v):
        return torch.tanh(v @ w).sum()

    class Tanh(tpart.SubgraphProperty):
        def match(self, node):
            return str(node.target) == "aten.tanh.default"

        def make_subgraph_fn(self, gm):
            return lambda *v: (gm(*v)[0],)

    x = torch.from_numpy(rng.randn(4, 8).astype("f4"))
    part, report = tpart.partition(fn, (x,), Tanh())
    assert report
    xg = x.clone().requires_grad_()
    (g_part,) = torch.autograd.grad(part(xg)[0], xg)
    xr = x.clone().requires_grad_()
    (g_ref,) = torch.autograd.grad(fn(xr), xr)
    assert floored_err(g_part.numpy(), g_ref.numpy()) <= TOL


def test_partition_with_k1_raises_when_differentiated():
    """Flash attention at T 256 is K1's operator in the graph (its
    gradient is K2): the partitioned callable runs forward, and
    differentiating it raises."""
    q = torch.from_numpy(onp.random.RandomState(0).randn(1, 2, 256, 16).astype("f4"))

    def fn(v):
        return flash_attention(v, v, v, False, None).sum() * 2.0

    class NoMatch(tpart.SubgraphProperty):
        def match(self, node):
            return False

    part, report = tpart.partition(fn, (q,), NoMatch())
    assert report == []
    assert floored_err(part(q)[0].numpy(), fn(q).numpy()) <= TOL
    qg = q.clone().requires_grad_()
    with pytest.raises(MXNetError, match="hand-written derivative"):
        torch.autograd.grad(part(qg)[0], qg)
