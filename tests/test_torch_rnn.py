"""``gluon.rnn`` of the port against the JAX package on the CPU: the fused
layers (LSTM, GRU, RNN with relu and tanh; one and two directions; TNC
and NTC; two layers with inter-layer dropout 0.5 in training mode), the
cells and ``unroll``, ``SequentialRNNCell``, ``npx.rnn``'s flat packing,
the parameter names, deferred shapes and ``interop.params_from_numpy``.

The JAX net's parameters are carried into the port's net with
``params_from_numpy``; the same inputs go through both. Tolerances:
outputs and states within 1e-5 (relative, a 1e-2 floor: XLA and torch
differ in the last place of sigmoid and tanh, compounding over the
steps), gradients within
1e-4 relative L2; dropout masks bit for bit (the port draws JAX's f64
bernoulli with its threefry).
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag, np as jnp_, npx as jnpx
from mxnet_tpu.gluon import rnn as jrnn

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd as tag, interop, np as tnp, npx as tnpx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import rnn as trnn

H, T, B, C = 16, 6, 3, 5


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


def close(got, want, tol=1e-5):
    got, want = onp.asarray(got, onp.float64), onp.asarray(want, onp.float64)
    assert got.shape == want.shape
    err = onp.abs(got - want) / onp.maximum(onp.abs(want), 1e-2)
    assert err.max() <= tol, err.max()


def rel_l2(got, want, tol=1e-4):
    assert onp.linalg.norm(got - want) <= tol * max(onp.linalg.norm(want), 1e-8)


def host_params(net):
    return {n: p.data().asnumpy() for n, p in net.collect_params().items()}


def pair(cls_name, x, **kw):
    """The JAX layer initialized by a forward on ``x``, and the port's with
    its parameters."""
    jmx.random.seed(0)
    j = getattr(jrnn, cls_name)(**kw)
    j.initialize()
    j(jnp_.array(x))
    t = getattr(trnn, cls_name)(**kw)
    t.initialize()
    interop.params_from_numpy(t, host_params(j))
    return j, t


def run(net, np, ag, x, states, train, seed=11):
    """Forward (in training mode when ``train``) and the gradients of a
    weighted sum of the outputs and final states."""
    (jmx if np is jnp_ else mx).random.seed(seed)
    xs = np.array(x)
    xs.attach_grad()
    sts = [np.array(s) for s in states]
    with ag.record(train_mode=train):
        out, new = net(xs, sts)
        w = np.array(onp.cos(onp.arange(out.size)).astype("float32").reshape(out.shape))
        loss = (out * w).sum() + sum((s * s).sum() for s in new)
    loss.backward()
    grads = {n: p.grad().asnumpy() for n, p in net.collect_params().items()}
    return out.asnumpy(), [s.asnumpy() for s in new], xs.grad.asnumpy(), grads


# each mode, both activations, one and two directions, both layouts, two
# layers with dropout 0.5 in training mode (the JAX side's recorded scans
# cost seconds a case, so the features share cases)
CASES = [("RNN", {"activation": "relu"}, "TNC"),
         ("RNN", {"activation": "tanh", "bidirectional": True}, "NTC"),
         ("LSTM", {"num_layers": 2, "dropout": 0.5}, "TNC"),
         ("GRU", {"bidirectional": True}, "NTC")]


@pytest.mark.parametrize("cls_name,kw,layout", CASES,
                         ids=[f"{c}-{i}" for i, (c, _, _) in enumerate(CASES)])
def test_layer_against_jax(cls_name, kw, layout):
    rng = onp.random.RandomState(0)
    x = rng.randn(*((T, B, C) if layout == "TNC" else (B, T, C))).astype("float32")
    j, t = pair(cls_name, x, hidden_size=H, layout=layout, **kw)
    L = kw.get("num_layers", 1) * (2 if kw.get("bidirectional") else 1)
    n_states = 2 if cls_name == "LSTM" else 1
    states = [rng.randn(L, B, H).astype("float32") * 0.5 for _ in range(n_states)]
    train = kw.get("dropout", 0) > 0
    jo, js, jx, jg = run(j, jnp_, jag, x, states, train)
    to, ts, tx, tg = run(t, tnp, tag, x, states, train)
    close(to, jo)
    for a, b in zip(ts, js):
        close(a, b)
    rel_l2(tx, jx)
    assert sorted(tg) == sorted(jg)
    for n in jg:
        rel_l2(tg[n], jg[n])
    if train:
        # the zero pattern of the output (dropout after layer 0 feeds layer 1;
        # compare the masks through the layer-0 outputs) and a second draw
        # differs from the first
        assert not onp.allclose(run(t, tnp, tag, x, states, True, seed=12)[0], to)


def test_dropout_masks_bitwise():
    """The port's mask draw against ``jax.random.bernoulli`` with x64."""
    import jax
    from mxnet_tpu_torch import _prng
    from mxnet_tpu_torch.gluon.rnn import _keep_mask
    for seed, layer, shape in ((0, 0, (6, 3, 32)), (5, 1, (7, 2, 20))):
        jk = jax.random.fold_in(jax.random.key(seed), layer)
        want = onp.asarray(jax.random.bernoulli(jk, 1 - 0.5, shape))
        got = _keep_mask(_prng.fold_in(_prng.key(seed), layer), 0.5, shape, "cpu")
        assert (got.numpy() == want).all()


def test_default_states_and_deferred_input():
    rng = onp.random.RandomState(1)
    x = rng.randn(T, B, C).astype("float32")
    j, t = pair("LSTM", x, hidden_size=H)
    assert t.l0_i2h_weight.shape == (4 * H, C) == j.l0_i2h_weight.shape
    assert sorted(t.collect_params()) == sorted(j.collect_params())
    close(t(tnp.array(x)).asnumpy(), j(jnp_.array(x)).asnumpy())
    st = t.begin_state(B)
    assert len(st) == 2 and st[0].shape == (1, B, H) and st[0].dtype == onp.float32


def test_initialization_matches_jax():
    """``initialize`` draws the JAX package's values in its order."""
    x = onp.ones((T, B, C), "float32")
    jmx.random.seed(3)
    j = jrnn.GRU(H, num_layers=2, bidirectional=True)
    j.initialize()
    j(jnp_.array(x))
    mx.random.seed(3)
    t = trnn.GRU(H, num_layers=2, bidirectional=True)
    t.initialize()
    t(tnp.array(x))
    want, got = host_params(j), host_params(t)
    assert sorted(got) == sorted(want)
    for n in want:
        assert got[n].tobytes() == want[n].tobytes(), n


CELLS = [("LSTMCell", {}), ("GRUCell", {}), ("RNNCell", {"activation": "relu"})]


@pytest.mark.parametrize("cls_name,kw", CELLS, ids=[f"{c}-{i}" for i, (c, _) in enumerate(CELLS)])
def test_cell_unroll(cls_name, kw):
    rng = onp.random.RandomState(2)
    x = rng.randn(B, 3, C).astype("float32")
    res = []
    for np, ag, mod, rnn in ((jnp_, jag, jmx, jrnn), (tnp, tag, mx, trnn)):
        cell = getattr(rnn, cls_name)(H, **kw)
        cell.initialize()
        if mod is mx:
            cell(tnp.array(x[:, 0]), cell.begin_state(B))
            interop.params_from_numpy(cell, res[0][3])
        xs = np.array(x)
        xs.attach_grad()
        with ag.record():
            outs, states = cell.unroll(3, xs, layout="NTC")
            (outs * outs).sum().backward()
        res.append((outs.asnumpy(), [s.asnumpy() for s in states], xs.grad.asnumpy(),
                    host_params(cell)))
    (jo, js, jx, _), (to, ts, tx, _) = res
    close(to, jo)
    for a, b in zip(ts, js):
        close(a, b)
    rel_l2(tx, jx)


def test_sequential_cell_and_params_names():
    rng = onp.random.RandomState(3)
    x = rng.randn(T, B, C).astype("float32")
    res = []
    for np, rnn in ((jnp_, jrnn), (tnp, trnn)):
        seq = rnn.SequentialRNNCell()
        seq.add(rnn.LSTMCell(H))
        seq.add(rnn.GRUCell(H))
        seq.initialize()
        if np is tnp:
            seq(tnp.array(x[0]), seq.begin_state(B))
            interop.params_from_numpy(seq, res[0][2])
        outs, states = seq.unroll(T, np.array(x), layout="TNC", merge_outputs=False)
        res.append(([o.asnumpy() for o in outs], [s.asnumpy() for s in states],
                    host_params(seq)))
    (jo, js, jp), (to, ts, tp) = res
    assert sorted(tp) == sorted(jp) and len(to) == T
    for a, b in zip(to + ts, jo + js):
        close(a, b)


@pytest.mark.parametrize("mode,L,bidir", [("lstm", 2, False), ("gru", 1, True),
                                          ("rnn_tanh", 1, False)])
def test_npx_rnn_flat_packing(mode, L, bidir):
    rng = onp.random.RandomState(4)
    x = rng.randn(T, B, C).astype("float32")
    cls = {"lstm": "LSTM", "gru": "GRU", "rnn_tanh": "RNN"}[mode]
    kw = {"activation": "tanh"} if mode == "rnn_tanh" else {}
    j, _ = pair(cls, x, hidden_size=H, num_layers=L, bidirectional=bidir, **kw)
    items = list(j.collect_params().items())
    flat = onp.concatenate([p.data().asnumpy().ravel() for n, p in items if "weight" in n]
                           + [p.data().asnumpy().ravel() for n, p in items if "bias" in n])
    nd = L * (2 if bidir else 1)
    h0 = rng.randn(nd, B, H).astype("float32")
    c0 = rng.randn(nd, B, H).astype("float32") if mode == "lstm" else None
    got, want = [], []
    for np, npx, dst in ((jnp_, jnpx, want), (tnp, tnpx, got)):
        out = npx.rnn(data=np.array(x), parameters=np.array(flat), state=np.array(h0),
                      state_cell=None if c0 is None else np.array(c0), mode=mode, state_size=H,
                      num_layers=L, bidirectional=bidir)
        dst.extend(o.asnumpy() for o in out)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        close(a, b)


def test_npx_rnn_rejects_unsupported():
    data = tnp.array(onp.zeros((2, 1, 3), "float32"))
    h0 = tnp.array(onp.zeros((1, 1, 4), "float32"))
    for kw, match in ((dict(use_sequence_length=True), "sequence_length"),
                      (dict(projection_size=2), "projection_size"), (dict(p=0.2), "dropout"),
                      (dict(mode="bogus"), "unknown mode")):
        args = dict(data=data, parameters=tnp.array([0.0]), state=h0, mode="gru",
                    state_size=4)
        args.update(kw)
        with pytest.raises(MXNetError, match=match):
            tnpx.rnn(**args)


def test_layer_on_tensors_is_plain_pytorch():
    """Called on raw tensors a layer is a function of its parameters'
    tensors in PyTorch's own autograd."""
    net = trnn.GRU(H, input_size=C)
    net.initialize()
    x = torch.randn(T, B, C, requires_grad=True)
    out = net(x)
    assert isinstance(out, torch.Tensor) and out.shape == (T, B, H)
    out.sum().backward()
    assert x.grad is not None and net.l0_h2h_weight.data()._data.grad is not None
