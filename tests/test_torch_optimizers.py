"""Port parity of the optimizer registry on the CPU: every optimizer the JAX
package registers, under each of its option sets below, steps an f32
weight three times through the eager ``Optimizer.update`` (wd 0.01,
``clip_gradient`` 1.5, ``rescale_grad`` 0.5 and an ``lr_mult`` of 0.5 on
index 0) on both packages from the same numpy weight and gradients, and
through ``Updater``, whose ``get_states`` / ``set_states`` carry the states
from either package to the other mid-run. SGLD's seed and noise come from
the port's threefry, so its draws are the JAX package's.

Tolerance: weights and states within 1e-6 of max(1, max |JAX|) (a few f32
ulps: XLA and PyTorch sum norms and fuse scalars in other orders);
SGLD's seeds equal.
"""
import pickle

import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.optimizer import updater as jupd

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.optimizer import updater as tupd

TOL = 1e-6
STEPS = 3
BASE = dict(learning_rate=0.05, wd=0.01, clip_gradient=1.5, rescale_grad=0.5)
# (registry name, extra options): every registered name at its defaults,
# and the options that take another branch of its step
CASES = [(n, {}) for n in sorted(jopt._REGISTRY.list())] + [
    ("sgd", {"momentum": 0.9}), ("rmsprop", {"centered": True}),
    ("signum", {"momentum": 0.0, "wd_lh": 0.1}), ("dcasgd", {"momentum": 0.9}),
    ("lamb", {"lower_bound": 1e-3, "upper_bound": 2.0}),
    ("lamb", {"bias_correction": False}), ("lars", {"eta": 0.01})]


@pytest.fixture(autouse=True)
def on_cpu():
    with mx.cpu():
        yield


def data(seed=0):
    rng = onp.random.RandomState(seed)
    w0 = rng.randn(6, 9).astype("float32")
    return w0, [rng.randn(6, 9).astype("float32") * 2 for _ in range(STEPS)]


def close(got, want):
    got, want = onp.asarray(got), onp.asarray(want)
    assert got.shape == want.shape
    if not onp.issubdtype(want.dtype, onp.floating):
        return got.dtype == want.dtype and onp.array_equal(got, want)
    got, want = got.astype(onp.float64), want.astype(onp.float64)
    return onp.abs(got - want).max() <= TOL * max(1.0, onp.abs(want).max())


def pair(name, kw):
    opts = dict(BASE, **kw)
    jo, to = jopt.create(name, **opts), topt.create(name, **opts)
    jo.set_lr_mult({0: 0.5})
    to.set_lr_mult({0: 0.5})
    return jo, to


@pytest.mark.parametrize("name,kw", CASES, ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_update_matches_jax(name, kw):
    """Three eager updates of index 0 (and one of index 1, whose count and
    rate are its own): weights and states against the JAX package's."""
    w0, grads = data()
    jmx.random.seed(3)
    mx.random.seed(3)
    jo, to = pair(name, kw)
    assert type(to).__name__ == type(jo).__name__
    assert to.lazy_rowwise == jo.lazy_rowwise
    jw, tw = jmx.np.array(w0), mx.np.array(w0)
    jw1, tw1 = jmx.np.array(w0 * 0.5), torch.from_numpy(w0 * 0.5)
    js, ts = jo.create_state(0, jw), to.create_state(0, tw._data)
    js1, ts1 = jo.create_state(1, jw1), to.create_state(1, tw1)
    for g in grads:
        js = jo.update(0, jw, jmx.np.array(g), js)
        ts = to.update(0, tw, mx.np.array(g), ts)
    js1 = jo.update(1, jw1, jmx.np.array(grads[0]), js1)
    ts1 = to.update_multi_precision(1, tw1, torch.from_numpy(grads[0]), ts1)
    assert to._index_update_count == jo._index_update_count == {0: STEPS, 1: 1}
    assert to.num_update == jo.num_update == STEPS
    assert close(tw.asnumpy(), jw.asnumpy()), "weight"
    assert close(tw1.numpy(), jw1.asnumpy()), "weight 1"
    for st_t, st_j in ((ts, js), (ts1, js1)):
        assert len(st_t) == len(st_j)
        for a, b in zip(st_t, st_j):
            assert close(a.numpy(), onp.asarray(b)), "state"


def test_update_step_is_pure():
    """``update_step`` changes none of its inputs (``TrainStep`` and
    ``Trainer`` rely on it)."""
    w0, grads = data(1)
    for name in sorted(jopt._REGISTRY.list()):
        mx.random.seed(0)
        opt = topt.create(name, **dict(BASE, clip_gradient=0.5))
        w, g = torch.from_numpy(w0), torch.from_numpy(grads[0])
        state = opt.create_state(0, w)
        before = [t.clone() for t in (w, g, *state)]
        opt.update_step(w, g, state, 0.1, 0.01, 1)
        assert all(torch.equal(a, b) for a, b in zip(before, (w, g, *state))), name


@pytest.mark.parametrize("name", ["adam", "sgld", "rmsprop", "dcasgd"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_updater_states_cross_packages(name, direction):
    """Two updates in one package, its ``get_states`` loaded by the other's
    ``set_states`` (with the update counts, which live on the optimizer),
    then one more update on each side from there: the same weights."""
    w0, grads = data(2)
    jmx.random.seed(4)
    mx.random.seed(4)
    jo, to = pair(name, {})
    ju, tu = jupd.get_updater(jo), tupd.get_updater(to)
    jw, tw = jmx.np.array(w0), mx.np.array(w0)
    src_u, src_w, src_o = (ju, jw, jo) if direction == "jax_to_port" else (tu, tw, to)
    dst_u, dst_w, dst_o = (tu, tw, to) if direction == "jax_to_port" else (ju, jw, jo)
    for g in grads[:2]:
        src_u(0, (jmx.np if src_u is ju else mx.np).array(g), src_w)
    blob = src_u.get_states()
    assert isinstance(pickle.loads(blob)[0], tuple)
    dst_u.set_states(blob)
    dst_o._index_update_count = dict(src_o._index_update_count)
    dst_o.num_update = src_o.num_update
    dst_w[:] = (jmx.np if dst_w is jw else mx.np).array(src_w.asnumpy())
    ju(0, jmx.np.array(grads[2]), jw)
    tu(0, mx.np.array(grads[2]), tw)
    assert close(tw.asnumpy(), jw.asnumpy())
    for a, b in zip(tu.states[0], ju.states[0]):
        assert close(a.numpy(), onp.asarray(b))


def test_updater_dump_optimizer_round_trip():
    """``get_states(dump_optimizer=True)`` pickles the optimizer with the
    states; ``set_states`` restores both."""
    w0, grads = data(3)
    u = tupd.Updater(topt.create("lamb", learning_rate=0.01))
    w = mx.np.array(w0)
    u(0, mx.np.array(grads[0]), w)
    v = tupd.Updater(topt.SGD())
    v.set_states(u.get_states(dump_optimizer=True))
    assert isinstance(v.optimizer, topt.LAMB) and v.optimizer.lr == 0.01
    assert v.optimizer._index_update_count == {0: 1}
    assert all(torch.equal(a, b) for a, b in zip(u.states[0], v.states[0]))


def test_registry():
    """Every JAX registry name creates the port's class of the same name;
    an instance passes through; an unknown name raises."""
    for name in jopt._REGISTRY.list():
        assert type(topt.create(name)).__name__ == type(jopt.create(name)).__name__
    sgd = topt.SGD()
    assert topt.create(sgd) is sgd
    assert isinstance(topt.create("LAMB"), topt.LAMB)
    with pytest.raises(MXNetError):
        topt.create("no_such_optimizer")
    assert sorted(topt.__all__) == sorted(jopt.__all__)


def test_sgld_seed_is_jax_draw():
    """SGLD's state is one uint32 equal to the JAX package's draw from the
    same global seed."""
    jmx.random.seed(11)
    mx.random.seed(11)
    w = onp.zeros((3,), "float32")
    (js,) = jopt.SGLD().create_state(0, jmx.np.array(w))
    (ts,) = topt.SGLD().create_state(0, torch.from_numpy(w))
    assert ts.dtype == torch.uint32 and int(ts) == int(onp.asarray(js))
