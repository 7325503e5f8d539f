"""Three faults of the port against the JAX package, each held on the CPU:

- ``MXTPU_DROPOUT_RNG=threefry`` switches the JAX package's dropout sites
  to ``jax.random.bernoulli``; the port draws the counter hash only, so
  the variable set to ``threefry`` raises at every active dropout site
  (``npx.dropout``, attention dropout on the einsum and the chunked
  route), while ``counter`` or unset trains on the same masks.
- A bf16 weight stepped by any registry optimizer rounds where the JAX
  step rounds (weak scalars to bf16, the trust ratio cast, SGLD's bf16
  draw): three steps through ``parallel.train.apply_updates`` (what ``TrainStep``,
  ``gluon.Trainer`` and ``Optimizer.update`` call) against the JAX
  ``TrainStep``'s arithmetic, ``update_step`` jitted with f32 rates and
  the results cast to the weight's and the states' dtypes.
- An ``NDArray`` batch steps ``TrainStep`` without a round trip through
  numpy, bit for bit as the same batch as tensors.

Tolerance: within one bf16 ulp per element (LAMB's and LARS's f32 norms
sum in other orders, which can flip the trust ratio's rounding; a
transcendental of XLA's CPU and of torch may differ in the last f32 place,
which can flip a bf16 rounding); SGLD bit for bit; the rest bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import optimizer as jopt

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import np, npx, optimizer as topt, parallel
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.ops.attention import flash_attention_bthd
from mxnet_tpu_torch.parallel.train import apply_updates


@pytest.fixture(autouse=True)
def on_cpu():
    with mx.cpu():
        yield


# ---------------------------------------------------------------- threefry
def _dropout_net(seed=5):
    mx.random.seed(seed)
    net = nn.HybridSequential()
    net.add(nn.Dense(16, in_units=8, activation="relu"), nn.Dropout(0.3), nn.Dense(3))
    net.initialize()
    return net


def _step_loss(rng_var, monkeypatch):
    if rng_var is None:
        monkeypatch.delenv("MXTPU_DROPOUT_RNG", raising=False)
    else:
        monkeypatch.setenv("MXTPU_DROPOUT_RNG", rng_var)
    r = onp.random.RandomState(0)
    x, y = r.rand(6, 8).astype("float32"), r.randint(0, 3, 6).astype("int32")
    step = parallel.TrainStep(_dropout_net(), SoftmaxCrossEntropyLoss(), "sgd",
                              example_inputs=[np.array(x)])
    return [step(torch.from_numpy(x), torch.from_numpy(y)).numpy() for _ in range(2)]


def test_threefry_raises_at_every_dropout_site(monkeypatch):
    monkeypatch.setenv("MXTPU_DROPOUT_RNG", "threefry")
    x = torch.ones(4, 8)
    with pytest.raises(MXNetError, match="threefry is not ported"):
        npx.dropout(x, p=0.1, training=True)
    key = torch.tensor([0, 7], dtype=torch.int64)
    for T in (16, 640):       # the einsum route, then the chunked route
        q = torch.randn(1, T, 1, 8)
        with pytest.raises(MXNetError, match="ROADMAP Queue 3"):
            flash_attention_bthd(q, q, q, dropout=(key, 0.1))
    with pytest.raises(MXNetError, match="threefry"):
        _step_loss("threefry", monkeypatch)
    # inactive sites draw nothing and read nothing, as in the JAX package
    assert torch.equal(npx.dropout(x, p=0.1, training=False), x)
    assert torch.equal(npx.dropout(x, p=0.0, training=True), x)


def test_counter_or_unset_trains_on_the_same_masks(monkeypatch):
    unset = _step_loss(None, monkeypatch)
    counter = _step_loss("counter", monkeypatch)
    for a, b in zip(unset, counter):
        assert onp.isfinite(a) and a.tobytes() == b.tobytes()


# ----------------------------------------------------------- bf16 updates
BASE = dict(learning_rate=0.05, wd=0.01, clip_gradient=1.5, rescale_grad=0.5)
CASES = [("lamb", {}), ("lamb", {"lower_bound": 1e-3, "upper_bound": 2.0}),
         ("lamb", {"bias_correction": False}), ("lars", {}), ("lars", {"eta": 0.01}),
         ("sgld", {}), ("sgd", {}), ("sgd", {"momentum": 0.9}), ("nag", {}), ("adam", {}),
         ("adamw", {}), ("nadam", {}), ("rmsprop", {}), ("rmsprop", {"centered": True}),
         ("adagrad", {}), ("adadelta", {}), ("ftrl", {}), ("signum", {}),
         ("signum", {"momentum": 0.0, "wd_lh": 0.01}), ("dcasgd", {"momentum": 0.9}),
         ("test", {})]


def _bf16_jax(name, kw, w0, grads):
    jmx.random.seed(3)
    o = jopt.create(name, **dict(BASE, **kw))
    w = jnp.asarray(w0, dtype=jnp.bfloat16)
    st = o.create_state(0, jmx.np.array(w0).astype("bfloat16"))

    @jax.jit
    def step(w, g, s, lr, wd, t, rescale):
        nw, ns = o.update_step(w, g * rescale, s, lr, wd, t)
        return nw.astype(w.dtype), jax.tree.map(lambda a, b: b.astype(a.dtype), s, ns)
    for t, g in enumerate(grads, 1):
        w, st = step(w, jnp.asarray(g, jnp.bfloat16), st, jnp.float32(BASE["learning_rate"]),
                     jnp.float32(BASE["wd"]), jnp.int32(t), jnp.float32(BASE["rescale_grad"]))
    return onp.asarray(w.astype(jnp.float32)), [onp.asarray(s.astype(jnp.float32))
                                                if s.dtype == jnp.bfloat16 else onp.asarray(s)
                                                for s in st]


def _bf16_port(name, kw, w0, grads):
    mx.random.seed(3)
    o = topt.create(name, **dict(BASE, **kw))
    w = torch.from_numpy(w0).to(torch.bfloat16)
    states = [o.create_state(0, w)]
    for t, g in enumerate(grads, 1):
        apply_updates(o, [("w", w)], states, lambda i: (BASE["learning_rate"], BASE["wd"], t),
                      BASE["rescale_grad"], grads=[torch.from_numpy(g).to(torch.bfloat16)])
    return w.float().numpy(), [s.float().numpy() if s.dtype == torch.bfloat16 else s.numpy()
                               for s in states[0]]


def _ulps(got, want):
    """|got - want| in units of want's bf16 ulp (2**-7 of its binade)."""
    ulp = 2.0 ** (onp.floor(onp.log2(onp.maximum(onp.abs(want), 2.0 ** -126))) - 7)
    return onp.abs(got.astype(onp.float64) - want) / ulp


@pytest.mark.parametrize("name,kw", CASES, ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_bf16_steps_round_as_jax(name, kw):
    rng = onp.random.RandomState(0)
    w0 = rng.randn(24, 33).astype("float32")
    grads = [rng.randn(24, 33).astype("float32") * 2 for _ in range(3)]
    jw, js = _bf16_jax(name, kw, w0, grads)
    tw, ts = _bf16_port(name, kw, w0, grads)
    if name == "sgld":
        assert tw.tobytes() == jw.tobytes()
        assert [s.tolist() for s in ts] == [s.tolist() for s in js]     # the seed
        return
    assert _ulps(tw, jw).max() <= 1.0
    for a, b in zip(ts, js):
        assert _ulps(a, b).max() <= 1.0


def test_bf16_sgld_noise_is_jax_bf16_draw():
    """SGLD's bf16 noise is ``jax.random.normal(..., bfloat16)``: the draw
    alone rounds its product, bit for bit."""
    from mxnet_tpu_torch import _prng
    shape = (64, 33)
    for seed in (1, 2):
        want = onp.asarray(jax.random.normal(jax.random.fold_in(jax.random.key(seed), 2),
                                             shape, dtype=jnp.bfloat16)).astype("float32")
        got = _prng.normal_bf16(_prng.fold_in(_prng.key(seed), 2), shape)
        assert got.tobytes() == want.tobytes()


def test_f32_path_unchanged():
    """An f32 weight steps on f32 views as before: LAMB through
    apply_updates equals its update_step on the same tensors."""
    rng = onp.random.RandomState(1)
    w0, g = rng.randn(5, 7).astype("float32"), rng.randn(5, 7).astype("float32")
    o = topt.create("lamb", **BASE)
    w = torch.from_numpy(w0.copy())
    st = [o.create_state(0, w)]
    want, _ = o.update_step(torch.from_numpy(w0), torch.from_numpy(g) * 0.5, st[0], 0.05, 0.01, 1)
    apply_updates(o, [("w", w)], st, lambda i: (0.05, 0.01, 1), 0.5, grads=[torch.from_numpy(g)])
    assert torch.equal(w, want)


# ------------------------------------------------------ NDArray batches
def _mlp(seed=9):
    mx.random.seed(seed)
    net = nn.HybridSequential()
    net.add(nn.Dense(8, in_units=4, activation="relu"), nn.Dense(3))
    net.initialize()
    return net


def test_ndarray_batch_steps_without_numpy(monkeypatch):
    rng = onp.random.RandomState(4)
    X, Y = rng.rand(3, 8, 4).astype("float32"), rng.randint(0, 3, (3, 8)).astype("int32")

    def run(as_ndarray):
        step = parallel.TrainStep(_mlp(), SoftmaxCrossEntropyLoss(),
                                  mx.optimizer.Adam(learning_rate=0.01),
                                  example_inputs=[np.array(X[0])])
        wrap = np.array if as_ndarray else torch.from_numpy
        batches = [(wrap(x), wrap(y)) for x, y in zip(X, Y)]
        if as_ndarray:
            def no_host(self):
                raise AssertionError("an NDArray batch went through the host")
            monkeypatch.setattr(mx.NDArray, "asnumpy", no_host)
        losses = [step(x, y).numpy() for x, y in batches]
        losses.append(step.run(*batches[0], steps=2).numpy())
        monkeypatch.undo()
        return losses, [p.detach().numpy().copy() for _, p in step._params]

    nd_l, nd_p = run(True)
    t_l, t_p = run(False)
    for a, b in zip(nd_l + nd_p, t_l + t_p):
        assert a.tobytes() == b.tobytes()


def test_tensor_batch_moves_only_across_devices():
    from mxnet_tpu_torch.parallel.train import _as_tensors
    x = torch.ones(2, 3)
    (same,) = _as_tensors(x, torch.device("cpu"))
    assert same is x
    nd = mx.NDArray(x)
    (u,) = _as_tensors([nd], torch.device("cpu"))
    assert u.data_ptr() == nd._data.data_ptr()
    (h,) = _as_tensors(onp.zeros((2, 2), onp.int32), torch.device("cpu"))
    assert h.dtype == torch.int32
