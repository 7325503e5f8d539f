"""Port parity of the checkpoint slice on the CPU: ``serialization``
files byte for byte against the JAX package's, ``save_parameters`` /
``load_parameters`` and ``Trainer.save_states`` / ``load_states`` across
the two packages, ``CheckpointManager`` checkpoints of either package
resumed by the other (local layout with a ``Trainer``, sharded layout
with a ``TrainStep``) to the same next losses, the port's own resume bit
for bit against an uninterrupted run, and the cases of
tests/test_checkpoint.py on the port's manager."""
import json
import os
import signal
import subprocess
import sys

import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import np as mnp
from mxnet_tpu import parallel as jparallel
from mxnet_tpu import serialization as jser
from mxnet_tpu.checkpoint import CheckpointManager as JaxCheckpointManager
from mxnet_tpu.gluon import Trainer as JaxTrainer
from mxnet_tpu.gluon.loss import SoftmaxCrossEntropyLoss as JaxCELoss
from mxnet_tpu.models import GPTModel as JaxGPT
from mxnet_tpu.models.gpt import GPTConfig as JaxGPTConfig

from mxnet_tpu_torch import _random, optimizer, parallel, random, serialization
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.device import cpu
from mxnet_tpu_torch.checkpoint import CheckpointManager
from mxnet_tpu_torch.gluon import Block, Trainer, load_parameters, nn, save_parameters
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.interop import params_from_numpy, params_to_numpy
from mxnet_tpu_torch.models import GPTConfig, GPTModel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
           max_position_embeddings=256, dropout=0.1)
B, T = 2, 256


def _arrays(rng):
    """One array of each stored dtype, a 0-d one included."""
    f = rng.randn(3, 5).astype("float32")
    return {
        "f32": f, "bf16": f * 3, "f16": f.astype("float16"), "f64": rng.randn(4),
        "i32": rng.randint(-9, 9, (2, 3)).astype("int32"),
        "i64": rng.randint(-9, 9, (5,)).astype("int64"),
        "u8": rng.randint(0, 255, (4, 2)).astype("uint8"),
        "bool": rng.rand(6) > 0.5, "scalar": onp.float32(2.5),
    }


def _jax_array(name, a):
    return mnp.array(jnp.asarray(a, jnp.bfloat16) if name == "bf16" else a)


def _port_array(name, a):
    t = torch.from_numpy(onp.array(a))
    return t.to(torch.bfloat16) if name == "bf16" else t


def _same(t, want):
    """A port tensor equals a JAX NDArray in dtype and bits."""
    w = onp.asarray(want._data) if hasattr(want, "_data") else onp.asarray(want)
    if w.dtype.name == "bfloat16":
        return t.dtype == torch.bfloat16 and (t.view(torch.int16).numpy() ==
                                              w.view(onp.int16)).all()
    return t.numpy().dtype == w.dtype and t.numpy().shape == w.shape and \
        (t.numpy() == w).all()


# --------------------------------------------------------- serialization

@pytest.mark.parametrize("fmt", ["mxtpu", "legacy"])
@pytest.mark.parametrize("keyed", [True, False])
def test_params_files_byte_identical(tmp_path, fmt, keyed):
    """The same arrays give the same bytes from both packages, keyed or
    as a list, in both formats; each package loads the other's file."""
    arrs = _arrays(onp.random.RandomState(0))
    names = sorted(arrs)
    jdata = {n: _jax_array(n, arrs[n]) for n in names}
    tdata = {n: _port_array(n, arrs[n]) for n in names}
    if not keyed:
        jdata, tdata = [jdata[n] for n in names], [tdata[n] for n in names]
    jfile, tfile = str(tmp_path / "j.params"), str(tmp_path / "t.params")
    jser.save(jfile, jdata, format=fmt)
    serialization.save(tfile, tdata, format=fmt)
    with open(jfile, "rb") as a, open(tfile, "rb") as b:
        assert a.read() == b.read()
    got, want = serialization.load(jfile), jser.load(tfile)
    pairs = (zip(got.values(), want.values()) if keyed else zip(got, want))
    if keyed:
        assert list(got) == list(want) == names
    for t, w in pairs:
        assert _same(t, w)


def test_npy_npz_passthrough(tmp_path):
    rng = onp.random.RandomState(1)
    a, b = rng.randn(3, 4).astype("float32"), rng.randint(0, 9, 5)
    onp.save(tmp_path / "a.npy", a)
    onp.savez(tmp_path / "ab.npz", a=a, b=b)
    assert (serialization.load(str(tmp_path / "a.npy")).numpy() == a).all()
    got = serialization.load(str(tmp_path / "ab.npz"))
    assert (got["a"].numpy() == a).all() and (got["b"].numpy() == b).all()
    with open(tmp_path / "bad.params", "wb") as f:
        f.write(b"notmagic" + bytes(8))
    with pytest.raises(MXNetError, match="bad magic"):
        serialization.load(str(tmp_path / "bad.params"))


# -------------------------------------------------------------- GPT nets

def _jax_net(dtype=jnp.float32):
    mx.random.seed(0)
    net = JaxGPT(JaxGPTConfig(dtype=dtype, **CFG))
    net.initialize()
    net(mnp.array(onp.zeros((1, 4), "int32")))
    return net


def _port_net(jnet, dtype=torch.float32):
    named = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    return params_from_numpy(GPTModel(GPTConfig(dtype=dtype, **CFG), device="cpu"), named)


def _batch(seed):
    rng = onp.random.RandomState(seed)
    return (rng.randint(0, CFG["vocab_size"], (B, T)).astype("int32"),
            rng.randint(0, CFG["vocab_size"], (B, T)).astype("int32"))


def _params_equal_jax(tnet, jnet):
    jp = jnet.collect_params()
    return all(_same(p.detach(), jp[n].data()) for n, p in tnet.named_parameters())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_save_load_parameters_across_packages(tmp_path, dtype):
    """A JAX ``save_parameters`` file loads into the port's model bit for
    bit, and the port's file into the JAX model; both files are the same
    bytes for the same weights."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jnet = _jax_net(jdt)
    tnet = GPTModel(GPTConfig(dtype=tdt, **CFG), device="cpu")
    jnet.save_parameters(str(tmp_path / "j.params"))
    load_parameters(tnet, str(tmp_path / "j.params"))
    assert _params_equal_jax(tnet, jnet)
    save_parameters(tnet, str(tmp_path / "t.params"))
    assert (tmp_path / "t.params").read_bytes() == (tmp_path / "j.params").read_bytes()
    other = _jax_net(jdt)
    for p in other.collect_params().values():
        p.set_data(p.data() * 0)
    other.load_parameters(str(tmp_path / "t.params"))
    assert _params_equal_jax(tnet, other)


def _dense():
    """``nn.Dense(3, in_units=5)`` initialized on the CPU."""
    return nn.Dense(3, in_units=5).initialize(device=cpu())


def _weight(net):
    """The weight tensor of a Dense (a leaf of the tape)."""
    return dict(net.named_parameters())["weight"]


def test_load_parameters_options(tmp_path):
    """``allow_missing``, ``ignore_extra``, ``cast_dtype`` and shape checks;
    ``deduplicate`` saves a shared parameter once."""
    net = _dense()
    net.weight.set_data(torch.arange(15.0).reshape(3, 5))
    net.bias.set_data(torch.ones(3))
    w, b = _weight(net).detach(), net.bias.data()._data.detach()
    f = str(tmp_path / "d.params")
    serialization.save(f, {"weight": w})
    with pytest.raises(MXNetError, match="missing parameter bias"):
        load_parameters(_dense(), f)
    load_parameters(_dense(), f, allow_missing=True)
    serialization.save(f, {"weight": w, "bias": b, "other": torch.zeros(2)})
    with pytest.raises(MXNetError, match="extra parameters"):
        load_parameters(_dense(), f)
    fresh = load_parameters(_dense(), f, ignore_extra=True)
    assert torch.equal(_weight(fresh), _weight(net))
    serialization.save(f, {"weight": w.double(), "bias": b})
    assert _weight(load_parameters(_dense(), f)).dtype == torch.float64
    cast = load_parameters(_dense(), f, cast_dtype=True)
    assert _weight(cast).dtype == torch.float32 and torch.equal(_weight(cast), _weight(net))
    serialization.save(f, {"weight": torch.zeros(2, 5), "bias": b})
    with pytest.raises(MXNetError, match="loaded shape"):
        load_parameters(_dense(), f)

    class Tied(Block):
        def __init__(self):
            super().__init__()
            self.a = _dense()
            self.b = self.a
    save_parameters(Tied(), f)
    assert sorted(serialization.load(f)) == ["a.bias", "a.weight", "b.bias", "b.weight"]
    save_parameters(Tied(), f, deduplicate=True)
    assert sorted(serialization.load(f)) == ["a.bias", "a.weight"]


def _jax_eager_steps(jnet, jtr, ids, labels, n):
    out = []
    for _ in range(n):
        with jautograd.record():
            jl = JaxCELoss()(jnet(mnp.array(ids)), mnp.array(labels))
        jl.backward()
        jtr.step(B)
        out.append(jl.asnumpy())
    return out


def _port_eager_steps(tnet, ttr, ids, labels, n):
    out = []
    for _ in range(n):
        tl = SoftmaxCrossEntropyLoss()(tnet(torch.from_numpy(ids)), torch.from_numpy(labels))
        tl.backward(torch.ones_like(tl))
        ttr.step(B)
        out.append(tl.detach().numpy())
    return out


def test_save_load_states_across_packages(tmp_path):
    """``.states`` files: a JAX Trainer's Adam state loads into the port's
    Trainer bit for bit (moments, step, clocks), and the port's file into
    a JAX Trainer."""
    jnet = _jax_net()
    jtr = JaxTrainer(jnet.collect_params(), "adam", {"learning_rate": 1e-3})
    ids, labels = _batch(0)
    _jax_eager_steps(jnet, jtr, ids, labels, 2)
    jtr.save_states(str(tmp_path / "j.states"))
    tnet = _port_net(jnet).train()
    ttr = Trainer(dict(tnet.named_parameters()), "adam", {"learning_rate": 1e-3})
    ttr.load_states(str(tmp_path / "j.states"))
    assert ttr._step_count == 2 and ttr._optimizer.num_update == 2
    assert ttr._optimizer._index_update_count == jtr._optimizer._index_update_count
    for i, st in enumerate(jtr._states):
        assert all(_same(t, w) for t, w in zip(ttr._states[i], st))
    ttr.save_states(str(tmp_path / "t.states"))
    jtr2 = JaxTrainer(_jax_net().collect_params(), "adam", {"learning_rate": 1e-3})
    jtr2.load_states(str(tmp_path / "t.states"))
    assert jtr2._step_count == 2
    for i, st in enumerate(jtr2._states):
        assert all(_same(t, w) for t, w in zip(ttr._states[i], st))


def _continue_tol(got, want):
    return all(onp.abs(g - w).max() <= 1e-5 * onp.abs(w).max() for g, w in zip(got, want))


def test_jax_local_checkpoint_continues_in_port(tmp_path):
    """The JAX package's manager saves GPT + Adam Trainer at dropout 0.1
    mid-run; the port's manager restores it (parameters, states and the
    global key) and its next 2 eager steps give the JAX run's next losses
    to 1e-5 relative (the masks come from the restored key)."""
    jnet = _jax_net()
    jtr = JaxTrainer(jnet.collect_params(), "adam", {"learning_rate": 1e-3})
    ids, labels = _batch(1)
    mx.random.seed(8)
    _jax_eager_steps(jnet, jtr, ids, labels, 2)
    JaxCheckpointManager(str(tmp_path), net=jnet, trainer=jtr).save(1)
    want = _jax_eager_steps(jnet, jtr, ids, labels, 2)
    tnet = GPTModel(GPTConfig(**CFG), device="cpu").train()
    ttr = Trainer(dict(tnet.named_parameters()), "adam", {"learning_rate": 1e-3})
    random.seed(99)
    assert CheckpointManager(str(tmp_path), net=tnet, trainer=ttr).restore_or_init() == 2
    assert _continue_tol(_port_eager_steps(tnet, ttr, ids, labels, 2), want)


def _jax_step(jnet):
    return jparallel.TrainStep(jnet, JaxCELoss(), mx.optimizer.Adam(learning_rate=1e-3),
                               example_inputs=[mnp.array(onp.zeros((B, T), "int32"))])


def _port_step(tnet):
    return parallel.TrainStep(tnet, SoftmaxCrossEntropyLoss(),
                              optimizer.Adam(learning_rate=1e-3), example_inputs=[])


def _sharded(cls, d, net, step, **kw):
    return cls(str(d), net=net, sharded=True, state_arrays=step.state_arrays,
               write_state_arrays=step.write_state_arrays,
               extra_state=lambda: {"step": step._step},
               restore_extra=lambda e: setattr(step, "_step", e["step"]), **kw)


def test_jax_sharded_checkpoint_continues_in_port(tmp_path):
    """A JAX ``TrainStep``'s sharded checkpoint (``shards-0.npz``, the step
    clock in ``extra``) restores into the port's ``TrainStep``; the next 2
    steps' losses equal the JAX run's to 1e-5 relative (step t's masks
    come from key(t), so the clock must be restored). And the reverse: the
    port's sharded checkpoint continues in the JAX package."""
    ids, labels = _batch(2)
    jnet = _jax_net()
    jstep = _jax_step(jnet)
    for _ in range(2):
        jstep(mnp.array(ids), mnp.array(labels))
    _sharded(JaxCheckpointManager, tmp_path / "j", jnet, jstep).save(2)
    want = [float(jstep(mnp.array(ids), mnp.array(labels)).item()) for _ in range(2)]
    tnet = GPTModel(GPTConfig(**CFG), device="cpu")
    tstep = _port_step(tnet)
    _sharded(CheckpointManager, tmp_path / "j", tnet, tstep).restore()
    assert tstep._step == 2
    got = [float(tstep(ids, labels)) for _ in range(2)]
    assert all(abs(g - w) <= 1e-5 * abs(w) for g, w in zip(got, want))

    _sharded(CheckpointManager, tmp_path / "t", tnet, tstep).save(4)
    want = [float(tstep(ids, labels)) for _ in range(2)]
    jnet2 = _jax_net()
    jstep2 = _jax_step(jnet2)
    _sharded(JaxCheckpointManager, tmp_path / "t", jnet2, jstep2).restore()
    got = [float(jstep2(mnp.array(ids), mnp.array(labels)).item()) for _ in range(2)]
    assert all(abs(g - w) <= 1e-5 * abs(w) for g, w in zip(got, want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_sharded_resume_is_bitwise(tmp_path, dtype):
    """The port's async sharded save, 2 more steps, restore, the same 2
    steps again: losses, parameters and Adam states bit for bit."""
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    tnet = GPTModel(GPTConfig(dtype=tdt, **CFG), device="cpu").init_weights(3)
    tstep = _port_step(tnet)
    mgr = _sharded(CheckpointManager, tmp_path, tnet, tstep, blocking=False)
    ids, labels = _batch(3)
    for _ in range(2):
        tstep(ids, labels)
    mgr.save(tstep._step)
    first = [tstep(ids, labels) for _ in range(2)]
    params = [p.detach().clone() for p in tnet.parameters()]
    states = {k: v.clone() for k, v in tstep.state_arrays().items()}
    mgr.restore()
    second = [tstep(ids, labels) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert all(torch.equal(a, b) for a, b in zip(params, tnet.parameters()))
    now = tstep.state_arrays()
    assert set(now) == set(states) and all(torch.equal(states[k], now[k]) for k in states)
    assert next(iter(now.values())).dtype == tdt


def test_port_local_resume_is_bitwise(tmp_path):
    """The ``Trainer`` path through the local layout at dropout 0.1: save,
    2 more eager steps, restore (the global key too), the same 2 steps:
    losses, parameters and states bit for bit."""
    tnet = GPTModel(GPTConfig(**CFG), device="cpu").init_weights(4).train()
    ttr = Trainer(dict(tnet.named_parameters()), "adam", {"learning_rate": 1e-3})
    mgr = CheckpointManager(str(tmp_path), net=tnet, trainer=ttr, blocking=False)
    ids, labels = _batch(4)
    random.seed(12)
    _port_eager_steps(tnet, ttr, ids, labels, 2)
    mgr.save(1)
    first = _port_eager_steps(tnet, ttr, ids, labels, 2)
    params = [p.detach().clone() for p in tnet.parameters()]
    states = {i: [s.clone() for s in st] for i, st in ttr._states.items()}
    random.seed(77)
    mgr.restore()
    second = _port_eager_steps(tnet, ttr, ids, labels, 2)
    assert all((a == b).all() for a, b in zip(first, second))
    assert all(torch.equal(a, b) for a, b in zip(params, tnet.parameters()))
    assert all(torch.equal(a, b) for i in states for a, b in zip(states[i], ttr._states[i]))


# --------------------------------------- the cases of tests/test_checkpoint.py

def _build(seed=0):
    net = _dense()
    rng = onp.random.RandomState(seed)
    net.weight.set_data(torch.from_numpy(rng.randn(3, 5).astype("float32")))
    net.bias.set_data(torch.from_numpy(rng.randn(3).astype("float32")))
    return net, Trainer(dict(net.named_parameters()), "adam", {"learning_rate": 0.05})


def _train(net, tr, steps):
    rs = onp.random.RandomState(42)
    X = torch.from_numpy(rs.randn(16, 5).astype("float32"))
    Y = torch.from_numpy(rs.randn(16, 3).astype("float32"))
    for _ in range(steps):
        loss = 0.5 * ((net(X) - Y) ** 2).mean(-1)
        loss.backward(torch.ones_like(loss))
        tr.step(16)
    return _weight(net).detach().clone()


def test_save_restore_roundtrip(tmp_path):
    net, tr = _build()
    mgr = CheckpointManager(str(tmp_path), net=net, trainer=tr, period=5)
    _train(net, tr, 7)
    assert mgr.save(6, metric=0.5, meta={"note": "hi"}) == str(tmp_path / "step-0000000006")
    assert mgr.latest() == 6
    w_saved = _weight(net).detach().clone()
    _train(net, tr, 3)
    net2, tr2 = _build(seed=9)
    assert CheckpointManager(str(tmp_path), net=net2, trainer=tr2).restore_or_init() == 7
    assert torch.equal(_weight(net2), w_saved)
    a = _train(net2, tr2, 1)
    net3, tr3 = _build(seed=4)
    CheckpointManager(str(tmp_path), net=net3, trainer=tr3).restore(6)
    assert torch.equal(a, _train(net3, tr3, 1))
    with open(tmp_path / "step-0000000006" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["meta"] == {"note": "hi"} and manifest["metric"] == 0.5
    assert sorted(os.listdir(tmp_path / "step-0000000006")) == [
        "DONE", "manifest.json", "model.params", "trainer.states"]


def test_retention_and_best(tmp_path):
    net, tr = _build()
    mgr = CheckpointManager(str(tmp_path), net=net, trainer=tr,
                            keep_last=2, keep_best=True, mode="min")
    for step, metric in [(0, 3.0), (1, 1.0), (2, 2.0), (3, 1.5)]:
        mgr.save(step, metric=metric)
    assert mgr.checkpoints() == [1, 2, 3]      # best (step 1) pinned + last 2
    assert os.readlink(os.path.join(tmp_path, "best")).endswith("0000000001")
    again = CheckpointManager(str(tmp_path), net=net, trainer=tr, keep_best=True)
    again.restore()
    assert again._best == 1.0


def test_partial_checkpoint_ignored(tmp_path):
    net, tr = _build()
    mgr = CheckpointManager(str(tmp_path), net=net, trainer=tr)
    mgr.save(5)
    bad = os.path.join(tmp_path, "step-0000000009")
    os.makedirs(bad)
    with open(os.path.join(bad, "model.params"), "wb") as f:
        f.write(b"garbage")
    assert mgr.latest() == 5
    net2, tr2 = _build(seed=1)
    assert CheckpointManager(str(tmp_path), net=net2, trainer=tr2).restore_or_init() == 6


def test_rng_state_resumes(tmp_path):
    net, tr = _build()
    mgr = CheckpointManager(str(tmp_path), net=net, trainer=tr)
    random.seed(123)
    _random.next_key()
    mgr.save(0)
    a = _random.next_key()
    random.seed(999)
    mgr.restore(0)
    assert torch.equal(_random.next_key(), a)


def test_restore_healthy_only_walks_back(tmp_path):
    """Manifests tagged unhealthy (as the JAX package's ``health=`` writes
    them) are skipped by ``restore(healthy_only=True)``; untagged ones
    count as healthy."""
    net, tr = _build()
    mgr = CheckpointManager(str(tmp_path), net=net, trainer=tr, keep_last=5)
    for s in range(3):
        mgr.save(s)
    for s, healthy in ((1, False), (2, False)):
        path = tmp_path / f"step-{s:010d}" / "manifest.json"
        m = json.loads(path.read_text())
        m["health"] = {"healthy": healthy}
        path.write_text(json.dumps(m))
    assert mgr.restore(healthy_only=True) == 0
    assert mgr.last_healthy() == 0
    assert mgr.restore_or_init(healthy_only=True) == 1
    assert mgr.restore() == 2


def test_async_save_snapshot_semantics(tmp_path):
    """blocking=False captures the state at the save call although training
    mutates the parameters while the write lands; the restored trainer
    steps as one restored from a blocking save."""
    net, tr = _build()
    mgr = CheckpointManager(str(tmp_path / "a"), net=net, trainer=tr)
    _train(net, tr, 5)
    w5 = _weight(net).detach().clone()
    path = mgr.save(4, blocking=False)
    _train(net, tr, 3)
    mgr.wait()
    assert mgr.latest() == 4 and os.path.isdir(path)
    net_b, tr_b = _build()
    _train(net_b, tr_b, 5)
    CheckpointManager(str(tmp_path / "b"), net=net_b, trainer=tr_b).save(4, blocking=True)
    outs = {}
    for name in ("a", "b"):
        net2, tr2 = _build(seed=3)
        CheckpointManager(str(tmp_path / name), net=net2, trainer=tr2).restore(4)
        assert torch.equal(_weight(net2), w5)
        outs[name] = _train(net2, tr2, 1)
    assert torch.equal(outs["a"], outs["b"])


def test_async_overlap_save_protection(tmp_path):
    net, tr = _build()
    mgr = CheckpointManager(str(tmp_path), net=net, trainer=tr, keep_last=5)
    _train(net, tr, 2)
    mgr.save(0, blocking=False)
    mgr.save(1, blocking=False)         # waits for save(0)
    mgr.wait()
    mgr.wait()
    assert mgr.checkpoints() == [0, 1]


def test_async_save_error_surfaces_at_wait(tmp_path, monkeypatch):
    net, tr = _build()
    mgr = CheckpointManager(str(tmp_path), net=net, trainer=tr)
    monkeypatch.setattr(mgr, "_write_snapshot",
                        lambda *a, **k: (_ for _ in ()).throw(OSError("disk full")))
    mgr.save(0, blocking=False)
    with pytest.raises(MXNetError, match="disk full"):
        mgr.wait()
    mgr.wait()                          # raised exactly once


def test_ctor_blocking_false_periodic_steps(tmp_path):
    net, tr = _build()
    mgr = CheckpointManager(str(tmp_path), net=net, trainer=tr, period=2,
                            keep_last=10, blocking=False)
    for step in range(6):
        _train(net, tr, 1)
        mgr.step(step)
    mgr.wait()
    assert mgr.checkpoints() == [1, 3, 5]
    net2, tr2 = _build(seed=5)
    assert CheckpointManager(str(tmp_path), net=net2, trainer=tr2).restore_or_init() == 6


@pytest.mark.parametrize("kw", [{"publish_weights_dir": "w"}, {"health": object()}])
def test_unported_options_raise(tmp_path, kw):
    if "publish_weights_dir" in kw:
        # publish_weights_dir is ported: a completed save publishes the
        # parameters as a weight version that read_weights returns
        from mxnet_tpu_torch.serve.registry import read_weights
        wdir = str(tmp_path / kw["publish_weights_dir"])
        net, tr = _build()
        mgr = CheckpointManager(str(tmp_path / "ckpt"), net=net, trainer=tr,
                                publish_weights_dir=wdir)
        mgr.save(3)
        version, params, manifest = read_weights(wdir)
        assert version == 1 and manifest["meta"]["step"] == 3
        named = dict(net.named_parameters())
        assert sorted(params) == sorted(named)
        for name, p in named.items():
            onp.testing.assert_array_equal(params[name], p.detach().numpy())
    else:
        with pytest.raises(MXNetError, match="not ported yet"):
            CheckpointManager(str(tmp_path), **kw)
    with pytest.raises(MXNetError, match="not a Trainer"):
        CheckpointManager(str(tmp_path), trainer=_build()[1], sharded=True)


_WORKER = r"""
import os, signal, sys
import numpy as onp
import torch
from mxnet_tpu_torch.checkpoint import CheckpointManager
from mxnet_tpu_torch.device import cpu
from mxnet_tpu_torch.gluon import Trainer, nn

out_dir, total = sys.argv[1], int(sys.argv[2])
net = nn.Dense(3, in_units=5).initialize(device=cpu())
net.weight.set_data(torch.from_numpy(onp.random.RandomState(0).randn(3, 5).astype("float32")))
tr = Trainer(dict(net.named_parameters()), "adam", {"learning_rate": 0.05})
mgr = CheckpointManager(out_dir, net=net, trainer=tr, period=5, keep_last=2)
start = mgr.restore_or_init()
rs = onp.random.RandomState(42)
X = torch.from_numpy(rs.randn(16, 5).astype("float32"))
Y = torch.from_numpy(rs.randn(16, 3).astype("float32"))
for step in range(start, total):
    loss = ((net(X) - Y) ** 2).mean()
    loss.backward()
    tr.step(16)
    mgr.step(step)
    if step == 3:
        mgr.handle_preemption()
        os.kill(os.getpid(), signal.SIGTERM)
"""


def test_preemption_handler(tmp_path):
    """SIGTERM flags a preemption; the next step() writes a checkpoint and
    re-raises the signal."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", _WORKER, str(tmp_path), "20"], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == -signal.SIGTERM, r.stderr[-2000:]
    assert 4 in CheckpointManager(str(tmp_path)).checkpoints()
