"""Port parity of the GPT training slice on the CPU: a small GPT whose
weights are copied from a JAX ``GPTModel`` trains through the port's
``TrainStep`` and through ``loss.backward()`` + ``Trainer.step`` next to
the JAX package's ``TrainStep`` and ``autograd.record`` + ``Trainer.step``
on the same numpy batch. T = 256, so every block's attention takes the
flash ``autograd.Function`` (plain K1/K2 on the CPU) in the port."""
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import np as mnp
from mxnet_tpu import parallel as jparallel
from mxnet_tpu.gluon import Trainer as JaxTrainer
from mxnet_tpu.gluon.loss import SoftmaxCrossEntropyLoss as JaxCELoss
from mxnet_tpu.models import GPTModel as JaxGPT
from mxnet_tpu.models.gpt import GPTConfig as JaxGPTConfig

from mxnet_tpu_torch import optimizer, parallel
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import Trainer
from mxnet_tpu_torch.gluon.loss import SoftmaxCELoss, SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.models._layers import Dropout
from mxnet_tpu_torch.interop import params_from_numpy, params_to_numpy
from mxnet_tpu_torch.models import GPTConfig, GPTModel
from mxnet_tpu_torch.ops.int8_gemv import count_launches

CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
           max_position_embeddings=256, dropout=0.0)
B, T, STEPS = 2, 256, 3


def _jax_net(dtype=jnp.float32):
    mx.random.seed(0)
    net = JaxGPT(JaxGPTConfig(dtype=dtype, **CFG))
    net.initialize()
    net(mnp.array(onp.zeros((1, 4), "int32")))
    return net


def _port_net(jnet, dtype=torch.float32):
    named = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    return params_from_numpy(GPTModel(GPTConfig(dtype=dtype, **CFG), device="cpu"), named)


def _batch(seed=0):
    rng = onp.random.RandomState(seed)
    return (rng.randint(0, CFG["vocab_size"], (B, T)).astype("int32"),
            rng.randint(0, CFG["vocab_size"], (B, T)).astype("int32"))


def _max_param_diff(jnet, tnet):
    got = params_to_numpy(tnet)
    want = {n: onp.asarray(p.data().asnumpy(), "float32")
            for n, p in jnet.collect_params().items()}
    assert set(got) == set(want)
    return max(float(onp.abs(got[n] - want[n]).max()) for n in want)


# about 10x the 2.6e-6 and 3.2e-6 that the TrainStep and Trainer cases read
ADAM_STATE_TOL = 3e-5


def _adam_state_err(jstates, tstates):
    """Worst relative L2 error of Adam's m and v, leaf by leaf by name: the
    moments carry the gradients' magnitudes, which Adam's step hides."""
    assert set(jstates) == set(tstates)
    worst = 0.0
    for name, js in jstates.items():
        assert len(js) == len(tstates[name]) == 2, name
        for got, want in zip(tstates[name], js):
            want = onp.asarray(want.asnumpy() if hasattr(want, "asnumpy") else want, "float32")
            err = onp.linalg.norm(got.float().numpy() - want)
            worst = max(worst, err / max(float(onp.linalg.norm(want)), 1e-30))
    return worst


_OPTS = {
    "sgd": (lambda m: m.optimizer.SGD(learning_rate=0.1, momentum=0.9),
            lambda: optimizer.SGD(learning_rate=0.1, momentum=0.9), 1e-5),
    # Adam's step per element is about lr whatever the gradient's size, so
    # a near-zero gradient whose sign differs between the two packages
    # moves that element by up to 2 lr per step
    "adam": (lambda m: m.optimizer.Adam(learning_rate=1e-3),
             lambda: optimizer.Adam(learning_rate=1e-3), 2 * 1e-3 * STEPS),
}


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_train_step_matches_jax(name):
    """3 ``TrainStep`` steps: losses to 1e-5 relative, parameters to the
    optimizer's tolerance, Adam's moments leaf by leaf to ADAM_STATE_TOL
    relative; each step launches K1 and K2 once per block."""
    make_jax_opt, make_opt, ptol = _OPTS[name]
    jnet = _jax_net()
    tnet = _port_net(jnet)
    ids, labels = _batch()
    jstep = jparallel.TrainStep(jnet, JaxCELoss(), make_jax_opt(mx),
                                example_inputs=[mnp.array(ids)])
    tstep = parallel.TrainStep(tnet, SoftmaxCrossEntropyLoss(), make_opt(),
                               example_inputs=[ids])
    for _ in range(STEPS):
        want = float(jstep(mnp.array(ids), mnp.array(labels)).item())
        with count_launches() as tally:
            got = float(tstep(ids, labels))
        assert abs(got - want) <= 1e-5 * abs(want)
        assert tally == {"flash_fwd": CFG["num_layers"], "flash_bwd": CFG["num_layers"]}
    assert _max_param_diff(jnet, tnet) <= ptol
    if name == "adam":
        err = _adam_state_err(
            {n: st for (n, _), st in zip(jstep.model.param_items, jstep._opt_states)},
            {n: st for (n, _), st in zip(tstep._params, tstep._states)})
        assert err <= ADAM_STATE_TOL


def test_train_step_run_equals_separate_steps():
    """``run(steps)`` advances the step counter per step: the same losses
    and parameters as separate calls (Adam's bias correction included)."""
    jnet = _jax_net()
    a, b = _port_net(jnet), _port_net(jnet)
    ids, labels = _batch(1)
    sa = parallel.TrainStep(a, SoftmaxCELoss(), optimizer.Adam(learning_rate=1e-3),
                            example_inputs=[ids])
    sb = parallel.TrainStep(b, SoftmaxCELoss(), "adam", example_inputs=[ids])
    sb.optimizer.set_learning_rate(1e-3)
    for _ in range(STEPS):
        last = sa(ids, labels)
    assert torch.equal(sb.run(ids, labels, STEPS), last.float())
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n


def test_trainer_matches_jax():
    """``loss.backward()`` + ``Trainer.step(B)`` with Adam against the JAX
    package's ``autograd.record`` + ``Trainer.step(B)``: losses to 1e-5
    relative, parameters to 2 lr per step, Adam's moments leaf by leaf to
    ADAM_STATE_TOL relative."""
    jnet = _jax_net()
    tnet = _port_net(jnet).train()
    ids, labels = _batch(2)
    jtr = JaxTrainer(jnet.collect_params(), "adam", {"learning_rate": 1e-3})
    ttr = Trainer(dict(tnet.named_parameters()), "adam", {"learning_rate": 1e-3})
    jloss_fn, tloss_fn = JaxCELoss(), SoftmaxCrossEntropyLoss()
    x, y = torch.from_numpy(ids), torch.from_numpy(labels)
    for _ in range(STEPS):
        with jautograd.record():
            jl = jloss_fn(jnet(mnp.array(ids)), mnp.array(labels))
        jl.backward()
        jtr.step(B)
        tl = tloss_fn(tnet(x), y)
        tl.backward(torch.ones_like(tl))   # MXNet's implicit head gradient
        ttr.step(B)
        want = jl.asnumpy()
        assert onp.abs(tl.detach().numpy() - want).max() <= 1e-5 * onp.abs(want).max()
    assert _max_param_diff(jnet, tnet) <= 2 * 1e-3 * STEPS
    err = _adam_state_err(dict(zip(jtr._param_names, jtr._states)),
                          {ttr._params[i][0]: st for i, st in ttr._states.items()})
    assert err <= ADAM_STATE_TOL


def test_trainer_stale_gradient_raises():
    tnet = _port_net(_jax_net()).train()
    tr = Trainer(tnet.named_parameters(), "sgd", {"learning_rate": 0.1})
    with pytest.raises(MXNetError, match="has not been updated"):
        tr.step(B)
    tr.step(B, ignore_stale_grad=True)          # nothing to do, no raise
    ids, labels = _batch()
    SoftmaxCELoss()(tnet(torch.from_numpy(ids)), torch.from_numpy(labels)).sum().backward()
    tr.step(B)
    assert all(p.grad is None for p in tnet.parameters())   # consumed


def test_bf16_train_step_loss_matches_jax():
    """bf16 parameters (``GPTConfig.dtype``): one step's loss agrees with
    the JAX package's bf16 model to bf16 rounding; parameters and Adam
    state stay bf16, LayerNorm stays f32."""
    jnet = _jax_net(jnp.bfloat16)
    tnet = _port_net(jnet, torch.bfloat16)
    assert tnet.wte.weight.dtype == torch.bfloat16
    assert tnet.blocks[0].attn_qkv.weight.dtype == torch.bfloat16
    assert tnet.ln_f.gamma.dtype == torch.float32
    ids, labels = _batch(3)
    jstep = jparallel.TrainStep(jnet, JaxCELoss(), mx.optimizer.Adam(learning_rate=1e-3),
                                example_inputs=[mnp.array(ids)])
    tstep = parallel.TrainStep(tnet, SoftmaxCELoss(), optimizer.Adam(learning_rate=1e-3),
                               example_inputs=[ids])
    for _ in range(2):
        want = float(jstep(mnp.array(ids), mnp.array(labels)).item())
        got = float(tstep(ids, labels))
        assert abs(got - want) <= 2e-2 * abs(want)
    assert tnet.wte.weight.dtype == torch.bfloat16
    assert all(s.dtype == torch.bfloat16 for s in tstep._states[0])
    assert _max_param_diff(jnet, tnet) <= 2 * 1e-3 * 2 + 1e-2


@pytest.mark.parametrize("kind", ["fused", "log_softmax", "dense", "weighted"])
def test_softmax_cross_entropy_matches_jax(kind):
    """Loss and gradient of each route of ``SoftmaxCrossEntropyLoss``."""
    rng = onp.random.RandomState(4)
    pred = rng.randn(3, 5, 11).astype("float32")
    sparse = rng.randint(0, 11, (3, 5)).astype("int32")
    dense = rng.dirichlet(onp.ones(11), (3, 5)).astype("float32")
    kw, label = {}, sparse
    if kind == "log_softmax":
        kw, pred = {"from_logits": True}, pred - onp.log(onp.exp(pred).sum(-1, keepdims=True))
    elif kind == "dense":
        kw, label = {"sparse_label": False}, dense
    elif kind == "weighted":
        kw = {"weight": 0.5}
    head = rng.randn(3).astype("float32")
    x = mnp.array(pred)
    x.attach_grad()
    with jautograd.record():
        jl = JaxCELoss(**kw)(x, mnp.array(label))
    jl.backward(mnp.array(head))
    tx = torch.from_numpy(pred).requires_grad_(True)
    tl = SoftmaxCrossEntropyLoss(**kw)(tx, torch.from_numpy(label))
    tl.backward(torch.from_numpy(head))
    assert onp.abs(tl.detach().numpy() - jl.asnumpy()).max() <= 1e-5
    assert onp.abs(tx.grad.numpy() - x.grad.asnumpy()).max() <= 1e-6


@pytest.mark.parametrize("name,kw", [
    ("sgd", {"momentum": 0.0, "wd": 0.01}), ("sgd", {"momentum": 0.9, "clip_gradient": 0.5}),
    ("adam", {"wd": 0.01}), ("adamw", {"wd": 0.01})])
def test_update_step_matches_jax(name, kw):
    """Each optimizer's pure ``update_step`` over 3 steps (t = 1, 2, 3)
    against the JAX package's on the same arrays."""
    from mxnet_tpu import optimizer as jopt
    rng = onp.random.RandomState(5)
    w = rng.randn(7, 9).astype("float32")
    jo, to = jopt.create(name, learning_rate=0.05, **kw), optimizer.create(
        name, learning_rate=0.05, **kw)
    jw, tw = jnp.asarray(w), torch.from_numpy(w.copy())
    js = jo.create_state(0, mnp.array(w))
    ts = to.create_state(0, tw)
    for t in (1, 2, 3):
        g = rng.randn(7, 9).astype("float32")
        jw, js = jo.update_step(jw, jnp.asarray(g), js, jnp.float32(0.05),
                                jnp.float32(to.wd), jnp.int32(t))
        tw, ts = to.update_step(tw, torch.from_numpy(g), ts, 0.05, to.wd, t)
    assert onp.abs(tw.numpy() - onp.asarray(jw)).max() <= 1e-6
    for a, b in zip(ts, js):
        assert onp.abs(a.numpy() - onp.asarray(b)).max() <= 1e-6


def test_params_round_trip_f32_and_bf16():
    """params_to_numpy gives back what params_from_numpy loaded: f32 as is,
    the JAX package's bf16 arrays as exact f32."""
    for jd, td in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        jnet = _jax_net(jd)
        tnet = _port_net(jnet, td)
        assert _max_param_diff(jnet, tnet) == 0.0
        again = params_from_numpy(GPTModel(GPTConfig(dtype=td, **CFG), device="cpu"),
                                  params_to_numpy(tnet))
        for (n, p), q in zip(tnet.named_parameters(), again.parameters()):
            assert p.dtype == q.dtype and torch.equal(p, q), n


def test_parameters_trainable_and_dropout_rule():
    """Model parameters require grad; the model starts in eval mode; a
    Dropout above rate 0 in training mode draws the JAX package's mask
    from the key stream (the same output after the same seed), and is the
    identity in eval mode or at rate 0."""
    from mxnet_tpu import numpy_extension as jnpx
    from mxnet_tpu_torch import random
    net = GPTModel(GPTConfig(**CFG), device="cpu")
    assert all(p.requires_grad for p in net.parameters())
    assert not net.training
    x = torch.randn(4, 8)
    drop = Dropout(0.1)
    mx.random.seed(3)
    random.seed(3)
    with jautograd.record():
        want = jnpx.dropout(mnp.array(x.numpy()), p=0.1).asnumpy()
    got = drop.train()(x)
    assert (got.numpy() == want).all() and (got == 0).any()
    assert torch.equal(drop.eval()(x), x)
    assert torch.equal(Dropout(0.0).train()(x), x)


@pytest.mark.parametrize("kw", [{"mesh": object()}, {"zero": 1}, {"remat": True},
                                {"health": True}, {"block_every": 2},
                                {"compression_params": {"type": "int8"}}])
def test_train_step_unported_options_raise(kw):
    net = GPTModel(GPTConfig(**CFG), device="cpu")
    with pytest.raises(MXNetError, match="not ported yet"):
        parallel.TrainStep(net, SoftmaxCELoss(), "sgd", example_inputs=[], **kw)
