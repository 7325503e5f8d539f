"""Port parity of the learning-rate schedulers on the CPU: every
scheduler's rates over its updates against ``mxnet_tpu.lr_scheduler``,
the ``Optimizer(lr_scheduler=)`` hook, and ``TrainStep`` and ``Trainer``
stepping a small GPT on a warmup + cosine schedule next to the JAX
package."""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import lr_scheduler as jsched
from mxnet_tpu import np as mnp
from mxnet_tpu import parallel as jparallel
from mxnet_tpu.gluon import Trainer as JaxTrainer
from mxnet_tpu.gluon.loss import SoftmaxCrossEntropyLoss as JaxCELoss
from mxnet_tpu.models import GPTModel as JaxGPT
from mxnet_tpu.models.gpt import GPTConfig as JaxGPTConfig

from mxnet_tpu_torch import lr_scheduler, optimizer, parallel, random
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import Trainer
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.interop import params_from_numpy, params_to_numpy
from mxnet_tpu_torch.models import GPTConfig, GPTModel

CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
           max_position_embeddings=256, dropout=0.1)
B, T, STEPS = 2, 256, 4

SCHEDULES = {
    "factor": ("FactorScheduler", dict(step=3, factor=0.5, stop_factor_lr=1e-3, base_lr=0.1)),
    "factor_warmup": ("FactorScheduler", dict(step=2, factor=0.7, base_lr=0.2,
                                              warmup_steps=5, warmup_begin_lr=0.01)),
    "multifactor": ("MultiFactorScheduler", dict(step=[3, 7, 12], factor=0.3, base_lr=0.5)),
    "multifactor_warmup": ("MultiFactorScheduler",
                           dict(step=[6, 9], factor=0.5, base_lr=0.5, warmup_steps=4,
                                warmup_mode="constant", warmup_begin_lr=0.05)),
    "poly": ("PolyScheduler", dict(max_update=15, base_lr=0.3, pwr=2, final_lr=0.01)),
    "poly_warmup": ("PolyScheduler", dict(max_update=15, base_lr=0.3, pwr=3,
                                          warmup_steps=4, warmup_begin_lr=0.0)),
    "cosine": ("CosineScheduler", dict(max_update=12, base_lr=0.4, final_lr=0.02)),
    "cosine_warmup": ("CosineScheduler", dict(max_update=18, base_lr=0.4, warmup_steps=5,
                                              warmup_begin_lr=0.04)),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_scheduler_values_match_jax(name):
    """Rates at updates 0..N (past the end of the schedule), called in
    order as the optimizer calls them: equal to the JAX package's."""
    cls, kw = SCHEDULES[name]
    want = getattr(jsched, cls)(**kw)
    got = getattr(lr_scheduler, cls)(**kw)
    for n in range(25):
        assert got(n) == want(n), n


def test_bad_warmup_mode_raises():
    with pytest.raises(MXNetError, match="bad warmup_mode"):
        lr_scheduler.CosineScheduler(10, warmup_mode="cubic")


def test_optimizer_hook():
    """``learning_rate`` reads ``scheduler(num_update)``; setting it sets the
    scheduler's ``base_lr``; the constructor's rate becomes ``base_lr``."""
    for make in (lambda m, s: m.optimizer.SGD(learning_rate=0.2, lr_scheduler=s),
                 lambda m, s: m.optimizer.Adam(learning_rate=0.2, lr_scheduler=s)):
        pair = [make(mod, getattr(mod.lr_scheduler, "FactorScheduler")(step=2, factor=0.5))
                for mod in (mx, _PortNamespace)]
        for o in pair:
            assert o.lr_scheduler.base_lr == 0.2
        rates = [[], []]
        for n in range(8):
            for o, r in zip(pair, rates):
                o.num_update = n
                r.append(o.learning_rate)
        assert rates[0] == rates[1]
        for o in pair:
            o.set_learning_rate(0.05)
            assert o.lr_scheduler.base_lr == 0.05
        assert pair[0].learning_rate == pair[1].learning_rate


class _PortNamespace:
    optimizer = optimizer
    lr_scheduler = lr_scheduler


def _nets():
    mx.random.seed(0)
    jnet = JaxGPT(JaxGPTConfig(**CFG))
    jnet.initialize()
    jnet(mnp.array(onp.zeros((1, 4), "int32")))
    named = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    return jnet, params_from_numpy(GPTModel(GPTConfig(**CFG), device="cpu"), named)


def _batch(seed):
    rng = onp.random.RandomState(seed)
    return (rng.randint(0, CFG["vocab_size"], (B, T)).astype("int32"),
            rng.randint(0, CFG["vocab_size"], (B, T)).astype("int32"))


def _max_param_diff(jnet, tnet):
    got = params_to_numpy(tnet)
    return max(float(onp.abs(got[n] - p.data().asnumpy()).max())
               for n, p in jnet.collect_params().items())


def _cosine(mod):
    return mod.lr_scheduler.CosineScheduler(max_update=6, warmup_steps=2,
                                            warmup_begin_lr=1e-4, final_lr=1e-4)


def test_train_step_with_scheduler_matches_jax():
    """4 ``TrainStep`` steps of Adam on warmup + cosine at dropout 0.1:
    losses to 1e-5 relative, parameters to 2 lr per step (the file
    tests/test_torch_gpt_train.py's Adam tolerance at lr 1e-3)."""
    jnet, tnet = _nets()
    ids, labels = _batch(0)
    jstep = jparallel.TrainStep(
        jnet, JaxCELoss(), mx.optimizer.Adam(learning_rate=1e-3, lr_scheduler=_cosine(mx)),
        example_inputs=[mnp.array(ids)])
    tstep = parallel.TrainStep(
        tnet, SoftmaxCrossEntropyLoss(),
        optimizer.Adam(learning_rate=1e-3, lr_scheduler=_cosine(_PortNamespace)),
        example_inputs=[ids])
    for _ in range(STEPS):
        want = float(jstep(mnp.array(ids), mnp.array(labels)).item())
        got = float(tstep(ids, labels))
        assert abs(got - want) <= 1e-5 * abs(want)
        assert tstep.optimizer.learning_rate == jstep.optimizer.learning_rate
    assert _max_param_diff(jnet, tnet) <= 2 * 1e-3 * STEPS


def test_trainer_with_scheduler_matches_jax():
    """The eager path: ``Trainer`` reads the schedule at its step count."""
    jnet, tnet = _nets()
    tnet.train()
    ids, labels = _batch(1)
    jtr = JaxTrainer(jnet.collect_params(), "adam",
                     {"learning_rate": 1e-3, "lr_scheduler": _cosine(mx)})
    ttr = Trainer(dict(tnet.named_parameters()), "adam",
                  {"learning_rate": 1e-3, "lr_scheduler": _cosine(_PortNamespace)})
    mx.random.seed(4)
    random.seed(4)
    x, y = torch.from_numpy(ids), torch.from_numpy(labels)
    for _ in range(STEPS):
        with jautograd.record():
            jl = JaxCELoss()(jnet(mnp.array(ids)), mnp.array(labels))
        jl.backward()
        jtr.step(B)
        tl = SoftmaxCrossEntropyLoss()(tnet(x), y)
        tl.backward(torch.ones_like(tl))
        ttr.step(B)
        want = jl.asnumpy()
        assert onp.abs(tl.detach().numpy() - want).max() <= 1e-5 * onp.abs(want).max()
        assert ttr.learning_rate == jtr.learning_rate
    assert _max_param_diff(jnet, tnet) <= 2 * 1e-3 * STEPS
