"""Port parity of the Vision Transformer on the CPU: ``models.ViTModel``
against ``mxnet_tpu.models.ViTModel`` with the JAX package's weights, at
``VIT_TINY`` (T 17: the plain attention) and at 128 x 128 with 8 x 8
patches (T 257 >= 256: the flash ``autograd.Function``, whose plain K1 and
K2 run on the CPU, once a layer each way); forward in f32 and in bf16
through ``amp.convert_hybrid_block``, and three Adam ``TrainStep``s
against the JAX package's ``TrainStep``.

Tolerances: f32 outputs within 1e-4 of the JAX output's max-abs scale,
bf16 within 2e-2; losses within 1e-5 relative; parameters after the steps
within 2 * lr * steps (Adam moves an element by about lr a step whatever
its gradient, so a near-zero gradient whose sign differs moves it by up
to 2 lr).
"""
import numpy as onp
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import amp as jamp
from mxnet_tpu import np as jnp_
from mxnet_tpu import parallel as jparallel
from mxnet_tpu.gluon.loss import SoftmaxCrossEntropyLoss as JaxCELoss
from mxnet_tpu.models import VIT_TINY as J_VIT_TINY
from mxnet_tpu.models import ViTConfig as JViTConfig
from mxnet_tpu.models import ViTModel as JViTModel

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import amp, np, optimizer, parallel
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.models import VIT_B16, VIT_TINY, ViTConfig, ViTModel
from mxnet_tpu_torch.ops.int8_gemv import count_launches

F32_TOL, BF16_TOL, LOSS_TOL = 1e-4, 2e-2, 1e-5
LR, STEPS = 1e-3, 3
FLASH = dict(image_size=128, patch_size=8, num_classes=10, hidden_size=64, num_layers=2,
             num_heads=4)
TINY = dict(image_size=32, patch_size=8, num_classes=10, hidden_size=64, num_layers=2,
            num_heads=4)


@pytest.fixture(autouse=True)
def on_cpu():
    with mx.cpu():
        yield


def scaled_err(got, want):
    got, want = (onp.asarray(a, onp.float64) for a in (got, want))
    assert got.shape == want.shape
    return float(onp.abs(got - want).max() / max(onp.abs(want).max(), 1e-30))


def nets(cfg):
    x = onp.random.RandomState(0).rand(2, 3, cfg["image_size"], cfg["image_size"])
    x = x.astype("float32")
    jmx.random.seed(0)
    jnet = JViTModel(JViTConfig(**cfg))
    jnet.initialize()
    jnet(jnp_.array(x))
    tnet = ViTModel(ViTConfig(**cfg))
    tnet.initialize()
    tnet.load_dict({k: p.data().asnumpy() for k, p in jnet.collect_params().items()})
    return jnet, tnet, x


def test_configs_match_jax():
    for ours, theirs in ((VIT_TINY, J_VIT_TINY), (VIT_B16, JViTConfig())):
        for f in ("image_size", "patch_size", "num_classes", "hidden_size", "num_layers",
                  "num_heads", "mlp_ratio", "dropout", "layer_norm_eps"):
            assert getattr(ours, f) == getattr(theirs, f), f
    assert ViTConfig(image_size=384).num_patches + 1 == 577


@pytest.mark.parametrize("cfg,flash", [(TINY, 0), (FLASH, 2)])
@pytest.mark.parametrize("bf16", [False, True])
def test_forward_matches_jax(cfg, flash, bf16):
    jnet, tnet, x = nets(cfg)
    xj, xt = jnp_.array(x), np.array(x)
    if bf16:
        jamp.convert_hybrid_block(jnet, "bfloat16")
        amp.convert_hybrid_block(tnet, "bfloat16")
        xj, xt = xj.astype("bfloat16"), xt.astype("bfloat16")
    want = jnet(xj)
    with count_launches() as tally:
        got = tnet(xt)
    assert str(got.dtype) == str(want.dtype)
    assert tally.get("flash_fwd", 0) == flash
    err = scaled_err(got.astype("float32").asnumpy(), want.astype("float32").asnumpy())
    assert err <= (BF16_TOL if bf16 else F32_TOL)


@pytest.mark.parametrize("cfg", [TINY, FLASH])
def test_train_step_matches_jax(cfg):
    """Three Adam ``TrainStep``s; at T 257 each step runs the flash
    ``Function`` once a layer forward and backward."""
    jnet, tnet, x = nets(cfg)
    y = onp.random.RandomState(1).randint(0, 10, 2).astype("int32")
    jstep = jparallel.TrainStep(jnet, JaxCELoss(), jmx.optimizer.Adam(learning_rate=LR),
                                example_inputs=[jnp_.array(x)])
    tstep = parallel.TrainStep(tnet, SoftmaxCrossEntropyLoss(),
                               optimizer.Adam(learning_rate=LR), example_inputs=[x])
    n = cfg["num_layers"] if cfg is FLASH else 0
    for _ in range(STEPS):
        want = float(jstep(jnp_.array(x), jnp_.array(y)).item())
        with count_launches() as tally:
            got = float(tstep(x, y))
        assert abs(got - want) <= LOSS_TOL * abs(want)
        assert tally.get("flash_fwd", 0) == tally.get("flash_bwd", 0) == n
    want_p = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    for k, p in tnet.collect_params().items():
        assert onp.abs(p.data().asnumpy() - want_p[k]).max() <= 2 * LR * STEPS, k
