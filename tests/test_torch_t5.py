"""Port parity of T5 on the CPU: ``models.T5Model`` against the JAX
package's with its weights (``interop.params_from_numpy``, every name
loaded, none extra), on the same numpy inputs:

- the relative-position bucket table equal to the JAX package's exactly,
  for every relative position in [-1024, 1024], at ``T5_SMALL``'s and
  ``T5_TINY``'s settings, bidirectional (encoder) and causal (decoder);
- the model's parameter names (``enc_rel_bias``, ``dec_rel_bias``,
  ``enc_{i}``, ``dec_{i}``, each child registered once);
- forward logits in f32 and in bf16 through ``amp.convert_hybrid_block``,
  and ``encode``;
- three Adam ``TrainStep``s (teacher-forced copy batch) against the JAX
  package's ``TrainStep``: no flash kernel launches.

Tolerances: f32 within 1e-4 of the JAX output's max-abs scale, bf16 within
2e-2; losses within 1e-5 relative; parameters within 2 * lr * steps.
"""
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import amp as jamp
from mxnet_tpu import np as jnp_
from mxnet_tpu import parallel as jparallel
from mxnet_tpu.gluon.loss import SoftmaxCrossEntropyLoss as JaxCELoss
from mxnet_tpu.models import t5 as jt5

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import amp, interop, np, optimizer, parallel
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.models import T5_SMALL, T5_TINY, T5Config, T5Model
from mxnet_tpu_torch.models import t5 as tt5
from mxnet_tpu_torch.ops.int8_gemv import count_launches

F32_TOL, BF16_TOL, LOSS_TOL = 1e-4, 2e-2, 1e-5
LR, STEPS = 1e-3, 3
FIELDS = ("vocab_size", "d_model", "d_ff", "num_layers", "num_heads", "relative_buckets",
          "relative_max_distance", "layer_norm_eps", "dropout")


@pytest.fixture(autouse=True)
def on_cpu():
    with mx.cpu():
        yield


def scaled_err(got, want):
    got, want = (onp.asarray(a, onp.float64) for a in (got, want))
    assert got.shape == want.shape
    return float(onp.abs(got - want).max() / max(onp.abs(want).max(), 1e-30))


def test_configs_match_jax():
    for ours, theirs in ((T5_TINY, jt5.T5_TINY), (T5_SMALL, jt5.T5_SMALL)):
        for f in FIELDS:
            assert getattr(ours, f) == getattr(theirs, f), f


@pytest.mark.parametrize("cfg", [T5_SMALL, T5_TINY], ids=["small", "tiny"])
@pytest.mark.parametrize("bidirectional", [True, False])
def test_bucket_table_exact(cfg, bidirectional):
    """Every relative position in [-1024, 1024] lands in JAX's bucket, and
    the cached [T, S] table is ``_relative_bucket`` of S - T offsets."""
    rel = onp.arange(-1024, 1025, dtype=onp.int64)
    want = onp.asarray(jt5._relative_bucket(jnp.asarray(rel), cfg.relative_buckets,
                                            cfg.relative_max_distance, bidirectional))
    got = tt5._relative_bucket(torch.from_numpy(rel), cfg.relative_buckets,
                               cfg.relative_max_distance, bidirectional).numpy()
    assert onp.array_equal(got, want)
    assert got.min() >= 0 and got.max() < cfg.relative_buckets
    table = tt5._bucket_table(7, 11, cfg.relative_buckets, cfg.relative_max_distance,
                              bidirectional, "cpu")
    rel2 = onp.arange(11)[None, :] - onp.arange(7)[:, None]
    assert onp.array_equal(table.numpy(), got[rel2 + 1024])


def nets(cfg_kw):
    jmx.random.seed(0)
    jnet = jt5.T5Model(jt5.T5Config(**cfg_kw))
    jnet.initialize()
    tnet = T5Model(T5Config(**cfg_kw))
    tnet.initialize()
    interop.params_from_numpy(tnet, {k: p.data().asnumpy()
                                     for k, p in jnet.collect_params().items()})
    return jnet, tnet


def tiny():
    return {f: getattr(T5_TINY, f) for f in FIELDS}


def copy_batch(B=2, S=12, T=9, seed=0):
    rng = onp.random.RandomState(seed)
    src = rng.randint(2, T5_TINY.vocab_size, (B, S)).astype("int32")
    tgt = src[:, :T]
    dec_in = onp.concatenate([onp.zeros((B, 1), "int32"), tgt[:, :-1]], 1)
    return src, dec_in, tgt


def test_parameter_names_match_jax():
    jnet, tnet = nets(tiny())
    names = list(tnet.collect_params())
    assert names == list(jnet.collect_params())
    assert len(names) == len(set(names))
    assert {"enc_rel_bias", "dec_rel_bias", "enc_0.self_attn.q.weight",
            "dec_1.cross_attn.o.weight"} <= set(names)


@pytest.mark.parametrize("bf16", [False, True])
def test_forward_matches_jax(bf16):
    """Decoder logits (sources of 12, targets of 9: T != S in the
    cross-attention) and the encoder's memory."""
    jnet, tnet = nets(tiny())
    src, dec_in, _ = copy_batch()
    if bf16:
        jamp.convert_hybrid_block(jnet, "bfloat16")
        amp.convert_hybrid_block(tnet, "bfloat16")
    want = jnet(jnp_.array(src), jnp_.array(dec_in))
    with count_launches() as tally:
        got = tnet(np.array(src), np.array(dec_in))
    assert tally == {}
    assert str(got.dtype) == str(want.dtype)
    tol = BF16_TOL if bf16 else F32_TOL
    assert scaled_err(got.astype("float32").asnumpy(), want.astype("float32").asnumpy()) <= tol
    mem_j = jnet.encode(jnp_.array(src)).astype("float32").asnumpy()
    mem_t = tnet.encode(np.array(src)).astype("float32").asnumpy()
    assert scaled_err(mem_t, mem_j) <= tol


def test_train_step_matches_jax():
    """Three Adam steps on a teacher-forced copy batch, the loss over every
    target position."""
    jnet, tnet = nets(tiny())
    src, dec_in, tgt = copy_batch()
    jstep = jparallel.TrainStep(jnet, JaxCELoss(axis=-1), jmx.optimizer.Adam(learning_rate=LR),
                                example_inputs=[jnp_.array(src), jnp_.array(dec_in)])
    tstep = parallel.TrainStep(tnet, SoftmaxCrossEntropyLoss(axis=-1),
                               optimizer.Adam(learning_rate=LR), example_inputs=[src, dec_in])
    losses = []
    for _ in range(STEPS):
        want = float(jstep([jnp_.array(src), jnp_.array(dec_in)], [jnp_.array(tgt)]).item())
        with count_launches() as tally:
            got = float(tstep([src, dec_in], [tgt]))
        assert tally == {}
        assert abs(got - want) <= LOSS_TOL * abs(want)
        losses.append(got)
    assert losses[-1] < losses[0]
    want_p = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    for k, p in tnet.collect_params().items():
        assert onp.abs(p.data().asnumpy() - want_p[k]).max() <= 2 * LR * STEPS, k
