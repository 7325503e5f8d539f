"""Port parity of BERT on the CPU: ``models.BertModel``,
``BertForSequenceClassification`` and ``BertForPretraining`` against the
JAX package's with its weights (``interop.params_from_numpy``, every name
loaded, none extra), on the same numpy inputs:

- ``BERT_TINY`` forward in f32 and in bf16 through ``amp.convert_hybrid_block``;
- a T 256 config (``FLASH``, attention dropout 0) whose attention runs the
  flash ``autograd.Function`` (the plain K1/K2 here), once a layer each
  way, where the JAX package takes its einsum route off the TPU;
- the JAX package's mask-semantics and dropout-active checks
  (``tests/test_models.py``), mirrored;
- dropout under ``autograd.record()`` equal to the JAX package's under one
  seed, on the einsum route (T 16) and the chunked route (T 640): the
  attention-dropout key is drawn where JAX draws it;
- three Adam ``TrainStep``s of the classifier (dropout 0.1 everywhere)
  against the JAX package's ``TrainStep``, and at T 256 through K1/K2;
- ``BertForPretraining`` (MLM + NSP) with LAMB, three ``TrainStep``s.

Tolerances: f32 outputs within 1e-4 of the JAX output's max-abs scale,
bf16 within 2e-2; losses within 1e-5 relative; parameters after the steps
within 2 * lr * steps (Adam and LAMB move an element by about lr a step,
so a near-zero gradient whose sign differs moves it by up to 2 lr).
"""
import numpy as onp
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import amp as jamp
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import np as jnp_
from mxnet_tpu import parallel as jparallel
from mxnet_tpu.gluon.loss import SoftmaxCrossEntropyLoss as JaxCELoss
from mxnet_tpu.models import bert as jbert

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import amp, autograd, interop, np, optimizer, parallel
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.models import (BERT_BASE, BERT_TINY, BertConfig, BertForPretraining,
                                    BertForSequenceClassification, BertModel)
from mxnet_tpu_torch.ops.int8_gemv import count_launches

F32_TOL, BF16_TOL, LOSS_TOL = 1e-4, 2e-2, 1e-5
LR, STEPS = 1e-3, 3
FLASH = dict(vocab_size=1024, hidden_size=64, num_layers=2, num_heads=4,
             intermediate_size=128, max_position_embeddings=288, attention_dropout=0.0)
LONG = dict(FLASH, max_position_embeddings=640, attention_dropout=0.3, num_layers=1)
FIELDS = ("vocab_size", "hidden_size", "num_layers", "num_heads", "intermediate_size",
          "max_position_embeddings", "type_vocab_size", "hidden_dropout",
          "attention_dropout", "layer_norm_eps")


@pytest.fixture(autouse=True)
def on_cpu():
    with mx.cpu():
        yield


def scaled_err(got, want):
    got, want = (onp.asarray(a, onp.float64) for a in (got, want))
    assert got.shape == want.shape
    return float(onp.abs(got - want).max() / max(onp.abs(want).max(), 1e-30))


def f32(a):
    return a.astype("float32").asnumpy()


def nets(jcls, tcls, cfg, **kw):
    """The JAX net at seed 0 and the port's net with its weights."""
    jmx.random.seed(0)
    jnet = jcls(jbert.BertConfig(**cfg), **kw)
    jnet.initialize()
    tnet = tcls(BertConfig(**cfg), **kw)
    tnet.initialize()
    interop.params_from_numpy(tnet, {k: p.data().asnumpy()
                                     for k, p in jnet.collect_params().items()})
    return jnet, tnet


def batch(cfg, B, T, seed=0):
    rng = onp.random.RandomState(seed)
    ids = rng.randint(0, cfg["vocab_size"], (B, T)).astype("int32")
    types = rng.randint(0, 2, (B, T)).astype("int32")
    return ids, types


def tiny():
    return {f: getattr(BERT_TINY, f) for f in FIELDS}


def test_configs_match_jax():
    for ours, theirs in ((BERT_TINY, jbert.BERT_TINY), (BERT_BASE, jbert.BERT_BASE)):
        for f in FIELDS:
            assert getattr(ours, f) == getattr(theirs, f), f


def test_parameter_names_match_jax():
    jnet, tnet = nets(jbert.BertForPretraining, BertForPretraining, tiny())
    assert list(tnet.collect_params()) == list(jnet.collect_params())


@pytest.mark.parametrize("cfg,T,flash", [(None, 16, 0), (FLASH, 256, 2)])
@pytest.mark.parametrize("bf16", [False, True])
def test_forward_matches_jax(cfg, T, flash, bf16):
    """Sequence output and pooled vector in inference, with token types;
    at T 256 the flash forward runs once a layer."""
    cfg = cfg or tiny()
    jnet, tnet = nets(jbert.BertModel, BertModel, cfg)
    ids, types = batch(cfg, 2, T)
    if bf16:
        jamp.convert_hybrid_block(jnet, "bfloat16")
        amp.convert_hybrid_block(tnet, "bfloat16")
    jseq, jpool = jnet(jnp_.array(ids), jnp_.array(types))
    with count_launches() as tally:
        tseq, tpool = tnet(np.array(ids), np.array(types))
    assert str(tseq.dtype) == str(jseq.dtype)
    assert tally.get("flash_fwd", 0) == flash and "flash_bwd" not in tally
    tol = BF16_TOL if bf16 else F32_TOL
    assert scaled_err(f32(tseq), f32(jseq)) <= tol
    assert scaled_err(f32(tpool), f32(jpool)) <= tol


def test_attention_mask_semantics():
    """An all-ones mask equals no mask (einsum route against the unmasked
    call), and with right padding the valid prefix equals the truncated
    sequence alone (``tests/test_models.py``'s check, at 1e-4)."""
    mx.random.seed(0)
    net = BertModel(BERT_TINY)
    net.initialize()
    rng = onp.random.RandomState(0)
    B, T, VALID = 2, 16, 10
    ids = rng.randint(0, BERT_TINY.vocab_size, (B, T)).astype("int32")
    seq_nomask, _ = net(np.array(ids))
    seq_ones, _ = net(np.array(ids), attention_mask=np.array(onp.ones((B, T), "float32")))
    onp.testing.assert_allclose(seq_ones.asnumpy(), seq_nomask.asnumpy(), rtol=1e-4,
                                atol=1e-4)
    mask = onp.zeros((B, T), "float32")
    mask[:, :VALID] = 1.0
    seq_masked, _ = net(np.array(ids), attention_mask=np.array(mask))
    seq_trunc, _ = net(np.array(ids[:, :VALID]))
    onp.testing.assert_allclose(seq_masked.asnumpy()[:, :VALID], seq_trunc.asnumpy(),
                                rtol=1e-4, atol=1e-4)


def test_attention_dropout_active_in_training():
    """With rate 0.5 under ``record()`` the output changes with the seed;
    at rate 0 it does not (``tests/test_models.py``'s check)."""
    def run(rate, seed):
        cfg = BertConfig(vocab_size=128, hidden_size=32, num_layers=1, num_heads=2,
                         intermediate_size=64, max_position_embeddings=32,
                         hidden_dropout=0.0, attention_dropout=rate)
        mx.random.seed(0)
        net = BertModel(cfg)
        net.initialize()
        mx.random.seed(seed)
        ids = np.array(onp.arange(16, dtype="int32")[None, :])
        with autograd.record(train_mode=True):
            seq, _ = net(ids)
        return seq.asnumpy()

    a, b = run(0.5, 1), run(0.5, 2)
    assert not onp.allclose(a, b), "attention dropout had no effect"
    onp.testing.assert_allclose(run(0.0, 1), run(0.0, 2), rtol=1e-6)


@pytest.mark.parametrize("cfg,T", [(None, 16), (LONG, 640)])
def test_dropout_under_record_matches_jax(cfg, T):
    """Hidden dropout 0.1 and attention dropout under ``record()`` after
    ``random.seed(5)`` on both sides, with a right-padded key mask: the
    same masks, so the same sequence output and input gradient of the
    word embeddings. T 16 takes the einsum route, T 640 the chunked one."""
    cfg = cfg or tiny()
    jnet, tnet = nets(jbert.BertModel, BertModel, cfg)
    ids, types = batch(cfg, 2, T)
    mask = onp.ones((2, T), "float32")
    mask[1, T // 2:] = 0.0
    jmx.random.seed(5)
    with jautograd.record(train_mode=True):
        jseq, _ = jnet(jnp_.array(ids), jnp_.array(types), jnp_.array(mask))
    mx.random.seed(5)
    with autograd.record(train_mode=True):
        tseq, _ = tnet(np.array(ids), np.array(types), np.array(mask))
    assert scaled_err(tseq.asnumpy(), jseq.asnumpy()) <= F32_TOL


def run_steps(jnet, tnet, loss_pair, opt_pair, inputs, labels):
    """STEPS ``TrainStep``s on both sides: the losses and the launches of
    each port step."""
    jstep = jparallel.TrainStep(jnet, loss_pair[0], opt_pair[0],
                                example_inputs=[jnp_.array(a) for a in inputs])
    tstep = parallel.TrainStep(tnet, loss_pair[1], opt_pair[1], example_inputs=inputs)
    out = []
    for _ in range(STEPS):
        want = float(jstep([jnp_.array(a) for a in inputs],
                           [jnp_.array(a) for a in labels]).item())
        with count_launches() as tally:
            got = float(tstep(inputs, labels))
        out.append((got, want, dict(tally)))
    return out


def params_close(jnet, tnet, tol):
    want = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    for k, p in tnet.collect_params().items():
        assert onp.abs(p.data().asnumpy() - want[k]).max() <= tol, k


@pytest.mark.parametrize("cfg,T,flash", [(None, 16, 0), (FLASH, 256, 2)])
def test_classifier_train_step_matches_jax(cfg, T, flash):
    """Three Adam steps of the sequence classifier at hidden dropout 0.1
    (and attention dropout 0.1 at T 16), the masks from each step's key
    supply; at T 256 K1 and K2 carry every layer's attention."""
    cfg = cfg or tiny()
    jnet, tnet = nets(jbert.BertForSequenceClassification, BertForSequenceClassification,
                      cfg, num_classes=3)
    ids, types = batch(cfg, 2, T)
    y = onp.random.RandomState(1).randint(0, 3, 2).astype("int32")
    steps = run_steps(jnet, tnet, (JaxCELoss(), SoftmaxCrossEntropyLoss()),
                      (jmx.optimizer.Adam(learning_rate=LR), optimizer.Adam(learning_rate=LR)),
                      [ids, types], [y])
    for got, want, tally in steps:
        assert abs(got - want) <= LOSS_TOL * abs(want)
        assert tally.get("flash_fwd", 0) == tally.get("flash_bwd", 0) == flash
    params_close(jnet, tnet, 2 * LR * STEPS)


def pretraining_loss(ce):
    """MLM cross-entropy over every position plus NSP cross-entropy, per
    example."""
    mlm_ce, nsp_ce = ce(axis=-1), ce()

    def loss(outs, mlm_labels, nsp_labels):
        return mlm_ce(outs[0], mlm_labels) + nsp_ce(outs[1], nsp_labels)
    return loss


def test_pretraining_lamb_train_step_matches_jax():
    """``BertForPretraining`` at BERT_TINY's width, three LAMB steps (wd
    0.01) on MLM + NSP: losses and parameters against the JAX package's."""
    cfg = tiny()
    jnet, tnet = nets(jbert.BertForPretraining, BertForPretraining, cfg)
    ids, types = batch(cfg, 2, 16)
    rng = onp.random.RandomState(2)
    mlm = rng.randint(0, cfg["vocab_size"], (2, 16)).astype("int32")
    nsp = rng.randint(0, 2, 2).astype("int32")
    steps = run_steps(jnet, tnet, (pretraining_loss(JaxCELoss),
                                   pretraining_loss(SoftmaxCrossEntropyLoss)),
                      (jmx.optimizer.LAMB(learning_rate=LR, wd=0.01),
                       optimizer.LAMB(learning_rate=LR, wd=0.01)),
                      [ids, types], [mlm, nsp])
    for got, want, _ in steps:
        assert abs(got - want) <= LOSS_TOL * abs(want)
    assert steps[-1][0] < steps[0][0]
    params_close(jnet, tnet, 2 * LR * STEPS)
