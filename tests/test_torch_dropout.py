"""Port parity of dropout and its key stream on the CPU: the counter-hash
keep bits, ``npx.dropout`` forward and gradient, the global key stream and
``KeySupply`` against the JAX package bit for bit, then a small GPT at
dropout 0.1 training through ``TrainStep`` and through ``Trainer`` next to
the JAX package, and inference on the trained model without dropout."""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import _random as jrandom
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import np as mnp
from mxnet_tpu import numpy_extension as jnpx
from mxnet_tpu import parallel as jparallel
from mxnet_tpu.gluon import Trainer as JaxTrainer
from mxnet_tpu.gluon.loss import SoftmaxCrossEntropyLoss as JaxCELoss
from mxnet_tpu.models import GPTModel as JaxGPT
from mxnet_tpu.models import generate as jax_generate
from mxnet_tpu.models.gpt import GPTConfig as JaxGPTConfig

from mxnet_tpu_torch import _prng, _random, optimizer, parallel, random
from mxnet_tpu_torch import numpy_extension as npx
from mxnet_tpu_torch.gluon import Trainer
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.models._layers import Dropout
from mxnet_tpu_torch.interop import params_from_numpy, params_to_numpy
from mxnet_tpu_torch.models import GPTConfig, GPTModel, generate
from mxnet_tpu_torch.ops.int8_gemv import count_launches
from mxnet_tpu_torch.serve import InferenceEngine

# the shape tests/test_torch_gpt_train.py trains, at GPTConfig's default dropout
CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
           max_position_embeddings=256, dropout=0.1)
B, T, STEPS = 2, 256, 3
# about 10x the relative L2 error of Adam's moments the dropout-free cases read
ADAM_STATE_TOL = 3e-5


def _jkey(words):
    return jax.random.wrap_key_data(jnp.asarray(onp.asarray(words, onp.uint32)))


def _keys(n, seed):
    return onp.random.RandomState(seed).randint(0, 2 ** 32, (n, 2), dtype=onp.uint64)


# ------------------------------------------------------------ keep bits

@pytest.mark.parametrize("keep_prob", [0.9, 0.5, 0.0, 1.0])
@pytest.mark.parametrize("hi", [False, True])
def test_keep_bits_at_bitwise(keep_prob, hi):
    """Random keys, indices at 0, around 2**31 and up to 2**32 - 1, with and
    without the high word: the port's bits equal JAX's, all of them."""
    rng = onp.random.RandomState(1)
    idx = onp.concatenate([onp.arange(64), 2 ** 31 - 32 + onp.arange(64),
                           2 ** 32 - 64 + onp.arange(64),
                           rng.randint(0, 2 ** 32, 256, dtype=onp.uint64)]).astype(onp.uint64)
    idx_hi = rng.randint(0, 2 ** 32, idx.shape, dtype=onp.uint64) if hi else None
    for words in _keys(4, 2):
        want = onp.asarray(jnpx._keep_bits_at(
            _jkey(words), jnp.asarray(idx.astype(onp.uint32)), keep_prob,
            idx_hi=None if idx_hi is None else jnp.asarray(idx_hi.astype(onp.uint32))))
        got = npx._keep_bits_at(
            torch.tensor(words.astype(onp.int64)), torch.from_numpy(idx.astype(onp.int64)),
            keep_prob, None if idx_hi is None else torch.from_numpy(idx_hi.astype(onp.int64)))
        assert (got.numpy() == want).all()


@pytest.mark.parametrize("shape", [(7, 33), (2, 3, 5, 4), (0, 4), (1,)])
def test_cheap_keep_mask_bitwise(shape):
    """Flat-position masks over a dense shape (an empty one keeps all)."""
    for words in _keys(3, 3):
        want = onp.asarray(jnpx._cheap_keep_mask(_jkey(words), shape, 0.7))
        got = npx._cheap_keep_mask(torch.tensor(words.astype(onp.int64)), shape, 0.7)
        assert got.dtype == torch.bool and tuple(got.shape) == shape
        assert (got.numpy() == want).all()


# --------------------------------------------------------------- dropout

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p,axes", [(0.1, ()), (0.5, (1,)), (0.3, (0, 2))])
def test_dropout_matches_jax_exactly(dtype, p, axes):
    """Three draws after the same seed: outputs and gradients bit for bit
    in f32 and bf16 (whose scale is bf16(1 - p), as JAX rounds it)."""
    rng = onp.random.RandomState(4)
    x = rng.randn(3, 16, 10).astype("float32")
    head = rng.randn(3, 16, 10).astype("float32")
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    mx.random.seed(11)
    random.seed(11)
    for _ in range(3):
        jx = mnp.array(jnp.asarray(x, jdt))
        jx.attach_grad()
        with jautograd.record():
            jy = jnpx.dropout(jx, p=p, axes=axes)
        jy.backward(mnp.array(jnp.asarray(head, jdt)))
        tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
        ty = npx.dropout(tx, p=p, axes=axes, training=True)
        ty.backward(torch.from_numpy(head).to(tdt))
        for got, want in ((ty.detach(), jy), (tx.grad, jx.grad)):
            want = onp.asarray(jnp.asarray(want._data, jnp.float32))
            assert got.dtype == tdt
            assert (got.float().numpy() == want).all()


def test_no_key_consumed_at_p0_or_inference():
    """p = 0, inference and an eval-mode layer return the input and draw no
    key: the next key is the one a fresh seed gives, as in JAX."""
    x = torch.randn(4, 8)
    random.seed(5)
    assert npx.dropout(x, p=0.0, training=True) is x
    assert npx.dropout(x, p=0.5, training=False) is x
    assert npx.dropout(x, p=0.5) is x
    assert torch.equal(Dropout(0.5).eval()(x), x)
    assert torch.equal(Dropout(0.0).train()(x), x)
    got = _random.next_key()
    mx.random.seed(5)
    jx = mnp.array(x.numpy())
    with jautograd.record():
        jnpx.dropout(jx, p=0.0)
    jnpx.dropout(jx, p=0.5)
    want = onp.asarray(jax.random.key_data(jrandom.next_key()))
    assert got.tolist() == want.tolist()


def test_global_stream_and_supply_match_jax():
    """seed / next_key / get_state / set_state and KeySupply give JAX's
    keys; the supply's keys stay on its base key's device."""
    for s in (0, 7, 2 ** 31 + 5):
        random.seed(s)
        mx.random.seed(s)
        for _ in range(4):
            assert _random.next_key().tolist() == \
                onp.asarray(jax.random.key_data(jrandom.next_key())).tolist()
        state = _random.get_state()
        assert state == jrandom.get_state()
        a = _random.next_key()
        _random.set_state(state)
        assert torch.equal(_random.next_key(), a)
    base = _prng.key(9)
    with _random.KeySupply(base) as sup, jrandom.TraceKeySupply(jax.random.key(9)):
        assert _random.STATE.supply is sup
        for _ in range(5):
            k = _random.next_key()
            assert k.device == base.device
            assert k.tolist() == onp.asarray(jax.random.key_data(jrandom.next_key())).tolist()
    assert _random.STATE.supply is None


# ------------------------------------------------------------ GPT training

def _jax_net():
    mx.random.seed(0)
    net = JaxGPT(JaxGPTConfig(**CFG))
    net.initialize()
    net(mnp.array(onp.zeros((1, 4), "int32")))
    return net


def _port_net(jnet):
    named = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    return params_from_numpy(GPTModel(GPTConfig(**CFG), device="cpu"), named)


def _batch(seed=0):
    rng = onp.random.RandomState(seed)
    return (rng.randint(0, CFG["vocab_size"], (B, T)).astype("int32"),
            rng.randint(0, CFG["vocab_size"], (B, T)).astype("int32"))


def _max_param_diff(jnet, tnet):
    got = params_to_numpy(tnet)
    want = {n: onp.asarray(p.data().asnumpy(), "float32")
            for n, p in jnet.collect_params().items()}
    return max(float(onp.abs(got[n] - want[n]).max()) for n in want)


def _adam_state_err(jstates, tstates):
    worst = 0.0
    for name, js in jstates.items():
        for got, want in zip(tstates[name], js):
            want = onp.asarray(want, "float32")
            err = onp.linalg.norm(got.float().numpy() - want)
            worst = max(worst, err / max(float(onp.linalg.norm(want)), 1e-30))
    return worst


def test_gpt_dropout_sites_in_jax_order(monkeypatch):
    """25 sites for GPT-2 small, 1 + 2 L here: the embedding's ``drop``
    draws first, then each block's ``attn_out`` site and ``mlp_proj``
    site, each right after its Dense."""
    net = _port_net(_jax_net()).train()
    events = []
    orig = _random.next_key
    monkeypatch.setattr(_random, "next_key", lambda: events.append("key") or orig())
    for i, blk in enumerate(net.blocks):
        for name in ("attn_out", "mlp_proj"):
            getattr(blk, name).register_forward_hook(
                lambda *a, tag=f"{i}.{name}": events.append(tag))
    with torch.no_grad(), _random.KeySupply(_prng.key(1)):
        net(torch.zeros(1, 8, dtype=torch.int32))
    want = ["key"]
    for i in range(CFG["num_layers"]):
        want += [f"{i}.attn_out", "key", f"{i}.mlp_proj", "key"]
    assert events == want


def test_train_forward_masks_equal_jax():
    """One training-mode forward under step 5's keys: the logits equal the
    JAX package's traced step (its apply with seed 5) to f32 summation
    order, far below what one differing mask would move."""
    jnet = _jax_net()
    tnet = _port_net(jnet).train()
    ids, _ = _batch(6)
    jstep = jparallel.TrainStep(jnet, JaxCELoss(), "sgd", example_inputs=[mnp.array(ids)])
    jout, _ = jstep.model.apply(jstep.model.values(), ids, seed=5, training=True)
    with torch.no_grad(), _random.KeySupply(_prng.key(5)):
        tout = tnet(torch.from_numpy(ids))
    want = onp.asarray(jout[0] if isinstance(jout, (tuple, list)) else jout)
    assert onp.abs(tout.numpy() - want).max() <= 1e-4


_OPTS = {
    "sgd": (lambda: mx.optimizer.SGD(learning_rate=0.1, momentum=0.9),
            lambda: optimizer.SGD(learning_rate=0.1, momentum=0.9), 1e-5),
    "adam": (lambda: mx.optimizer.Adam(learning_rate=1e-3),
             lambda: optimizer.Adam(learning_rate=1e-3), 2 * 1e-3 * STEPS),
}


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_train_step_dropout_matches_jax(name):
    """3 ``TrainStep`` steps at dropout 0.1 against the JAX package's: losses
    to 1e-5 relative, parameters to the optimizer's tolerance
    (tests/test_torch_gpt_train.py), Adam's moments to ADAM_STATE_TOL
    relative; 12 K1 + 12 K2 launches a step in GPT-2 small, L each here."""
    make_jax_opt, make_opt, ptol = _OPTS[name]
    jnet = _jax_net()
    tnet = _port_net(jnet)
    ids, labels = _batch()
    jstep = jparallel.TrainStep(jnet, JaxCELoss(), make_jax_opt(),
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


def test_trainer_dropout_matches_jax():
    """``mx.random.seed(s)`` + ``autograd.record`` + ``Trainer.step`` against
    ``random.seed(s)`` + ``backward`` + ``Trainer.step``: the eager path
    splits the global key once per site in both; losses to 1e-5 relative,
    parameters to 2 lr per step, Adam's moments to ADAM_STATE_TOL."""
    jnet = _jax_net()
    tnet = _port_net(jnet).train()
    ids, labels = _batch(2)
    jtr = JaxTrainer(jnet.collect_params(), "adam", {"learning_rate": 1e-3})
    ttr = Trainer(dict(tnet.named_parameters()), "adam", {"learning_rate": 1e-3})
    jloss_fn, tloss_fn = JaxCELoss(), SoftmaxCrossEntropyLoss()
    x, y = torch.from_numpy(ids), torch.from_numpy(labels)
    mx.random.seed(21)
    random.seed(21)
    for _ in range(STEPS):
        with jautograd.record():
            jl = jloss_fn(jnet(mnp.array(ids)), mnp.array(labels))
        jl.backward()
        jtr.step(B)
        tl = tloss_fn(tnet(x), y)
        tl.backward(torch.ones_like(tl))
        ttr.step(B)
        want = jl.asnumpy()
        assert onp.abs(tl.detach().numpy() - want).max() <= 1e-5 * onp.abs(want).max()
    assert _random.get_state() == jrandom.get_state()
    assert _max_param_diff(jnet, tnet) <= 2 * 1e-3 * STEPS
    err = _adam_state_err({n: [s.asnumpy() if hasattr(s, "asnumpy") else s for s in st]
                           for n, st in zip(jtr._param_names, jtr._states)},
                          {ttr._params[i][0]: st for i, st in ttr._states.items()})
    assert err <= ADAM_STATE_TOL


def test_inference_after_training_has_no_dropout():
    """After TrainStep leaves the model in training mode, ``generate()``
    (cached and cache-free) and a serving engine give the JAX package's
    greedy tokens on the trained weights, and repeat them: no dropout."""
    jnet = _jax_net()
    tnet = _port_net(jnet)
    ids, labels = _batch(7)
    step = parallel.TrainStep(tnet, SoftmaxCrossEntropyLoss(),
                              optimizer.Adam(learning_rate=1e-2), example_inputs=[ids])
    step.run(ids, labels, 2)
    assert tnet.training
    trained = params_to_numpy(tnet)
    for n, p in jnet.collect_params().items():
        p.set_data(mnp.array(trained[n]))
    prompts = ids[:, :6]
    want = jax_generate(jnet, mnp.array(prompts), 8).asnumpy()
    for use_cache in (True, False):
        for _ in range(2):
            assert (generate(tnet, prompts, 8, use_cache=use_cache).numpy() == want).all()
    eng = InferenceEngine(tnet, max_batch_size=2, max_len=32).start()
    try:
        res = [eng.submit(p, 8).result(timeout=120) for p in prompts]
    finally:
        eng.shutdown(drain=True, timeout=120)
    for r, row in zip(res, want):
        assert r.status == "ok", r.error
        assert r.generated_ids == row[6:].tolist()
    assert tnet.training


@pytest.mark.parametrize("temperature,top_k", [(0.0, 0), (0.8, 5)])
def test_generate_without_cache_matches_jax(temperature, top_k):
    """``generate(use_cache=False)`` recomputes the full forward per token:
    its tokens equal the JAX package's cache-free decode, greedy and
    sampled (one key split per token), and equal the cached decode;
    ``multi_token > 1`` without the cache raises, as in JAX."""
    from mxnet_tpu_torch.base import MXNetError
    jnet = _jax_net()
    tnet = _port_net(jnet).train()
    prompts = _batch(8)[0][:, :5]
    kw = dict(temperature=temperature, top_k=top_k, seed=3)
    want = jax_generate(jnet, mnp.array(prompts), 9, use_cache=False, **kw).asnumpy()
    got = generate(tnet, prompts, 9, use_cache=False, **kw).numpy()
    assert (got == want).all()
    assert (generate(tnet, prompts, 9, **kw).numpy() == got).all()
    with pytest.raises(MXNetError, match="requires KV-cache decode"):
        generate(tnet, prompts, 9, use_cache=False, multi_token=2)
