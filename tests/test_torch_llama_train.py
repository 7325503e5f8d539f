"""Port parity of Llama training on the CPU: the port's ``LlamaMoE`` and
``parallel.TrainStep`` over dense (per-layer and stacked) and MoE Llamas
against the JAX package's, at tiny sizes in f32, weights copied with
``interop.params_from_numpy``.

Covered: the MoE layer's routing (every (token, choice) pair's expert and
slot, read from the JAX package's own dispatch tensor), outputs and
gradients, with and without capacity drops; three Adam steps of
``TrainStep`` on both packages at T 256 (the port's attention takes the
``_FlashAttention`` route with K1's and K2's plain versions) and T 16 (the
plain fallback); ``remat=True`` bit for bit against ``remat=False``; a
sharded ``CheckpointManager`` checkpoint of the MoE model written by either
package and continued by the other; and that importing the port brings in
neither jax nor the JAX package. The kernels on this path are held against
these plain versions on the card in ``tests/test_torch_cuda_kernels.py``."""
import subprocess
import sys

import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import chip_smoke
import mxnet_tpu as mx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import np as mnp
from mxnet_tpu import parallel as jparallel
from mxnet_tpu.checkpoint import CheckpointManager as JaxCheckpointManager
from mxnet_tpu.gluon.loss import SoftmaxCrossEntropyLoss as JaxCELoss
from mxnet_tpu.models import llama as JL

from mxnet_tpu_torch import optimizer, parallel
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.checkpoint import CheckpointManager
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.interop import params_from_numpy, params_to_numpy
from mxnet_tpu_torch.models import llama as TL
from mxnet_tpu_torch.ops.int8_gemv import count_launches

TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
            num_heads=4, num_kv_heads=2)
MOE = dict(TINY, num_experts=4, num_experts_per_tok=2, moe_every=2)
B, STEPS, LR = 2, 3, 1e-3
# f32 logits and gradients, relative to each tensor's largest magnitude
FWD_TOL, GRAD_TOL = 1e-5, 1e-4
# Adam moves an element by about lr whatever its gradient's size, so a
# near-zero gradient whose sign differs between the packages moves it by up
# to 2 lr a step; the moments carry the gradients' magnitudes (relative L2,
# the bound tests/test_torch_gpt_train.py holds GPT's to)
PARAM_TOL, ADAM_STATE_TOL = 2 * LR * STEPS, 3e-5


def _pair(cfg, seed=1):
    """A JAX Llama and the port's (CPU, f32) with the same seeded weights:
    N(0, 0.1) matrices, gains 1 + N(0, 0.1)."""
    mx.random.seed(0)
    jnet = JL.LlamaForCausalLM(JL.LlamaConfig(dtype=onp.float32, **cfg))
    jnet.initialize()
    jnet(mnp.array(onp.zeros((1, 4), "int32")))
    rng = onp.random.RandomState(seed)
    for name, p in jnet.collect_params().items():
        base = 1.0 if name.endswith(("gamma", ".ln1", ".ln2")) else 0.0
        p.set_data(mnp.array((base + 0.1 * rng.randn(*p.shape)).astype("float32")))
    named = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    tnet = TL.LlamaForCausalLM(TL.LlamaConfig(dtype=torch.float32, **cfg), device="cpu")
    return jnet, params_from_numpy(tnet, named)


def _batch(T, seed=0, vocab=256):
    rng = onp.random.RandomState(seed)
    return (rng.randint(0, vocab, (B, T)).astype("int32"),
            rng.randint(0, vocab, (B, T)).astype("int32"))


def _close(got, want, tol, what=""):
    got, want = onp.asarray(got, onp.float32), onp.asarray(want, onp.float32)
    assert got.shape == want.shape, what
    err = float(onp.abs(got - want).max())
    assert err <= tol * max(float(onp.abs(want).max()), 1e-30), (what, err)


class _DispatchTap:
    """Reads the JAX package's dispatch tensors: the ``jnp`` that
    ``mxnet_tpu.models.llama`` calls, with every ``einsum("nec,nd->ecd")``
    (the expert gather, whose first operand is the dispatch tensor)
    recorded on the way."""

    def __init__(self):
        self.dispatch = []

    def __getattr__(self, name):
        return getattr(jnp, name)

    def einsum(self, spec, *ops, **kw):
        if spec == "nec,nd->ecd":
            self.dispatch.append(onp.asarray(ops[0]))
        return jnp.einsum(spec, *ops, **kw)


def _jax_dispatch(monkeypatch, fn):
    tap = _DispatchTap()
    monkeypatch.setattr(JL, "jnp", tap)
    out = fn()
    monkeypatch.setattr(JL, "jnp", jnp)
    return out, tap.dispatch


def _port_routes(tnet, fn):
    """fn's result and each MoE layer's ``moe_route`` of its router logits
    (``chip_smoke.moe_routes``)."""
    out, routes = chip_smoke.moe_routes(torch, tnet, fn)
    return out, [r for _, r in routes]


def _pairs(dispatch):
    """{(token, expert, slot)} of a dispatch tensor's ones."""
    return {tuple(int(v) for v in ix) for ix in zip(*onp.nonzero(dispatch))}


def _assert_routing(routes, jax_dispatch):
    """The port's routing equals JAX's: every kept (token, expert, slot)
    pair the same, before any value is compared."""
    assert len(routes) == len(jax_dispatch)
    for i, ((disp, _, idx, slot, keep), want) in enumerate(zip(routes, jax_dispatch)):
        kept = {(n, int(idx[j, n]), int(slot[j, n]))
                for j in range(idx.shape[0]) for n in range(idx.shape[1]) if keep[j, n]}
        jax_pairs = _pairs(want)
        assert kept == jax_pairs, (
            f"MoE layer {i}: routing differs from the JAX package's: port-only "
            f"{sorted(kept - jax_pairs)[:5]}, JAX-only {sorted(jax_pairs - kept)[:5]}")
        assert (disp.numpy() == want).all(), f"MoE layer {i}: dispatch tensors differ"


# ------------------------------------------------------------------ LlamaMoE

@pytest.mark.parametrize("moe_every", [1, 2])
@pytest.mark.parametrize("factor", [1.25, 0.5])
@pytest.mark.parametrize("k", [1, 2])
def test_moe_matches_jax(monkeypatch, k, factor, moe_every):
    """A 2-layer MoE Llama (``moe_every`` 1: both layers MoE; 2: layer 0):
    routing equal to JAX's (asserted first), then the logits and the
    gradient of their sum w.r.t. every parameter, router included, against
    JAX's ``autograd.record`` + ``backward``. At capacity factor 0.5 pairs
    are dropped, and a token whose every pair is dropped gets 0 from the
    MoE layer, as in JAX."""
    cfg = dict(MOE, num_experts_per_tok=k, moe_capacity_factor=factor, moe_every=moe_every)
    jnet, tnet = _pair(cfg)
    ids, _ = _batch(16, seed=k)
    want, jax_disp = _jax_dispatch(monkeypatch, lambda: jnet(mnp.array(ids)).asnumpy())
    got, routes = _port_routes(tnet, lambda: tnet(torch.from_numpy(ids)))
    assert len(routes) == (2 if moe_every == 1 else 1)
    _assert_routing(routes, jax_disp)
    dropped = sum(int((~r[4]).sum()) for r in routes)
    assert dropped > 0 or factor > 1, dropped
    _close(got.detach().numpy(), want, FWD_TOL, "logits")

    params = jnet.collect_params()
    for p in params.values():
        p.grad_req = "write"
    with jautograd.record():
        jout = jnet(mnp.array(ids))
    jout.backward()
    got.sum().backward()
    grads = {n: (p.grad.numpy(), params[n].grad().asnumpy()) for n, p in tnet.named_parameters()}
    scale = max(float(onp.abs(w).max()) for _, w in grads.values())
    for name, (g, w) in grads.items():
        if k == 1 and name.endswith("router.weight"):
            # one choice: the combine weight is gate / gate = 1, so the
            # router's gradient is 0 up to rounding in both packages
            assert max(onp.abs(g).max(), onp.abs(w).max()) <= 1e-4 * scale, name
            continue
        _close(g, w, GRAD_TOL, name)
    if k > 1:
        assert tnet.model.layers[0].mlp.router.weight.grad.abs().max() > 1e-3 * scale

    # one MoE layer on its own: the output rows of tokens with every pair
    # dropped are exactly 0 in both packages
    x = onp.random.RandomState(7).randn(B, 16, cfg["hidden_size"]).astype("float32")
    jy = jnet.model.layers[0].mlp(mnp.array(x)).asnumpy()
    ty, (route,) = _port_routes(tnet, lambda: tnet.model.layers[0].mlp(torch.from_numpy(x)))
    _close(ty.detach().numpy(), jy, FWD_TOL, "moe layer")
    none_kept = (~route[4]).all(dim=0).numpy()
    if factor < 1:
        assert none_kept.any()
    rows = ty.detach().reshape(-1, cfg["hidden_size"]).numpy()
    assert (rows[none_kept] == 0).all() and (jy.reshape(rows.shape)[none_kept] == 0).all()
    assert (onp.abs(rows[~none_kept]).max(axis=1) > 0).all()


def test_moe_layers_and_refusals():
    """``LlamaDecoderLayer`` builds an MoE on ``layer_idx % moe_every ==
    0``; rank-3 expert weights in JAX's layout and names; the stacked
    decoder and the KV-cache specs refuse MoE with JAX's words."""
    _, tnet = _pair(dict(MOE, num_layers=4, moe_every=2))
    kinds = [type(layer.mlp).__name__ for layer in tnet.model.layers]
    assert kinds == ["LlamaMoE", "LlamaMLP", "LlamaMoE", "LlamaMLP"]
    named = params_to_numpy(tnet)
    E, d, f = 4, 64, 128
    assert named["model.layers.2.mlp.w_gate"].shape == (E, d, f)
    assert named["model.layers.2.mlp.w_up"].shape == (E, d, f)
    assert named["model.layers.2.mlp.w_down"].shape == (E, f, d)
    assert named["model.layers.2.mlp.router.weight"].shape == (E, d)
    with pytest.raises(MXNetError, match="does not support MoE"):
        TL.LlamaForCausalLM(TL.LlamaConfig(dtype=torch.float32, stacked=True, **MOE),
                            device="cpu")
    for call in (lambda: tnet.cache_spec(1, 8), lambda: tnet.cache_spec_paged(4, 8)):
        with pytest.raises(MXNetError, match="not supported for MoE"):
            call()


# ------------------------------------------------------------------ TrainStep

_KINDS = {"dense": TINY, "stacked": dict(TINY, stacked=True), "moe": MOE}


@pytest.mark.parametrize("T", [256, 16], ids=["T256_flash", "T16_fallback"])
@pytest.mark.parametrize("kind", sorted(_KINDS))
def test_train_step_matches_jax(kind, T):
    """3 Adam steps of ``TrainStep`` without a mesh on both packages: losses
    to 1e-5 relative, parameters to 2 lr a step, Adam's moments leaf by
    leaf to ADAM_STATE_TOL relative. At T 256 each step runs every
    layer's attention through K1's and K2's plain versions once (counted);
    at T 16 through the fallback, which counts none."""
    jnet, tnet = _pair(_KINDS[kind])
    ids, labels = _batch(T, seed=T)
    jstep = jparallel.TrainStep(jnet, JaxCELoss(axis=-1), mx.optimizer.Adam(learning_rate=LR),
                                [mnp.array(ids)])
    tstep = parallel.TrainStep(tnet, SoftmaxCrossEntropyLoss(axis=-1),
                               optimizer.Adam(learning_rate=LR), [ids])
    layers = TINY["num_layers"] if T >= 256 else 0
    for _ in range(STEPS):
        want = float(jstep(mnp.array(ids), mnp.array(labels)).item())
        with count_launches() as tally:
            got = float(tstep(ids, labels))
        assert abs(got - want) <= 1e-5 * abs(want), (got, want)
        assert tally.get("flash_fwd", 0) == tally.get("flash_bwd", 0) == layers
    got = params_to_numpy(tnet)
    for (name, p), st in zip(jstep.model.param_items, jstep._opt_states):
        w = onp.asarray(p.data().asnumpy(), "float32")
        assert onp.abs(got[name] - w).max() <= PARAM_TOL, name
    for (name, _), js, ts in zip(jstep.model.param_items, jstep._opt_states, tstep._states):
        for a, b in zip(ts, js):
            b = onp.asarray(b, "float32")
            err = onp.linalg.norm(a.numpy() - b) / max(float(onp.linalg.norm(b)), 1e-30)
            assert err <= ADAM_STATE_TOL, name


@pytest.mark.parametrize("T", [256, 16], ids=["T256_flash", "T16_fallback"])
@pytest.mark.parametrize("kind", sorted(_KINDS))
def test_remat_is_bitwise_plain(kind, T):
    """``remat=True`` recomputes the forward in the backward: 3 Adam steps
    give ``remat=False``'s losses, parameters and Adam states bit for bit;
    at T 256 the recompute launches K1's plain version again per layer."""
    _, a = _pair(_KINDS[kind])
    _, b = _pair(_KINDS[kind])
    ids, labels = _batch(T, seed=3)
    plain = parallel.TrainStep(a, SoftmaxCrossEntropyLoss(), optimizer.Adam(learning_rate=LR),
                               [ids])
    remat = parallel.TrainStep(b, SoftmaxCrossEntropyLoss(), optimizer.Adam(learning_rate=LR),
                               [ids], remat=True)
    layers = TINY["num_layers"] if T >= 256 else 0
    for _ in range(STEPS):
        want = plain(ids, labels)
        with count_launches() as tally:
            got = remat(ids, labels)
        assert torch.equal(got, want)
        assert tally.get("flash_fwd", 0) == 2 * layers
        assert tally.get("flash_bwd", 0) == layers
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n
    for s, r in zip(plain._states, remat._states):
        assert all(torch.equal(x, y) for x, y in zip(s, r))


def test_trained_model_serves_without_quantized_head_in_training():
    """A tied model with a quantized head differentiates the float table
    while autograd records a training forward, and serves through the
    table under ``no_grad`` (every serving path), under ``predict_mode``
    and in eval mode, train mode or not."""
    from mxnet_tpu_torch.autograd import predict_mode
    from mxnet_tpu_torch.contrib.quantization import _quantize_tied_lm_head
    _, tnet = _pair(dict(TINY, tie_embeddings=True))
    _quantize_tied_lm_head(tnet, 8)
    h = torch.randn(2, 3, TINY["hidden_size"], generator=torch.Generator().manual_seed(0))
    dense = h @ tnet.model.embed_tokens.weight.T
    tnet.train()
    with count_launches() as tally:
        assert torch.equal(tnet._logits(h), dense)
        with predict_mode():
            served = tnet._logits(h)
        with torch.no_grad():
            assert torch.equal(tnet._logits(h), served)
        tnet.eval()
        assert torch.equal(tnet._logits(h), served)
    assert tally.get("gemv", 0) == 3 and not torch.equal(served, dense)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_trained_then_quantized_tied_model_serves_as_jax(monkeypatch, paged):
    """A tied Llama trained 2 Adam steps through ``TrainStep`` (which
    leaves it in train mode), then ``quantize_net``: the engine's greedy
    tokens and ``generate``'s equal the JAX package's ``generate`` of the
    same trained weights quantized by its ``quantize_net``, and the
    engine's head reads the quantized table at every prefill and decode
    step (the JAX head always does)."""
    from mxnet_tpu.contrib.quantization import quantize_net as jax_quantize_net
    from mxnet_tpu.models import generate as jax_generate

    from mxnet_tpu_torch.contrib.quantization import quantize_net
    from mxnet_tpu_torch.models import generate
    from mxnet_tpu_torch.ops import int8_gemv
    from mxnet_tpu_torch.serve import InferenceEngine
    cfg = dict(TINY, tie_embeddings=True)
    jnet, tnet = _pair(cfg)
    ids, labels = _batch(16, seed=6)
    step = parallel.TrainStep(tnet, SoftmaxCrossEntropyLoss(axis=-1),
                              optimizer.Adam(learning_rate=LR), [ids])
    for _ in range(2):
        step(ids, labels)
    assert tnet.training
    trained = params_to_numpy(tnet)
    for name, p in jnet.collect_params().items():
        p.set_data(mnp.array(trained[name]))
    jax_quantize_net(jnet, calib_mode="none", bits=8)
    quantize_net(tnet, bits=8)
    prompts = [onp.array([5, 9, 1, 7], onp.int32), onp.array([200, 31, 17], onp.int32)]
    want = [list(jax_generate(jnet, mnp.array(p[None]), 6).asnumpy()[0][len(p):])
            for p in prompts]
    for p, w in zip(prompts, want):
        assert generate(tnet, p[None], 6)[0, len(p):].tolist() == w
    table, head_calls, real = tnet._q_lm_head[0], [], int8_gemv.weight_matmul

    def spy(x, w_q, scale):
        head_calls.append(w_q is table)
        return real(x, w_q, scale)
    monkeypatch.setattr(int8_gemv, "weight_matmul", spy)
    eng = InferenceEngine(tnet, max_batch_size=2, max_len=32, paged=paged, page_size=8).start()
    try:
        got = [eng.submit(p, 6).result(300) for p in prompts]
    finally:
        eng.shutdown()
    assert [r.generated_ids for r in got] == want
    # the first token from each prefill, then at least one decode step
    assert sum(head_calls) >= len(prompts) + 1, head_calls


# ------------------------------------------------------------- checkpoints

def _sharded(cls, d, net, step):
    return cls(str(d), net=net, sharded=True, state_arrays=step.state_arrays,
               write_state_arrays=step.write_state_arrays,
               extra_state=lambda: {"step": step._step},
               restore_extra=lambda e: setattr(step, "_step", e["step"]))


def _jax_moe_step(jnet, T):
    return jparallel.TrainStep(jnet, JaxCELoss(axis=-1), mx.optimizer.Adam(learning_rate=LR),
                               [mnp.array(onp.zeros((B, T), "int32"))])


def _port_moe_step(tnet):
    return parallel.TrainStep(tnet, SoftmaxCrossEntropyLoss(axis=-1),
                              optimizer.Adam(learning_rate=LR), [])


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_moe_checkpoint_continues_across_packages(tmp_path, direction):
    """The sharded layout the JAX package's Llama program writes for a
    one-device ``TrainStep`` (``sharded=True`` with ``state_arrays``; it
    needs no mesh): one package trains the MoE Llama 2 Adam steps and
    saves, the other restores into a fresh model and takes 2 more; its
    losses are the writer's steps 3 and 4 to 1e-5 relative, its parameters
    the writer's after 4 steps to 2 lr a step. The rank-3 expert weights
    and their Adam moments come back under JAX's names, with their
    shapes."""
    T = 16
    ids, labels = _batch(T, seed=5)
    jnet, tnet = _pair(MOE)
    jstep, tstep = _jax_moe_step(jnet, T), _port_moe_step(tnet)
    if direction == "jax_to_port":
        writer, reader = (jnet, jstep, JaxCheckpointManager), (tnet, tstep, CheckpointManager)

        def run_writer():
            return float(jstep(mnp.array(ids), mnp.array(labels)).item())

        def run_reader():
            return float(tstep(ids, labels))
    else:
        writer, reader = (tnet, tstep, CheckpointManager), (jnet, jstep, JaxCheckpointManager)

        def run_writer():
            return float(tstep(ids, labels))

        def run_reader():
            return float(jstep(mnp.array(ids), mnp.array(labels)).item())
    for _ in range(2):
        run_writer()
    _sharded(writer[2], tmp_path, writer[0], writer[1]).save(2)
    want = [run_writer() for _ in range(2)]
    after = (params_to_numpy(tnet) if writer[0] is tnet else
             {n: p.data().asnumpy() for n, p in jnet.collect_params().items()})
    # the reader starts from other weights, then restores
    fresh = _pair(MOE, seed=9)
    if direction == "jax_to_port":
        tnet, tstep = fresh[1], _port_moe_step(fresh[1])
        reader = (tnet, tstep, CheckpointManager)
    else:
        jnet, jstep = fresh[0], _jax_moe_step(fresh[0], T)
        reader = (jnet, jstep, JaxCheckpointManager)
    _sharded(reader[2], tmp_path, reader[0], reader[1]).restore()
    assert reader[1]._step == 2
    names = [n for n, _ in tstep._params] if direction == "jax_to_port" else \
        [n for n, _ in jstep.model.param_items]
    slot = names.index("model.layers.0.mlp.w_gate")
    arrays = reader[1].state_arrays()
    for i in (0, 1):             # Adam's m and v of the [E, d, f] weight
        assert tuple(arrays[f"opt{slot}.{i}"].shape) == (4, 64, 128)
    got = [run_reader() for _ in range(2)]
    assert all(abs(g - w) <= 1e-5 * abs(w) for g, w in zip(got, want)), (got, want)
    now = (params_to_numpy(tnet) if reader[0] is tnet else
           {n: p.data().asnumpy() for n, p in jnet.collect_params().items()})
    assert list(now) == list(after)
    for n in after:
        assert now[n].shape == after[n].shape
        assert onp.abs(now[n] - after[n]).max() <= PARAM_TOL, n


# ------------------------------------------------------------------ imports

def test_port_imports_neither_jax_nor_the_jax_package():
    """In a fresh interpreter, with any import of jax or mxnet_tpu refused,
    the port's package, its Llama module and its TrainStep import, and
    neither name is in ``sys.modules`` afterwards."""
    code = """
import importlib.abc, sys
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'mxnet_tpu'):
            raise ImportError('refused: ' + name)
        return None
before = set(sys.modules)
sys.meta_path.insert(0, Refuse())
import mxnet_tpu_torch, mxnet_tpu_torch.models.llama, mxnet_tpu_torch.parallel.train
new = set(sys.modules) - before
bad = sorted(m for m in new if m.split('.')[0] in ('jax', 'jaxlib', 'mxnet_tpu'))
print(bad, 'jax' in new, 'mxnet_tpu' in new)
"""
    import os
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=repo, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[0] == "[] False False", out.stdout
