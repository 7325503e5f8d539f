"""Port parity of flash attention (``mxnet_tpu_torch/ops/attention.py``):
the plain versions of K1 and K2 against the JAX package's real Pallas
kernels ``_pallas_forward(with_lse=True)`` and ``_pallas_backward``, run in
interpret mode on the CPU, and ``flash_attention``'s routing and gradient
against ``jax.vjp`` of the JAX ``flash_attention``. Same numpy inputs on
both sides."""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import chip_smoke
from mxnet_tpu_torch.ops import attention as ta
from mxnet_tpu_torch.ops.int8_gemv import count_launches

# the module, not the function ``attention`` that shadows it in ops/__init__
ja = importlib.import_module("mxnet_tpu.ops.attention")

# (T, S, D, causal): ragged causal, end-aligned causal, padded head dim
_KERNEL_CASES = [(300, 300, 64, True), (256, 512, 64, True), (384, 384, 40, False)]


@pytest.fixture
def interpret(monkeypatch):
    """Run the Pallas kernels in interpret mode for this test only."""
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _inputs(T, S, D, seed, B=1, H=2):
    rng = onp.random.RandomState(seed)
    q, do = (rng.randn(B, H, T, D).astype("float32") for _ in range(2))
    k, v = (rng.randn(B, H, S, D).astype("float32") for _ in range(2))
    return q, k, v, do


def _pair(a, dtype):
    """The same numpy array as a JAX array and a torch tensor of ``dtype``."""
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(dtype)


def _f32(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return onp.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, dtype):
    """f32: 1e-5 abs; bf16: ``chip_smoke``'s rule (2e-2 of max(1,
    |want|max), and every row within 1e-2 of its own size)."""
    got, want = _f32(got), _f32(want)
    if dtype == torch.float32:
        return onp.abs(got - want).max() <= 1e-5
    return chip_smoke.flash_within(torch.tensor(got), torch.tensor(want), "bfloat16")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,S,D,causal", _KERNEL_CASES)
def test_plain_k1_k2_match_pallas_kernels(interpret, T, S, D, causal, dtype):
    """o and lse of ``_reference_flash_forward`` against the interpret-mode
    K1, and dq, dk, dv of ``_reference_flash_backward`` against the
    interpret-mode K2 (fed the JAX forward's own o and lse on both
    sides)."""
    q, k, v, do = _inputs(T, S, D, seed=T + D)
    scale = D ** -0.5
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = (_pair(a, dtype) for a in (q, k, v, do))
    jo, jlse = ja._pallas_forward(jq, jk, jv, causal, scale, with_lse=True)
    to, tlse = ta._reference_flash_forward(tq, tk, tv, causal, scale)
    assert to.dtype == dtype and tlse.dtype == torch.float32
    assert _close(to, jo, dtype)
    assert _close(tlse, jlse[:, :, :T, 0], dtype)
    jd = ja._pallas_backward(jq, jk, jv, jo, jlse, jdo, causal, scale)
    o_same = torch.from_numpy(onp.array(_f32(jo))).to(dtype)
    lse_same = torch.from_numpy(onp.asarray(jlse)[:, :, :T, 0].copy())
    td = ta._reference_flash_backward(tq, tk, tv, o_same, lse_same, tdo, causal, scale)
    for name, got, want in zip(("dq", "dk", "dv"), td, jd):
        assert got.dtype == dtype, name
        assert _close(got, want, dtype), name


@pytest.mark.parametrize("T,S,D,causal,kernel", [
    (256, 256, 64, True, True),       # eligible: K1/K2 route
    (300, 256, 64, False, True),      # T > S, not causal: eligible
    (300, 256, 64, True, False),      # causal T > S: plain route, empty rows 0
    (64, 64, 32, True, False),        # short: plain route
    (520, 520, 272, False, False),    # D > 256 and T*S past the plain cap: chunked
])
def test_flash_attention_routing_and_gradient(T, S, D, causal, kernel):
    """``flash_attention`` takes the ``autograd.Function`` exactly where the
    JAX package takes its kernels, and its output and gradients agree with
    ``jax.vjp`` of the JAX ``flash_attention`` (its CPU route) to f32
    rounding."""
    q, k, v, do = _inputs(T, S, D, seed=7, H=1)
    out, vjp = jax.vjp(lambda a, b, c: ja.flash_attention(a, b, c, causal, None),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    assert ta._use_kernel(leaves[0], leaves[1], causal) == kernel
    with count_launches() as tally:
        got = ta.flash_attention(*leaves, causal=causal)
        got.backward(torch.from_numpy(do))
    assert tally == ({"flash_fwd": 1, "flash_bwd": 1} if kernel else {})
    tol = 2e-5 * max(1.0, float(onp.abs(onp.asarray(out)).max()))
    assert onp.abs(got.detach().numpy() - onp.asarray(out)).max() <= tol
    for leaf, g in zip(leaves, want):
        g = onp.asarray(g)
        assert onp.abs(leaf.grad.numpy() - g).max() <= 2e-5 * max(1.0, onp.abs(g).max())


def test_pad_head_dim_matches_jax():
    for d in (1, 40, 64, 65, 128, 129, 256):
        assert ta._pad_head_dim(d) == ja._pad_head_dim(d)


def test_bf16_flash_check_passes_rounding_and_fails_planted_faults():
    """``chip_smoke``'s K1/K2 check in bf16 (max abs error and per-row
    error): the plain versions run on bf16 tensors, which round p, ds and
    the outputs where the kernels do, pass it against the plain versions in
    f32 on the same inputs; K1 skipping a key tile, K2's dk/dv skipping
    the last query tile and K2 leaving the scale out of ds each fail it
    (``planted_faults`` raises otherwise)."""
    T = S = 512
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _inputs(T, S, 64, seed=11, H=4))
    scale = 0.125
    o, lse = ta._reference_flash_forward(q, k, v, True, scale)
    got = dict(zip(("dq", "dk", "dv"),
                   ta._reference_flash_backward(q, k, v, o, lse, do, True, scale)))
    got.update(o=o, lse=lse)
    f = [t.float() for t in (q, k, v, do)]
    po, plse = ta._reference_flash_forward(f[0], f[1], f[2], True, scale)
    want = dict(zip(("dq", "dk", "dv"), ta._reference_flash_backward(
        f[0], f[1], f[2], o.float(), lse, f[3], True, scale)))
    want.update(o=po, lse=plse)
    for name in want:
        assert chip_smoke.flash_within(got[name], want[name], "bfloat16"), name
    rows = chip_smoke.planted_faults(torch, ta, f, o, lse, True, scale, want, torch.bfloat16)
    assert set(rows) == {"k1_key_tile_skipped", "k2_last_query_tile_skipped",
                         "k2_ds_unscaled"}
    assert all(r > 1e-2 for fault in rows.values() for r in fault["row_err"].values())
