"""Port parity of ``flash_attention_bthd`` (``mxnet_tpu_torch/ops/attention.py``)
against the JAX package's ``flash_attention_bthd`` on the CPU, on every
route, f32 and bf16, causal and not, forward and gradients (``jax.vjp``
against ``torch.autograd``), with the same numpy inputs on both sides:

- the kernel route (no mask, no dropout, T and S >= 256), where the port's
  plain K1 and K2 run once each way and the JAX package, off the TPU, takes
  its einsum route;
- the einsum route (T * S <= 262144) with a key padding mask, a fully
  masked row giving 0, and with dropout, whose keep multipliers equal the
  JAX package's bit for bit;
- the chunked route at T 640 with a key mask and dropout, whose per-chunk
  keep bits equal the JAX package's bit for bit.

Tolerances: f32 within 2e-5 of max(1, max |JAX|); bf16 within 2e-2 of
max(1, max |JAX|) with every row (a head-dim vector) within ROW_TOL of its
own size (``chip_smoke.flash_errors``): 1e-2 (``chip_smoke``'s flash rule)
where both packages take the same route, 2e-2 on the kernel route, whose
plain K2 rounds p and ds to bf16 where JAX's einsum route does not (the
worst row read 1.04e-2, a causal dq).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import chip_smoke
from mxnet_tpu_torch.ops import attention as ta
from mxnet_tpu_torch.ops.int8_gemv import count_launches

ja = importlib.import_module("mxnet_tpu.ops.attention")
jnx = importlib.import_module("mxnet_tpu.numpy_extension")

F32_TOL, BF16_TOL = 2e-5, 2e-2
ROW_TOL, KERNEL_ROUTE_ROW_TOL = 1e-2, 2e-2
RATE = 0.25
DTYPES = [torch.float32, torch.bfloat16]


def _inputs(B, T, S, H, D, seed):
    rng = onp.random.RandomState(seed)
    q, do = (rng.randn(B, T, H, D).astype("float32") for _ in range(2))
    k, v = (rng.randn(B, S, H, D).astype("float32") for _ in range(2))
    return q, k, v, do


def _pair(a, dtype):
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(dtype)


def _f32(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return onp.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, dtype, row_tol=ROW_TOL):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    if dtype == torch.float32:
        return onp.abs(got - want).max() <= F32_TOL * max(1.0, onp.abs(want).max())
    # rows along the head dim, as chip_smoke holds K1/K2
    err, size, row = chip_smoke.flash_errors(torch.tensor(got), torch.tensor(want))
    return err <= BF16_TOL * size and row <= row_tol


def _keys(seed):
    """A JAX key and the same key's words as the port's key tensor."""
    jkey = jax.random.fold_in(jax.random.key(seed), 3)
    words = onp.asarray(jax.random.key_data(jkey)).astype(onp.int64)
    return jkey, torch.from_numpy(words)


def _both(q, k, v, do, dtype, causal, key_mask=None, drop_seed=None):
    """Forward and gradients of both packages: ((o, dq, dk, dv) JAX,
    (o, dq, dk, dv) port, the port's launches)."""
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = (_pair(a, dtype) for a in (q, k, v, do))
    jmask = tmask = jdrop = tdrop = None
    if key_mask is not None:
        jmask, tmask = jnp.asarray(key_mask), torch.from_numpy(key_mask)
    if drop_seed is not None:
        jkey, tkey = _keys(drop_seed)
        jdrop, tdrop = (jkey, RATE), (tkey, RATE)
    jo, vjp = jax.vjp(lambda a, b, c: ja.flash_attention_bthd(
        a, b, c, causal, key_mask=jmask, dropout=jdrop), jq, jk, jv)
    jgrads = vjp(jdo)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    with count_launches() as tally:
        to = ta.flash_attention_bthd(*leaves, causal, key_mask=tmask, dropout=tdrop)
        to.backward(tdo)
    assert to.dtype == dtype and all(t.grad.dtype == dtype for t in leaves)
    return (jo, *jgrads), (to, *(t.grad for t in leaves)), dict(tally)


def _check(j, t, dtype, row_tol=ROW_TOL):
    for name, a, b in zip(("o", "dq", "dk", "dv"), t, j):
        assert _close(a, b, dtype, row_tol), name


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [False, True])
def test_kernel_route(dtype, causal):
    """No mask and no dropout at T = S = 256: one K1 and one K2 launch (the
    plain versions on the CPU), the JAX package's einsum route's values."""
    q, k, v, do = _inputs(1, 256, 256, 2, 16, seed=1)
    j, t, tally = _both(q, k, v, do, dtype, causal)
    assert tally == {"flash_fwd": 1, "flash_bwd": 1}
    _check(j, t, dtype, KERNEL_ROUTE_ROW_TOL)


def _padding_mask(B, S, valid):
    mask = onp.zeros((B, S), "float32")
    for b, n in enumerate(valid):
        mask[b, :n] = 1.0
    return mask


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [False, True])
def test_einsum_route_key_mask(dtype, causal):
    """A right-padded key mask at T = S = 48 (and at T = S = 256, which
    the mask alone keeps off the kernels): no launch; batch row 2 has no
    valid key and gives 0."""
    for T in (48, 256):
        q, k, v, do = _inputs(3, T, T, 2, 16, seed=T)
        mask = _padding_mask(3, T, (T, T // 3, 0))
        j, t, tally = _both(q, k, v, do, dtype, causal, key_mask=mask)
        assert tally == {}
        _check(j, t, dtype)
        assert not _f32(t[0])[2].any()


@pytest.mark.parametrize("dtype", DTYPES)
def test_einsum_route_causal_more_queries_than_keys(dtype):
    """Causal at T 40 > S 24, end-aligned, with a key mask: the first 16
    query rows see no key and are 0, the rest the JAX package's values."""
    q, k, v, do = _inputs(2, 40, 24, 2, 16, seed=8)
    mask = _padding_mask(2, 24, (24, 20))
    j, t, tally = _both(q, k, v, do, dtype, True, key_mask=mask)
    assert tally == {}
    _check(j, t, dtype)
    assert not _f32(t[0])[:, :16].any()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [False, True])
def test_einsum_route_dropout(dtype, causal):
    """Attention dropout at rate 0.25 with and without a key mask: the
    outputs and gradients of the JAX package's masks."""
    q, k, v, do = _inputs(2, 40, 40, 3, 16, seed=5)
    for mask in (None, _padding_mask(2, 40, (40, 17))):
        j, t, tally = _both(q, k, v, do, dtype, causal, key_mask=mask, drop_seed=11)
        assert tally == {}
        _check(j, t, dtype)


@pytest.mark.parametrize("layout", ["bhtd", "bthd"])
def test_xla_attention_both_layouts(layout):
    """``_xla_attention`` in either layout, with a key mask and dropout, in
    bf16: the JAX package's values."""
    q, k, v, _ = _inputs(2, 40, 40, 3, 16, seed=6)
    if layout == "bhtd":
        q, k, v = (a.transpose(0, 2, 1, 3).copy() for a in (q, k, v))
    mask = _padding_mask(2, 40, (40, 11))
    jkey, tkey = _keys(4)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, torch.bfloat16) for a in (q, k, v))
    want = ja._xla_attention(jq, jk, jv, False, 0.25, layout=layout,
                             key_mask=jnp.asarray(mask), dropout=(jkey, RATE))
    got = ta._xla_attention(tq, tk, tv, False, 0.25, layout=layout,
                            key_mask=torch.from_numpy(mask), dropout=(tkey, RATE))
    assert got.dtype == torch.bfloat16
    assert _close(got, want, torch.bfloat16)


def test_einsum_route_keep_multiplier_bits():
    """``_dropout_keep`` equals the JAX package's bit for bit over (B, H,
    T, S) = (2, 3, 40, 56). JAX's is a weakly typed f64 array under x64,
    which the product with the f32 probabilities casts to f32 first."""
    shape = (2, 3, 40, 56)
    for seed in (0, 7, 123):
        jkey, tkey = _keys(seed)
        want = onp.asarray(ja._dropout_keep(jkey, shape, RATE)).astype(onp.float32)
        got = ta._dropout_keep(tkey, shape, RATE, "cpu").numpy()
        assert got.dtype == onp.float32
        assert onp.array_equal(got.view(onp.uint32), want.view(onp.uint32))
        assert 0.6 < (got > 0).mean() < 0.9


def test_chunked_route_keep_bits():
    """The chunked route's keep bits of every 512-key chunk at (B, H, T)
    = (2, 3, 640), S 640, equal the JAX package's draw
    (``_keep_bits_at(key, spos, 1 - rate, idx_hi=bht)``)."""
    B, H, T, S, bs = 2, 3, 640, 640, 512
    jkey, tkey = _keys(5)
    ii = jax.lax.broadcasted_iota
    for j in range(-(-S // bs)):
        shape = (B, H, T, bs)
        bht = (ii(jnp.int32, shape, 0) * H + ii(jnp.int32, shape, 1)) * T \
            + ii(jnp.int32, shape, 2)
        spos = j * bs + ii(jnp.int32, shape, 3)
        want = onp.asarray(jnx._keep_bits_at(jkey, spos, 1.0 - RATE, idx_hi=bht))
        n = min(bs, S - j * bs)
        got = ta._chunk_keep(tkey, RATE, B, H, T, j * bs, n, "cpu").numpy()
        assert onp.array_equal(got, want[..., :n])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [False, True])
def test_chunked_route(dtype, causal):
    """T = S = 640 (past the einsum route's 262144 scores) with a
    right-padded key mask (one row fully masked) and dropout, and with
    neither (then K1/K2 carry it): the chunked route's values and
    gradients."""
    q, k, v, do = _inputs(2, 640, 640, 2, 16, seed=2)
    mask = _padding_mask(2, 640, (600, 0))
    j, t, tally = _both(q, k, v, do, dtype, causal, key_mask=mask, drop_seed=9)
    assert tally == {}
    _check(j, t, dtype)
    assert not _f32(t[0])[1].any()


def test_key_mask_all_ones_is_unmasked():
    """An all-ones mask keeps every key: the einsum route's values equal
    the unmasked call's (kernel route) within f32 rounding."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(2, 256, 256, 2, 16, seed=4))
    ones = torch.ones(2, 256)
    with count_launches() as tally:
        plain = ta.flash_attention_bthd(q, k, v)
    masked = ta.flash_attention_bthd(q, k, v, key_mask=ones)
    assert tally == {"flash_fwd": 1}
    assert (plain - masked).abs().max() <= F32_TOL
