"""Port parity of the grammar-mask path of sampling and of K8's mask and
bf16 lanes, on the CPU: ``generation.filter_logits`` / keyed
``sample_tokens`` with masks against the JAX package's, the plain K8
(``fused_lm_head_sample`` on CPU tensors) with a mask or bf16 h / bf16
logits against the TPU kernel ``_head_kernel`` in interpret mode, and the
filtered + masked branch against JAX's ``fused_lm_head_sample``.

Every input is made from a numpy seed and handed to both packages. Tokens
are compared exactly; the unfiltered fused head draws the TPU kernel's
hash-Gumbel stream, so its T > 0 rows are held against ``_head_kernel``
(interpret mode), never against JAX's off-TPU ``sample_tokens`` branch.
"""
import numpy as onp
import pytest
import torch

import chip_smoke
import jax
import jax.numpy as jnp
from mxnet_tpu.base import MXNetError as JaxMXNetError
from mxnet_tpu.models import generation as jgen
from mxnet_tpu.ops import fused_block_gemv as jfb

from mxnet_tpu_torch import _prng
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.contrib.quantization import _quantize_int4
from mxnet_tpu_torch.models import generation as gen
from mxnet_tpu_torch.ops import fused_block_gemv as fb
from mxnet_tpu_torch.ops.int8_gemv import count_launches, weight_matmul

D, VP, VOCAB = 256, 384, 379      # VOCAB pads to VP (3 lanes of 128)


def _table(bits, seed):
    """A vocab-padded head table as numpy: int8 [VP, D] + scales [VP], or
    the packed int4 table [VP, D/2] uint8 + block scales [VP, D/128]."""
    rng = onp.random.RandomState(seed)
    if bits == 8:
        w = rng.randint(-127, 128, (VP, D)).astype(onp.int8)
        s = (rng.rand(VP) * 0.02 + 1e-3).astype(onp.float32)
        return w, s
    w, s = _quantize_int4(torch.from_numpy(rng.randn(VP, D).astype(onp.float32)))
    return w.numpy(), s.numpy()


def _mask(rng, B, V, p=0.3):
    """bool [B, V]: each lane allowed with probability p, at least one lane
    a row."""
    m = rng.rand(B, V) < p
    m[onp.arange(B), rng.randint(0, V, B)] = True
    return m


def _keybits(B, seed):
    return gen._key_bits(onp.arange(B) + seed, onp.full(B, 3))


# ---------------------------------------------------------------------------
# filter_logits / sample_tokens with masks against the JAX package
# ---------------------------------------------------------------------------
_ROWS = [  # (temperature, top_k, top_p; None = a nucleus away from its edges)
    (0.0, 0, 1.0), (0.8, 0, 1.0), (0.8, 5, 1.0), (1.2, 0, None),
    (0.0, 3, None), (0.7, 40, None), (1.0, 1, 1.0), (0.8, 0, 1.0)]


def _masked_inputs(seed, V=300):
    """Logits, a mask, and per-row (temps, top_k, top_p): every nucleus lies
    halfway between two exclusive prefix sums, 1e-4 or more apart, of the
    row's masked, scaled, top-k-filtered probabilities
    (``chip_smoke.nucleus_away_from_edges``), where the two packages'
    cumsums cannot disagree."""
    rng = onp.random.RandomState(seed)
    logits = (rng.randn(len(_ROWS), V) * 3).astype(onp.float32)
    mask = _mask(rng, len(_ROWS), V, p=0.4)
    temps = onp.array([r[0] for r in _ROWS], onp.float32)
    topk = onp.array([r[1] for r in _ROWS], onp.int32)
    rows = [b for b, r in enumerate(_ROWS) if r[2] is None]
    masked = onp.where(mask, logits, -onp.inf).astype(onp.float32)
    topp = chip_smoke.nucleus_away_from_edges(onp, masked, temps, topk, rows)
    return logits, mask, temps, topk, topp


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_filter_logits_with_mask_equals_jax(seed):
    """Masked lanes drop to -inf before top-k and top-p, so the filters
    count the legal lanes only: the surviving lanes and their values equal
    JAX's exactly (tolerance 0)."""
    logits, mask, temps, topk, topp = _masked_inputs(seed)
    scaled = logits / onp.where(temps > 0, temps, 1.0)[:, None]
    want = onp.asarray(jgen.filter_logits(jnp.asarray(scaled), jnp.asarray(topk),
                                          jnp.asarray(topp), mask=jnp.asarray(mask)))
    got = gen.filter_logits(torch.from_numpy(scaled), topk, topp,
                            mask=torch.from_numpy(mask)).numpy()
    assert (onp.isfinite(want) == onp.isfinite(got)).all()
    assert (got[onp.isfinite(got)] == want[onp.isfinite(want)]).all()
    assert not onp.isfinite(got[~mask]).any()
    one = gen.filter_logits(torch.from_numpy(scaled[:1]), topk[:1], topp[:1],
                            mask=torch.from_numpy(mask[0]))          # a [V] mask
    assert torch.equal(one, torch.from_numpy(got[:1]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_tokens_with_mask_equals_jax(seed):
    """Keyed ``sample_tokens`` with a mask, greedy rows, T 0.8 rows, top-k
    and top-p rows: JAX's tokens for 20 counters, exactly; no token lands
    on a forbidden lane; greedy rows are the argmax of the masked logits."""
    logits, mask, temps, topk, topp = _masked_inputs(seed)
    seeds = onp.arange(len(temps), dtype=onp.uint32) * 17 + seed
    for c in range(20):
        counters = onp.full(len(temps), c, onp.int32)
        keys = jgen._fold_keys(jnp.asarray(seeds), jnp.asarray(counters))
        want = onp.asarray(jgen.sample_tokens(jnp.asarray(logits), keys, jnp.asarray(temps),
                                              jnp.asarray(topk), jnp.asarray(topp),
                                              mask=jnp.asarray(mask)))
        got = gen.sample_tokens(torch.from_numpy(logits), _prng.fold_keys(seeds, counters),
                                temps, topk, topp, mask=torch.from_numpy(mask)).numpy()
        assert (got == want).all(), c
        assert mask[onp.arange(len(got)), got].all()
        greedy = temps == 0
        assert (got[greedy] == onp.where(mask, logits, -onp.inf)[greedy].argmax(-1)).all()


def test_all_masked_row_raises_as_in_jax():
    """A row whose mask allows nothing raises in both packages, naming the
    row, in every masked entry point of the port."""
    rng = onp.random.RandomState(3)
    logits = rng.randn(3, 50).astype(onp.float32)
    mask = onp.ones((3, 50), bool)
    mask[1] = False
    with pytest.raises(JaxMXNetError, match=r"allows NO token for row\(s\) \[1\]"):
        jgen.sample_tokens(jnp.asarray(logits), None, jnp.zeros(3), 0, 1.0,
                           mask=jnp.asarray(mask))
    lt, mt = torch.from_numpy(logits), torch.from_numpy(mask)
    with pytest.raises(MXNetError, match=r"allows NO token for row\(s\) \[1\]"):
        gen.sample_tokens(lt, None, torch.zeros(3), mask=mt)
    with pytest.raises(MXNetError, match=r"allows NO token for row\(s\) \[1\]"):
        gen.filter_logits(lt, 0, 1.0, mask=mt)
    w, s = _table(8, 0)
    h = torch.from_numpy(rng.randn(3, D).astype(onp.float32))
    m = onp.ones((3, VOCAB), bool)
    m[2] = False
    with pytest.raises(MXNetError, match=r"allows NO token for row\(s\) \[2\]"):
        fb.fused_lm_head_sample(h, torch.from_numpy(w), torch.from_numpy(s), VOCAB,
                                torch.from_numpy(_keybits(3, 1)), torch.zeros(3),
                                mask=torch.from_numpy(m))


# ---------------------------------------------------------------------------
# the plain K8 with a mask / bf16 lanes against the TPU kernel (interpret)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("temp", [0.0, 0.8])
def test_plain_head_sampler_with_mask_matches_jax_kernel(bits, temp):
    """The plain K8 with a grammar mask against ``_head_kernel(mask=,
    interpret=True)`` given the same key bits: identical tokens (greedy and
    hash-Gumbel T = 0.8 rows), none on a forbidden or pad lane; greedy rows
    are the argmax of the masked head logits."""
    B = 6
    w, s = _table(bits, 10 + bits)
    rng = onp.random.RandomState(20 + bits)
    h = rng.randn(B, D).astype(onp.float32)
    mask = _mask(rng, B, VOCAB, p=0.2)
    mask_p = onp.zeros((B, VP), bool)
    mask_p[:, :VOCAB] = mask
    kb = _keybits(B, 40)
    temps = onp.full(B, temp, onp.float32)
    want = onp.asarray(jfb._head_kernel(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(s), VOCAB, jnp.asarray(temps),
        jnp.asarray(kb.astype(onp.uint32)), mask=jnp.asarray(mask_p), interpret=True))
    tw, ts = torch.from_numpy(w), torch.from_numpy(s)
    with count_launches() as tally:
        got = fb.fused_lm_head_sample(torch.from_numpy(h), tw, ts, VOCAB, torch.from_numpy(kb),
                                      torch.from_numpy(temps),
                                      mask=torch.from_numpy(mask)).numpy()
    assert tally == {"fused_head" + ("_int4" if bits == 4 else ""): 1}
    assert (got == want).all()
    assert mask[onp.arange(B), got].all() and (got < VOCAB).all()
    if temp == 0.0:
        logits = weight_matmul(torch.from_numpy(h), tw, ts)[:, :VOCAB]
        logits = logits.masked_fill(~torch.from_numpy(mask), float("-inf"))
        assert (got == logits.argmax(-1).numpy()).all()


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("temp", [0.0, 0.8])
def test_plain_head_sampler_bf16_matches_jax_kernel(bits, temp):
    """The plain K8 on bf16 h with bf16 logits against
    ``_head_kernel(out_dtype=jnp.bfloat16, interpret=True)`` on the same bf16
    h: identical tokens (the logits rounded through bf16 before the
    temperature, ties to the lowest lane); bf16 h gives h.float()'s tokens
    (the widening is exact)."""
    B = 5
    w, s = _table(bits, 30 + bits)
    rng = onp.random.RandomState(50 + bits)
    hb = torch.from_numpy(rng.randn(B, D).astype(onp.float32)).bfloat16()
    kb = _keybits(B, 60)
    temps = onp.full(B, temp, onp.float32)
    hj = jnp.asarray(hb.float().numpy()).astype(jnp.bfloat16)
    want = onp.asarray(jfb._head_kernel(
        hj, jnp.asarray(w), jnp.asarray(s), VOCAB, jnp.asarray(temps),
        jnp.asarray(kb.astype(onp.uint32)), out_dtype=jnp.bfloat16, interpret=True))
    tw, ts = torch.from_numpy(w), torch.from_numpy(s)
    args = (tw, ts, VOCAB, torch.from_numpy(kb), torch.from_numpy(temps))
    got = fb.fused_lm_head_sample(hb, *args, out_dtype=torch.bfloat16).numpy()
    assert (got == want).all()
    wide = fb.fused_lm_head_sample(hb.float(), *args, out_dtype=torch.bfloat16).numpy()
    assert (got == wide).all()
    if temp == 0.0:
        logits = weight_matmul(hb, tw, ts)[:, :VOCAB].bfloat16().float()
        assert (got == logits.argmax(-1).numpy()).all()


# ---------------------------------------------------------------------------
# fused_lm_head_sample against the JAX package's on the CPU
# ---------------------------------------------------------------------------
def _head_inputs(bits, B, seed):
    w, s = _table(bits, seed)
    rng = onp.random.RandomState(seed + 1)
    h = rng.randn(B, D).astype(onp.float32)
    return w, s, h, _mask(rng, B, VOCAB, p=0.3)


@pytest.mark.parametrize("bits", [8, 4])
def test_masked_greedy_rows_equal_jax_fused_head(bits):
    """Greedy rows of the masked fused head (the port's unfiltered branch,
    the plain K8) equal JAX's ``fused_lm_head_sample(mask=)`` on the CPU,
    which takes ``sample_tokens`` over the masked head logits."""
    B = 6
    w, s, h, mask = _head_inputs(bits, B, 70 + bits)
    seeds, counters = onp.arange(B, dtype=onp.uint32) + 5, onp.full(B, 2, onp.int32)
    keys = jgen._fold_keys(jnp.asarray(seeds), jnp.asarray(counters))
    temps = onp.zeros(B, onp.float32)
    want = onp.asarray(jfb.fused_lm_head_sample(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(s), VOCAB, keys, jnp.asarray(temps),
        0, 1.0, mask=jnp.asarray(mask)))
    got = fb.fused_lm_head_sample(torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(s),
                                  VOCAB, _prng.fold_keys(seeds, counters),
                                  torch.from_numpy(temps), mask=torch.from_numpy(mask)).numpy()
    assert (got == want).all()


@pytest.mark.parametrize("bits", [8, 4])
def test_filtered_masked_branch_equals_jax(bits):
    """A batch with a top-k/top-p row takes the filtered branch: the head
    GEMV's logits cut to the vocab, then ``sample_tokens`` with the mask and
    the rows' keys, JAX's tokens exactly (greedy, T 0.8, top-k and top-p
    rows; each nucleus away from its edges), with no K8 launch."""
    B = 6
    w, s, h, mask = _head_inputs(bits, B, 90 + bits)
    tw, ts = torch.from_numpy(w), torch.from_numpy(s)
    temps = onp.array([0.0, 0.8, 0.8, 1.1, 0.9, 0.0], onp.float32)
    topks = onp.array([0, 0, 7, 0, 30, 4], onp.int32)
    logits = weight_matmul(torch.from_numpy(h), tw, ts)[:, :VOCAB].numpy()
    masked = onp.where(mask, logits, -onp.inf).astype(onp.float32)
    topps = chip_smoke.nucleus_away_from_edges(onp, masked, temps, topks, (3, 4))
    seeds, counters = onp.arange(B, dtype=onp.uint32) * 3 + bits, onp.full(B, 9, onp.int32)
    keys = jgen._fold_keys(jnp.asarray(seeds), jnp.asarray(counters))
    want = onp.asarray(jfb.fused_lm_head_sample(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(s), VOCAB, keys, jnp.asarray(temps),
        jnp.asarray(topks), jnp.asarray(topps), mask=jnp.asarray(mask)))
    with count_launches() as tally:
        got = fb.fused_lm_head_sample(torch.from_numpy(h), tw, ts, VOCAB,
                                      _prng.fold_keys(seeds, counters), torch.from_numpy(temps),
                                      topks, topps, mask=torch.from_numpy(mask)).numpy()
    assert not any(k.startswith("fused_head") for k in tally)
    assert (got == want).all()
    assert mask[onp.arange(B), got].all()


def test_mask_shape_is_checked():
    """The fused head takes the mask at [B, vocab], as the reference pads
    it; another shape raises rather than broadcasting."""
    w, s = _table(8, 1)
    h = torch.zeros(2, D)
    with pytest.raises(MXNetError, match="mask must be bool"):
        fb.fused_lm_head_sample(h, torch.from_numpy(w), torch.from_numpy(s), VOCAB,
                                torch.zeros(2, dtype=torch.int64), torch.zeros(2),
                                mask=torch.ones(2, VP, dtype=torch.bool))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("B", [9, 16])
def test_unpadded_mask_and_key_forms_match_jax_kernel(bits, B):
    """The fused head takes the caller's bool [B, vocab] mask as it is (K8
    reads it unpadded; the plain version pads it): with the last vocab lane
    forbidden everywhere, at B past one row tile of 8, greedy and T = 0.8
    rows give ``_head_kernel(mask=, interpret=True)``'s tokens on the
    padded mask, whether the rows' keys come as [B, 2] keys or as their [B]
    key bits, and the mask as numpy or a tensor."""
    w, s = _table(bits, 110 + bits)
    rng = onp.random.RandomState(120 + B)
    h = rng.randn(B, D).astype(onp.float32)
    mask = _mask(rng, B, VOCAB, p=0.3)
    mask[:, VOCAB - 1] = False
    mask_p = onp.zeros((B, VP), bool)
    mask_p[:, :VOCAB] = mask
    seeds, counters = onp.arange(B) + 7, onp.full(B, 4)
    keys = _prng.fold_keys(seeds, counters)
    kb = gen._key_bits(seeds, counters)
    assert (kb == (keys[:, 0] ^ keys[:, 1]).numpy()).all()
    temps = onp.where(onp.arange(B) % 2 == 0, 0.0, 0.8).astype(onp.float32)
    want = onp.asarray(jfb._head_kernel(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(s), VOCAB, jnp.asarray(temps),
        jnp.asarray(kb.astype(onp.uint32)), mask=jnp.asarray(mask_p), interpret=True))
    tw, ts, th = torch.from_numpy(w), torch.from_numpy(s), torch.from_numpy(h)
    for k, m in ((keys, torch.from_numpy(mask)), (torch.from_numpy(kb), mask)):
        got = fb.fused_lm_head_sample(th, tw, ts, VOCAB, k, torch.from_numpy(temps),
                                      mask=m).numpy()
        assert (got == want).all()
        assert mask[onp.arange(B), got].all()
