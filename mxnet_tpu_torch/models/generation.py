"""Autoregressive generation with the KV cache (counterpart of
``mxnet_tpu/models/generation.py``).

PyTorch runs eagerly, so the JAX package's compiled ``fori_loop`` /
``while_loop`` decode loops are Python loops here; one loop iteration is
one incremental forward (12 K5 launches for GPT-2 small) plus the head.

Sampling streams are keyed like the JAX package's: per row,
``fold_in(key(seed), counter)`` of JAX's threefry2x32 PRNG
(:func:`_fold_keys`, a numpy port run on the host). The fused head (K8)
hashes those key bits, so temperature sampling through the quantized head
(``multi_token > 1``) draws the TPU kernel's token stream. Greedy decoding
is exact everywhere. Rows that need ``jax.random.categorical`` — sampling
without the fused head (``multi_token=1`` or an unquantized head), and
top-k / top-p filtering — raise until the sampling slice ports it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["generate", "decode_step", "decode_step_hidden",
           "decode_multi_tokens", "sample_tokens"]

_SAMPLING_LATER = ("needs the jax.random.categorical sampling stream, which "
                   "a later slice of the port brings")


def _validate_sampling(temperature, top_k, top_p):
    if not temperature >= 0:
        raise MXNetError(f"temperature must be >= 0, got {temperature}")
    if int(top_k) != top_k or top_k < 0:
        raise MXNetError(f"top_k must be a non-negative integer (0 disables "
                         f"top-k filtering), got {top_k}")
    if not 0.0 < top_p <= 1.0:
        raise MXNetError(f"top_p must be in (0, 1], got {top_p}")
    if top_k > 0 or top_p < 1.0:
        raise MXNetError("top-k/top-p sampling " + _SAMPLING_LATER)


# ---------------------------------------------------------------------------
# JAX's threefry2x32 key / fold_in, on uint32 numpy arrays
# ---------------------------------------------------------------------------
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k0, k1, x0, x1):
    """The 20-round Threefry-2x32 hash of ``jax._src.prng`` (key (k0, k1),
    counts (x0, x1)); uint32 arrays, wrapping arithmetic."""
    u32 = np.uint32
    ks = (k0, k1, k0 ^ k1 ^ u32(0x1BD11BDA))
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = (x1 << u32(r)) | (x1 >> u32(32 - r))
            x1 = x0 ^ x1
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + u32(i + 1)
    return x0, x1


def _fold_keys(seeds, counters):
    """[B, 2] uint32 key data of ``fold_in(key(seed), counter)`` per row:
    ``key(s)`` is (0, s) for a 32-bit seed and ``fold_in`` hashes the
    counts (0, counter) under it."""
    s = np.asarray(seeds, dtype=np.int64).astype(np.uint32).reshape(-1)
    c = np.asarray(counters, dtype=np.int64).astype(np.uint32).reshape(-1)
    zero = np.zeros_like(s)
    y0, y1 = _threefry2x32(zero, s, zero, c)
    return np.stack([y0, y1], axis=1)


def _key_bits(seeds, counters):
    """The 32 key bits the fused head hashes per row (``kd[:, -2] ^
    kd[:, -1]``, fused_block_gemv.py:1380-1381) as int64 in [0, 2**32)."""
    kd = _fold_keys(seeds, counters)
    return (kd[:, 0] ^ kd[:, 1]).astype(np.int64)


def _row_seeds(seed: int, B: int):
    """Per-row uint32 seeds of generate()'s multi-token streams."""
    base = np.uint32((int(seed) * 0x9E3779B1) & 0xFFFFFFFF)
    return (base + np.arange(B, dtype=np.uint32)) & np.uint32(0xFFFFFFFF)


def sample_tokens(logits, temperature):
    """Next token per row of [B, V] logits. Greedy rows (T == 0) take the
    argmax (lowest index on ties); T > 0 rows raise (see module doc)."""
    t = np.asarray(temperature, dtype=np.float32).reshape(-1)
    if (t > 0).any():
        raise MXNetError("temperature sampling without the fused quantized head "
                         + _SAMPLING_LATER)
    return torch.argmax(logits.float(), dim=-1).to(torch.int32)


def decode_step(model, tokens, pos, caches, block_table=None):
    """One incremental forward: attend ``tokens`` [B, T] at ``pos`` (int,
    or a [B] tensor of per-row offsets) against ``caches`` (written in
    place). Returns ``(logits [B, T, V], caches)``. With ``block_table``
    [B, max_pages] the step goes through the model's paged entry point:
    ``caches`` are then the shared page pools (serve/paging)."""
    if block_table is None:
        logits, *caches = model.forward_cached(tokens, pos, *caches)
    else:
        logits, *caches = model.forward_cached_paged(tokens, pos, block_table,
                                                     *caches)
    return logits, caches


def decode_step_hidden(model, tokens, pos, caches, block_table=None):
    """:func:`decode_step` returning the final hidden state [B, T, D]."""
    if block_table is None:
        hidden, *caches = model.forward_cached_hidden(tokens, pos, *caches)
    else:
        hidden, *caches = model.forward_cached_paged_hidden(
            tokens, pos, block_table, *caches)
    return hidden, caches


def decode_multi_tokens(model, tokens, pos, caches, num_tokens, temps,
                        seeds, counters, eos_ids=None, remaining=None,
                        done=None, fill_eos=False, head=None,
                        block_table=None):
    """Emit up to ``num_tokens`` (K) tokens per row, feeding each token
    straight back in, with per-row ``fold_in(key(seed), counter + j)``
    sampling. ``tokens`` [B] (device), ``pos`` int or [B] device tensor;
    ``temps`` / ``seeds`` / ``counters`` / ``eos_ids`` (-1 = none) /
    ``remaining`` (token budget) are host arrays of length B, ``done`` an
    optional [B] bool device tensor. ``head`` = ``(w_q, scales, vocab)``
    routes selection through the fused LM-head sampler (K8);
    ``block_table`` routes every substep through the paged pools.

    The JAX loop exits early once every row is done, which needs the
    device's EOS flags. This loop runs ``min(K, max(remaining))``
    substeps, which the host knows without a sync; substeps past a row's
    EOS are discarded by the caller, as in JAX.

    Returns ``(toks [B, K] int32, last [B], steps, done [B], caches)``;
    columns >= ``steps`` of ``toks`` are zeros."""
    dev = model.device
    B = tokens.shape[0]
    K = int(num_tokens)
    temps = np.array(np.broadcast_to(np.asarray(temps, np.float32).reshape(-1),
                                     (B,)))
    if head is None and (temps > 0).any():
        raise MXNetError("temperature sampling without the fused quantized head "
                         + _SAMPLING_LATER)
    seeds = np.asarray(seeds, np.int64).reshape(-1)
    counters = np.asarray(counters, np.int64).reshape(-1)
    eos = np.full(B, -1, np.int64) if eos_ids is None else \
        np.array(np.broadcast_to(np.asarray(eos_ids, np.int64).reshape(-1), (B,)))
    eos_t = torch.as_tensor(eos, dtype=torch.int32).to(dev)
    dn = (torch.zeros(B, dtype=torch.bool, device=dev) if done is None
          else done.to(dev, torch.bool).clone())
    steps = K
    rem_t = None
    if remaining is not None:
        rem = np.asarray(remaining, np.int64).reshape(-1)
        steps = int(min(K, max(0, int(rem.max(initial=0)))))
        rem_t = torch.as_tensor(rem, dtype=torch.int32).to(dev)
    out = torch.zeros(B, K, dtype=torch.int32, device=dev)
    tok = tokens.to(torch.int32)
    if head is not None and steps:
        from ..ops.fused_block_gemv import fused_lm_head_sample
        w_q, scale, vocab = head
        temps_t = torch.from_numpy(temps).to(dev)
        kbits = torch.as_tensor(np.stack(
            [_key_bits(seeds, counters + j) for j in range(steps)])).to(dev)
    for j in range(steps):
        posj = pos + j
        if head is None:
            logits, caches = decode_step(model, tok[:, None], posj, caches,
                                         block_table)
            nxt = sample_tokens(logits[:, -1], temps)
        else:
            hidden, caches = decode_step_hidden(model, tok[:, None], posj,
                                                caches, block_table)
            nxt = fused_lm_head_sample(hidden[:, -1], w_q, scale, vocab,
                                       kbits[j], temps_t)
        if fill_eos:
            nxt = torch.where(dn & (eos_t >= 0), eos_t, nxt)
        newly = nxt == eos_t
        if rem_t is not None:
            newly = newly | (j + 1 >= rem_t)
        out[:, j] = nxt
        dn = dn | newly
        tok = nxt
    return out, tok, steps, dn, caches


def generate(model, input_ids, max_new_tokens: int,
             eos_token_id: Optional[int] = None,
             temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
             seed: int = 0, use_cache: bool = True, multi_token: int = 1):
    """Generate ``max_new_tokens`` continuations of ``input_ids`` [B, P]
    with KV-cache decode on the model's device. ``temperature == 0`` is
    greedy; after ``eos_token_id`` a row keeps emitting eos. Returns
    [B, P + max_new_tokens] int32.

    ``multi_token`` > 1 decodes in chunks of K tokens with per-row
    ``fold_in`` streams and, when the model carries a quantized tied head,
    the fused LM-head sampler; greedy output equals ``multi_token=1``."""
    if max_new_tokens <= 0:
        raise MXNetError("max_new_tokens must be positive")
    _validate_sampling(temperature, top_k, top_p)
    multi_token = int(multi_token)
    if multi_token < 1:
        raise MXNetError("multi_token must be >= 1")
    if not use_cache:
        raise MXNetError("cache-free decode is not ported (the GPT family "
                         "always speaks the KV-cache protocol)")
    dev = model.device
    ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.int32).to(dev)
    B, P = ids.shape
    L = P + max_new_tokens
    max_pos = model.cfg.max_position_embeddings
    if L > max_pos:
        raise MXNetError(
            f"generate: prompt ({P}) + max_new_tokens ({max_new_tokens}) "
            f"= {L} exceeds the model's max_position_embeddings ({max_pos})")
    eos = -1 if eos_token_id is None else int(eos_token_id)
    with torch.no_grad():
        if multi_token == 1:
            return _generate_single(model, ids, max_new_tokens, eos,
                                    temperature)
        return _generate_multi(model, ids, max_new_tokens, eos, temperature,
                               seed, multi_token)


def _generate_single(model, ids, max_new_tokens, eos, temperature):
    B, P = ids.shape
    L = P + max_new_tokens
    caches = model.new_caches(B, L)
    buf = torch.zeros(B, L, dtype=torch.int32, device=ids.device)
    buf[:, :P] = ids
    done = torch.zeros(B, dtype=torch.bool, device=ids.device)

    def select(step_logits, done):
        nxt = sample_tokens(step_logits, temperature)
        if eos >= 0:
            nxt = torch.where(done, torch.full_like(nxt, eos), nxt)
            done = done | (nxt == eos)
        return nxt, done

    logits, caches = decode_step(model, ids, 0, caches)
    buf[:, P], done = select(logits[:, -1], done)
    for i in range(max_new_tokens - 1):
        pos = P + i
        logits, caches = decode_step(model, buf[:, pos:pos + 1], pos, caches)
        buf[:, pos + 1], done = select(logits[:, 0], done)
    return buf


def _generate_multi(model, ids, max_new_tokens, eos, temperature, seed, K):
    B, P = ids.shape
    L = P + max_new_tokens
    chunks = -(-(max_new_tokens - 1) // K) if max_new_tokens > 1 else 0
    Lbuf = P + 1 + chunks * K
    head = model.head_weights()
    caches = model.new_caches(B, Lbuf)
    buf = torch.zeros(B, Lbuf, dtype=torch.int32, device=ids.device)
    buf[:, :P] = ids
    seeds = _row_seeds(seed, B)
    temps = np.full(B, temperature, np.float32)
    eos_vec = np.full(B, eos, np.int64)
    # prefill + token 0 (counter 0 of every row's stream)
    if head is None:
        logits, caches = decode_step(model, ids, 0, caches)
        tok0 = sample_tokens(logits[:, -1], temps)
    else:
        from ..ops.fused_block_gemv import fused_lm_head_sample
        hidden, caches = decode_step_hidden(model, ids, 0, caches)
        kb = torch.as_tensor(_key_bits(seeds, np.zeros(B, np.int64)))
        tok0 = fused_lm_head_sample(hidden[:, -1], head[0], head[1], head[2],
                                    kb.to(ids.device),
                                    torch.as_tensor(temps).to(ids.device))
    buf[:, P] = tok0
    done = tok0 == eos
    tok = tok0
    for c in range(chunks):
        toks, tok, _, done, caches = decode_multi_tokens(
            model, tok, P + c * K, caches, K, temps, seeds,
            np.full(B, 1 + c * K, np.int64), eos_ids=eos_vec, done=done,
            fill_eos=True, head=head)
        buf[:, P + 1 + c * K:P + 1 + (c + 1) * K] = toks
    return buf[:, :L]
