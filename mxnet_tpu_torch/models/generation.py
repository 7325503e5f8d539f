"""Autoregressive generation with the KV cache (counterpart of
``mxnet_tpu/models/generation.py``).

PyTorch runs eagerly, so the JAX package's compiled ``fori_loop`` /
``while_loop`` decode loops are Python loops here; one loop iteration is
one incremental forward (12 K5 launches for GPT-2 small) plus the head.

Sampling draws JAX's own stream (``_prng``: threefry2x32 keys,
``random.categorical``): :func:`filter_logits` (top-k, then top-p) and
keyed :func:`sample_tokens` are ported op for op, so the same seed gives
the JAX package's tokens on any path that materialises logits.
``generate(multi_token=1)`` splits one ``key(seed)`` per step, as JAX
does; the multi-token loop and the serving engine key each row with
``fold_in(key(seed), counter)``. A quantized tied head with
``multi_token > 1`` selects through the fused head (K8): greedy rows are
exact, unfiltered T > 0 rows draw K8's hash-Gumbel stream from the same
key bits (the TPU kernel's stream; the JAX package's off-TPU branch uses
``sample_tokens`` there instead, so those rows, and only those, differ
from JAX on the CPU by design), and a batch with any top-k/top-p row
takes ``sample_tokens`` on the head GEMV's logits, as the reference's
``lax.cond`` does. A grammar mask (bool, True = allowed) constrains
:func:`filter_logits`, :func:`sample_tokens` and the fused head as it does
in the JAX package: masked lanes drop to -inf before any filter or argmax,
and an all-masked row raises.

``mxnet_recompilations_total{block="generate"}`` counts where the JAX
package compiles a new decode loop: the first call of each (model, batch,
prompt length, budget, sampling parameters, eos, cache, multi_token) key
its bounded LRU of 8 loops does not hold (``kind="initial"`` for a model's
first loop, ``"retrace"`` after).
"""
from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from .. import _prng
from .. import metrics as _metrics
from ..autograd import predict_mode
from ..base import MXNetError

__all__ = ["generate", "decode_step", "decode_step_hidden",
           "decode_multi_tokens", "filter_logits", "sample_tokens",
           "spec_verify_tokens"]


def _can_cache(model) -> bool:
    """True if the model exposes the KV-cache protocol (``cache_spec`` and
    ``forward_cached``) and its config supports it: ``cache_spec`` raising
    MXNetError is the unsupported-config signal (Llama's MoE, pp_mesh and
    sp_mesh configs); any other error propagates."""
    if not (hasattr(model, "cache_spec") and hasattr(model, "forward_cached")):
        return False
    try:
        model.cache_spec(1, 8)
    except MXNetError:
        return False
    return True


def _validate_sampling(temperature, top_k, top_p):
    if not temperature >= 0:
        raise MXNetError(f"temperature must be >= 0, got {temperature}")
    if int(top_k) != top_k or top_k < 0:
        raise MXNetError(f"top_k must be a non-negative integer (0 disables "
                         f"top-k filtering), got {top_k}")
    if not 0.0 < top_p <= 1.0:
        raise MXNetError(f"top_p must be in (0, 1], got {top_p}")


def _fold_keys(seeds, counters):
    """[B, 2] uint32 key data of ``fold_in(key(seed), counter)`` per row
    (numpy, for the host side and the tests)."""
    return _prng.fold_keys(seeds, counters).numpy().astype(np.uint32)


def _key_bits(seeds, counters):
    """The 32 key bits the fused head hashes per row (``kd[:, -2] ^
    kd[:, -1]``, fused_block_gemv.py:1380-1381) as int64 in [0, 2**32)."""
    kd = _prng.fold_keys(seeds, counters)
    return (kd[:, 0] ^ kd[:, 1]).numpy()


def _row_seeds(seed: int, B: int):
    """Per-row uint32 seeds of generate()'s multi-token streams."""
    base = np.uint32((int(seed) * 0x9E3779B1) & 0xFFFFFFFF)
    return (base + np.arange(B, dtype=np.uint32)) & np.uint32(0xFFFFFFFF)


def _rows(x, dtype, device):
    """Per-row sampling parameters as a [B|1, 1] tensor on ``device``."""
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x,
                           dtype=dtype, device=device).reshape(-1, 1)


def _check_mask_live(mask):
    """Raise on a row whose grammar mask allows no token (an automaton dead
    end), as ``mxnet_tpu/models/generation.py:_check_mask_live`` does for a
    concrete mask: the -inf argmax would otherwise emit token 0. Reading
    the rows synchronises with the mask's device."""
    live = torch.as_tensor(mask).any(dim=-1).reshape(-1)
    if not bool(live.all()):
        rows = torch.nonzero(~live).reshape(-1).tolist()
        raise MXNetError(
            f"grammar mask allows NO token for row(s) {rows[:8]} — the "
            "automaton reached a dead end (every vocab token and EOS "
            "forbidden); this indicates a grammar whose token table "
            "cannot spell the remaining language, or a corrupted "
            "automaton state")


def _apply_mask(x, mask, check=True):
    """``x`` with the lanes ``mask`` forbids (bool [B, V] or [V], True =
    allowed) at -inf, after the dead-end check (``check=False`` skips it:
    the serving engine's captured steps, whose masks the host guards)."""
    if check:
        _check_mask_live(mask)
    mask = torch.as_tensor(mask, dtype=torch.bool, device=x.device)
    return torch.where(mask, x, torch.full((), float("-inf"), device=x.device))


def filter_logits(scaled, top_k, top_p, mask=None):
    """Top-k then nucleus (top-p) filtering of [B, V] logits: filtered-out
    entries become -inf. ``top_k`` / ``top_p`` are scalars or per-row [B]
    arrays; ``top_k <= 0`` and ``top_p >= 1`` disable their filter. The
    nucleus keeps the smallest prefix of the sorted probabilities whose
    mass reaches ``top_p`` (at least the argmax), over the post-top-k
    distribution, as ``mxnet_tpu/models/generation.py:filter_logits``.
    ``mask`` (bool [B, V] or [V], True = allowed) applies a grammar
    constraint BEFORE the filters, so top-k counts and the nucleus mass
    cover the legal tokens only."""
    if mask is not None:
        scaled = _apply_mask(scaled, mask)
    B, V = scaled.shape
    dev = scaled.device
    top_k = _rows(top_k, torch.int64, dev)
    top_p = _rows(top_p, torch.float32, dev)
    ninf = torch.full((), float("-inf"), device=dev)
    sdesc = torch.sort(scaled, dim=-1, descending=True).values
    kth = torch.gather(sdesc, 1, (top_k - 1).clamp(0, V - 1).expand(B, 1))
    scaled = torch.where((top_k <= 0) | (scaled >= kth), scaled, ninf)
    # the top-k filter only -infs a suffix of sdesc, so the filtered sorted
    # view needs no second sort
    sdesc = torch.where((top_k <= 0) | (sdesc >= kth), sdesc, ninf)
    probs = torch.softmax(sdesc, dim=-1)
    csum = torch.cumsum(probs, dim=-1)
    ncut = ((csum - probs) < top_p).sum(dim=-1, keepdim=True)       # >= 1
    thr = torch.gather(sdesc, 1, (ncut - 1).clamp(0, V - 1))
    return torch.where((top_p >= 1.0) | (scaled >= thr), scaled, ninf)


def sample_tokens(logits, keys, temperature, top_k=0, top_p=1.0, mask=None,
                  greedy=None, check_mask=True):
    """Next token per row of [B, V] logits with per-row parameters: rows at
    ``temperature == 0`` take the argmax (lowest index on ties), the rest
    draw ``random.categorical`` with their own key from the temperature-
    scaled, top-k/top-p filtered logits. ``keys`` is [B, 2] key data
    (``_prng.fold_keys``); it may be None when every row is greedy.
    ``mask`` (bool [B, V], True = allowed) constrains both paths: greedy
    rows take the argmax of the masked logits, sampled rows mask before
    scaling and filtering. ``greedy`` (a bool) says whether every row is at
    ``temperature == 0``, as the caller knows it on the host; None reads it
    from ``temperature``, which syncs with a device tensor (a CUDA-graph
    capture cannot). ``check_mask=False`` skips the read-back of the mask's
    rows that raises on a row with no allowed token; the serving engine's
    steps pass it, as the JAX package skips the check for a traced mask.
    Returns [B] int32."""
    logits = logits.float()
    if mask is not None:
        logits = _apply_mask(logits, mask, check_mask)
    t = _rows(temperature, torch.float32, logits.device)
    best = torch.argmax(logits, dim=-1)
    if greedy is None:
        greedy = not bool((t > 0).any())
    if greedy:
        return best.to(torch.int32)
    if keys is None:
        raise MXNetError("sample_tokens: T > 0 rows need their keys")
    scaled = logits / torch.where(t > 0, t, torch.ones_like(t))
    filt = filter_logits(scaled, top_k, top_p)
    sampled = _prng.categorical(torch.as_tensor(keys).to(logits.device), filt)
    return torch.where(t.reshape(-1) > 0, sampled, best).to(torch.int32)


def spec_verify_tokens(logits, inputs, temps, topks, topps, seeds=None,
                       counters=None, masks=None, keys=None, greedy=None,
                       check_mask=True):
    """Exact self-speculative verification of one drafted batch
    (``mxnet_tpu/models/generation.py:spec_verify_tokens``).

    ``logits`` [B, T, V] is the verify forward's output over ``inputs`` [B,
    T] = ``[t0, d_1, ..., d_{T-1}]`` (the current token, then T-1 drafts).
    Column j is selected by ``sample_tokens`` with the key
    ``fold_in(key(seed), counter + j)``, the one the non-speculative path
    uses at that position, so ``toks[:, j]`` is that path's token, greedy or
    sampled, and acceptance is equality with the draft: ``acc = 1 +`` the
    run of leading matches. The T selections are one flattened [B*T, V]
    ``sample_tokens`` call; every op of it is row-wise.

    ``temps`` / ``topks`` / ``topps`` are per-row [B]; ``seeds`` and
    ``counters`` [B] give the keys, or ``keys`` gives them ready ([B, T, 2]
    or [B*T, 2] key data, row-major in (b, j)). ``masks`` (bool [B, T, V])
    constrains column j with ``masks[:, j]``. A caller that owns device
    buffers (the engine's captured verify) passes ``keys``, ``greedy`` (every
    row at T 0, known on the host) and ``check_mask=False``: the call then
    neither syncs nor copies from the host.

    Returns ``(toks [B, T] int32, acc [B] int32)``: ``toks[b, :acc[b]]`` are
    the row's tokens this round, the accepted drafts and one correction or
    bonus token."""
    B, T, V = logits.shape
    dev = logits.device

    def per_position(x, dtype):
        return _per_row(x, dtype, B, dev)[:, None].expand(B, T).reshape(B * T)

    if keys is None and greedy is not True:
        keys = _prng.step_keys(seeds, counters, T).transpose(1, 0, 2)
    if keys is not None:
        keys = torch.as_tensor(keys).to(dev).reshape(B * T, 2)
    toks = sample_tokens(logits.reshape(B * T, V), keys,
                         per_position(temps, torch.float32),
                         per_position(topks, torch.int64),
                         per_position(topps, torch.float32),
                         mask=None if masks is None else masks.reshape(B * T, V),
                         greedy=greedy, check_mask=check_mask).reshape(B, T)
    if T == 1:
        return toks, torch.ones(B, dtype=torch.int32, device=dev)
    match = toks[:, :-1] == torch.as_tensor(inputs).to(dev)[:, 1:]
    lead = torch.cumprod(match.to(torch.int32), dim=1)
    return toks, (1 + lead.sum(dim=1)).to(torch.int32)


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


def _per_row(x, dtype, B, dev):
    """A per-row parameter as a [B] tensor on ``dev``: a tensor is taken as
    it is (converted on its device), a host scalar or array is broadcast
    and copied."""
    if isinstance(x, torch.Tensor):
        return x.to(dev, dtype).reshape(-1)
    nd = {torch.float32: np.float32, torch.int32: np.int32, torch.int64: np.int64}[dtype]
    return torch.from_numpy(np.array(np.broadcast_to(np.asarray(x, nd).reshape(-1), (B,)))).to(dev)


def decode_multi_tokens(model, tokens, pos, caches, num_tokens, temps,
                        seeds=None, counters=None, eos_ids=None, remaining=None,
                        done=None, fill_eos=False, head=None,
                        block_table=None, topks=0, topps=1.0, keys=None,
                        steps=None, filtered=None, greedy=None):
    """Emit up to ``num_tokens`` (K) tokens per row, feeding each token
    straight back in, with per-row ``fold_in(key(seed), counter + j)``
    sampling. ``tokens`` [B] (device), ``pos`` int or [B] device tensor;
    ``temps`` / ``seeds`` / ``counters`` / ``eos_ids`` (-1 = none) /
    ``remaining`` (token budget) / ``topks`` / ``topps`` are host arrays
    of length B (or scalars), ``done`` an optional [B] bool device tensor.
    ``head`` = ``(w_q, scales, vocab)`` routes selection through the fused
    LM-head sampler (K8; a batch with any top-k/top-p row takes
    ``sample_tokens`` on the head GEMV's logits); ``block_table`` routes
    every substep through the paged pools.

    The JAX loop exits early once every row is done, which needs the
    device's EOS flags. This loop runs ``min(K, max(remaining))``
    substeps, which the host knows without a sync; substeps past a row's
    EOS are discarded by the caller, as in JAX.

    A caller that owns device buffers (the serving engine's CUDA-graph
    inputs) passes ``temps``, ``eos_ids``, ``remaining``, ``topks`` and
    ``topps`` as [B] device tensors, ``keys`` as the [>= steps, B, 2]
    int64 device keys in place of ``seeds``/``counters``
    (``_prng.step_keys``), and the host's decisions as Python values:
    ``steps``, ``filtered`` (any top-k/top-p row, for ``head``) and
    ``greedy`` (every row at T 0). The call then neither syncs nor copies
    from the host, so it can be captured. None reads each decision from the
    host arrays (``steps``) or on the device.

    Returns ``(toks [B, K] int32, last [B], steps, done [B], caches)``;
    columns >= ``steps`` of ``toks`` are zeros."""
    dev = model.device
    B = tokens.shape[0]
    K = int(num_tokens)
    temps_t = _per_row(temps, torch.float32, B, dev)
    if not isinstance(topks, torch.Tensor):
        topks = np.array(np.broadcast_to(np.asarray(topks, np.int64).reshape(-1), (B,)))
    if not isinstance(topps, torch.Tensor):
        topps = np.array(np.broadcast_to(np.asarray(topps, np.float32).reshape(-1), (B,)))
    eos_t = _per_row(-1 if eos_ids is None else eos_ids, torch.int32, B, dev)
    dn = (torch.zeros(B, dtype=torch.bool, device=dev) if done is None
          else done.to(dev, torch.bool).clone())
    rem_t = None
    if remaining is not None:
        if steps is None:
            rem = np.asarray(remaining, np.int64).reshape(-1)
            steps = int(min(K, max(0, int(rem.max(initial=0)))))
        rem_t = _per_row(remaining, torch.int32, B, dev)
    steps = K if steps is None else int(steps)
    out = torch.zeros(B, K, dtype=torch.int32, device=dev)
    tok = tokens.to(torch.int32)
    if steps and keys is None:
        # every substep's keys at once: [steps, B, 2]
        keys = torch.from_numpy(_prng.step_keys(seeds, counters, steps)).to(dev)
    if head is not None and steps:
        from ..ops.fused_block_gemv import fused_lm_head_sample
        w_q, scale, vocab = head
    for j in range(steps):
        posj = pos + j
        if head is None:
            logits, caches = decode_step(model, tok[:, None], posj, caches,
                                         block_table)
            nxt = sample_tokens(logits[:, -1], keys[j], temps_t, topks, topps,
                                greedy=greedy)
        else:
            hidden, caches = decode_step_hidden(model, tok[:, None], posj,
                                                caches, block_table)
            nxt = fused_lm_head_sample(hidden[:, -1], w_q, scale, vocab,
                                       keys[j], temps_t, topks, topps,
                                       out_dtype=hidden.dtype, filtered=filtered,
                                       greedy=greedy)
        if fill_eos:
            nxt = torch.where(dn & (eos_t >= 0), eos_t, nxt)
        newly = nxt == eos_t
        if rem_t is not None:
            newly = newly | (j + 1 >= rem_t)
        out[:, j] = nxt
        dn = dn | newly
        tok = nxt
    return out, tok, steps, dn, caches


# the keys of the JAX package's LRU of compiled decode loops (generate()
# compiles on a miss); the port compiles nothing and keeps the keys only to
# count mxnet_recompilations_total where JAX does. JAX's entries hold their
# model; these hold a weak reference, and a dead model's keys drop out (so a
# new model that reuses its id is new)
_DECODE_KEYS: "OrderedDict" = OrderedDict()
_DECODE_KEYS_LIMIT = 8
_DECODE_KEYS_LOCK = threading.Lock()


def _note_decode_loop(model, key):
    """Record ``mxnet_recompilations_total{block="generate"}`` on a miss
    of the JAX package's decode-loop cache key ``(id(model), *key)``."""
    key = (id(model),) + key
    with _DECODE_KEYS_LOCK:
        for k in [k for k, ref in _DECODE_KEYS.items() if ref() is None]:
            del _DECODE_KEYS[k]
        if key in _DECODE_KEYS:
            _DECODE_KEYS.move_to_end(key)
            return
        seen = any(k[0] == key[0] for k in _DECODE_KEYS)
        while len(_DECODE_KEYS) >= _DECODE_KEYS_LIMIT:
            _DECODE_KEYS.popitem(last=False)
        _DECODE_KEYS[key] = weakref.ref(model)
    _metrics.RECOMPILATIONS.labels(block="generate",
                                   kind="retrace" if seen else "initial").inc()


def generate(model, input_ids, max_new_tokens: int,
             eos_token_id: Optional[int] = None,
             temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
             seed: int = 0, use_cache: Optional[bool] = None, multi_token: int = 1):
    """Generate ``max_new_tokens`` continuations of ``input_ids`` [B, P]
    with KV-cache decode on the model's device. ``temperature == 0`` is
    greedy; otherwise softmax sampling at the temperature, restricted to
    the ``top_k`` highest logits and/or the nucleus reaching ``top_p``;
    after ``eos_token_id`` a row keeps emitting eos. Returns
    [B, P + max_new_tokens] int32.

    ``multi_token=1`` splits ``key(seed)`` once per token (the JAX
    package's split chain). ``multi_token`` > 1 decodes in chunks of K
    tokens with per-row ``fold_in`` streams and, when the model carries a
    quantized tied head, the fused LM-head sampler; greedy output equals
    ``multi_token=1``.

    ``use_cache=False`` recomputes the full forward over the padded
    [B, P + max_new_tokens] buffer for every token (the JAX package's
    ``decode_nocache``) at ``multi_token=1``; True decodes with the KV
    cache and raises where the model's config refuses it; None decodes
    with the cache where the config allows it. Generation runs in
    ``autograd.predict_mode``: no dropout, whatever the model's mode."""
    if max_new_tokens <= 0:
        raise MXNetError("max_new_tokens must be positive")
    _validate_sampling(temperature, top_k, top_p)
    multi_token = int(multi_token)
    if multi_token < 1:
        raise MXNetError("multi_token must be >= 1")
    if use_cache is None:
        use_cache = _can_cache(model)
    elif use_cache and not _can_cache(model):
        raise MXNetError(
            "use_cache=True but the model does not expose the KV-cache "
            "protocol (cache_spec/forward_cached), or its config (stacked/"
            "pipeline decoder) does not support it")
    if multi_token > 1 and not use_cache:
        raise MXNetError(
            "multi_token > 1 requires KV-cache decode (the fused "
            "whole-step path drives the cache protocol)")
    dev = model.device
    ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.int32).to(dev)
    B, P = ids.shape
    L = P + max_new_tokens
    max_pos = getattr(getattr(model, "cfg", None), "max_position_embeddings", None)
    if max_pos is not None and L > max_pos:
        raise MXNetError(
            f"generate: prompt ({P}) + max_new_tokens ({max_new_tokens}) "
            f"= {L} exceeds the model's max_position_embeddings ({max_pos})")
    eos = -1 if eos_token_id is None else int(eos_token_id)
    _note_decode_loop(model, (B, P, max_new_tokens, temperature == 0.0,
                              float(temperature), int(top_k), float(top_p), eos_token_id,
                              use_cache, multi_token))
    with torch.no_grad(), predict_mode():
        if not use_cache:
            return _generate_nocache(model, ids, max_new_tokens, eos,
                                     temperature, int(top_k), float(top_p), seed)
        if multi_token == 1:
            return _generate_single(model, ids, max_new_tokens, eos,
                                    temperature, int(top_k), float(top_p), seed)
        return _generate_multi(model, ids, max_new_tokens, eos, temperature,
                               int(top_k), float(top_p), seed, multi_token)


def _selector(temperature, top_k, top_p, eos, dev):
    """generate()'s token selection at ``multi_token=1``: greedy, or one
    ``split`` of the key per token and ``categorical`` over the filtered,
    temperature-scaled logits; after eos a row keeps emitting eos."""
    temp = torch.tensor(temperature, dtype=torch.float32, device=dev)

    def select(step_logits, key, done):
        step_logits = step_logits.float()
        if temperature == 0.0:
            nxt = torch.argmax(step_logits, dim=-1)
        else:
            scaled = step_logits / temp
            if top_k > 0 or top_p < 1.0:
                scaled = filter_logits(scaled, top_k, top_p)
            key, sub = _prng.split(key)
            nxt = _prng.categorical(sub, scaled)
        nxt = nxt.to(torch.int32)
        if eos >= 0:
            nxt = torch.where(done, torch.full_like(nxt, eos), nxt)
            done = done | (nxt == eos)
        return nxt, key, done

    return select


def _start(ids, L, seed):
    """(token buffer [B, L] holding the prompt, done flags, key)."""
    B, P = ids.shape
    buf = torch.zeros(B, L, dtype=torch.int32, device=ids.device)
    buf[:, :P] = ids
    return (buf, torch.zeros(B, dtype=torch.bool, device=ids.device),
            _prng.key(seed, ids.device))


def _generate_nocache(model, ids, max_new_tokens, eos, temperature, top_k,
                      top_p, seed):
    """One full forward over the padded buffer per token; the causal mask
    keeps the zero tail from reaching position ``P + i - 1``."""
    B, P = ids.shape
    buf, done, key = _start(ids, P + max_new_tokens, seed)
    select = _selector(temperature, top_k, top_p, eos, ids.device)
    for i in range(max_new_tokens):
        pos = P + i - 1
        logits = model(buf)
        buf[:, pos + 1], key, done = select(logits[:, pos], key, done)
    return buf


def _generate_single(model, ids, max_new_tokens, eos, temperature, top_k,
                     top_p, seed):
    B, P = ids.shape
    caches = model.new_caches(B, P + max_new_tokens)
    buf, done, key = _start(ids, P + max_new_tokens, seed)
    select = _selector(temperature, top_k, top_p, eos, ids.device)
    logits, caches = decode_step(model, ids, 0, caches)
    buf[:, P], key, done = select(logits[:, -1], key, done)
    for i in range(max_new_tokens - 1):
        pos = P + i
        logits, caches = decode_step(model, buf[:, pos:pos + 1], pos, caches)
        buf[:, pos + 1], key, done = select(logits[:, 0], key, done)
    return buf


def _generate_multi(model, ids, max_new_tokens, eos, temperature, top_k, top_p,
                    seed, K):
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
    topks = np.full(B, top_k, np.int64)
    topps = np.full(B, top_p, np.float32)
    eos_vec = np.full(B, eos, np.int64)
    # prefill + token 0 (counter 0 of every row's stream)
    keys0 = _prng.fold_keys(seeds, np.zeros(B, np.int64), ids.device)
    if head is None:
        logits, caches = decode_step(model, ids, 0, caches)
        tok0 = sample_tokens(logits[:, -1], keys0, temps, topks, topps)
    else:
        from ..ops.fused_block_gemv import fused_lm_head_sample
        hidden, caches = decode_step_hidden(model, ids, 0, caches)
        tok0 = fused_lm_head_sample(hidden[:, -1], head[0], head[1], head[2],
                                    keys0, torch.as_tensor(temps).to(ids.device),
                                    topks, topps, out_dtype=hidden.dtype)
    buf[:, P] = tok0
    done = tok0 == eos
    tok = tok0
    for c in range(chunks):
        toks, tok, _, done, caches = decode_multi_tokens(
            model, tok, P + c * K, caches, K, temps, seeds,
            np.full(B, 1 + c * K, np.int64), eos_ids=eos_vec, done=done,
            fill_eos=True, head=head, topks=topks, topps=topps)
        buf[:, P + 1 + c * K:P + 1 + (c + 1) * K] = toks
    return buf[:, :L]
