"""Cached-attention helpers that GPT imports from ``models/llama.py``
(counterpart of ``mxnet_tpu/models/llama.py:_decode_positions``,
``_attend`` and ``_cached_attention``). The Llama model itself is ported
in a later slice.

Deliberate difference from JAX: :func:`_cached_attention` writes the new
K/V rows into the caches IN PLACE and returns the same tensors, where the
JAX function returns updated copies. The fused block kernel updates the
caches in place too, so both decode paths share one cache discipline.
"""
from __future__ import annotations

import math

import torch

__all__ = ["_decode_positions", "_attend", "_cached_attention"]


def _decode_positions(pos, T: int, device=None):
    """Token positions for an incremental step: scalar ``pos`` -> [T];
    per-row [B] ``pos`` -> [B, T]."""
    pos = torch.as_tensor(pos, dtype=torch.int64, device=device)
    steps = torch.arange(T, dtype=torch.int64, device=pos.device)
    if pos.dim() == 0:
        return pos + steps
    return pos[:, None] + steps[None, :]


def _attend(qh, kf, vf, mask3):
    """Masked attention of ``qh`` [B, H, T, hd] against f32 ``kf``/``vf``
    [B, H, L, hd] with validity mask ``mask3`` [B|1, T, L]. The JAX
    helper's grouped-query branch (Llama's GQA) comes with the Llama
    model."""
    hd = qh.shape[-1]
    scores = torch.einsum("bhtd,bhjd->bhtj", qh.float(), kf) / math.sqrt(hd)
    scores = scores.masked_fill(~mask3[:, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhtj,bhjd->bhtd", probs, vf).to(qh.dtype)


def _cached_attention(qh, kh, vh, k_cache, v_cache, pos):
    """Write the T new K/V rows at ``pos`` into the [B, H, L, hd] caches
    (in place) and attend the T query rows against the whole cache with a
    causality + validity mask: column j takes part iff j <= pos + t.
    ``pos`` is a scalar (whole batch at one offset) or a [B] tensor (each
    row at its own offset)."""
    B, H, T, hd = qh.shape
    L = k_cache.shape[2]
    dev = k_cache.device
    pos = torch.as_tensor(pos, device=dev)
    cols_all = torch.arange(L, device=dev)
    if pos.dim() == 0:
        p = int(pos)
        k_cache[:, :, p:p + T] = kh.to(k_cache.dtype)
        v_cache[:, :, p:p + T] = vh.to(v_cache.dtype)
        mask3 = (cols_all[None, :] <= (p + torch.arange(T, device=dev))[:, None])[None]
    else:
        cols = pos.long()[:, None] + torch.arange(T, device=dev)[None, :]    # [B, T]
        b_idx = torch.arange(B, device=dev)[:, None].expand(B, T)
        k_cache[b_idx, :, cols, :] = kh.transpose(1, 2).to(k_cache.dtype)
        v_cache[b_idx, :, cols, :] = vh.transpose(1, 2).to(v_cache.dtype)
        mask3 = cols_all[None, None, :] <= cols[:, :, None]                # [B, T, L]
    out = _attend(qh, k_cache.float(), v_cache.float(), mask3)
    return out, k_cache, v_cache
