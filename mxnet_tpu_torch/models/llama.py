"""Cached-attention helpers that GPT imports from ``models/llama.py``
(counterpart of ``mxnet_tpu/models/llama.py:_decode_positions``,
``_attend``, ``_cached_attention`` and ``_paged_attention``). The Llama
model itself is ported in a later slice.

Deliberate difference from JAX: :func:`_cached_attention` and
:func:`_paged_attention` write the new K/V rows into the caches or page
pools IN PLACE and return the same tensors, where the JAX functions return
updated copies. The fused block kernels update them in place too, so every
decode path shares one cache discipline.
"""
from __future__ import annotations

import math

import torch

__all__ = ["_decode_positions", "_attend", "_cached_attention",
           "_paged_attention"]


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


def _paged_attention(qh, kh, vh, k_pages, v_pages, block_table, pos):
    """Attention over a PAGED cache: the pools are [num_pages + 1, H, ps,
    hd] physical pages shared by every request, ``block_table`` [B,
    max_pages] maps row b's logical page i (positions [i*ps, (i+1)*ps)) to
    a physical page, and the last physical page is the sink.

    Every row's T new K/V rows are scattered through the table (page
    ``table[col // ps]``, row ``col % ps``) before any row gathers, so
    rows that share pages see one pool state. Columns at or past ``L =
    max_pages * ps`` (the padded tail of a bucketed final prefill chunk)
    go to the sink page: clamping the page index instead would overwrite
    the row's last real page. Reads gather the table's pages into the
    logical [B, H, L, hd] view and run :func:`_attend` with the mask
    ``j <= pos + t``. ``pos`` is a scalar or a [B] tensor; T >= 1 (prefill
    chunks and decode steps)."""
    B, H, T, hd = qh.shape
    NP1, ps = k_pages.shape[0], k_pages.shape[2]
    maxp = block_table.shape[1]
    L = maxp * ps
    dev = k_pages.device
    pos = torch.as_tensor(pos, dtype=torch.int64, device=dev)
    if pos.dim() == 0:
        pos = pos.expand(B)
    table = torch.as_tensor(block_table, device=dev).long()
    cols = pos.long()[:, None] + torch.arange(T, device=dev)[None, :]   # [B, T]
    pg = torch.take_along_dim(table, torch.clamp(cols // ps, max=maxp - 1), dim=1)
    pg = torch.where(cols < L, pg, torch.full_like(pg, NP1 - 1))
    off = cols % ps
    k_pages[pg, :, off, :] = kh.transpose(1, 2).to(k_pages.dtype)
    v_pages[pg, :, off, :] = vh.transpose(1, 2).to(v_pages.dtype)
    # logical view: page i of the table lands at rows [i*ps, (i+1)*ps)
    kf = k_pages[table].transpose(1, 2).reshape(B, H, L, hd).float()
    vf = v_pages[table].transpose(1, 2).reshape(B, H, L, hd).float()
    mask3 = torch.arange(L, device=dev)[None, None, :] <= cols[:, :, None]
    out = _attend(qh, kf, vf, mask3)
    return out, k_pages, v_pages
