"""Llama-family decoder LM: GQA, RoPE, RMSNorm, SwiGLU (counterpart of
``mxnet_tpu/models/llama.py``), and the cached-attention helpers that GPT
shares with it.

:class:`LlamaForCausalLM` holds the JAX package's parameters under its
``collect_params()`` names (``model.embed_tokens.weight``,
``model.layers.0.self_attn.q_proj.weight`` (units, in),
``model.layers.0.input_layernorm.gamma``, ..., ``model.norm.gamma``,
``lm_head.weight``; the stacked decoder's ``model.layers.wq`` [layers, out,
in], ...), so ``interop.params_from_numpy`` carries a JAX net's weights and
``quantize_net`` derives the same tables. The cache-free
:meth:`LlamaForCausalLM.forward` repeats the K/V heads and runs causal
attention through ``ops/attention.flash_attention``: K1 at T >= 256 on the
card. The serving path is the cached one (``forward_cached*``), on the
contiguous [B, n_kv, L, hd] caches or the paged [pages, n_kv, ps, hd]
pools, per layer or stacked ([layers, ...]); with ``quantize_net`` every
Dense (and a tied head) of up to ``gemv_max_m()`` rows streams its int8 or
int4 table through K3 or K4, and a tied quantized head selects tokens
through K8 in a ``multi_token > 1`` loop.

Training goes through the cache-free forward: ``parallel.TrainStep``
differentiates it end to end (RoPE, the bf16 RMSNorm rounding, the GQA
repeat, the untied or tied head), and at T >= 256 each layer's attention
is K1 forward and K2 backward. ``num_experts > 0`` builds :class:`LlamaMoE`
layers (every ``moe_every``-th layer, per-layer decoder only); as in the
JAX package an MoE model has no KV-cache path and trains or runs
cache-free.

Not ported yet (ROADMAP Queue 1 item 8): ring and Ulysses
sequence-parallel attention, the GPipe schedule of the stacked decoder
(``pp_mesh``) and ``llama_shardings``; each raises where the JAX package
would run it.

Deliberate difference from JAX: :func:`_cached_attention` and
:func:`_paged_attention` write the new K/V rows into the caches or page
pools IN PLACE and return the same tensors, where the JAX functions return
updated copies. The fused block kernels update them in place too, so every
decode path shares one cache discipline. The stacked decoder loops over the
layer axis in Python where the JAX package scans it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from .. import numpy_extension as npx
from ..autograd import is_predicting, predict_mode
from ..base import MXNetError
from ..device import resolve
from ..ops.attention import flash_attention
from ._layers import Dense, Embedding, RMSNorm

__all__ = ["LlamaConfig", "LlamaForCausalLM", "LlamaModel", "LlamaStackedDecoder",
           "LlamaMoE", "LLAMA3_8B", "LLAMA_TINY", "moe_capacity", "moe_route",
           "_decode_positions", "_attend",
           "_cached_attention", "_paged_attention"]

_NOT_PORTED = "is not ported yet (ROADMAP Queue 1 item 8)"


@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: Optional[int] = None
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    tie_embeddings: bool = False
    # attention implementation: 'flash'; 'ring' and 'ulysses' (with an
    # sp_mesh) are not ported yet
    attn_impl: str = "flash"
    sp_mesh: Optional[object] = None
    sp_axis: str = "sp"
    # MoE (0 = dense): every moe_every-th layer routes over num_experts
    num_experts: int = 0
    num_experts_per_tok: int = 2
    moe_capacity_factor: float = 1.25
    moe_every: int = 1
    # stacked decoder: one set of [num_layers, ...] parameters
    stacked: bool = False
    pp_mesh: Optional[object] = None
    pp_axis: str = "pp"
    pp_microbatches: int = 2

    @property
    def hd(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads


LLAMA3_8B = LlamaConfig()
LLAMA_TINY = LlamaConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                         num_layers=2, num_heads=4, num_kv_heads=2,
                         dtype=torch.float32)


def _rope(x, positions, theta: float):
    """Rotary embedding over split halves (the JAX code's convention: the
    first D/2 lanes rotate against the last D/2), f32 math, the result in
    x's dtype. ``positions`` is [T] (the whole batch at the same offsets)
    or [B, T] (each row at its own offset)."""
    D = x.shape[-1]
    inv_freq = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                             device=x.device) / D))
    positions = torch.as_tensor(positions, device=x.device)
    ang = positions.float()[..., None] * inv_freq               # (..., T, D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if ang.dim() == 2:
        cos, sin = cos[None, None], sin[None, None]             # [1, 1, T, D/2]
    else:
        cos, sin = cos[:, None], sin[:, None]                   # [B, 1, T, D/2]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _decode_positions(pos, T: int, device=None):
    """Token positions for an incremental step: scalar ``pos`` -> [T];
    per-row [B] ``pos`` -> [B, T]."""
    pos = torch.as_tensor(pos, dtype=torch.int64, device=device)
    steps = torch.arange(T, dtype=torch.int64, device=pos.device)
    if pos.dim() == 0:
        return pos + steps
    return pos[:, None] + steps[None, :]


def _attend(qh, kf, vf, mask3, rep: int = 1):
    """Masked attention of ``qh`` [B, H, T, hd] against f32 ``kf``/``vf``
    [B, n_kv, L, hd] with validity mask ``mask3`` [B|1, T, L]. GQA
    (``rep`` = H / n_kv > 1) attends grouped: q as [B, n_kv, rep, T, hd]
    against the unrepeated cache, as the JAX helper does."""
    B, H, T, hd = qh.shape
    if rep > 1:
        qg = qh.reshape(B, H // rep, rep, T, hd).float()
        scores = torch.einsum("bgrtd,bgjd->bgrtj", qg, kf) / math.sqrt(hd)
        scores = scores.masked_fill(~mask3[:, None, None], float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bgrtj,bgjd->bgrtd", probs, vf).reshape(B, H, T, hd)
    else:
        scores = torch.einsum("bhtd,bhjd->bhtj", qh.float(), kf) / math.sqrt(hd)
        scores = scores.masked_fill(~mask3[:, None], float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhtj,bhjd->bhtd", probs, vf)
    return out.to(qh.dtype)


def _cached_attention(qh, kh, vh, k_cache, v_cache, pos, rep: int = 1):
    """Write the T new K/V rows at ``pos`` into the [B, n_kv, L, hd] caches
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
    out = _attend(qh, k_cache.float(), v_cache.float(), mask3, rep)
    return out, k_cache, v_cache


def _paged_attention(qh, kh, vh, k_pages, v_pages, block_table, pos, rep: int = 1):
    """Attention over a PAGED cache: the pools are [num_pages + 1, n_kv, ps,
    hd] physical pages shared by every request, ``block_table`` [B,
    max_pages] maps row b's logical page i (positions [i*ps, (i+1)*ps)) to
    a physical page, and the last physical page is the sink.

    Every row's T new K/V rows are scattered through the table (page
    ``table[col // ps]``, row ``col % ps``) before any row gathers, so
    rows that share pages see one pool state. Columns at or past ``L =
    max_pages * ps`` (the padded tail of a bucketed final prefill chunk)
    go to the sink page: clamping the page index instead would overwrite
    the row's last real page. Reads gather the table's pages into the
    logical [B, n_kv, L, hd] view and run :func:`_attend` with the mask
    ``j <= pos + t``. ``pos`` is a scalar or a [B] tensor; T >= 1 (prefill
    chunks and decode steps)."""
    B, H, T, hd = qh.shape
    NP1, G, ps = k_pages.shape[0], k_pages.shape[1], k_pages.shape[2]
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
    kf = k_pages[table].transpose(1, 2).reshape(B, G, L, hd).float()
    vf = v_pages[table].transpose(1, 2).reshape(B, G, L, hd).float()
    mask3 = torch.arange(L, device=dev)[None, None, :] <= cols[:, :, None]
    out = _attend(qh, kf, vf, mask3, rep)
    return out, k_pages, v_pages


def _heads(cfg: LlamaConfig, q, k, v, positions):
    """[B, T, *] projections -> rotated q [B, H, T, hd], rotated k and v
    [B, n_kv, T, hd]."""
    B, T, _ = q.shape
    hd = cfg.hd
    qh = q.reshape(B, T, cfg.num_heads, hd).transpose(1, 2)
    kh = k.reshape(B, T, cfg.num_kv_heads, hd).transpose(1, 2)
    vh = v.reshape(B, T, cfg.num_kv_heads, hd).transpose(1, 2)
    return (_rope(qh, positions, cfg.rope_theta), _rope(kh, positions, cfg.rope_theta), vh)


def _context(o):
    """[B, H, T, hd] attention output -> the [B, T, H * hd] context."""
    B, H, T, hd = o.shape
    return o.transpose(1, 2).reshape(B, T, H * hd)


def _full_attention(cfg: LlamaConfig, qh, kh, vh):
    """Causal attention of the cache-free forward: the GQA K/V heads
    repeated (``jnp.repeat(..., axis=1)``), then ``flash_attention`` (K1 at
    T >= 256 on the card). Returns the context [B, T, H * hd]."""
    rep = cfg.num_heads // cfg.num_kv_heads
    if rep > 1:
        kh = kh.repeat_interleave(rep, dim=1)
        vh = vh.repeat_interleave(rep, dim=1)
    if cfg.attn_impl in ("ring", "ulysses") and cfg.sp_mesh is not None:
        raise MXNetError(f"{cfg.attn_impl} sequence-parallel attention (sp_mesh) "
                         + _NOT_PORTED)
    return _context(flash_attention(qh, kh, vh, True, None))


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        hd, d, dt = cfg.hd, cfg.hidden_size, cfg.dtype
        self.q_proj = Dense(cfg.num_heads * hd, d, use_bias=False, device=device, dtype=dt)
        self.k_proj = Dense(cfg.num_kv_heads * hd, d, use_bias=False, device=device, dtype=dt)
        self.v_proj = Dense(cfg.num_kv_heads * hd, d, use_bias=False, device=device, dtype=dt)
        self.o_proj = Dense(d, cfg.num_heads * hd, use_bias=False, device=device, dtype=dt)

    def _project(self, x, positions):
        return _heads(self.cfg, self.q_proj(x), self.k_proj(x), self.v_proj(x), positions)

    def forward(self, x):
        T = x.shape[1]
        qh, kh, vh = self._project(x, torch.arange(T, device=x.device))
        return self.o_proj(_full_attention(self.cfg, qh, kh, vh))

    def forward_cached(self, x, pos, k_cache, v_cache):
        """Incremental forward against the [B, n_kv, L, hd] KV caches
        (written in place): returns (out, k_cache, v_cache)."""
        cfg = self.cfg
        qh, kh, vh = self._project(x, _decode_positions(pos, x.shape[1], x.device))
        o, k_cache, v_cache = _cached_attention(qh, kh, vh, k_cache, v_cache, pos,
                                                cfg.num_heads // cfg.num_kv_heads)
        return self.o_proj(_context(o)), k_cache, v_cache

    def forward_cached_paged(self, x, pos, block_table, k_pages, v_pages):
        """Incremental forward against the shared [NP + 1, n_kv, ps, hd]
        page pools through the block table (written in place)."""
        cfg = self.cfg
        qh, kh, vh = self._project(x, _decode_positions(pos, x.shape[1], x.device))
        o, k_pages, v_pages = _paged_attention(qh, kh, vh, k_pages, v_pages, block_table,
                                               pos, cfg.num_heads // cfg.num_kv_heads)
        return self.o_proj(_context(o)), k_pages, v_pages


class LlamaMLP(nn.Module):
    """SwiGLU: ``down(silu(gate(x)) * up(x))``."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        d, f, dt = cfg.hidden_size, cfg.intermediate_size, cfg.dtype
        self.gate_proj = Dense(f, d, use_bias=False, device=device, dtype=dt)
        self.up_proj = Dense(f, d, use_bias=False, device=device, dtype=dt)
        self.down_proj = Dense(d, f, use_bias=False, device=device, dtype=dt)

    def forward(self, x):
        return self.down_proj(npx.silu(self.gate_proj(x)) * self.up_proj(x))


def moe_capacity(cfg: LlamaConfig, n_tokens: int) -> int:
    """Slots per expert for ``n_tokens`` tokens: ``ceil(k N / E * factor)``
    in Python floats, at least 1 (the JAX package's formula)."""
    k, E = cfg.num_experts_per_tok, cfg.num_experts
    return max(int(math.ceil(k * n_tokens / E * cfg.moe_capacity_factor)), 1)


def moe_route(gate_logits, k: int, capacity: int):
    """Top-k routing with capacity (Mesh-TF / Switch dense dispatch), step
    for step the JAX package's ``LlamaMoE``: softmax of the [N, E] router
    logits in f32, then k rounds of ``argmax`` over the gates not yet taken
    (the first index on ties, as ``jnp.argmax``); a pair's slot is its
    expert's running count (``cumsum`` of the one-hots offset by the
    experts' kept counts), and a pair at or past ``capacity`` is dropped.
    Returns ``(dispatch, combine, idx, slot, keep)``: dispatch and combine
    [N, E, C] f32 (combine normalized over each token's kept pairs by
    ``max(sum, 1e-9)``, so a token with every pair dropped combines to 0),
    and per round [k, N] the expert index, the slot and the keep flag.
    Gradients reach the logits through the gate values and the
    normalization; none flows through ``argmax`` or the one-hots."""
    N, E = gate_logits.shape
    gates = torch.softmax(gate_logits.float(), dim=-1)
    dev = gates.device
    dispatch = torch.zeros(N, E, capacity, device=dev)
    combine = torch.zeros(N, E, capacity, device=dev)
    counts = torch.zeros(E, device=dev)
    remaining = gates.detach()
    idxs, slots, keeps = [], [], []
    for _ in range(k):
        idx = torch.argmax(remaining, dim=1)
        onehot = torch.nn.functional.one_hot(idx, E).float()
        pos = torch.cumsum(onehot, dim=0) - 1 + counts[None, :]
        pos_tok = (pos * onehot).sum(dim=1)
        keep = (pos_tok < capacity).float()
        gate_val = (gates * onehot).sum(dim=1)
        slot = pos_tok.clamp(0, capacity - 1).long()
        disp = (onehot[:, :, None]
                * torch.nn.functional.one_hot(slot, capacity).float()[:, None, :]
                * keep[:, None, None])
        dispatch = dispatch + disp
        combine = combine + disp * gate_val[:, None, None]
        counts = counts + (onehot * keep[:, None]).sum(dim=0)
        remaining = remaining * (1.0 - onehot)
        idxs.append(idx)
        slots.append(pos_tok.long())
        keeps.append(keep.bool())
    denom = combine.sum(dim=(1, 2), keepdim=True)
    combine = combine / denom.clamp_min(1e-9)
    return dispatch, combine, torch.stack(idxs), torch.stack(slots), torch.stack(keeps)


class LlamaMoE(nn.Module):
    """Top-k routed MoE with capacity-limited dense dispatch (the JAX
    package's ``LlamaMoE``): a bias-free router ``Dense(E)`` and rank-3
    expert weights ``w_gate``, ``w_up`` [E, d, f] and ``w_down`` [E, f, d]
    in the JAX layout (not Dense's (out, in)), so ``interop`` copies them
    as they are. The JAX package initializes them with ``StackedXavier(
    factor_type="in", magnitude=2.0)``; here :meth:`LlamaForCausalLM.
    init_weights` draws them as it draws every other matrix.

    The forward routes with :func:`moe_route`, gathers each expert's slots
    with an f32 ``einsum`` over the dispatch tensor, runs the SwiGLU
    experts in the weights' dtype as batched products, and combines the
    f32 expert outputs. The products are plain ``torch.einsum`` calls, as
    the JAX package computes them outside any Pallas kernel."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        E, d, f, dt = cfg.num_experts, cfg.hidden_size, cfg.intermediate_size, cfg.dtype
        self.router = Dense(E, d, use_bias=False, device=device, dtype=dt)
        for name, shape in (("w_gate", (E, d, f)), ("w_up", (E, d, f)),
                            ("w_down", (E, f, d))):
            setattr(self, name, nn.Parameter(torch.zeros(shape, device=device, dtype=dt)))

    def forward(self, x):
        cfg = self.cfg
        B, T, d = x.shape
        N = B * T
        capacity = moe_capacity(cfg, N)
        gate_logits = self.router(x).reshape(N, cfg.num_experts)
        dispatch, combine, *_ = moe_route(gate_logits, cfg.num_experts_per_tok, capacity)
        expert_in = torch.einsum("nec,nd->ecd", dispatch, x.reshape(N, d).float())
        ein = expert_in.to(self.w_gate.dtype)
        h = (npx.silu(torch.einsum("ecd,edf->ecf", ein, self.w_gate))
             * torch.einsum("ecd,edf->ecf", ein, self.w_up))
        eout = torch.einsum("ecf,efd->ecd", h, self.w_down).float()
        y = torch.einsum("nec,ecd->nd", combine, eout)
        return y.reshape(B, T, d).to(x.dtype)


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, layer_idx: int, device=None):
        super().__init__()
        d, dt = cfg.hidden_size, cfg.dtype
        self.input_layernorm = RMSNorm(d, epsilon=cfg.rms_eps, device=device, dtype=dt)
        self.self_attn = LlamaAttention(cfg, device=device)
        self.post_attention_layernorm = RMSNorm(d, epsilon=cfg.rms_eps, device=device,
                                                dtype=dt)
        use_moe = cfg.num_experts > 0 and layer_idx % cfg.moe_every == 0
        self.mlp = LlamaMoE(cfg, device=device) if use_moe else LlamaMLP(cfg, device=device)

    def forward(self, x):
        x = x + self.self_attn(self.input_layernorm(x))
        return x + self.mlp(self.post_attention_layernorm(x))

    def forward_cached(self, x, pos, k_cache, v_cache):
        attn, kc, vc = self.self_attn.forward_cached(self.input_layernorm(x), pos,
                                                     k_cache, v_cache)
        x = x + attn
        return x + self.mlp(self.post_attention_layernorm(x)), kc, vc

    def forward_cached_paged(self, x, pos, block_table, k_pages, v_pages):
        attn, kp, vp = self.self_attn.forward_cached_paged(
            self.input_layernorm(x), pos, block_table, k_pages, v_pages)
        x = x + attn
        return x + self.mlp(self.post_attention_layernorm(x)), kp, vp


def _rms(x, w, eps):
    """The stacked decoder's RMS norm (JAX ``_rms``): normalized in f32,
    rounded to x's dtype, then scaled by ``w``."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def _stacked_mlp(p, x, eps):
    h = _rms(x, p["ln2"], eps)
    return x + (npx.silu(h @ p["wg"].T) * (h @ p["wu"].T)) @ p["wd"].T


def _stacked_qkv(cfg: LlamaConfig, p, x, positions):
    h = _rms(x, p["ln1"], cfg.rms_eps)
    return _heads(cfg, h @ p["wq"].T, h @ p["wk"].T, h @ p["wv"].T, positions)


def _stacked_layer(cfg: LlamaConfig, p, x):
    """One dense decoder layer as a function of its (unstacked) parameters."""
    T = x.shape[1]
    qh, kh, vh = _stacked_qkv(cfg, p, x, torch.arange(T, device=x.device))
    x = x + _full_attention(cfg, qh, kh, vh) @ p["wo"].T
    return _stacked_mlp(p, x, cfg.rms_eps)


def _stacked_layer_cached(cfg: LlamaConfig, p, x, pos, k_cache, v_cache):
    """Cached variant of :func:`_stacked_layer` against one layer's [B,
    n_kv, L, hd] cache slice (written in place)."""
    qh, kh, vh = _stacked_qkv(cfg, p, x, _decode_positions(pos, x.shape[1], x.device))
    o, kc, vc = _cached_attention(qh, kh, vh, k_cache, v_cache, pos,
                                  cfg.num_heads // cfg.num_kv_heads)
    x = x + _context(o) @ p["wo"].T
    return _stacked_mlp(p, x, cfg.rms_eps), kc, vc


def _stacked_layer_paged(cfg: LlamaConfig, p, x, pos, block_table, k_pages, v_pages):
    """Paged variant of :func:`_stacked_layer_cached` against one layer's
    [num_pages + 1, n_kv, ps, hd] pool slice (the block table is shared by
    every layer)."""
    qh, kh, vh = _stacked_qkv(cfg, p, x, _decode_positions(pos, x.shape[1], x.device))
    o, kp, vp = _paged_attention(qh, kh, vh, k_pages, v_pages, block_table, pos,
                                 cfg.num_heads // cfg.num_kv_heads)
    x = x + _context(o) @ p["wo"].T
    return _stacked_mlp(p, x, cfg.rms_eps), kp, vp


class LlamaStackedDecoder(nn.Module):
    """All decoder layers as stacked [num_layers, ...] parameters (``ln1``,
    ``ln2`` [N, d]; ``wq``, ``wk``, ``wv``, ``wo``, ``wg``, ``wu``, ``wd``
    [N, out, in]), run by a loop over the layer axis. Its caches are
    [num_layers, B, n_kv, L, hd] and its pools [num_layers, pages, n_kv,
    ps, hd]; layer i reads and writes slice i in place. Dense layers only;
    the Dense-free layers keep their float weights under ``quantize_net``,
    as in the JAX package."""

    _WEIGHTS = ("wq", "wk", "wv", "wo", "wg", "wu", "wd")

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        if cfg.num_experts > 0:
            raise MXNetError("stacked decoder does not support MoE layers")
        if cfg.attn_impl != "flash" or cfg.sp_mesh is not None:
            raise MXNetError(
                "stacked decoder supports flash attention only; ring/ulysses "
                "sequence parallelism requires the per-layer (non-stacked) "
                "decoder")
        self.cfg = cfg
        N, d, f, hd = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size, cfg.hd
        shapes = {
            "ln1": (N, d), "ln2": (N, d),
            "wq": (N, cfg.num_heads * hd, d),
            "wk": (N, cfg.num_kv_heads * hd, d),
            "wv": (N, cfg.num_kv_heads * hd, d),
            "wo": (N, d, cfg.num_heads * hd),
            "wg": (N, f, d), "wu": (N, f, d), "wd": (N, d, f),
        }
        for name, shape in shapes.items():
            make = torch.ones if name.startswith("ln") else torch.zeros
            setattr(self, name, nn.Parameter(make(shape, device=device, dtype=cfg.dtype)))

    def _layer(self, i):
        return {n: getattr(self, n)[i] for n in ("ln1", "ln2") + self._WEIGHTS}

    def _check_pp(self):
        cfg = self.cfg
        if cfg.pp_mesh is not None:
            raise MXNetError("the GPipe schedule of the stacked decoder (pp_mesh) "
                             + _NOT_PORTED)

    def forward(self, x):
        self._check_pp()
        for i in range(self.cfg.num_layers):
            x = _stacked_layer(self.cfg, self._layer(i), x)
        return x

    def forward_cached(self, x, pos, k_caches, v_caches):
        """Incremental forward through every layer against the stacked
        caches (written in place)."""
        for i in range(self.cfg.num_layers):
            x, _, _ = _stacked_layer_cached(self.cfg, self._layer(i), x, pos,
                                            k_caches[i], v_caches[i])
        return x, k_caches, v_caches

    def forward_cached_paged(self, x, pos, block_table, k_pages, v_pages):
        """Paged incremental forward against the stacked pools (written in
        place); every layer shares the block table."""
        for i in range(self.cfg.num_layers):
            x, _, _ = _stacked_layer_paged(self.cfg, self._layer(i), x, pos, block_table,
                                           k_pages[i], v_pages[i])
        return x, k_pages, v_pages


class LlamaModel(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = Embedding(cfg.vocab_size, cfg.hidden_size, device=device,
                                      dtype=cfg.dtype)
        if cfg.stacked or cfg.pp_mesh is not None:
            self.layers = LlamaStackedDecoder(cfg, device=device)
        else:
            self.layers = nn.ModuleList(LlamaDecoderLayer(cfg, i, device=device)
                                        for i in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, epsilon=cfg.rms_eps, device=device,
                            dtype=cfg.dtype)

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.weight.device

    def forward(self, input_ids):
        x = self.embed_tokens(input_ids)
        if isinstance(self.layers, LlamaStackedDecoder):
            x = self.layers(x)
        else:
            for layer in self.layers:
                x = layer(x)
        return self.norm(x)

    def cache_spec(self, batch: int, max_len: int):
        """[(shape, dtype)] for the flat KV cache. Per-layer decoder: k0,
        v0, k1, v1, ... of [B, n_kv, L, hd]; stacked decoder: one stacked K
        and one stacked V of [num_layers, B, n_kv, L, hd]."""
        cfg = self.cfg
        if cfg.pp_mesh is not None:
            raise MXNetError("KV-cache decode is not supported under "
                             "pipeline parallelism; use the cache-free path")
        if cfg.num_experts > 0:
            raise MXNetError("KV-cache decode is not supported for MoE "
                             "configs; use the cache-free path")
        if cfg.sp_mesh is not None:
            raise MXNetError("KV-cache decode is not supported with "
                             "sequence-parallel attention (sp_mesh); use "
                             "the cache-free path")
        shp = (batch, cfg.num_kv_heads, max_len, cfg.hd)
        if cfg.stacked:
            return [((cfg.num_layers,) + shp, cfg.dtype)] * 2
        return [(shp, cfg.dtype)] * (2 * cfg.num_layers)

    def cache_spec_paged(self, num_pages: int, page_size: int):
        """[(shape, dtype)] for the PAGED KV pools: per-layer k0, v0, ... of
        [num_pages, n_kv, page_size, hd]; stacked one K and one V of
        [num_layers, num_pages, n_kv, page_size, hd]. The caller passes the
        physical page count (the engine adds its sink page). The refusals
        of :meth:`cache_spec`."""
        self.cache_spec(1, page_size)
        cfg = self.cfg
        shp = (num_pages, cfg.num_kv_heads, page_size, cfg.hd)
        if cfg.stacked:
            return [((cfg.num_layers,) + shp, cfg.dtype)] * 2
        return [(shp, cfg.dtype)] * (2 * cfg.num_layers)

    def forward_cached(self, input_ids, pos, *caches):
        x = self.embed_tokens(input_ids)
        if isinstance(self.layers, LlamaStackedDecoder):
            x, k, v = self.layers.forward_cached(x, pos, caches[0], caches[1])
            return (self.norm(x), k, v)
        new = []
        for i, layer in enumerate(self.layers):
            x, kc, vc = layer.forward_cached(x, pos, caches[2 * i], caches[2 * i + 1])
            new += [kc, vc]
        return (self.norm(x), *new)

    def forward_cached_paged(self, input_ids, pos, block_table, *pools):
        x = self.embed_tokens(input_ids)
        table = torch.as_tensor(block_table, dtype=torch.int32, device=x.device)
        if isinstance(self.layers, LlamaStackedDecoder):
            x, k, v = self.layers.forward_cached_paged(x, pos, table, pools[0], pools[1])
            return (self.norm(x), k, v)
        new = []
        for i, layer in enumerate(self.layers):
            x, kp, vp = layer.forward_cached_paged(x, pos, table, pools[2 * i],
                                                   pools[2 * i + 1])
            new += [kp, vp]
        return (self.norm(x), *new)


class LlamaForCausalLM(nn.Module):
    """Llama LM, tied (``cfg.tie_embeddings``) or with its own ``lm_head``.
    Built on ``device`` (default: the CUDA card; ``device='cpu'`` for the
    plain path) with zero weights: call :meth:`init_weights` or load them
    (``interop.params_from_numpy``). Starts in eval mode."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        dev = resolve(device)
        self.cfg = cfg
        self.model = LlamaModel(cfg, device=dev)
        self.lm_head = (None if cfg.tie_embeddings else
                        Dense(cfg.vocab_size, cfg.hidden_size, use_bias=False, device=dev,
                              dtype=cfg.dtype))
        self._q_lm_head = None
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.model.device

    @torch.no_grad()
    def init_weights(self, seed: int = 0, std: float = 0.02):
        """Random weights from ``seed`` on the model's own device: N(0,
        std) matrices and embeddings, unit RMSNorm gains. One
        ``torch.Generator`` of that device draws the parameters in their
        ``named_parameters()`` order, each in its own dtype (Llama-3-8B's
        8.03 B values are drawn on the card, never on the host)."""
        g = torch.Generator(device=self.device).manual_seed(int(seed))
        for name, p in self.named_parameters():
            if name.endswith(("gamma", ".ln1", ".ln2")):
                p.fill_(1.0)
            else:
                p.normal_(0.0, std, generator=g)
        return self

    def forward(self, input_ids):
        return self._logits(self.model(input_ids))

    def _logits(self, h):
        """The head. Untied: ``lm_head`` (a QuantizedDense after
        ``quantize_net``). Tied with a quantized table and at most
        ``gemv_max_m()`` rows: the table streams through K3 (int8) or K4
        (packed int4, chosen by its uint8 dtype) and the logits are sliced
        back to the vocab in h's dtype, unless autograd records a training
        forward (train mode, grad enabled, outside ``predict_mode``); then,
        and without a table, h multiplies the embedding table in their
        promoted dtype."""
        if self.lm_head is not None:
            return self.lm_head(h)
        from ..ops.int8_gemv import gemv_max_m, weight_matmul
        q = self._q_lm_head
        lead = h.shape[:-1]
        n = h.numel() // h.shape[-1]
        # K3/K4 have no backward: a recorded training forward differentiates
        # the float table; every serving path runs under no_grad
        recording = self.training and torch.is_grad_enabled() and not is_predicting()
        if q is not None and not recording and n <= gemv_max_m():
            w_q, scale, V = q
            y = weight_matmul(h.reshape(n, h.shape[-1]), w_q, scale)
            return y.reshape(*lead, w_q.shape[0])[..., :V].to(h.dtype)
        w = self.model.embed_tokens.weight
        dt = torch.promote_types(h.dtype, w.dtype)
        return h.to(dt) @ w.to(dt).T

    # the serving engine's name for the head of a prefill's last row
    _lm_head = _logits

    def head_weights(self):
        """(table, scales, vocab) of the quantized tied head for the fused
        LM-head sampler, or None (an untied head keeps the unfused path:
        the Dense owns the weight)."""
        if self.lm_head is not None:
            return None
        return self._q_lm_head

    def cache_spec(self, batch: int, max_len: int):
        return self.model.cache_spec(batch, max_len)

    def cache_spec_paged(self, num_pages: int, page_size: int):
        return self.model.cache_spec_paged(num_pages, page_size)

    def new_caches(self, batch: int, max_len: int):
        """Zeroed KV caches of :meth:`cache_spec` on the model's device."""
        return [torch.zeros(s, dtype=d, device=self.device)
                for s, d in self.cache_spec(batch, max_len)]

    def new_pools(self, num_pages: int, page_size: int):
        """Zeroed page pools of :meth:`cache_spec_paged` on the model's
        device (``num_pages`` physical pages, sink included)."""
        return [torch.zeros(s, dtype=d, device=self.device)
                for s, d in self.cache_spec_paged(num_pages, page_size)]

    @torch.no_grad()
    def forward_cached(self, input_ids, pos, *caches):
        h, *caches = self.forward_cached_hidden(input_ids, pos, *caches)
        return (self._logits(h), *caches)

    @torch.no_grad()
    def forward_cached_paged(self, input_ids, pos, block_table, *pools):
        h, *pools = self.forward_cached_paged_hidden(input_ids, pos, block_table, *pools)
        return (self._logits(h), *pools)

    @torch.no_grad()
    @predict_mode()
    def forward_cached_hidden(self, input_ids, pos, *caches):
        """Incremental forward returning the final (normed) hidden state
        [B, T, D] and the caches, written in place; ``pos`` is an int or a
        [B] tensor. Per-layer and stacked decoders alike."""
        return self.model.forward_cached(input_ids, _step_pos(input_ids, pos), *caches)

    @torch.no_grad()
    @predict_mode()
    def forward_cached_paged_hidden(self, input_ids, pos, block_table, *pools):
        """Paged variant of :meth:`forward_cached_hidden` over the page
        pools and the [B, max_pages] block table."""
        return self.model.forward_cached_paged(input_ids, _step_pos(input_ids, pos),
                                               block_table, *pools)


def _step_pos(input_ids, pos):
    """A T=1 step's int ``pos`` as one [B] device vector (instead of one
    host copy per layer)."""
    B, T = input_ids.shape
    if T == 1 and not torch.is_tensor(pos):
        return torch.full((B,), int(pos), dtype=torch.int32, device=input_ids.device)
    return pos
