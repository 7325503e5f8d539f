"""GPT-2-family decoder LM: learned positions, pre-LN, tanh-GeLU MLP,
causal attention (counterpart of ``mxnet_tpu/models/gpt.py``).

The full-sequence :meth:`GPTModel.forward` runs each block's causal
attention through ``ops/attention.flash_attention``: K1 forward and K2
backward at T >= 256 (the training path), the plain path below that.
``GPTConfig.dtype`` is the dtype of the Dense and Embedding parameters
and of the KV caches and page pools (bf16 for the training headline and
the quantized serving headlines); LayerNorm stays f32, as in JAX, so in a
bf16 model block 0 takes the bf16 embedding sum and every later block,
the final LayerNorm and the head see f32. The
serving path is the cached one: :meth:`GPTModel.forward_cached` /
:meth:`~GPTModel.forward_cached_hidden`, whose T=1 steps run each block as
one K5 launch once :meth:`GPTModel.enable_fused_decode` packed it, and
its paged counterpart :meth:`~GPTModel.forward_cached_paged` /
:meth:`~GPTModel.forward_cached_paged_hidden` over the shared page pools
and a block table, one K6 or K7 launch per block.

Dropout (``GPTConfig.dropout``, 0.1 by default) is active in training
mode: 25 sites for GPT-2 small, each drawing one key of the stream in the
JAX package's order (the embedding's ``drop``, then per block the
``attn_out`` site and the ``mlp_proj`` site). The cached entry points run
in ``autograd.predict_mode``: they serve, and never drop.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from .. import numpy_extension as npx
from ..autograd import predict_mode
from ..device import resolve
from ..gluon.nn import Dense, Dropout, Embedding, LayerNorm
from ..ops.attention import flash_attention

__all__ = ["GPTConfig", "GPTModel", "GPT2_SMALL", "GPT_TINY"]


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 1024
    dropout: float = 0.1
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.float32


GPT2_SMALL = GPTConfig()
GPT_TINY = GPTConfig(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
                     max_position_embeddings=128)


class GPTBlock(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        d = cfg.hidden_size
        self.ln_1 = LayerNorm(d, epsilon=cfg.layer_norm_eps, device=device)
        dt = cfg.dtype
        self.attn_qkv = Dense(3 * d, d, device=device, dtype=dt)
        self.attn_out = Dense(d, d, device=device, dtype=dt)
        self.ln_2 = LayerNorm(d, epsilon=cfg.layer_norm_eps, device=device)
        self.mlp_fc = Dense(4 * d, d, device=device, dtype=dt)
        self.mlp_proj = Dense(d, 4 * d, device=device, dtype=dt)
        self.dropout = Dropout(cfg.dropout)
        self.heads = cfg.num_heads
        self._fused_pack = None

    def _split_heads(self, t, B, T):
        hd = t.shape[-1] // self.heads
        return t.reshape(B, T, self.heads, hd).transpose(1, 2)

    def forward(self, x):
        B, T, d = x.shape
        q, k, v = torch.split(self.attn_qkv(self.ln_1(x)), d, dim=-1)
        o = flash_attention(self._split_heads(q, B, T),
                            self._split_heads(k, B, T),
                            self._split_heads(v, B, T), True, None)
        x = x + self.dropout(self.attn_out(o.transpose(1, 2).reshape(B, T, d)))
        h = npx.gelu(self.mlp_fc(self.ln_2(x)))
        return x + self.dropout(self.mlp_proj(h))

    def forward_cached(self, x, pos, k_cache, v_cache):
        """Incremental forward against the [B, H, L, hd] KV caches (written
        in place). A T=1 step of a block packed by ``enable_fused_decode``
        runs as ONE K5 launch when the Hopper gate accepts the shape;
        everything else takes the unfused layers."""
        from ..ops.fused_block_gemv import fusable, fused_block_decode
        from .llama import _cached_attention
        B, T, d = x.shape
        pack = self._fused_pack
        if pack is not None and T == 1 and fusable(B, d, self.heads, k_cache.shape[2],
                                                   pack["blocks"], k_cache.element_size()):
            return fused_block_decode(x, pos, k_cache, v_cache, pack)
        q, k, v = torch.split(self.attn_qkv(self.ln_1(x)), d, dim=-1)
        o, k_cache, v_cache = _cached_attention(
            self._split_heads(q, B, T), self._split_heads(k, B, T),
            self._split_heads(v, B, T), k_cache, v_cache, pos)
        x = x + self.dropout(self.attn_out(o.transpose(1, 2).reshape(B, T, d)))
        h = npx.gelu(self.mlp_fc(self.ln_2(x)))
        return x + self.dropout(self.mlp_proj(h)), k_cache, v_cache

    def forward_cached_paged(self, x, pos, block_table, k_pages, v_pages):
        """Incremental forward against the shared [NP + 1, H, ps, hd] page
        pools through the [B, max_pages] block table (written in place). A
        T=1 step of a packed block runs as ONE launch of K6 when its
        shared-memory gate accepts the context length, of K7 (pages
        streamed) beyond that; shapes neither gate accepts, and T > 1,
        take the unfused layers."""
        from ..ops.fused_block_gemv import (fusable_paged, fusable_paged_dma,
                                            fused_block_decode_paged)
        from .llama import _paged_attention
        B, T, d = x.shape
        pack = self._fused_pack
        if pack is not None and T == 1:
            gate = (B, d, self.heads, k_pages.shape[0], k_pages.shape[2],
                    block_table.shape[1], k_pages.element_size())
            blocks = pack["blocks"]
            if fusable_paged(*gate, blocks=blocks) or fusable_paged_dma(*gate, blocks=blocks):
                return fused_block_decode_paged(x, pos, block_table, k_pages,
                                                v_pages, pack)
        q, k, v = torch.split(self.attn_qkv(self.ln_1(x)), d, dim=-1)
        o, k_pages, v_pages = _paged_attention(
            self._split_heads(q, B, T), self._split_heads(k, B, T),
            self._split_heads(v, B, T), k_pages, v_pages, block_table, pos)
        x = x + self.dropout(self.attn_out(o.transpose(1, 2).reshape(B, T, d)))
        h = npx.gelu(self.mlp_fc(self.ln_2(x)))
        return x + self.dropout(self.mlp_proj(h)), k_pages, v_pages


class GPTModel(nn.Module):
    """GPT-2 LM with a tied head. Built on ``device`` (default: the CUDA
    card; ``device='cpu'`` for the plain path) with zero weights: call
    :meth:`init_weights` or load them (``interop.params_from_numpy``).
    Parameters are trainable. The model starts in eval mode, as the JAX
    package's train mode is off outside ``autograd.record`` and
    ``TrainStep``; ``TrainStep`` and ``.train()`` switch it on, and with
    it dropout."""

    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        dev = resolve(device)
        self.cfg = cfg
        self.wte = Embedding(cfg.vocab_size, cfg.hidden_size, device=dev,
                             dtype=cfg.dtype)
        self.wpe = Embedding(cfg.max_position_embeddings, cfg.hidden_size,
                             device=dev, dtype=cfg.dtype)
        self.drop = Dropout(cfg.dropout)
        self.blocks = nn.ModuleList(GPTBlock(cfg, device=dev)
                                    for _ in range(cfg.num_layers))
        self.ln_f = LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_eps,
                              device=dev)
        self._q_lm_head = None
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.wte.weight.device

    @torch.no_grad()
    def init_weights(self, seed: int = 0, std: float = 0.02):
        """Random weights from ``seed``: N(0, std) matrices and embeddings,
        N(0, std) biases, unit LayerNorm gains. Drawn on the CPU through a
        ``torch.Generator`` and copied over (then cast to the parameter's
        dtype), so a model on the card and one on the CPU built from the
        same seed hold the same weights."""
        g = torch.Generator(device="cpu").manual_seed(int(seed))
        for name, p in self.named_parameters():
            if name.endswith("gamma"):
                p.fill_(1.0)
            elif name.endswith("beta"):
                p.zero_()
            else:
                p.copy_(torch.randn(p.shape, generator=g) * std)
        return self

    def forward(self, input_ids):
        T = input_ids.shape[1]
        pos = torch.arange(T, device=input_ids.device)
        x = self.drop(self.wte(input_ids) + self.wpe(pos))
        for blk in self.blocks:
            x = blk(x)
        return self._lm_head(self.ln_f(x))

    def cache_spec(self, batch: int, max_len: int):
        """[(shape, dtype)] for the flat KV cache: k0, v0, k1, v1, ..."""
        cfg = self.cfg
        shp = (batch, cfg.num_heads, max_len, cfg.hidden_size // cfg.num_heads)
        return [(shp, cfg.dtype)] * (2 * cfg.num_layers)

    def new_caches(self, batch: int, max_len: int):
        """Zeroed KV caches of :meth:`cache_spec` on the model's device."""
        return [torch.zeros(s, dtype=d, device=self.device)
                for s, d in self.cache_spec(batch, max_len)]

    def cache_spec_paged(self, num_pages: int, page_size: int):
        """[(shape, dtype)] for the PAGED KV pools (serve/paging): k0, v0,
        ... of [num_pages, H, page_size, hd]. The caller passes the
        physical page count (the engine adds its sink page)."""
        cfg = self.cfg
        shp = (num_pages, cfg.num_heads, page_size,
               cfg.hidden_size // cfg.num_heads)
        return [(shp, cfg.dtype)] * (2 * cfg.num_layers)

    def new_pools(self, num_pages: int, page_size: int):
        """Zeroed page pools of :meth:`cache_spec_paged` on the model's
        device (``num_pages`` physical pages, sink included)."""
        return [torch.zeros(s, dtype=d, device=self.device)
                for s, d in self.cache_spec_paged(num_pages, page_size)]

    @torch.no_grad()
    def forward_cached(self, input_ids, pos, *caches):
        hidden, *caches = self.forward_cached_hidden(input_ids, pos, *caches)
        return (self._lm_head(hidden), *caches)

    @torch.no_grad()
    def forward_cached_paged(self, input_ids, pos, block_table, *pools):
        hidden, *pools = self.forward_cached_paged_hidden(input_ids, pos,
                                                          block_table, *pools)
        return (self._lm_head(hidden), *pools)

    @torch.no_grad()
    @predict_mode()
    def forward_cached_paged_hidden(self, input_ids, pos, block_table, *pools):
        """Paged variant of :meth:`forward_cached_hidden`: the per-layer
        page pools (written in place) and the [B, max_pages] block table
        replace the per-slot caches. Positions of a padded prefill tail
        past the last learned position are clamped to it: those rows are
        discarded and their K/V rows go to the sink or stay masked (the
        JAX package's gather reads NaN there)."""
        from .llama import _decode_positions
        B, T = input_ids.shape
        dev = input_ids.device
        if T == 1 and not torch.is_tensor(pos):
            pos = torch.full((B,), int(pos), dtype=torch.int32, device=dev)
        p = _decode_positions(pos, T, device=dev)
        positions = p[None, :].expand(B, T) if p.dim() == 1 else p
        positions = positions.clamp(max=self.cfg.max_position_embeddings - 1)
        table = torch.as_tensor(block_table, dtype=torch.int32, device=dev)
        x = self.drop(self.wte(input_ids) + self.wpe(positions))
        new_pools = []
        for i, blk in enumerate(self.blocks):
            x, kp, vp = blk.forward_cached_paged(x, pos, table, pools[2 * i],
                                                 pools[2 * i + 1])
            new_pools += [kp, vp]
        return (self.ln_f(x), *new_pools)

    @torch.no_grad()
    @predict_mode()
    def forward_cached_hidden(self, input_ids, pos, *caches):
        """Incremental forward returning the final hidden state [B, T, D]
        (the fused LM-head sampler folds the head into token selection).
        ``pos`` is an int (whole batch at one offset) or a [B] tensor. The
        cached path serves only: it writes the KV caches in place and
        builds no autograd graph."""
        from .llama import _decode_positions
        B, T = input_ids.shape
        if T == 1 and not torch.is_tensor(pos):
            # one device vector per step instead of one copy per layer
            pos = torch.full((B,), int(pos), dtype=torch.int32,
                             device=input_ids.device)
        p = _decode_positions(pos, T, device=input_ids.device)
        positions = p[None, :].expand(B, T) if p.dim() == 1 else p
        x = self.drop(self.wte(input_ids) + self.wpe(positions))
        new_caches = []
        for i, blk in enumerate(self.blocks):
            x, kc, vc = blk.forward_cached(x, pos, caches[2 * i], caches[2 * i + 1])
            new_caches += [kc, vc]
        return (self.ln_f(x), *new_caches)

    def head_weights(self):
        """(table, scales, vocab) of the quantized tied head: an int8 table
        [Vp, D] with per-row scales [Vp], or a packed int4 table [Vp, D/2]
        uint8 with block scales [Vp, D/block]; None when the head is not
        quantized."""
        return self._q_lm_head

    def enable_fused_decode(self) -> int:
        """Opt every block whose four Dense layers are QuantizedDense of one
        weight lane (int8, or packed int4) into the one-launch block decode
        kernel. Returns the number of blocks packed."""
        from ..ops.fused_block_gemv import pack_gpt_block
        n = 0
        for blk in self.blocks:
            blk._fused_pack = pack_gpt_block(blk, eps=self.cfg.layer_norm_eps)
            n += blk._fused_pack is not None
        return n

    def disable_fused_decode(self):
        for blk in self.blocks:
            blk._fused_pack = None

    def _lm_head(self, x):
        """Tied LM head. With a quantized table and at most ``gemv_max_m()``
        rows, the table streams through K3 (int8) or K4 (packed int4,
        chosen by its uint8 dtype) and the logits are sliced back to the
        vocab; otherwise the hidden state multiplies the embedding table
        in their promoted dtype (f32 hidden states of a bf16 model, as the
        JAX package promotes them)."""
        from ..ops.int8_gemv import gemv_max_m, weight_matmul
        q = self._q_lm_head
        lead = x.shape[:-1]
        n = x.numel() // x.shape[-1]
        if q is not None and n <= gemv_max_m():
            w_q, scale, V = q
            y = weight_matmul(x.reshape(n, x.shape[-1]), w_q, scale)
            return y.reshape(*lead, w_q.shape[0])[..., :V].to(x.dtype)
        w = self.wte.weight
        dt = torch.promote_types(x.dtype, w.dtype)
        return x.to(dt) @ w.to(dt).T
