"""GPT-2-family decoder LM: learned positions, pre-LN, tanh-GeLU MLP,
causal attention (counterpart of ``mxnet_tpu/models/gpt.py``).

The full-sequence :meth:`GPTModel.forward` uses plain PyTorch causal
attention (``ops/attention._jnp_reference`` of the JAX package): flash
attention (K1/K2) comes with the training slice. The serving path is the
cached one: :meth:`GPTModel.forward_cached` /
:meth:`~GPTModel.forward_cached_hidden`, whose T=1 steps run each block as
one K5 launch once :meth:`GPTModel.enable_fused_decode` packed it.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from .. import numpy_extension as npx
from ..device import resolve
from ..gluon.nn import Dense, Dropout, Embedding, LayerNorm

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


GPT2_SMALL = GPTConfig()
GPT_TINY = GPTConfig(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
                     max_position_embeddings=128)


def _causal_attention(q, k, v):
    """Plain causal attention over [B, H, T, hd] (the JAX package's
    ``ops/attention._jnp_reference``)."""
    T, S = q.shape[2], k.shape[2]
    s = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float()) / math.sqrt(q.shape[-1])
    mask = torch.ones(T, S, dtype=torch.bool, device=q.device).tril(S - T)
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhts,bhsd->bhtd", p, v.float()).to(q.dtype)


class GPTBlock(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        d = cfg.hidden_size
        self.ln_1 = LayerNorm(d, epsilon=cfg.layer_norm_eps, device=device)
        self.attn_qkv = Dense(3 * d, d, device=device)
        self.attn_out = Dense(d, d, device=device)
        self.ln_2 = LayerNorm(d, epsilon=cfg.layer_norm_eps, device=device)
        self.mlp_fc = Dense(4 * d, d, device=device)
        self.mlp_proj = Dense(d, 4 * d, device=device)
        self.dropout = Dropout(cfg.dropout)
        self.heads = cfg.num_heads
        self._fused_pack = None

    def _split_heads(self, t, B, T):
        hd = t.shape[-1] // self.heads
        return t.reshape(B, T, self.heads, hd).transpose(1, 2)

    def forward(self, x):
        B, T, d = x.shape
        q, k, v = torch.split(self.attn_qkv(self.ln_1(x)), d, dim=-1)
        o = _causal_attention(self._split_heads(q, B, T),
                              self._split_heads(k, B, T),
                              self._split_heads(v, B, T))
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
        if pack is not None and T == 1 and fusable(B, d, self.heads,
                                                   k_cache.shape[2]):
            return fused_block_decode(x, pos, k_cache, v_cache, pack)
        q, k, v = torch.split(self.attn_qkv(self.ln_1(x)), d, dim=-1)
        o, k_cache, v_cache = _cached_attention(
            self._split_heads(q, B, T), self._split_heads(k, B, T),
            self._split_heads(v, B, T), k_cache, v_cache, pos)
        x = x + self.dropout(self.attn_out(o.transpose(1, 2).reshape(B, T, d)))
        h = npx.gelu(self.mlp_fc(self.ln_2(x)))
        return x + self.dropout(self.mlp_proj(h)), k_cache, v_cache


class GPTModel(nn.Module):
    """GPT-2 LM with a tied head. Built on ``device`` (default: the CUDA
    card; ``device='cpu'`` for the plain path) with zero weights: call
    :meth:`init_weights` or load them (``interop.params_from_numpy``)."""

    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        dev = resolve(device)
        self.cfg = cfg
        self.wte = Embedding(cfg.vocab_size, cfg.hidden_size, device=dev)
        self.wpe = Embedding(cfg.max_position_embeddings, cfg.hidden_size,
                             device=dev)
        self.drop = Dropout(cfg.dropout)
        self.blocks = nn.ModuleList(GPTBlock(cfg, device=dev)
                                    for _ in range(cfg.num_layers))
        self.ln_f = LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_eps,
                              device=dev)
        self._q_lm_head = None
        self.requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return self.wte.weight.device

    @torch.no_grad()
    def init_weights(self, seed: int = 0, std: float = 0.02):
        """Random weights from ``seed``: N(0, std) matrices and embeddings,
        N(0, std) biases, unit LayerNorm gains. Drawn on the CPU through a
        ``torch.Generator`` and copied over, so a model on the card and one
        on the CPU built from the same seed hold the same weights."""
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
        return [(shp, torch.float32)] * (2 * cfg.num_layers)

    def new_caches(self, batch: int, max_len: int):
        """Zeroed KV caches of :meth:`cache_spec` on the model's device."""
        return [torch.zeros(s, dtype=d, device=self.device)
                for s, d in self.cache_spec(batch, max_len)]

    def forward_cached(self, input_ids, pos, *caches):
        hidden, *caches = self.forward_cached_hidden(input_ids, pos, *caches)
        return (self._lm_head(hidden), *caches)

    def forward_cached_hidden(self, input_ids, pos, *caches):
        """Incremental forward returning the final hidden state [B, T, D]
        (the fused LM-head sampler folds the head into token selection).
        ``pos`` is an int (whole batch at one offset) or a [B] tensor."""
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
        """(int8 table [Vp, D], scales [Vp], vocab) of the quantized tied
        head, or None when the head is not quantized."""
        return self._q_lm_head

    def enable_fused_decode(self) -> int:
        """Opt every block whose four Dense layers are int8 QuantizedDense
        into the one-launch block decode kernel. Returns the number of
        blocks packed."""
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
        rows, the int8 table streams through K3 and the logits are sliced
        back to the vocab; otherwise the f32 embedding table is used."""
        from ..ops.int8_gemv import gemv_max_m, int8_weight_matmul
        q = self._q_lm_head
        lead = x.shape[:-1]
        n = x.numel() // x.shape[-1]
        if q is not None and n <= gemv_max_m():
            w_q, scale, V = q
            y = int8_weight_matmul(x.reshape(n, x.shape[-1]), w_q, scale)
            return y.reshape(*lead, w_q.shape[0])[..., :V].to(x.dtype)
        return x @ self.wte.weight.T
