"""T5-style encoder-decoder transformer (counterpart of
``mxnet_tpu/models/t5.py``; Raffel et al. 2020): RMSNorm pre-norm without
biases, one relative-position bias table per stack added to every layer's
self-attention scores, a ReLU MLP, cross-attention in the decoder and the
tied head ``(h * d_model ** -0.5) @ shared.T``. Parameter names are the JAX
package's (``shared``, ``enc_rel_bias``, ``dec_rel_bias``, ``enc_{i}``,
``dec_{i}``, ``enc_final``, ``dec_final``).

Attention is plain f32 einsums and a softmax, as in the JAX package (the
additive position bias keeps it off the flash kernels), at scale 1 with no
1/sqrt(d); the causal mask is ``finfo(f32).min`` under the end-aligned
``tril(k=S-T)``. The bucket table is computed on the host in the JAX
package's f32 arithmetic (it equals JAX's exactly; a device log one ulp
away would flip buckets) and copied once per shape and device.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as onp
import torch

from .. import numpy_extension as npx
from ..gluon import nn
from ..gluon.block import HybridBlock
from ..gluon.parameter import Parameter
from ..ndarray import apply, apply_multi
from ..numpy_extension import _dtype_scalar

__all__ = ["T5Config", "T5Model", "T5_SMALL", "T5_TINY"]

_F32_MIN = torch.finfo(torch.float32).min


@dataclass
class T5Config:
    vocab_size: int = 32128
    d_model: int = 512
    d_ff: int = 2048
    num_layers: int = 6
    num_heads: int = 8
    relative_buckets: int = 32
    relative_max_distance: int = 128
    layer_norm_eps: float = 1e-6
    dropout: float = 0.0
    dtype: object = onp.float32


T5_SMALL = T5Config()
T5_TINY = T5Config(vocab_size=256, d_model=64, d_ff=128, num_layers=2,
                   num_heads=4, relative_buckets=8,
                   relative_max_distance=32)


def _relative_bucket(rel, num_buckets: int, max_dist: int, bidirectional: bool):
    """T5's bucket of each relative position ``rel`` (key minus query, an
    integer tensor): exact below ``max_exact``, log-spaced beyond, in f32
    as the JAX package computes it (the log of ``max_dist / max_exact`` in
    f64, rounded to f32), truncated to int."""
    ret = torch.zeros_like(rel)
    n = -rel
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).to(rel.dtype) * num_buckets
        n = n.abs()
    else:
        n = n.clamp_min(0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    denom = float(onp.float32(onp.log(max_dist / max_exact)))
    large = max_exact + (torch.log(n.float() / max_exact + 1e-6) / denom
                         * (num_buckets - max_exact)).to(torch.int32)
    large = large.clamp_max(num_buckets - 1).to(rel.dtype)
    return ret + torch.where(is_small, n, large)


@functools.lru_cache(maxsize=64)
def _bucket_table(T: int, S: int, num_buckets: int, max_dist: int, bidirectional: bool,
                  device: str) -> torch.Tensor:
    """[T, S] int64 buckets of ``arange(S)[None] - arange(T)[:, None]``,
    computed on the host and kept on ``device``."""
    rel = torch.arange(S)[None, :] - torch.arange(T)[:, None]
    return _relative_bucket(rel, num_buckets, max_dist, bidirectional).to(device)


class _T5Attention(HybridBlock):
    def __init__(self, cfg: T5Config, causal: bool):
        super().__init__()
        d = cfg.d_model
        self.q = nn.Dense(d, flatten=False, use_bias=False, in_units=d, dtype=cfg.dtype)
        self.k = nn.Dense(d, flatten=False, use_bias=False, in_units=d, dtype=cfg.dtype)
        self.v = nn.Dense(d, flatten=False, use_bias=False, in_units=d, dtype=cfg.dtype)
        self.o = nn.Dense(d, flatten=False, use_bias=False, in_units=d, dtype=cfg.dtype)
        self._cfg = cfg
        self._causal = causal

    def forward(self, x, kv=None, bias=None):
        cfg = self._cfg
        H = cfg.num_heads
        hd = cfg.d_model // H
        source = x if kv is None else kv
        q, k, v = self.q(x), self.k(source), self.v(source)
        causal = self._causal
        args = (q, k, v) if bias is None else (q, k, v, bias)

        def fn(qv, kv_, vv, *rest):
            B, T, d = qv.shape
            S = kv_.shape[1]
            qh = qv.reshape(B, T, H, hd).transpose(1, 2)
            kh = kv_.reshape(B, S, H, hd).transpose(1, 2)
            vh = vv.reshape(B, S, H, hd).transpose(1, 2)
            s = torch.einsum("bhqd,bhkd->bhqk", qh.float(), kh.float())
            if rest:
                buckets = _bucket_table(T, S, cfg.relative_buckets, cfg.relative_max_distance,
                                        not causal, str(qv.device))
                s = s + rest[0][buckets].permute(2, 0, 1)[None]
            if causal:
                mask = torch.ones(T, S, dtype=torch.bool, device=qv.device).tril(S - T)
                s = torch.where(mask[None, None], s, _F32_MIN)
            p = torch.softmax(s, dim=-1)
            o = torch.einsum("bhqk,bhkd->bhqd", p, vh.float())
            return o.to(qv.dtype).transpose(1, 2).reshape(B, T, d)

        return self.o(apply_multi(fn, args, name="t5_attention"))


class _T5Block(HybridBlock):
    def __init__(self, cfg: T5Config, decoder: bool):
        super().__init__()
        d = cfg.d_model
        self.ln_sa = nn.RMSNorm(in_channels=d, epsilon=cfg.layer_norm_eps)
        self.self_attn = _T5Attention(cfg, causal=decoder)
        self._decoder = decoder
        if decoder:
            self.ln_ca = nn.RMSNorm(in_channels=d, epsilon=cfg.layer_norm_eps)
            self.cross_attn = _T5Attention(cfg, causal=False)
        self.ln_ff = nn.RMSNorm(in_channels=d, epsilon=cfg.layer_norm_eps)
        self.wi = nn.Dense(cfg.d_ff, flatten=False, use_bias=False, in_units=d,
                           dtype=cfg.dtype)
        self.wo = nn.Dense(d, flatten=False, use_bias=False, in_units=cfg.d_ff,
                           dtype=cfg.dtype)
        self.drop = nn.Dropout(cfg.dropout)

    def forward(self, x, bias=None, memory=None):
        x = x + self.drop(self.self_attn(self.ln_sa(x), bias=bias))
        if self._decoder:
            x = x + self.drop(self.cross_attn(self.ln_ca(x), kv=memory))
        h = npx.relu(self.wi(self.ln_ff(x)))
        return x + self.drop(self.wo(h))


class T5Model(HybridBlock):
    """Encoder-decoder LM: shared token embedding, tied LM head; returns
    decoder logits [B, T_dec, vocab]."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model, dtype=cfg.dtype)
        # one bias table per stack, added in every layer
        self.enc_rel_bias = Parameter("enc_rel_bias", shape=(cfg.relative_buckets,
                                                             cfg.num_heads),
                                      init="normal", dtype=cfg.dtype)
        self.dec_rel_bias = Parameter("dec_rel_bias", shape=(cfg.relative_buckets,
                                                             cfg.num_heads),
                                      init="normal", dtype=cfg.dtype)
        # registered once, as enc_{i} / dec_{i}; the lists only order them
        self.enc_blocks = []
        self.dec_blocks = []
        for i in range(cfg.num_layers):
            enc = _T5Block(cfg, decoder=False)
            dec = _T5Block(cfg, decoder=True)
            setattr(self, f"enc_{i}", enc)
            setattr(self, f"dec_{i}", dec)
            self.enc_blocks.append(enc)
            self.dec_blocks.append(dec)
        self.enc_final = nn.RMSNorm(in_channels=cfg.d_model, epsilon=cfg.layer_norm_eps)
        self.dec_final = nn.RMSNorm(in_channels=cfg.d_model, epsilon=cfg.layer_norm_eps)
        self.drop = nn.Dropout(cfg.dropout)

    def encode(self, input_ids):
        """The encoder's memory [B, S, d_model]; called on its own it runs
        under the model's AMP policy, as a call of the model does."""
        with self._amp_scope():
            x = self.drop(self.shared(input_ids))
            bias = self.enc_rel_bias.data()
            for blk in self.enc_blocks:
                x = blk(x, bias=bias)
            return self.enc_final(x)

    def forward(self, input_ids, decoder_input_ids):
        memory = self.encode(input_ids)
        y = self.drop(self.shared(decoder_input_ids))
        bias = self.dec_rel_bias.data()
        for blk in self.dec_blocks:
            y = blk(y, bias=bias, memory=memory)
        y = self.dec_final(y)
        scale = self.cfg.d_model ** -0.5        # T5 ties with a rescale

        def head(h, w):
            # the scale rounded to h's dtype, as JAX rounds a weak scalar;
            # the product in the wider of the two dtypes (f32 h against the
            # bf16 table under AMP), as jnp's matmul promotes
            h = h * _dtype_scalar(scale, h.dtype, h.device)
            dt = torch.promote_types(h.dtype, w.dtype)
            return h.to(dt) @ w.to(dt).T
        return apply(head, y, self.shared.weight.data(), name="t5_lm_head")
