"""Vision Transformer (Dosovitskiy et al. 2021; counterpart of
``mxnet_tpu/models/vit.py``): gluon blocks over the port's layers. The
patch embedding is one ``nn.Conv2D`` with kernel = stride = patch over
NCHW images; attention is bidirectional through
``ops.attention.flash_attention``, so at T >= 256 (ViT-B/16 at 384: T 577)
it runs K1 forward and K2 backward on the card, below that the plain path.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as onp
import torch

from .. import numpy_extension as npx
from ..gluon import nn
from ..gluon.block import HybridBlock
from ..gluon.parameter import Parameter
from ..ndarray import apply
from ..ops.attention import flash_attention

__all__ = ["ViTConfig", "ViTModel", "ViTBlock", "VIT_B16", "VIT_TINY"]


@dataclass
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: int = 4
    dropout: float = 0.0
    layer_norm_eps: float = 1e-6
    dtype: object = onp.float32

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


VIT_B16 = ViTConfig()
VIT_TINY = ViTConfig(image_size=32, patch_size=8, num_classes=10, hidden_size=64,
                     num_layers=2, num_heads=4)


class ViTBlock(HybridBlock):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        d = cfg.hidden_size
        self.ln_1 = nn.LayerNorm(epsilon=cfg.layer_norm_eps, in_channels=d)
        self.qkv = nn.Dense(3 * d, flatten=False, in_units=d, dtype=cfg.dtype)
        self.proj = nn.Dense(d, flatten=False, in_units=d, dtype=cfg.dtype)
        self.ln_2 = nn.LayerNorm(epsilon=cfg.layer_norm_eps, in_channels=d)
        self.fc1 = nn.Dense(cfg.mlp_ratio * d, flatten=False, in_units=d, dtype=cfg.dtype)
        self.fc2 = nn.Dense(d, flatten=False, in_units=cfg.mlp_ratio * d, dtype=cfg.dtype)
        self.drop = nn.Dropout(cfg.dropout)
        self._heads = cfg.num_heads

    def forward(self, x):
        B, T, d = x.shape
        H = self._heads
        hd = d // H
        qkv = self.qkv(self.ln_1(x))

        def attn(qkv_v):
            q, k, v = (t.reshape(B, T, H, hd).transpose(1, 2)
                       for t in torch.split(qkv_v, d, dim=-1))
            o = flash_attention(q, k, v, False, None)
            return o.transpose(1, 2).reshape(B, T, d)

        x = x + self.drop(self.proj(apply(attn, qkv, name="vit_attention")))
        h = npx.gelu(self.fc1(self.ln_2(x)))
        return x + self.drop(self.fc2(h))


class ViTModel(HybridBlock):
    """Patchify, then [CLS] + learned position embeddings, the encoder and
    the head on the [CLS] token."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.patch_embed = nn.Conv2D(d, cfg.patch_size, strides=cfg.patch_size, in_channels=3,
                                     dtype=cfg.dtype)
        self.cls_token = Parameter("cls_token", shape=(1, 1, d), init="zeros", dtype=cfg.dtype)
        self.pos_embed = Parameter("pos_embed", shape=(1, cfg.num_patches + 1, d),
                                   init="normal", dtype=cfg.dtype)
        self.drop = nn.Dropout(cfg.dropout)
        self.blocks = nn.HybridSequential()
        for _ in range(cfg.num_layers):
            self.blocks.add(ViTBlock(cfg))
        self.ln = nn.LayerNorm(epsilon=cfg.layer_norm_eps, in_channels=d)
        self.head = nn.Dense(cfg.num_classes, in_units=d, dtype=cfg.dtype)

    def forward(self, images):
        patches = self.patch_embed(images)          # [B, d, P, P]

        def assemble(p, c, pe):
            B, d = p.shape[0], p.shape[1]
            tok = p.reshape(B, d, -1).transpose(1, 2)       # [B, N, d]
            return torch.cat([c.expand(B, 1, d), tok], dim=1) + pe

        x = apply(assemble, patches, self.cls_token.data(), self.pos_embed.data(),
                  name="vit_embed")
        x = self.blocks(self.drop(x))
        x = self.ln(x)
        return self.head(x[:, 0])                   # the [CLS] token
