"""BERT encoder (counterpart of ``mxnet_tpu/models/bert.py``): learned
positions and token types, post-LN encoder layers, the pooler, and the
sequence-classification and pretraining (MLM + NSP) heads, with the JAX
package's parameter names.

Attention goes through ``ops.attention.flash_attention_bthd`` as one funnel
op named ``bert_attention``: with no key mask and no attention dropout a
sequence of T >= 256 runs K1 forward and K2 backward on the card; a key
mask or attention dropout takes the einsum route (T * S <= 262144) or the
chunked route, as in the JAX package. The attention-dropout key is drawn
after q, k and v and before the output dropout's, only when the rate is
positive in training, so the masks are the JAX package's under one seed.
"""
from __future__ import annotations

import dataclasses

import numpy as onp
import torch

from .. import _tape
from .. import numpy_extension as npx
from .._random import next_key
from ..gluon import nn
from ..gluon.block import HybridBlock
from ..ndarray import NDArray, apply_multi
from ..ops.attention import flash_attention_bthd

__all__ = ["BertConfig", "BertModel", "BertForSequenceClassification",
           "BertForPretraining", "BERT_BASE", "BERT_TINY"]


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    layer_norm_eps: float = 1e-12
    dtype: object = onp.float32


BERT_BASE = BertConfig()
BERT_TINY = BertConfig(vocab_size=1024, hidden_size=64, num_layers=2,
                       num_heads=4, intermediate_size=128,
                       max_position_embeddings=128)


class BertSelfAttention(HybridBlock):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.query = nn.Dense(d, flatten=False, in_units=d, dtype=cfg.dtype)
        self.key = nn.Dense(d, flatten=False, in_units=d, dtype=cfg.dtype)
        self.value = nn.Dense(d, flatten=False, in_units=d, dtype=cfg.dtype)
        self.out = nn.Dense(d, flatten=False, in_units=d, dtype=cfg.dtype)
        self.dropout = nn.Dropout(cfg.hidden_dropout)

    def forward(self, x, attention_mask=None):
        cfg = self.cfg
        B, T, d = x.shape
        H = cfg.num_heads
        hd = d // H
        q, k, v = self.query(x), self.key(x), self.value(x)
        # dropout on the normalised probabilities; its key rides the
        # model's stream, drawn here as the JAX package draws it
        rate = cfg.attention_dropout
        dropout = (next_key(), rate) if (rate > 0.0 and _tape.is_training()) else None
        arrays = (q, k, v) if attention_mask is None else (q, k, v, attention_mask)

        def fn(qv, kv, vv, *rest):
            o = flash_attention_bthd(
                qv.reshape(B, T, H, hd), kv.reshape(B, T, H, hd), vv.reshape(B, T, H, hd),
                key_mask=rest[0] if rest else None, dropout=dropout)
            return o.reshape(B, T, d)

        ctx = apply_multi(fn, arrays, name="bert_attention")
        return self.dropout(self.out(ctx))


class BertLayer(HybridBlock):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.attention = BertSelfAttention(cfg)
        self.attention_norm = nn.LayerNorm(epsilon=cfg.layer_norm_eps,
                                           in_channels=cfg.hidden_size)
        self.intermediate = nn.Dense(cfg.intermediate_size, flatten=False,
                                     in_units=cfg.hidden_size, dtype=cfg.dtype)
        self.output = nn.Dense(cfg.hidden_size, flatten=False,
                               in_units=cfg.intermediate_size, dtype=cfg.dtype)
        self.output_norm = nn.LayerNorm(epsilon=cfg.layer_norm_eps,
                                        in_channels=cfg.hidden_size)
        self.dropout = nn.Dropout(cfg.hidden_dropout)

    def forward(self, x, attention_mask=None):
        x = self.attention_norm(x + self.attention(x, attention_mask))
        h = npx.gelu(self.intermediate(x))
        return self.output_norm(x + self.dropout(self.output(h)))


def _positions(input_ids, T):
    """``arange(T)`` in int32 on the ids' device, an NDArray when they are."""
    t = input_ids._data if isinstance(input_ids, NDArray) else input_ids
    pos = torch.arange(T, dtype=torch.int32, device=t.device)
    return NDArray._new(pos) if isinstance(input_ids, NDArray) else pos


class BertModel(HybridBlock):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                            dtype=cfg.dtype)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size, dtype=cfg.dtype)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size, dtype=cfg.dtype)
        self.embedding_norm = nn.LayerNorm(epsilon=cfg.layer_norm_eps,
                                           in_channels=cfg.hidden_size)
        self.embedding_dropout = nn.Dropout(cfg.hidden_dropout)
        self.encoder = nn.HybridSequential()
        for _ in range(cfg.num_layers):
            self.encoder.add(BertLayer(cfg))
        self.pooler = nn.Dense(cfg.hidden_size, flatten=False,
                               in_units=cfg.hidden_size, activation="tanh",
                               dtype=cfg.dtype)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        B, T = input_ids.shape
        x = self.word_embeddings(input_ids) + \
            self.position_embeddings(_positions(input_ids, T))
        if token_type_ids is not None:
            x = x + self.token_type_embeddings(token_type_ids)
        x = self.embedding_dropout(self.embedding_norm(x))
        for layer in self.encoder:
            x = layer(x, attention_mask)
        pooled = self.pooler(x[:, 0])
        return x, pooled


class BertForSequenceClassification(HybridBlock):
    def __init__(self, cfg: BertConfig, num_classes: int = 2):
        super().__init__()
        self.bert = BertModel(cfg)
        self.dropout = nn.Dropout(cfg.hidden_dropout)
        self.classifier = nn.Dense(num_classes, in_units=cfg.hidden_size,
                                   dtype=cfg.dtype)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        return self.classifier(self.dropout(pooled))


class BertForPretraining(HybridBlock):
    """MLM + NSP heads: returns (MLM logits [B, T, vocab], NSP logits [B, 2])."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.bert = BertModel(cfg)
        self.transform = nn.Dense(cfg.hidden_size, flatten=False,
                                  in_units=cfg.hidden_size, dtype=cfg.dtype)
        self.transform_norm = nn.LayerNorm(epsilon=cfg.layer_norm_eps,
                                           in_channels=cfg.hidden_size)
        self.mlm_decoder = nn.Dense(cfg.vocab_size, flatten=False,
                                    in_units=cfg.hidden_size, dtype=cfg.dtype)
        self.nsp_classifier = nn.Dense(2, in_units=cfg.hidden_size,
                                       dtype=cfg.dtype)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        seq, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        h = self.transform_norm(npx.gelu(self.transform(seq)))
        return self.mlm_decoder(h), self.nsp_classifier(pooled)
