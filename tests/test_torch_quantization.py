"""Port parity of weight-only int8 quantization (mxnet_tpu_torch.contrib.
quantization vs mxnet_tpu.contrib.quantization): the same weights must
quantize to the same int8 tables and scales, bit for bit, and the
activation-quantized product for more than 64 rows must match exactly."""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import np as mnp
from mxnet_tpu.contrib.quantization import quantize_net as jax_quantize_net
from mxnet_tpu.models import GPTModel as JaxGPT
from mxnet_tpu.models.gpt import GPTConfig as JaxGPTConfig

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.contrib.quantization import quantize_net
from mxnet_tpu_torch.interop import params_from_numpy
from mxnet_tpu_torch.models import GPTConfig, GPTModel
from mxnet_tpu_torch.ops.fused_block_gemv import pad_vocab


def _pair(vocab, hidden=256, heads=4, layers=2):
    """A JAX GPT and the port's GPT holding the same seeded weights."""
    mx.random.seed(0)
    jnet = JaxGPT(JaxGPTConfig(vocab_size=vocab, hidden_size=hidden,
                               num_layers=layers, num_heads=heads,
                               max_position_embeddings=64, dropout=0.0))
    jnet.initialize()
    jnet(mnp.array(onp.zeros((1, 4), "int32")))
    named = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    tnet = GPTModel(GPTConfig(vocab_size=vocab, hidden_size=hidden,
                              num_layers=layers, num_heads=heads,
                              max_position_embeddings=64, dropout=0.0),
                    device="cpu")
    params_from_numpy(tnet, named)
    return jnet, tnet


@pytest.mark.parametrize("vocab", [256, 251])
def test_int8_tables_bitwise(vocab):
    """Every Dense layer's (w_q, w_scale) and the vocab-padded tied-head
    table equal the JAX package's bit for bit (same division order, round
    half to even on both sides)."""
    jnet, tnet = _pair(vocab)
    jax_quantize_net(jnet, calib_mode="none")
    quantize_net(tnet)
    for jblk, tblk in zip(jnet.blocks, tnet.blocks):
        for name in ("attn_qkv", "attn_out", "mlp_fc", "mlp_proj"):
            jq, tq = getattr(jblk, name), getattr(tblk, name)
            assert (onp.asarray(jq._w_q) == tq.w_q.numpy()).all(), name
            assert (onp.asarray(jq._w_scale) == tq.w_scale.numpy()).all(), name
    jw, js, jv = jnet._q_lm_head
    tw, ts, tv = tnet._q_lm_head
    assert jv == tv == vocab and tw.shape[0] == pad_vocab(vocab)
    assert (onp.asarray(jw) == tw.numpy()).all()
    assert (onp.asarray(js) == ts.numpy()).all()


@pytest.mark.parametrize("rows", [65, 96])
def test_activation_quantized_rows_match_exactly(rows):
    """Above 64 rows QuantizedDense takes the activation-quantized int8
    product; the port forms it exactly (float64 integer sums), so its
    output equals JAX's int32 product path bit for bit."""
    jnet, tnet = _pair(256)
    jax_quantize_net(jnet, calib_mode="none")
    quantize_net(tnet)
    x = onp.random.RandomState(rows).randn(1, rows, 256).astype("float32")
    for name in ("attn_qkv", "mlp_fc"):
        want = getattr(list(jnet.blocks)[0], name)(mnp.array(x)).asnumpy()
        with torch.no_grad():   # parameters are trainable; this is inference
            got = getattr(tnet.blocks[0], name)(torch.from_numpy(x)).numpy()
        assert got.shape == want.shape
        assert (got == want).all(), name


def test_gemv_rows_use_the_weight_only_path():
    """At most 64 rows stream the int8 weights (K3's plain version on the
    CPU) with f32 activations: equal to the dequantized f32 matmul."""
    _, tnet = _pair(256, layers=1)
    quantize_net(tnet)
    layer = tnet.blocks[0].attn_qkv
    x = torch.from_numpy(onp.random.RandomState(3).randn(2, 5, 256)
                         .astype("float32"))
    want = x @ (layer.w_q.float() * layer.w_scale[:, None]).T + layer.inner.bias
    assert torch.equal(layer(x), want)


def test_unported_options_raise():
    _, tnet = _pair(256, layers=1)
    with pytest.raises(MXNetError, match="later slice"):
        quantize_net(tnet, bits=4)
    with pytest.raises(MXNetError, match="calib_mode"):
        quantize_net(tnet, calib_mode="naive")
