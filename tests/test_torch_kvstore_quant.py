"""Port parity of the block-scaled codec (mxnet_tpu_torch.kvstore.quant vs
mxnet_tpu.kvstore.quant): quantize, pack, unpack and dequantize are bit for
bit the JAX package's, at both widths, on ordinary, tiny and all-zero
blocks."""
import numpy as onp
import pytest
import torch

import jax.numpy as jnp
from mxnet_tpu.kvstore import quant as jquant

from mxnet_tpu_torch.kvstore import quant


def _values(n, seed):
    """N(0, 1) values with an all-zero block, a block of tiny values, a
    block of halves (round-half-to-even ties) and a block of large ones."""
    rng = onp.random.RandomState(seed)
    x = rng.randn(n).astype("float32")
    x[:128] = 0.0
    x[128:256] *= 1e-30
    x[256:384] = rng.randint(-7, 8, 128) + 0.5
    x[384:512] *= 1e6
    return x


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("block", [128, 32, 1024])
def test_codec_bitwise(bits, block):
    x = _values(4096, seed=bits + block)
    jc, js = jquant.quantize_blocks(jnp.asarray(x), bits, block)
    tc, ts = quant.quantize_blocks(torch.from_numpy(x), bits, block)
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    assert (tc.numpy() == onp.asarray(jc)).all()
    assert (ts.numpy() == onp.asarray(js)).all()
    jp = jquant.pack_codes(jc, bits)
    tp = quant.pack_codes(tc, bits)
    assert tp.dtype == torch.uint8 and tp.numel() == 4096 * bits // 8
    assert (tp.numpy() == onp.asarray(jp)).all()
    tu = quant.unpack_codes(tp, bits)
    assert (tu.numpy() == onp.asarray(jquant.unpack_codes(jp, bits))).all()
    assert torch.equal(tu, tc)                        # exact round trip
    td = quant.dequantize_blocks(tu, ts, block)
    assert (td.numpy() == onp.asarray(jquant.dequantize_blocks(jc, js, block))).all()
    assert quant.wire_bytes(4096, bits, block) == jquant.wire_bytes(4096, bits, block)


def test_zero_blocks_and_nibble_layout():
    """An all-zero block quantizes against scale 1.0 to zero codes (packed
    bytes 0x88); code 2i is the lo nibble of byte i, each stored as code
    + 8; every legal 4-bit code pair packs and unpacks exactly."""
    codes, scales = quant.quantize_blocks(torch.zeros(256), 4, 128)
    assert (scales == 1.0).all() and (codes == 0).all()
    assert (quant.pack_codes(codes, 4) == 0x88).all()
    pair = torch.tensor([-7, 7], dtype=torch.int8)
    assert quant.pack_codes(pair, 4).tolist() == [1 | (15 << 4)]
    grid = torch.cartesian_prod(torch.arange(-7, 8), torch.arange(-7, 8))
    flat = grid.reshape(-1).to(torch.int8)
    assert torch.equal(quant.unpack_codes(quant.pack_codes(flat, 4), 4), flat)
    assert quant.QMAX == jquant.QMAX
