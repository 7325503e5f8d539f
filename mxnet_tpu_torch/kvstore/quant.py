"""Block-scaled quantization codec (counterpart of
``mxnet_tpu/kvstore/quant.py``).

Each block of ``block`` values is quantized against its own f32 scale,
``max |x|_block / qmax``; the codes are int8 (bits 8) or two offset-binary
nibbles per byte (bits 4):

    wire bytes = n * bits/8  +  (n/block) * 4        (vs 4n for f32)

Every function is bit for bit the JAX package's: the same f32 division
order (``amax / q``, then ``x / scale``), round half to even on both sides
(``torch.round`` and ``jnp.round``), scale 1.0 for all-zero blocks, and the
nibble layout of ``pack_codes``: code 2i is the lo nibble of byte i, code
2i + 1 the hi nibble, each stored as code + 8.
"""
from __future__ import annotations

import torch

__all__ = ["QMAX", "quantize_blocks", "dequantize_blocks", "pack_codes",
           "unpack_codes", "wire_bytes"]

#: largest code magnitude per bit width (symmetric signed range)
QMAX = {8: 127, 4: 7}


def quantize_blocks(x, bits: int, block: int):
    """f32 ``(n,)`` -> ``(codes int8 (n,), scales f32 (n/block,))``."""
    q = QMAX[bits]
    xb = x.float().reshape(-1, block)
    amax = xb.abs().amax(dim=1)
    scales = torch.where(amax > 0, amax / q, torch.ones_like(amax))
    codes = torch.clamp(torch.round(xb / scales[:, None]), -q, q).to(torch.int8)
    return codes.reshape(-1), scales


def dequantize_blocks(codes, scales, block: int):
    """Inverse of :func:`quantize_blocks` (codes may be the unpacked int8
    view of packed bytes)."""
    cb = codes.reshape(-1, block).float()
    return (cb * scales.float()[:, None]).reshape(-1)


def pack_codes(codes, bits: int):
    """int8 codes -> uint8 bytes (bitwise-invertible): a bitcast for bits
    8; for bits 4 two nibbles per byte, code + 8 in [1, 15] (the code
    count must be even)."""
    if bits == 8:
        return codes.view(torch.uint8)
    u = (codes.to(torch.int32) + 8).to(torch.uint8).reshape(-1, 2)
    return u[:, 0] | (u[:, 1] << 4)


def unpack_codes(packed, bits: int):
    """uint8 bytes -> int8 codes (exact inverse of :func:`pack_codes`)."""
    if bits == 8:
        return packed.view(torch.int8)
    lo = (packed & 0x0F).to(torch.int32)
    hi = (packed >> 4).to(torch.int32)
    u = torch.stack([lo, hi], dim=-1).reshape(-1)
    return (u - 8).to(torch.int8)


def wire_bytes(n: int, bits: int, block: int) -> int:
    """Bytes of the quantized representation of ``n`` values (packed codes
    + f32 scales); the f32 baseline is ``4 * n``."""
    return n * bits // 8 + (n // block) * 4
