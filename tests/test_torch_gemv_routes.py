"""The two routes of K3 and K4 (``mxnet_tpu_torch.ops.int8_gemv``) on the
CPU: the row thresholds of ``gemv_route``, the per-route launch counts of
``gemv_routes`` beside the unchanged launch kinds, and the tile route's
arithmetic, emulated in plain PyTorch, against the JAX package's
``int8_weight_matmul`` / ``int4_weight_matmul``.

The tile route (``csrc/gemv_mma.cuh``) writes x as three bf16 planes
(hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid)), multiplies
each plane by the weight codes (exact in bf16) with f32 sums, splits K into
slices of whole 32-code k-tiles, multiplies an int8 row scale into the
finished dot and an int4 block scale into each block's partial sum within a
slice, and sums the slices in ascending order. The emulation below repeats
that arithmetic, with the tile constants read from the kernel's header;
the kernel itself runs only on the card (tests/test_torch_cuda_kernels.py).
"""
import re
from pathlib import Path

import numpy as onp
import pytest
import torch

import jax.numpy as jnp
from mxnet_tpu.ops import int8_gemv as jgemv

from mxnet_tpu_torch.ops import int8_gemv



def _header_constants():
    """The ``constexpr int`` constants of csrc/gemv_mma.cuh, evaluated in
    order (C integer arithmetic on literals and earlier constants)."""
    text = (Path(int8_gemv.__file__).resolve().parent.parent / "csrc" /
            "gemv_mma.cuh").read_text()
    consts = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([\w\s*/+()-]+);", text, re.M):
        consts[name] = eval(expr.replace("/", "//"), {"__builtins__": {}}, consts)
    return consts


# the kernel's channels per CTA, codes per k-tile, CTAs the split stays
# within, most slices per channel tile
_TILE = _header_constants()
_BN, _BK, _FILL, _MAX_SLICES = (_TILE[k] for k in ("kBN", "kBK", "kFillCtas", "kMaxSlices"))


def test_gemv_route_thresholds():
    """Warp route up to 8 rows (decode) and past gemv_max_m(); tile route
    from GEMV_TILE_MIN_M = 9 to gemv_max_m() = 64 rows (prefill)."""
    assert int8_gemv.GEMV_TILE_MIN_M == 9 and int8_gemv.gemv_max_m() == 64
    assert int8_gemv.GEMV_TILE_K == _BK and _TILE["kMaxRows"] == int8_gemv.gemv_max_m()
    assert [int8_gemv.gemv_route(m) for m in (1, 2, 8)] == ["warp"] * 3
    assert [int8_gemv.gemv_route(m) for m in (9, 16, 33, 64)] == ["mma"] * 4
    assert int8_gemv.gemv_route(65) == "warp"


def _int8_table(rng, N, K):
    w = rng.randint(-127, 128, (N, K)).astype("int8")
    s = (rng.rand(N) * 0.02 + 1e-3).astype("float32")
    return w, s


def _int4_table(rng, N, K, block=128, pow2=False):
    """A packed int4 table [N, K/2] uint8 (lo nibble = even code) and its
    block scales [N, K/block]; with ``pow2`` the scales are powers of two."""
    codes = rng.randint(0, 16, (N, K)).astype("uint8")
    packed = (codes[:, 0::2] | (codes[:, 1::2] << 4)).astype("uint8")
    if pow2:
        s = onp.exp2(rng.randint(-9, -4, (N, K // block))).astype("float32")
    else:
        s = (rng.rand(N, K // block) * 0.02 + 1e-3).astype("float32")
    return packed, s


@pytest.mark.parametrize("bits", [8, 4])
def test_routes_counted_and_reset(bits):
    """A CPU call counts once under its launch kind (``gemv`` or
    ``gemv_int4``, unchanged) and under no route: it runs the plain
    version, not a kernel. A kernel launch (recorded on the card after it
    returned) counts under its kind and its route; ``reset_launches``
    zeroes both."""
    rng = onp.random.RandomState(0)
    w, s = (_int8_table if bits == 8 else _int4_table)(rng, 64, 256)
    fn = int8_gemv.int8_weight_matmul if bits == 8 else int8_gemv.int4_weight_matmul
    kind = "gemv" if bits == 8 else "gemv_int4"
    int8_gemv.reset_launches()
    with int8_gemv.count_launches() as tally:
        for M in (1, 8, 9, 64, 65):
            fn(torch.from_numpy(rng.randn(M, 256).astype("float32")), torch.from_numpy(w),
               torch.from_numpy(s))
    assert tally == {kind: 5}
    assert int8_gemv.launches() == {kind: 5}
    assert int8_gemv.gemv_routes() == {"warp": 0, "mma": 0}
    for M in (1, 8, 9, 64, 65):
        int8_gemv._record_gemv(kind, int8_gemv.gemv_route(M))
    assert int8_gemv.launches() == {kind: 10}
    assert int8_gemv.gemv_routes() == {"warp": 3, "mma": 2}
    int8_gemv.reset_launches()
    assert int8_gemv.gemv_routes() == {"warp": 0, "mma": 0} and int8_gemv.launches() == {}


def _slices(N, K):
    """csrc/gemv_mma.cuh slices(): K-slices of a launch, from N and K only."""
    tiles = -(-N // _BN)
    s = min(_FILL // tiles, _MAX_SLICES, K // _BK)
    return max(s, 1)


def _planes(x):
    hi = x.to(torch.bfloat16).float()
    mid = (x - hi).to(torch.bfloat16).float()
    lo = (x - hi - mid).to(torch.bfloat16).float()
    return hi, mid, lo


def _tile_emulation(x, codes, row_scale=None, block_scale=None, block=None):
    """The tile route's arithmetic in plain PyTorch: x (M, K) f32, codes
    (N, K) f32 integers; an int8 row scale (N,) on the finished dot, or int4
    block scales (N, K/block) on each block's partial sum within a slice."""
    N, K = codes.shape
    planes = _planes(x)
    kt = K // _BK
    S = _slices(N, K)
    total = None
    for q in range(S):
        k0, k1 = q * kt // S * _BK, (q + 1) * kt // S * _BK
        acc = torch.zeros(x.shape[0], N)
        edges = ([k0, k1] if block is None else
                 sorted({k0, k1, *range((k0 // block + 1) * block, k1, block)}))
        for a, b in zip(edges[:-1], edges[1:]):
            part = torch.zeros(x.shape[0], N)
            for p in planes:
                part = part + p[:, a:b] @ codes[:, a:b].T
            acc = acc + (part if block is None else part * block_scale[:, a // block])
        total = acc if total is None else total + acc
    return total if row_scale is None else total * row_scale


@pytest.mark.parametrize("M", [16, 64])
@pytest.mark.parametrize("N,K", [(768, 768), (768, 3072)])
def test_tile_emulation_int8_matches_jax(M, N, K):
    """Against JAX's ``int8_weight_matmul`` (its f32 CPU fallback), D 768:
    within 1e-4 x max(1, |ref|), the kernel check's tolerance (three planes
    carry all 24 bits of an f32 x; the sums run in another order)."""
    rng = onp.random.RandomState(M + K)
    x = rng.randn(M, K).astype("float32")
    w, s = _int8_table(rng, N, K)
    want = onp.asarray(jgemv.int8_weight_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s)))
    got = _tile_emulation(torch.from_numpy(x), torch.from_numpy(w).float(),
                          row_scale=torch.from_numpy(s)).numpy()
    assert onp.abs(got - want).max() <= 1e-4 * max(1.0, onp.abs(want).max())


def _int4_codes(packed):
    p = torch.from_numpy(packed).int()
    return torch.stack([(p & 0xF) - 8, (p >> 4) - 8], dim=-1).reshape(p.shape[0], -1).float()


@pytest.mark.parametrize("M", [16, 64])
@pytest.mark.parametrize("N,K", [(768, 768), (768, 3072)])
def test_tile_emulation_int4_matches_jax_fallback(M, N, K):
    """Against JAX's ``int4_weight_matmul`` (its f32 CPU fallback through
    the codec), D 768, block 128: within 1e-4 x max(1, |ref|)."""
    rng = onp.random.RandomState(M + K + 1)
    x = rng.randn(M, K).astype("float32")
    w_p, w_s = _int4_table(rng, N, K)
    want = onp.asarray(jgemv.int4_weight_matmul(*map(jnp.asarray, (x, w_p, w_s))))
    got = _tile_emulation(torch.from_numpy(x), _int4_codes(w_p),
                          block_scale=torch.from_numpy(w_s), block=128).numpy()
    assert onp.abs(got - want).max() <= 1e-4 * max(1.0, onp.abs(want).max())


@pytest.mark.parametrize("M", [16, 64])
def test_tile_emulation_int4_matches_pallas_interpret(M):
    """Against the Pallas kernel of ``int4_weight_matmul`` in interpret
    mode, D 768, block 128. That kernel feeds its MXU x and the dequantized
    weight in bf16, so the inputs are ones on which both casts are exact (x
    already in bf16, power-of-two block scales); then the two differ only
    in the order of f32 sums: within 1e-4 x max(1, |ref|)."""
    rng = onp.random.RandomState(M + 7)
    N = K = 768
    x = torch.from_numpy(rng.randn(M, K).astype("float32")).bfloat16().float().numpy()
    w_p, w_s = _int4_table(rng, N, K, pow2=True)
    want = onp.asarray(jgemv.int4_weight_matmul(*map(jnp.asarray, (x, w_p, w_s)),
                                                interpret=True))
    got = _tile_emulation(torch.from_numpy(x), _int4_codes(w_p),
                          block_scale=torch.from_numpy(w_s), block=128).numpy()
    assert onp.abs(got - want).max() <= 1e-4 * max(1.0, onp.abs(want).max())
