"""Block-level fused decode and the fused LM-head sampler (counterpart of
``mxnet_tpu/ops/fused_block_gemv.py``, contiguous int8 lane).

- :func:`pack_gpt_block` extracts one GPT block's frozen int8 weights.
- :func:`fused_block_decode` runs one block's whole T=1 decode step: on a
  CUDA tensor as ONE cooperative launch of ``csrc/fused_block_decode.cu``
  (K5), on a CPU tensor as :func:`_reference_block_decode`, which replays
  the unfused LayerNorm -> QuantizedDense -> cached-attention op sequence.
  The caches are updated in place (the JAX function returns copies).
- :func:`fused_lm_head_sample` folds the tied int8 head GEMV into greedy or
  temperature sampling: ``csrc/lm_head_sample.cu`` (K8) on CUDA, and
  :func:`_reference_head_sample` on the CPU. Sampled rows draw Gumbel noise
  from :func:`_hash_uniform` of (request key bits, vocab lane), as the TPU
  kernel does; the JAX package's off-TPU path samples with
  ``jax.random.categorical`` instead, so sampled tokens match JAX only
  against its kernel (interpret mode), never against its CPU fallback.

Paged decode (K6, K7), the int4 lanes and grammar masks are later slices.
"""
from __future__ import annotations

import torch

from .. import numpy_extension as npx
from ..base import MXNetError
from .int8_gemv import _reference_int8_matmul, record_launch

__all__ = ["pack_gpt_block", "fused_block_decode", "fused_lm_head_sample",
           "fusable", "VOCAB_LANE", "pad_vocab"]

# lane width the vocab dim is padded to (50257 -> 50304)
VOCAB_LANE = 128
# shared memory one CTA may use on Hopper (H100: 227 KB)
_SMEM_LIMIT = 232448
# kernel geometry of csrc/fused_block_decode.cu (kRowTile, kThreads)
_ROW_TILE = 8
_THREADS = 256


def pad_vocab(n: int) -> int:
    """Smallest multiple of VOCAB_LANE >= n."""
    return -(-int(n) // VOCAB_LANE) * VOCAB_LANE


def fusable(B: int, D: int, heads: int, L: int) -> bool:
    """Shape gate of the Hopper block kernel: 16-byte int8 rows (D % 16),
    whole heads with hd % 8 == 0 and hd <= 256 (one CTA per (row, head)
    covers the head dim in float4 words), and the larger of the staged
    activation tile (8 rows of the 4D fc activations) and the attention
    buffers (one f32 score row of L, q and the float4 reduction scratch)
    within one CTA's 227 KB of shared memory. It replaces the TPU kernel's
    VMEM budget gate, which would reject GPT-2 small at L = 1024."""
    if B < 1 or heads < 1 or D % 16 or D % heads:
        return False
    hd = D // heads
    if hd % 8 or hd > _THREADS:
        return False
    smem = 4 * max(_ROW_TILE * 4 * D, hd + -(-L // 4) * 4 + 4 * _THREADS)
    return smem <= _SMEM_LIMIT


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

def pack_gpt_block(block, eps: float):
    """One GPTBlock's fused-decode pack, or None if any of its four Dense
    layers is not a frozen int8 QuantizedDense (per-layer opt-in: such
    blocks keep the unfused path)."""
    layers = []
    for name in ("attn_qkv", "attn_out", "mlp_fc", "mlp_proj"):
        q = getattr(block, name, None)
        if q is None or getattr(q, "w_q", None) is None:
            return None
        layers.append(q)

    def wsb(q):
        bias = q.inner.bias
        if bias is None:
            bias = torch.zeros(q.w_q.shape[0], device=q.w_q.device)
        return q.w_q, q.w_scale, bias

    qkv, out, fc, proj = layers
    return {
        "qkv": wsb(qkv), "out": wsb(out), "fc": wsb(fc), "proj": wsb(proj),
        "ln1": (block.ln_1.gamma, block.ln_1.beta),
        "ln2": (block.ln_2.gamma, block.ln_2.beta),
        "eps": float(eps), "heads": int(block.heads),
    }


# ---------------------------------------------------------------------------
# plain version of K5 — the op sequence of the unfused quantized block
# ---------------------------------------------------------------------------

def _dense(xv, w_q, w_scale, bias):
    B, T, _ = xv.shape
    y = _reference_int8_matmul(xv.reshape(B * T, xv.shape[-1]), w_q, w_scale)
    return y.reshape(B, T, w_q.shape[0]) + bias


def _reference_block_decode(xv, posv, kc, vc, pack):
    """One block's decode step with the op sequence of the unfused
    LayerNorm -> QuantizedDense -> _cached_attention chain; the caches
    are written in place."""
    from ..models.llama import _cached_attention
    heads, eps = pack["heads"], pack["eps"]
    g1, b1 = pack["ln1"]
    g2, b2 = pack["ln2"]
    B, T, d = xv.shape
    hd = d // heads
    qkv = _dense(npx.layer_norm(xv, g1, b1, eps=eps), *pack["qkv"])
    q, k, v = torch.split(qkv, d, dim=-1)
    qh = q.reshape(B, T, heads, hd).transpose(1, 2)
    kh = k.reshape(B, T, heads, hd).transpose(1, 2)
    vh = v.reshape(B, T, heads, hd).transpose(1, 2)
    o, kc, vc = _cached_attention(qh, kh, vh, kc, vc, posv)
    ctx = o.transpose(1, 2).reshape(B, T, d)
    x = xv + _dense(ctx, *pack["out"])
    h = _dense(npx.layer_norm(x, g2, b2, eps=eps), *pack["fc"])
    h = npx.gelu(h, approximate=True)
    return x + _dense(h, *pack["proj"]), kc, vc


def _row_positions(posv, B, device):
    pos = torch.as_tensor(posv, dtype=torch.int32, device=device)
    return pos.reshape(-1).expand(B).contiguous() if pos.numel() == 1 else pos


def fused_block_decode(xv, posv, kc, vc, pack):
    """One transformer block's whole T=1 decode step. ``xv`` [B, 1, D] f32,
    ``posv`` scalar or [B] positions, ``kc``/``vc`` [B, H, L, hd] f32
    caches, updated IN PLACE (the JAX function returns new caches; copying
    12 layers x 2 x B x H x L x hd x 4 bytes every step is what the in-place
    update saves). Returns ``(out [B, 1, D], kc, vc)``.

    A CUDA tensor launches K5 once; a CPU tensor runs the plain version.
    Shapes :func:`fusable` rejects raise: the model routes them to the
    unfused layers before calling here."""
    heads = pack["heads"]
    B, T, D = xv.shape
    L = kc.shape[2]
    if T != 1 or not fusable(B, D, heads, L):
        raise MXNetError(f"fused_block_decode: shape B={B} T={T} D={D} "
                         f"heads={heads} L={L} is not fusable")
    if kc.shape != (B, heads, L, D // heads) or vc.shape != kc.shape:
        raise MXNetError(f"fused_block_decode: caches {tuple(kc.shape)} / "
                         f"{tuple(vc.shape)} do not match x {tuple(xv.shape)}")
    record_launch("fused_block")
    if xv.device.type == "cpu":
        return _reference_block_decode(xv, posv, kc, vc, pack)
    return _cuda_block_decode(xv, posv, kc, vc, pack)


def _cuda_block_decode(xv, posv, kc, vc, pack):
    from .. import _build
    B, _, D = xv.shape
    heads = pack["heads"]
    L = kc.shape[2]
    for t in (kc, vc):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise MXNetError("fused_block_decode: caches must be contiguous f32 "
                             "(they are written in place)")
    if xv.dtype != torch.float32:
        raise MXNetError("fused_block_decode: the kernel takes f32 activations")
    pos = _row_positions(posv, B, xv.device)
    x = xv.reshape(B, D).contiguous()
    ops = []
    for key in ("qkv", "out", "fc", "proj"):
        w, s, b = pack[key]
        if w.dtype != torch.int8:
            raise MXNetError("fused_block_decode: the kernel takes int8 weights")
        ops += [w.contiguous(), s.contiguous(), b.detach().float().contiguous()]
    g1, b1 = pack["ln1"]
    g2, b2 = pack["ln2"]
    ops += [t.detach().float().contiguous() for t in (g1, b1, g2, b2)]
    scratch = torch.empty(9 * B * D, device=xv.device, dtype=torch.float32)
    out = torch.empty(B, D, device=xv.device, dtype=torch.float32)
    lib = _build.library("fused_block_decode")
    stream = torch.cuda.current_stream(xv.device).cuda_stream
    _build.check(lib.mx_fused_block_decode(
        x.data_ptr(), pos.data_ptr(), *[t.data_ptr() for t in ops],
        kc.data_ptr(), vc.data_ptr(), scratch.data_ptr(), out.data_ptr(),
        B, D, heads, L, pack["eps"], stream), "fused_block_decode")
    return out.reshape(B, 1, D), kc, vc


# ---------------------------------------------------------------------------
# fused LM-head sampling
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _hash_uniform(keys, lanes):
    """Stateless per-(request key, absolute lane) uniform in (0, 1): the
    murmur3-style finalizer of ``fused_block_gemv._hash_uniform``, in
    uint32 arithmetic carried in int64 (the low 32 bits of every product
    are exact). ``keys`` and ``lanes`` broadcast; both hold values in
    [0, 2**32)."""
    z = (lanes.long() * 0x9E3779B9) & _M32
    z = z ^ (keys.long() & _M32)
    z = z ^ (z >> 16)
    z = (z * 0x7FEB352D) & _M32
    z = z ^ (z >> 15)
    z = (z * 0x846CA68B) & _M32
    z = z ^ (z >> 16)
    return ((z >> 8).float() + 0.5) * (1.0 / (1 << 24))


def _reference_head_sample(h, w_q, w_scale, vocab, temps, keybits):
    """Plain version of K8: dequantized head logits, divided by T (T > 0
    rows), hash-Gumbel noise on T > 0 rows, pad lanes at -inf, argmax with
    ties to the lowest lane."""
    B = h.shape[0]
    Vp = w_q.shape[0]
    acc = _reference_int8_matmul(h, w_q, w_scale)                  # [B, Vp]
    t = temps.reshape(B, 1)
    z = acc / torch.where(t > 0, t, torch.ones_like(t))
    lanes = torch.arange(Vp, device=h.device)[None, :]
    u = _hash_uniform(keybits.reshape(B, 1), lanes)
    gumbel = -torch.log(-torch.log(u))
    z = torch.where(t > 0, z + gumbel, z)
    z = torch.where(lanes < vocab, z, torch.full_like(z, float("-inf")))
    return torch.argmax(z, dim=-1).to(torch.int32)


def fused_lm_head_sample(h, w_q, w_scale, vocab, keybits, temps, topks=0,
                         topps=1.0, out_dtype=None, mask=None):
    """Tied-head GEMV + token selection for one decode step's last-position
    hidden state ``h`` [B, D]: greedy rows (T == 0) take the exact argmax
    of the head logits, T > 0 rows Gumbel-argmax sample with noise from
    :func:`_hash_uniform` of ``keybits`` [B] (``generation._fold_keys``
    key bits, values in [0, 2**32)). ``(w_q, w_scale)`` is the
    vocab-padded int8 table; pad lanes never win. Returns [B] int32.

    Top-k / top-p filtering needs JAX's ``random.categorical`` stream and
    raises until the sampling slice; so do grammar masks and a non-f32
    ``out_dtype``."""
    B, D = h.shape
    if mask is not None:
        raise MXNetError("fused_lm_head_sample: grammar masks are not ported "
                         "yet (a later slice ports serve/grammar.py)")
    if out_dtype is not None and out_dtype != torch.float32:
        raise MXNetError("fused_lm_head_sample: only f32 logits are supported")
    topks = torch.as_tensor(topks).reshape(-1)
    topps = torch.as_tensor(topps, dtype=torch.float32).reshape(-1)
    if bool((topks > 0).any()) or bool((topps < 1.0).any()):
        raise MXNetError("fused_lm_head_sample: top-k/top-p sampling needs the "
                         "jax.random.categorical stream, which a later slice "
                         "ports")
    Vp = w_q.shape[0]
    if w_q.shape != (Vp, D) or w_scale.shape != (Vp,) or w_q.dtype != torch.int8:
        raise MXNetError("fused_lm_head_sample: w_q (Vp, D) int8, w_scale (Vp,)")
    dev = h.device
    temps = torch.as_tensor(temps, dtype=torch.float32, device=dev).reshape(-1)
    temps = temps.expand(B).contiguous()
    keybits = torch.as_tensor(keybits, device=dev).reshape(-1)
    if keybits.numel() != B:
        raise MXNetError("fused_lm_head_sample: one key per row")
    record_launch("fused_head")
    if dev.type == "cpu":
        return _reference_head_sample(h.float(), w_q, w_scale, int(vocab),
                                      temps, keybits)
    return _cuda_head_sample(h, w_q, w_scale, int(vocab), temps, keybits)


def _cuda_head_sample(h, w_q, w_scale, vocab, temps, keybits):
    from .. import _build
    B, D = h.shape
    Vp = w_q.shape[0]
    if h.dtype != torch.float32 or D % 16:
        raise MXNetError("fused_lm_head_sample: the kernel takes f32 h with "
                         "D % 16 == 0")
    # key bits as int32 carrying the uint32 pattern
    kb = keybits.long() & _M32
    kb = torch.where(kb >= 2 ** 31, kb - 2 ** 32, kb).to(torch.int32).contiguous()
    h = h.contiguous()
    lib = _build.library("lm_head_sample")
    ntiles = lib.mx_head_tiles(Vp)
    pmax = torch.empty(B * ntiles, device=h.device, dtype=torch.float32)
    pidx = torch.empty(B * ntiles, device=h.device, dtype=torch.int32)
    tok = torch.empty(B, device=h.device, dtype=torch.int32)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    _build.check(lib.mx_lm_head_sample(
        h.data_ptr(), w_q.contiguous().data_ptr(),
        w_scale.contiguous().data_ptr(), temps.data_ptr(), kb.data_ptr(),
        pmax.data_ptr(), pidx.data_ptr(), tok.data_ptr(), B, Vp, D, vocab,
        stream), "lm_head_sample")
    return tok
