"""Flash attention (counterpart of ``mxnet_tpu/ops/attention.py``).

:func:`flash_attention` routes as the JAX package does (``_use_pallas``,
with "on the TPU" read as "for a kernel-eligible shape"): f32/bf16, head dim
at most 256, not causal with more queries than keys, and T, S >= 256 go
through :class:`_FlashAttention`, an ``autograd.Function`` that saves
``q, k, v, o, lse`` and whose backward is K2. Every other shape takes
:func:`_fallback`: the plain K1 in f32 for small score matrices, the
chunked online softmax past that (the JAX package's own non-kernel route,
differentiated by autograd).

Inside the ``autograd.Function`` each wrapper dispatches by the tensor's
device: a CPU tensor takes the plain version
(:func:`_reference_flash_forward` / :func:`_reference_flash_backward`,
which recompute ``p = exp(s - lse)`` and follow the kernels' arithmetic), a
CUDA tensor launches the hand-written kernel or raises:

- K1 ``csrc/flash_attention_fwd.cu`` replaces ``_pallas_forward``;
- K2 ``csrc/flash_attention_bwd.cu`` replaces ``_pallas_backward``.

In bf16 at a padded head dim of 64 or 128 both run the warp-specialised
wgmma bodies, which load tiles by TMA: a head dim that is not a multiple
of 8 (a row that is not a whole number of 16-byte units) is zero-padded in
device memory to the next multiple of 8 first, and the outputs are cut
back, as the TPU kernel padded its operands (``_pad4``). K2's bf16 one
sweep takes an f32 dq accumulator and its turn counters from workspaces
the wrapper allocates.

Layout (B, H, T, D) as in the JAX package; lse is (B, H, T) f32 (the TPU
kernel returned its padded (B, H, Tp, 1) form).

:func:`flash_attention_bthd` is the (B, T, H, D) entry BERT calls, with an
optional key padding mask and attention-probability dropout. Either routes
off the kernels, as in the JAX package: to :func:`_xla_attention` (f32
einsums contracted in BTHD, dropout bits from the flat (B, H, T, S) index)
for small score matrices, to :func:`_chunked_reference` (dropout bits per
key chunk, (b, h, t) as the high word) past that. With neither, an
eligible shape runs K1 and K2 on (B, H, T, D) views. On the CPU the JAX
package never takes its kernel route; the port's plain K1 and K2 take it
here, so the two agree within rounding, not bit for bit.
"""
from __future__ import annotations

import functools
import sys
import types
from typing import Optional

import torch

from ..base import MXNetError
from .int8_gemv import record_launch

__all__ = ["flash_attention", "flash_attention_bthd", "attention"]

# Below this length the JAX package leaves attention to XLA (the kernel is
# grid-overhead-bound there); the port keeps the same routing.
_MIN_KERNEL_LEN = 256
# Above this score-matrix size the plain path gives way to the chunked
# online softmax (one constant for every routing site, as in JAX).
_XLA_PATH_MAX_SCORE_ELEMS = 2048 * 128
_F32_MIN = torch.finfo(torch.float32).min


def _pad_head_dim(d: int) -> int:
    """The head dim the kernels compute in: 64, 128 or 256 (the MXU lane
    widths of the TPU kernel; on Hopper the tile widths of K1/K2)."""
    for cand in (64, 128, 256):
        if d <= cand:
            return cand
    raise MXNetError(f"head dim {d} > 256 has no kernel path")


def _online_block(q, k, v, m, l, acc, scale, mask=None, acc_scale=None):
    """One blockwise online-softmax step; masked entries give p = 0 even
    when the whole block is masked. ``acc_scale``, when given, multiplies p
    in the value sum only, never in the normaliser ``l``: dropout on the
    normalised probabilities, ``dropout(softmax(s)) @ V``, blockwise."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if mask is not None:
        s = torch.where(mask, s, torch.finfo(s.dtype).min)
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    corr = torch.exp(m - m_new)
    p = torch.exp(s - m_new)
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    l_new = l * corr + p.sum(dim=-1, keepdim=True)
    pa = p if acc_scale is None else p * acc_scale
    acc_new = acc * corr + torch.einsum("bhqk,bhkd->bhqd", pa, v)
    return m_new, l_new, acc_new


def _chunk_keep(key, rate: float, B, H, T, lo, n, device):
    """The chunked route's keep bits of key positions [lo, lo + n): the
    (b, h, t) row index ``(b * H + h) * T + t`` as the high word and the
    key position as the low word of ``_keep_bits_at`` (a flat B*H*T*S index
    would wrap at 2**32 at long contexts)."""
    from ..numpy_extension import _keep_bits_at, _check_dropout_rng
    _check_dropout_rng()
    ar = functools.partial(torch.arange, dtype=torch.int64, device=device)
    bht = ((ar(B)[:, None, None] * H + ar(H)[None, :, None]) * T + ar(T)[None, None, :])
    spos = lo + ar(n)
    return _keep_bits_at(key, spos, 1.0 - rate, idx_hi=bht[..., None])


def _chunked_reference(q, k, v, causal: bool, scale: float, block: int = 512,
                       key_mask=None, dropout=None):
    """Online softmax over key chunks of ``block``: O(T * block) live
    scores, for long shapes that skip the kernel. Rows with no valid key
    (causal T > S, or fully key-masked) are 0. ``key_mask``: optional
    (B, S) 1/0 padding mask. ``dropout``: optional ``(key, rate)``
    attention-probability dropout whose bits each chunk draws for its own
    key positions (:func:`_chunk_keep`), so the memory bound holds under
    dropout; it scales the value sum only (``_online_block``'s
    ``acc_scale``). The JAX package's ``MXTPU_DROPOUT_RNG=threefry`` switch
    raises (``npx._check_dropout_rng``): the port draws the counter hash
    only, as its ``npx.dropout`` does."""
    B, H, T, D = q.shape
    S = k.shape[2]
    bs = min(block, S)
    nb = -(-S // bs)
    dtype = torch.promote_types(q.dtype, torch.float32)
    qf = q.to(dtype)
    q_pos = torch.arange(T, device=q.device)[:, None]
    m = torch.full((B, H, T, 1), torch.finfo(dtype).min, dtype=dtype, device=q.device)
    l = torch.zeros((B, H, T, 1), dtype=dtype, device=q.device)
    acc = torch.zeros((B, H, T, D), dtype=dtype, device=q.device)
    for j in range(nb):
        kb = k[:, :, j * bs:(j + 1) * bs].to(dtype)
        vb = v[:, :, j * bs:(j + 1) * bs].to(dtype)
        n = kb.shape[2]
        kv_pos = j * bs + torch.arange(n, device=q.device)[None, :]
        valid = kv_pos < S
        if causal:
            valid = valid & (q_pos + (S - T) >= kv_pos)
        valid = valid[None, None]
        if key_mask is not None:
            valid = valid & (key_mask[:, j * bs:j * bs + n] > 0)[:, None, None, :]
        acc_scale = None
        if dropout is not None:
            dkey, rate = dropout
            keep = _chunk_keep(dkey, rate, B, H, T, j * bs, n, q.device)
            acc_scale = torch.where(keep, 1.0 / (1.0 - rate), 0.0).to(dtype)
        m, l, acc = _online_block(qf, kb, vb, m, l, acc, scale, valid, acc_scale)
    return (acc / l.clamp_min(torch.finfo(dtype).tiny)).to(q.dtype)


def _dropout_keep(key, shape, rate: float, device):
    """The einsum route's keep multiplier over ``shape`` (B, H, T, S) in
    f32: ``1 / (1 - rate)`` where the counter hash of the flat index keeps,
    0 elsewhere (``npx._cheap_keep_mask``, the bits of the JAX package's
    ``_dropout_keep``). ``MXTPU_DROPOUT_RNG=threefry``, the JAX package's
    switch to ``jax.random.bernoulli``, raises (``npx._check_dropout_rng``)."""
    from ..numpy_extension import _cheap_keep_mask, _check_dropout_rng
    _check_dropout_rng()
    keep = _cheap_keep_mask(key, shape, 1.0 - rate, device=device)
    return torch.where(keep, 1.0 / (1.0 - rate), 0.0).to(torch.float32)


def _xla_attention(q, k, v, causal: bool, scale: float, layout: str = "bhtd",
                   key_mask=None, dropout=None):
    """The JAX package's einsum route for small score matrices, in either
    layout ("bhtd" or "bthd", contracted in place: no transposes). Scores
    and softmax in f32 from the storage-dtype operands (the JAX
    ``preferred_element_type``: upcast before the product), p cast to q's
    dtype before p V, the result in q's dtype. ``key_mask``: optional (B, S)
    1/0 padding mask, an additive -1e30 score bias; a fully masked row is
    0. ``dropout``: optional ``(key, rate)`` on the normalised
    probabilities (:func:`_dropout_keep`). Causal rows with no visible key
    (T > S) are 0."""
    if layout == "bhtd":
        T, S = q.shape[2], k.shape[2]
        qk, pv, row_shape = "bhqd,bhkd->bhqk", "bhqk,bhkd->bhqd", (T, 1)
    else:
        T, S = q.shape[1], k.shape[1]
        qk, pv, row_shape = "bqhd,bkhd->bhqk", "bhqk,bkhd->bqhd", (T, 1, 1)
    s = torch.einsum(qk, q.float(), k.float()) * scale
    if causal:
        mask = torch.ones(T, S, dtype=torch.bool, device=q.device).tril(S - T)
        s = torch.where(mask[None, None], s, _F32_MIN)
    if key_mask is not None:
        s = s + (1.0 - key_mask[:, None, None, :].float()) * -1e30
    p = torch.softmax(s, dim=-1)
    if dropout is not None:
        dkey, rate = dropout
        p = p * _dropout_keep(dkey, p.shape, rate, p.device)
    o = torch.einsum(pv, p.to(q.dtype).float(), v.float())
    if causal and T > S:
        o = o * (torch.arange(T, device=q.device).reshape(row_shape) >= T - S)
    if key_mask is not None:
        # a fully masked row's softmax is uniform over -1e30: zeroed, so the
        # einsum and chunked routes agree
        o = o * (key_mask.sum(dim=-1) > 0)[:, None, None, None]
    return o.to(q.dtype)


def _fallback(q, k, v, causal: bool, scale: float):
    """The non-kernel route: for a small score matrix the plain K1 in f32
    (the JAX package's ``_jnp_reference``: f32 softmax and products, the
    result in q's dtype; causal T > S rows with no key are 0), past that
    the chunked online softmax."""
    T, S = q.shape[2], k.shape[2]
    if T * S <= _XLA_PATH_MAX_SCORE_ELEMS:
        o, _ = _reference_flash_forward(q.float(), k.float(), v.float(), causal, scale)
        return o.to(q.dtype)
    return _chunked_reference(q, k, v, causal, scale)


def _use_kernel(q, k, causal: bool) -> bool:
    """Kernel eligibility (the JAX package's ``_use_pallas``): f32/bf16,
    head dim <= 256, not causal with T > S, T and S >= 256. A CPU tensor of
    an eligible shape takes the same ``autograd.Function`` with the plain
    versions in place of the kernels."""
    D = q.shape[-1]
    T, S = q.shape[2], k.shape[2]
    if q.dtype not in (torch.float32, torch.bfloat16):
        return False
    if D > 256 or (causal and T > S):
        return False
    return T >= _MIN_KERNEL_LEN and S >= _MIN_KERNEL_LEN


# ---------------------------------------------------------------------------
# Plain versions of K1 and K2
# ---------------------------------------------------------------------------
def _scores(q, k, causal: bool, scale: float):
    """(s, valid): f32 scores q k^T * scale with masked entries at
    finfo(f32).min, and the visibility mask (None when nothing is masked)."""
    T, S = q.shape[2], k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if not causal:
        return s, None
    # end-aligned: query i sees keys j <= i + S - T
    valid = torch.ones(T, S, dtype=torch.bool, device=q.device).tril(S - T)
    return s.masked_fill(~valid, _F32_MIN), valid


def _reference_flash_forward(q, k, v, causal: bool, scale: float):
    """Plain version of K1: ``(o, lse)`` with o in q's dtype and lse
    (B, H, T) f32. p = exp(s - m) is cast to v's dtype before p v, as the
    kernel casts it before its tile product; masked p is exactly 0."""
    s, valid = _scores(q, k, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if valid is not None:
        p = p.masked_fill(~valid, 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float()) / l
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def _reference_flash_backward(q, k, v, o, lse, do, causal: bool, scale: float):
    """Plain version of K2: ``(dq, dk, dv)`` in the inputs' dtypes.
    Recomputes p = exp(s - lse); delta = sum(do * o) in f32; p and
    ds = p (do v^T - delta) scale are cast to the storage dtype before their
    products, as in the kernels."""
    s, valid = _scores(q, k, causal, scale)
    p = torch.exp(s - lse[..., None])
    if valid is not None:
        p = p.masked_fill(~valid, 0.0)
    dof = do.float()
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(do.dtype).float(), dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, v.float())
    ds = (p * (dp - delta) * scale).to(q.dtype).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------
def _check(name, q, k, v, *more):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise MXNetError(f"{name}: q, k, v must be (B, H, T, D)")
    B, H, T, D = q.shape
    S = k.shape[2]
    if tuple(k.shape) != (B, H, S, D) or tuple(v.shape) != (B, H, S, D):
        raise MXNetError(f"{name}: shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)} disagree")
    if not all(t.dtype == q.dtype for t in (k, v)):
        raise MXNetError(f"{name}: q, k, v must share one dtype")
    if not all(t.device == q.device for t in (k, v, *more)):
        raise MXNetError(f"{name}: operands on different devices")
    return B, H, T, S, D


def _dense(t):
    """``t`` contiguous with a 16-byte-aligned start (the bf16 bodies load
    tile rows in 16-byte chunks)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _tma_route(q, Dp) -> bool:
    """bf16 at padded head dim 64 or 128: the wgmma bodies of K1 and K2."""
    return q.dtype == torch.bfloat16 and Dp <= 128


def _pad8(t):
    """``t`` with its last dim zero-padded to a multiple of 8."""
    D = t.shape[-1]
    return t if D % 8 == 0 else torch.nn.functional.pad(t, (0, 8 - D % 8))


def _launch_args(q, causal, scale):
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise MXNetError(f"flash attention kernels take f32 or bf16, got {q.dtype}")
    return (int(bool(causal)), float(scale), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)


def flash_forward(q, k, v, causal: bool, scale: float):
    """K1: ``(o, lse)``. A CPU tensor takes :func:`_reference_flash_forward`;
    a CUDA tensor launches ``csrc/flash_attention_fwd.cu`` or raises."""
    B, H, T, S, D = _check("flash_forward", q, k, v)
    if q.device.type == "cpu":
        record_launch("flash_fwd")
        return _reference_flash_forward(q, k, v, causal, scale)
    from .. import _build
    if causal and T > S:
        raise MXNetError("flash_forward: causal attention needs T <= S")
    Dp = _pad_head_dim(D)
    if _tma_route(q, Dp):
        q, k, v = _pad8(q), _pad8(k), _pad8(v)
    q, k, v = _dense(q), _dense(k), _dense(v)
    Dk = q.shape[-1]
    o = torch.empty_like(q)
    lse = torch.empty(B, H, T, device=q.device, dtype=torch.float32)
    c, s, bf, stream = _launch_args(q, causal, scale)
    lib = _build.library("flash_attention_fwd")
    _build.check(lib.mx_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                  lse.data_ptr(), B * H, T, S, Dk, Dp, c, s, bf, stream),
                 "flash_attention_fwd")
    record_launch("flash_fwd")
    return o[..., :D], lse


def flash_backward(q, k, v, o, lse, do, causal: bool, scale: float):
    """K2: ``(dq, dk, dv)``. A CPU tensor takes
    :func:`_reference_flash_backward`; a CUDA tensor launches
    ``csrc/flash_attention_bwd.cu`` (bf16 at padded head dim 64 or 128: its
    delta preprocess, one-sweep and dq cast kernels; otherwise its dk/dv
    kernel, then its dq kernel) or raises. One launch is recorded per call,
    after the last kernel's launch returned."""
    B, H, T, S, D = _check("flash_backward", q, k, v, o, lse, do)
    if tuple(o.shape) != tuple(q.shape) or tuple(do.shape) != tuple(q.shape) \
            or tuple(lse.shape) != (B, H, T):
        raise MXNetError("flash_backward: o and do must be q's shape, lse (B, H, T)")
    if q.device.type == "cpu":
        record_launch("flash_bwd")
        return _reference_flash_backward(q, k, v, o, lse, do, causal, scale)
    from .. import _build
    if causal and T > S:
        raise MXNetError("flash_backward: causal attention needs T <= S")
    if lse.dtype != torch.float32:
        raise MXNetError("flash_backward: lse must be f32")
    Dp = _pad_head_dim(D)
    do = do.to(q.dtype)
    ws_f32 = ws_i32 = None
    if _tma_route(q, Dp):
        q, k, v, o, do = (_pad8(t) for t in (q, k, v, o, do))
    q, k, v, o, lse, do = (_dense(t) for t in (q, k, v, o, lse, do))
    Dk = q.shape[-1]
    if _tma_route(q, Dp):
        # the dq accumulator and delta (f32), the turn counters and the ticket
        ws_f32 = torch.empty(B * H * T * (Dk + 1), device=q.device, dtype=torch.float32)
        ws_i32 = torch.empty(B * H * -(-T // 64) + 1, device=q.device, dtype=torch.int32)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    c, s, bf, stream = _launch_args(q, causal, scale)
    lib = _build.library("flash_attention_bwd")
    _build.check(lib.mx_flash_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                  lse.data_ptr(), do.data_ptr(), dq.data_ptr(),
                                  dk.data_ptr(), dv.data_ptr(),
                                  None if ws_f32 is None else ws_f32.data_ptr(),
                                  None if ws_i32 is None else ws_i32.data_ptr(),
                                  B * H, T, S, Dk, Dp, c, s, bf, stream), "flash_attention_bwd")
    record_launch("flash_bwd")
    return dq[..., :D], dk[..., :D], dv[..., :D]


class _FlashAttention(torch.autograd.Function):
    """The JAX package's ``custom_vjp`` (attention.py:649-684): the forward
    saves q, k, v, o and lse; the backward is K2."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_forward(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, o, lse, do, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = False, scale: Optional[float] = None):
    """Fused scaled-dot-product attention over (B, H, T, D). Kernel-eligible
    shapes go through K1 (forward) and K2 (backward); the rest through the
    plain or chunked path. Causal with T != S is end-aligned; causal query
    rows with no visible key (T > S) are 0."""
    s = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    if _use_kernel(q, k, causal):
        return _FlashAttention.apply(q, k, v, causal, s)
    return _fallback(q, k, v, causal, s)


def flash_attention_bthd(q, k, v, causal: bool = False, scale: Optional[float] = None,
                         key_mask=None, dropout=None):
    """Attention over the (B, T, H, D) layout that the projections produce
    (the JAX package's entry, routed as it routes). With no ``key_mask``
    and no ``dropout`` a kernel-eligible shape goes through K1 and K2 on
    (B, H, T, D) views; otherwise :func:`_xla_attention` contracts in BTHD
    while T * S <= _XLA_PATH_MAX_SCORE_ELEMS, and :func:`_chunked_reference`
    runs past that. ``key_mask``: optional (B, S) 1/0 padding mask.
    ``dropout``: optional ``(key, rate)`` attention-probability dropout; the
    einsum and chunked routes draw different bits, each the JAX route's."""
    B, T, H, D = q.shape
    S = k.shape[1]
    s = scale if scale is not None else 1.0 / (D ** 0.5)

    def bhtd(x):
        return x.transpose(1, 2)
    if key_mask is None and dropout is None and _use_kernel(bhtd(q), bhtd(k), causal):
        return bhtd(_FlashAttention.apply(bhtd(q), bhtd(k), bhtd(v), causal, s))
    if T * S > _XLA_PATH_MAX_SCORE_ELEMS:
        return bhtd(_chunked_reference(bhtd(q), bhtd(k), bhtd(v), causal, s,
                                       key_mask=key_mask, dropout=dropout))
    return _xla_attention(q, k, v, causal, s, layout="bthd", key_mask=key_mask,
                          dropout=dropout)


def attention(q, k, v, causal: bool = False, scale: Optional[float] = None):
    """Frontend entry of the fused attention op (the JAX package's
    NDArray-level ``attention``), over (B, H, T, D): NDArrays go through
    the funnel, so inside ``autograd.record()`` a kernel-eligible shape on
    the card runs K1 forward and K2 in the tape's backward; tensors go
    straight to :func:`flash_attention`."""
    from ..ndarray import apply
    return apply(lambda a, b, c: flash_attention(a, b, c, causal, scale), q, k, v,
                 name="flash_attention")


class _CallableModule(types.ModuleType):
    """``mx.ops.attention(q, k, v, causal=True)`` calls :func:`attention`, as
    the JAX package's ``mx.ops.attention`` does, while ``ops.attention``
    stays this module for ``from mxnet_tpu_torch.ops import attention``."""

    def __call__(self, q, k, v, causal: bool = False, scale: Optional[float] = None):
        return attention(q, k, v, causal, scale)


sys.modules[__name__].__class__ = _CallableModule
