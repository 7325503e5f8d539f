"""Weight-only int8 GEMV for decode-shaped matmuls (counterpart of
``mxnet_tpu/ops/int8_gemv.py``), plus the launch counters of the decode
kernels.

:func:`int8_weight_matmul` dispatches by the tensor's device: a CPU tensor
takes :func:`_reference_int8_matmul`, the plain PyTorch version (the exact
op sequence of the JAX package's off-TPU fallback: dequantize, then an f32
matmul); a CUDA tensor launches the hand-written kernel
``csrc/int8_gemv.cu`` (K3) or raises.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict

import torch

from ..base import MXNetError

__all__ = ["int8_weight_matmul", "count_launches", "record_launch",
           "reset_launches", "launches", "gemv_max_m"]

# row threshold of the GEMV route: at most this many rows stream int8
# weights through K3, more take the activation-quantized int8 product
# (contrib/quantization). The JAX package's tuned-config layer is not
# ported; this is its default.
_GEMV_MAX_M = 64


def gemv_max_m() -> int:
    return _GEMV_MAX_M


# ---------------------------------------------------------------------------
# Launch accounting. The port runs eagerly, so a launch is a real kernel
# launch (or, on the CPU, a call of its plain version under the same
# kind): each wrapper records one per call. ``launches()`` reads the
# process-wide per-kind totals, ``reset_launches()`` zeroes them, and
# ``count_launches()`` additionally tallies one thread's launches inside a
# ``with`` block (the JAX package's trace-time tally).
# ---------------------------------------------------------------------------
_COUNTS: Dict[str, int] = {}
_COUNTS_LOCK = threading.Lock()
_TALLY = threading.local()


@contextlib.contextmanager
def count_launches():
    """Tally the launches recorded on this thread: yields {kind: count}."""
    prev = getattr(_TALLY, "d", None)
    d: dict = {}
    _TALLY.d = d
    try:
        yield d
    finally:
        _TALLY.d = prev


def record_launch(kind: str):
    """Record one launch of a decode kernel (or of its plain version)."""
    with _COUNTS_LOCK:
        _COUNTS[kind] = _COUNTS.get(kind, 0) + 1
    d = getattr(_TALLY, "d", None)
    if d is not None:
        d[kind] = d.get(kind, 0) + 1


def launches() -> Dict[str, int]:
    """Process-wide launches per kind since the last :func:`reset_launches`."""
    with _COUNTS_LOCK:
        return dict(_COUNTS)


def reset_launches():
    with _COUNTS_LOCK:
        _COUNTS.clear()


def _reference_int8_matmul(x, w_q, w_scale):
    """Plain version of K3: ``x @ (w_q * w_scale).T`` in f32."""
    wf = w_q.float() * w_scale[:, None]
    return x.float() @ wf.T


def _check_gemv(x, w_q, w_scale):
    if x.dim() != 2 or w_q.dim() != 2 or w_scale.dim() != 1:
        raise MXNetError("int8_weight_matmul: x (M, K), w_q (N, K), w_scale (N,)")
    M, K = x.shape
    N = w_q.shape[0]
    if w_q.shape[1] != K or w_scale.shape[0] != N:
        raise MXNetError(f"int8_weight_matmul: shapes {tuple(x.shape)}, "
                         f"{tuple(w_q.shape)}, {tuple(w_scale.shape)} disagree")
    if w_q.dtype != torch.int8 or w_scale.dtype != torch.float32:
        raise MXNetError("int8_weight_matmul: w_q must be int8, w_scale f32")
    if not (x.device == w_q.device == w_scale.device):
        raise MXNetError("int8_weight_matmul: operands on different devices")
    return M, N, K


def int8_weight_matmul(x, w_q, w_scale):
    """x: (M, K) float; w_q: (N, K) int8; w_scale: (N,) f32 per-out-channel.
    Returns (M, N) f32 = x @ (w_q * w_scale).T."""
    M, N, K = _check_gemv(x, w_q, w_scale)
    record_launch("gemv")
    if x.device.type == "cpu":
        return _reference_int8_matmul(x, w_q, w_scale)
    return _cuda_int8_matmul(x, w_q, w_scale, M, N, K)


def _cuda_int8_matmul(x, w_q, w_scale, M, N, K):
    from .. import _build
    if x.dtype != torch.float32:
        raise MXNetError("int8_weight_matmul: the kernel takes f32 activations")
    if K % 16 or M < 1:
        raise MXNetError(f"int8_weight_matmul: the kernel needs K % 16 == 0 "
                         f"and M >= 1 (got M={M}, K={K})")
    x = x.contiguous()
    w_q = w_q.contiguous()
    w_scale = w_scale.contiguous()
    y = torch.empty(M, N, device=x.device, dtype=torch.float32)
    lib = _build.library("int8_gemv")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(lib.mx_int8_gemv(x.data_ptr(), w_q.data_ptr(),
                                  w_scale.data_ptr(), y.data_ptr(),
                                  M, N, K, stream), "int8_gemv")
    return y
