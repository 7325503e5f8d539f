"""Prompt-length and batch bucketing for the serving engine (counterpart of
``mxnet_tpu/serve/bucketing.py``). The port runs eagerly, but it keeps the
ladder: a request's prefill runs at the same padded shape as in the JAX
engine."""
from __future__ import annotations

from typing import List

from ..base import MXNetError

__all__ = ["next_pow2", "bucket_for", "bucket_ladder"]


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    if n < 1:
        raise MXNetError(f"next_pow2: n must be >= 1, got {n}")
    return 1 << (int(n) - 1).bit_length()


def bucket_for(n: int, lo: int, hi: int, growth: int = 2) -> int:
    """Round ``n`` up to a ladder bucket ``lo * growth**k``, clamped to
    [lo, hi]; ``hi`` is always a bucket. Raises if ``n`` exceeds ``hi``."""
    if growth < 2:
        raise MXNetError(f"bucket_for: growth must be >= 2, got {growth}")
    if n > hi:
        raise MXNetError(f"bucket_for: {n} exceeds the maximum bucket {hi}")
    b = max(int(lo), 1)
    while b < n:
        b *= growth
    return min(b, hi)


def bucket_ladder(lo: int, hi: int, growth: int = 2) -> List[int]:
    """All buckets ``bucket_for`` can return for sizes in [1, hi]."""
    if growth < 2:
        raise MXNetError(
            f"bucket_ladder: growth must be >= 2, got {growth}")
    out = []
    b = lo
    while b < hi:
        out.append(b)
        b *= growth
    out.append(hi)
    return out
