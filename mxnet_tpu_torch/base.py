"""Errors shared by the whole package (counterpart of ``mxnet_tpu/base.py``)."""
from __future__ import annotations

__all__ = ["MXNetError"]


class MXNetError(RuntimeError):
    """Base error type (role of dmlc::Error / MXNetError in the reference C API)."""
