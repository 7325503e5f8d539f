"""Errors and env-var config shared by the whole package (counterpart of
``mxnet_tpu/base.py``)."""
from __future__ import annotations

import logging
import os
from typing import Any, Optional

__all__ = ["MXNetError", "get_env"]

logger = logging.getLogger("mxnet_tpu_torch")


class MXNetError(RuntimeError):
    """Base error type (role of dmlc::Error / MXNetError in the reference C API)."""


def get_env(name: str, default: Any = None, dtype: Optional[type] = None, doc: str = ""):
    """Read an ``MXNET_*`` env var with the JAX package's typed parsing: a
    bool is true for ``1``/``true``/``yes``/``on``, other types parse with
    ``dtype`` (default: the default's type), and an unparsable value warns
    and gives the default. ``doc`` documents the variable at its call
    site."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    if dtype is None and default is not None:
        dtype = type(default)
    if dtype is bool:
        return raw.strip().lower() in ("1", "true", "yes", "on")
    if dtype is not None:
        try:
            return dtype(raw)
        except (TypeError, ValueError):
            logger.warning("invalid value %r for %s; using default %r", raw, name, default)
            return default
    return raw
