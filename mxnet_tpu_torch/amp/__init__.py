"""AMP, automatic mixed precision (counterpart of ``mxnet_tpu/amp``).

A :class:`Policy` is consulted by op name at the port's single funnel
(``ndarray.apply_multi``): the ops of ``lists.TARGET_DTYPE_OPS`` get their
floating inputs cast to the low dtype, those of ``lists.FP32_OPS`` to
f32, those of ``lists.WIDEST_TYPE_CASTS`` to the widest floating input.
The casts are recorded with the op, so an f32 master weight receives an
f32 gradient while its product runs in bf16. ``amp.init()`` sets the
process-wide policy, ``autocast()`` a thread's, and
:func:`convert_hybrid_block` a block's own, entered by ``Block.__call__``
(and part of a ``CachedOp``'s cache key).

bf16 needs no loss scaling; for f16, :func:`init_trainer` attaches a
:class:`LossScaler` and ``Trainer.step`` folds the inverse scale into the
gradient rescale and skips a step whose gradients overflowed.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Optional

import torch

from .. import _tape
from ..base import MXNetError, logger
from ..ndarray import to_torch_dtype
from . import lists
from .loss_scaler import LossScaler

__all__ = ["init", "init_trainer", "scale_loss", "autocast", "convert_hybrid_block",
           "Policy", "LossScaler", "lists"]

_NAMES = {torch.bfloat16: "bfloat16", torch.float16: "float16", torch.float32: "float32"}


class Policy:
    """Autocast rules keyed by op name."""

    def __init__(self, target_dtype=torch.bfloat16):
        self.target_dtype = to_torch_dtype(target_dtype)
        self._action = {}
        for n in lists.TARGET_DTYPE_OPS:
            self._action[n] = "target"
        for n in lists.FP32_OPS:
            self._action[n] = "fp32"
        for n in lists.WIDEST_TYPE_CASTS:
            self._action[n] = "widest"

    @property
    def name(self) -> str:
        """The target dtype's name (a ``CachedOp`` key's ``amp`` slot)."""
        return _NAMES.get(self.target_dtype, str(self.target_dtype))

    def wrap(self, fn, name: str):
        """``fn`` with its floating tensor inputs cast by the rule of
        ``name`` (``fn`` itself when no list names it)."""
        act = self._action.get(name)
        if act is None:
            return fn
        target = self.target_dtype

        def casted(*vals):
            floats = [v.dtype for v in vals if torch.is_tensor(v) and v.is_floating_point()]
            if not floats:
                return fn(*vals)
            if act == "target":
                to = target
            elif act == "fp32":
                to = torch.float32
            else:
                to = max(floats, key=lambda d: torch.finfo(d).bits)
            return fn(*(v.to(to) if torch.is_tensor(v) and v.is_floating_point()
                        and v.dtype != to else v for v in vals))
        return casted


def _as_dtype(target_dtype):
    if isinstance(target_dtype, str):
        try:
            return {"bfloat16": torch.bfloat16, "float16": torch.float16,
                    "float32": torch.float32}[target_dtype]
        except KeyError:
            raise MXNetError(f"AMP: unsupported target dtype {target_dtype}") from None
    return to_torch_dtype(target_dtype)


def init(target_dtype="bfloat16", target_precision_ops=None, conditional_fp32_ops=None,
         fp32_ops=None):
    """Enable AMP process-wide: every later op goes through the policy.
    Extra op lists extend the defaults."""
    target_dtype = _as_dtype(target_dtype)
    pol = Policy(target_dtype)
    for n in (target_precision_ops or []):
        pol._action[n] = "target"
    for n in (fp32_ops or []) + (conditional_fp32_ops or []):
        pol._action[n] = "fp32"
    _tape.GLOBAL_AMP_POLICY = pol
    logger.info("AMP initialized with target dtype %s", target_dtype)


@contextmanager
def autocast(target_dtype="bfloat16", enabled: bool = True):
    """Scoped autocast for this thread, over the global policy."""
    prev = _tape.STATE.amp_policy
    _tape.STATE.amp_policy = Policy(_as_dtype(target_dtype)) if enabled else _tape.AMP_OFF
    try:
        yield
    finally:
        _tape.STATE.amp_policy = prev


def _param_should_stay_fp32(name: str) -> bool:
    # normalization statistics and scale/shift stay f32
    return name.endswith(("gamma", "beta", "running_mean", "running_var"))


def convert_hybrid_block(block, target_dtype="bfloat16", device=None, cast_params: bool = True):
    """Convert a block to mixed precision: floating parameters to the
    target dtype (a deferred one records the dtype it will be made in),
    norm parameters and statistics kept f32, and the block's forward run
    under the policy."""
    target_dtype = _as_dtype(target_dtype)
    for name, p in block.collect_params().items():
        if _param_should_stay_fp32(name):
            continue
        if cast_params and to_torch_dtype(p.dtype).is_floating_point:
            p.cast(target_dtype)
    block._amp_target = target_dtype
    block._amp_policy = Policy(target_dtype)
    return block


def init_trainer(trainer, loss_scaler: Optional[LossScaler] = None):
    """Attach dynamic loss scaling to a Trainer (f16; bf16 needs none)."""
    trainer._amp_loss_scaler = loss_scaler or LossScaler()
    return trainer


@contextmanager
def scale_loss(loss, trainer):
    """``with amp.scale_loss(loss, trainer) as scaled: scaled.backward()``:
    the loss scaled up; ``Trainer.step`` folds the inverse scale into the
    gradient rescale and skips steps whose gradients overflowed."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None:
        yield loss
        return
    if isinstance(loss, (list, tuple)):
        yield type(loss)(l * scaler.loss_scale for l in loss)
    else:
        yield loss * scaler.loss_scale
