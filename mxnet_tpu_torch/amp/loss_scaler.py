"""Dynamic loss scaling (counterpart of ``mxnet_tpu/amp/loss_scaler.py``),
for f16 training; bf16 trains unscaled."""
from __future__ import annotations

import torch

__all__ = ["LossScaler"]


class LossScaler:
    def __init__(self, init_scale: float = 2.0 ** 16, scale_factor: float = 2.0,
                 scale_window: int = 2000, tolerance: float = 0.05):
        self.loss_scale = init_scale
        self._scale_factor = scale_factor
        self._scale_window = scale_window
        self._unskipped = 0

    def scale(self, loss):
        return loss * self.loss_scale

    def unscale(self, grads):
        inv = 1.0 / self.loss_scale
        for g in grads:
            g._set_data(g._data * inv)

    def has_overflow(self, params) -> bool:
        """True when a gradient of ``params`` holds an inf or a nan."""
        gs = [p.data()._grad._data for p in params if p.data()._grad is not None]
        return any_not_finite(gs)

    def update_scale(self, overflow: bool):
        """Halve the scale (not below 1) on an overflow; double it after
        ``scale_window`` clean steps."""
        if overflow:
            self.loss_scale = max(self.loss_scale / self._scale_factor, 1.0)
            self._unskipped = 0
        else:
            self._unskipped += 1
            if self._unskipped >= self._scale_window:
                self.loss_scale *= self._scale_factor
                self._unskipped = 0


def any_not_finite(tensors) -> bool:
    """Whether any of ``tensors`` holds an inf or a nan (one host sync)."""
    flags = [torch.logical_not(torch.isfinite(t)).any() for t in tensors]
    return bool(torch.stack(flags).any()) if flags else False
