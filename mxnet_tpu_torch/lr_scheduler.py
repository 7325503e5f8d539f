"""Learning-rate schedulers (counterpart of ``mxnet_tpu/lr_scheduler.py``):
each maps the optimizer's update count to a rate, with an optional linear
or constant warmup. Host-side Python, read once per step by ``TrainStep``
and ``gluon.Trainer`` through ``Optimizer(lr_scheduler=...)``."""
from __future__ import annotations

import math

from .base import MXNetError

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler"]


class LRScheduler:
    def __init__(self, base_lr: float = 0.01, warmup_steps: int = 0,
                 warmup_begin_lr: float = 0.0, warmup_mode: str = "linear"):
        self.base_lr = base_lr
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr
        self.warmup_final_lr = base_lr
        if warmup_mode not in ("linear", "constant"):
            raise MXNetError(f"bad warmup_mode {warmup_mode}")
        self.warmup_mode = warmup_mode

    def get_warmup_lr(self, num_update: int) -> float:
        assert num_update < self.warmup_steps
        if self.warmup_mode == "linear":
            inc = (self.warmup_final_lr - self.warmup_begin_lr) * num_update / self.warmup_steps
            return self.warmup_begin_lr + inc
        return self.warmup_begin_lr

    def __call__(self, num_update: int) -> float:
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    def __init__(self, step: int, factor: float = 1.0, stop_factor_lr: float = 1e-8,
                 base_lr: float = 0.01, **kwargs):
        super().__init__(base_lr, **kwargs)
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0

    def __call__(self, num_update: int) -> float:
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        while num_update > self.count + self.step:
            self.count += self.step
            self.base_lr = max(self.base_lr * self.factor, self.stop_factor_lr)
        return self.base_lr


class MultiFactorScheduler(LRScheduler):
    def __init__(self, step, factor: float = 1.0, base_lr: float = 0.01, **kwargs):
        super().__init__(base_lr, **kwargs)
        self.step = list(step)
        self.factor = factor
        self.cur_step_ind = 0

    def __call__(self, num_update: int) -> float:
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        while self.cur_step_ind < len(self.step) and \
                num_update > self.step[self.cur_step_ind]:
            self.base_lr *= self.factor
            self.cur_step_ind += 1
        return self.base_lr


class PolyScheduler(LRScheduler):
    def __init__(self, max_update: int, base_lr: float = 0.01, pwr: int = 2,
                 final_lr: float = 0.0, **kwargs):
        super().__init__(base_lr, **kwargs)
        self.max_update = max_update
        self.power = pwr
        self.final_lr = final_lr

    def __call__(self, num_update: int) -> float:
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update >= self.max_update:
            return self.final_lr
        frac = 1.0 - (num_update - self.warmup_steps) / \
            max(self.max_update - self.warmup_steps, 1)
        return self.final_lr + (self.base_lr - self.final_lr) * frac ** self.power


class CosineScheduler(LRScheduler):
    def __init__(self, max_update: int, base_lr: float = 0.01,
                 final_lr: float = 0.0, **kwargs):
        super().__init__(base_lr, **kwargs)
        self.max_update = max_update
        self.final_lr = final_lr

    def __call__(self, num_update: int) -> float:
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update >= self.max_update:
            return self.final_lr
        frac = (num_update - self.warmup_steps) / \
            max(self.max_update - self.warmup_steps, 1)
        return self.final_lr + (self.base_lr - self.final_lr) * \
            (1 + math.cos(math.pi * frac)) / 2
