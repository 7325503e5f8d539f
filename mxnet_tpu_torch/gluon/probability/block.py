"""StochasticBlock (counterpart of
``mxnet_tpu/gluon/probability/block.py``): a HybridBlock whose forward can
register auxiliary losses (e.g. a KL term in a VAE) collected after the
call."""
from __future__ import annotations

from ...base import MXNetError
from ..block import HybridBlock

__all__ = ["StochasticBlock", "DeterministicBlock"]


class StochasticBlock(HybridBlock):
    def __init__(self):
        super().__init__()
        self._losses = []
        self._flag = False

    def add_loss(self, loss):
        """Record an auxiliary loss inside forward (reference add_loss)."""
        self._losses.append(loss)

    @property
    def losses(self):
        if not self._flag:
            raise MXNetError(
                "collect losses after calling the block (losses are "
                "registered during forward)")
        return self._losses

    def __call__(self, *args, **kwargs):
        self._losses = []
        out = super().__call__(*args, **kwargs)
        self._flag = True
        return out

    def hybridize(self, active: bool = True, **kwargs):
        if active:
            # losses are collected per eager forward: a CachedOp replay
            # (a captured graph on the card) would not run add_loss again
            raise MXNetError(
                "StochasticBlock cannot be hybridized: auxiliary losses "
                "are collected per eager forward (reference behavior is "
                "trace-once via @StochasticBlock.collectLoss; run eager)")
        return super().hybridize(active, **kwargs)


class DeterministicBlock(HybridBlock):
    """Marker base for purely deterministic probabilistic modules."""
