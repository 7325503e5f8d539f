"""Runtime guards (counterpart of ``mxnet_tpu/analysis``): so far the
lock-order witness of :mod:`.guards`. The linter and the sync, recompile,
alias and DMA-ledger guards wait for the analysis slice."""
from . import guards

__all__ = ["guards"]
