"""Gluon ``Trainer`` on one device (counterpart of
``mxnet_tpu/gluon/trainer.py``, without the kvstore).

    loss = loss_fn(net(x), y)
    loss.backward()
    trainer.step(batch_size)

``step`` sets ``rescale_grad = scale / batch_size`` and steps every
trainable parameter that has a gradient with the optimizer's pure
``update_step``, in place under ``torch.no_grad()``. The JAX package's
``grad_req='write'`` overwrites a gradient on every backward, where
PyTorch adds to it; so ``step`` consumes the gradients (sets ``.grad`` to
None) and the next backward writes fresh ones. A parameter with no
gradient since the last step is stale: ``step`` raises, unless
``ignore_stale_grad=True`` skips it.
"""
from __future__ import annotations

from typing import Dict, Optional

from .. import optimizer as opt_mod
from ..base import MXNetError
from ..parallel.train import apply_updates

__all__ = ["Trainer"]


class Trainer:
    def __init__(self, params, optimizer, optimizer_params: Optional[dict] = None,
                 kvstore="device"):
        """``params``: a dict name -> parameter (``dict(net.named_parameters())``),
        an iterable of (name, parameter) pairs, or of parameters. Shared
        parameters are stepped once. Only the single-device kvstores
        (``'device'``, ``'local'``, None) are ported."""
        if isinstance(params, dict):
            items = list(params.items())
        else:
            items = [x if isinstance(x, tuple) else (str(i), x)
                     for i, x in enumerate(params)]
        seen, self._params = set(), []
        for name, p in items:
            if id(p) not in seen:
                seen.add(id(p))
                self._params.append((name, p))
        if kvstore not in ("device", "local", None, False):
            raise MXNetError(f"Trainer(kvstore={kvstore!r}): distributed kvstores are "
                             "not ported yet (ROADMAP Queue 1 item 8)")
        self._optimizer = opt_mod.create(optimizer, **dict(optimizer_params or {}))
        self._optimizer.idx2name = {i: n for i, (n, _) in enumerate(self._params)}
        self._scale = self._optimizer.rescale_grad
        self._states: Dict[int, tuple] = {}
        self._step_count = 0

    @property
    def learning_rate(self) -> float:
        return self._optimizer.learning_rate

    @learning_rate.setter
    def learning_rate(self, lr):
        self._optimizer.learning_rate = lr

    def set_learning_rate(self, lr):
        self._optimizer.learning_rate = lr

    def step(self, batch_size: int, ignore_stale_grad: bool = False):
        """Update the parameters from their gradients, scaled by
        1 / ``batch_size`` (one device: there is nothing to reduce)."""
        self.update(batch_size, ignore_stale_grad)

    def update(self, batch_size: int, ignore_stale_grad: bool = False):
        opt = self._optimizer
        opt.rescale_grad = self._scale / batch_size
        idx = []
        for i, (name, p) in enumerate(self._params):
            if not p.requires_grad:
                continue
            if p.grad is None:
                if ignore_stale_grad:
                    continue
                raise MXNetError(
                    f"Gradient of Parameter `{name}` has not been updated by backward "
                    "since last step: run backward before step(), or pass "
                    "ignore_stale_grad=True to skip it")
            idx.append(i)
        if not idx:
            return
        self._step_count += 1
        ts = []
        for i in idx:
            ts.append(opt._update_count(i))
            if i not in self._states:
                self._states[i] = opt.create_state(i, self._params[i][1])
        params = [self._params[i] for i in idx]
        states = [self._states[i] for i in idx]
        apply_updates(opt, params, states,
                      lambda j: (opt._get_lr(idx[j]), opt._get_wd(idx[j]), ts[j]),
                      opt.rescale_grad)
        for j, i in enumerate(idx):
            self._states[i] = states[j]
            self._params[i][1].grad = None
        opt.num_update = self._step_count
