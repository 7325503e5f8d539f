"""Gluon ``Trainer`` on one device (counterpart of
``mxnet_tpu/gluon/trainer.py``, without the kvstore).

    with autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    trainer.step(batch_size)

``step`` sets ``rescale_grad = scale / batch_size`` and steps every
trainable parameter that has a fresh gradient with the optimizer's pure
``update_step``, writing weights and state in place under
``torch.no_grad()``. A parameter with no gradient since the last step is
stale: ``step`` raises, unless ``ignore_stale_grad=True`` skips it.

Two forms. Given gluon ``Parameter``s (``net.collect_params()``), it
reads each one's gradient buffer (filled by the tape's ``backward`` under
``grad_req`` 'write' or 'add'; 'null' ones are skipped), steps with
``lr * lr_mult`` and ``wd * wd_mult`` as the JAX package does, and marks
the gradient stale. Given tensors (``dict(module.named_parameters())``,
as ``TrainStep``'s GPT runs use), it reads ``.grad``: the JAX package's
``grad_req='write'`` overwrites a gradient on every backward, where
PyTorch adds to it, so ``step`` consumes those gradients (sets ``.grad``
to None) and the next backward writes fresh ones.

``save_states`` / ``load_states`` write and read the JAX package's
``.states`` file: a pickled dict ``{"states", "step", "num_update",
"index_update_count"}`` whose ``states`` list holds, per parameter index,
None or the tuple of that parameter's state leaves as numpy arrays, so
either package loads the other's file. bf16 leaves are ``ml_dtypes``
bfloat16 arrays, as the JAX package writes them; where ``ml_dtypes`` is
missing the port writes them as raw ``[("bfloat16", "<u2")]`` records,
which only the port reads back.
"""
from __future__ import annotations

import pickle
from typing import Dict, Optional

import numpy as np
import torch

from .. import optimizer as opt_mod
from ..base import MXNetError
from ..parallel.train import apply_updates
from ..serialization import host_copies
from .parameter import Parameter

__all__ = ["Trainer"]

_RAW_BF16 = np.dtype([("bfloat16", "<u2")])


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host tensor as the numpy array the JAX package pickles."""
    if t.dtype != torch.bfloat16:
        return t.numpy()
    bits = t.contiguous().view(torch.int16).numpy().view(np.uint16)
    try:
        import ml_dtypes
    except ImportError:
        return bits.view(_RAW_BF16)
    return bits.view(ml_dtypes.bfloat16)


def _leaf_from_numpy(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or a.dtype == _RAW_BF16:
        u16 = np.ascontiguousarray(a).view(np.uint16)
        return torch.from_numpy(u16.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


class Trainer:
    def __init__(self, params, optimizer, optimizer_params: Optional[dict] = None,
                 kvstore="device"):
        """``params``: gluon ``Parameter``s (``net.collect_params()``, or an
        iterable of them), or tensors (``dict(net.named_parameters())``, an
        iterable of (name, tensor) pairs or of tensors). Shared parameters
        are stepped once. Only the single-device kvstores (``'device'``,
        ``'local'``, None) are ported."""
        if isinstance(params, dict):
            items = list(params.items())
        else:
            items = [x if isinstance(x, tuple) else
                     (x.name if isinstance(x, Parameter) else str(i), x)
                     for i, x in enumerate(params)]
        self._gluon = bool(items) and isinstance(items[0][1], Parameter)
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

    def _tensor(self, i: int) -> torch.Tensor:
        p = self._params[i][1]
        return p.data()._data if self._gluon else p

    def update(self, batch_size: int, ignore_stale_grad: bool = False):
        if self._gluon:
            return self._update_gluon(batch_size, ignore_stale_grad)
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
        opt.num_update = self._step_count
        counts = opt._index_update_count
        ts = []
        for i in idx:
            counts[i] = counts.get(i, 0) + 1
            ts.append(counts[i])
            if i not in self._states:
                self._states[i] = opt.create_state(i, self._params[i][1])
        lr = opt.learning_rate          # read once per step
        params = [self._params[i] for i in idx]
        states = [self._states[i] for i in idx]
        apply_updates(opt, params, states,
                      lambda j: (opt._get_lr(idx[j], lr), opt._get_wd(idx[j]), ts[j]),
                      opt.rescale_grad)
        for j, i in enumerate(idx):
            self._states[i] = states[j]
            self._params[i][1].grad = None

    def _update_gluon(self, batch_size: int, ignore_stale_grad: bool):
        opt = self._optimizer
        opt.rescale_grad = self._scale / batch_size
        idx = []
        for i, (name, p) in enumerate(self._params):
            if p.grad_req == "null":
                continue
            arr = p.data()
            if arr._grad is None or not arr._grad_fresh:
                if ignore_stale_grad:
                    continue
                raise MXNetError(
                    f"Gradient of Parameter `{name}` has not been updated by backward "
                    "since last step: run backward inside autograd.record() before "
                    "step(), or pass ignore_stale_grad=True to skip it")
            idx.append(i)
        if not idx:
            return
        self._step_count += 1
        opt.num_update = self._step_count
        counts = opt._index_update_count
        ts = []
        for i in idx:
            counts[i] = counts.get(i, 0) + 1
            ts.append(counts[i])
            if i not in self._states:
                self._states[i] = opt.create_state(i, self._tensor(i))
        lr, wd = opt.learning_rate, opt.wd
        ps = [self._params[i][1] for i in idx]
        states = [self._states[i] for i in idx]
        apply_updates(opt, [(self._params[i][0], self._tensor(i)) for i in idx], states,
                      lambda j: (lr * ps[j].lr_mult, wd * ps[j].wd_mult, ts[j]),
                      opt.rescale_grad, grads=[p.data()._grad._data for p in ps])
        for j, i in enumerate(idx):
            self._states[i] = states[j]
            ps[j].data()._grad_fresh = False

    def _host_state_payload(self) -> dict:
        """Host snapshot of the optimizer state, the serializable half of
        :meth:`save_states`: taken on the caller's thread (the next step
        updates the state in place), written by
        :meth:`_write_states_payload`, possibly on another thread."""
        slots = sorted(self._states)
        leaves = [t for i in slots for t in self._states[i]]
        host = iter(host_copies(leaves))
        states = [None] * len(self._params)
        for i in slots:
            states[i] = tuple(_leaf_to_numpy(next(host)) for _ in self._states[i])
        opt = self._optimizer
        return {"states": states, "step": self._step_count,
                "num_update": opt.num_update,
                "index_update_count": dict(opt._index_update_count)}

    @staticmethod
    def _write_states_payload(fname: str, payload: dict):
        with open(fname, "wb") as f:
            pickle.dump(payload, f)

    def save_states(self, fname: str):
        self._write_states_payload(fname, self._host_state_payload())

    def load_states(self, fname: str):
        """Load a ``.states`` file of either package: each state leaf goes
        to its parameter's device in the dtype it was saved in."""
        with open(fname, "rb") as f:
            payload = pickle.load(f)
        states = payload["states"]
        if len(states) != len(self._params):
            raise MXNetError(f"{fname}: {len(states)} parameter states for "
                             f"{len(self._params)} parameters")
        self._states = {
            i: tuple(_leaf_from_numpy(a, self._tensor(i).device) for a in st)
            for i, st in enumerate(states) if st is not None}
        self._step_count = payload["step"]
        self._optimizer.num_update = payload["num_update"]
        self._optimizer._index_update_count = dict(payload.get("index_update_count", {}))
