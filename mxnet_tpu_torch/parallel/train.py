"""TrainStep: one training step of a model on one device (counterpart of
``mxnet_tpu/parallel/train.py``).

The JAX package compiles forward, backward and the optimizer update into
one XLA executable. The port runs them eagerly: forward and
``loss.backward()`` through the model (for GPT, K1 and K2 carry the
attention), then the optimizer's pure ``update_step`` on every trainable
parameter, written back in place under ``torch.no_grad()``. The loss is
``mean(loss_fn(net(*inputs), *labels))``; the step counter ``t`` starts at
1 and the learning rate is read once per step, as in the JAX package.
Step ``t``'s dropout masks draw from ``KeySupply(key(t))`` (site k gets
``fold_in(key(t), k)``), the JAX package's per-step seed, so a model at
the default dropout trains on the JAX package's masks. The keys are hashed
on the host and reach the mask kernels as scalars; a captured step would
take a device base key, which ``KeySupply`` folds on the device.

    step = parallel.TrainStep(net, SoftmaxCrossEntropyLoss(),
                              optimizer.Adam(learning_rate=1e-4),
                              example_inputs=[ids])
    loss = step(ids, labels)            # one step
    loss = step.run(ids, labels, 10)    # ten steps, returns the last loss

Sharding (``mesh``), ZeRO (``zero``, ``compression_params``), numeric
health (``health``), rematerialisation (``remat``) and the dispatch window
(``block_every``) are not ported yet and raise.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .. import _prng
from .. import optimizer as opt_mod
from .._random import KeySupply
from ..base import MXNetError

__all__ = ["TrainStep"]

_LATER = "is not ported yet (ROADMAP Queue 1 item 8: kvstore and parallel)"


def _as_tensors(xs, device):
    if xs is None:
        return None
    if not isinstance(xs, (tuple, list)):
        xs = (xs,)
    return tuple(x.to(device) if torch.is_tensor(x)
                 else torch.as_tensor(np.asarray(x), device=device) for x in xs)


def trainable(net):
    """[(name, parameter)] of ``net`` that require grad, shared parameters
    once."""
    seen, out = set(), []
    for name, p in net.named_parameters():
        if p.requires_grad and id(p) not in seen:
            seen.add(id(p))
            out.append((name, p))
    return out


@torch.no_grad()
def apply_updates(opt, params, states, lr_wd_t, rescale):
    """Step every ``(name, parameter)`` of ``params`` with ``opt``'s pure
    ``update_step`` on f32 views, writing weights and ``states`` (a list,
    updated in place) back in their own dtypes. ``lr_wd_t(i)`` gives
    ``(lr, wd, t)`` of parameter ``i``. A parameter without a gradient
    steps with a zero one (the JAX gradient of an unused parameter)."""
    for i, (_, p) in enumerate(params):
        g = p.grad.float() if p.grad is not None else torch.zeros_like(p, dtype=torch.float32)
        lr, wd, t = lr_wd_t(i)
        new_w, new_state = opt.update_step(
            p.float(), g * rescale, tuple(s.float() for s in states[i]), lr, wd, t)
        p.copy_(new_w)
        states[i] = tuple(n.to(o.dtype) for o, n in zip(states[i], new_state))


class TrainStep:
    def __init__(self, net, loss_fn, optimizer, example_inputs: Sequence,
                 mesh=None, remat: bool = False, block_every: Optional[int] = None,
                 zero: int = 0, compression_params: Optional[dict] = None,
                 health: bool = False):
        """``example_inputs`` is taken for the JAX signature: the port runs
        eagerly, so nothing is traced from it. Switches ``net`` to training
        mode (the JAX package traces the step with ``training=True``)."""
        for flag, name in ((mesh is not None, "mesh"), (bool(zero), "zero"),
                           (bool(compression_params), "compression_params"),
                           (health, "health"), (remat, "remat"),
                           (block_every is not None, "block_every")):
            if flag:
                raise MXNetError(f"TrainStep({name}=...) {_LATER}")
        self.net = net.train()
        self.loss_fn = loss_fn
        self.optimizer = optimizer if isinstance(optimizer, opt_mod.Optimizer) \
            else opt_mod.create(optimizer)
        self._params = trainable(net)
        self.optimizer.idx2name = {i: n for i, (n, _) in enumerate(self._params)}
        self._states = [self.optimizer.create_state(i, p)
                        for i, (_, p) in enumerate(self._params)]
        self._device = self._params[0][1].device if self._params else torch.device("cpu")
        self._step = 0

    def _loss(self, inputs, labels):
        outs = self.net(*inputs)
        loss = self.loss_fn(outs) if labels is None else self.loss_fn(outs, *labels)
        return loss.mean()

    def _one(self, inputs, labels):
        self._step += 1
        opt = self.optimizer
        opt.num_update = self._step
        t = self._step
        lr = opt.learning_rate          # read once per step
        for _, p in self._params:
            p.grad = None
        with KeySupply(_prng.key(t)):
            loss = self._loss(inputs, labels)
        loss.backward()
        apply_updates(opt, self._params, self._states,
                      lambda i: (opt._get_lr(i, lr), opt._get_wd(i), t), opt.rescale_grad)
        return loss.detach()

    def state_arrays(self):
        """Flat name -> tensor view of the optimizer state, ``opt{slot}.{i}``
        for leaf i of parameter slot ``slot``, as the JAX package names
        them (sharded checkpoints, ``checkpoint.CheckpointManager``). The
        tensors are the live state."""
        return {f"opt{slot}.{i}": leaf
                for slot, st in enumerate(self._states) for i, leaf in enumerate(st)}

    @torch.no_grad()
    def write_state_arrays(self, arrays):
        """Inverse of :meth:`state_arrays`: copies loaded values into the
        live state tensors (same structure required)."""
        for slot, st in enumerate(self._states):
            for i, leaf in enumerate(st):
                leaf.copy_(torch.as_tensor(arrays[f"opt{slot}.{i}"]))

    def __call__(self, inputs, labels=None):
        """One step: updates the parameters and optimizer state in place and
        returns the scalar loss (in the loss's dtype; not synchronised)."""
        return self._one(_as_tensors(inputs, self._device),
                         _as_tensors(labels, self._device))

    def step(self, inputs, labels=None):
        """The same step as :meth:`__call__`: PyTorch queues the work on the
        card and returns without waiting, so there is no separate lazy
        window to manage."""
        return self(inputs, labels)

    def run(self, inputs, labels=None, steps: int = 1):
        """``steps`` steps on the same batch, looped in Python. The step
        counter advances per step, so momentum and Adam's bias correction
        match ``steps`` separate calls. Returns the last loss in f32."""
        inputs = _as_tensors(inputs, self._device)
        labels = _as_tensors(labels, self._device)
        loss = None
        for _ in range(steps):
            loss = self._one(inputs, labels)
        return loss.float()
