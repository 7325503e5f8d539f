"""TrainStep: one training step of a model on one device (counterpart of
``mxnet_tpu/parallel/train.py``).

The JAX package compiles forward, backward and the optimizer update into
one XLA executable. The port runs them eagerly: forward and
``loss.backward()`` through the model (for GPT and Llama, K1 and K2 carry
the attention at T >= 256), then the optimizer's pure ``update_step`` on
every trainable parameter, written back in place under
``torch.no_grad()``. The loss is ``mean(loss_fn(net(*inputs), *labels))``;
the step counter ``t`` starts at 1 and the learning rate is read once per
step, as in the JAX package. Step ``t``'s dropout masks draw from
``KeySupply(key(t))`` (site k gets ``fold_in(key(t), k)``), the JAX
package's per-step seed, so a model at the default dropout trains on the
JAX package's masks. The keys are hashed on the host and reach the mask
kernels as scalars; a captured step would take a device base key, which
``KeySupply`` folds on the device.

    step = parallel.TrainStep(net, SoftmaxCrossEntropyLoss(),
                              optimizer.Adam(learning_rate=1e-4),
                              example_inputs=[ids])
    loss = step(ids, labels)            # one step
    loss = step.run(ids, labels, 10)    # ten steps, returns the last loss
    for ids, labels in batches:         # block_every=2: at most 2 steps
        step.step(ids, labels)          # in flight on the card
    step.drain()

``remat=True`` recomputes the model's forward in the backward
(``torch.utils.checkpoint``, the JAX package's ``jax.checkpoint`` over the
whole apply). ``block_every=W`` bounds :meth:`TrainStep.step`'s run-ahead
on the card. The training metric families (``mxnet_step_time_seconds``,
``mxnet_examples_total``, ``mxnet_examples_per_sec``,
``mxnet_pipeline_depth``) are observed as in the JAX package. Sharding
(``mesh``), ZeRO (``zero``, ``compression_params``) and numeric health
(``health``) are not ported yet and raise.
"""
from __future__ import annotations

import time
from collections import deque
from contextlib import nullcontext
from typing import Optional, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .. import _prng, _tape, autograd
from .. import metrics as _metrics
from .. import optimizer as opt_mod
from .._random import KeySupply
from ..base import MXNetError
from ..ndarray import NDArray

__all__ = ["TrainStep"]

_LATER = "is not ported yet (ROADMAP Queue 1 item 8: kvstore and parallel)"


def _as_tensors(xs, device):
    """The batch as tensors on ``device``: an NDArray gives its tensor, a
    tensor moves only when it lies on another device (a batch the
    prefetcher staged is taken as it is), anything else goes through
    numpy."""
    if xs is None:
        return None
    if not isinstance(xs, (tuple, list)):
        xs = (xs,)
    out = []
    for x in xs:
        if isinstance(x, NDArray):
            x = x._data.detach()
        if torch.is_tensor(x):
            out.append(x if x.device == device else x.to(device))
        else:
            out.append(torch.as_tensor(np.asarray(x), device=device))
    return tuple(out)


def _finish_deferred(net, example_inputs):
    """Initialize a gluon block's deferred parameters with one forward of
    ``example_inputs`` in training mode (the JAX package traces the step
    with ``training=True``), in the order that forward reaches them."""
    from ..gluon.block import CachedOp
    from ..ndarray import NDArray
    if all(p._var is not None for p in net.collect_params().values()):
        return
    xs = tuple(x if isinstance(x, NDArray) else NDArray(x) for x in example_inputs)
    with autograd.train_mode():
        CachedOp(net)._ensure_params(xs)


def trainable(net):
    """[(name, parameter)] of ``net`` that require grad, shared parameters
    once."""
    seen, out = set(), []
    for name, p in net.named_parameters():
        if p.requires_grad and id(p) not in seen:
            seen.add(id(p))
            out.append((name, p))
    return out


_LOW = (torch.bfloat16, torch.float16)


@torch.no_grad()
def apply_updates(opt, params, states, lr_wd_t, rescale, grads=None):
    """Step every ``(name, parameter)`` of ``params`` with ``opt``'s pure
    ``update_step``, writing weights and ``states`` (a list, updated in
    place) back in their own dtypes. The step gets an f32 gradient and
    the weight and its floating state as they are when the weight is bf16
    or f16 (each ``update_step`` rounds where the JAX step rounds), in f32
    otherwise; an integer state leaf (SGLD's seed) is passed as it is.
    ``lr_wd_t(i)`` gives ``(lr, wd, t)`` of parameter ``i``; its gradient
    is ``grads[i]``, else its ``.grad``. A parameter without a gradient
    steps with a zero one (the JAX gradient of an unused parameter)."""
    for i, (_, p) in enumerate(params):
        g = grads[i] if grads is not None else p.grad
        g = g.float() if g is not None else torch.zeros_like(p, dtype=torch.float32)
        lr, wd, t = lr_wd_t(i)
        low = p.dtype in _LOW
        w = p.detach() if low else p.float()
        st = tuple(s.float() if s.is_floating_point() and not low else s for s in states[i])
        new_w, new_state = opt.update_step(w, g * rescale, st, lr, wd, t)
        p.copy_(new_w)
        states[i] = tuple(n.to(o.dtype) for o, n in zip(states[i], new_state))


class TrainStep:
    def __init__(self, net, loss_fn, optimizer, example_inputs: Sequence,
                 example_labels=None, mesh=None, data_spec=None, label_spec=None,
                 donate: bool = True, loss_has_aux: bool = False, remat: bool = False,
                 block_every: Optional[int] = None, zero: int = 0,
                 compression_params: Optional[dict] = None, health: bool = False,
                 health_config=None):
        """The JAX package's signature. ``example_inputs`` and
        ``example_labels`` are taken for it: the port runs eagerly, so
        nothing is traced from them. ``data_spec`` and ``label_spec`` place
        batches on a mesh and ``donate`` donates buffers to an executable:
        without a mesh and in eager PyTorch they mean nothing, so they are
        accepted and ignored. ``loss_has_aux`` is accepted and unused, as
        in the JAX package; ``health_config`` is read only with
        ``health=True``, which raises.

        ``remat=True`` recomputes the model's forward during the backward
        instead of keeping its activations: the JAX package's
        ``jax.checkpoint`` over the whole apply, here
        ``torch.utils.checkpoint`` (non-reentrant) around ``net(*inputs)``.
        The recomputed forward enters step t's ``KeySupply(key(t))``
        afresh, so its dropout sites draw the forward's keys; losses and
        parameters are those of ``remat=False`` bit for bit.

        ``block_every=W`` bounds :meth:`step`'s run-ahead: at most W steps
        stay in flight on the card, and the W+1-th ``step()`` waits on the
        oldest step's CUDA event. ``None`` leaves :meth:`step` unbounded.

        Switches ``net`` to training mode (the JAX package traces the step
        with ``training=True``): an ``nn.Module`` by ``net.train()``; a
        gluon block runs each forward under ``autograd.train_mode()``, its
        deferred parameters initialized first by one forward of
        ``example_inputs``. BatchNorm's running statistics move once a
        step, with or without ``remat``."""
        for flag, name in ((mesh is not None, "mesh"), (bool(zero), "zero"),
                           (bool(compression_params), "compression_params"),
                           (health, "health")):
            if flag:
                raise MXNetError(f"TrainStep({name}=...) {_LATER}")
        if block_every is not None and block_every < 1:
            raise MXNetError(f"block_every must be >= 1, got {block_every}")
        from ..gluon.block import Block
        self._gluon = isinstance(net, Block)
        if self._gluon:
            _finish_deferred(net, example_inputs)
        else:
            net.train()
        self.net = net
        self.loss_fn = loss_fn
        self.remat = remat
        self.block_every = block_every
        self.optimizer = optimizer if isinstance(optimizer, opt_mod.Optimizer) \
            else opt_mod.create(optimizer)
        self._params = trainable(net)
        self.optimizer.idx2name = {i: n for i, (n, _) in enumerate(self._params)}
        self._states = [self.optimizer.create_state(i, p)
                        for i, (_, p) in enumerate(self._params)]
        self._device = self._params[0][1].device if self._params else torch.device("cpu")
        self._step = 0
        # CUDA events of the steps dispatched by step() and not yet waited
        # on; with no window only the most recent 8 are kept (the card runs
        # a stream's work in order, so a later event implies the earlier)
        self._inflight: deque = deque(maxlen=None if block_every else 8)

    def _apply(self, inputs, t, calls=None):
        """The model's forward in step t's key supply (a gluon block in
        training mode, under the caller's AMP policy). Under ``remat`` the
        second call is the backward's recompute, on the autograd thread:
        it enters the same scopes, and its parameter writes (BatchNorm's
        running statistics) are dropped, as they were made in the first."""
        recompute = bool(calls)
        if calls is not None:
            calls.append(t)
        st = _tape.STATE
        prev = (st.amp_policy, st.recomputing)
        st.amp_policy, st.recomputing = self._amp, recompute
        try:
            with KeySupply(_prng.key(t)), \
                    autograd.train_mode() if self._gluon else nullcontext():
                return self.net(*inputs)
        finally:
            st.amp_policy, st.recomputing = prev

    def _loss(self, inputs, labels, t):
        self._amp = _tape.STATE.amp_policy
        if self.remat:
            outs = checkpoint(self._apply, inputs, t, [], use_reentrant=False)
        else:
            outs = self._apply(inputs, t)
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
        loss = self._loss(inputs, labels, t)
        loss.backward()
        apply_updates(opt, self._params, self._states,
                      lambda i: (opt._get_lr(i, lr), opt._get_wd(i), t), opt.rescale_grad)
        return loss.detach()

    def input_shardings(self):
        """``(data_placement, label_placement)`` to hand
        ``DataLoader.as_device_iterator`` / ``DevicePrefetcher``, so
        batches arrive on the step's device and the step takes them as
        they are. Without a mesh (the only case the port has) this is the
        step's device twice; the JAX package returns ``(None, None)`` there
        (its default device), which here would be the caller's current
        device, not necessarily the step's."""
        return (self._device, self._device)

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
        t0 = time.perf_counter() if _metrics.ENABLED else None
        out = self._one(_as_tensors(inputs, self._device), _as_tensors(labels, self._device))
        if t0 is not None:
            _observe_step(inputs, time.perf_counter() - t0, 1, "train_step")
        return out

    def step(self, inputs, labels=None):
        """The step of :meth:`__call__`, with its completion tracked: on the
        card a CUDA event is recorded after it, and with ``block_every=W``
        the host waits on the oldest event while more than W are in flight.
        The same steps in the same order as ``__call__``, so the same
        results; only the host's waits move. Call :meth:`drain` after the
        loop. On the CPU a step has finished when it returns: nothing stays
        in flight."""
        out = self(inputs, labels)
        if out.is_cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(out.device))
            self._inflight.append(ev)
        w = self.block_every
        while w and len(self._inflight) > w:
            self._inflight.popleft().synchronize()
        if _metrics.ENABLED:
            _metrics.PIPELINE_DEPTH.labels(path="train_step").set(len(self._inflight))
        return out

    def drain(self):
        """Wait until every step dispatched through :meth:`step` has run on
        the card (the end-of-epoch / pre-checkpoint barrier)."""
        while self._inflight:
            self._inflight.popleft().synchronize()
        if _metrics.ENABLED:
            _metrics.PIPELINE_DEPTH.labels(path="train_step").set(0)

    def run(self, inputs, labels=None, steps: int = 1):
        """``steps`` steps on the same batch, looped in Python. The step
        counter advances per step, so momentum and Adam's bias correction
        match ``steps`` separate calls. Returns the last loss in f32."""
        if steps == 1:
            return self(inputs, labels).float()
        t0 = time.perf_counter() if _metrics.ENABLED else None
        ins = _as_tensors(inputs, self._device)
        labels = _as_tensors(labels, self._device)
        loss = None
        for _ in range(steps):
            loss = self._one(ins, labels)
        if t0 is not None:
            _observe_step(inputs, time.perf_counter() - t0, steps, "train_step_multi")
        return loss.float()


def _observe_step(inputs, dt: float, steps: int, path: str):
    """Step-time histogram and examples throughput (host wall time; the
    card runs asynchronously, so an unsynchronised step reads as its
    dispatch time), as the JAX package's ``TrainStep._observe_step``."""
    _metrics.STEP_TIME.labels(path=path).observe(dt)
    x0 = inputs[0] if isinstance(inputs, (tuple, list)) else inputs
    shape = getattr(x0, "shape", ())
    examples = (shape[0] if shape else 1) * steps
    _metrics.EXAMPLES.labels(path=path).inc(examples)
    if dt > 0:
        _metrics.EXAMPLES_PER_SEC.labels(path=path).set(examples / dt)
