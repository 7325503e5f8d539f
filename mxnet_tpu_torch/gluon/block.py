"""Gluon ``Block``, ``HybridBlock``, ``CachedOp``, ``Sequential`` and
``HybridSequential`` (counterpart of ``mxnet_tpu/gluon/block.py``), and
the parameter files of a block or of an ``nn.Module``.

Children and parameters register on attribute assignment, and
``collect_params()`` names them by structural path (``0.weight``), as the
JAX package does, so the two packages read each other's ``.params``
files. A block called on NDArrays computes through the funnel and the
tape; called on torch tensors it is a function of its parameters' tensors
in PyTorch's own autograd (``named_parameters()`` lists them).

``hybridize()`` makes a ``HybridBlock`` run through a :class:`CachedOp`:
one cache entry per (input shapes and dtypes, training, AMP policy), a
warning on every new signature after the first and the
``mxnet_recompilations_total`` and ``mxnet_cachedop_cache_hits_total``
counters, as in the JAX package.
Each call draws the JAX CachedOp's int32 seed from the global key stream
and runs the forward under ``KeySupply(key(seed))``, so its dropout masks
are the JAX package's. On the card, a block hybridized with
``static_alloc=True`` and called outside ``autograd.record()`` replays one
CUDA graph per cache entry from its second call on (the first runs
eagerly); under ``record()`` it runs eagerly on the same ops.

``SymbolBlock``, ``export``, ``imports`` and ``optimize_for`` wait for the
AOT/ONNX slice (ROADMAP Queue 1) and raise.
"""
from __future__ import annotations

import re
import threading
from collections import OrderedDict
from contextlib import contextmanager, nullcontext
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as onp
import torch

from .. import _prng, _tape, autograd, serialization
from .. import metrics as _metrics
from .._random import KeySupply, next_key
from ..base import MXNetError, logger
from ..ndarray import NDArray
from .parameter import DRY, Parameter

__all__ = ["Block", "HybridBlock", "CachedOp", "Sequential", "HybridSequential",
           "SymbolBlock", "save_parameters", "load_parameters"]

_LATER = "waits for the AOT/ONNX slice (ROADMAP Queue 1)"


@contextmanager
def _amp_policy_scope(policy):
    prev = _tape.STATE.amp_policy
    _tape.STATE.amp_policy = policy
    try:
        yield
    finally:
        _tape.STATE.amp_policy = prev


class _Inline(threading.local):
    """Set while a CachedOp runs its block: hybridized children inline."""

    def __init__(self):
        self.depth = 0


_INLINE = _Inline()


class Block:
    """Base class of layers and models."""

    def __init__(self):
        self._children: "OrderedDict[str, Block]" = OrderedDict()
        self._reg_params: "OrderedDict[str, Parameter]" = OrderedDict()
        self._forward_hooks: List[Callable] = []
        self._forward_pre_hooks: List[Callable] = []

    def __setattr__(self, name, value):
        if isinstance(value, Block):
            self.__dict__.setdefault("_children", OrderedDict())[name] = value
        elif isinstance(value, Parameter):
            self.__dict__.setdefault("_reg_params", OrderedDict())[name] = value
            if value._name in ("param", "const"):
                value._name = name
        else:
            # a non-block value deregisters what the name held
            self.__dict__.get("_children", {}).pop(name, None)
            self.__dict__.get("_reg_params", {}).pop(name, None)
        super().__setattr__(name, value)

    def register_child(self, block: "Block", name: Optional[str] = None):
        self._children[name or str(len(self._children))] = block

    # ------------------------------------------------------------ params
    def _collect_params_with_prefix(self, prefix: str = "") -> "OrderedDict[str, Parameter]":
        out: "OrderedDict[str, Parameter]" = OrderedDict()
        if prefix:
            prefix += "."
        for name, p in self._reg_params.items():
            out[prefix + name] = p
        for name, child in self._children.items():
            out.update(child._collect_params_with_prefix(prefix + name))
        return out

    def collect_params(self, select: Optional[str] = None) -> "OrderedDict[str, Parameter]":
        """All parameters by structural path; ``select`` is a regex."""
        params = self._collect_params_with_prefix()
        if select is None:
            return params
        pat = re.compile(select)
        return OrderedDict((k, v) for k, v in params.items() if pat.search(k))

    @property
    def params(self) -> "OrderedDict[str, Parameter]":
        return self.collect_params()

    def named_parameters(self):
        """(name, tensor) of every initialized parameter, shared ones once:
        the leaves a torch-tensor call differentiates."""
        seen = set()
        for name, p in self.collect_params().items():
            if p._var is not None and id(p) not in seen:
                seen.add(id(p))
                yield name, p._var._data

    def parameters(self):
        return (t for _, t in self.named_parameters())

    def initialize(self, init=None, device=None, ctx=None, verbose: bool = False,
                   force_reinit: bool = False):
        device = device or ctx
        for p in self.collect_params().values():
            p.initialize(init=None if p.init is not None else init, device=device,
                         default_init=init, force_reinit=force_reinit)
        return self

    def zero_grad(self):
        for p in self.collect_params().values():
            p.zero_grad()

    def cast(self, dtype):
        for p in self.collect_params().values():
            p.cast(dtype)

    def reset_device(self, device):
        for p in self.collect_params().values():
            p.reset_ctx(device)

    def apply(self, fn: Callable[["Block"], None]):
        for child in self._children.values():
            child.apply(fn)
        fn(self)
        return self

    def share_parameters(self, shared: Dict[str, Parameter]):
        """Tie parameters by structural name."""
        own = self.collect_params()
        for name, p in shared.items():
            if name not in own:
                raise MXNetError(f"share_parameters: no parameter {name}")
            holder, attr = self._find_param_holder(name)
            holder._reg_params[attr] = p
            object.__setattr__(holder, attr, p)
        return self

    def _find_param_holder(self, path: str) -> Tuple["Block", str]:
        parts = path.split(".")
        blk = self
        for part in parts[:-1]:
            blk = blk._children[part]
        return blk, parts[-1]

    # ------------------------------------------------------------ hooks
    def register_forward_hook(self, hook):
        self._forward_hooks.append(hook)
        return hook

    def register_forward_pre_hook(self, hook):
        self._forward_pre_hooks.append(hook)
        return hook

    def summary(self, *inputs):
        """Print each layer's output shape and parameter count for one
        forward of ``inputs``; returns the total parameter count."""
        rows, hooks = [], []

        def hook(block, args, out):
            outs = out if isinstance(out, (tuple, list)) else (out,)
            n = sum(int(onp.prod(p.shape)) for p in block._reg_params.values()
                    if p.shape is not None)
            rows.append((type(block).__name__, [tuple(o.shape) for o in outs], n))

        def attach(b):
            b._forward_hooks.append(hook)
            hooks.append(b)
        self.apply(attach)
        try:
            with autograd.pause():
                self(*inputs)
        finally:
            for b in hooks:
                b._forward_hooks.remove(hook)
        total = sum(int(onp.prod(p.shape)) for p in
                    {id(p): p for p in self.collect_params().values()}.values())
        print(f"{'Layer':<28}{'Output shape':<32}{'Params':>12}")
        for name, shapes, n in rows:
            print(f"{name:<28}{str(shapes[0] if len(shapes) == 1 else shapes):<32}{n:>12}")
        print(f"Total params: {total}")
        return total

    # ------------------------------------------------------------ files
    def save_parameters(self, filename: str, deduplicate: bool = False):
        """Every parameter by structural name; a shared one once with
        ``deduplicate``."""
        data, seen = {}, set()
        for name, p in self.collect_params().items():
            arr = p.data()
            if deduplicate and id(arr) in seen:
                continue
            seen.add(id(arr))
            data[name] = arr._data.detach()
        serialization.save(filename, data)

    def load_parameters(self, filename: str, device=None, ctx=None,
                        allow_missing: bool = False, ignore_extra: bool = False,
                        cast_dtype: bool = False):
        loaded = serialization.load(filename)
        if isinstance(loaded, list):
            raise MXNetError(f"{filename}: expected named parameter dict")
        return self._load(loaded, device or ctx, allow_missing, ignore_extra, cast_dtype,
                          f"in {filename}")

    def load_dict(self, param_dict, device=None, allow_missing=False, ignore_extra=False,
                  cast_dtype=False):
        """Load ``{name: NDArray, tensor or numpy array}`` (e.g. the JAX
        package's ``{n: p.data().asnumpy()}``)."""
        return self._load(param_dict, device, allow_missing, ignore_extra, cast_dtype, "")

    def _load(self, named, device, allow_missing, ignore_extra, cast_dtype, where):
        params = self.collect_params()
        for name, p in params.items():
            if name in named:
                v = named[name]
                v = v if isinstance(v, NDArray) else NDArray(
                    v if isinstance(v, torch.Tensor) else onp.asarray(v), device="cpu")
                p._load_init(v, device, cast_dtype=cast_dtype)
            elif not allow_missing:
                raise MXNetError(f"load_parameters: missing parameter {name} {where}".strip())
        if not ignore_extra:
            extra = set(named) - set(params)
            if extra:
                raise MXNetError(f"load_parameters: extra parameters {sorted(extra)}")
        return self

    # ------------------------------------------------------------ calling
    def _amp_scope(self):
        """This block's AMP policy (``amp.convert_hybrid_block``) as the
        thread's for the duration of a forward."""
        pol = getattr(self, "_amp_policy", None)
        return nullcontext() if pol is None else _amp_policy_scope(pol)

    def __call__(self, *args, **kwargs):
        with self._amp_scope():
            for hook in self._forward_pre_hooks:
                hook(self, args)
            out = self.forward(*args, **kwargs)
            for hook in self._forward_hooks:
                hook(self, args, out)
            return out

    def forward(self, *args, **kwargs):
        raise NotImplementedError

    def hybridize(self, active: bool = True, **kwargs):
        for child in self._children.values():
            child.hybridize(active, **kwargs)
        return self

    def __repr__(self):
        lines = [type(self).__name__ + "("]
        for name, child in self._children.items():
            lines.append(f"  ({name}): " + repr(child).replace("\n", "\n  "))
        lines.append(")")
        return "\n".join(lines) if len(lines) > 2 else "".join(lines)


def _flat(out) -> List[NDArray]:
    if isinstance(out, NDArray):
        return [out]
    if isinstance(out, (tuple, list)):
        return [a for o in out for a in _flat(o)]
    raise MXNetError(f"hybridized outputs must nest tuples/lists of arrays, "
                     f"not {type(out).__name__}")


def _rebuild(like, vals: List[NDArray], pos=None):
    """``like``'s nesting over the arrays of ``vals`` in order."""
    pos = pos if pos is not None else [0]
    if isinstance(like, NDArray):
        pos[0] += 1
        return vals[pos[0] - 1]
    return type(like)(_rebuild(o, vals, pos) for o in like)


class _Graph:
    """One cache entry's CUDA graph: static inputs and key, the captured
    forward's outputs, the launch tally of the capture, and the parameter
    storage it read (a rebound parameter forces a new capture). Dropout
    keys fold on the device, so they capture; ``mx.np.random`` draws on
    the host and cannot be captured."""

    def __init__(self, op: "CachedOp", inputs, seed: int):
        from ..ops import int8_gemv
        dev = inputs[0]._data.device
        self.ptrs = op._param_ptrs()
        self.inputs = [x._data.detach().clone() for x in inputs]
        self.key = _prng.key(seed, device=dev)
        self.graph = torch.cuda.CUDAGraph()
        with int8_gemv.record_graph() as tally:
            with torch.cuda.graph(self.graph):
                outs = op._run([NDArray._new(t) for t in self.inputs], self.key)
                tally.seal()
        self.tally = tally
        self.like = outs
        self.outs = [o._data for o in _flat(outs)]

    def replay(self, inputs, seed: int):
        for dst, x in zip(self.inputs, inputs):
            dst.copy_(x._data)
        self.key.copy_(_prng.key(seed))
        self.graph.replay()
        self.tally.replayed()
        return _rebuild(self.like, [NDArray._new(t.clone()) for t in self.outs])


class CachedOp:
    """The executor of a hybridized block."""

    def __init__(self, block: "HybridBlock", static_alloc: bool = False,
                 static_shape: bool = False):
        self.block = block
        self.static_alloc = static_alloc
        self.static_shape = static_shape
        self._cache: Dict[Any, Dict[str, Any]] = {}
        self._param_items: Optional[List[Tuple[str, Parameter]]] = None
        self.replays = 0            # CUDA-graph replays, over every entry

    def _ensure_params(self, inputs):
        """Infer deferred shapes with one forward on zero placeholders
        (under ``KeySupply(key(0))``, taking no key of the global stream),
        then initialize the deferred parameters in the order the forward
        reached them, as the JAX CachedOp does after its shape trace."""
        if self._param_items is not None:
            return
        if any(p._var is None for p in self.block.collect_params().values()):
            pending: List[Parameter] = []
            prev = (DRY.bindings, DRY.pending)
            DRY.bindings, DRY.pending = {}, pending
            _INLINE.depth += 1
            try:
                with torch.no_grad(), KeySupply(_prng.key(0)), \
                        autograd.pause(train_mode=autograd.is_training()), \
                        self.block._amp_scope():
                    self.block.forward(*inputs)
            finally:
                _INLINE.depth -= 1
                DRY.bindings, DRY.pending = prev
            for p in pending:
                p._finish_deferred_init()
        self._param_items = list(self.block.collect_params().items())

    def _param_ptrs(self):
        return tuple(p._var._data.data_ptr() for _, p in self._param_items
                     if p._var is not None)

    def _run(self, inputs, base_key):
        _INLINE.depth += 1
        try:
            with KeySupply(base_key):
                return self.block.forward(*inputs)
        finally:
            _INLINE.depth -= 1

    def __call__(self, *inputs: NDArray):
        self._ensure_params(inputs)
        training = _tape.is_training()
        # the AMP policy is part of the signature: a trace under another
        # (or no) policy casts differently
        pol = _tape.effective_amp_policy()
        key = tuple((tuple(x.shape), str(x.dtype)) for x in inputs) \
            + (training, None if pol is None else pol.name)
        entry = self._cache.get(key)
        bname = type(self.block).__name__
        if entry is None:
            if self._cache:
                logger.warning("CachedOp(%s): recompilation #%d — new signature %s not in "
                               "trace cache (%d cached)", bname, len(self._cache),
                               _sig_str(key), len(self._cache))
            if _metrics.ENABLED:
                _metrics.RECOMPILATIONS.labels(
                    block=bname, kind="retrace" if self._cache else "initial").inc()
            entry = self._cache[key] = {"calls": 0, "graph": None}
        elif _metrics.ENABLED:
            _metrics.CACHE_HITS.labels(block=bname).inc()
        # the JAX CachedOp's per-call seed: randint(next_key(), (), 0, 2**31 - 1)
        seed = _prng.cachedop_seed(next_key())
        entry["calls"] += 1
        if (self.static_alloc and not _tape.is_recording() and entry["calls"] > 1
                and inputs and all(x._data.is_cuda for x in inputs)):
            g = entry["graph"]
            if g is None or g.ptrs != self._param_ptrs():
                g = entry["graph"] = _Graph(self, inputs, seed)
            self.replays += 1
            return g.replay(inputs, seed)
        return self._run(inputs, _prng.key(seed))

    @property
    def cache_size(self) -> int:
        return len(self._cache)


def _sig_str(key) -> str:
    *ins, training, amp = key
    shapes = ", ".join(f"{s}:{d}" for s, d in ins)
    return f"inputs=[{shapes}], training={training}, amp={amp}"


class HybridBlock(Block):
    """A block that can run through a :class:`CachedOp`."""

    def __init__(self):
        super().__init__()
        self._active = False
        self._cached_op: Optional[CachedOp] = None
        self._cached_op_args: Dict[str, Any] = {}

    def hybridize(self, active: bool = True, static_alloc: bool = False,
                  static_shape: bool = False, **kwargs):
        self._active = active
        self._cached_op = None
        self._cached_op_args = {"static_alloc": static_alloc, "static_shape": static_shape}
        super().hybridize(active, static_alloc=static_alloc, static_shape=static_shape,
                          **kwargs)
        return self

    def __call__(self, *args, **kwargs):
        if self._active and not kwargs and args and _INLINE.depth == 0 \
                and all(isinstance(a, NDArray) for a in args):
            for hook in self._forward_pre_hooks:
                hook(self, args)
            if self._cached_op is None:
                self._cached_op = CachedOp(self, **self._cached_op_args)
            with self._amp_scope():
                out = self._cached_op(*args)
            for hook in self._forward_hooks:
                hook(self, args, out)
            return out
        return super().__call__(*args, **kwargs)

    def infer_shape(self, *args):
        """Infer deferred parameter shapes (and initialize them)."""
        CachedOp(self)._ensure_params(tuple(a if isinstance(a, NDArray) else NDArray(a)
                                            for a in args))

    def optimize_for(self, *args, **kwargs):
        raise MXNetError(f"HybridBlock.optimize_for {_LATER}")

    def export(self, *args, **kwargs):
        raise MXNetError(f"HybridBlock.export {_LATER}")


class SymbolBlock(HybridBlock):
    """A model reloaded from an exported artifact."""

    def __init__(self, *args, **kwargs):
        raise MXNetError(f"SymbolBlock {_LATER}")

    @staticmethod
    def imports(*args, **kwargs):
        raise MXNetError(f"SymbolBlock.imports {_LATER}")


class Sequential(Block):
    """Children called in order."""

    def __init__(self, *blocks):
        super().__init__()
        for b in blocks:
            self.add(b)

    def add(self, *blocks):
        for b in blocks:
            self.register_child(b)
        return self

    def forward(self, x, *args):
        for child in self._children.values():
            x = child(x, *args)
            args = ()
        return x

    def __len__(self):
        return len(self._children)

    def __getitem__(self, idx):
        values = list(self._children.values())
        if isinstance(idx, slice):
            net = type(self)()
            for v in values[idx]:
                net.add(v)
            return net
        return values[idx]

    def __iter__(self):
        return iter(self._children.values())


class HybridSequential(HybridBlock, Sequential):
    """Children called in order, hybridizable."""

    def __init__(self, *blocks):
        HybridBlock.__init__(self)
        for b in blocks:
            self.add(b)


# --------------------------------------------------- files of nn.Modules

def save_parameters(net, filename: str, deduplicate: bool = False):
    """Save every parameter of ``net`` (a gluon block, or an ``nn.Module``
    by ``named_parameters()`` names, which are the JAX model's
    ``collect_params()`` names) by name. A parameter shared under two names
    is saved under both, or under its first name only with
    ``deduplicate=True``."""
    if isinstance(net, Block):
        return net.save_parameters(filename, deduplicate)
    data, seen = {}, set()
    for name, p in net.named_parameters(remove_duplicate=False):
        if deduplicate and id(p) in seen:
            continue
        seen.add(id(p))
        data[name] = p.detach()
    serialization.save(filename, data)


@torch.no_grad()
def load_parameters(net, filename: str, device=None, allow_missing: bool = False,
                    ignore_extra: bool = False, cast_dtype: bool = False):
    """Load ``filename`` into ``net``'s parameters, on each parameter's
    device (``device`` is accepted for the JAX signature). A loaded array
    keeps its dtype unless ``cast_dtype``, which casts it to the
    parameter's. Raises on a missing name unless ``allow_missing``, on a
    name ``net`` lacks unless ``ignore_extra``, and on a shape mismatch."""
    if isinstance(net, Block):
        return net.load_parameters(filename, device, allow_missing=allow_missing,
                                   ignore_extra=ignore_extra, cast_dtype=cast_dtype)
    loaded = serialization.load(filename)
    if isinstance(loaded, list):
        raise MXNetError(f"{filename}: expected named parameter dict")
    params = dict(net.named_parameters(remove_duplicate=False))
    for name, p in params.items():
        if name not in loaded:
            if not allow_missing:
                raise MXNetError(f"load_parameters: missing parameter {name} in {filename}")
            continue
        v = loaded[name]
        if tuple(v.shape) != tuple(p.shape):
            raise MXNetError(f"Parameter {name}: loaded shape {tuple(v.shape)} != "
                             f"expected {tuple(p.shape)}")
        if cast_dtype or v.dtype == p.dtype:
            p.copy_(v.to(p.dtype))
        else:
            p.data = v.to(p.device)
    if not ignore_extra:
        extra = set(loaded) - set(params)
        if extra:
            raise MXNetError(f"load_parameters: extra parameters {sorted(extra)}")
    return net
