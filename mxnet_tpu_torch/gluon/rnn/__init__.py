"""Recurrent layers and cells (counterpart of
``mxnet_tpu/gluon/rnn/__init__.py``): the fused layers ``RNN``, ``LSTM``
and ``GRU``, and the cells ``RNNCell``, ``LSTMCell``, ``GRUCell`` and
``SequentialRNNCell``.

The JAX package's parameter names (``l0_i2h_weight`` ... ``r{L}_h2h_bias``)
and ``[gates * H, in]`` shapes, deferred input size, f32 ``begin_state``,
``TNC``/``NTC`` layouts and gate orders (LSTM ``[i, f, c, o]``, GRU ``[r,
z, n]`` with ``n = tanh(xn + r * (h Wh^T + bh))``) are kept.

A layer on the CPU runs the JAX package's scan as a loop over time, the
same cell arithmetic a step. On the card it runs cuDNN's fused RNN through
``torch._VF.{lstm, gru, rnn_tanh, rnn_relu}``, one call a layer with both
directions in it and the JAX layout's weights as they are: the JAX
package's scan stands in for the reference's fused cuDNN op, and no TPU
kernel is involved (the library's, like the convolutions). Inter-layer
dropout is the JAX package's draw, applied between the per-layer calls:
``bernoulli(fold_in(next_key(), layer), 1 - p)`` from the port's threefry
in f64 (the JAX package runs with x64), so the masks equal the JAX
package's bit for bit for one seed; cuDNN's own dropout is never used.
The cells, ``unroll`` and ``SequentialRNNCell`` are plain torch ops
through the funnel.
"""
from __future__ import annotations

import warnings
from typing import Optional

import numpy as onp
import torch

from ... import _prng, _tape
from ..._random import next_key
from ...base import MXNetError
from ...ndarray import NDArray, apply_multi, asarray
from ..block import Block, HybridBlock
from ..parameter import Parameter

__all__ = ["RNN", "LSTM", "GRU", "RNNCell", "LSTMCell", "GRUCell",
           "SequentialRNNCell", "HybridSequentialRNNCell"]

def _gates(mode: str) -> int:
    return {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}[mode]


def _cell_step(mode: str):
    """``step(xw, states, wh, bh) -> (out, states)`` where ``xw`` is the
    input's ``x @ wi.T + bi``; the JAX package's ``_cell_step``."""
    if mode in ("rnn_relu", "rnn_tanh"):
        act = torch.relu if mode == "rnn_relu" else torch.tanh

        def step(xw, states, wh, bh):
            (h,) = states
            h_new = act(xw + h @ wh.T + bh)
            return h_new, (h_new,)
        return step
    if mode == "lstm":
        def step(xw, states, wh, bh):
            h, c = states
            i, f, g, o = (xw + h @ wh.T + bh).chunk(4, dim=-1)
            c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h_new = torch.sigmoid(o) * torch.tanh(c_new)
            return h_new, (h_new, c_new)
        return step
    if mode == "gru":
        def step(xw, states, wh, bh):
            (h,) = states
            xr, xz, xn = xw.chunk(3, dim=-1)
            hr, hz, hn = (h @ wh.T + bh).chunk(3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            h_new = (1 - z) * n + z * h
            return h_new, (h_new,)
        return step
    raise MXNetError(f"unknown RNN mode {mode}")


def _scan(mode, seq, init, wi, bi, wh, bh):
    """One direction over ``seq`` [T, B, in]: (outputs [T, B, H], final
    states)."""
    step = _cell_step(mode)
    xw = seq @ wi.T + bi
    states, ys = tuple(init), []
    for t in range(seq.shape[0]):
        h, states = step(xw[t], states, wh, bh)
        ys.append(h)
    return torch.stack(ys), states


def _keep_mask(key, p: float, shape, device):
    """``jax.random.bernoulli(key, 1 - p, shape)`` with the JAX package's
    x64: an f64 uniform from 64 bits a position, drawn on ``device``."""
    n = int(onp.prod(shape, dtype=onp.int64))
    idx = torch.arange(n, dtype=torch.int64, device=device)
    k = key.to(device)
    y0, y1 = _prng.threefry2x32(k[0], k[1], idx >> 32, idx & _prng.M32)
    mant = (y0 << 20) | (y1 >> 12)
    u = (mant | 0x3FF0000000000000).view(torch.float64) - 1.0
    return (u < 1.0 - p).reshape(shape)


def _layer_cudnn(mode, x, init, weights, bidirectional, train):
    """One layer, both directions, through cuDNN's fused RNN (``train``
    keeps what its backward needs; its dropout is 0)."""
    fn = getattr(torch._VF, mode)      # the modes are _VF's names
    with warnings.catch_warnings():
        # per-layer weights are separate tensors, not one flattened buffer
        warnings.simplefilter("ignore", UserWarning)
        if mode == "lstm":
            out, h, c = fn(x, init, weights, True, 1, 0.0, train, bidirectional, False)
            return out, (h, c)
        out, h = fn(x, init[0], weights, True, 1, 0.0, train, bidirectional, False)
    return out, (h,)


class _RNNLayer(HybridBlock):
    def __init__(self, mode: str, hidden_size: int, num_layers: int = 1, layout: str = "TNC",
                 dropout: float = 0.0, bidirectional: bool = False, input_size: int = 0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 dtype=onp.float32, **kwargs):
        super().__init__()
        if layout not in ("TNC", "NTC"):
            raise MXNetError(f"bad layout {layout}")
        self._mode = mode
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        for name, shape, init in self._param_specs(input_size, i2h_weight_initializer,
                                                   h2h_weight_initializer,
                                                   i2h_bias_initializer,
                                                   h2h_bias_initializer):
            setattr(self, name, Parameter(name, shape=shape, dtype=dtype, init=init,
                                          allow_deferred_init=True))

    def _param_specs(self, input_size, *inits):
        ng, H = _gates(self._mode), self._hidden_size
        inits = inits or (None,) * 4
        for layer in range(self._num_layers):
            for d in range(self._dir):
                prefix = f"{'lr'[d]}{layer}_"
                in_sz = input_size if layer == 0 else H * self._dir
                yield prefix + "i2h_weight", (ng * H, in_sz), inits[0]
                yield prefix + "h2h_weight", (ng * H, H), inits[1]
                yield prefix + "i2h_bias", (ng * H,), inits[2]
                yield prefix + "h2h_bias", (ng * H,), inits[3]

    def _num_states(self) -> int:
        return 2 if self._mode == "lstm" else 1

    def state_info(self, batch_size: int = 0):
        shape = (self._num_layers * self._dir, batch_size, self._hidden_size)
        return [{"shape": shape, "__layout__": "LNC"} for _ in range(self._num_states())]

    def begin_state(self, batch_size: int = 0, func=None, device=None, **kwargs):
        shape = (self._num_layers * self._dir, batch_size, self._hidden_size)
        return [NDArray(onp.zeros(shape, onp.float32), device=device)
                for _ in range(self._num_states())]

    def forward(self, inputs, states=None):
        raw = isinstance(inputs, torch.Tensor)
        inputs = inputs if raw else asarray(inputs)
        batch = inputs.shape[0] if self._layout == "NTC" else inputs.shape[1]
        if self._input_size == 0:
            self._input_size = inputs.shape[-1]
        for name, shape, _ in self._param_specs(self._input_size):
            p = getattr(self, name)
            if p._var is None:
                p.shape = shape
                p._finish_deferred_init()
        ret_states = states is not None
        if states is None:
            dev = inputs.device if raw else inputs._data.device
            states = self.begin_state(batch, device=dev)
        if isinstance(states, (NDArray, torch.Tensor)):
            states = [states]
        states = [s if isinstance(s, torch.Tensor) else asarray(s) for s in states]
        mode, layout, L, ndir = self._mode, self._layout, self._num_layers, self._dir
        nstates, dropout = self._num_states(), self._dropout
        params = [getattr(self, f"{'lr'[d]}{layer}_{n}").data()
                  for layer in range(L) for d in range(ndir)
                  for n in ("i2h_weight", "i2h_bias", "h2h_weight", "h2h_bias")]
        training = _tape.is_training()
        drop_key = next_key() if (dropout > 0 and training) else None

        def fn(x, *flat):
            state_arrs, weights = flat[:nstates], flat[nstates:]
            if layout == "NTC":
                x = x.transpose(0, 1)
            out, finals = x, [[] for _ in range(nstates)]
            for layer in range(L):
                lw = weights[layer * ndir * 4:(layer + 1) * ndir * 4]
                init = [s[layer * ndir:(layer + 1) * ndir] for s in state_arrs]
                if out.is_cuda:
                    # cuDNN takes (w_ih, w_hh, b_ih, b_hh) a direction
                    cw = [w for d in range(ndir) for w in
                          (lw[4 * d], lw[4 * d + 2], lw[4 * d + 1], lw[4 * d + 3])]
                    out, last = _layer_cudnn(mode, out.contiguous(), tuple(init), cw,
                                             ndir == 2, torch.is_grad_enabled())
                    for si in range(nstates):
                        finals[si].append(last[si])
                else:
                    dir_outs = []
                    for d in range(ndir):
                        wi, bi, wh, bh = lw[4 * d:4 * d + 4]
                        seq = out if d == 0 else torch.flip(out, dims=(0,))
                        ys, last = _scan(mode, seq, [s[d] for s in init], wi, bi, wh, bh)
                        dir_outs.append(ys if d == 0 else torch.flip(ys, dims=(0,)))
                        for si in range(nstates):
                            finals[si].append(last[si][None])
                    out = dir_outs[0] if ndir == 1 else torch.cat(dir_outs, dim=-1)
                if drop_key is not None and layer < L - 1:
                    keep = _keep_mask(_prng.fold_in(drop_key, layer), dropout, out.shape,
                                      out.device)
                    out = torch.where(keep, out / (1 - dropout),
                                      torch.zeros((), dtype=out.dtype, device=out.device))
            if layout == "NTC":
                out = out.transpose(0, 1)
            return (out,) + tuple(torch.cat(f, dim=0) for f in finals)

        outs = apply_multi(fn, [inputs] + states + params, name=f"rnn_{mode}")
        out, new_states = outs[0], list(outs[1:])
        return (out, new_states) if ret_states else out

    def __repr__(self):
        return (f"{type(self).__name__}({self._hidden_size}, "
                f"num_layers={self._num_layers}, bidirectional={self._dir == 2})")


class RNN(_RNNLayer):
    """Elman RNN layer; ``activation`` relu (the default) or tanh."""

    def __init__(self, hidden_size, num_layers=1, activation="relu", **kwargs):
        super().__init__(f"rnn_{activation}", hidden_size, num_layers, **kwargs)


class LSTM(_RNNLayer):
    def __init__(self, hidden_size, num_layers=1, **kwargs):
        super().__init__("lstm", hidden_size, num_layers, **kwargs)


class GRU(_RNNLayer):
    def __init__(self, hidden_size, num_layers=1, **kwargs):
        super().__init__("gru", hidden_size, num_layers, **kwargs)


# ---------------------------------------------------------------- cells

class RecurrentCell(Block):
    """Base cell: ``begin_state`` and ``unroll``."""

    def state_info(self, batch_size: int = 0):
        raise NotImplementedError

    def begin_state(self, batch_size: int = 0, func=None, device=None, **kwargs):
        return [NDArray(onp.zeros(info["shape"], onp.float32), device=device)
                for info in self.state_info(batch_size)]

    def unroll(self, length: int, inputs, begin_state=None, layout: str = "NTC",
               merge_outputs: Optional[bool] = None, valid_length=None):
        """Step the cell over ``length`` steps of ``inputs``; the outputs
        are stacked along the layout's time axis unless ``merge_outputs``
        is False."""
        inputs = asarray(inputs)
        axis = layout.find("T")
        batch = inputs.shape[layout.find("N")]
        states = begin_state if begin_state is not None else \
            self.begin_state(batch, device=inputs._data.device)
        outputs = []
        for t in range(length):
            x_t = inputs[t] if axis == 0 else inputs[:, t]
            out, states = self(x_t, states)
            outputs.append(out)
        if merge_outputs is None or merge_outputs:
            outputs = apply_multi(lambda *ts: torch.stack(ts, dim=axis), outputs)
        return outputs, states


class _SimpleCell(RecurrentCell):
    def __init__(self, mode: str, hidden_size: int, input_size: int = 0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 dtype=onp.float32):
        super().__init__()
        self._mode = mode
        self._hidden_size = hidden_size
        self._input_size = input_size
        ng = _gates(mode)
        self.i2h_weight = Parameter("i2h_weight", shape=(ng * hidden_size, input_size),
                                    dtype=dtype, init=i2h_weight_initializer,
                                    allow_deferred_init=True)
        self.h2h_weight = Parameter("h2h_weight", shape=(ng * hidden_size, hidden_size),
                                    dtype=dtype, init=h2h_weight_initializer,
                                    allow_deferred_init=True)
        self.i2h_bias = Parameter("i2h_bias", shape=(ng * hidden_size,), dtype=dtype,
                                  init=i2h_bias_initializer)
        self.h2h_bias = Parameter("h2h_bias", shape=(ng * hidden_size,), dtype=dtype,
                                  init=h2h_bias_initializer)

    def state_info(self, batch_size: int = 0):
        n = 2 if self._mode == "lstm" else 1
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"}
                for _ in range(n)]

    def forward(self, x, states):
        x = asarray(x)
        if self.i2h_weight._var is None:
            self.i2h_weight.shape = (_gates(self._mode) * self._hidden_size, x.shape[-1])
            self.i2h_weight._finish_deferred_init()
            self.h2h_weight._finish_deferred_init()
        step = _cell_step(self._mode)
        nstates = 2 if self._mode == "lstm" else 1
        states = [asarray(s) for s in (states if isinstance(states, (list, tuple))
                                       else [states])]

        def fn(x_, *rest):
            wi, bi, wh, bh = rest[nstates:]
            out, new = step(x_ @ wi.T + bi, tuple(rest[:nstates]), wh, bh)
            return (out,) + new

        outs = apply_multi(fn, [x] + states + [
            self.i2h_weight.data(), self.i2h_bias.data(), self.h2h_weight.data(),
            self.h2h_bias.data()], name=f"{self._mode}_cell")
        return outs[0], list(outs[1:])


class RNNCell(_SimpleCell):
    def __init__(self, hidden_size, activation="tanh", **kwargs):
        super().__init__(f"rnn_{activation}", hidden_size, **kwargs)


class LSTMCell(_SimpleCell):
    def __init__(self, hidden_size, **kwargs):
        super().__init__("lstm", hidden_size, **kwargs)


class GRUCell(_SimpleCell):
    def __init__(self, hidden_size, **kwargs):
        super().__init__("gru", hidden_size, **kwargs)


class SequentialRNNCell(RecurrentCell):
    """A stack of cells, each fed the one before's output."""

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size: int = 0):
        return [s for cell in self._children.values() for s in cell.state_info(batch_size)]

    def begin_state(self, batch_size: int = 0, **kwargs):
        return [s for cell in self._children.values()
                for s in cell.begin_state(batch_size, **kwargs)]

    def forward(self, x, states):
        new_states, i = [], 0
        for cell in self._children.values():
            n = len(cell.state_info(0))
            x, st = cell(x, states[i:i + n])
            new_states.extend(st)
            i += n
        return x, new_states


HybridSequentialRNNCell = SequentialRNNCell
