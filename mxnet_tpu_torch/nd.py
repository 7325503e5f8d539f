"""``mx.nd``: the legacy NDArray namespace (counterpart of
``mxnet_tpu/nd.py``).

It re-exports the frontend's ops under their legacy names (the ops are
``mx.np``'s and ``mx.npx``'s) and adds the legacy-only spellings: the
reference's operator registry names that scripts use (``Activation``,
``FullyConnected``, ``SliceChannel``, ``LRN``, ``ctc_loss``, the
``*_update`` optimizer ops, the regression output heads, ``Custom``, ...),
each a torch function behind the funnel, with the JAX package's
semantics. The optimizer ops are functional: they return the updated
weight and state, as the JAX package's.
"""
from __future__ import annotations

import builtins
import functools
import operator

import numpy as onp
import torch

from . import numpy as _np
from . import numpy_extension as _npx
from . import _prng
from ._random import next_key
from .base import MXNetError
from .ndarray import NDArray, apply_multi, invoke, waitall  # noqa: F401
from . import load, save  # noqa: F401  (NDArrays in, NDArrays out)

_SHARED = [
    "zeros", "ones", "full", "arange", "array", "empty", "eye", "linspace",
    "abs", "sign", "exp", "log", "log2", "log10", "sqrt", "square", "cbrt",
    "sin", "cos", "tan", "arcsin", "arccos", "arctan", "sinh", "cosh", "tanh",
    "floor", "ceil", "trunc", "round", "clip", "maximum", "minimum", "where",
    "add", "subtract", "multiply", "divide", "power", "mod", "dot",
    "sum", "prod", "mean", "max", "min", "argmax", "argmin", "stack",
    "concatenate", "split", "tile", "repeat", "expand_dims", "squeeze",
    "transpose", "reshape", "broadcast_to", "take", "sort",
    "argsort", "flip", "ones_like", "zeros_like",
]
_g = globals()
for _name in _SHARED:
    if hasattr(_np, _name):
        _g[_name] = getattr(_np, _name)
del _g, _name

concat = _np.concatenate
elemwise_add = _np.add
elemwise_sub = _np.subtract
elemwise_mul = _np.multiply
elemwise_div = _np.divide
broadcast_add = _np.add
broadcast_sub = _np.subtract
broadcast_mul = _np.multiply
broadcast_div = _np.divide
broadcast_maximum = _np.maximum
broadcast_minimum = _np.minimum
relu = _npx.relu
sigmoid = _npx.sigmoid
softmax = _npx.softmax
log_softmax = _npx.log_softmax
LeakyReLU = _npx.leaky_relu
Activation = _npx.activation
FullyConnected = _npx.fully_connected
Convolution = _npx.convolution
Deconvolution = _npx.deconvolution
Pooling = _npx.pooling
BatchNorm = _npx.batch_norm
LayerNorm = _npx.layer_norm
Dropout = _npx.dropout
Embedding = _npx.embedding
one_hot = _npx.one_hot
pick = _npx.pick
topk = _npx.topk
batch_dot = _npx.batch_dot
gather_nd = _npx.gather_nd
scatter_nd = _npx.scatter_nd
SequenceMask = _npx.sequence_mask
slice_axis = _npx.slice_axis
smooth_l1 = _npx.smooth_l1
cast = _np.cast
random = _np.random
random_uniform = _np.random.uniform
random_normal = _np.random.normal
random_randint = _np.random.randint


def flatten(data):
    data = _np.asarray(data)
    return data.reshape(data.shape[0], -1)


def norm(data, ord=2, axis=None, keepdims=False):
    return _np.asarray(data).norm(ord=ord, axis=axis, keepdims=keepdims)


def waitall_():
    waitall()


from . import sparse  # noqa: E402,F401
from .sparse import (  # noqa: E402,F401
    CSRNDArray, RowSparseNDArray, cast_storage, csr_matrix, row_sparse_array)
from .ops import contrib  # noqa: E402,F401

ROIAlign = contrib.roi_align
ROIPooling = contrib.roi_pooling
swapaxes = _np.swapaxes


def UpSampling(data, scale: int = 2, sample_type: str = "nearest", num_filter: int = 0,
               **kwargs):
    """Nearest upsampling of NCHW: each cell repeated ``scale`` times on H
    and W."""
    if sample_type != "nearest":
        raise MXNetError("UpSampling: only sample_type='nearest' is supported "
                         "(bilinear = use npx contrib resize)")
    s = int(scale)
    return invoke(lambda x: x.repeat_interleave(s, dim=2).repeat_interleave(s, dim=3),
                  (data,), {}, name="UpSampling")


def SliceChannel(data, num_outputs: int, axis: int = 1, squeeze_axis: bool = False):
    parts = _np.split(data, int(num_outputs), axis=int(axis))
    if squeeze_axis:
        parts = [p.squeeze(int(axis)) for p in parts]
    return list(parts)


slice_channel = SliceChannel


def SwapAxis(data, dim1: int = 0, dim2: int = 0):
    return _np.swapaxes(data, dim1, dim2)


def SoftmaxActivation(data, mode: str = "instance"):
    """'instance': softmax over the flattened non-batch axes; 'channel':
    over axis 1."""
    if mode == "channel":
        return _npx.softmax(data, axis=1)
    if mode != "instance":
        raise MXNetError(f"SoftmaxActivation: unknown mode {mode!r}")
    d = _np.asarray(data)
    return _npx.softmax(d.reshape(d.shape[0], -1), axis=-1).reshape(d.shape)


def L2Normalization(data, eps: float = 1e-10, mode: str = "instance"):
    if mode not in ("instance", "channel", "spatial"):
        raise MXNetError(f"L2Normalization: unknown mode {mode!r}")

    def fn(x):
        if mode == "channel":
            axes = (1,)
        elif mode == "spatial":
            axes = tuple(range(2, x.dim()))
        else:
            axes = tuple(range(1, x.dim()))
        return x / torch.sqrt(torch.sum(x * x, dim=axes, keepdim=True) + eps)
    return invoke(fn, (data,), {}, name="L2Normalization")


def BlockGrad(data):
    """Identity forward, zero gradient."""
    return _np.asarray(data).detach()


stop_gradient = BlockGrad


class _ScaledGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def MakeLoss(data, grad_scale: float = 1.0):
    """Identity forward; ``grad_scale`` multiplies only the gradient."""
    if grad_scale == 1.0:
        return _np.asarray(data)
    return apply_multi(lambda x: _ScaledGrad.apply(x, grad_scale), [_np.asarray(data)],
                       name="MakeLoss")


Cast = cast
Reshape = reshape  # noqa: F821 (re-exported above)
GroupNorm = _npx.group_norm
InstanceNorm = _npx.instance_norm


def _size_kw(shape, size):
    return size if shape is None else shape


def uniform(low=0.0, high=1.0, shape=None, size=None, **kw):
    """Legacy ``mx.nd.uniform`` (the ``shape=`` spelling)."""
    return _np.random.uniform(low, high, _size_kw(shape, size), **kw)


def normal(loc=0.0, scale=1.0, shape=None, size=None, **kw):
    return _np.random.normal(loc, scale, _size_kw(shape, size), **kw)


sample_uniform = uniform
sample_normal = normal


def random_exponential(scale=1.0, shape=None, size=None, **kw):
    return _np.random.exponential(scale, _size_kw(shape, size), **kw)


def random_gamma(alpha=1.0, beta=1.0, shape=None, size=None, **kw):
    """Gamma with shape ``alpha`` and scale ``beta``."""
    return _np.random.gamma(alpha, beta, _size_kw(shape, size), **kw)


def random_poisson(lam=1.0, shape=None, size=None, **kw):
    return _np.random.poisson(lam, _size_kw(shape, size), **kw)


def sample_multinomial(data, shape=None, get_prob=False, dtype="int32"):
    """Category indices drawn from each row distribution of ``data``
    (``jax.random.categorical`` over log-probabilities, draw axes last);
    with ``get_prob`` also each draw's log-likelihood."""
    from .ndarray import to_torch_dtype
    key = next_key()
    n = () if shape in (None, 1) else (
        tuple(shape) if isinstance(shape, (list, tuple)) else (int(shape),))
    tdt = to_torch_dtype(dtype)

    def fn(p):
        logits = torch.log(torch.clamp(p.float(), min=1e-30))
        batch = tuple(p.shape[:-1])
        noise = _prng.gumbel(key, n + batch + (p.shape[-1],)).to(p.device)
        draws = torch.argmax(noise + logits, dim=-1)
        if n:
            draws = torch.movedim(draws, tuple(range(len(n))), tuple(range(-len(n), 0)))
        out = draws.to(tdt)
        if get_prob:
            lnorm = logits - torch.logsumexp(logits, dim=-1, keepdim=True)
            flat = draws.reshape(batch + (-1,))
            lp = torch.gather(lnorm, -1, flat)
            return out, lp.reshape(draws.shape)
        return out
    return apply_multi(fn, [_np.asarray(data)], name="sample_multinomial")


broadcast_plus = _np.add
broadcast_minus = _np.subtract
broadcast_mod = _np.mod
broadcast_power = _np.power
broadcast_equal = _np.equal
broadcast_not_equal = _np.not_equal
broadcast_greater = _np.greater
broadcast_greater_equal = _np.greater_equal
broadcast_lesser = _np.less
broadcast_lesser_equal = _np.less_equal
broadcast_logical_and = _np.logical_and
broadcast_logical_or = _np.logical_or
broadcast_logical_xor = _np.logical_xor
broadcast_hypot = _np.hypot
broadcast_like = _npx.broadcast_like
reverse = _np.flip
make_loss = MakeLoss
reciprocal = _np.reciprocal


def _unwrap_list(args):
    """Vararg ops take f(a, b, c) and f([a, b, c])."""
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        return list(args[0])
    return list(args)


def rsqrt(data):
    return invoke(torch.rsqrt, (data,), {}, name="rsqrt")


def rcbrt(data):
    return invoke(lambda x: 1.0 / (torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)), (data,), {},
                  name="rcbrt")


def hard_sigmoid(data, alpha: float = 0.2, beta: float = 0.5):
    return invoke(lambda x: torch.clamp(alpha * x + beta, 0.0, 1.0), (data,), {},
                  name="hard_sigmoid")


def softmin(data, axis: int = -1):
    return _npx.softmax(-_np.asarray(data), axis=axis)


def add_n(*args):
    """The sum of the inputs (``ElementWiseSum``)."""
    return invoke(lambda *xs: functools.reduce(operator.add, xs), tuple(_unwrap_list(args)),
                  {}, name="add_n")


ElementWiseSum = add_n


def slice(data, begin, end, step=None):  # noqa: A001 (the reference's name)
    """begin / end / step tuples, None spanning the axis."""
    return _np.asarray(data).slice(begin, end, step)


crop = slice


def slice_like(data, shape_like, axes=None):
    d = _np.asarray(data)
    ref = _np.asarray(shape_like)
    ax = range(d.ndim) if axes is None else [a % d.ndim for a in axes]
    idx = [builtins.slice(None)] * d.ndim
    for a in ax:
        idx[a] = builtins.slice(0, ref.shape[a])
    return d[tuple(idx)]


def amp_cast(data, dtype):
    return _np.asarray(data).astype(dtype)


def amp_multicast(*data, num_outputs=None, cast_narrow: bool = False):
    """Every floating input cast to the widest (``cast_narrow``: the
    narrowest) floating dtype among them."""
    arrays = _unwrap_list(data)
    floats = [a for a in arrays if a._data.is_floating_point()]
    if not floats:
        return arrays
    pick_fn = builtins.min if cast_narrow else builtins.max
    to = pick_fn((a._data.dtype for a in floats), key=lambda dt: torch.finfo(dt).bits)
    return [a.astype(to) if a._data.is_floating_point() else a for a in arrays]


def shape_array(data):
    return _np.array(onp.asarray(_np.asarray(data).shape, onp.int64))


def size_array(data):
    return _np.array(onp.asarray([_np.asarray(data).size], onp.int64))


def space_to_depth(data, block_size: int):
    b = int(block_size)

    def fn(x):
        N, C, H, W = x.shape
        x = x.reshape(N, C, H // b, b, W // b, b)
        return x.permute(0, 3, 5, 1, 2, 4).reshape(N, C * b * b, H // b, W // b)
    return invoke(fn, (data,), {}, name="space_to_depth")


def depth_to_space(data, block_size: int):
    b = int(block_size)

    def fn(x):
        N, C, H, W = x.shape
        x = x.reshape(N, b, b, C // (b * b), H, W)
        return x.permute(0, 3, 4, 1, 5, 2).reshape(N, C // (b * b), H * b, W * b)
    return invoke(fn, (data,), {}, name="depth_to_space")


def im2col(data, kernel, stride=(1, 1), dilate=(1, 1), pad=(0, 0)):
    """NCHW patches as columns: (N, C * kh * kw, L), channels major."""
    return invoke(lambda x: torch.nn.functional.unfold(
        x, tuple(kernel), dilation=tuple(dilate), padding=tuple(pad), stride=tuple(stride)),
        (data,), {}, name="im2col")


def col2im(data, output_size, kernel, stride=(1, 1), dilate=(1, 1), pad=(0, 0)):
    """Columns summed back into (N, C, H, W)."""
    return invoke(lambda c: torch.nn.functional.fold(
        c, tuple(output_size), tuple(kernel), dilation=tuple(dilate), padding=tuple(pad),
        stride=tuple(stride)), (data,), {}, name="col2im")


def khatri_rao(*matrices):
    """Column-wise Kronecker product."""
    def fn(*ms):
        out = ms[0]
        for m in ms[1:]:
            out = (out[:, None, :] * m[None, :, :]).reshape(-1, out.shape[-1])
        return out
    return invoke(fn, tuple(_unwrap_list(matrices)), {}, name="khatri_rao")


def moments(data, axes=None, keepdims: bool = False):
    """(mean, variance) over ``axes``, the variance as E[x^2] - mean^2."""
    def fn(x):
        ax = tuple(axes) if axes is not None else tuple(range(x.dim()))
        m = torch.mean(x, dim=ax, keepdim=True)
        v = torch.mean(x * x, dim=ax, keepdim=True) - m * m
        if not keepdims:
            m, v = m.squeeze(ax), v.squeeze(ax)
        return m, v
    return apply_multi(fn, [_np.asarray(data)], name="moments")


def batch_take(a, indices):
    """out[i] = a[i, indices[i]]."""
    return _npx.pick(a, indices, axis=-1, keepdims=False)


choose_element_0index = batch_take


def LRN(data, alpha: float = 1e-4, beta: float = 0.75, knorm: float = 2.0, nsize: int = 5):
    """Local response normalization across the channels of NCHW (the
    window sum scaled by alpha / nsize)."""
    n = int(nsize)

    def fn(x):
        sq = x * x
        p = n // 2
        sqp = torch.nn.functional.pad(sq, (0, 0, 0, 0, p, p))
        win = functools.reduce(operator.add, (sqp[:, i:i + x.shape[1]] for i in range(n)))
        return x / torch.pow(knorm + (alpha / n) * win, beta)
    return invoke(fn, (data,), {}, name="LRN")


def SequenceReverse(data, sequence_length=None, use_sequence_length=False, axis: int = 0):
    """Reverse each sequence of (T, N, ...) within its length."""
    if not use_sequence_length or sequence_length is None:
        return _np.flip(data, axis=axis)

    def fn(x, ln):
        T = x.shape[0]
        pos = torch.arange(T, device=x.device)[:, None]
        lnb = ln.long()[None, :]
        src = torch.where(pos < lnb, lnb - 1 - pos, pos)
        src = src.reshape(tuple(src.shape) + (1,) * (x.dim() - 2)).expand_as(x)
        return torch.gather(x, 0, src)
    return invoke(fn, (data, sequence_length), {}, name="SequenceReverse")


def SequenceLast(data, sequence_length=None, use_sequence_length=False, axis: int = 0):
    """The last valid step of each sequence of (T, N, ...)."""
    if not use_sequence_length or sequence_length is None:
        return _np.asarray(data)[-1]

    def fn(x, ln):
        idx = (ln.long() - 1)[None, :]
        idx = idx.reshape(tuple(idx.shape) + (1,) * (x.dim() - 2))
        idx = idx.expand((1,) + tuple(x.shape[1:]))
        return torch.gather(x, 0, idx)[0]
    return invoke(fn, (data, sequence_length), {}, name="SequenceLast")


def _pad_index(n: int, lo: int, hi: int, mode: str, device):
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    if n == 1:
        return torch.zeros_like(i)
    m = 2 * (n - 1)
    j = i.abs() % m
    return torch.where(j >= n, m - j, j)


def Pad(data, mode: str = "constant", pad_width=(), constant_value=0.0):
    """Pad with ``pad_width`` (two numbers an axis, flat): 'constant',
    'edge' or 'reflect' (numpy's modes)."""
    pw = [(int(pad_width[2 * i]), int(pad_width[2 * i + 1]))
          for i in range(len(pad_width) // 2)]
    if mode not in ("constant", "edge", "reflect"):
        raise MXNetError(f"Pad: unknown mode {mode!r}")

    def fn(x):
        if mode == "constant":
            flat = [v for lo_hi in reversed(pw) for v in lo_hi]
            return torch.nn.functional.pad(x, flat, value=constant_value)
        for ax, (lo, hi) in enumerate(pw):
            if lo or hi:
                x = x.index_select(ax, _pad_index(x.shape[ax], lo, hi, mode, x.device))
        return x
    return invoke(fn, (data,), {}, name="Pad")


pad = Pad


def ctc_loss(data, label, data_lengths=None, label_lengths=None, use_data_lengths=False,
             use_label_lengths=False, blank_label: str = "first"):
    """CTC negative log-likelihood per sequence of (T, N, C) activations
    (log-softmax over C taken here, as optax's loss takes logits): blank
    is class 0 ('first') or C - 1 ('last'); without label lengths a label
    ends at its first negative or blank entry."""
    def fn(x, lab, *rest):
        T, N, C = x.shape
        blank = 0 if blank_label == "first" else C - 1
        dl = rest[0].long() if use_data_lengths else torch.full((N,), T, dtype=torch.long,
                                                                 device=x.device)
        if use_label_lengths:
            ll = rest[-1].long()
        else:
            ll = torch.sum((lab >= 0) & (lab != blank), dim=-1)
        logp = torch.log_softmax(x.double(), dim=-1)
        # f64, as the JAX package's optax loss comes out under x64
        return torch.nn.functional.ctc_loss(logp, lab.long().clamp(min=0), dl, ll, blank=blank,
                                            reduction="none")
    args = [data, label]
    if use_data_lengths:
        args.append(data_lengths)
    if use_label_lengths:
        args.append(label_lengths)
    return invoke(fn, tuple(args), {}, name="ctc_loss")


CTCLoss = ctc_loss


def all_finite(data, init_output: bool = True):
    return invoke(lambda x: torch.isfinite(x).all()[None], (data,), {}, name="all_finite")


def multi_all_finite(*arrays, num_arrays=None, init_output=True):
    return invoke(lambda *xs: torch.stack([torch.isfinite(x).all() for x in xs]).all()[None],
                  tuple(_unwrap_list(arrays)), {}, name="multi_all_finite")


def multi_sum_sq(*arrays, num_arrays=None):
    return [invoke(lambda x: torch.sum(x.float() * x.float())[None], (a,), {},
                   name="multi_sum_sq") for a in _unwrap_list(arrays)]


def reset_arrays(*arrays, num_arrays=None):
    """Zeros like each input (functional: the inputs are not written)."""
    return [_np.zeros_like(a) for a in _unwrap_list(arrays)]


# ---- the reference's optimizer update ops: functional, the updated weight
# (and state) returned

def _upd(opt_cls, weight, grad, states, lr, wd, rescale_grad=1.0, clip_gradient=None, **kw):
    """One ``update_step`` of ``opt_cls`` at t = 1 with ``grad`` as given
    (the JAX package's ops pass ``rescale_grad`` to the optimizer, whose
    step does not apply it)."""
    opt = opt_cls(learning_rate=lr, wd=wd, rescale_grad=rescale_grad,
                  clip_gradient=clip_gradient if clip_gradient and clip_gradient > 0 else None,
                  **kw)
    w = _np.asarray(weight)._data.detach()
    g = _np.asarray(grad)._data.detach()
    st = tuple(_np.asarray(a)._data.detach() for a in states)
    with torch.no_grad():
        new_w, new_states = opt.update_step(w, g, st, float(onp.float32(lr)),
                                            float(onp.float32(wd)), 1)
    return NDArray._new(new_w), tuple(NDArray._new(s) for s in new_states)


def sgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
               lazy_update=True):
    from .optimizer import SGD
    return _upd(SGD, weight, grad, (), lr, wd, rescale_grad, clip_gradient)[0]


def sgd_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0, lazy_update=True):
    from .optimizer import SGD
    w, st = _upd(SGD, weight, grad, (mom,), lr, wd, rescale_grad, clip_gradient,
                 momentum=momentum)
    return w, st[0]


def adam_update(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    """The reference op's Adam step: no bias correction inside the op."""
    def fn(w, g, m, v):
        gf = g.float() * rescale_grad
        if clip_gradient and clip_gradient > 0:
            gf = torch.clamp(gf, -clip_gradient, clip_gradient)
        gf = gf + wd * w
        m_t = beta1 * m + (1 - beta1) * gf
        v_t = beta2 * v + (1 - beta2) * gf * gf
        w_t = w - lr * m_t / (torch.sqrt(v_t) + epsilon)
        return w_t.to(w.dtype), m_t, v_t
    return apply_multi(fn, [_np.asarray(a) for a in (weight, grad, mean, var)],
                       name="adam_update")


def rmsprop_update(weight, grad, n, lr, gamma1=0.95, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0, clip_weights=-1.0):
    from .optimizer import RMSProp
    w, st = _upd(RMSProp, weight, grad, (n, _np.zeros_like(n)), lr, wd, rescale_grad,
                 clip_gradient, rho=gamma1, epsilon=epsilon)
    return w, st[0]


def signsgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    from .optimizer import Signum
    return _upd(Signum, weight, grad, (), lr, wd, rescale_grad, clip_gradient,
                momentum=0.0)[0]


def nag_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    from .optimizer import NAG
    w, st = _upd(NAG, weight, grad, (mom,), lr, wd, rescale_grad, clip_gradient,
                 momentum=momentum)
    return w, st[0]


def Custom(*inputs, op_type: str = None, **kwargs):
    """Run a registered ``mx.operator`` custom op."""
    if op_type is None:
        raise MXNetError("Custom: op_type is required")
    from .operator import invoke_custom
    return invoke_custom(*inputs, op_type=op_type, **kwargs)


Softmax = softmax


def broadcast_axis(data, axis=0, size=1):
    axes = axis if isinstance(axis, (list, tuple)) else (axis,)
    sizes = size if isinstance(size, (list, tuple)) else (size,)
    d = _np.asarray(data)
    shape = list(d.shape)
    for a, s in zip(axes, sizes):
        shape[a] = int(s)
    return _np.broadcast_to(d, tuple(shape))


broadcast_axes = broadcast_axis


def signum_update(weight, grad, mom, lr, momentum=0.0, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0, wd_lh=0.0):
    from .optimizer import Signum
    w, st = _upd(Signum, weight, grad, (mom,), lr, wd, rescale_grad, clip_gradient,
                 momentum=momentum)
    return w, st[0]


def ftrl_update(weight, grad, z, n, lr, lamda1=0.01, beta=1.0, wd=0.0, rescale_grad=1.0,
                clip_gradient=-1.0):
    from .optimizer import Ftrl
    w, st = _upd(Ftrl, weight, grad, (z, n), lr, wd, rescale_grad, clip_gradient,
                 lamda1=lamda1, beta=beta)
    return w, st[0], st[1]


def ftml_update(weight, grad, d, v, z, lr, beta1=0.6, beta2=0.999, epsilon=1e-8, t=1, wd=0.0,
                rescale_grad=1.0, clip_grad=-1.0):
    """The FTML step."""
    def fn(w, g, dd, vv, zz):
        gf = g * rescale_grad
        if clip_grad and clip_grad > 0:
            gf = torch.clamp(gf, -clip_grad, clip_grad)
        gf = gf + wd * w
        v_t = beta2 * vv + (1 - beta2) * gf * gf
        d_t = (1 - beta1 ** t) / lr * (torch.sqrt(v_t / (1 - beta2 ** t)) + epsilon)
        sigma = d_t - beta1 * dd
        z_t = beta1 * zz + (1 - beta1) * gf - sigma * w
        return -z_t / d_t, d_t, v_t, z_t
    return apply_multi(fn, [_np.asarray(a) for a in (weight, grad, d, v, z)],
                       name="ftml_update")


def rmspropalex_update(weight, grad, n, g, delta, lr, gamma1=0.95, gamma2=0.9, epsilon=1e-8,
                       wd=0.0, rescale_grad=1.0, clip_gradient=-1.0, clip_weights=-1.0):
    """Centered RMSProp (Graves, 2013)."""
    def fn(w, gr, nn_, gg, dd):
        gf = gr * rescale_grad
        if clip_gradient and clip_gradient > 0:
            gf = torch.clamp(gf, -clip_gradient, clip_gradient)
        gf = gf + wd * w
        n_t = gamma1 * nn_ + (1 - gamma1) * gf * gf
        g_t = gamma1 * gg + (1 - gamma1) * gf
        d_t = gamma2 * dd - lr * gf / torch.sqrt(n_t - g_t * g_t + epsilon)
        w_t = w + d_t
        if clip_weights and clip_weights > 0:
            w_t = torch.clamp(w_t, -clip_weights, clip_weights)
        return w_t, n_t, g_t, d_t
    return apply_multi(fn, [_np.asarray(a) for a in (weight, grad, n, g, delta)],
                       name="rmspropalex_update")


def _flatten_multi(args):
    out = []
    for a in args:
        if isinstance(a, (list, tuple)):
            out.extend(a)
        else:
            out.append(a)
    return out


def multi_sgd_update(*args, lrs=None, wds=None, rescale_grad=1.0, clip_gradient=-1.0,
                     num_weights=None):
    """(w0, g0, w1, g1, ...)."""
    flat = _flatten_multi(args)
    n = num_weights or len(flat) // 2
    return [sgd_update(flat[2 * i], flat[2 * i + 1], lr=lrs[i], wd=wds[i] if wds else 0.0,
                       rescale_grad=rescale_grad, clip_gradient=clip_gradient)
            for i in range(n)]


def multi_sgd_mom_update(*args, lrs=None, wds=None, momentum=0.0, rescale_grad=1.0,
                         clip_gradient=-1.0, num_weights=None):
    """(w0, g0, mom0, w1, g1, mom1, ...)."""
    flat = _flatten_multi(args)
    n = num_weights or len(flat) // 3
    return [sgd_mom_update(flat[3 * i], flat[3 * i + 1], flat[3 * i + 2], lr=lrs[i],
                           wd=wds[i] if wds else 0.0, momentum=momentum,
                           rescale_grad=rescale_grad, clip_gradient=clip_gradient)
            for i in range(n)]


def multi_mp_sgd_update(*args, lrs=None, wds=None, rescale_grad=1.0, clip_gradient=-1.0,
                        num_weights=None):
    """(w0, g0, w0_f32, ...): the f32 master copy stepped, the weight its
    cast."""
    flat = _flatten_multi(args)
    n = num_weights or len(flat) // 3
    outs = []
    for i in range(n):
        w, g, w32 = flat[3 * i], flat[3 * i + 1], flat[3 * i + 2]
        new32 = sgd_update(w32, g.astype("float32"), lr=lrs[i], wd=wds[i] if wds else 0.0,
                           rescale_grad=rescale_grad, clip_gradient=clip_gradient)
        outs.append((new32.astype(w.dtype), new32))
    return outs


def multi_mp_sgd_mom_update(*args, lrs=None, wds=None, momentum=0.0, rescale_grad=1.0,
                            clip_gradient=-1.0, num_weights=None):
    flat = _flatten_multi(args)
    n = num_weights or len(flat) // 4
    outs = []
    for i in range(n):
        w, g, m, w32 = flat[4 * i], flat[4 * i + 1], flat[4 * i + 2], flat[4 * i + 3]
        new32, newm = sgd_mom_update(w32, g.astype("float32"), m, lr=lrs[i],
                                     wd=wds[i] if wds else 0.0, momentum=momentum,
                                     rescale_grad=rescale_grad, clip_gradient=clip_gradient)
        outs.append((new32.astype(w.dtype), newm, new32))
    return outs


def _as_scalar_list(a, n):
    host = onp.asarray(_np.asarray(a).asnumpy()).ravel()
    return [float(host[i]) for i in range(n)]


def preloaded_multi_sgd_update(*args, num_weights=None, **kw):
    """The multi ops with ``lrs`` and ``wds`` as the last two arrays."""
    flat = _flatten_multi(args)
    n = num_weights or (len(flat) - 2) // 2
    return multi_sgd_update(*flat[:-2], lrs=_as_scalar_list(flat[-2], n),
                            wds=_as_scalar_list(flat[-1], n), num_weights=n, **kw)


def preloaded_multi_sgd_mom_update(*args, num_weights=None, **kw):
    flat = _flatten_multi(args)
    n = num_weights or (len(flat) - 2) // 3
    return multi_sgd_mom_update(*flat[:-2], lrs=_as_scalar_list(flat[-2], n),
                                wds=_as_scalar_list(flat[-1], n), num_weights=n, **kw)


def preloaded_multi_mp_sgd_update(*args, num_weights=None, **kw):
    flat = _flatten_multi(args)
    n = num_weights or (len(flat) - 2) // 3
    return multi_mp_sgd_update(*flat[:-2], lrs=_as_scalar_list(flat[-2], n),
                               wds=_as_scalar_list(flat[-1], n), num_weights=n, **kw)


def preloaded_multi_mp_sgd_mom_update(*args, num_weights=None, **kw):
    flat = _flatten_multi(args)
    n = num_weights or (len(flat) - 2) // 4
    return multi_mp_sgd_mom_update(*flat[:-2], lrs=_as_scalar_list(flat[-2], n),
                                   wds=_as_scalar_list(flat[-1], n), num_weights=n, **kw)


def multi_lars(lrs, weights_sum_sq, grads_sum_sq, wds, eta=0.001, eps=1e-8, rescale_grad=1.0):
    """Layer-wise LARS rates from per-layer squared norms."""
    def fn(lr, wsq, gsq, wd):
        wn = torch.sqrt(wsq)
        gn = torch.sqrt(gsq) * rescale_grad
        trust = torch.where((wn > 0) & (gn > 0), eta * wn / (gn + wd * wn + eps),
                            torch.ones_like(wn))
        return lr * trust
    return invoke(fn, (lrs, weights_sum_sq, grads_sum_sq, wds), {}, name="multi_lars")


def softmax_cross_entropy(data, label):
    """The batch-summed loss, shape ``(1,)`` (legacy scripts read
    ``out[0]``), unlike ``npx.softmax_cross_entropy``'s per-row loss."""
    return _np.sum(_npx.softmax_cross_entropy(data, label)).reshape((1,))


class _RegressionHead(torch.autograd.Function):
    """act(x) forward; the gradient (act(x) - label) (its sign for MAE)
    times grad_scale / outputs per sample, whatever the cotangent."""

    @staticmethod
    def forward(ctx, x, lab, act, grad_scale, mae):
        pred = act(x)
        ctx.save_for_backward(pred, lab)
        ctx.scale = grad_scale / (builtins.max(x.numel() // x.shape[0], 1) if x.dim() else 1)
        ctx.mae = mae
        return pred

    @staticmethod
    def backward(ctx, g):
        pred, lab = ctx.saved_tensors
        diff = torch.sign(pred - lab) if ctx.mae else pred - lab
        return (diff * ctx.scale).to(pred.dtype), None, None, None, None


def _regression_output(data, label, act, grad_scale, mae=False):
    return apply_multi(lambda x, lab: _RegressionHead.apply(x, lab, act, grad_scale, mae),
                       [_np.asarray(data), _np.asarray(label)], name="RegressionOutput")


def LinearRegressionOutput(data, label, grad_scale: float = 1.0):
    return _regression_output(data, label, lambda x: x, grad_scale)


def LogisticRegressionOutput(data, label, grad_scale: float = 1.0):
    return _regression_output(data, label, torch.sigmoid, grad_scale)


def MAERegressionOutput(data, label, grad_scale: float = 1.0):
    return _regression_output(data, label, lambda x: x, grad_scale, mae=True)
