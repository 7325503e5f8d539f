"""Vision transforms (counterpart of
``mxnet_tpu/gluon/data/vision/transforms.py``; the reference's
python/mxnet/gluon/data/vision/transforms.py).

Transforms are host ops first: a numpy input stays numpy (the DataLoader
uploads once per batch), which also keeps them safe inside forked
DataLoader workers, where CUDA must not run. An NDArray or tensor input
takes the device path in torch on its own device and returns the same
kind. Random draws come from numpy's global RNG in the JAX package's
order, so one ``numpy.random.seed`` gives both packages the same crops and
flips."""
from __future__ import annotations

import numpy as onp
import torch
import torch.nn.functional as F

from ....ndarray import NDArray, apply, asarray, to_torch_dtype
from ...block import Block, HybridBlock, Sequential

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize", "CenterCrop",
           "RandomCrop", "RandomFlipLeftRight", "RandomFlipTopBottom"]


def _is_host(x) -> bool:
    return not isinstance(x, (NDArray, torch.Tensor))


def _dev(x):
    """An NDArray or tensor input as the funnel takes it."""
    return x if isinstance(x, torch.Tensor) else asarray(x)


class Compose(Sequential):
    """Sequentially composed transforms (reference transforms.Compose)."""

    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)


class Cast(HybridBlock):
    def __init__(self, dtype=onp.float32):
        super().__init__()
        self._dtype = dtype

    def forward(self, x):
        if _is_host(x):
            return onp.asarray(x).astype(self._dtype)
        if isinstance(x, torch.Tensor):
            return x.to(to_torch_dtype(self._dtype))
        return x.astype(self._dtype)


class ToTensor(HybridBlock):
    """HWC uint8 [0,255] -> CHW float32 [0,1] (reference ToTensor)."""

    def forward(self, x):
        if _is_host(x):
            v = onp.asarray(x, dtype=onp.float32) / 255.0
            return (v.transpose(2, 0, 1) if v.ndim == 3
                    else v.transpose(0, 3, 1, 2))

        def fn(v):
            v = v.to(torch.float32) / 255.0
            return v.permute(2, 0, 1) if v.dim() == 3 else v.permute(0, 3, 1, 2)
        return apply(fn, _dev(x))


class Normalize(HybridBlock):
    """Channel-wise normalize CHW (reference Normalize)."""

    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = onp.asarray(mean, dtype=onp.float32)
        self._std = onp.asarray(std, dtype=onp.float32)

    def forward(self, x):
        if _is_host(x):
            v = onp.asarray(x)
            c = v.shape[0] if v.ndim == 3 else v.shape[1]
            shape = (c, 1, 1) if v.ndim == 3 else (1, c, 1, 1)
            m = onp.broadcast_to(self._mean, (c,)).reshape(shape)
            s = onp.broadcast_to(self._std, (c,)).reshape(shape)
            return (v - m) / s
        mean, std = self._mean, self._std

        def fn(v):
            c = v.shape[0] if v.dim() == 3 else v.shape[1]
            shape = (c, 1, 1) if v.dim() == 3 else (1, c, 1, 1)
            m = torch.from_numpy(onp.broadcast_to(mean, (c,)).reshape(shape).copy()).to(v.device)
            s = torch.from_numpy(onp.broadcast_to(std, (c,)).reshape(shape).copy()).to(v.device)
            return (v - m) / s
        return apply(fn, _dev(x))


def _np_bilinear_resize(v, h, w):
    """Host classic 2-tap bilinear resize, half-pixel centers (the
    reference imresize's OpenCV INTER_LINEAR convention); the device path
    computes the same weights (``F.interpolate``, ``align_corners=False``,
    no antialias)."""
    squeeze = v.ndim == 3
    if squeeze:
        v = v[None]
    B, H, W, C = v.shape
    v = v.astype(onp.float32)
    ys = (onp.arange(h) + 0.5) * H / h - 0.5
    xs = (onp.arange(w) + 0.5) * W / w - 0.5
    y0 = onp.clip(onp.floor(ys), 0, H - 1).astype(int)
    x0 = onp.clip(onp.floor(xs), 0, W - 1).astype(int)
    y1 = onp.clip(y0 + 1, 0, H - 1)
    x1 = onp.clip(x0 + 1, 0, W - 1)
    wy = onp.clip(ys - y0, 0, 1)[None, :, None, None]
    wx = onp.clip(xs - x0, 0, 1)[None, None, :, None]
    vy0 = v[:, y0]
    vy1 = v[:, y1]
    top = vy0[:, :, x0] * (1 - wx) + vy0[:, :, x1] * wx
    bot = vy1[:, :, x0] * (1 - wx) + vy1[:, :, x1] * wx
    out = top * (1 - wy) + bot * wy
    return out[0] if squeeze else out


def _bilinear(v, h, w):
    """HWC or NHWC f32 ``v`` resized to (h, w): the JAX package's
    ``jax.image.resize(..., "bilinear", antialias=False)``, whose two-tap
    half-pixel weights (edge taps clamped) ``F.interpolate`` computes."""
    x = v.to(torch.float32)
    x = x.permute(2, 0, 1)[None] if x.dim() == 3 else x.permute(0, 3, 1, 2)
    out = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False, antialias=False)
    return out[0].permute(1, 2, 0) if v.dim() == 3 else out.permute(0, 2, 3, 1)


class Resize(HybridBlock):
    """Bilinear resize HWC (reference Resize -> image resize op)."""

    def __init__(self, size, keep_ratio: bool = False, interpolation: int = 1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)

    def forward(self, x):
        h, w = self._size[1], self._size[0]
        if _is_host(x):
            return _np_bilinear_resize(onp.asarray(x), h, w)
        return apply(lambda v: _bilinear(v, h, w), _dev(x))


def _crop(x, y0, x0, h, w):
    if x.ndim == 3:
        return x[y0:y0 + h, x0:x0 + w, :]
    return x[:, y0:y0 + h, x0:x0 + w, :]


class CenterCrop(HybridBlock):
    def __init__(self, size):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)

    def forward(self, x):
        x = onp.asarray(x) if _is_host(x) else _dev(x)
        w, h = self._size
        H, W = (x.shape[0], x.shape[1]) if x.ndim == 3 else (x.shape[1], x.shape[2])
        return _crop(x, (H - h) // 2, (W - w) // 2, h, w)


class RandomCrop(Block):
    def __init__(self, size, pad=None):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._pad = pad

    def forward(self, x):
        host = _is_host(x)
        x = onp.asarray(x) if host else _dev(x)
        w, h = self._size
        if self._pad:
            p = self._pad
            if host:
                cfg = ((p, p), (p, p), (0, 0)) if x.ndim == 3 \
                    else ((0, 0), (p, p), (p, p), (0, 0))
                x = onp.pad(x, cfg)
            else:
                # F.pad pads the last dims first: (C, W, H) of HWC / NHWC
                x = apply(lambda v: F.pad(v, (0, 0, p, p, p, p)), x)
        H, W = (x.shape[0], x.shape[1]) if x.ndim == 3 else (x.shape[1], x.shape[2])
        y0 = int(onp.random.randint(0, max(H - h, 0) + 1))
        x0 = int(onp.random.randint(0, max(W - w, 0) + 1))
        return _crop(x, y0, x0, h, w)


class RandomFlipLeftRight(Block):
    def forward(self, x):
        if onp.random.rand() >= 0.5:
            return x
        if _is_host(x):
            v = onp.asarray(x)
            return onp.flip(v, axis=1 if v.ndim == 3 else 2)
        axis = 1 if x.ndim == 3 else 2
        return apply(lambda v: torch.flip(v, (axis,)), _dev(x))


class RandomFlipTopBottom(Block):
    def forward(self, x):
        if onp.random.rand() >= 0.5:
            return x
        if _is_host(x):
            v = onp.asarray(x)
            return onp.flip(v, axis=0 if v.ndim == 3 else 1)
        axis = 0 if x.ndim == 3 else 1
        return apply(lambda v: torch.flip(v, (axis,)), _dev(x))
