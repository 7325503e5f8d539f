"""``mx.image``: image ops and augmenters (counterpart of
``mxnet_tpu/image.py``; the reference's python/mxnet/image/ and
src/operator/image/: resize, crop, normalize, random augmentations).

Array work runs in torch on the input's device (a numpy input goes to the
current device first, as ``asarray`` places it); decoding uses PIL, as the
JAX package does. ``imresize``'s bilinear resize is
``jax.image.resize(..., "bilinear")`` with its antialiasing on a
downscale, which ``F.interpolate(..., antialias=True)`` computes; its
nearest neighbour takes JAX's source indices ``floor((i + 0.5) * m / n)``.
The random crops and flips draw from Python's ``random``, as there."""
from __future__ import annotations

import random as _pyrandom
from typing import Optional, Sequence, Tuple

import numpy as onp
import torch
import torch.nn.functional as F

from .base import MXNetError
from .ndarray import NDArray, apply, asarray

__all__ = [
    "imdecode", "imresize", "resize_short", "fixed_crop", "center_crop",
    "random_crop", "color_normalize", "HorizontalFlipAug", "RandomCropAug",
    "CenterCropAug", "ResizeAug", "ColorNormalizeAug", "CreateAugmenter",
]


def imdecode(buf: bytes, flag: int = 1, to_rgb: bool = True) -> NDArray:
    """Decode compressed image bytes (reference image.imdecode; OpenCV's
    role) into an HWC uint8 NDArray on the current device."""
    try:
        from PIL import Image
    except ImportError as e:
        raise MXNetError("imdecode requires PIL") from e
    import io
    img = Image.open(io.BytesIO(buf))
    if flag == 0:
        img = img.convert("L")
    elif to_rgb:
        img = img.convert("RGB")
    arr = onp.asarray(img)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return NDArray(arr)


def _nearest_index(m: int, n: int) -> onp.ndarray:
    """JAX's nearest-neighbour source rows of n outputs over m inputs."""
    return onp.floor((onp.arange(n, dtype=onp.float32) + 0.5) * m / n).astype(onp.int64)


def _resize_hwc(x, h: int, w: int, bilinear: bool):
    v = x.to(torch.float32)
    if bilinear:
        out = F.interpolate(v.permute(2, 0, 1)[None], size=(h, w), mode="bilinear",
                            align_corners=False, antialias=True)[0].permute(1, 2, 0)
    else:
        rows = torch.from_numpy(_nearest_index(v.shape[0], h)).to(v.device)
        cols = torch.from_numpy(_nearest_index(v.shape[1], w)).to(v.device)
        out = v.index_select(0, rows).index_select(1, cols)
    if x.is_floating_point():
        return out.to(x.dtype)
    return out.round().to(x.dtype)


def imresize(src, w: int, h: int, interp: int = 1) -> NDArray:
    """HWC resize (reference image.imresize): bilinear unless ``interp``
    is 0 (nearest); integer images are rounded back to their dtype."""
    src = asarray(src)
    return apply(lambda x: _resize_hwc(x, h, w, interp != 0), src, name="imresize")


def resize_short(src, size: int, interp: int = 2) -> NDArray:
    src = asarray(src)
    h, w = src.shape[:2]
    if h > w:
        new_w, new_h = size, int(h * size / w)
    else:
        new_w, new_h = int(w * size / h), size
    return imresize(src, new_w, new_h, interp)


def fixed_crop(src, x0: int, y0: int, w: int, h: int,
               size: Optional[Tuple[int, int]] = None, interp: int = 2) -> NDArray:
    src = asarray(src)
    out = src[y0:y0 + h, x0:x0 + w, :]
    if size is not None and (w, h) != size:
        out = imresize(out, size[0], size[1], interp)
    return out


def center_crop(src, size: Tuple[int, int], interp: int = 2):
    src = asarray(src)
    h, w = src.shape[:2]
    new_w, new_h = size
    x0 = max((w - new_w) // 2, 0)
    y0 = max((h - new_h) // 2, 0)
    out = fixed_crop(src, x0, y0, min(new_w, w), min(new_h, h), size, interp)
    return out, (x0, y0, new_w, new_h)


def random_crop(src, size: Tuple[int, int], interp: int = 2):
    src = asarray(src)
    h, w = src.shape[:2]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = _pyrandom.randint(0, w - new_w)
    y0 = _pyrandom.randint(0, h - new_h)
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def color_normalize(src, mean, std=None) -> NDArray:
    """``(src - mean) / std`` in f32 over the last (channel) axis."""
    src = asarray(src)
    mean_a = onp.asarray(mean, dtype=onp.float32)
    std_a = None if std is None else onp.asarray(std, dtype=onp.float32)

    def fn(x):
        y = x.to(torch.float32) - torch.from_numpy(mean_a).to(x.device)
        if std_a is not None:
            y = y / torch.from_numpy(std_a).to(x.device)
        return y

    return apply(fn, src, name="color_normalize")


# ------------------------------------------------------------- augmenters

class Augmenter:
    def __call__(self, src):
        raise NotImplementedError


class ResizeAug(Augmenter):
    def __init__(self, size: int, interp: int = 2):
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class CenterCropAug(Augmenter):
    def __init__(self, size, interp: int = 2):
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class RandomCropAug(Augmenter):
    def __init__(self, size, interp: int = 2):
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, src):
        if _pyrandom.random() < self.p:
            return apply(lambda x: torch.flip(x, (1,)), asarray(src))
        return src


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std=None):
        self.mean = mean
        self.std = std

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


def CreateAugmenter(data_shape, resize: int = 0, rand_crop: bool = False,
                    rand_mirror: bool = False, mean=None, std=None,
                    **kwargs) -> Sequence[Augmenter]:
    """Reference image.CreateAugmenter."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize))
    crop_size = (data_shape[2], data_shape[1])
    if rand_crop:
        auglist.append(RandomCropAug(crop_size))
    else:
        auglist.append(CenterCropAug(crop_size))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    if mean is not None:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist
