"""SqueezeNet 1.0/1.1 (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/squeezenet.py``; Iandola et al. 2016)."""
from __future__ import annotations

from ....base import MXNetError
from ... import nn
from ...block import HybridBlock

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


class _Fire(HybridBlock):
    """squeeze 1x1 → expand 1x1 ∥ expand 3x3, channel-concatenated."""

    def __init__(self, squeeze: int, expand1: int, expand3: int):
        super().__init__()
        self.squeeze = nn.Conv2D(squeeze, 1, activation="relu")
        self.expand1 = nn.Conv2D(expand1, 1, activation="relu")
        self.expand3 = nn.Conv2D(expand3, 3, padding=1, activation="relu")

    def forward(self, x):
        s = self.squeeze(x)
        from .... import np as mxnp
        return mxnp.concatenate([self.expand1(s), self.expand3(s)], axis=1)


class SqueezeNet(HybridBlock):
    def __init__(self, version: str = "1.0", classes: int = 1000):
        super().__init__()
        if version not in ("1.0", "1.1"):
            raise MXNetError(f"unsupported SqueezeNet version {version!r}")
        self.features = nn.HybridSequential()
        if version == "1.0":
            self.features.add(nn.Conv2D(96, 7, strides=2, activation="relu"),
                              nn.MaxPool2D(3, strides=2, ceil_mode=True),
                              _Fire(16, 64, 64), _Fire(16, 64, 64),
                              _Fire(32, 128, 128),
                              nn.MaxPool2D(3, strides=2, ceil_mode=True),
                              _Fire(32, 128, 128), _Fire(48, 192, 192),
                              _Fire(48, 192, 192), _Fire(64, 256, 256),
                              nn.MaxPool2D(3, strides=2, ceil_mode=True),
                              _Fire(64, 256, 256))
        else:
            self.features.add(nn.Conv2D(64, 3, strides=2, activation="relu"),
                              nn.MaxPool2D(3, strides=2, ceil_mode=True),
                              _Fire(16, 64, 64), _Fire(16, 64, 64),
                              nn.MaxPool2D(3, strides=2, ceil_mode=True),
                              _Fire(32, 128, 128), _Fire(32, 128, 128),
                              nn.MaxPool2D(3, strides=2, ceil_mode=True),
                              _Fire(48, 192, 192), _Fire(48, 192, 192),
                              _Fire(64, 256, 256), _Fire(64, 256, 256))
        self.features.add(nn.Dropout(0.5))
        # the classifier is fully convolutional
        self.output = nn.HybridSequential()
        self.output.add(nn.Conv2D(classes, 1, activation="relu"),
                        nn.GlobalAvgPool2D(), nn.Flatten())

    def forward(self, x):
        return self.output(self.features(x))


def squeezenet1_0(**kwargs):
    return SqueezeNet("1.0", **kwargs)


def squeezenet1_1(**kwargs):
    return SqueezeNet("1.1", **kwargs)
