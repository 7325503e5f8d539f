"""MobileNet V1/V2 (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/mobilenet.py``): the depthwise convs
are grouped convolutions (``groups`` = channels)."""
from __future__ import annotations

from ....base import MXNetError
from ... import nn
from ...block import HybridBlock

__all__ = ["MobileNet", "MobileNetV2",
           "mobilenet1_0", "mobilenet0_75", "mobilenet0_5", "mobilenet0_25",
           "mobilenet_v2_1_0", "mobilenet_v2_0_75", "mobilenet_v2_0_5",
           "mobilenet_v2_0_25"]


def _add_conv(out, channels, kernel=1, stride=1, pad=0, num_group=1,
              active=True, relu6=False):
    out.add(nn.Conv2D(channels, kernel, stride, pad, groups=num_group,
                      use_bias=False))
    out.add(nn.BatchNorm())
    if active:
        out.add(nn.Activation("relu6" if relu6 else "relu"))


def _add_conv_dw(out, dw_channels, channels, stride, relu6=False):
    _add_conv(out, dw_channels, kernel=3, stride=stride, pad=1,
              num_group=dw_channels, relu6=relu6)
    _add_conv(out, channels, relu6=relu6)


class LinearBottleneck(HybridBlock):
    def __init__(self, in_channels, channels, t, stride):
        super().__init__()
        self.use_shortcut = stride == 1 and in_channels == channels
        self.out = nn.HybridSequential()
        _add_conv(self.out, in_channels * t, relu6=True)
        _add_conv(self.out, in_channels * t, kernel=3, stride=stride, pad=1,
                  num_group=in_channels * t, relu6=True)
        _add_conv(self.out, channels, active=False, relu6=True)

    def forward(self, x):
        out = self.out(x)
        if self.use_shortcut:
            out = out + x
        return out


class MobileNet(HybridBlock):
    def __init__(self, multiplier: float = 1.0, classes: int = 1000):
        super().__init__()
        self.features = nn.HybridSequential()
        _add_conv(self.features, int(32 * multiplier), kernel=3, stride=2, pad=1)
        dw_channels = [int(x * multiplier) for x in
                       [32, 64] + [128] * 2 + [256] * 2 + [512] * 6 + [1024]]
        channels = [int(x * multiplier) for x in
                    [64] + [128] * 2 + [256] * 2 + [512] * 6 + [1024] * 2]
        strides = [1, 2, 1, 2, 1, 2] + [1] * 5 + [2, 1]
        for dwc, c, s in zip(dw_channels, channels, strides):
            _add_conv_dw(self.features, dwc, c, s)
        self.features.add(nn.GlobalAvgPool2D())
        self.features.add(nn.Flatten())
        self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


class MobileNetV2(HybridBlock):
    def __init__(self, multiplier: float = 1.0, classes: int = 1000):
        super().__init__()
        self.features = nn.HybridSequential()
        _add_conv(self.features, int(32 * multiplier), kernel=3, stride=2, pad=1,
                  relu6=True)
        in_channels_group = [int(x * multiplier) for x in
                             [32] + [16] + [24] * 2 + [32] * 3 + [64] * 4
                             + [96] * 3 + [160] * 3]
        channels_group = [int(x * multiplier) for x in
                          [16] + [24] * 2 + [32] * 3 + [64] * 4 + [96] * 3
                          + [160] * 3 + [320]]
        ts = [1] + [6] * 16
        strides = [1, 2, 1, 2, 1, 1, 2, 1, 1, 1, 1, 1, 1, 2, 1, 1, 1]
        for in_c, c, t, s in zip(in_channels_group, channels_group, ts, strides):
            self.features.add(LinearBottleneck(in_c, c, t, s))
        last_channels = int(1280 * multiplier) if multiplier > 1.0 else 1280
        _add_conv(self.features, last_channels, relu6=True)
        self.features.add(nn.GlobalAvgPool2D())
        self.output = nn.HybridSequential()
        self.output.add(nn.Conv2D(classes, 1, use_bias=False))
        self.output.add(nn.Flatten())

    def forward(self, x):
        return self.output(self.features(x))


def _make(mult):
    def f(pretrained=False, **kwargs):
        if pretrained:
            raise MXNetError("pretrained weights unavailable (no network egress)")
        return MobileNet(mult, **kwargs)
    return f


def _make_v2(mult):
    def f(pretrained=False, **kwargs):
        if pretrained:
            raise MXNetError("pretrained weights unavailable (no network egress)")
        return MobileNetV2(mult, **kwargs)
    return f


mobilenet1_0 = _make(1.0)
mobilenet0_75 = _make(0.75)
mobilenet0_5 = _make(0.5)
mobilenet0_25 = _make(0.25)
mobilenet_v2_1_0 = _make_v2(1.0)
mobilenet_v2_0_75 = _make_v2(0.75)
mobilenet_v2_0_5 = _make_v2(0.5)
mobilenet_v2_0_25 = _make_v2(0.25)
