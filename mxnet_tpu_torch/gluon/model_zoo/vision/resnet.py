"""ResNet V1/V2 (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/resnet.py``): BasicBlock for 18/34,
Bottleneck for 50/101/152; V2 is pre-activation.

NCHW by default; ``layout="NHWC"`` builds the whole network channel-last.
In NHWC a V1 network takes the fused route of the JAX package: in
training each block runs as one ``npx.fused_resnet_block`` (convs, BNs,
ReLUs and the residual add under one hand-written backward), in inference
each conv + BN pair as ``npx.fused_conv_bn_relu``, and the 7x7/2 stem as
the space-to-depth 4x4/1 conv over 12 channels (:func:`_stem_s2d`). The
NCHW route runs the layers one by one. Both compute the same function.
"""
from __future__ import annotations

from typing import List

import torch

from .... import _tape
from .... import numpy_extension as npx
from ....base import MXNetError
from ....ndarray import apply
from ... import nn
from ...block import HybridBlock

__all__ = [
    "ResNetV1", "ResNetV2", "BasicBlockV1", "BasicBlockV2", "BottleneckV1",
    "BottleneckV2", "resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
    "resnet152_v1", "resnet18_v2", "resnet34_v2", "resnet50_v2", "resnet101_v2",
    "resnet152_v2", "get_resnet",
]


def _bn_axis(layout):
    return -1 if layout == "NHWC" else 1


def _write_stats(bn, new_rm, new_rv):
    bn.running_mean.set_data(new_rm)
    bn.running_var.set_data(new_rv)


def _fused_cbr(conv, bn, x, relu=True, residual=None):
    """A (Conv2D, BatchNorm) child pair through ``npx.fused_conv_bn_relu``:
    the same parameters and running-statistics updates as the pair's own
    forwards. NHWC only."""
    _init_pair(conv, bn, x.shape[-1])
    training = _tape.is_training() and not bn._use_global_stats
    out, new_rm, new_rv = npx.fused_conv_bn_relu(
        x, conv.weight.data(), bn.gamma.data(), bn.beta.data(),
        bn.running_mean.data(), bn.running_var.data(),
        bias=None if conv.bias is None else conv.bias.data(),
        residual=residual, stride=conv._strides, pad=conv._padding,
        eps=bn._eps, momentum=bn._momentum, relu=relu,
        use_global_stats=bn._use_global_stats)
    if training:
        _write_stats(bn, new_rm, new_rv)
    return out


def _can_fuse(layout, conv, bn):
    return (layout == "NHWC" and isinstance(conv, nn.Conv2D)
            and isinstance(bn, nn.BatchNorm) and not conv._transpose
            and conv._groups == 1 and conv._dilation == (1, 1)
            and bn._scale and bn._center and not bn._use_global_stats)


def _init_pair(conv, bn, in_ch):
    """Finish the deferred initialization of a (Conv2D, BatchNorm) pair from
    the incoming channel count (the fused routes bypass their forwards)."""
    if conv.weight._var is None:
        conv.weight.shape = (conv._channels,) + conv._kernel + (in_ch // conv._groups,)
        conv.weight._finish_deferred_init()
    for p in (bn.gamma, bn.beta, bn.running_mean, bn.running_var):
        if p._var is None:
            p.shape = (conv._channels,)
            p._finish_deferred_init()


def _fused_block_train(block_kind, x, pairs, stride):
    """A whole V1 block through ``npx.fused_resnet_block``: ``pairs`` are
    [(conv, bn), ...], the main path first and the downsample last when
    present; the running-statistics updates go back into the BatchNorm
    children as their own forwards would write them."""
    n_main = 3 if block_kind == "bottleneck" else 2
    in_ch = x.shape[-1]
    prev = in_ch
    for i, (conv, bn) in enumerate(pairs):
        # main-path convs chain; the downsample conv branches from the input
        _init_pair(conv, bn, in_ch if (i == 0 or i >= n_main) else prev)
        prev = conv._channels
    conv_params = [(c.weight.data(), None if c.bias is None else c.bias.data())
                   for c, _ in pairs]
    bn_params = [(b.gamma.data(), b.beta.data(), b.running_mean.data(),
                  b.running_var.data()) for _, b in pairs]
    z, updates = npx.fused_resnet_block(x, conv_params, bn_params, kind=block_kind,
                                        stride=stride, eps=pairs[0][1]._eps,
                                        momentum=pairs[0][1]._momentum)
    for (new_rm, new_rv), (_, bn) in zip(updates, pairs):
        _write_stats(bn, new_rm, new_rv)
    return z


def _fused_v1(block, kind, x, pairs):
    """A V1 block on the NHWC fused route: the whole-block composite in
    training, fused conv + BN pairs in inference (the last absorbing the
    residual add and the block's ReLU)."""
    b = block.body
    if block.downsample is not None:
        pairs.append((block.downsample[0], block.downsample[1]))
    if _tape.is_training():
        return _fused_block_train(kind, x, pairs, stride=b[0]._strides)
    n_main = 3 if kind == "bottleneck" else 2
    h = x
    for conv, bn in pairs[:n_main - 1]:
        h = _fused_cbr(conv, bn, h, relu=True)
    residual = x if block.downsample is None else _fused_cbr(*pairs[-1], x, relu=False)
    return _fused_cbr(*pairs[n_main - 1], h, relu=True, residual=residual)


def _conv3x3(channels, stride, in_channels, layout=None):
    return nn.Conv2D(channels, kernel_size=3, strides=stride, padding=1, use_bias=False,
                     in_channels=in_channels, layout=layout)


def _downsample(channels, stride, in_channels, layout, ax):
    ds = nn.HybridSequential()
    ds.add(nn.Conv2D(channels, kernel_size=1, strides=stride, use_bias=False,
                     in_channels=in_channels, layout=layout))
    ds.add(nn.BatchNorm(axis=ax))
    return ds


class BasicBlockV1(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0, layout=None):
        super().__init__()
        ax = _bn_axis(layout)
        self._layout = layout
        self.body = nn.HybridSequential()
        self.body.add(_conv3x3(channels, stride, in_channels, layout))
        self.body.add(nn.BatchNorm(axis=ax))
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(channels, 1, channels, layout))
        self.body.add(nn.BatchNorm(axis=ax))
        self.downsample = _downsample(channels, stride, in_channels, layout, ax) \
            if downsample else None

    def forward(self, x):
        b = self.body
        if _can_fuse(self._layout, b[0], b[1]):
            return _fused_v1(self, "basic", x, [(b[0], b[1]), (b[3], b[4])])
        out = self.body(x)
        residual = x if self.downsample is None else self.downsample(x)
        return npx.activation(out + residual, "relu")


class BottleneckV1(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0, layout=None):
        super().__init__()
        ax = _bn_axis(layout)
        self._layout = layout
        self.body = nn.HybridSequential()
        self.body.add(nn.Conv2D(channels // 4, kernel_size=1, strides=stride, layout=layout))
        self.body.add(nn.BatchNorm(axis=ax))
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(channels // 4, 1, channels // 4, layout))
        self.body.add(nn.BatchNorm(axis=ax))
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(channels, kernel_size=1, strides=1, layout=layout))
        self.body.add(nn.BatchNorm(axis=ax))
        self.downsample = _downsample(channels, stride, in_channels, layout, ax) \
            if downsample else None

    def forward(self, x):
        b = self.body
        if _can_fuse(self._layout, b[0], b[1]):
            return _fused_v1(self, "bottleneck", x, [(b[0], b[1]), (b[3], b[4]), (b[6], b[7])])
        out = self.body(x)
        residual = x if self.downsample is None else self.downsample(x)
        return npx.activation(out + residual, "relu")


class BasicBlockV2(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0, layout=None):
        super().__init__()
        ax = _bn_axis(layout)
        self.bn1 = nn.BatchNorm(axis=ax)
        self.conv1 = _conv3x3(channels, stride, in_channels, layout)
        self.bn2 = nn.BatchNorm(axis=ax)
        self.conv2 = _conv3x3(channels, 1, channels, layout)
        self.downsample = nn.Conv2D(channels, 1, stride, use_bias=False,
                                    in_channels=in_channels, layout=layout) \
            if downsample else None

    def forward(self, x):
        residual = x
        x = npx.activation(self.bn1(x), "relu")
        if self.downsample is not None:
            residual = self.downsample(x)
        x = npx.activation(self.bn2(self.conv1(x)), "relu")
        return self.conv2(x) + residual


class BottleneckV2(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0, layout=None):
        super().__init__()
        ax = _bn_axis(layout)
        self.bn1 = nn.BatchNorm(axis=ax)
        self.conv1 = nn.Conv2D(channels // 4, kernel_size=1, strides=1, use_bias=False,
                               layout=layout)
        self.bn2 = nn.BatchNorm(axis=ax)
        self.conv2 = _conv3x3(channels // 4, stride, channels // 4, layout)
        self.bn3 = nn.BatchNorm(axis=ax)
        self.conv3 = nn.Conv2D(channels, kernel_size=1, strides=1, use_bias=False,
                               layout=layout)
        self.downsample = nn.Conv2D(channels, 1, stride, use_bias=False,
                                    in_channels=in_channels, layout=layout) \
            if downsample else None

    def forward(self, x):
        residual = x
        x = npx.activation(self.bn1(x), "relu")
        if self.downsample is not None:
            residual = self.downsample(x)
        x = npx.activation(self.bn2(self.conv1(x)), "relu")
        x = npx.activation(self.bn3(self.conv2(x)), "relu")
        return self.conv3(x) + residual


def _s2d_input(x):
    """[B, H, W, C] -> [B, (H+6)/2, (W+6)/2, 4C]: padded by (4, 2), 2 x 2
    spatial blocks gathered into channels."""
    B, H, W, C = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, 4, 2, 4, 2))
    Hp, Wp = H + 6, W + 6
    return xp.reshape(B, Hp // 2, 2, Wp // 2, 2, C).permute(0, 1, 3, 2, 4, 5) \
        .reshape(B, Hp // 2, Wp // 2, 4 * C)


def _s2d_weight(w):
    """[O, 7, 7, C] -> [O, 4, 4, 4C]: the 7 x 7 kernel padded by a zero row
    and column in front and regrouped as :func:`_s2d_input` regroups x."""
    O, _, _, C = w.shape
    wp = torch.nn.functional.pad(w, (0, 0, 1, 0, 1, 0))
    return wp.reshape(O, 4, 2, 4, 2, C).permute(0, 1, 3, 2, 4, 5).reshape(O, 4, 4, 4 * C)


def _stem_s2d(conv, bn, x):
    """The space-to-depth stem: the 7x7/2 conv over 3 channels rewritten as
    the identical 4x4/1 conv over 12 channels (y[p, q] = sum of w[2a'+da-1,
    2b'+db-1, c] * x[2(p+a')+da-4, ...]), through the fused conv + BN +
    ReLU. The stored parameter stays the [64, 7, 7, 3] weight: its
    rearrangement is part of the graph, so gradients reach it."""
    _init_pair(conv, bn, x.shape[-1])
    # one funnel call: with a raw tensor x the weight's rearrangement stays
    # in PyTorch's graph too
    x2, w2 = apply(lambda xv, wv: (_s2d_input(xv), _s2d_weight(wv)), x, conv.weight.data())
    training = _tape.is_training() and not bn._use_global_stats
    out, new_rm, new_rv = npx.fused_conv_bn_relu(
        x2, w2, bn.gamma.data(), bn.beta.data(), bn.running_mean.data(),
        bn.running_var.data(), bias=None if conv.bias is None else conv.bias.data(),
        stride=(1, 1), pad=(0, 0), eps=bn._eps, momentum=bn._momentum, relu=True,
        use_global_stats=bn._use_global_stats)
    if training:
        _write_stats(bn, new_rm, new_rv)
    return out


class ResNetV1(HybridBlock):
    def __init__(self, block, layers: List[int], channels: List[int], classes: int = 1000,
                 thumbnail: bool = False, layout=None):
        super().__init__()
        assert len(layers) == len(channels) - 1
        ax = _bn_axis(layout)
        self._layout = layout
        self.features = nn.HybridSequential()
        if thumbnail:
            self.features.add(_conv3x3(channels[0], 1, 0, layout))
        else:
            self.features.add(nn.Conv2D(channels[0], 7, 2, 3, use_bias=False, layout=layout))
            self.features.add(nn.BatchNorm(axis=ax))
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.MaxPool2D(3, 2, 1, layout=layout))
        for i, num_layer in enumerate(layers):
            stride = 1 if i == 0 else 2
            self.features.add(self._make_layer(block, num_layer, channels[i + 1], stride,
                                               in_channels=channels[i], layout=layout))
        self.features.add(nn.GlobalAvgPool2D(layout=layout))
        self.features.add(nn.Flatten())
        self.output = nn.Dense(classes, in_units=channels[-1])

    @staticmethod
    def _make_layer(block, num_layers, channels, stride, in_channels=0, layout=None):
        layer = nn.HybridSequential()
        layer.add(block(channels, stride, channels != in_channels, in_channels=in_channels,
                        layout=layout))
        for _ in range(num_layers - 1):
            layer.add(block(channels, 1, False, in_channels=channels, layout=layout))
        return layer

    def forward(self, x):
        f = self.features
        if (self._layout == "NHWC" and len(f) > 3 and isinstance(f[0], nn.Conv2D)
                and f[0]._kernel == (7, 7) and _can_fuse(self._layout, f[0], f[1])
                and x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0):
            x = _stem_s2d(f[0], f[1], x)
            for child in list(f._children.values())[3:]:
                x = child(x)
            return self.output(x)
        return self.output(self.features(x))


class ResNetV2(HybridBlock):
    def __init__(self, block, layers: List[int], channels: List[int], classes: int = 1000,
                 thumbnail: bool = False, layout=None):
        super().__init__()
        assert len(layers) == len(channels) - 1
        ax = _bn_axis(layout)
        self.features = nn.HybridSequential()
        self.features.add(nn.BatchNorm(axis=ax, scale=False, center=False))
        if thumbnail:
            self.features.add(_conv3x3(channels[0], 1, 0, layout))
        else:
            self.features.add(nn.Conv2D(channels[0], 7, 2, 3, use_bias=False, layout=layout))
            self.features.add(nn.BatchNorm(axis=ax))
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.MaxPool2D(3, 2, 1, layout=layout))
        in_channels = channels[0]
        for i, num_layer in enumerate(layers):
            stride = 1 if i == 0 else 2
            self.features.add(ResNetV1._make_layer(block, num_layer, channels[i + 1], stride,
                                                   in_channels=in_channels, layout=layout))
            in_channels = channels[i + 1]
        self.features.add(nn.BatchNorm(axis=ax))
        self.features.add(nn.Activation("relu"))
        self.features.add(nn.GlobalAvgPool2D(layout=layout))
        self.features.add(nn.Flatten())
        self.output = nn.Dense(classes, in_units=in_channels)

    def forward(self, x):
        return self.output(self.features(x))


resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}
resnet_net_versions = [ResNetV1, ResNetV2]
resnet_block_versions = [
    {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1},
    {"basic_block": BasicBlockV2, "bottle_neck": BottleneckV2},
]


def get_resnet(version: int, num_layers: int, pretrained: bool = False, device=None,
               **kwargs):
    if num_layers not in resnet_spec:
        raise MXNetError(f"invalid resnet depth {num_layers}; "
                         f"options: {sorted(resnet_spec)}")
    if pretrained:
        raise MXNetError("pretrained weights unavailable (no network egress); "
                         "use load_parameters with a local file")
    block_type, layers, channels = resnet_spec[num_layers]
    resnet_class = resnet_net_versions[version - 1]
    block_class = resnet_block_versions[version - 1][block_type]
    return resnet_class(block_class, layers, channels, **kwargs)


def _maker(version, depth):
    def make(**kwargs):
        return get_resnet(version, depth, **kwargs)
    make.__name__ = make.__qualname__ = f"resnet{depth}_v{version}"
    return make


resnet18_v1, resnet34_v1, resnet50_v1, resnet101_v1, resnet152_v1 = (
    _maker(1, d) for d in (18, 34, 50, 101, 152))
resnet18_v2, resnet34_v2, resnet50_v2, resnet101_v2, resnet152_v2 = (
    _maker(2, d) for d in (18, 34, 50, 101, 152))
