"""Inception V3 (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/inception.py``; Szegedy et al. 2016),
299 x 299 input."""
from __future__ import annotations

from ... import nn
from ...block import HybridBlock

__all__ = ["Inception3", "inception_v3"]


def _conv_bn(channels, kernel, stride=1, pad=0):
    out = nn.HybridSequential()
    out.add(nn.Conv2D(channels, kernel, stride, pad, use_bias=False),
            nn.BatchNorm(epsilon=0.001), nn.Activation("relu"))
    return out


class _Concurrent(HybridBlock):
    """Parallel branches, channel-concatenated."""

    def __init__(self, *branches):
        super().__init__()
        for b in branches:
            self.register_child(b)

    def forward(self, x):
        from .... import np as mxnp
        return mxnp.concatenate([b(x) for b in self._children.values()],
                                axis=1)


def _branch(*stages):
    out = nn.HybridSequential()
    out.add(*stages)
    return out


def _inception_a(pool_features):
    return _Concurrent(
        _branch(_conv_bn(64, 1)),
        _branch(_conv_bn(48, 1), _conv_bn(64, 5, pad=2)),
        _branch(_conv_bn(64, 1), _conv_bn(96, 3, pad=1),
                _conv_bn(96, 3, pad=1)),
        _branch(nn.AvgPool2D(3, strides=1, padding=1),
                _conv_bn(pool_features, 1)))


def _reduction_a():
    return _Concurrent(
        _branch(_conv_bn(384, 3, stride=2)),
        _branch(_conv_bn(64, 1), _conv_bn(96, 3, pad=1),
                _conv_bn(96, 3, stride=2)),
        _branch(nn.MaxPool2D(3, strides=2)))


def _inception_b(c7):
    return _Concurrent(
        _branch(_conv_bn(192, 1)),
        _branch(_conv_bn(c7, 1), _conv_bn(c7, (1, 7), pad=(0, 3)),
                _conv_bn(192, (7, 1), pad=(3, 0))),
        _branch(_conv_bn(c7, 1), _conv_bn(c7, (7, 1), pad=(3, 0)),
                _conv_bn(c7, (1, 7), pad=(0, 3)),
                _conv_bn(c7, (7, 1), pad=(3, 0)),
                _conv_bn(192, (1, 7), pad=(0, 3))),
        _branch(nn.AvgPool2D(3, strides=1, padding=1), _conv_bn(192, 1)))


def _reduction_b():
    return _Concurrent(
        _branch(_conv_bn(192, 1), _conv_bn(320, 3, stride=2)),
        _branch(_conv_bn(192, 1), _conv_bn(192, (1, 7), pad=(0, 3)),
                _conv_bn(192, (7, 1), pad=(3, 0)),
                _conv_bn(192, 3, stride=2)),
        _branch(nn.MaxPool2D(3, strides=2)))


def _inception_c():
    return _Concurrent(
        _branch(_conv_bn(320, 1)),
        _branch(_conv_bn(384, 1),
                _Concurrent(_branch(_conv_bn(384, (1, 3), pad=(0, 1))),
                            _branch(_conv_bn(384, (3, 1), pad=(1, 0))))),
        _branch(_conv_bn(448, 1), _conv_bn(384, 3, pad=1),
                _Concurrent(_branch(_conv_bn(384, (1, 3), pad=(0, 1))),
                            _branch(_conv_bn(384, (3, 1), pad=(1, 0))))),
        _branch(nn.AvgPool2D(3, strides=1, padding=1), _conv_bn(192, 1)))


class Inception3(HybridBlock):
    def __init__(self, classes: int = 1000, dropout: float = 0.5):
        super().__init__()
        self.features = nn.HybridSequential()
        self.features.add(
            _conv_bn(32, 3, stride=2), _conv_bn(32, 3), _conv_bn(64, 3, pad=1),
            nn.MaxPool2D(3, strides=2),
            _conv_bn(80, 1), _conv_bn(192, 3),
            nn.MaxPool2D(3, strides=2),
            _inception_a(32), _inception_a(64), _inception_a(64),
            _reduction_a(),
            _inception_b(128), _inception_b(160), _inception_b(160),
            _inception_b(192),
            _reduction_b(),
            _inception_c(), _inception_c(),
            nn.GlobalAvgPool2D(), nn.Flatten(), nn.Dropout(dropout))
        self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


def inception_v3(**kwargs):
    return Inception3(**kwargs)
