"""DenseNet-BC 121/161/169/201 (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/densenet.py``; Huang et al. 2017):
dense connectivity as channel concatenation."""
from __future__ import annotations

from ... import nn
from ...block import HybridBlock

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201"]


class _DenseLayer(HybridBlock):
    """BN-ReLU-Conv(1x1, 4k) -> BN-ReLU-Conv(3x3, k), output concatenated
    onto the running feature stack."""

    def __init__(self, growth_rate: int, bn_size: int, dropout: float):
        super().__init__()
        self.body = nn.HybridSequential()
        self.body.add(nn.BatchNorm(), nn.Activation("relu"),
                      nn.Conv2D(bn_size * growth_rate, 1, use_bias=False),
                      nn.BatchNorm(), nn.Activation("relu"),
                      nn.Conv2D(growth_rate, 3, padding=1, use_bias=False))
        self.dropout = nn.Dropout(dropout) if dropout else None

    def forward(self, x):
        out = self.body(x)
        if self.dropout is not None:
            out = self.dropout(out)
        from .... import np as mxnp
        return mxnp.concatenate([x, out], axis=1)


class _Transition(HybridBlock):
    def __init__(self, out_channels: int):
        super().__init__()
        self.body = nn.HybridSequential()
        self.body.add(nn.BatchNorm(), nn.Activation("relu"),
                      nn.Conv2D(out_channels, 1, use_bias=False),
                      nn.AvgPool2D(2, strides=2))

    def forward(self, x):
        return self.body(x)


class DenseNet(HybridBlock):
    def __init__(self, num_init_features: int, growth_rate: int,
                 block_config, bn_size: int = 4, dropout: float = 0.0,
                 classes: int = 1000):
        super().__init__()
        self.features = nn.HybridSequential()
        self.features.add(
            nn.Conv2D(num_init_features, 7, strides=2, padding=3,
                      use_bias=False),
            nn.BatchNorm(), nn.Activation("relu"),
            nn.MaxPool2D(3, strides=2, padding=1))
        channels = num_init_features
        for i, layers in enumerate(block_config):
            block = nn.HybridSequential()
            for _ in range(layers):
                block.add(_DenseLayer(growth_rate, bn_size, dropout))
            self.features.add(block)
            channels += layers * growth_rate
            if i != len(block_config) - 1:
                channels //= 2
                self.features.add(_Transition(channels))
        self.features.add(nn.BatchNorm(), nn.Activation("relu"),
                          nn.GlobalAvgPool2D(), nn.Flatten())
        self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


_SPECS = {121: (64, 32, (6, 12, 24, 16)),
          161: (96, 48, (6, 12, 36, 24)),
          169: (64, 32, (6, 12, 32, 32)),
          201: (64, 32, (6, 12, 48, 32))}


def _densenet(depth: int, **kwargs) -> DenseNet:
    init_f, growth, cfg = _SPECS[depth]
    return DenseNet(init_f, growth, cfg, **kwargs)


def densenet121(**kwargs):
    return _densenet(121, **kwargs)


def densenet161(**kwargs):
    return _densenet(161, **kwargs)


def densenet169(**kwargs):
    return _densenet(169, **kwargs)


def densenet201(**kwargs):
    return _densenet(201, **kwargs)
