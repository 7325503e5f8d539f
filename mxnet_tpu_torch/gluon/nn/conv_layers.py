"""Gluon convolution and pooling layers with the JAX package's signatures
(counterpart of ``mxnet_tpu/gluon/nn/conv_layers.py``): ``Conv1D``-
``Conv3D``, their transposes, and max, average, global max and global
average pooling in 1-D, 2-D and 3-D, over ``npx.convolution``,
``npx.deconvolution`` and ``npx.pooling``.

NCHW-family layouts by default; ``layout='NHWC'`` (NWC, NDHWC) keeps
channels last, with weights stored ``(out, *kernel, in/groups)``; on the
card those tensors reach cuDNN as channels-last views. A weight's input
channels are inferred at the first forward when ``in_channels`` is 0.
"""
from __future__ import annotations

import numpy as onp

from ... import numpy_extension as npx
from ...base import MXNetError
from ..block import HybridBlock
from ..parameter import Parameter

__all__ = [
    "Conv1D", "Conv2D", "Conv3D",
    "Conv1DTranspose", "Conv2DTranspose", "Conv3DTranspose",
    "MaxPool1D", "MaxPool2D", "MaxPool3D",
    "AvgPool1D", "AvgPool2D", "AvgPool3D",
    "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
    "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D",
]


def _tup(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _Conv(HybridBlock):
    def __init__(self, channels, kernel_size, strides, padding, dilation, groups, use_bias,
                 in_channels, activation, weight_initializer, bias_initializer, ndim,
                 transpose=False, output_padding=0, dtype=onp.float32, layout=None):
        super().__init__()
        self._channels = channels
        self._nd = ndim
        self._kernel = _tup(kernel_size, ndim)
        self._strides = _tup(strides, ndim)
        self._padding = _tup(padding, ndim)
        self._dilation = _tup(dilation, ndim)
        self._groups = groups
        self._activation = activation
        self._transpose = transpose
        self._output_padding = _tup(output_padding, ndim)
        self._layout = layout
        self._ch_last = layout is not None and layout.endswith("C")
        if transpose and self._ch_last:
            raise MXNetError("channel-last layout is not supported for "
                             "transposed convolution")
        self.weight = Parameter("weight", shape=self._weight_shape(in_channels), dtype=dtype,
                                init=weight_initializer, allow_deferred_init=True)
        self.bias = Parameter("bias", shape=(channels,), dtype=dtype,
                              init=bias_initializer) if use_bias else None

    def _weight_shape(self, in_ch):
        """(in, out/groups, *k) transposed; (out, *k, in/groups) channel-last;
        else (out, in/groups, *k). An unknown ``in_ch`` (0) stays 0."""
        if self._transpose:
            return (in_ch, self._channels // self._groups) + self._kernel
        per_group = in_ch // self._groups if in_ch else 0
        if self._ch_last:
            return (self._channels,) + self._kernel + (per_group,)
        return (self._channels, per_group) + self._kernel

    def forward(self, x):
        if self.weight._var is None:
            self.weight.shape = self._weight_shape(x.shape[-1] if self._ch_last else x.shape[1])
            self.weight._finish_deferred_init()
        bias = None if self.bias is None else self.bias.data()
        if self._transpose:
            out = npx.deconvolution(x, self.weight.data(), bias, kernel=self._kernel,
                                    stride=self._strides, dilate=self._dilation,
                                    pad=self._padding, adj=self._output_padding,
                                    num_filter=self._channels, num_group=self._groups,
                                    no_bias=bias is None)
        else:
            out = npx.convolution(x, self.weight.data(), bias, kernel=self._kernel,
                                  stride=self._strides, dilate=self._dilation,
                                  pad=self._padding, num_filter=self._channels,
                                  num_group=self._groups, no_bias=bias is None,
                                  layout=self._layout)
        if self._activation:
            out = npx.activation(out, self._activation)
        return out

    def __repr__(self):
        kind = "ConvTranspose" if self._transpose else "Conv"
        return (f"{kind}{self._nd}D({self._channels}, kernel={self._kernel}, "
                f"stride={self._strides}, pad={self._padding})")


def _make_conv(name, ndim, transpose):
    class C(_Conv):
        def __init__(self, channels, kernel_size, strides=1, padding=0, output_padding=0,
                     dilation=1, groups=1, layout=None, activation=None, use_bias=True,
                     weight_initializer=None, bias_initializer="zeros", in_channels=0,
                     dtype=onp.float32):
            super().__init__(channels, kernel_size, strides, padding, dilation, groups,
                             use_bias, in_channels, activation, weight_initializer,
                             bias_initializer, ndim, transpose=transpose,
                             output_padding=output_padding if transpose else 0,
                             dtype=dtype, layout=layout)
    C.__name__ = C.__qualname__ = name
    return C


Conv1D = _make_conv("Conv1D", 1, False)
Conv2D = _make_conv("Conv2D", 2, False)
Conv3D = _make_conv("Conv3D", 3, False)
Conv1DTranspose = _make_conv("Conv1DTranspose", 1, True)
Conv2DTranspose = _make_conv("Conv2DTranspose", 2, True)
Conv3DTranspose = _make_conv("Conv3DTranspose", 3, True)


class _Pool(HybridBlock):
    def __init__(self, pool_type, pool_size, strides, padding, ndim, global_pool=False,
                 count_include_pad=True, ceil_mode=False, layout=None):
        super().__init__()
        self._type = pool_type
        self._nd = ndim
        self._global = global_pool
        self._size = _tup(pool_size, ndim)
        self._strides = _tup(strides if strides is not None else pool_size, ndim)
        self._padding = _tup(padding, ndim)
        self._count_include_pad = count_include_pad
        self._ceil_mode = ceil_mode
        self._layout = layout

    def forward(self, x):
        return npx.pooling(x, kernel=self._size, pool_type=self._type, stride=self._strides,
                           pad=self._padding, global_pool=self._global,
                           count_include_pad=self._count_include_pad,
                           pooling_convention="full" if self._ceil_mode else "valid",
                           layout=self._layout)

    def __repr__(self):
        if self._global:
            return f"Global{self._type.capitalize()}Pool{self._nd}D"
        return (f"{self._type.capitalize()}Pool{self._nd}D(size={self._size}, "
                f"stride={self._strides}, pad={self._padding})")


def _make_pool(name, pool_type, ndim, global_pool):
    if global_pool:
        class P(_Pool):
            def __init__(self, layout=None):
                super().__init__(pool_type, 1, 1, 0, ndim, global_pool=True, layout=layout)
    else:
        class P(_Pool):
            def __init__(self, pool_size=2, strides=None, padding=0, layout=None,
                         ceil_mode=False, count_include_pad=True):
                super().__init__(pool_type, pool_size, strides, padding, ndim,
                                 count_include_pad=count_include_pad, ceil_mode=ceil_mode,
                                 layout=layout)
    P.__name__ = P.__qualname__ = name
    return P


MaxPool1D = _make_pool("MaxPool1D", "max", 1, False)
MaxPool2D = _make_pool("MaxPool2D", "max", 2, False)
MaxPool3D = _make_pool("MaxPool3D", "max", 3, False)
AvgPool1D = _make_pool("AvgPool1D", "avg", 1, False)
AvgPool2D = _make_pool("AvgPool2D", "avg", 2, False)
AvgPool3D = _make_pool("AvgPool3D", "avg", 3, False)
GlobalMaxPool1D = _make_pool("GlobalMaxPool1D", "max", 1, True)
GlobalMaxPool2D = _make_pool("GlobalMaxPool2D", "max", 2, True)
GlobalMaxPool3D = _make_pool("GlobalMaxPool3D", "max", 3, True)
GlobalAvgPool1D = _make_pool("GlobalAvgPool1D", "avg", 1, True)
GlobalAvgPool2D = _make_pool("GlobalAvgPool2D", "avg", 2, True)
GlobalAvgPool3D = _make_pool("GlobalAvgPool3D", "avg", 3, True)
