"""Conv1D, Conv2D and Conv3D (``paddle_tpu/nn/layer/conv.py``): weight
(out, in / groups, *kernel) drawn by ``KaimingUniform`` over the fan-in
(in / groups)·prod(kernel), a bias of zeros unless ``bias_attr=False``.
The transposed convolutions are not ported yet."""
from __future__ import annotations

import math

from .. import functional as F
from .. import initializer as I
from ..functional.conv import _ntuple
from .layers import Layer

__all__ = ["Conv1D", "Conv2D", "Conv3D"]


class _ConvNd(Layer):
    _fn = None

    def __init__(self, in_channels, out_channels, kernel_size, stride,
                 padding, dilation, groups, padding_mode, weight_attr,
                 bias_attr, data_format, dims):
        super().__init__()
        if in_channels % groups != 0:
            raise ValueError("in_channels must be divisible by groups")
        if padding_mode != "zeros":
            raise NotImplementedError(f"padding_mode={padding_mode!r} is "
                                      f"not ported to paddle_tpu_torch")
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _ntuple(kernel_size, dims)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._padding_mode = padding_mode
        self._data_format = data_format
        fan_in = (in_channels // groups) * math.prod(self._kernel_size)
        self.weight = self.create_parameter(
            shape=[out_channels, in_channels // groups]
            + list(self._kernel_size), attr=weight_attr,
            default_initializer=I.KaimingUniform(fan_in=fan_in))
        self.bias = self.create_parameter(shape=[out_channels],
                                          attr=bias_attr, is_bias=True)

    def forward(self, x):
        return type(self)._fn(x, self.weight, self.bias, self._stride,
                              self._padding, self._dilation, self._groups,
                              self._data_format)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}")


class Conv1D(_ConvNd):
    _fn = staticmethod(F.conv1d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, 1)


class Conv2D(_ConvNd):
    _fn = staticmethod(F.conv2d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, 2)


class Conv3D(_ConvNd):
    _fn = staticmethod(F.conv3d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, 3)
