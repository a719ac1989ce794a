"""The pooling layers (``paddle_tpu/nn/layer/pooling.py``) over
``nn/functional/pooling.py``."""
from __future__ import annotations

from .. import functional as F
from .layers import Layer

__all__ = [
    "MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D", "AvgPool2D",
    "AvgPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
    "AdaptiveAvgPool3D", "AdaptiveMaxPool1D", "AdaptiveMaxPool2D",
    "AdaptiveMaxPool3D",
]


class MaxPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, name=None):
        super().__init__()
        self.args = (kernel_size, stride, padding, return_mask, ceil_mode)

    def forward(self, x):
        return F.max_pool1d(x, *self.args)


class MaxPool2D(Layer):
    _fn = staticmethod(F.max_pool2d)

    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, data_format="NCHW",
                 name=None):
        super().__init__()
        self.args = (kernel_size, stride, padding, ceil_mode, return_mask,
                     data_format)

    def forward(self, x):
        return type(self)._fn(x, *self.args)


class MaxPool3D(MaxPool2D):
    _fn = staticmethod(F.max_pool3d)

    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, data_format="NCDHW",
                 name=None):
        super().__init__(kernel_size, stride, padding, return_mask,
                         ceil_mode, data_format)


class AvgPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None):
        super().__init__()
        self.args = (kernel_size, stride, padding, exclusive, ceil_mode)

    def forward(self, x):
        return F.avg_pool1d(x, *self.args)


class AvgPool2D(Layer):
    _fn = staticmethod(F.avg_pool2d)

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.args = (kernel_size, stride, padding, ceil_mode, exclusive,
                     divisor_override, data_format)

    def forward(self, x):
        return type(self)._fn(x, *self.args)


class AvgPool3D(AvgPool2D):
    _fn = staticmethod(F.avg_pool3d)

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCDHW",
                 name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode, exclusive,
                         divisor_override, data_format)


class _Adaptive(Layer):
    _fn = None

    def __init__(self, output_size, *args):
        super().__init__()
        self.output_size = output_size
        self.args = args

    def forward(self, x):
        return type(self)._fn(x, self.output_size, *self.args)


class AdaptiveAvgPool1D(_Adaptive):
    _fn = staticmethod(F.adaptive_avg_pool1d)

    def __init__(self, output_size, name=None):
        super().__init__(output_size)


class AdaptiveAvgPool2D(_Adaptive):
    _fn = staticmethod(F.adaptive_avg_pool2d)

    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__(output_size, data_format)


class AdaptiveAvgPool3D(_Adaptive):
    _fn = staticmethod(F.adaptive_avg_pool3d)

    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__(output_size, data_format)


class AdaptiveMaxPool1D(_Adaptive):
    _fn = staticmethod(F.adaptive_max_pool1d)

    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(output_size, return_mask)


class AdaptiveMaxPool2D(AdaptiveMaxPool1D):
    _fn = staticmethod(F.adaptive_max_pool2d)


class AdaptiveMaxPool3D(AdaptiveMaxPool1D):
    _fn = staticmethod(F.adaptive_max_pool3d)
