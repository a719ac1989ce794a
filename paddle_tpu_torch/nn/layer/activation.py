"""Activation layers (``paddle_tpu/nn/layer/activation.py``): each calls
its functional in ``nn/functional/activation.py``. ``PReLU`` owns one
weight (``num_parameters`` of them, ``init`` each); ``RReLU`` draws its
slopes only in training."""
from __future__ import annotations

from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = [
    "ReLU", "ReLU6", "GELU", "Sigmoid", "Tanh", "Softmax", "LogSoftmax",
    "LeakyReLU", "ELU", "SELU", "CELU", "Silu", "Swish", "Mish", "Hardshrink",
    "Hardsigmoid", "Hardswish", "Hardtanh", "Softplus", "Softshrink",
    "Softsign", "Tanhshrink", "ThresholdedReLU", "Maxout", "PReLU",
    "LogSigmoid", "GLU", "RReLU",
]


def _simple(name, fn_name):
    def __init__(self, name=None):
        Layer.__init__(self)

    def forward(self, x):
        return getattr(F, fn_name)(x)

    return type(name, (Layer,), {"__init__": __init__, "forward": forward,
                                 "__module__": __name__})


ReLU = _simple("ReLU", "relu")
ReLU6 = _simple("ReLU6", "relu6")
Sigmoid = _simple("Sigmoid", "sigmoid")
Tanh = _simple("Tanh", "tanh")
Silu = _simple("Silu", "silu")
Swish = _simple("Swish", "swish")
Mish = _simple("Mish", "mish")
Hardswish = _simple("Hardswish", "hardswish")
Hardsigmoid = _simple("Hardsigmoid", "hardsigmoid")
Softsign = _simple("Softsign", "softsign")
Tanhshrink = _simple("Tanhshrink", "tanhshrink")
LogSigmoid = _simple("LogSigmoid", "log_sigmoid")


def _with_args(name, fn_name, **defaults):
    """A layer whose constructor takes ``defaults``' keywords (in that
    order) and passes them to the functional."""
    keys = tuple(defaults)

    def __init__(self, *args, name=None, **kwargs):
        Layer.__init__(self)
        vals = dict(defaults)
        vals.update(zip(keys, args))
        vals.update(kwargs)
        for k in keys:
            setattr(self, k, vals[k])

    def forward(self, x):
        return getattr(F, fn_name)(x, *(getattr(self, k) for k in keys))

    def extra_repr(self):
        return ", ".join(f"{k}={getattr(self, k)}" for k in keys)

    return type(name, (Layer,), {"__init__": __init__, "forward": forward,
                                 "extra_repr": extra_repr,
                                 "__module__": __name__})


GELU = _with_args("GELU", "gelu", approximate=False)
Softmax = _with_args("Softmax", "softmax", axis=-1)
LogSoftmax = _with_args("LogSoftmax", "log_softmax", axis=-1)
LeakyReLU = _with_args("LeakyReLU", "leaky_relu", negative_slope=0.01)
ELU = _with_args("ELU", "elu", alpha=1.0)
SELU = _with_args("SELU", "selu", scale=1.0507009873554805,
                  alpha=1.6732632423543772)
CELU = _with_args("CELU", "celu", alpha=1.0)
Hardshrink = _with_args("Hardshrink", "hardshrink", threshold=0.5)
Hardtanh = _with_args("Hardtanh", "hardtanh", min=-1.0, max=1.0)
Softplus = _with_args("Softplus", "softplus", beta=1.0, threshold=20.0)
Softshrink = _with_args("Softshrink", "softshrink", threshold=0.5)
ThresholdedReLU = _with_args("ThresholdedReLU", "thresholded_relu",
                             threshold=1.0)
GLU = _with_args("GLU", "glu", axis=-1)


class Maxout(Layer):
    def __init__(self, groups, axis=1, name=None):
        super().__init__()
        self.groups, self.axis = groups, axis

    def forward(self, x):
        return F.maxout(x, self.groups, self.axis)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None):
        super().__init__()
        self.weight = self.create_parameter(
            shape=[num_parameters], attr=weight_attr,
            default_initializer=I.Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight)


class RReLU(Layer):
    def __init__(self, lower=1.0 / 8.0, upper=1.0 / 3.0, name=None):
        super().__init__()
        self.lower, self.upper = lower, upper

    def forward(self, x):
        return F.rrelu(x, self.lower, self.upper, self.training)
