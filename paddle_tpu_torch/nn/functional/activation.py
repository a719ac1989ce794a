"""Activation functionals (``paddle_tpu/nn/functional/activation.py``).

Each computes the reference's formula on the tensor's own device:
``gelu`` defaults to the exact erf form (``approximate=False``), as
Paddle's does; ``hardsigmoid``'s default slope is Paddle's 0.1666667;
``prelu`` takes one weight, one per channel (axis 1) or one per element
of a sample. ``rrelu`` in training and ``gumbel_softmax`` draw from the
input device's seeded generator (``framework/random.py``). The in-place
forms (``relu_``, ``elu_``, ``softmax_``, ``tanh_``) rebind the Tensor to
the result, keeping a non-leaf's graph, and refuse a leaf that needs a
gradient (``framework.core.inplace_apply``)."""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...framework import dtype as dtypes
from ...framework import random as grandom
from ...framework.core import apply_op, inplace_apply, records

__all__ = [
    "relu", "relu6", "gelu", "sigmoid", "tanh", "softmax", "log_softmax",
    "leaky_relu", "elu", "selu", "celu", "silu", "swish", "mish",
    "hardshrink", "hardsigmoid", "hardswish", "hardtanh", "softplus",
    "softshrink", "softsign", "tanhshrink", "thresholded_relu", "maxout",
    "prelu", "rrelu", "glu", "gumbel_softmax", "log_sigmoid",
    "relu_", "elu_", "softmax_", "tanh_",
]


def _unary(fn, name):
    def op(x, name=None):
        return apply_op(fn, x)

    op.__name__ = op.__qualname__ = name
    return op


def _relu6(x):
    return torch.clamp(x, 0.0, 6.0)


def _swish(x):
    return x * torch.sigmoid(x)


def _softsign(x):
    return x / (1 + torch.abs(x))


def _tanhshrink(x):
    return x - torch.tanh(x)


relu = _unary(torch.relu, "relu")
relu6 = _unary(_relu6, "relu6")
sigmoid = _unary(torch.sigmoid, "sigmoid")
tanh = _unary(torch.tanh, "tanh")
silu = _unary(TF.silu, "silu")
swish = _unary(_swish, "swish")
mish = _unary(TF.mish, "mish")
hardswish = _unary(TF.hardswish, "hardswish")
softsign = _unary(_softsign, "softsign")
tanhshrink = _unary(_tanhshrink, "tanhshrink")
log_sigmoid = _unary(TF.logsigmoid, "log_sigmoid")


def _gelu(x, approximate=False):
    return TF.gelu(x, approximate="tanh" if approximate else "none")


def gelu(x, approximate=False, name=None):
    return apply_op(_gelu, x, approximate=bool(approximate))


def _softmax(x, axis=-1, dtype=None):
    return torch.softmax(x if dtype is None else x.to(dtype), dim=axis)


def softmax(x, axis=-1, dtype=None, name=None):
    return apply_op(_softmax, x, axis=int(axis),
                    dtype=dtypes.convert_dtype(dtype))


def _log_softmax(x, axis=-1, dtype=None):
    return torch.log_softmax(x if dtype is None else x.to(dtype), dim=axis)


def log_softmax(x, axis=-1, dtype=None, name=None):
    return apply_op(_log_softmax, x, axis=int(axis),
                    dtype=dtypes.convert_dtype(dtype))


def _leaky_relu(x, negative_slope=0.01):
    return torch.where(x >= 0, x, negative_slope * x)


def leaky_relu(x, negative_slope=0.01, name=None):
    return apply_op(_leaky_relu, x, negative_slope=float(negative_slope))


def _elu(x, alpha=1.0):
    return torch.where(x > 0, x, alpha * torch.expm1(x))


def elu(x, alpha=1.0, name=None):
    return apply_op(_elu, x, alpha=float(alpha))


def _selu(x, scale=1.0507009873554805, alpha=1.6732632423543772):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return apply_op(_selu, x, scale=float(scale), alpha=float(alpha))


def celu(x, alpha=1.0, name=None):
    return apply_op(TF.celu, x, alpha=float(alpha))


def _hardshrink(x, threshold=0.5):
    return torch.where(torch.abs(x) > threshold, x, torch.zeros_like(x))


def hardshrink(x, threshold=0.5, name=None):
    return apply_op(_hardshrink, x, threshold=float(threshold))


def _hardsigmoid(x, slope=0.1666667, offset=0.5):
    return torch.clamp(slope * x + offset, 0.0, 1.0)


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    return apply_op(_hardsigmoid, x, slope=float(slope), offset=float(offset))


def hardtanh(x, min=-1.0, max=1.0, name=None):  # noqa: A002
    return apply_op(torch.clamp, x, min=float(min), max=float(max))


def _softplus(x, beta=1.0, threshold=20.0):
    return torch.where(x * beta > threshold, x,
                       TF.softplus(x * beta) / beta)


def softplus(x, beta=1.0, threshold=20.0, name=None):
    return apply_op(_softplus, x, beta=float(beta), threshold=float(threshold))


def _softshrink(x, threshold=0.5):
    zero = torch.zeros_like(x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, zero))


def softshrink(x, threshold=0.5, name=None):
    return apply_op(_softshrink, x, threshold=float(threshold))


def _thresholded_relu(x, threshold=1.0):
    return torch.where(x > threshold, x, torch.zeros_like(x))


def thresholded_relu(x, threshold=1.0, name=None):
    return apply_op(_thresholded_relu, x, threshold=float(threshold))


def _maxout(x, groups, axis=1):
    axis %= x.dim()
    shape = list(x.shape)
    shape[axis: axis + 1] = [shape[axis] // groups, groups]
    return torch.amax(x.reshape(shape), dim=axis + 1)


def maxout(x, groups, axis=1, name=None):
    return apply_op(_maxout, x, groups=int(groups), axis=int(axis))


def _prelu(x, weight):
    if weight.numel() > 1:
        if tuple(weight.shape) == tuple(x.shape[1:]):
            # element mode: one alpha per element of a sample
            weight = weight.unsqueeze(0)
        else:
            shape = [1] * x.dim()
            shape[1] = weight.numel()
            weight = weight.reshape(shape)
    return torch.where(x >= 0, x, weight * x)


def prelu(x, weight, data_format="NCHW", name=None):
    return apply_op(_prelu, x, weight)


def _rrelu_apply(x, slope):
    return torch.where(x >= 0, x, slope * x)


@records
def rrelu(x, lower=0.125, upper=0.3333333333333333, training=True,
          name=None):
    """Leaky ReLU whose negative slope is drawn from U(lower, upper) per
    element in training, and is their mean otherwise."""
    if not training:
        return leaky_relu(x, (lower + upper) / 2)
    xa = x._data
    slope = torch.empty(xa.shape, dtype=xa.dtype, device=xa.device).uniform_(
        float(lower), float(upper), generator=grandom.generator(xa.device))
    return apply_op(_rrelu_apply, x, slope)


def _glu(x, axis=-1):
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


def glu(x, axis=-1, name=None):
    return apply_op(_glu, x, axis=int(axis))


def _gumbel_softmax(x, g, temperature=1.0, hard=False, axis=-1):
    y = torch.softmax((x + g) / temperature, dim=axis)
    if hard:
        idx = torch.argmax(y, dim=axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter(axis, idx, 1.0)
        # straight-through: the hard value forward, the soft gradient back
        y = (y_hard - y).detach() + y
    return y


@records
def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    """softmax((x + g) / temperature) with g standard Gumbel noise
    (−log of an Exp(1) draw from the device's seeded generator); ``hard``
    gives the one-hot of its argmax forward and the soft gradient."""
    xa = x._data
    e = torch.empty(xa.shape, dtype=xa.dtype, device=xa.device)
    e.exponential_(generator=grandom.generator(xa.device))
    return apply_op(_gumbel_softmax, x, -torch.log(e),
                    temperature=float(temperature), hard=bool(hard),
                    axis=int(axis))


def relu_(x, name=None):
    return inplace_apply(x, relu)


def elu_(x, alpha=1.0, name=None):
    return inplace_apply(x, elu, alpha=alpha)


def softmax_(x, axis=-1, dtype=None, name=None):
    return inplace_apply(x, softmax, axis=axis, dtype=dtype)


def tanh_(x, name=None):
    return inplace_apply(x, tanh)

