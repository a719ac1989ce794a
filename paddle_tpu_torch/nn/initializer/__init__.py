"""Weight initializers (a subset of ``paddle_tpu/nn/initializer``).

An initializer is called with ``(shape, dtype, device)`` and returns a
torch tensor drawn from that device's seeded generator
(``framework/random.py``). Fans follow Paddle's ``(in, out)`` weight
layout.
"""
from __future__ import annotations

import math

import torch

from ...framework import random as grandom

__all__ = ["Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
           "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
           "calculate_gain"]


def calculate_gain(nonlinearity, param=None):
    gains = {
        "sigmoid": 1.0, "linear": 1.0,
        "conv1d": 1.0, "conv2d": 1.0, "conv3d": 1.0,
        "conv_transpose1d": 1.0, "conv_transpose2d": 1.0,
        "conv_transpose3d": 1.0,
        "tanh": 5.0 / 3,
        "relu": math.sqrt(2.0),
        "leaky_relu": math.sqrt(
            2.0 / (1 + (param if param is not None else 0.01) ** 2)),
        "selu": 3.0 / 4,
    }
    if nonlinearity not in gains:
        raise ValueError(f"unknown nonlinearity {nonlinearity}")
    return gains[nonlinearity]


def _fan_in_out(shape):
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        # paddle convention: weight is [in, out]
        return shape[0], shape[1]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


def _empty(shape, dtype, device):
    return torch.empty(tuple(shape), dtype=dtype, device=device)


class Initializer:
    def __call__(self, shape, dtype, device):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype, device):
        return torch.full(tuple(shape), self.value, dtype=dtype,
                          device=device)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype, device):
        return _empty(shape, dtype, device).normal_(
            self.mean, self.std, generator=grandom.generator(device))


class TruncatedNormal(Initializer):
    """Normal(mean, std) cut at two standard deviations, drawn by the
    inverse CDF of a uniform draw."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype, device):
        cdf = lambda v: 0.5 * (1.0 + math.erf(v / math.sqrt(2.0)))
        u = _empty(shape, torch.float32, device).uniform_(
            2.0 * cdf(-2.0) - 1.0, 2.0 * cdf(2.0) - 1.0,
            generator=grandom.generator(device))
        t = torch.erfinv(u).mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
        return (t * self.std + self.mean).to(dtype)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype, device):
        return _empty(shape, dtype, device).uniform_(
            self.low, self.high, generator=grandom.generator(device))


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype, device):
        fi, fo = _fan_in_out(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return Normal(0.0, std)(shape, dtype, device)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype, device):
        fi, fo = _fan_in_out(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return Uniform(-limit, limit)(shape, dtype, device)


class KaimingNormal(Initializer):
    """Normal(0, gain / sqrt(fan_in)); ``fan_in`` defaults to the
    shape's."""

    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="relu"):
        self.fan_in, self.negative_slope = fan_in, negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype, device):
        fi = self.fan_in if self.fan_in is not None else _fan_in_out(shape)[0]
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        return Normal(0.0, gain / math.sqrt(fi))(shape, dtype, device)


class KaimingUniform(Initializer):
    """Uniform(-gain·sqrt(3 / fan_in), +gain·sqrt(3 / fan_in)): the conv
    layers' default weight initializer."""

    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="relu"):
        self.fan_in, self.negative_slope = fan_in, negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype, device):
        fi = self.fan_in if self.fan_in is not None else _fan_in_out(shape)[0]
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        limit = gain * math.sqrt(3.0 / fi)
        return Uniform(-limit, limit)(shape, dtype, device)
