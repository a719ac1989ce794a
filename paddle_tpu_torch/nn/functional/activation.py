"""Activation functionals (a subset of
``paddle_tpu/nn/functional/activation.py``). ``gelu`` defaults to the
exact erf form, as Paddle's does (``approximate=False``)."""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...framework import dtype as dtypes
from ...framework.core import apply_op

__all__ = ["relu", "gelu", "softmax"]


def relu(x, name=None):
    return apply_op(torch.relu, x)


def _gelu(x, approximate=False):
    return TF.gelu(x, approximate="tanh" if approximate else "none")


def gelu(x, approximate=False, name=None):
    return apply_op(_gelu, x, approximate=bool(approximate))


def _softmax(x, axis=-1, dtype=None):
    return torch.softmax(x if dtype is None else x.to(dtype), dim=axis)


def softmax(x, axis=-1, dtype=None, name=None):
    return apply_op(_softmax, x, axis=int(axis),
                    dtype=dtypes.convert_dtype(dtype))
