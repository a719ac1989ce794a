"""Tensor creation ops (a subset of ``paddle_tpu/tensor/creation.py``).
New tensors go to the current device (``paddle_tpu_torch.device``)."""
from __future__ import annotations

import torch

from ..device import current_device
from ..framework import dtype as dtypes
from ..framework.core import Tensor, to_tensor

__all__ = ["to_tensor", "zeros", "ones", "full", "arange"]


def _dt(dtype, default=None):
    d = dtypes.convert_dtype(dtype)
    return d if d is not None else (default or dtypes.default_float_dtype())


def _shape(shape):
    if isinstance(shape, Tensor):
        shape = shape.tolist()
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s) for s in shape)


def full(shape, fill_value, dtype=None, name=None):
    if isinstance(fill_value, Tensor):
        fill_value = fill_value.item()
    return Tensor(torch.full(_shape(shape), fill_value, dtype=_dt(dtype),
                             device=current_device()))


def zeros(shape, dtype=None, name=None):
    return full(shape, 0, dtype)


def ones(shape, dtype=None, name=None):
    return full(shape, 1, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    start, end, step = (v.item() if isinstance(v, Tensor) else v
                        for v in (start, end, step))
    if end is None:
        start, end = 0, start
    if dtype is None:
        dtype = ("int64" if all(isinstance(v, int) for v in (start, end,
                                                             step))
                 else None)
    return Tensor(torch.arange(start, end, step, dtype=_dt(dtype),
                               device=current_device()))
