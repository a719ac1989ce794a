"""Shape ops (a subset of ``paddle_tpu/tensor/manipulation.py``), with
Paddle's conventions: ``reshape`` takes 0 for "keep this dimension",
``split`` a section count or a list of sizes (one may be -1),
``flatten`` folds the axes from ``start_axis`` to ``stop_axis`` into
one (a 0-d tensor becomes shape [1])."""
from __future__ import annotations

import torch

from ..framework import dtype as dtypes
from ..framework.core import Tensor, apply_op

__all__ = ["reshape", "transpose", "concat", "split", "unsqueeze", "cast",
           "flatten"]


def _reshape(x, shape):
    shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    return x.reshape(shape)


def reshape(x, shape, name=None):
    if isinstance(shape, Tensor):
        shape = shape.tolist()
    return apply_op(_reshape, x, shape=tuple(int(s) for s in shape))


def _transpose(x, perm):
    return x.permute(*perm)


def transpose(x, perm, name=None):
    return apply_op(_transpose, x, perm=tuple(int(p) for p in perm))


def _concat(*xs, axis=0):
    return torch.cat(xs, dim=axis)


def concat(x, axis=0, name=None):
    return apply_op(_concat, *x, axis=int(axis))


def _split(x, sections, axis):
    return tuple(torch.split(x, sections, dim=axis))


def split(x, num_or_sections, axis=0, name=None):
    n = x.shape[int(axis)]
    if isinstance(num_or_sections, int):
        if n % num_or_sections:
            raise ValueError(f"cannot split {n} into {num_or_sections} "
                             f"equal sections")
        sections = [n // num_or_sections] * num_or_sections
    else:
        sections = [int(s) for s in num_or_sections]
        if -1 in sections:
            sections[sections.index(-1)] = n - (sum(sections) + 1)
    return list(apply_op(_split, x, sections=sections, axis=int(axis)))


def _unsqueeze(x, axis):
    for a in sorted(a % (x.dim() + len(axis)) for a in axis):
        x = x.unsqueeze(a)
    return x


def unsqueeze(x, axis, name=None):
    axis = (axis,) if isinstance(axis, int) else tuple(int(a) for a in axis)
    return apply_op(_unsqueeze, x, axis=axis)


def _cast(x, dtype):
    return x.to(dtype)


def cast(x, dtype):
    return apply_op(_cast, x, dtype=dtypes.convert_dtype(dtype))


def _flatten(x, start_axis=0, stop_axis=-1):
    if x.dim() == 0:
        return x.reshape(1)
    return torch.flatten(x, start_axis % x.dim(), stop_axis % x.dim())


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    return apply_op(_flatten, x, start_axis=int(start_axis),
                    stop_axis=int(stop_axis))
