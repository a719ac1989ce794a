"""Math ops (a subset of ``paddle_tpu/tensor/math.py``): elementwise
arithmetic with broadcasting (``floor_divide`` and ``remainder`` round
toward minus infinity, as Python's ``//`` and ``%``), ``abs``,
``matmul`` (and ``mm``, ``bmm``) with Paddle's ``transpose_x`` /
``transpose_y``, cast to the AMP dtype under ``amp.auto_cast``, ``sum``,
``mean`` and ``scale``."""
from __future__ import annotations

import torch

from ..framework import dtype as dtypes
from ..framework.core import Tensor, _as_torch, apply_op

__all__ = ["add", "subtract", "multiply", "divide", "floor_divide",
           "remainder", "mod", "pow", "matmul", "mm", "bmm", "sum", "mean",
           "scale", "neg", "abs"]


def _operand(v, like):
    """A numpy array beside a Tensor becomes a torch tensor on the
    Tensor's device; Python scalars stay scalars."""
    if isinstance(v, (Tensor, int, float, bool)):
        return v
    dev = like._data.device if isinstance(like, Tensor) else None
    return _as_torch(v, device=dev)


def _binary(fn):
    def op(x, y, name=None):
        return apply_op(fn, _operand(x, y), _operand(y, x))

    op.__name__ = fn.__name__
    return op


add = _binary(torch.add)
subtract = _binary(torch.sub)
multiply = _binary(torch.mul)
divide = _binary(torch.true_divide)
floor_divide = _binary(torch.floor_divide)
remainder = _binary(torch.remainder)
mod = remainder
pow = _binary(torch.pow)  # noqa: A001


def _matmul(x, y, transpose_x=False, transpose_y=False):
    if transpose_x:
        x = x.transpose(-1, -2)
    if transpose_y:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    from ..amp import maybe_autocast

    x, y = maybe_autocast(x, y)
    return apply_op(_matmul, x, y, transpose_x=bool(transpose_x),
                    transpose_y=bool(transpose_y))


mm = matmul


def bmm(x, y, name=None):
    from ..amp import maybe_autocast

    x, y = maybe_autocast(x, y)
    return apply_op(torch.matmul, x, y)


def _axis(axis):
    if axis is None:
        return None
    return tuple(axis) if isinstance(axis, (list, tuple)) else int(axis)


def _sum(x, axis=None, keepdim=False, dtype=None):
    if axis is None:
        out = torch.sum(x, dtype=dtype)
        return out.reshape([1] * x.dim()) if keepdim else out
    return torch.sum(x, dim=axis, keepdim=keepdim, dtype=dtype)


def sum(x, axis=None, dtype=None, keepdim=False, name=None):  # noqa: A001
    return apply_op(_sum, x, axis=_axis(axis), keepdim=bool(keepdim),
                    dtype=dtypes.convert_dtype(dtype))


def _mean(x, axis=None, keepdim=False):
    if not (x.is_floating_point() or x.is_complex()):
        x = x.float()     # int and bool inputs: the f32 mean, as JAX's
    if axis is None:
        out = torch.mean(x)
        return out.reshape([1] * x.dim()) if keepdim else out
    return torch.mean(x, dim=axis, keepdim=keepdim)


def mean(x, axis=None, keepdim=False, name=None):
    return apply_op(_mean, x, axis=_axis(axis), keepdim=bool(keepdim))


def _scale(x, scale=1.0, bias=0.0, bias_after_scale=True):
    if bias_after_scale:
        return x * scale + bias
    return (x + bias) * scale


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):  # noqa: A002
    if isinstance(scale, Tensor):
        scale = scale.item()  # noqa: A001
    out = apply_op(_scale, x, scale=float(scale), bias=float(bias),
                   bias_after_scale=bool(bias_after_scale))
    if act is not None:
        from ..nn import functional as F

        out = getattr(F, act)(out)
    return out


def _neg(x):
    return -x


def neg(x, name=None):
    return apply_op(_neg, x)


def abs(x, name=None):  # noqa: A001
    return apply_op(torch.abs, x)
