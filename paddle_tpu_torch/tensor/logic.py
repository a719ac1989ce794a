"""Comparison, logical and bitwise ops (counterpart of
``paddle_tpu/tensor/logic.py``): elementwise comparisons and logical ops
give bool Tensors, the bitwise ops the operands' integer (or bool)
dtype; a Python scalar or a numpy array beside a Tensor is taken on the
Tensor's device, as the arithmetic ops take it."""
from __future__ import annotations

import torch

from ..framework.core import Tensor, apply_op, records
from .math import _operand

__all__ = ["equal", "not_equal", "less_than", "less_equal", "greater_than",
           "greater_equal", "logical_and", "logical_or", "logical_xor",
           "logical_not", "bitwise_and", "bitwise_or", "bitwise_xor",
           "bitwise_not", "equal_all", "allclose", "isclose", "is_empty",
           "is_tensor"]


def _tensor(v, like):
    """As :func:`_operand`, but a Python scalar too becomes a tensor (the
    logical ops and the closeness tests take none)."""
    v = _operand(v, like)
    if isinstance(v, (Tensor, torch.Tensor)):
        return v
    dev = like._data.device if isinstance(like, Tensor) else None
    return torch.as_tensor(v, device=dev)


def _compare(fn, swapped, name):
    """torch's comparisons take a tensor first: ``3 < x`` arrives as
    ``less_than(3, x)`` and runs as ``x > 3`` (``swapped``)."""
    def cmp(x, y):
        return fn(x, y) if isinstance(x, torch.Tensor) else swapped(y, x)

    def op(x, y, name=None):
        return apply_op(cmp, _operand(x, y), _operand(y, x))

    op.__name__ = op.__qualname__ = name
    return op


def _logical(fn, name):
    def op(x, y, name=None):
        return apply_op(fn, _tensor(x, y), _tensor(y, x))

    op.__name__ = op.__qualname__ = name
    return op


equal = _compare(torch.eq, torch.eq, "equal")
not_equal = _compare(torch.ne, torch.ne, "not_equal")
less_than = _compare(torch.lt, torch.gt, "less_than")
less_equal = _compare(torch.le, torch.ge, "less_equal")
greater_than = _compare(torch.gt, torch.lt, "greater_than")
greater_equal = _compare(torch.ge, torch.le, "greater_equal")
logical_and = _logical(torch.logical_and, "logical_and")
logical_or = _logical(torch.logical_or, "logical_or")
logical_xor = _logical(torch.logical_xor, "logical_xor")


bitwise_and = _logical(torch.bitwise_and, "bitwise_and")
bitwise_or = _logical(torch.bitwise_or, "bitwise_or")
bitwise_xor = _logical(torch.bitwise_xor, "bitwise_xor")


def logical_not(x, name=None):
    return apply_op(torch.logical_not, _tensor(x, None))


def bitwise_not(x, name=None):
    return apply_op(torch.bitwise_not, _tensor(x, None))


@records
def is_empty(x, name=None):
    """A 0-d bool tensor: whether ``x`` has no elements."""
    return Tensor(torch.tensor(x.size == 0, device=x._data.device))


def _promoted(x, y):
    dt = torch.promote_types(x.dtype, y.dtype)
    return x.to(dt), y.to(dt)


def _equal_all(x, y):
    return torch.tensor(x.shape == y.shape
                        and bool(torch.equal(*_promoted(x, y))),
                        device=x.device)


def equal_all(x, y, name=None):
    """One bool: the same shape and equal elements."""
    return apply_op(_equal_all, _tensor(x, y), _tensor(y, x))


def _isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False):
    return torch.isclose(*_promoted(x, y), rtol=rtol, atol=atol,
                         equal_nan=equal_nan)


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    """Elementwise ``|x - y| <= atol + rtol·|y|``."""
    return apply_op(_isclose, _tensor(x, y), _tensor(y, x), rtol=float(rtol),
                    atol=float(atol), equal_nan=bool(equal_nan))


def _allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False):
    return _isclose(x, y, rtol, atol, equal_nan).all()


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    """One bool: :func:`isclose` everywhere (broadcasting)."""
    return apply_op(_allclose, _tensor(x, y), _tensor(y, x), rtol=float(rtol),
                    atol=float(atol), equal_nan=bool(equal_nan))


def is_tensor(x):
    return isinstance(x, Tensor)
