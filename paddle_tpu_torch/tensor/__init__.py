"""paddle_tpu_torch.tensor — the op namespace (creation, math,
manipulation, logic, search, linalg, random and ``einsum``), plus the Tensor
methods and arithmetic operators (as ``paddle_tpu/tensor/__init__.py``
attaches them: its ``_METHODS`` list, ``dim`` and ``rank``)."""
from __future__ import annotations

import torch

from ..framework.core import Tensor, _unwrap, apply_op
from . import (creation, linalg, logic, manipulation, math,  # noqa: F401
               random, search)
from .creation import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .random import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403

__all__ = list(dict.fromkeys(
    creation.__all__ + math.__all__ + manipulation.__all__ + logic.__all__
    + search.__all__ + linalg.__all__ + random.__all__ + ["einsum"]))


def _einsum(*ops, equation):
    return torch.einsum(equation, *ops)


def einsum(equation, *operands):
    if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
        operands = tuple(operands[0])
    return apply_op(_einsum, *operands, equation=equation)


def _index(idx):
    if isinstance(idx, tuple):
        return tuple(_unwrap(i) for i in idx)
    return _unwrap(idx)


def _getitem(x, idx):
    return x[idx]


def _tensor_getitem(self, idx):
    return apply_op(_getitem, self, idx=_index(idx))


def _setitem(x, value, idx):
    out = x.clone()
    out[idx] = value.to(x.dtype) if isinstance(value, torch.Tensor) \
        else value
    return out


def _tensor_setitem(self, idx, value):
    if self._symbolic or getattr(value, "_symbolic", False):
        # a placeholder is rebound to the recorded assignment's output
        out = apply_op(_setitem, self, value, idx=_index(idx),
                       op_name="setitem")
        self._data, self._expr = out._data, out._expr
        return
    value = _unwrap(value)
    self._data[_index(idx)] = (value.to(self.dtype)
                               if isinstance(value, torch.Tensor) else value)


def _binop(fn):
    return lambda self, other: fn(self, other)


def _rbinop(fn):
    return lambda self, other: fn(other, self)


# the reference's table: comparisons give bool Tensors, and & | ^ ~ are
# the logical ops
_DUNDERS = {
    "__add__": _binop(add), "__radd__": _rbinop(add),
    "__sub__": _binop(subtract), "__rsub__": _rbinop(subtract),
    "__mul__": _binop(multiply), "__rmul__": _rbinop(multiply),
    "__truediv__": _binop(divide), "__rtruediv__": _rbinop(divide),
    "__floordiv__": _binop(floor_divide),
    "__rfloordiv__": _rbinop(floor_divide),
    "__mod__": _binop(remainder), "__rmod__": _rbinop(remainder),
    "__pow__": _binop(pow), "__rpow__": _rbinop(pow),
    "__matmul__": _binop(matmul), "__rmatmul__": _rbinop(matmul),
    "__eq__": _binop(equal), "__ne__": _binop(not_equal),
    "__lt__": _binop(less_than), "__le__": _binop(less_equal),
    "__gt__": _binop(greater_than), "__ge__": _binop(greater_equal),
    "__and__": _binop(logical_and), "__or__": _binop(logical_or),
    "__xor__": _binop(logical_xor),
    "__neg__": neg, "__abs__": abs, "__invert__": logical_not,
    "__getitem__": _tensor_getitem, "__setitem__": _tensor_setitem,
}
for _name, _fn in _DUNDERS.items():
    setattr(Tensor, _name, _fn)
# __hash__ stays framework/core.py's identity: a Tensor is a dict key and a
# set member by identity while == compares elements, so membership tests
# on Tensors in this package go by id()

# t.sum(), t.reshape(...), ...: the reference's method list and every op
# of math, manipulation, logic and search (each takes the tensor first),
# unless Tensor defines it itself
_METHODS = [
    # linalg
    "norm", "dist", "t", "cross", "cholesky", "inv", "matrix_power",
    # creation
    "tril", "triu", "diag",
]
for _name in (math.__all__ + manipulation.__all__ + logic.__all__
              + search.__all__ + _METHODS):
    if _name != "is_tensor" and not hasattr(Tensor, _name):
        setattr(Tensor, _name, globals()[_name])
Tensor.dim = lambda self: self.ndim
Tensor.rank = lambda self: rank(self)
