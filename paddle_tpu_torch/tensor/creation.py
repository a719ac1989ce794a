"""Tensor creation ops (``paddle_tpu/tensor/creation.py``). New tensors
go to the current device (``paddle_tpu_torch.device``); a ``*_like`` op
and the ops on a tensor keep that tensor's device. ``empty`` and
``empty_like`` are zero-filled, as the reference's are. ``numel`` is
an int64 count and ``one_hot`` the default float dtype."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as TF

from ..device import current_device
from ..framework import dtype as dtypes
from ..framework.core import Parameter, Tensor, _as_torch, apply_op, \
    records, to_tensor

__all__ = [
    "to_tensor", "zeros", "ones", "full", "zeros_like", "ones_like",
    "full_like", "empty", "empty_like", "arange", "linspace", "logspace",
    "eye", "tril", "triu", "diag", "diagflat", "meshgrid", "assign",
    "clone", "numel", "one_hot", "complex", "create_parameter",
    "check_shape",
]


def _dt(dtype, default=None):
    d = dtypes.convert_dtype(dtype)
    return d if d is not None else (default or dtypes.default_float_dtype())


def _shape(shape):
    if isinstance(shape, Tensor):
        shape = shape.tolist()
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s) for s in shape)


def _scalar(v):
    return v.item() if isinstance(v, Tensor) else v


def _data(x):
    """A Tensor's torch tensor, or numpy / Python data on the current
    device."""
    return x._data if isinstance(x, Tensor) else _as_torch(x)


def full(shape, fill_value, dtype=None, name=None):
    return Tensor(torch.full(_shape(shape), _scalar(fill_value),
                             dtype=_dt(dtype), device=current_device()))


def zeros(shape, dtype=None, name=None):
    return full(shape, 0, dtype)


def ones(shape, dtype=None, name=None):
    return full(shape, 1, dtype)


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


@records
def full_like(x, fill_value, dtype=None, name=None):
    return Tensor(torch.full_like(_data(x), _scalar(fill_value),
                                  dtype=dtypes.convert_dtype(dtype)))


def zeros_like(x, dtype=None, name=None):
    return full_like(x, 0, dtype)


def ones_like(x, dtype=None, name=None):
    return full_like(x, 1, dtype)


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    start, end, step = (_scalar(v) for v in (start, end, step))
    if end is None:
        start, end = 0, start
    if dtype is None:
        dtype = ("int64" if all(isinstance(v, (int, np.integer))
                                for v in (start, end, step)) else None)
    return Tensor(torch.arange(start, end, step, dtype=_dt(dtype),
                               device=current_device()))


def linspace(start, stop, num, dtype=None, name=None):
    return Tensor(torch.linspace(_scalar(start), _scalar(stop),
                                 int(_scalar(num)), dtype=_dt(dtype),
                                 device=current_device()))


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return Tensor(torch.logspace(_scalar(start), _scalar(stop),
                                 int(_scalar(num)), base=float(base),
                                 dtype=_dt(dtype), device=current_device()))


def eye(num_rows, num_columns=None, dtype=None, name=None):
    n = int(num_rows)
    m = n if num_columns is None else int(num_columns)
    return Tensor(torch.eye(n, m, dtype=_dt(dtype), device=current_device()))


def tril(x, diagonal=0, name=None):
    return apply_op(torch.tril, x, diagonal=int(diagonal))


def triu(x, diagonal=0, name=None):
    return apply_op(torch.triu, x, diagonal=int(diagonal))


def _diag(x, offset=0, padding_value=0):
    d = torch.diag(x, offset)
    if x.dim() == 1 and padding_value != 0:
        mask = torch.diag(torch.ones_like(x, dtype=torch.bool), offset)
        d = torch.where(mask, d, torch.full_like(d, padding_value))
    return d


def diag(x, offset=0, padding_value=0, name=None):
    """A 1-D x: the square matrix with x on diagonal ``offset`` (the rest
    ``padding_value``); a 2-D x: its diagonal ``offset``."""
    return apply_op(_diag, x, offset=int(offset), padding_value=padding_value)


def diagflat(x, offset=0, name=None):
    return apply_op(torch.diagflat, x, offset=int(offset))


def _meshgrid(*xs):
    return tuple(torch.meshgrid(*xs, indexing="ij"))


def meshgrid(*args, **kwargs):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = args[0]
    return list(apply_op(_meshgrid, *args))


def assign(x, output=None):
    """A copy of ``x`` (a Tensor, keeping its graph, or numpy / Python
    data); with ``output``, written into that Tensor."""
    if output is not None:
        output.set_value(_data(x))
        return output
    return apply_op(torch.clone, x if isinstance(x, Tensor)
                    else Tensor(_data(x)))


def clone(x, name=None):
    return apply_op(torch.clone, x)


@records
def numel(x, name=None):
    n = x.size if isinstance(x, Tensor) else int(np.size(x))
    dev = x._data.device if isinstance(x, Tensor) else current_device()
    return Tensor(torch.tensor(n, dtype=torch.int64, device=dev))


def _one_hot(x, num_classes, dtype):
    return TF.one_hot(x.long(), num_classes).to(dtype)


def one_hot(x, num_classes, name=None):
    return apply_op(_one_hot, x, num_classes=int(num_classes),
                    dtype=dtypes.default_float_dtype())


def complex(real, imag, name=None):  # noqa: A001
    return apply_op(torch.complex, real, imag)


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """A learnable Parameter: Xavier-uniform by default, zeros for a
    bias, or the attr's / the given initializer."""
    from ..framework.param_attr import ParamAttr
    from ..nn import initializer as I

    init = default_initializer
    trainable = True
    attr = ParamAttr._to_attr(attr)
    if getattr(attr, "weight_norm_dim", None) is not None:
        raise NotImplementedError(
            "WeightNormParamAttr: apply nn.utils.weight_norm(layer) "
            "instead — the reparameterization is a layer hook here")
    if isinstance(attr, ParamAttr):
        if attr.initializer is not None:
            init = attr.initializer
        trainable = attr.trainable
        if name is None:
            name = attr.name
    if init is None:
        init = I.Constant(0.0) if is_bias else I.XavierUniform()
    data = init(tuple(int(s) for s in shape), _dt(dtype), current_device())
    return Parameter(data, name=name, trainable=trainable)


def check_shape(shape, op_name="create"):
    """Refuse a shape that is not a list / tuple / Tensor of ints ≥ -1."""
    if isinstance(shape, Tensor):
        return
    if not isinstance(shape, (list, tuple)):
        raise TypeError("%s: shape must be a list/tuple/Tensor, got %r"
                        % (op_name, type(shape)))
    for s in shape:
        if not isinstance(s, (int, np.integer, Tensor)):
            raise TypeError("%s: shape entries must be int or Tensor"
                            % op_name)
        if isinstance(s, (int, np.integer)) and s < -1:
            raise ValueError("%s: shape entries must be >= -1" % op_name)
