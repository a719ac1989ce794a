"""Math ops (``paddle_tpu/tensor/math.py``): elementwise arithmetic with
broadcasting (``floor_divide`` and ``remainder`` round toward minus
infinity, as Python's ``//`` and ``%``), the unary functions,
``matmul`` (and ``mm``, ``bmm``) with Paddle's ``transpose_x`` /
``transpose_y``, cast to the AMP dtype under ``amp.auto_cast``, and the
reductions.

Where torch's defaults differ from the reference's, these follow the
reference: ``std`` and ``var`` are unbiased unless told otherwise;
``median`` of an even count is the mean of the two middle values
(``jnp.median``), where ``torch.median`` takes the lower; ``max`` /
``min`` split the gradient evenly between ties (``amax``); ``dot`` of
2-D operands is their matrix product (``jnp.dot``); ``outer`` flattens
its operands. ``max``, ``min``, ``all``, ``any``, ``round``, ``sum``,
``pow`` and ``abs`` are this module's globals: its own helpers reach
Python's through ``builtins``."""
from __future__ import annotations

import builtins

import torch

from ..framework import dtype as dtypes
from ..framework.core import Tensor, _as_torch, apply_op, inplace_apply, records

__all__ = [
    "add", "subtract", "multiply", "divide", "floor_divide", "remainder",
    "mod", "pow", "matmul", "mm", "bmm", "dot", "inner", "outer", "addmm",
    "maximum", "minimum", "fmax", "fmin", "exp", "expm1", "log", "log2",
    "log10", "log1p", "sqrt", "rsqrt", "square", "abs", "sign", "floor",
    "ceil", "round", "trunc", "sin", "cos", "tan", "asin", "acos", "atan",
    "atan2", "sinh", "cosh", "tanh", "asinh", "acosh", "atanh", "reciprocal",
    "sigmoid", "clip", "sum", "mean", "max", "min", "amax", "amin", "prod",
    "cumsum", "cumprod", "logsumexp", "logcumsumexp", "std", "var", "median",
    "kron", "isnan", "isinf", "isfinite", "nan_to_num", "erf", "erfinv",
    "lgamma", "digamma", "neg", "increment", "scale", "stanh", "multiplex",
    "all", "any", "deg2rad", "rad2deg", "angle", "conj", "real", "imag",
    "trace", "diff", "heaviside", "frac", "count_nonzero", "nansum",
    "nanmean", "gcd", "lcm", "lerp", "rot90", "add_n", "diagonal",
    "floor_mod", "tanh_",
]


def _operand(v, like):
    """A numpy array beside a Tensor becomes a torch tensor on the
    Tensor's device; Python scalars stay scalars."""
    if isinstance(v, (Tensor, int, float, bool)):
        return v
    dev = like._data.device if isinstance(like, Tensor) else None
    return _as_torch(v, device=dev)


def _tensor(v, like=None):
    """As :func:`_operand`, but a Python scalar too becomes a tensor (on
    ``like``'s device, else the current one)."""
    v = _operand(v, like)
    if isinstance(v, (Tensor, torch.Tensor)):
        return v
    dev = like._data.device if isinstance(like, Tensor) else None
    return _as_torch(v, device=dev)


def _binary(fn, name=None):
    label = name or fn.__name__

    def op(x, y, name=None):
        return apply_op(fn, _operand(x, y), _operand(y, x), op_name=label)

    op.__name__ = op.__qualname__ = label
    return op


def _binary_tensors(fn, name):
    """A binary op whose torch function takes tensors only: a scalar
    operand becomes a 0-d tensor of the other's dtype class."""
    def both(x, y):
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(x, device=y.device)
        if not isinstance(y, torch.Tensor):
            y = torch.as_tensor(y, device=x.device)
        return fn(x, y)

    label = name

    def op(x, y, name=None):
        return apply_op(both, _operand(x, y), _operand(y, x), op_name=label)

    op.__name__ = op.__qualname__ = label
    return op


def _unary(fn, name):
    label = name

    def op(x, name=None):
        return apply_op(fn, _tensor(x), op_name=label)

    op.__name__ = op.__qualname__ = label
    return op


add = _binary(torch.add)
subtract = _binary(torch.sub, "subtract")
multiply = _binary(torch.mul, "multiply")
divide = _binary(torch.true_divide, "divide")
floor_divide = _binary(torch.floor_divide)
remainder = _binary(torch.remainder)
mod = floor_mod = remainder
pow = _binary(torch.pow)  # noqa: A001
maximum = _binary_tensors(torch.maximum, "maximum")
minimum = _binary_tensors(torch.minimum, "minimum")
fmax = _binary_tensors(torch.fmax, "fmax")
fmin = _binary_tensors(torch.fmin, "fmin")
atan2 = _binary_tensors(torch.atan2, "atan2")
kron = _binary_tensors(torch.kron, "kron")
gcd = _binary_tensors(torch.gcd, "gcd")
lcm = _binary_tensors(torch.lcm, "lcm")
inner = _binary_tensors(torch.inner, "inner")


def _heaviside(x, y):
    return torch.heaviside(x, y.to(x.dtype))


heaviside = _binary_tensors(_heaviside, "heaviside")


def _outer(x, y):
    return torch.outer(x.reshape(-1), y.reshape(-1))


outer = _binary_tensors(_outer, "outer")


def _dot(x, y):
    if x.dim() <= 2 and y.dim() <= 2:
        return torch.matmul(x, y)
    return torch.tensordot(x, y, dims=([-1], [-2 if y.dim() > 1 else -1]))


dot = _binary_tensors(_dot, "dot")


def _frac(x):
    return x - torch.trunc(x)


def _reciprocal(x):
    return 1.0 / x


def _float_of_int(fn):
    """jnp's float functions take ints and return the default float."""
    def f(x):
        if not (x.is_floating_point() or x.is_complex()):
            x = x.to(dtypes.default_float_dtype())
        return fn(x)

    return f


def _real(x):
    return torch.real(x) if x.is_complex() else x.clone()


def _imag(x):
    return torch.imag(x) if x.is_complex() else torch.zeros_like(x)


def _conj(x):
    return torch.conj_physical(x) if x.is_complex() else x.clone()


exp = _unary(_float_of_int(torch.exp), "exp")
expm1 = _unary(_float_of_int(torch.expm1), "expm1")
log = _unary(_float_of_int(torch.log), "log")
log2 = _unary(_float_of_int(torch.log2), "log2")
log10 = _unary(_float_of_int(torch.log10), "log10")
log1p = _unary(_float_of_int(torch.log1p), "log1p")
sqrt = _unary(_float_of_int(torch.sqrt), "sqrt")
rsqrt = _unary(_float_of_int(torch.rsqrt), "rsqrt")
square = _unary(torch.square, "square")
sign = _unary(torch.sign, "sign")
floor = _unary(torch.floor, "floor")
ceil = _unary(torch.ceil, "ceil")
round = _unary(torch.round, "round")  # noqa: A001
trunc = _unary(torch.trunc, "trunc")
sin = _unary(_float_of_int(torch.sin), "sin")
cos = _unary(_float_of_int(torch.cos), "cos")
tan = _unary(_float_of_int(torch.tan), "tan")
asin = _unary(_float_of_int(torch.asin), "asin")
acos = _unary(_float_of_int(torch.acos), "acos")
atan = _unary(_float_of_int(torch.atan), "atan")
sinh = _unary(_float_of_int(torch.sinh), "sinh")
cosh = _unary(_float_of_int(torch.cosh), "cosh")
tanh = _unary(_float_of_int(torch.tanh), "tanh")
asinh = _unary(_float_of_int(torch.asinh), "asinh")
acosh = _unary(_float_of_int(torch.acosh), "acosh")
atanh = _unary(_float_of_int(torch.atanh), "atanh")
abs = _unary(torch.abs, "abs")  # noqa: A001
neg = _unary(torch.neg, "neg")
erf = _unary(_float_of_int(torch.special.erf), "erf")
erfinv = _unary(_float_of_int(torch.special.erfinv), "erfinv")
lgamma = _unary(_float_of_int(torch.special.gammaln), "lgamma")
digamma = _unary(_float_of_int(torch.special.digamma), "digamma")
isnan = _unary(torch.isnan, "isnan")
isinf = _unary(torch.isinf, "isinf")
isfinite = _unary(torch.isfinite, "isfinite")
deg2rad = _unary(_float_of_int(torch.deg2rad), "deg2rad")
rad2deg = _unary(_float_of_int(torch.rad2deg), "rad2deg")
angle = _unary(_float_of_int(torch.angle), "angle")
conj = _unary(_conj, "conj")
real = _unary(_real, "real")
imag = _unary(_imag, "imag")
frac = _unary(_frac, "frac")
reciprocal = _unary(_reciprocal, "reciprocal")
sigmoid = _unary(_float_of_int(torch.sigmoid), "sigmoid")


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


def _addmm(input, x, y, beta=1.0, alpha=1.0):  # noqa: A002
    return beta * input + alpha * torch.matmul(x, y)


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):  # noqa: A002
    return apply_op(_addmm, input, x, y, beta=float(beta), alpha=float(alpha))


def clip(x, min=None, max=None, name=None):  # noqa: A002
    if isinstance(min, Tensor):
        min = min.item()  # noqa: A001
    if isinstance(max, Tensor):
        max = max.item()  # noqa: A001
    return apply_op(torch.clamp, x, min=min, max=max)


def _axis(axis):
    if axis is None:
        return None
    if isinstance(axis, Tensor):
        axis = axis.tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def _dims(x, axis):
    """Every axis of ``x`` for None, else the axes as a sorted tuple of
    non-negative ints."""
    if axis is None:
        return tuple(range(x.dim()))
    axis = axis if isinstance(axis, tuple) else (axis,)
    return tuple(sorted(a % builtins.max(x.dim(), 1) for a in axis))


def _keep_all(out, x, axis, keepdim):
    """A whole-tensor reduction with keepdim: shape [1] * ndim."""
    if keepdim and axis is None:
        return out.reshape([1] * x.dim())
    return out


def _reduce_each(fn, x, axis, keepdim):
    """A reduction whose torch function takes one dim: applied axis by
    axis, highest first."""
    if axis is None:
        return _keep_all(fn(x.reshape(-1), 0, False), x, axis, keepdim)
    for a in reversed(_dims(x, axis)):
        x = fn(x, a, keepdim)
    return x


def _sum(x, axis=None, keepdim=False, dtype=None):
    if axis is None:
        return _keep_all(torch.sum(x, dtype=dtype), x, axis, keepdim)
    return torch.sum(x, dim=axis, keepdim=keepdim, dtype=dtype)


def sum(x, axis=None, dtype=None, keepdim=False, name=None):  # noqa: A001
    return apply_op(_sum, x, axis=_axis(axis), keepdim=bool(keepdim),
                    dtype=dtypes.convert_dtype(dtype))


def _nansum(x, axis=None, keepdim=False):
    if axis is None:
        return _keep_all(torch.nansum(x), x, axis, keepdim)
    return torch.nansum(x, dim=axis, keepdim=keepdim)


def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    return apply_op(_nansum, x, axis=_axis(axis), keepdim=bool(keepdim))


def _nanmean(x, axis=None, keepdim=False):
    if axis is None:
        return _keep_all(torch.nanmean(x), x, axis, keepdim)
    return torch.nanmean(x, dim=axis, keepdim=keepdim)


def nanmean(x, axis=None, keepdim=False, name=None):
    return apply_op(_nanmean, x, axis=_axis(axis), keepdim=bool(keepdim))


def _mean(x, axis=None, keepdim=False):
    if not (x.is_floating_point() or x.is_complex()):
        x = x.float()     # int and bool inputs: the f32 mean, as JAX's
    if axis is None:
        return _keep_all(torch.mean(x), x, axis, keepdim)
    return torch.mean(x, dim=axis, keepdim=keepdim)


def mean(x, axis=None, keepdim=False, name=None):
    return apply_op(_mean, x, axis=_axis(axis), keepdim=bool(keepdim))


def _max(x, axis=None, keepdim=False):
    if axis is None:
        return _keep_all(torch.amax(x), x, axis, keepdim)
    return torch.amax(x, dim=axis, keepdim=keepdim)


def max(x, axis=None, keepdim=False, name=None):  # noqa: A001
    return apply_op(_max, x, axis=_axis(axis), keepdim=bool(keepdim))


def _min(x, axis=None, keepdim=False):
    if axis is None:
        return _keep_all(torch.amin(x), x, axis, keepdim)
    return torch.amin(x, dim=axis, keepdim=keepdim)


def min(x, axis=None, keepdim=False, name=None):  # noqa: A001
    return apply_op(_min, x, axis=_axis(axis), keepdim=bool(keepdim))


amax = max
amin = min


def _prod(x, axis=None, keepdim=False, dtype=None):
    if dtype is not None:
        x = x.to(dtype)
    return _reduce_each(lambda t, a, k: torch.prod(t, a, keepdim=k), x, axis,
                        keepdim)


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    return apply_op(_prod, x, axis=_axis(axis), keepdim=bool(keepdim),
                    dtype=dtypes.convert_dtype(dtype))


def _cumsum(x, axis=None, dtype=None):
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.cumsum(x, dim=axis, dtype=dtype)


def cumsum(x, axis=None, dtype=None, name=None):
    return apply_op(_cumsum, x, axis=_axis(axis),
                    dtype=dtypes.convert_dtype(dtype))


def _cumprod(x, dim=None, dtype=None):
    if dim is None:
        x, dim = x.reshape(-1), 0
    return torch.cumprod(x, dim=dim, dtype=dtype)


def cumprod(x, dim=None, dtype=None, name=None):
    return apply_op(_cumprod, x, dim=_axis(dim),
                    dtype=dtypes.convert_dtype(dtype))


def _logsumexp(x, axis=None, keepdim=False):
    if axis is None:
        return _keep_all(torch.logsumexp(x.reshape(-1), 0), x, axis,
                         keepdim)
    return torch.logsumexp(x, dim=axis, keepdim=keepdim)


def logsumexp(x, axis=None, keepdim=False, name=None):
    return apply_op(_logsumexp, x, axis=_axis(axis), keepdim=bool(keepdim))


def _logcumsumexp(x, axis=None):
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.logcumsumexp(x, dim=axis)


def logcumsumexp(x, axis=None, name=None):
    return apply_op(_logcumsumexp, x, axis=_axis(axis))


def _std(x, axis=None, unbiased=True, keepdim=False):
    out = torch.std(x, dim=axis, correction=1 if unbiased else 0,
                    keepdim=keepdim)
    return _keep_all(out, x, axis, keepdim)


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return apply_op(_std, x, axis=_axis(axis), unbiased=bool(unbiased),
                    keepdim=bool(keepdim))


def _var(x, axis=None, unbiased=True, keepdim=False):
    out = torch.var(x, dim=axis, correction=1 if unbiased else 0,
                    keepdim=keepdim)
    return _keep_all(out, x, axis, keepdim)


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return apply_op(_var, x, axis=_axis(axis), unbiased=bool(unbiased),
                    keepdim=bool(keepdim))


def _median(x, axis=None, keepdim=False):
    """``jnp.median``: the middle of the sorted values, or the mean of the
    two middle ones for an even count (over the flattened tensor for
    ``axis=None``, else over the axes moved last and joined)."""
    if not x.is_floating_point():
        x = x.to(dtypes.default_float_dtype())
    dims = _dims(x, axis)
    rest = [d for d in range(x.dim()) if d not in dims]
    flat = x.permute(*rest, *dims).reshape(
        [x.shape[d] for d in rest] + [-1])
    s = torch.sort(flat, dim=-1).values
    n = s.shape[-1]
    if n % 2:
        out = s[..., n // 2]
    else:
        out = (s[..., n // 2 - 1] + s[..., n // 2]) / 2
    if keepdim:
        shape = [1 if d in dims else x.shape[d] for d in range(x.dim())]
        out = out.reshape(shape)
    return out


def median(x, axis=None, keepdim=False, name=None):
    return apply_op(_median, x, axis=_axis(axis), keepdim=bool(keepdim))


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return apply_op(torch.nan_to_num, x, nan=float(nan), posinf=posinf,
                    neginf=neginf)


def increment(x, value=1.0, name=None):
    """``x + value`` written back into ``x`` (the Tensor is rebound; its
    graph, if any, is kept)."""
    if x._symbolic:
        return inplace_apply(x, lambda t: t + value)
    x._data = x._data + value
    return x


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


def _stanh(x, scale_a=0.67, scale_b=1.7159):
    return scale_b * torch.tanh(scale_a * x)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return apply_op(_stanh, x, scale_a=float(scale_a), scale_b=float(scale_b))


def _multiplex(*args):
    index, cands = args[-1].reshape(-1).long(), torch.stack(args[:-1])
    return cands[index, torch.arange(index.shape[0], device=index.device)]


def multiplex(inputs, index, name=None):
    """Row i of the output is row i of ``inputs[index[i]]``."""
    return apply_op(_multiplex, *inputs, _tensor(index, inputs[0]))


def _bool_reduce(fn):
    def f(x, axis=None, keepdim=False):
        return _reduce_each(lambda t, a, k: fn(t, dim=a, keepdim=k),
                            x.bool(), axis, keepdim)

    return f


_all = _bool_reduce(torch.all)
_any = _bool_reduce(torch.any)


def all(x, axis=None, keepdim=False, name=None):  # noqa: A001
    return apply_op(_all, x, axis=_axis(axis), keepdim=bool(keepdim))


def any(x, axis=None, keepdim=False, name=None):  # noqa: A001
    return apply_op(_any, x, axis=_axis(axis), keepdim=bool(keepdim))


def _trace(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset, axis1, axis2).sum(-1)


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return apply_op(_trace, x, offset=int(offset), axis1=int(axis1),
                    axis2=int(axis2))


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    if prepend is not None or append is not None:
        from .manipulation import concat

        parts = ([prepend] if prepend is not None else []) + [x] \
            + ([append] if append is not None else [])
        x = concat([_tensor(p, x) if not isinstance(p, Tensor) else p
                    for p in parts], axis=axis)
    return apply_op(torch.diff, x, n=int(n), dim=int(axis))


def _count_nonzero(x, axis=None, keepdim=False):
    out = torch.count_nonzero(x, dim=axis)
    if keepdim:
        shape = [1 if d in _dims(x, axis) else s
                 for d, s in enumerate(x.shape)]
        out = out.reshape(shape)
    return out


def count_nonzero(x, axis=None, keepdim=False, name=None):
    return apply_op(_count_nonzero, x, axis=_axis(axis),
                    keepdim=bool(keepdim))


def _lerp(x, y, weight):
    return x + weight * (y - x)


@records
def lerp(x, y, weight, name=None):
    if not isinstance(weight, Tensor):
        like = x if isinstance(x, Tensor) else y
        weight = Tensor(torch.as_tensor(weight, dtype=like.dtype,
                                        device=like._data.device))
    return apply_op(_lerp, _tensor(x, y), _tensor(y, x), weight)


def rot90(x, k=1, axes=(0, 1), name=None):
    return apply_op(torch.rot90, x, k=int(k),
                    dims=tuple(int(a) for a in axes))


def _add_n(*xs):
    out = xs[0]
    for a in xs[1:]:
        out = out + a
    return out


def add_n(inputs, name=None):
    """The elementwise sum of a list of tensors; one tensor gives a fresh
    Tensor, never an alias of the input."""
    if isinstance(inputs, Tensor):
        inputs = [inputs]
    if not inputs:
        raise ValueError("add_n expects at least one input tensor")
    return apply_op(lambda *xs: _add_n(*xs) + 0, *inputs)


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return apply_op(torch.diagonal, _tensor(x), offset=int(offset),
                    dim1=int(axis1), dim2=int(axis2))


def tanh_(x, name=None):
    return inplace_apply(x, tanh)
