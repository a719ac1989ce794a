"""Shape and indexing ops (``paddle_tpu/tensor/manipulation.py``), with
Paddle's conventions: ``reshape`` takes 0 for "keep this dimension",
``split`` a section count or a list of sizes (one may be -1),
``flatten`` folds the axes from ``start_axis`` to ``stop_axis`` into
one (a 0-d tensor becomes shape [1]), ``expand`` takes -1 for "keep",
``scatter`` overwrites rows (or, with ``overwrite=False``, zeroes the
indexed rows and sums every update into them), ``pad`` takes one pair
per dimension or the trailing spatial pairs of a layout, last spatial
dimension first.

Everything runs on the tensor's device, ``unique`` and
``unique_consecutive`` too (the reference goes through numpy):
``unique``'s ``return_index`` is each value's first position, taken
with a scatter-min over the inverse. ``strided_slice`` takes negative
strides (an index gather). The in-place forms rebind the Tensor
(``framework.core.inplace_apply``). ``slice`` is this module's global:
its helpers reach Python's through ``builtins``."""
from __future__ import annotations

import builtins

import numpy as np
import torch
import torch.nn.functional as TF

from ..framework import dtype as dtypes
from ..framework.core import Tensor, _as_torch, apply_op, inplace_apply, records

__all__ = [
    "reshape", "transpose", "concat", "stack", "split", "chunk", "squeeze",
    "unsqueeze", "flatten", "flip", "roll", "tile", "expand", "expand_as",
    "broadcast_to", "broadcast_tensors", "gather", "gather_nd", "scatter",
    "scatter_nd_add", "index_select", "masked_select", "where", "slice",
    "unbind", "unique", "unique_consecutive", "repeat_interleave",
    "take_along_axis", "put_along_axis", "moveaxis", "cast", "unstack",
    "strided_slice", "tensordot", "as_real", "as_complex", "crop", "pad",
    "index_sample", "index_add", "tolist", "split_sections", "shape",
    "rank", "reverse", "scatter_nd", "shard_index", "reshape_",
    "squeeze_", "unsqueeze_", "scatter_", "broadcast_shape",
]


def _ax(a):
    return int(a.item() if isinstance(a, Tensor) else a)


def _ints(v):
    if isinstance(v, Tensor):
        v = v.tolist()
    if isinstance(v, (int, np.integer)):
        return (int(v),)
    return tuple(_ax(s) for s in v)


def _index(v, like):
    """An index operand as a torch tensor on ``like``'s device."""
    if isinstance(v, Tensor):
        return v
    return _as_torch(v, device=like._data.device)


def _reshape(x, shape):
    shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    return x.reshape(shape)


def reshape(x, shape, name=None):
    return apply_op(_reshape, x, shape=_ints(shape))


def transpose(x, perm, name=None):
    return apply_op(torch.permute, x, dims=_ints(perm))


def _concat(*xs, axis=0):
    return torch.cat(xs, dim=axis)


def concat(x, axis=0, name=None):
    return apply_op(_concat, *x, axis=_ax(axis))


def _stack(*xs, axis=0):
    return torch.stack(xs, dim=axis)


def stack(x, axis=0, name=None):
    return apply_op(_stack, *x, axis=_ax(axis))


def _split(x, sections, axis):
    return tuple(torch.split(x, sections, dim=axis))


def split(x, num_or_sections, axis=0, name=None):
    axis = _ax(axis)
    n = x.shape[axis]
    if isinstance(num_or_sections, (int, np.integer)):
        if n % num_or_sections:
            raise ValueError(f"cannot split {n} into {num_or_sections} "
                             f"equal sections")
        sections = [n // int(num_or_sections)] * int(num_or_sections)
    else:
        sections = list(_ints(num_or_sections))
        if -1 in sections:
            sections[sections.index(-1)] = n - (builtins.sum(sections) + 1)
    return list(apply_op(_split, x, sections=sections, axis=axis))


split_sections = split


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def _squeeze(x, axis=None):
    if axis is None:
        return torch.squeeze(x)
    axis = tuple(a for a in axis if x.shape[a] == 1)
    return torch.squeeze(x, axis) if axis else x


def squeeze(x, axis=None, name=None):
    if axis is not None:
        axis = tuple(a % builtins.max(x.ndim, 1) for a in _ints(axis))
    return apply_op(_squeeze, x, axis=axis)


def _unsqueeze(x, axis):
    for a in sorted(a % (x.dim() + len(axis)) for a in axis):
        x = x.unsqueeze(a)
    return x


def unsqueeze(x, axis, name=None):
    return apply_op(_unsqueeze, x, axis=_ints(axis))


def _flatten(x, start_axis=0, stop_axis=-1):
    if x.dim() == 0:
        return x.reshape(1)
    return torch.flatten(x, start_axis % x.dim(), stop_axis % x.dim())


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    return apply_op(_flatten, x, start_axis=int(start_axis),
                    stop_axis=int(stop_axis))


def flip(x, axis, name=None):
    return apply_op(torch.flip, x, dims=_ints(axis))


def reverse(x, axis, name=None):
    """The legacy name of :func:`flip`."""
    return flip(x, axis)


def roll(x, shifts, axis=None, name=None):
    shifts = _ints(shifts) if isinstance(shifts, (list, tuple)) \
        else _ax(shifts)
    if axis is None:
        return apply_op(torch.roll, x, shifts=shifts)
    axis = _ints(axis) if isinstance(axis, (list, tuple)) else _ax(axis)
    return apply_op(torch.roll, x, shifts=shifts, dims=axis)


def tile(x, repeat_times, name=None):
    return apply_op(torch.tile, x, dims=_ints(repeat_times))


def _expand(x, shape):
    offset = len(shape) - x.dim()
    shape = tuple(x.shape[i - offset] if (s == -1 and i >= offset) else s
                  for i, s in enumerate(shape))
    return x.expand(shape)


def expand(x, shape, name=None):
    return apply_op(_expand, x, shape=_ints(shape))


def expand_as(x, y, name=None):
    return expand(x, y.shape)


def broadcast_to(x, shape, name=None):
    return expand(x, shape)


def broadcast_tensors(inputs, name=None):
    shape = torch.broadcast_shapes(*[tuple(t.shape) for t in inputs])
    return [expand(t, list(shape)) for t in inputs]


def broadcast_shape(x_shape, y_shape):
    return list(torch.broadcast_shapes(_ints(x_shape), _ints(y_shape)))


def _gather(x, index, axis=0):
    return torch.index_select(x, axis, index.reshape(-1).long())


def gather(x, index, axis=0, name=None):
    """Slices of ``x`` along ``axis`` at ``index`` (flattened)."""
    return apply_op(_gather, x, _index(index, x), axis=_ax(axis))


def index_select(x, index, axis=0, name=None):
    return apply_op(_gather, x, _index(index, x), axis=_ax(axis))


def _gather_nd(x, index):
    return x[tuple(index.long().movedim(-1, 0))]


def gather_nd(x, index, name=None):
    return apply_op(_gather_nd, x, _index(index, x))


def _scatter(x, index, updates, overwrite=True):
    index = index.long()
    if index.dim() == 2:
        index = index[:, 0]
    if overwrite:
        return x.index_put((index,), updates)
    zeroed = x.index_put((index,), torch.zeros_like(updates))
    return zeroed.index_put((index,), updates, accumulate=True)


def scatter(x, index, updates, overwrite=True, name=None):
    return apply_op(_scatter, x, _index(index, x), updates,
                    overwrite=bool(overwrite))


def scatter_(x, index, updates, overwrite=True, name=None):
    return inplace_apply(x, scatter, index, updates, overwrite=overwrite)


def _scatter_nd_add(x, index, updates):
    return x.index_put(tuple(index.long().movedim(-1, 0)), updates,
                       accumulate=True)


def scatter_nd_add(x, index, updates, name=None):
    return apply_op(_scatter_nd_add, x, _index(index, x), updates)


@records
def scatter_nd(index, updates, shape, name=None):  # noqa: A002
    """``updates`` summed into zeros of ``shape`` at ``index``."""
    zero = Tensor(torch.zeros(_ints(shape), dtype=updates.dtype,
                              device=updates._data.device))
    return scatter_nd_add(zero, index, updates)


def _index_add(x, index, value, axis):
    return x.index_add(axis, index.long(), value)


def index_add(x, index, axis, value, name=None):
    return apply_op(_index_add, x, _index(index, x), _index(value, x),
                    axis=_ax(axis))


def _index_sample(x, index):
    return torch.gather(x, 1, index.long())


def index_sample(x, index, name=None):
    return apply_op(_index_sample, x, _index(index, x))


def _masked_select(x, mask):
    return torch.masked_select(x, mask.bool())


def masked_select(x, mask, name=None):
    """The elements of ``x`` where the (broadcast) ``mask`` is true, as a
    1-D tensor (a data-dependent shape: not inside a captured step)."""
    return apply_op(_masked_select, x, _index(mask, x))


def _where(cond, x, y):
    return torch.where(cond.bool(), x, y)


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        from .search import nonzero

        return nonzero(condition, as_tuple=False)
    like = condition if isinstance(condition, Tensor) else (
        x if isinstance(x, Tensor) else y)

    def operand(v):
        # torch.where takes Python scalars as they are
        return v if isinstance(v, (Tensor, int, float)) else _index(v, like)

    return apply_op(_where, _index(condition, like), operand(x), operand(y))


def _slice_op(x, axes, starts, ends):
    idx = [builtins.slice(None)] * x.dim()
    for ax, st, en in zip(axes, starts, ends):
        idx[ax] = builtins.slice(st, en)
    return x[tuple(idx)]


def slice(x, axes, starts, ends, name=None):  # noqa: A001
    return apply_op(_slice_op, x, axes=_ints(axes), starts=_ints(starts),
                    ends=_ints(ends))


def _strided_slice(x, axes, starts, ends, strides):
    for ax, st, en, sd in zip(axes, starts, ends, strides):
        n = x.shape[ax]
        if sd > 0:
            idx = [builtins.slice(None)] * x.dim()
            idx[ax] = builtins.slice(st, en, sd)
            x = x[tuple(idx)]
        else:
            rows = range(*builtins.slice(st, en, sd).indices(n))
            x = torch.index_select(x, ax, torch.tensor(
                list(rows), dtype=torch.long, device=x.device))
    return x


def strided_slice(x, axes, starts, ends, strides, name=None):
    return apply_op(_strided_slice, x, axes=_ints(axes),
                    starts=_ints(starts), ends=_ints(ends),
                    strides=_ints(strides))


def _unbind(x, axis=0):
    return torch.unbind(x, axis)


def unbind(input, axis=0, name=None):  # noqa: A002
    return list(apply_op(_unbind, input, axis=_ax(axis)))


unstack = unbind


def _first_positions(inverse, n_unique, n):
    pos = torch.arange(n, device=inverse.device)
    first = torch.full((n_unique,), n, dtype=torch.long,
                       device=inverse.device)
    return first.scatter_reduce(0, inverse.reshape(-1), pos, "amin")


@records
def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """The sorted unique values (of the flattened tensor, or slices along
    ``axis``), with, as asked, each one's first position, the inverse
    and the counts, in ``np.unique``'s order."""
    xa = x._data.detach()
    out, inv, counts = torch.unique(xa, sorted=True, return_inverse=True,
                                    return_counts=True, dim=axis)
    idt = dtypes.convert_dtype(dtype)
    res = [Tensor(out)]
    if return_index:
        n = xa.numel() if axis is None else xa.shape[axis]
        res.append(Tensor(_first_positions(inv, out.shape[
            0 if axis is None else axis], n).to(idt)))
    if return_inverse:
        res.append(Tensor(inv.to(idt)))
    if return_counts:
        res.append(Tensor(counts.to(idt)))
    return res[0] if len(res) == 1 else tuple(res)


@records
def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    """Each run of equal values once (of the flattened tensor for
    ``axis=None``), with the inverse and the run lengths as asked."""
    out, inv, counts = torch.unique_consecutive(
        x._data.detach(), return_inverse=True, return_counts=True, dim=axis)
    idt = dtypes.convert_dtype(dtype)
    res = [Tensor(out)]
    if return_inverse:
        res.append(Tensor(inv.reshape(-1).to(idt) if axis is None
                          else inv.to(idt)))
    if return_counts:
        res.append(Tensor(counts.to(idt)))
    return res[0] if len(res) == 1 else tuple(res)


def _repeat_interleave(x, repeats, axis=None):
    if isinstance(repeats, torch.Tensor):
        repeats = repeats.long()
    return torch.repeat_interleave(x, repeats, dim=axis)


def repeat_interleave(x, repeats, axis=None, name=None):
    if isinstance(repeats, Tensor):
        return apply_op(_repeat_interleave, x, repeats,
                        axis=None if axis is None else _ax(axis))
    return apply_op(_repeat_interleave, x, repeats=int(repeats),
                    axis=None if axis is None else _ax(axis))


def _take_along_axis(x, indices, axis):
    return torch.take_along_dim(x, indices.long(), dim=axis)


def take_along_axis(arr, indices, axis, name=None):
    return apply_op(_take_along_axis, arr, _index(indices, arr),
                    axis=_ax(axis))


def _put_along_axis(x, indices, values, axis, reduce="assign"):  # noqa: A002
    indices = indices.long()
    values = values.to(x.dtype).expand(indices.shape)
    if reduce == "assign":
        return x.scatter(axis, indices, values)
    if reduce == "add":
        return x.scatter_add(axis, indices, values)
    if reduce in ("multiply", "mul"):
        return x.scatter_reduce(axis, indices, values, "prod")
    raise ValueError(f"unknown reduce {reduce}")


@records
def put_along_axis(arr, indices, values, axis, reduce="assign", name=None):
    if not isinstance(values, Tensor):
        values = Tensor(torch.as_tensor(values, dtype=arr.dtype,
                                        device=arr._data.device))
    return apply_op(_put_along_axis, arr, _index(indices, arr), values,
                    axis=_ax(axis), reduce=reduce)


def moveaxis(x, source, destination, name=None):
    if isinstance(source, (list, tuple)):
        source, destination = _ints(source), _ints(destination)
    else:
        source, destination = int(source), int(destination)
    return apply_op(torch.movedim, x, source=source, destination=destination)


def _cast(x, dtype):
    return x.to(dtype)


def cast(x, dtype):
    return apply_op(_cast, x, dtype=dtypes.convert_dtype(dtype))


def tensordot(x, y, axes=2, name=None):
    if isinstance(axes, (list, tuple)):
        axes = [list(a) if isinstance(a, (list, tuple)) else a
                for a in axes]
    return apply_op(torch.tensordot, x, y, dims=axes)


def _as_real(x):
    return torch.stack([x.real, x.imag], dim=-1)


def as_real(x, name=None):
    return apply_op(_as_real, x)


def _as_complex(x):
    return torch.complex(x[..., 0], x[..., 1])


def as_complex(x, name=None):
    return apply_op(_as_complex, x)


def _crop(x, offsets, shape):
    return x[tuple(builtins.slice(o, o + s) for o, s in zip(offsets, shape))]


def crop(x, shape=None, offsets=None, name=None):
    offsets = (0,) * x.ndim if offsets is None else _ints(offsets)
    shape = tuple(x.shape[i] if s == -1 else s
                  for i, s in enumerate(_ints(shape)))
    return apply_op(_crop, x, offsets=offsets, shape=shape)


def _pad_index(n, lo, hi, mode, device):
    """The source index of each padded position along one axis, for the
    edge (``replicate``), ``reflect`` (edge not repeated) and
    ``circular`` modes."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "replicate":
        return i.clamp(0, n - 1)
    if mode == "circular":
        return i % n
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = i.abs() % period
    return torch.where(i >= n, period - i, i)


def _pad_nd(x, pad_width, mode="constant", value=0.0):
    if mode == "constant":
        flat = [p for pair in reversed(pad_width) for p in pair]
        return TF.pad(x, flat, value=value)
    if mode not in ("replicate", "reflect", "circular"):
        raise ValueError(f"unknown pad mode {mode}")
    for d, (lo, hi) in enumerate(pad_width):
        if lo or hi:
            x = torch.index_select(x, d, _pad_index(x.shape[d], lo, hi, mode,
                                                    x.device))
    return x


def pad(x, pad, mode="constant", value=0.0, data_format=None, name=None):  # noqa: A002
    """``paddle.nn.functional.pad``: ``pad`` holds one (before, after)
    pair per dimension (2·ndim values, first dimension first), or the
    pairs of the trailing spatial dimensions of ``data_format`` (NCL,
    NCHW, NCDHW by rank, or channels-last), the last dimension first, or
    one int for every side of every spatial dimension."""
    nd = x.ndim
    if isinstance(pad, (int, np.integer)):
        # one width for every side of every spatial dimension (Paddle's
        # Pad1D/2D/3D(int); the reference raises on an int)
        pad = [int(pad)] * (2 * (nd - 2) if nd >= 3 else 2 * nd)
    pad = list(_ints(pad))
    if len(pad) == 2 * nd:
        pw = tuple((pad[2 * i], pad[2 * i + 1]) for i in range(nd))
    else:
        df = data_format or {3: "NCL", 4: "NCHW", 5: "NCDHW"}.get(nd)
        n_spatial = len(pad) // 2
        pw = [(0, 0)] * nd
        if df is None:
            spatial = list(range(nd - n_spatial, nd))
        elif df.startswith("NC"):
            spatial = list(range(2, 2 + n_spatial))
        else:
            spatial = list(range(1, 1 + n_spatial))
        for i, d in enumerate(reversed(spatial)):
            pw[d] = (pad[2 * i], pad[2 * i + 1])
        pw = tuple(pw)
    return apply_op(_pad_nd, x, pad_width=pw, mode=mode, value=float(value))


def tolist(x):
    return x.tolist()


@records
def shape(input, name=None):  # noqa: A002
    """The shape as a 1-D int32 tensor."""
    return Tensor(torch.tensor(list(input.shape), dtype=torch.int32,
                               device=input._data.device))


@records
def rank(input, name=None):  # noqa: A002
    """The number of dimensions as a 0-d int32 tensor."""
    return Tensor(torch.tensor(input.ndim, dtype=torch.int32,
                               device=input._data.device))


def _shard_index(x, shard_size, shard_id, ignore_value):
    return torch.where(torch.div(x, shard_size, rounding_mode="floor")
                       == shard_id, x % shard_size,
                       torch.full_like(x, ignore_value))


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1,
                name=None):  # noqa: A002
    """Each index relative to its shard where that is ``shard_id``,
    ``ignore_value`` elsewhere."""
    if shard_id < 0 or shard_id >= nshards:
        raise ValueError(
            "The shard_id(%d) should be in [0, %d)" % (shard_id, nshards))
    shard_size = (int(index_num) + int(nshards) - 1) // int(nshards)
    return apply_op(_shard_index, input, shard_size=shard_size,
                    shard_id=int(shard_id), ignore_value=int(ignore_value))


def reshape_(x, shape, name=None):
    return inplace_apply(x, reshape, shape)


def squeeze_(x, axis=None, name=None):
    return inplace_apply(x, squeeze, axis=axis)


def unsqueeze_(x, axis, name=None):
    return inplace_apply(x, unsqueeze, axis)
