"""Search, sort and index ops (``paddle_tpu/tensor/search.py``).

``argsort`` and ``sort`` are stable (``jnp.argsort`` is), so equal keys
keep their order; ``kthvalue`` reads the k-th of that stable order;
``mode`` is the most frequent value of each row (the smallest among
equally frequent ones) with the index of its last occurrence, as the
reference's numpy loop picks them, computed here on the tensor's device
from one sort. ``nonzero`` and ``masked_select`` have data-dependent
shapes: they read the card, so a captured step cannot hold them."""
from __future__ import annotations

import torch

from ..framework import dtype as dtypes
from ..framework.core import Tensor, apply_op, records
from .manipulation import _index
from .manipulation import index_select, masked_select, where  # noqa: F401

__all__ = [
    "argmax", "argmin", "argsort", "sort", "topk", "nonzero", "searchsorted",
    "kthvalue", "mode", "masked_select", "index_select", "where",
]


def _arg(fn):
    def f(x, axis=None, keepdim=False, dtype=torch.int64):
        if axis is None:
            out = fn(x.reshape(-1), 0)
            if keepdim:
                out = out.reshape([1] * x.dim())
        else:
            out = fn(x, axis, keepdim=keepdim)
        return out.to(dtype)

    return f


_argmax = _arg(torch.argmax)
_argmin = _arg(torch.argmin)


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return apply_op(_argmax, x, axis=None if axis is None else int(axis),
                    keepdim=bool(keepdim), dtype=dtypes.convert_dtype(dtype))


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return apply_op(_argmin, x, axis=None if axis is None else int(axis),
                    keepdim=bool(keepdim), dtype=dtypes.convert_dtype(dtype))


def _argsort(x, axis=-1, descending=False):
    return torch.sort(x, dim=axis, descending=descending, stable=True)[1]


def argsort(x, axis=-1, descending=False, name=None):
    return apply_op(_argsort, x, axis=int(axis), descending=bool(descending))


def _sort(x, axis=-1, descending=False):
    return torch.sort(x, dim=axis, descending=descending, stable=True)[0]


def sort(x, axis=-1, descending=False, name=None):
    return apply_op(_sort, x, axis=int(axis), descending=bool(descending))


def _topk(x, k, axis=-1, largest=True, sorted=True):  # noqa: A002
    return tuple(torch.topk(x, k, dim=axis, largest=largest, sorted=sorted))


def topk(x, k, axis=-1, largest=True, sorted=True, name=None):  # noqa: A002
    if isinstance(k, Tensor):
        k = int(k.item())
    return apply_op(_topk, x, k=int(k), axis=int(axis), largest=bool(largest),
                    sorted=bool(sorted))


@records
def nonzero(x, as_tuple=False):
    """The indices of the nonzero elements: an (n, ndim) int64 tensor, or
    one (n, 1) tensor a dimension with ``as_tuple``."""
    nz = torch.nonzero(x._data.detach())
    if as_tuple:
        return tuple(Tensor(nz[:, i:i + 1].contiguous())
                     for i in range(nz.shape[1]))
    return Tensor(nz)


def _searchsorted(sorted_sequence, values, right=False, out_int32=False):
    return torch.searchsorted(sorted_sequence, values, right=right,
                              out_int32=out_int32)


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    return apply_op(_searchsorted, sorted_sequence,
                    _index(values, sorted_sequence), right=bool(right),
                    out_int32=bool(out_int32))


def _kthvalue(x, k, axis=-1, keepdim=False):
    vals, idx = torch.sort(x, dim=axis, stable=True)
    vals = vals.narrow(axis, k - 1, 1)
    idx = idx.narrow(axis, k - 1, 1)
    if not keepdim:
        vals, idx = vals.squeeze(axis), idx.squeeze(axis)
    return vals, idx


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    return apply_op(_kthvalue, x, k=int(k), axis=int(axis),
                    keepdim=bool(keepdim))


def _mode(x, axis=-1, keepdim=False):
    axis %= x.dim()
    xm = x.movedim(axis, -1)
    rows = xm.reshape(-1, xm.shape[-1])
    n = rows.shape[-1]
    s = torch.sort(rows, dim=-1).values
    # each run of equal sorted values gets one id; its length is its count
    start = torch.ones_like(s, dtype=torch.bool)
    start[:, 1:] = s[:, 1:] != s[:, :-1]
    run = torch.cumsum(start.long(), dim=-1) - 1 \
        + n * torch.arange(rows.shape[0], device=x.device).unsqueeze(1)
    counts = torch.zeros(rows.numel(), dtype=torch.long, device=x.device)
    counts.scatter_add_(0, run.reshape(-1), torch.ones_like(run.reshape(-1)))
    # the first of the most frequent runs in sorted order: the smallest
    best = torch.argmax(counts[run], dim=-1, keepdim=True)
    vals = torch.gather(s, 1, best)
    pos = torch.arange(n, device=x.device).expand_as(rows)
    idx = torch.where(rows == vals, pos, -1).amax(dim=-1)
    shape = xm.shape[:-1]
    vals, idx = vals.reshape(shape), idx.reshape(shape)
    if keepdim:
        vals, idx = vals.unsqueeze(axis), idx.unsqueeze(axis)
    return vals, idx


@records
def mode(x, axis=-1, keepdim=False, name=None):
    xa = x._data.detach()
    vals, idx = _mode(xa, int(axis), bool(keepdim))
    return Tensor(vals), Tensor(idx)

