"""Max, average and adaptive pooling (``paddle_tpu/nn/functional/
pooling.py``), NC* layouts.

The JAX package pools with ``lax.reduce_window`` over explicitly padded
windows, and these follow its edge rules rather than PyTorch's:

- ``ceil_mode`` pads the high edge of each axis by ``stride - 1`` more,
  so a window that starts in that padding still counts (PyTorch's
  ``ceil_mode`` drops it); the pads go through ``F.pad`` and the pool
  itself runs unpadded;
- max pooling pads with -inf;
- average pooling sums each window and, where there is padding and
  ``exclusive`` (Paddle's default), divides by the count of real
  elements in it, else by the window's size;
- ``"SAME"`` pads as XLA does (``conv.same_pads``);
- adaptive windows run from floor(i·in / out) to ceil((i+1)·in / out)
  (:func:`_adaptive_starts_ends`); an average over windows of unequal
  sizes sums each joint window and divides once.

``return_mask`` and ``max_unpool2d`` are not ported yet.
"""
from __future__ import annotations

import itertools
import math

import numpy as np
import torch
import torch.nn.functional as TF

from ...framework.core import apply_op
from .conv import _ntuple, same_pads

__all__ = [
    "max_pool1d", "max_pool2d", "max_pool3d", "avg_pool1d", "avg_pool2d",
    "avg_pool3d", "adaptive_max_pool1d", "adaptive_max_pool2d",
    "adaptive_max_pool3d", "adaptive_avg_pool1d", "adaptive_avg_pool2d",
    "adaptive_avg_pool3d",
]

_MAX = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}
_AVG = {2: TF.avg_pool2d, 3: TF.avg_pool3d}


def _pool_pads(padding, n):
    if isinstance(padding, str):
        kind = padding.upper()
        if kind not in ("SAME", "VALID"):
            raise ValueError(f"bad pool padding {padding!r}")
        return kind
    if isinstance(padding, (int, np.integer)):
        return ((int(padding), int(padding)),) * n
    padding = list(padding)
    if len(padding) == n:
        return tuple((int(p), int(p)) for p in padding)
    if len(padding) == 2 * n:
        return tuple((int(padding[2 * i]), int(padding[2 * i + 1]))
                     for i in range(n))
    raise ValueError(f"bad pool padding {padding}")


def _window_pads(x, ksize, strides, pads, ceil_mode):
    """The explicit (lo, hi) pads of each spatial axis and whether the
    windows reach past the input."""
    if pads == "VALID":
        return ((0, 0),) * len(ksize), False
    if pads == "SAME":
        pads = same_pads(x.shape[2:], ksize, strides)
        return pads, any(lo or hi for lo, hi in pads)
    pads = tuple((lo, hi + (s - 1 if ceil_mode else 0))
                 for (lo, hi), s in zip(pads, strides))
    return pads, any(lo or hi for lo, hi in pads)


def _pad(x, pads, value):
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    return TF.pad(x, flat, value=value) if any(flat) else x


def _max_pool(x, ksize, strides, pads, ceil_mode):
    pads, _ = _window_pads(x, ksize, strides, pads, ceil_mode)
    low = (-math.inf if x.is_floating_point()
           else torch.iinfo(x.dtype).min)
    return _MAX[len(ksize)](_pad(x, pads, low), ksize, strides)


def _window_sum(x, ksize, strides):
    return _AVG[len(ksize)](x, ksize, strides, divisor_override=1)


def _avg_pool(x, ksize, strides, pads, ceil_mode, exclusive,
              divisor=None):
    pads, padded = _window_pads(x, ksize, strides, pads, ceil_mode)
    s = _window_sum(_pad(x, pads, 0.0), ksize, strides)
    if divisor is not None:
        return s / divisor
    if padded and exclusive:
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                          device=x.device)
        return s / _window_sum(_pad(ones, pads, 0.0), ksize, strides)
    return s / float(np.prod(ksize))


def _stride(stride, kernel_size, n):
    return _ntuple(stride if stride is not None else kernel_size, n)


def _no_mask(return_mask):
    if return_mask:
        raise NotImplementedError("pooling with return_mask=True is not "
                                  "ported to paddle_tpu_torch yet")


def _channels_first(data_format, n):
    if data_format not in ("NCL", "NCHW", "NCDHW"):
        raise NotImplementedError(f"{n}-d pooling takes channels-first "
                                  f"input; data_format={data_format!r} is "
                                  f"not ported")


def _as_2d(x, pool=None, **kw):
    return pool(x.unsqueeze(2), **kw).squeeze(2)


def _pool1d(pool, x, kernel_size, stride, padding, ceil_mode, **kw):
    """A 1-d pool as the 2-d one over a unit H axis, as the reference
    runs it."""
    k = (1,) + _ntuple(kernel_size, 1)
    s = (1,) + _stride(stride, kernel_size, 1)
    p = (padding.upper() if isinstance(padding, str)
         else ((0, 0),) + _pool_pads(padding, 1))
    return apply_op(_as_2d, x, pool=pool, ksize=k, strides=s, pads=p,
                    ceil_mode=bool(ceil_mode), **kw)


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, name=None):
    _no_mask(return_mask)
    return _pool1d(_max_pool, x, kernel_size, stride, padding, ceil_mode)


def _max_poolnd(x, kernel_size, stride, padding, ceil_mode, return_mask,
                data_format, n):
    _no_mask(return_mask)
    _channels_first(data_format, n)
    return apply_op(_max_pool, x, ksize=_ntuple(kernel_size, n),
                    strides=_stride(stride, kernel_size, n),
                    pads=_pool_pads(padding, n), ceil_mode=bool(ceil_mode))


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW", name=None):
    return _max_poolnd(x, kernel_size, stride, padding, ceil_mode,
                       return_mask, data_format, 2)


def max_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCDHW", name=None):
    return _max_poolnd(x, kernel_size, stride, padding, ceil_mode,
                       return_mask, data_format, 3)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, name=None):
    return _pool1d(_avg_pool, x, kernel_size, stride, padding, ceil_mode,
                   exclusive=bool(exclusive))


def _avg_poolnd(x, kernel_size, stride, padding, ceil_mode, exclusive,
                divisor_override, data_format, n):
    _channels_first(data_format, n)
    if divisor_override:
        # the reference's divisor path pads as given, without ceil_mode's
        # extra
        ceil_mode, divisor = False, float(divisor_override)
    else:
        divisor = None
    return apply_op(_avg_pool, x, ksize=_ntuple(kernel_size, n),
                    strides=_stride(stride, kernel_size, n),
                    pads=_pool_pads(padding, n), ceil_mode=bool(ceil_mode),
                    exclusive=bool(exclusive), divisor=divisor)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _avg_poolnd(x, kernel_size, stride, padding, ceil_mode,
                       exclusive, divisor_override, data_format, 2)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _avg_poolnd(x, kernel_size, stride, padding, ceil_mode,
                       exclusive, divisor_override, data_format, 3)


def _adaptive_starts_ends(in_size, out_size):
    starts = [(i * in_size) // out_size for i in range(out_size)]
    ends = [-(-((i + 1) * in_size) // out_size) for i in range(out_size)]
    return starts, ends


def _adaptive_pool(x, out_sizes, op):
    n = len(out_sizes)
    spatial = tuple(x.shape[2:])
    if op == "avg" and any(i != o and i % o for i, o in zip(spatial,
                                                            out_sizes)):
        # windows of unequal sizes: sum each joint window, divide once
        windows = [_adaptive_starts_ends(i, o)
                   for i, o in zip(spatial, out_sizes)]
        cells = []
        for idx in itertools.product(*[range(o) for o in out_sizes]):
            lo = [windows[d][0][idx[d]] for d in range(n)]
            hi = [windows[d][1][idx[d]] for d in range(n)]
            seg = x[(slice(None), slice(None))
                    + tuple(slice(a, b) for a, b in zip(lo, hi))]
            cells.append(seg.sum(dim=tuple(range(2, 2 + n)))
                         / math.prod(b - a for a, b in zip(lo, hi)))
        return torch.stack(cells, dim=-1).reshape(
            tuple(x.shape[:2]) + tuple(out_sizes))
    out = x
    for d, (i, o) in enumerate(zip(spatial, out_sizes)):
        if i == o:
            continue
        ax = 2 + d
        if i % o == 0:                 # windows of one size
            r = out.reshape(out.shape[:ax] + (o, i // o) + out.shape[ax + 1:])
            out = (r.amax(dim=ax + 1) if op == "max"
                   else r.mean(dim=ax + 1))
        else:
            starts, ends = _adaptive_starts_ends(i, o)
            out = torch.cat([out.narrow(ax, a, b - a).amax(dim=ax,
                                                           keepdim=True)
                             for a, b in zip(starts, ends)], dim=ax)
    return out


def _out_sizes(x, output_size, n):
    o = ((output_size,) * n if isinstance(output_size, (int, np.integer))
         or output_size is None else tuple(output_size))
    return tuple(int(x.shape[2 + i]) if v is None else int(v)
                 for i, v in enumerate(o))


def _adaptive(x, output_size, n, op, return_mask=False):
    _no_mask(return_mask)
    return apply_op(_adaptive_pool, x, out_sizes=_out_sizes(x, output_size,
                                                            n), op=op)


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive(x, output_size, 1, "avg")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    _channels_first(data_format, 2)
    return _adaptive(x, output_size, 2, "avg")


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    _channels_first(data_format, 3)
    return _adaptive(x, output_size, 3, "avg")


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 1, "max", return_mask)


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 2, "max", return_mask)


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 3, "max", return_mask)
