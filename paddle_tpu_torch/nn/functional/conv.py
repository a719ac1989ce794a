"""``conv1d``, ``conv2d`` and ``conv3d`` and their transposes
(``paddle_tpu/nn/functional/conv.py``), NC* layouts, weight (out, in /
groups, *kernel), a transpose's (in, out / groups, *kernel).

The JAX package computes them with ``lax.conv_general_dilated`` and no
Pallas kernel; here ``aten.convolution`` (cuDNN on the card) stands in
its place. Padding takes Paddle's forms (:func:`_norm_padding`): an int,
n values, 2n values (low, high per axis), the (n + 2)-pair form, or
``"SAME"`` / ``"VALID"``; pads that differ on the two sides of an axis go
through ``F.pad`` first. The bias is added after the product, so under
``amp.auto_cast`` a bf16 product plus an f32 bias is f32, as in ``jnp``.

f32 on the card is f32: cuDNN may use TF32 for f32 convolutions by
default (``torch.backends.cudnn.allow_tf32``), which the reference's
f32 convolution does not, so the forward and both backward products run
with it off, for the call only.

The transposes (``conv*d_transpose``) run ``aten.convolution`` with
``transposed=True``, the JAX package's flipped-kernel, input-dilated
convolution. A padding (lo, hi) crops lo positions from the low end of
the full transposed output and hi from the high end, ``output_padding``
adds that many at the high end; pads that differ, or an
``output_padding`` at least the stride and the dilation, take the full
output (no padding) and crop or extend it with ``F.pad``. Two arguments
follow Paddle where the JAX package does not:

- ``output_size`` (ignored by the JAX package) sets ``output_padding``
  to the output size asked for less the size without it, which must lie
  in [0, stride); it and a nonzero ``output_padding`` exclude each
  other;
- ``"SAME"`` pads as Paddle's ``conv2d_transpose`` does: a total of
  max((ceil(in / stride) − 1)·stride + k_eff − in, 0), the smaller half
  at the low end (the JAX package pads both ends by min(k_eff − 1,
  k_eff // 2)).

A channels-last ``data_format`` raises ``NotImplementedError``: the JAX
package has no channels-last path either.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch
import torch.nn.functional as TF

from ...framework.core import apply_op

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose"]


def _ntuple(v, n):
    if isinstance(v, (int, np.integer)):
        return (int(v),) * n
    return tuple(int(x) for x in v)


def _norm_padding(padding, n):
    """("EXPLICIT", ((lo, hi), ...)) or ("SAME" / "VALID", None)."""
    if isinstance(padding, str):
        kind = padding.upper()
        if kind not in ("SAME", "VALID"):
            raise ValueError(f"bad padding {padding!r}")
        return kind, None
    if isinstance(padding, (int, np.integer)):
        return "EXPLICIT", ((int(padding), int(padding)),) * n
    padding = list(padding)
    if len(padding) == n and all(isinstance(p, (int, np.integer))
                                 for p in padding):
        return "EXPLICIT", tuple((int(p), int(p)) for p in padding)
    if len(padding) == n + 2 and all(isinstance(p, (list, tuple))
                                     for p in padding):
        # [[0, 0], [0, 0], [lo, hi], ...] (the reference's 2n test comes
        # first and so misreads this form at n = 2)
        return "EXPLICIT", tuple((int(p[0]), int(p[1]))
                                 for p in padding[2:])
    if len(padding) == 2 * n:
        return "EXPLICIT", tuple((int(padding[2 * i]), int(padding[2 * i + 1]))
                                 for i in range(n))
    raise ValueError(f"bad padding {padding}")


def same_pads(sizes, window, strides):
    """XLA's "SAME" pads: the output has ceil(size / stride) positions,
    and the low side gets the smaller half of the padding."""
    pads = []
    for size, k, s in zip(sizes, window, strides):
        total = max((-(-size // s) - 1) * s + k - size, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(pads)


# threads inside _f32_exact, and the flag they found on entering: the
# first one in turns TF32 off, the last one out puts the flag back, so
# overlapping calls from several threads cannot leave it changed
_tf32_lock = threading.Lock()
_tf32_state = {"inside": 0, "saved": None}


@contextlib.contextmanager
def _f32_exact(t):
    """cuDNN without TF32 while an f32 CUDA tensor's product runs."""
    if t.dtype != torch.float32 or t.device.type != "cuda":
        yield
        return
    with _tf32_lock:
        if _tf32_state["inside"] == 0:
            _tf32_state["saved"] = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = False
        _tf32_state["inside"] += 1
    try:
        yield
    finally:
        with _tf32_lock:
            _tf32_state["inside"] -= 1
            if _tf32_state["inside"] == 0:
                torch.backends.cudnn.allow_tf32 = _tf32_state["saved"]


class _Conv(torch.autograd.Function):
    """``aten.convolution`` without bias (transposed or not), forward and
    backward each with TF32 off for f32 (the backward otherwise reads the
    global flag when it runs, outside the forward's scope)."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, dilation, groups,
                transposed=False, output_padding=None):
        ctx.save_for_backward(x, w)
        out_pad = output_padding or [0] * len(stride)
        ctx.conf = (stride, padding, dilation, groups, transposed, out_pad)
        with _f32_exact(x):
            return torch.ops.aten.convolution(
                x, w, None, stride, padding, dilation, transposed, out_pad,
                groups)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        stride, padding, dilation, groups, transposed, out_pad = ctx.conf
        with _f32_exact(x):
            gx, gw, _ = torch.ops.aten.convolution_backward(
                gy, x, w, None, stride, padding, dilation, transposed,
                out_pad, groups,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return gx, gw, None, None, None, None, None, None


def _conv(x, w, b=None, strides=(), pads=(), dils=(), groups=1):
    n = len(strides)
    if any(lo != hi for lo, hi in pads):
        # F.pad takes the last axis first
        x = TF.pad(x, [p for lo_hi in reversed(pads) for p in lo_hi])
        pads = ((0, 0),) * n
    y = _Conv.apply(x, w, list(strides), [lo for lo, _ in pads],
                    list(dils), groups)
    if b is not None:
        y = y + b.reshape((1, -1) + (1,) * n)
    return y


def _convnd(x, weight, bias, stride, padding, dilation, groups, n,
            data_format):
    from ...amp import maybe_autocast

    if data_format not in ("NCL", "NCHW", "NCDHW"):
        raise NotImplementedError(f"conv{n}d takes channels-first input; "
                                  f"data_format={data_format!r} is not "
                                  f"ported")
    x, weight = maybe_autocast(x, weight)
    strides = _ntuple(stride, n)
    dils = _ntuple(dilation, n)
    kind, pads = _norm_padding(padding, n)
    if kind == "VALID":
        pads = ((0, 0),) * n
    elif kind == "SAME":
        window = [d * (k - 1) + 1 for d, k in zip(dils, weight.shape[2:])]
        pads = same_pads(x.shape[2:], window, strides)
    args = (x, weight) if bias is None else (x, weight, bias)
    return apply_op(_conv, *args, strides=strides, pads=pads, dils=dils,
                    groups=int(groups))


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _convnd(x, weight, bias, stride, padding, dilation, groups, 1,
                   data_format)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _convnd(x, weight, bias, stride, padding, dilation, groups, 2,
                   data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _convnd(x, weight, bias, stride, padding, dilation, groups, 3,
                   data_format)


def _conv_transpose(x, w, b=None, strides=(), pads=(), out_pad=(),
                    dils=(), groups=1):
    n = len(strides)
    native = all(lo == hi for lo, hi in pads) and all(
        op < s or op < d for op, s, d in zip(out_pad, strides, dils))
    if native:
        y = _Conv.apply(x, w, list(strides), [lo for lo, _ in pads],
                        list(dils), groups, True, list(out_pad))
    else:
        y = _Conv.apply(x, w, list(strides), [0] * n, list(dils), groups,
                        True, [0] * n)
        # crop lo / hi (negative pads) and extend by output_padding
        y = TF.pad(y, [v for (lo, hi), op in zip(reversed(pads),
                                                 reversed(out_pad))
                       for v in (-lo, op - hi)])
    if b is not None:
        y = y + b.reshape((1, -1) + (1,) * n)
    return y


def _transpose_pads(padding, n, sizes, window, strides):
    kind, pads = _norm_padding(padding, n)
    if kind == "VALID":
        return ((0, 0),) * n
    if kind == "SAME":
        # Paddle's conv_transpose "SAME": the pads a forward "SAME" conv
        # of the input's size would take
        out = []
        for size, k, s in zip(sizes, window, strides):
            total = max((-(-size // s) - 1) * s + k - size, 0)
            out.append((total // 2, total - total // 2))
        return tuple(out)
    return pads


def _conv_transpose_nd(x, weight, bias, stride, padding, output_padding,
                       dilation, groups, output_size, data_format, n):
    from ...amp import maybe_autocast

    if data_format not in ("NCL", "NCHW", "NCDHW"):
        raise NotImplementedError(f"conv{n}d_transpose takes channels-first "
                                  f"input; data_format={data_format!r} is "
                                  f"not ported")
    x, weight = maybe_autocast(x, weight)
    strides = _ntuple(stride, n)
    dils = _ntuple(dilation, n)
    out_pad = _ntuple(output_padding, n)
    window = [d * (k - 1) + 1 for d, k in zip(dils, weight.shape[2:])]
    sizes = x.shape[2:]
    pads = _transpose_pads(padding, n, sizes, window, strides)
    if output_size is not None:
        if any(out_pad):
            raise ValueError("output_padding and output_size exclude each "
                             "other")
        want = (list(output_size) if isinstance(output_size, (list, tuple))
                else [output_size] * n)
        want = [int(v) for v in want[-n:]]
        base = [(i - 1) * s + k - lo - hi for i, s, k, (lo, hi) in
                zip(sizes, strides, window, pads)]
        out_pad = tuple(int(o) - b for o, b in zip(want, base))
        if any(op < 0 or op >= s for op, s in zip(out_pad, strides)):
            raise ValueError(f"output_size {list(want)} must lie in "
                             f"[{base}, {[b + s for b, s in zip(base, strides)]})")
    args = (x, weight) if bias is None else (x, weight, bias)
    return apply_op(_conv_transpose, *args, strides=strides, pads=pads,
                    out_pad=out_pad, dils=dils, groups=int(groups))


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, output_size,
                              data_format, 1)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW", name=None):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, output_size,
                              data_format, 2)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, output_size,
                              data_format, 3)
