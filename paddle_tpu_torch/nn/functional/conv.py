"""``conv1d``, ``conv2d`` and ``conv3d`` (``paddle_tpu/nn/functional/
conv.py``), NC* layouts, weight (out, in / groups, *kernel).

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
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch
import torch.nn.functional as TF

from ...framework.core import apply_op

__all__ = ["conv1d", "conv2d", "conv3d"]


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
    """``aten.convolution`` without bias, forward and backward each with
    TF32 off for f32 (the backward otherwise reads the global flag when
    it runs, outside the forward's scope)."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, dilation, groups):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, dilation, groups)
        with _f32_exact(x):
            return torch.ops.aten.convolution(
                x, w, None, stride, padding, dilation, False,
                [0] * len(stride), groups)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        stride, padding, dilation, groups = ctx.conf
        with _f32_exact(x):
            gx, gw, _ = torch.ops.aten.convolution_backward(
                gy, x, w, None, stride, padding, dilation, False,
                [0] * len(stride), groups,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return gx, gw, None, None, None, None


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
