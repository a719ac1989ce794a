"""``linear``, ``dropout`` and ``embedding`` (a subset of
``paddle_tpu/nn/functional/common.py``). ``linear`` takes Paddle's
``(in, out)`` weight and, under ``amp.auto_cast``, casts ``x`` and the
weight (not the bias) to the AMP dtype; ``dropout`` draws its mask from the input
device's seeded generator."""
from __future__ import annotations

import warnings

import torch

from ...framework import random as grandom
from ...framework.core import Tensor, apply_op

__all__ = ["linear", "dropout", "embedding"]


def _linear(x, w, b=None):
    y = torch.matmul(x, w)
    return y if b is None else y + b


def linear(x, weight, bias=None, name=None):
    from ...amp import maybe_autocast

    x, weight = maybe_autocast(x, weight)
    if bias is None:
        return apply_op(_linear, x, weight)
    return apply_op(_linear, x, weight, bias)


def _dropout_train(x, keep, p, mode):
    if mode == "upscale_in_train":
        return x * keep / (1.0 - p)
    return x * keep


def _scale_by(x, factor):
    return x * factor


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return apply_op(_scale_by, x, factor=1.0 - p)
        return x
    xa = x._data
    if axis is None:
        mshape = xa.shape
    else:
        axes = (axis,) if isinstance(axis, int) else tuple(axis)
        mshape = tuple(s if i in axes else 1 for i, s in enumerate(xa.shape))
    keep = torch.empty(mshape, dtype=xa.dtype, device=xa.device).bernoulli_(
        1.0 - p, generator=grandom.generator(xa.device))
    return apply_op(_dropout_train, x, keep.expand(xa.shape), p=float(p),
                    mode=mode)


def _embedding(weight, ids, padding_idx=None):
    out = weight[ids]
    if padding_idx is not None:
        out = out * (ids != padding_idx).unsqueeze(-1).to(out.dtype)
    return out


_sparse_warned = [False]


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` at the integer ids ``x``; rows of
    ``padding_idx`` read as zeros. ``sparse=True`` takes the dense
    backward, as the JAX package does without a device mesh."""
    if sparse and not _sparse_warned[0]:
        _sparse_warned[0] = True
        warnings.warn("Embedding(sparse=True) runs the dense backward in "
                      "paddle_tpu_torch (values and gradients are the "
                      "same)", stacklevel=2)
    ids = x if isinstance(x, Tensor) else Tensor(x)
    return apply_op(_embedding, weight, ids.astype("int64"),
                    padding_idx=padding_idx)
