"""``batch_norm`` and ``layer_norm`` (``paddle_tpu/nn/functional/
norm.py``).

``batch_norm`` follows the reference's statistics, not PyTorch's
defaults:

- in training (and not ``use_global_stats``) it normalizes by the batch
  mean and the **biased** variance, computed in f32 for bf16 input, and
  returns ``x.dtype``;
- the running statistics move by Paddle's convention,
  ``running·momentum + batch·(1 − momentum)`` with ``momentum=0.9``, and
  the biased variance goes into ``running_var`` too; they are updated in
  place and carry no gradient;
- otherwise it normalizes by the running statistics.

``torch.batch_norm`` does the normalization (cuDNN on the card), with
the statistics in f32 for low-precision input. Its own running update
takes the unbiased variance with the opposite momentum convention, so
it writes into zeroed scratch vectors at momentum 1 (the batch's
statistics), and the reference's update is applied from those, the
unbiased variance scaled back by (n − 1) / n.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from ...framework.core import apply_op

__all__ = ["batch_norm", "layer_norm"]


def _bn(x, mean, var, w=None, b=None, training=False, epsilon=1e-5,
        axis=1):
    if axis != 1:
        x = x.movedim(axis, 1)
    y = torch.batch_norm(x, w, b, mean, var, training, 1.0, epsilon,
                         torch.backends.cudnn.enabled)
    return y.movedim(1, axis) if axis != 1 else y


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-05,
               data_format="NCHW", use_global_stats=None, name=None):
    """Functional batch norm; in training, ``running_mean`` and
    ``running_var`` (Tensors) are updated in place."""
    axis = 1 if data_format.startswith("NC") or x.ndim <= 2 else x.ndim - 1
    if use_global_stats is None:
        use_global_stats = not training
    if (weight is None) != (bias is None):
        raise ValueError("batch_norm: weight/bias must both be set or both "
                         "None")
    affine = () if weight is None else (weight, bias)
    if not training or use_global_stats:
        return apply_op(_bn, x, running_mean, running_var, *affine,
                        training=False, epsilon=float(epsilon), axis=axis)
    c = x.shape[axis]
    xd = x._data
    sdt = torch.float64 if xd.dtype == torch.float64 else torch.float32
    mean = torch.zeros(c, dtype=sdt, device=xd.device)
    var = torch.zeros(c, dtype=sdt, device=xd.device)
    y = apply_op(_bn, x, mean, var, *affine, training=True,
                 epsilon=float(epsilon), axis=axis)
    if running_mean is not None:
        n = math.prod(x.shape) // c
        m = momentum
        with torch.no_grad():
            rm, rv = running_mean._data, running_var._data
            rm.copy_(rm * m + mean * (1 - m))
            rv.copy_(rv * m + var * ((n - 1) / n) * (1 - m))
    return y


def _layer_norm(x, w=None, b=None, shape=(), epsilon=1e-5):
    cast = lambda t: None if t is None else t.to(x.dtype)
    return TF.layer_norm(x, shape, cast(w), cast(b), epsilon)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05,
               name=None):
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    return apply_op(_layer_norm, x, weight, bias,
                    shape=tuple(int(s) for s in normalized_shape),
                    epsilon=float(epsilon))
