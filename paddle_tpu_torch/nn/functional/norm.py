"""``batch_norm``, ``layer_norm``, ``instance_norm``, ``group_norm``
and ``local_response_norm`` (``paddle_tpu/nn/functional/norm.py``).

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

``instance_norm`` and ``group_norm`` are composed as the JAX package
composes them: (x − mean)·rsqrt(biased var + ε) over each sample's
channel (or group of channels), then the scale and shift.
``instance_norm`` normalizes by the input's own statistics only: given
running statistics, or ``use_input_stats=False``, it raises
``NotImplementedError``, where the JAX package ignores them.
``local_response_norm`` divides by (k + α·Σ x²)^β, the sum over
``size`` neighbouring channels, as the JAX package does. A channels-last
``data_format`` raises ``NotImplementedError`` in all three.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from ...framework.core import apply_op

__all__ = ["batch_norm", "layer_norm", "instance_norm", "group_norm",
           "local_response_norm"]


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


def _channels_first(data_format, what):
    if data_format not in ("NC", "NCL", "NCHW", "NCDHW"):
        raise NotImplementedError(f"{what} takes channels-first input; "
                                  f"data_format={data_format!r} is not "
                                  f"ported")


def _affine(y, w, b):
    shape = (1, -1) + (1,) * (y.ndim - 2)
    if w is not None:
        y = y * w.reshape(shape)
    if b is not None:
        y = y + b.reshape(shape)
    return y


def _instance_norm(x, w=None, b=None, epsilon=1e-5):
    axes = tuple(range(2, x.ndim))
    mean = x.mean(axes, keepdim=True)
    var = x.var(axes, unbiased=False, keepdim=True)
    return _affine((x - mean) * torch.rsqrt(var + epsilon), w, b)


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-05,
                  data_format="NCHW", name=None):
    _channels_first(data_format, "instance_norm")
    if running_mean is not None or running_var is not None \
            or not use_input_stats:
        raise NotImplementedError(
            "instance_norm normalizes by the input's own statistics; "
            "running statistics and use_input_stats=False are not ported")
    affine = (weight, bias) if weight is not None and bias is not None \
        else ()
    return apply_op(_instance_norm, x, *affine, epsilon=float(eps))


def _group_norm(x, w=None, b=None, groups=1, epsilon=1e-5):
    n, c = x.shape[:2]
    xg = x.reshape((n, groups, c // groups) + tuple(x.shape[2:]))
    axes = tuple(range(2, xg.ndim))
    mean = xg.mean(axes, keepdim=True)
    var = xg.var(axes, unbiased=False, keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + epsilon)).reshape(x.shape)
    return _affine(y, w, b)


def group_norm(x, num_groups, epsilon=1e-05, weight=None, bias=None,
               data_format="NCHW", name=None):
    _channels_first(data_format, "group_norm")
    if x.shape[1] % int(num_groups):
        raise ValueError(f"group_norm: {x.shape[1]} channels do not split "
                         f"into {num_groups} groups")
    return apply_op(_group_norm, x, weight, bias, groups=int(num_groups),
                    epsilon=float(epsilon))


def _lrn(x, size=5, alpha=1e-4, beta=0.75, k=1.0):
    half = size // 2
    sq = TF.pad(x * x, (0, 0) * (x.ndim - 2) + (half, size - 1 - half))
    acc = torch.zeros_like(x)
    for i in range(size):
        acc = acc + sq.narrow(1, i, x.shape[1])
    return x / torch.pow(k + alpha * acc, beta)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    _channels_first(data_format, "local_response_norm")
    return apply_op(_lrn, x, size=int(size), alpha=float(alpha),
                    beta=float(beta), k=float(k))
