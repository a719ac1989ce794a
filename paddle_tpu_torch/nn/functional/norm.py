"""``layer_norm`` (``paddle_tpu/nn/functional/norm.py``): statistics
over the last ``len(normalized_shape)`` axes, then scale and shift."""
from __future__ import annotations

import torch.nn.functional as TF

from ...framework.core import apply_op

__all__ = ["layer_norm"]


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
