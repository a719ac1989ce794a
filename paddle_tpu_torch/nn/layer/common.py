"""Linear, Embedding and Dropout (a subset of
``paddle_tpu/nn/layer/common.py``). ``Linear.weight`` keeps Paddle's
``(in_features, out_features)`` layout, not ``torch.nn.Linear``'s
``(out, in)``, so a Paddle state dict carries across unchanged."""
from __future__ import annotations

import torch

from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["Linear", "Embedding", "Dropout"]


class Linear(Layer):
    """y = xW + b with W: [in_features, out_features]."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self._in_features = in_features
        self._out_features = out_features
        self.weight = self.create_parameter(
            shape=[in_features, out_features], attr=weight_attr,
            default_initializer=I.XavierUniform())
        self.bias = self.create_parameter(shape=[out_features],
                                          attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self._in_features}, "
                f"out_features={self._out_features}")


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None):
        super().__init__()
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._sparse = bool(sparse)
        self._padding_idx = (
            None if padding_idx is None
            else padding_idx if padding_idx >= 0
            else num_embeddings + padding_idx)
        self.weight = self.create_parameter(
            shape=[num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=(I.Normal(0.0, 1.0) if weight_attr is None
                                 else None))
        if self._padding_idx is not None:
            with torch.no_grad():
                self.weight._data[self._padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx,
                           sparse=self._sparse)


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train",
                 name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, self.p, axis=self.axis, training=self.training,
                         mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}"
