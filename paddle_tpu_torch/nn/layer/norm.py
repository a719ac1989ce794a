"""LayerNorm and the batch norms (``paddle_tpu/nn/layer/norm.py``).

``_BatchNormBase`` holds ``weight`` (ones) and ``bias`` (zeros) and the
buffers ``_mean`` (zeros) and ``_variance`` (ones), all f32, and calls
``F.batch_norm`` with ``training`` from ``train()`` / ``eval()``.
``SyncBatchNorm`` is ``BatchNorm`` on one process, as the reference's is
eagerly; inside a process group of more than one rank it raises, since
the cross-rank statistics are not ported yet.
"""
from __future__ import annotations

import torch

from ...device import current_device
from ...framework.core import Tensor
from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["LayerNorm", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "BatchNorm3D", "SyncBatchNorm"]


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = self.create_parameter(
            shape=[num_features], attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter(shape=[num_features],
                                          attr=bias_attr, is_bias=True)
        dev = current_device()
        self.register_buffer("_mean", Tensor(torch.zeros(
            num_features, dtype=torch.float32, device=dev)))
        self.register_buffer("_variance", Tensor(torch.ones(
            num_features, dtype=torch.float32, device=dev)))

    def forward(self, x):
        return F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format,
            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return (f"num_features={self._num_features}, "
                f"momentum={self._momentum}")


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr,
                         "NCHW" if data_format == "NCL" else data_format,
                         use_global_stats)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats)


class BatchNorm(_BatchNormBase):
    """The fluid-style BatchNorm: BatchNorm2D with an optional
    activation (``act``, a name in ``nn.functional``)."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-05,
                 param_attr=None, bias_attr=None, dtype="float32",
                 data_layout="NCHW", in_place=False, moving_mean_name=None,
                 moving_variance_name=None,
                 do_model_average_for_mean_and_var=True,
                 use_global_stats=False, trainable_statistics=False):
        super().__init__(num_channels, momentum, epsilon, param_attr,
                         bias_attr, data_layout, use_global_stats or None)
        self._act = act

    def forward(self, x):
        y = super().forward(x)
        if self._act:
            y = getattr(F, self._act)(y)
        return y


class SyncBatchNorm(_BatchNormBase):
    """Cross-replica batch norm; on one process it is BatchNorm."""

    def forward(self, x):
        dist = torch.distributed
        if dist.is_available() and dist.is_initialized() \
                and dist.get_world_size() > 1:
            raise NotImplementedError(
                "SyncBatchNorm across ranks is not ported to "
                "paddle_tpu_torch yet (its statistics would be this "
                "rank's only)")
        return super().forward(x)

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        out = layer
        if isinstance(layer, _BatchNormBase) \
                and not isinstance(layer, SyncBatchNorm):
            out = SyncBatchNorm(layer._num_features, layer._momentum,
                                layer._epsilon,
                                data_format=layer._data_format)
            out.weight = layer.weight
            out.bias = layer.bias
            out._mean = layer._mean
            out._variance = layer._variance
        for name, sub in layer._sub_layers.items():
            out._sub_layers[name] = cls.convert_sync_batchnorm(sub)
        return out


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            shape=self._normalized_shape, attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter(
            shape=self._normalized_shape, attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}"
