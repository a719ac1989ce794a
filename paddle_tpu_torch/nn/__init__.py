"""paddle_tpu_torch.nn — the ported layers of ``paddle.nn`` (Layer,
Linear, Embedding, Dropout, the convolutions, pooling, batch norm and
LayerNorm, the containers, GELU/ReLU and the transformer encoder),
``functional`` and ``initializer``; and the MoE routing functions
(``nn/moe.py``)."""
from . import functional, initializer  # noqa: F401
from .layer.activation import GELU, ReLU
from .layer.common import Dropout, Embedding, Linear
from .layer.container import LayerList, Sequential
from .layer.conv import Conv1D, Conv2D, Conv3D
from .layer.layers import Layer
from .layer.norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                         LayerNorm, SyncBatchNorm)
from .layer.pooling import (AdaptiveAvgPool1D, AdaptiveAvgPool2D,
                            AdaptiveAvgPool3D, AdaptiveMaxPool1D,
                            AdaptiveMaxPool2D, AdaptiveMaxPool3D, AvgPool1D,
                            AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D,
                            MaxPool3D)
from .layer.transformer import (MultiHeadAttention, TransformerEncoder,
                                TransformerEncoderLayer)
from .moe import moe_capacity, moe_ffn, moe_route

__all__ = ["Layer", "Linear", "Embedding", "Dropout", "LayerNorm",
           "BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "SyncBatchNorm", "Conv1D", "Conv2D", "Conv3D", "MaxPool1D",
           "MaxPool2D", "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D",
           "AdaptiveMaxPool1D", "AdaptiveMaxPool2D", "AdaptiveMaxPool3D",
           "LayerList", "Sequential", "GELU", "ReLU", "MultiHeadAttention",
           "TransformerEncoderLayer", "TransformerEncoder", "functional",
           "initializer", "moe_capacity", "moe_ffn", "moe_route"]
