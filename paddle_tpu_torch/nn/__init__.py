"""paddle_tpu_torch.nn — the ported layers of ``paddle.nn`` (Layer,
the common layers of ``nn/layer/common.py``, the convolutions, pooling,
batch norm and LayerNorm, the containers, every activation layer, the
transformer encoder and eight loss layers), ``functional``,
``initializer``, the gradient clips (``nn/clip.py``); and the MoE
routing functions (``nn/moe.py``)."""
from . import functional, initializer  # noqa: F401
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import activation as _activation
from .layer import common as _common
from .layer.activation import *  # noqa: F401,F403
from .layer.common import *  # noqa: F401,F403
from .layer.container import LayerDict, LayerList, ParameterList, Sequential
from .layer.loss import (BCELoss, BCEWithLogitsLoss, CrossEntropyLoss,
                         KLDivLoss, L1Loss, MSELoss, NLLLoss, SmoothL1Loss)
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

__all__ = _activation.__all__ + _common.__all__ + [
           "Layer", "LayerNorm", "LayerDict", "ParameterList",
           "BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "SyncBatchNorm", "Conv1D", "Conv2D", "Conv3D", "MaxPool1D",
           "MaxPool2D", "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D",
           "AdaptiveMaxPool1D", "AdaptiveMaxPool2D", "AdaptiveMaxPool3D",
           "LayerList", "Sequential", "MultiHeadAttention",
           "TransformerEncoderLayer", "TransformerEncoder", "functional",
           "initializer", "moe_capacity", "moe_ffn", "moe_route",
           "ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "CrossEntropyLoss", "MSELoss", "L1Loss", "NLLLoss", "BCELoss",
           "BCEWithLogitsLoss", "SmoothL1Loss", "KLDivLoss"]
