"""paddle_tpu_torch.nn — the layers of ``paddle.nn`` (Layer, the common
layers of ``nn/layer/common.py``, the convolutions and their transposes,
pooling, the norms, the containers, every activation layer, the
recurrent cells and layers, the transformer encoder, decoder and
``Transformer``, the loss layers), beam-search decoding
(``nn/decode.py``), ``functional``, ``initializer``, the gradient clips
(``nn/clip.py``); and the MoE routing functions (``nn/moe.py``)."""
from . import functional, initializer  # noqa: F401
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .decode import BeamSearchDecoder, beam_search, dynamic_decode
from .layer import activation as _activation
from .layer import common as _common
from .layer import conv as _conv
from .layer import loss as _loss
from .layer import norm as _norm
from .layer import rnn as _rnn
from .layer import transformer as _transformer
from .layer.activation import *  # noqa: F401,F403
from .layer.common import *  # noqa: F401,F403
from .layer.container import LayerDict, LayerList, ParameterList, Sequential
from .layer.conv import *  # noqa: F401,F403
from .layer.layers import Layer
from .layer.loss import *  # noqa: F401,F403
from .layer.norm import *  # noqa: F401,F403
from .layer.pooling import (AdaptiveAvgPool1D, AdaptiveAvgPool2D,
                            AdaptiveAvgPool3D, AdaptiveMaxPool1D,
                            AdaptiveMaxPool2D, AdaptiveMaxPool3D, AvgPool1D,
                            AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D,
                            MaxPool3D)
from .layer.rnn import *  # noqa: F401,F403
from .layer.transformer import *  # noqa: F401,F403
from .moe import moe_capacity, moe_ffn, moe_route

__all__ = (_activation.__all__ + _common.__all__ + _conv.__all__
           + _loss.__all__ + _norm.__all__ + _rnn.__all__
           + _transformer.__all__ + [
               "Layer", "LayerDict", "ParameterList", "MaxPool1D",
               "MaxPool2D", "MaxPool3D", "AvgPool1D", "AvgPool2D",
               "AvgPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
               "AdaptiveAvgPool3D", "AdaptiveMaxPool1D", "AdaptiveMaxPool2D",
               "AdaptiveMaxPool3D", "LayerList", "Sequential", "functional",
               "initializer", "moe_capacity", "moe_ffn", "moe_route",
               "ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
               "BeamSearchDecoder", "dynamic_decode", "beam_search"])
