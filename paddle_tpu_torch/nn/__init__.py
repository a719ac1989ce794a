"""paddle_tpu_torch.nn — the ported layers of ``paddle.nn`` (Layer,
Linear, Embedding, Dropout, LayerNorm, the containers, GELU/ReLU and the
transformer encoder), ``functional`` and ``initializer``; and the MoE
routing functions (``nn/moe.py``)."""
from . import functional, initializer  # noqa: F401
from .layer.activation import GELU, ReLU
from .layer.common import Dropout, Embedding, Linear
from .layer.container import LayerList, Sequential
from .layer.layers import Layer
from .layer.norm import LayerNorm
from .layer.transformer import (MultiHeadAttention, TransformerEncoder,
                                TransformerEncoderLayer)
from .moe import moe_capacity, moe_ffn, moe_route

__all__ = ["Layer", "Linear", "Embedding", "Dropout", "LayerNorm",
           "LayerList", "Sequential", "GELU", "ReLU", "MultiHeadAttention",
           "TransformerEncoderLayer", "TransformerEncoder", "functional",
           "initializer", "moe_capacity", "moe_ffn", "moe_route"]
