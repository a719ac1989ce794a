"""MultiHeadAttention, TransformerEncoderLayer and TransformerEncoder
(``paddle_tpu/nn/layer/transformer.py``), without the incremental
decoding caches and the decoder stack (ROADMAP Queue 1 item 8).

The attention core takes the port's flash-attention kernels
(``ops/flash_attention.py``) where the JAX package takes its Pallas
kernel on a TPU: no mask, no attention weights asked for, no attention
dropout, and Sq = Sk >= 512 — on a CUDA tensor. The 512 threshold is
the JAX package's, measured on a TPU v5e (its comment at
``transformer.py:96-99``); it is kept as JAX has it, not re-measured on
the H100. Everywhere else the core is the composed softmax(QKᵀ/√d)·V.
"""
from __future__ import annotations

import copy

import torch

from ...framework.core import apply_op
from ...ops.flash_attention import flash_attention_arrays
from ...tensor import cast, matmul, reshape, transpose
from .. import functional as F
from .common import Dropout, Linear
from .container import LayerList
from .layers import Layer
from .norm import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder"]


def _convert_attention_mask(attn_mask, dtype):
    """A bool mask (True = keep) becomes an additive one (-1e9 where
    False); an additive mask passes through."""
    if attn_mask is None or attn_mask.dtype != torch.bool:
        return attn_mask
    return (1.0 - cast(attn_mask, dtype)) * -1e9


def _no_cache(cache):
    if cache is not None:
        raise NotImplementedError("incremental decoding caches are not "
                                  "ported to paddle_tpu_torch yet")


def _flash(q, k, v):
    return flash_attention_arrays(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=False)


class MultiHeadAttention(Layer):
    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.dropout = dropout
        self.need_weights = need_weights
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)
        self.k_proj = Linear(self.kdim, embed_dim, weight_attr, bias_attr)
        self.v_proj = Linear(self.vdim, embed_dim, weight_attr, bias_attr)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)

    def _heads(self, t):
        t = reshape(t, [t.shape[0], t.shape[1], self.num_heads,
                        self.head_dim])
        return transpose(t, [0, 2, 1, 3])

    def core_attention(self, q, k, v, attn_mask=None):
        # where the JAX package takes its flash kernel on a TPU (no mask,
        # no weights, no dropout, Sq = Sk >= 512: the v5e crossover it
        # measured), the port takes its flash kernels on the card
        if (attn_mask is None and not self.need_weights and not self.dropout
                and q.shape[2] == k.shape[2] and q.shape[2] >= 512
                and q.place.type == "cuda"):
            return apply_op(_flash, q, k, v), None
        product = matmul(q, k, transpose_y=True) * (self.head_dim ** -0.5)
        if attn_mask is not None:
            product = product + attn_mask
        weights = F.softmax(product, axis=-1)
        if self.dropout:
            weights = F.dropout(weights, self.dropout,
                                training=self.training,
                                mode="upscale_in_train")
        return matmul(weights, v), weights

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        _no_cache(cache)
        key = query if key is None else key
        value = query if value is None else value
        attn_mask = _convert_attention_mask(attn_mask, query.dtype)
        q = self._heads(self.q_proj(query))
        k = self._heads(self.k_proj(key))
        v = self._heads(self.v_proj(value))
        out, weights = self.core_attention(q, k, v, attn_mask)
        # [B, H, T, D] -> [B, T, H*D]
        out = transpose(out, [0, 2, 1, 3])
        out = self.out_proj(reshape(out, [out.shape[0], out.shape[1],
                                          self.embed_dim]))
        return (out, weights) if self.need_weights else out


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead,
                                            dropout=attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr)
        self.dropout = Dropout(act_dropout, mode="upscale_in_train")
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout, mode="upscale_in_train")
        self.dropout2 = Dropout(dropout, mode="upscale_in_train")
        self.activation = activation

    def forward(self, src, src_mask=None, cache=None):
        _no_cache(cache)
        src_mask = _convert_attention_mask(src_mask, src.dtype)
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        src = self.self_attn(src, src, src, src_mask)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        act = getattr(F, self.activation)
        src = self.linear2(self.dropout(act(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([encoder_layer] + [
            copy.deepcopy(encoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        _no_cache(cache)
        src_mask = _convert_attention_mask(src_mask, src.dtype)
        output = src
        for layer in self.layers:
            output = layer(output, src_mask)
        if self.norm is not None:
            output = self.norm(output)
        return output
