"""MultiHeadAttention (with its incremental ``Cache`` and cross-attention
``StaticCache``), the encoder and decoder layers and stacks, and
``Transformer`` (``paddle_tpu/nn/layer/transformer.py``).

A ``Cache`` holds the keys and values of the steps decoded so far
([batch, heads, steps, head_dim]; ``gen_cache`` makes an empty one) and
each call appends the new step's; a ``StaticCache`` holds the keys and
values of a fixed memory, projected once. The layers return
``(output, new_cache)`` when given a cache, as the JAX package's do.

The attention core takes the port's flash-attention kernels
(``ops/flash_attention.py``) where the JAX package takes its Pallas
kernel on a TPU: no mask, no attention weights asked for, no attention
dropout, and Sq = Sk >= 512 — on a CUDA tensor. The 512 threshold is
the JAX package's, measured on a TPU v5e (its comment at
``transformer.py:96-99``); it is kept as JAX has it, not re-measured on
the H100. Everywhere else the core is the composed softmax(QKᵀ/√d)·V.
"""
from __future__ import annotations

import collections
import copy
import math

import torch

from ...framework.core import Tensor, apply_op
from ...ops.flash_attention import flash_attention_arrays
from ...tensor import cast, concat, matmul, reshape, transpose
from .. import functional as F
from .common import Dropout, Linear
from .container import LayerList
from .layers import Layer
from .norm import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]


def _convert_attention_mask(attn_mask, dtype):
    """A bool mask (True = keep) becomes an additive one (-1e9 where
    False); an additive mask passes through."""
    if attn_mask is None or attn_mask.dtype != torch.bool:
        return attn_mask
    return (1.0 - cast(attn_mask, dtype)) * -1e9


def _flash(q, k, v):
    return flash_attention_arrays(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=False)


class MultiHeadAttention(Layer):
    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

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

    def _prepare_qkv(self, query, key, value, cache=None):
        q = self._heads(self.q_proj(query))
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._heads(self.k_proj(key))
            v = self._heads(self.v_proj(value))
        if isinstance(cache, self.Cache):
            k = concat([cache.k, k], axis=2)
            v = concat([cache.v, v], axis=2)
            cache = self.Cache(k, v)
        return q, k, v, cache

    def gen_cache(self, key, value=None, type=Cache):  # noqa: A002
        """A ``StaticCache`` of ``key`` / ``value`` projected once, or an
        empty incremental ``Cache`` for ``key``'s batch (``key`` a
        Tensor or the batch size)."""
        if type == MultiHeadAttention.StaticCache:
            k = self._heads(self.k_proj(key))
            v = self._heads(self.v_proj(value if value is not None
                                        else key))
            return self.StaticCache(k, v)
        if isinstance(key, Tensor):
            bsz, dt, dev = key.shape[0], key.dtype, key.place
        else:
            w = self.k_proj.weight._data
            bsz, dt, dev = int(key), w.dtype, w.device
        empty = torch.zeros((bsz, self.num_heads, 0, self.head_dim),
                            dtype=dt, device=dev)
        return self.Cache(Tensor(empty), Tensor(empty.clone()))

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
        key = query if key is None else key
        value = query if value is None else value
        attn_mask = _convert_attention_mask(attn_mask, query.dtype)
        q, k, v, cache = self._prepare_qkv(query, key, value, cache)
        out, weights = self.core_attention(q, k, v, attn_mask)
        # [B, H, T, D] -> [B, T, H*D]
        out = transpose(out, [0, 2, 1, 3])
        out = self.out_proj(reshape(out, [out.shape[0], out.shape[1],
                                          self.embed_dim]))
        outs = [out]
        if self.need_weights:
            outs.append(weights)
        if cache is not None:
            outs.append(cache)
        return out if len(outs) == 1 else tuple(outs)


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
        src_mask = _convert_attention_mask(src_mask, src.dtype)
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
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
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src.shape[0])


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([encoder_layer] + [
            copy.deepcopy(encoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        src_mask = _convert_attention_mask(src_mask, src.dtype)
        output = src
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is None:
                output = layer(output, src_mask)
            else:
                output, c = layer(output, src_mask, cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(Layer):
    """Self-attention (causal through ``tgt_mask``, incremental through a
    ``Cache``), cross-attention over ``memory`` (a ``StaticCache`` when
    decoding) and the feed-forward block, each with its residual and
    LayerNorm (before or after, by ``normalize_before``)."""

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
        self.cross_attn = MultiHeadAttention(d_model, nhead,
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
        self.norm3 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout, mode="upscale_in_train")
        self.dropout2 = Dropout(dropout, mode="upscale_in_train")
        self.dropout3 = Dropout(dropout, mode="upscale_in_train")
        self.activation = activation

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        tgt_mask = _convert_attention_mask(tgt_mask, tgt.dtype)
        memory_mask = _convert_attention_mask(memory_mask, tgt.dtype)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask, None)
        else:
            tgt, incremental = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                              cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if cache is None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask, None)
        else:
            tgt, static = self.cross_attn(tgt, memory, memory, memory_mask,
                                          cache[1])
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        act = getattr(F, self.activation)
        tgt = self.linear2(self.dropout(act(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (incremental, static))

    def gen_cache(self, memory):
        return (self.self_attn.gen_cache(memory.shape[0]),
                self.cross_attn.gen_cache(memory, memory,
                                          MultiHeadAttention.StaticCache))


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([decoder_layer] + [
            copy.deepcopy(decoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is None:
                output = layer(output, memory, tgt_mask, memory_mask, None)
            else:
                output, c = layer(output, memory, tgt_mask, memory_mask,
                                  cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        cache = [layer.gen_cache(memory) for layer in self.layers]
        return list(zip(*cache)) if do_zip else cache


class Transformer(Layer):
    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None):
        super().__init__()
        args = (d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            self.encoder = TransformerEncoder(
                TransformerEncoderLayer(*args), num_encoder_layers,
                LayerNorm(d_model) if normalize_before else None)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            self.decoder = TransformerDecoder(
                TransformerDecoderLayer(*args), num_decoder_layers,
                LayerNorm(d_model) if normalize_before else None)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length):
        """[length, length] additive causal mask: 0 on and below the
        diagonal, -inf above, on the current device."""
        from ...device import current_device

        return Tensor(torch.triu(torch.full((length, length), -math.inf,
                                            device=current_device()), 1))
