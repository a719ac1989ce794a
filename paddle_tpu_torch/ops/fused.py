"""Fused transformer ops of the Paddle surface:
``fused_multi_head_attention`` and ``fused_feedforward``.

Counterpart of ``paddle_tpu/ops/fused.py`` (Paddle's
``incubate.nn.functional`` fused ops), with its flag logic. Attention
runs the flash-attention kernels (``ops/flash_attention.py``; the plain
version on a CPU tensor). With ``FLAGS_fused_kernels`` set, the
feed-forward runs the fused kernels of ``ops/fused_kernels.py``: pre-LN
as one ``fused_ln_mlp(ln_scale=..., residual=True)``; post-LN as
``fused_ln_mlp(ln_scale=None, residual=False)`` followed by
``fused_add_layernorm(x, mlp, ln_w, ln_b)``. Unset, it is the composed
math. The LayerNorms of both ops are ``F.layer_norm``'s, which returns
x's dtype, so a bf16 block stays bf16 beside f32 LayerNorm parameters,
as in Paddle. Both forms use the tanh form of gelu (``jax.nn.gelu``'s
default, which the JAX package's fused ops call), where ``F.gelu`` and
the composed ``TransformerEncoderLayer`` default to the exact erf form.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ..core import flags
from ..framework.core import apply_op
from ..monitor.stats import FUSED_KERNEL_CALLS
from ..nn.functional.norm import _layer_norm as _functional_layer_norm
from .flash_attention import flash_attention_arrays
from .fused_kernels import fused_add_layernorm, fused_ln_mlp

__all__ = ["fused_multi_head_attention", "fused_feedforward"]


def _layer_norm(x, w, b, eps):
    return _functional_layer_norm(x, w, b, (x.shape[-1],), eps)


def _fused_mha(x, qkv_w, qkv_b, out_w, out_b, ln_w, ln_b, num_heads,
               pre_ln, causal, eps):
    b, s, d = x.shape
    hd = d // num_heads
    residual = x
    if pre_ln:
        x = _layer_norm(x, ln_w, ln_b, eps)
    q, k, v = (x @ qkv_w + qkv_b).split(d, dim=-1)   # [b, s, 3d]

    def heads(t):
        return t.reshape(b, s, num_heads, hd).transpose(1, 2).contiguous()

    o = flash_attention_arrays(heads(q), heads(k), heads(v), causal=causal)
    o = o.transpose(1, 2).reshape(b, s, d) @ out_w + out_b
    y = residual + o
    return y if pre_ln else _layer_norm(y, ln_w, ln_b, eps)


def fused_multi_head_attention(x, qkv_weight, qkv_bias, linear_weight,
                               linear_bias, ln_scale, ln_bias, num_heads,
                               pre_layer_norm=False, causal=False,
                               epsilon=1e-5, name=None):
    """x [b, s, d]; qkv_weight (d, 3d) holding the q, k and v projections
    side by side, linear_weight (d, d); the residual add and the
    LayerNorm before (pre-LN) or after (post-LN) the attention."""
    return apply_op(_fused_mha, x, qkv_weight, qkv_bias, linear_weight,
                    linear_bias, ln_scale, ln_bias,
                    num_heads=int(num_heads), pre_ln=bool(pre_layer_norm),
                    causal=bool(causal), eps=float(epsilon))


def _fused_ffn(x, w1, b1, w2, b2, ln_w, ln_b, pre_ln, act, eps):
    if flags.fused_kernels[0]:
        if pre_ln:
            return fused_ln_mlp(x, w1, b1, w2, b2, ln_scale=ln_w,
                                ln_bias=ln_b, residual=True, act=act,
                                eps=eps)
        mlp = fused_ln_mlp(x, w1, b1, w2, b2, ln_scale=None, residual=False,
                           act=act, eps=eps)
        return fused_add_layernorm(x, mlp, ln_w, ln_b, eps=eps)
    residual = x
    if pre_ln:
        x = _layer_norm(x, ln_w, ln_b, eps)
    hdn = x @ w1 + b1
    hdn = (TF.gelu(hdn, approximate="tanh") if act == "gelu"
           else torch.relu(hdn))
    y = residual + (hdn @ w2 + b2)
    return y if pre_ln else _layer_norm(y, ln_w, ln_b, eps)


def fused_feedforward(x, linear1_weight, linear1_bias, linear2_weight,
                      linear2_bias, ln_scale, ln_bias, pre_layer_norm=False,
                      activation="relu", epsilon=1e-5, name=None):
    """The transformer block's feed-forward half with its residual and
    LayerNorm: ``LN(x + act(x·W1 + b1)·W2 + b2)`` (post-LN) or
    ``x + act(LN(x)·W1 + b1)·W2 + b2`` (pre-LN); activation "gelu",
    "relu" or any other (the composed form runs relu for it, as JAX does)."""
    if flags.fused_kernels[0]:
        FUSED_KERNEL_CALLS.add()
    return apply_op(_fused_ffn, x, linear1_weight, linear1_bias,
                    linear2_weight, linear2_bias, ln_scale, ln_bias,
                    pre_ln=bool(pre_layer_norm), act=activation,
                    eps=float(epsilon))
