"""Hand-written CUDA kernels of the port and their plain PyTorch versions,
and the fused transformer ops of the Paddle surface (``ops/fused.py``)."""
from .fused import fused_feedforward, fused_multi_head_attention
from .fused_kernels import fused_add_layernorm, fused_ln_mlp

__all__ = ["fused_feedforward", "fused_multi_head_attention",
           "fused_add_layernorm", "fused_ln_mlp"]
