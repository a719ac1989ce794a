"""Layers of the port: the MoE routing functions (``nn/moe.py``)."""
from .moe import moe_capacity, moe_ffn, moe_route

__all__ = ["moe_capacity", "moe_ffn", "moe_route"]
