"""Mixed precision of the port: the fp8 (e4m3) linear (``amp/fp8.py``)."""
from .fp8 import (E4M3_MAX, DelayedScaling, delayed_scale, fp8_linear,
                  fp8_linear_delayed, init_delayed_state, quantize_fp8,
                  update_delayed_state)

__all__ = ["E4M3_MAX", "DelayedScaling", "delayed_scale", "fp8_linear",
           "fp8_linear_delayed", "init_delayed_state", "quantize_fp8",
           "update_delayed_state"]
