"""Regularizers (own copy of ``paddle_tpu/regularizer.py``). The
optimizers read them: an ``L2Decay`` adds ``coeff * p`` to the gradient
(and is the fused eager step's ``l2``), an ``L1Decay`` adds
``coeff * sign(p)``."""
from __future__ import annotations

__all__ = ["L1Decay", "L2Decay"]


class WeightDecayRegularizer:
    pass


class L1Decay(WeightDecayRegularizer):
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __repr__(self):
        return f"L1Decay({self.coeff})"


class L2Decay(WeightDecayRegularizer):
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __repr__(self):
        return f"L2Decay({self.coeff})"
