"""paddle_tpu_torch.optimizer — the optimizers of the Paddle surface
(``optimizer/optimizer.py``) and the LR schedulers (``optimizer/lr.py``)."""
from . import lr  # noqa: F401
from .optimizer import (SGD, Adadelta, Adagrad, Adam, Adamax,  # noqa: F401
                        AdamW, DecayedAdagrad, DecayedAdagradOptimizer, Dpsgd,
                        DpsgdOptimizer, ExponentialMovingAverage, Ftrl,
                        FtrlOptimizer, Lamb, LarsMomentum, Momentum,
                        Optimizer, RMSProp)

__all__ = ["lr", "Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adagrad", "Adadelta", "RMSProp", "Lamb", "LarsMomentum", "Ftrl",
           "FtrlOptimizer", "Dpsgd", "DpsgdOptimizer", "DecayedAdagrad",
           "DecayedAdagradOptimizer", "ExponentialMovingAverage"]
