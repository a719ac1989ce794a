"""paddle_tpu_torch.optimizer — the eager optimizers of the Paddle
surface (``optimizer/optimizer.py``)."""
from .optimizer import SGD, Adam, AdamW, Lamb, Momentum, Optimizer

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Lamb"]
