"""fluid.optimizer: the 1.x *Optimizer class names (reference
python/paddle/fluid/optimizer.py). ``LookaheadOptimizer`` and
``ModelAverage`` wrap ``paddle.incubate``, which the port does not have
yet: they are left out."""
from ..optimizer import (  # noqa: F401
    Adadelta, Adagrad, Adam, Adamax, AdamW, DecayedAdagrad, Dpsgd, Ftrl,
    Lamb, LarsMomentum, Momentum, RMSProp, SGD, ExponentialMovingAverage,
)

SGDOptimizer = SGD
MomentumOptimizer = Momentum
AdagradOptimizer = Adagrad
AdamOptimizer = Adam
AdamaxOptimizer = Adamax
DpsgdOptimizer = Dpsgd
DecayedAdagradOptimizer = DecayedAdagrad
AdadeltaOptimizer = Adadelta
RMSPropOptimizer = RMSProp
FtrlOptimizer = Ftrl
LambOptimizer = Lamb
LarsMomentumOptimizer = LarsMomentum
