"""fluid.initializer (reference fluid/initializer.py): the 2.x
initializers and their 1.x names (``paddle_tpu/nn/initializer``'s
aliases: Xavier is uniform, MSRA is Kaiming normal). ``Bilinear``,
``Dirac``, ``Orthogonal`` and ``set_global_initializer`` are not in the
port's ``nn.initializer`` yet and are left out."""
from __future__ import annotations

import numpy as np
import torch

from ..framework.core import Tensor
from ..nn.initializer import (  # noqa: F401
    Constant, Initializer, KaimingNormal, KaimingUniform, Normal,
    TruncatedNormal, Uniform, XavierNormal, XavierUniform,
)


class Assign(Initializer):
    """A parameter's value given as an array (or Tensor), reshaped to
    the parameter's shape."""

    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype=None, device=None):
        v = self.value
        arr = v.numpy() if isinstance(v, Tensor) else np.asarray(v)
        t = torch.as_tensor(np.ascontiguousarray(arr), dtype=dtype,
                            device=device)
        return t.reshape(tuple(shape)) if tuple(t.shape) != tuple(shape) \
            else t


ConstantInitializer = Constant
NormalInitializer = Normal
UniformInitializer = Uniform
XavierInitializer = XavierUniform
MSRAInitializer = KaimingNormal
TruncatedNormalInitializer = TruncatedNormal
NumpyArrayInitializer = Assign
Xavier = XavierInitializer
MSRA = MSRAInitializer
