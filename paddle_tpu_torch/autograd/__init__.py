"""paddle_tpu_torch.autograd (``paddle_tpu/autograd/__init__.py``):
``backward``, ``grad``, ``no_grad`` and ``enable_grad`` from the eager
core, and ``PyLayer`` / ``PyLayerContext``.

A ``PyLayer`` subclass's static ``forward(ctx, *args)`` and
``backward(ctx, *grads)`` run on Tensors; ``apply`` runs them inside a
``torch.autograd.Function``, so torch autograd calls the user's backward
where the JAX package's tape calls its vjp. ``backward`` returns one
gradient a Tensor argument of ``forward``, in order (None for one that
needs none).
"""
from __future__ import annotations

import torch

from ..framework.core import (Tensor, backward, enable_grad, grad,
                              no_grad)

__all__ = ["backward", "grad", "no_grad", "enable_grad", "PyLayer",
           "PyLayerContext"]


class PyLayerContext:
    def __init__(self):
        self._saved = ()
        self.not_inplace_tensors = ()

    def save_for_backward(self, *tensors):
        self._saved = tensors

    @property
    def saved_tensor(self):
        return self._saved

    def saved_tensors(self):
        return self._saved


class _Bridge(torch.autograd.Function):
    """Runs a PyLayer's forward and backward on Tensor views of torch's
    tensors. ``spec`` holds (the PyLayer class, its context, the
    arguments, the keyword arguments, the positions of the Tensor
    arguments, a list that receives whether forward returned a
    sequence)."""

    @staticmethod
    def forward(fctx, spec, *tensors):
        cls, ctx, args, kwargs, slots, multi_out = spec
        full = list(args)
        for i, t in zip(slots, tensors):
            full[i] = Tensor._wrap(t.detach())
        with torch.no_grad():
            out = cls.forward(ctx, *full, **kwargs)
        multi = isinstance(out, (tuple, list))
        multi_out.append(multi)
        outs = tuple(out) if multi else (out,)
        fctx.pylayer = (cls, ctx, len(tensors))
        return tuple(o._data for o in outs)

    @staticmethod
    def backward(fctx, *grads):
        cls, ctx, n = fctx.pylayer
        with torch.no_grad():
            gin = cls.backward(ctx, *(Tensor._wrap(g) for g in grads))
        gin = tuple(gin) if isinstance(gin, (tuple, list)) else (gin,)
        gin = [None if g is None else (g._data if isinstance(g, Tensor)
                                       else g) for g in gin]
        gin = (gin + [None] * n)[:n]
        return (None, *gin)


class PyLayer:
    """A differentiable function given by its forward and backward
    (``paddle.autograd.PyLayer``)."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        ctx = PyLayerContext()
        slots = [i for i, a in enumerate(args) if isinstance(a, Tensor)]
        tensors = [args[i]._data for i in slots]
        multi = []
        outs = _Bridge.apply((cls, ctx, args, kwargs, slots, multi),
                             *tensors)
        wrapped = tuple(Tensor._wrap(o) for o in outs)
        return wrapped if multi[0] else wrapped[0]
