"""``paddle.save`` / ``paddle.load`` (``paddle_tpu/framework/io.py``;
reference python/paddle/framework/io.py:553 save, :769 load).

A saved object is a pickle of the object with every Tensor replaced by a
:class:`_TensorPickle` holding its numpy array, the JAX package's file
layout. A bf16 tensor is stored as its raw 16-bit words with
``dtype = "bfloat16"`` beside them (numpy has no bf16 of its own; the
RPC codec of ``serving/rpc.py`` does the same).

The port reads ``.pdparams`` / ``.pdopt`` files the JAX package wrote:
the unpickler maps the NAME ``paddle_tpu.framework.io._TensorPickle`` to
this module's class and never imports the JAX package; an array that
arrives as an ``ml_dtypes`` bfloat16 array (the JAX package's bf16)
becomes a ``torch.bfloat16`` tensor from its 16-bit words. ``load``
gives Tensors on the current device, or numpy arrays with
``return_numpy=True`` (bf16 as f32 there, as ``Tensor.numpy()`` gives
it).
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from ..device import current_device
from .core import Tensor

__all__ = ["save", "load"]


class _TensorPickle:
    """Pickle wrapper marking an array to restore as a Tensor; ``dtype``
    is "bfloat16" when ``array`` holds bf16 words as uint16."""

    dtype = None

    def __init__(self, array, dtype=None):
        self.array = array
        if dtype is not None:
            self.dtype = dtype

    def torch(self) -> torch.Tensor:
        arr = self.array
        if self.dtype == "bfloat16" or arr.dtype.name == "bfloat16":
            words = np.ascontiguousarray(arr).view(np.uint16)
            return torch.from_numpy(words.astype(np.int16, copy=True)).view(
                torch.bfloat16)
        return torch.from_numpy(np.array(arr, copy=True))


class _Unpickler(pickle.Unpickler):
    """Maps the JAX package's wrapper class to the port's by name."""

    _NAMES = {("paddle_tpu.framework.io", "_TensorPickle"),
              ("paddle_tpu_torch.framework.io", "_TensorPickle")}

    def find_class(self, module, name):
        if (module, name) in self._NAMES:
            return _TensorPickle
        return super().find_class(module, name)


def _to_savable(obj):
    if isinstance(obj, (Tensor, torch.Tensor)):
        t = (obj._data if isinstance(obj, Tensor) else obj).detach().cpu()
        if t.dtype == torch.bfloat16:
            return _TensorPickle(t.view(torch.int16).numpy().view(np.uint16)
                                 .copy(), "bfloat16")
        return _TensorPickle(t.numpy().copy())
    if isinstance(obj, dict):
        return {k: _to_savable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [_to_savable(v) for v in obj]
        return t if isinstance(obj, list) else tuple(t)
    return obj


def _from_savable(obj, return_numpy=False):
    if isinstance(obj, _TensorPickle):
        t = obj.torch()
        if return_numpy:
            return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        return Tensor(t.to(current_device()))
    if isinstance(obj, dict):
        return {k: _from_savable(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [_from_savable(v, return_numpy) for v in obj]
        return t if isinstance(obj, list) else tuple(t)
    return obj


def save(obj, path, protocol=4, **configs):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_to_savable(obj), f, protocol=protocol)


def load(path, **configs):
    return_numpy = configs.get("return_numpy", False)
    with open(path, "rb") as f:
        obj = _Unpickler(f).load()
    return _from_savable(obj, return_numpy)
