"""PyTorch + CUDA port of ``paddle_tpu`` for NVIDIA Hopper (H100).

The package mirrors ``paddle_tpu``'s module paths (``models/gpt.py``,
``serving/engine.py``, ``ops/flash_attention.py``, ...) so each
counterpart is easy to find. Plain tensor code is PyTorch; every Pallas
TPU kernel on a ported path is a hand-written CUDA kernel for ``sm_90a``
under ``csrc/``, built with ``nvcc`` at first use (``ops/_build.py``).

It imports ``torch`` and never ``jax`` or ``paddle_tpu``: whatever it
needs from the JAX package it keeps its own copy of.

Device rule: entry points run on the card. ``device=None`` resolves to
``cuda``; without a GPU that raises unless the caller asked for the CPU
(``device="cpu"``), where every kernel wrapper runs its plain PyTorch
version instead.

The package is also the eager Paddle surface (``import paddle_tpu_torch
as paddle``): ``paddle.to_tensor``, ``Tensor``, ``nn``,
``nn.functional``, ``autograd`` (``PyLayer``), ``optimizer``, ``ops``
(the fused transformer ops),
``amp`` (``auto_cast``, ``decorate``, ``GradScaler``), ``vision``
(LeNet and the ResNets), the training entry points (``jit``'s
``TrainStep`` and ``to_static``, ``optimizer.lr``, ``nn.ClipGrad*``,
``io`` (``DataLoader``, ``DevicePrefetcher``), ``metric``, ``Model``
and ``callbacks``, ``summary``, ``save`` / ``load``), the tensor ops at
the top level (creation, math, manipulation, logic, search, linalg,
``einsum``, random sampling) and ``linalg``, ``seed``, ``set_flags`` / ``get_flags`` and
``set_device``. Its tensors and
parameters go to the card unless ``paddle.set_device("cpu")`` was
called. Importing it builds nothing.
"""
from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """``None`` → the current CUDA device; a CUDA device without a GPU
    raises ``RuntimeError`` (never a silent CPU run); ``"cpu"`` is
    honoured."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' (or call "
                "paddle_tpu_torch.set_device('cpu')) to run the plain "
                "PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


# the Paddle surface (imported after resolve_device, which it uses)
from . import (amp, autograd, device, io, jit, metric, nn,  # noqa: E402
               ops, optimizer, regularizer, tensor, vision)
from .core.flags import get_flag as _get_flag  # noqa: E402
from .core.flags import set_flag as _set_flag  # noqa: E402
from .device import (device_count, get_device,  # noqa: E402
                     is_compiled_with_cuda, set_device)
from .framework.core import (Parameter, Tensor, enable_grad,  # noqa: E402
                             grad, is_grad_enabled, no_grad,
                             set_grad_enabled)
from .framework.dtype import (bfloat16, bool, complex64,  # noqa: E402,A004
                              complex128, dtype, float16, float32, float64,
                              get_default_dtype, int8, int16, int32, int64,
                              set_default_dtype, uint8)
from .framework.io import load, save  # noqa: E402
from .framework.param_attr import ParamAttr  # noqa: E402
from .hapi import callbacks  # noqa: E402
from .hapi.model import Model  # noqa: E402
from .jit import to_static  # noqa: E402
from .framework.random import get_rng_state, seed, set_rng_state  # noqa: E402
from .tensor import *  # noqa: E402,F401,F403
from . import linalg  # noqa: E402  (after the star import: paddle.linalg)


def set_flags(flags):
    """paddle.set_flags parity: a dict of ``FLAGS_*`` names to values,
    written into ``core/flags.py``'s cells (an unknown name raises)."""
    for k, v in dict(flags).items():
        _set_flag(k, v)


def in_dynamic_mode() -> bool:
    """The port runs eagerly: always True (no static mode yet)."""
    return True


def enable_static():
    raise NotImplementedError(
        "paddle_tpu_torch has no static-graph mode yet (ROADMAP.md Queue 1 "
        "item 8 step 7)")


def summary(net, input_size=None, dtypes=None, input=None):  # noqa: A002
    """paddle.summary: each layer's parameter count and the totals."""
    from .hapi.summary import summary as _summary

    return _summary(net, input_size, dtypes, input)


def get_flags(flags):
    if isinstance(flags, str):
        flags = [flags]
    return {k: _get_flag(k) for k in flags}


__all__ = ["resolve_device", "__version__", "amp", "autograd", "device",
           "io", "jit",
           "metric", "nn", "ops", "optimizer", "regularizer", "tensor",
           "vision", "set_flags", "get_flags", "Model", "callbacks",
           "summary", "save", "load", "to_static", "in_dynamic_mode",
           "enable_static",
           "set_device", "get_device", "device_count",
           "is_compiled_with_cuda", "Tensor", "Parameter", "no_grad",
           "enable_grad", "grad", "is_grad_enabled", "set_grad_enabled",
           "bool", "uint8", "int8", "int16", "int32", "int64", "float16",
           "bfloat16", "float32", "float64", "complex64", "complex128",
           "dtype", "linalg", "set_default_dtype",
           "get_default_dtype", "ParamAttr", "seed", "get_rng_state",
           "set_rng_state"] + tensor.__all__
