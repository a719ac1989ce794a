"""Paddle dtype names on torch dtypes.

Counterpart of ``paddle_tpu/framework/dtype.py``: the names
(``float32``, ``bfloat16``, ``int64``, ...) are torch dtypes here, and
:func:`convert_dtype` takes a name, a torch dtype or a numpy dtype.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "bool", "uint8", "int8", "int16", "int32", "int64", "float16",
    "bfloat16", "float32", "float64", "complex64", "complex128",
    "dtype", "set_default_dtype", "get_default_dtype", "convert_dtype",
]

_NAME_TO_DTYPE = {
    "bool": torch.bool,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
    "complex64": torch.complex64,
    "complex128": torch.complex128,
}
_DTYPE_TO_NAME = {v: k for k, v in _NAME_TO_DTYPE.items()}

bool = torch.bool  # noqa: A001 - mirrors paddle.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128
# paddle.dtype: the type of every dtype above (``np.dtype`` in the JAX
# package), so ``isinstance(t.dtype, paddle.dtype)`` holds
dtype = torch.dtype

_DEFAULT_DTYPE = [torch.float32]


def set_default_dtype(d):
    """paddle.set_default_dtype parity."""
    _DEFAULT_DTYPE[0] = convert_dtype(d)


def get_default_dtype() -> str:
    return _DTYPE_TO_NAME[_DEFAULT_DTYPE[0]]


def default_float_dtype() -> torch.dtype:
    return _DEFAULT_DTYPE[0]


def convert_dtype(dtype):
    """Any dtype spec (name, torch dtype, numpy dtype or type) → torch
    dtype; None stays None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    if name not in _NAME_TO_DTYPE:
        raise ValueError(f"Unknown dtype {dtype!r}")
    return _NAME_TO_DTYPE[name]


def dtype_name(dtype) -> str:
    return _DTYPE_TO_NAME[convert_dtype(dtype)]
