"""Device selection for the eager Paddle surface.

Counterpart of ``paddle_tpu/device/__init__.py``. The default device is
the card: until :func:`set_device` is called, every tensor and
parameter the Paddle surface makes goes to the current CUDA device, and
without a GPU that raises (``resolve_device``). ``set_device("cpu")`` is
the only way onto the CPU, where every kernel wrapper runs its plain
PyTorch version.
"""
from __future__ import annotations

import torch

from .. import resolve_device

__all__ = ["set_device", "get_device", "device_count",
           "is_compiled_with_cuda"]

# the device set by set_device; None = the card
_current = [None]


def set_device(device):
    """paddle.set_device parity: "cpu", "gpu", "gpu:1", "cuda:0" or a
    ``torch.device``. A GPU request without a GPU raises."""
    if isinstance(device, str):
        name, _, idx = device.partition(":")
        if name == "gpu":
            device = "cuda" + (f":{idx}" if idx else "")
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"set_device takes 'cpu' or 'gpu[:i]', got "
                         f"{device!r}")
    _current[0] = resolve_device(dev)
    return _current[0]


def current_device() -> torch.device:
    """The device new tensors go to: the one set, else the card."""
    return _current[0] if _current[0] is not None else resolve_device(None)


def get_device() -> str:
    """"cpu" or "gpu:<index>", as Paddle names them."""
    dev = current_device()
    return "cpu" if dev.type == "cpu" else f"gpu:{dev.index}"


def device_count() -> int:
    return torch.cuda.device_count()


def is_compiled_with_cuda() -> bool:
    return torch.backends.cuda.is_built()
