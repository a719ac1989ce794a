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
           "is_compiled_with_cuda", "CPUPlace", "CUDAPlace",
           "CUDAPinnedPlace", "NPUPlace", "XPUPlace"]


class _Place:
    """A Paddle place (``paddle_tpu/device/__init__.py``'s ``_Place``):
    where ``Executor(place)`` runs a program. ``torch_device`` is its
    torch device; an accelerator place (CUDA, and as the JAX package
    maps them to its accelerator, NPU and XPU) is the card."""

    device_type = "unknown"

    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    def __repr__(self):
        return f"{type(self).__name__}({self.device_id})"

    def __eq__(self, other):
        return (isinstance(other, _Place)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def get_device_id(self):
        return self.device_id

    @property
    def torch_device(self) -> torch.device:
        if self.device_type == "cpu":
            return torch.device("cpu")
        return resolve_device(torch.device("cuda", self.device_id))


class CPUPlace(_Place):
    device_type = "cpu"

    def __init__(self, device_id: int = 0):
        super().__init__(device_id)


class CUDAPlace(_Place):
    device_type = "gpu"


class XPUPlace(CUDAPlace):
    pass


class NPUPlace(CUDAPlace):
    pass


class CUDAPinnedPlace(CPUPlace):
    pass

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
