"""Eager Tensor, op dispatch and autograd of the Paddle surface.

Counterpart of ``paddle_tpu/framework/core.py``. A :class:`Tensor`
wraps a ``torch.Tensor`` (``_data``): ``stop_gradient`` is the negation
of ``requires_grad``, ``.grad`` is a Tensor view of the torch leaf's
``.grad``, :meth:`Tensor.backward` is ``torch.autograd.backward`` and
:func:`grad` is ``torch.autograd.grad``. :func:`apply_op` unwraps its
Tensor arguments, calls a function on torch tensors and wraps what it
returns; torch autograd records the graph. The JAX package's tape, its
grad-jit cache and its static-mode dispatch hook are its own machinery
for what torch autograd does here, and have no counterpart.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import numpy as np
import torch

from ..device import current_device
from . import dtype as dtypes

__all__ = [
    "Tensor", "Parameter", "apply_op", "backward", "grad", "no_grad",
    "enable_grad", "is_grad_enabled", "set_grad_enabled", "to_tensor",
    "AsyncLoss",
]


# --------------------------------------------------------------------------
# grad mode (torch's thread-local switch)
# --------------------------------------------------------------------------

def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()


def set_grad_enabled(enabled: bool):
    torch.set_grad_enabled(bool(enabled))


class _GradMode:
    _mode = False

    def __enter__(self):
        self._prev = torch.is_grad_enabled()
        torch.set_grad_enabled(self._mode)
        return self

    def __exit__(self, *exc):
        torch.set_grad_enabled(self._prev)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*a, **k):
            with type(self)():
                return fn(*a, **k)

        return wrapper


class no_grad(_GradMode):
    """Context manager and decorator that records no graph
    (``paddle.no_grad``)."""

    _mode = False


class enable_grad(_GradMode):
    _mode = True


# --------------------------------------------------------------------------
# Tensor
# --------------------------------------------------------------------------

def _unwrap(x):
    return x._data if isinstance(x, Tensor) else x


def _as_torch(data, dtype=None, device=None) -> torch.Tensor:
    """Python or numpy data → a torch tensor on ``device`` (default: the
    current device). A Python/numpy float64 becomes the default float
    dtype unless ``dtype`` says otherwise, as in Paddle."""
    dev = device if device is not None else current_device()
    arr = np.asarray(data)
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        # ml_dtypes bfloat16 (the JAX package's numpy arrays)
        arr = arr.astype(np.float32)
        dtype = dtype or torch.bfloat16
    if dtype is None and arr.dtype == np.float64:
        dtype = dtypes.default_float_dtype()
    # a copy: the tensor never aliases the caller's (maybe read-only)
    # array
    return torch.tensor(arr).to(device=dev, dtype=dtype)


class Tensor:
    """Eager tensor: a named wrapper over a ``torch.Tensor``.

    ``stop_gradient`` defaults to True as in Paddle; a :class:`Parameter`
    and the output of an op on a tensor that needs a gradient have it
    False."""

    __slots__ = ("_data", "name", "persistable", "__weakref__")

    # let Tensor win in  np_array * tensor
    __array_priority__ = 100

    def __init__(self, data, stop_gradient: bool = True,
                 name: Optional[str] = None):
        if isinstance(data, Tensor):
            data = data._data
        if not isinstance(data, torch.Tensor):
            data = _as_torch(data)
        self._data = data.detach() if data.requires_grad else data
        self.name = name
        self.persistable = False
        if not stop_gradient:
            self.stop_gradient = False

    @classmethod
    def _wrap(cls, data: torch.Tensor) -> "Tensor":
        """Wrap an op's output as it is (its graph and requires_grad)."""
        t = Tensor.__new__(Tensor)
        t._data = data
        t.name = None
        t.persistable = False
        return t

    # -- autograd ----------------------------------------------------------
    @property
    def stop_gradient(self) -> bool:
        return not self._data.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value):
        if value:
            if self._data.is_leaf:
                self._data.requires_grad_(False)
            else:
                self._data = self._data.detach()
        elif self._data.is_leaf and not self._data.requires_grad:
            self._data.requires_grad_(True)

    @property
    def grad(self) -> Optional["Tensor"]:
        """The accumulated gradient of a leaf (None before a backward,
        after clear_grad, and on a non-leaf)."""
        if not self._data.is_leaf or self._data.grad is None:
            return None
        return Tensor._wrap(self._data.grad)

    @grad.setter
    def grad(self, value):
        self._data.grad = None if value is None else _unwrap(value)

    @property
    def is_leaf(self) -> bool:
        return self._data.is_leaf

    def backward(self, grad_tensor=None, retain_graph: bool = False):
        backward(self, grad_tensor, retain_graph=retain_graph)

    def clear_grad(self):
        self._data.grad = None

    def detach(self):
        return Tensor(self._data.detach(), name=self.name)

    # -- basic properties ---------------------------------------------------
    @property
    def shape(self):
        return list(self._data.shape)

    @property
    def dtype(self):
        return self._data.dtype

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def size(self):
        return self._data.numel()

    @property
    def place(self) -> torch.device:
        return self._data.device

    def numpy(self):
        """A numpy copy on the host (never a view of the tensor); bf16
        comes back as float32 (numpy has no bfloat16)."""
        d = self._data.detach()
        if d.dtype == torch.bfloat16:
            d = d.float()
        return d.cpu().numpy().copy()

    def item(self, *args):
        return self.numpy().item(*args)

    def tolist(self):
        return self.numpy().tolist()

    def clone(self):
        return Tensor._wrap(self._data.clone())

    def astype(self, dtype):
        return Tensor._wrap(self._data.to(dtypes.convert_dtype(dtype)))

    # -- value mutation (state loading) --------------------------------------
    def set_value(self, value):
        value = _unwrap(value)
        if not isinstance(value, torch.Tensor):
            value = _as_torch(value, device=self._data.device)
        if tuple(value.shape) != tuple(self._data.shape):
            raise ValueError(f"set_value shape mismatch: "
                             f"{tuple(value.shape)} vs "
                             f"{tuple(self._data.shape)}")
        with torch.no_grad():
            self._data.copy_(value)

    # -- Python protocol ------------------------------------------------------
    def __repr__(self):
        return (f"Tensor(shape={self.shape}, dtype="
                f"{dtypes.dtype_name(self.dtype)}, place={self.place}, "
                f"stop_gradient={self.stop_gradient},\n       "
                f"{self.numpy()})")

    def __bool__(self):
        return bool(self._data.detach())

    def __int__(self):
        return int(self._data.detach())

    def __float__(self):
        return float(self._data.detach())

    def __hash__(self):
        return id(self)

    # arithmetic dunders and op methods are attached in
    # paddle_tpu_torch/tensor/__init__.py


class Parameter(Tensor):
    """Trainable tensor: a torch leaf, ``stop_gradient=False`` unless not
    trainable, persistable (``paddle_tpu``'s ``Parameter``)."""

    __slots__ = ("trainable", "optimize_attr", "regularizer", "need_clip",
                 "is_distributed")

    def __init__(self, data, name=None, trainable=True):
        data = _unwrap(data)
        if not isinstance(data, torch.Tensor):
            data = _as_torch(data)
        super().__init__(data.detach(), stop_gradient=not trainable,
                         name=name)
        self.persistable = True
        self.trainable = trainable
        self.optimize_attr = {"learning_rate": 1.0}
        self.regularizer = None
        self.need_clip = True
        self.is_distributed = False


class AsyncLoss(Tensor):
    """Loss handle of an asynchronous (``FLAGS_fast_step``) train step
    (``paddle_tpu/framework/core.py``'s ``AsyncLoss``).

    The step is queued on the card and not waited for; the handle acts
    as any scalar Tensor, and its first host read (``float()``,
    ``numpy()``, ``item()``, ``bool()``...) is the sync point, counted
    once per handle by the ``step_async_syncs`` gauge."""

    __slots__ = ("_synced",)

    def __init__(self, data, name=None):
        super().__init__(data, stop_gradient=True, name=name)
        self._synced = False

    def _materialize(self):
        if not self._synced:
            self._synced = True
            from ..monitor.stats import STEP_ASYNC_SYNCS

            STEP_ASYNC_SYNCS.add()

    def numpy(self):
        self._materialize()
        return super().numpy()

    def item(self, *args):
        self._materialize()
        return super().item(*args)

    def tolist(self):
        self._materialize()
        return super().tolist()

    def __float__(self):
        self._materialize()
        return super().__float__()

    def __int__(self):
        self._materialize()
        return super().__int__()

    def __bool__(self):
        self._materialize()
        return super().__bool__()

    def __array__(self, dtype=None, copy=None):
        self._materialize()
        a = super().numpy()
        return a.astype(dtype) if dtype is not None else a


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """paddle.to_tensor parity: a new leaf Tensor on ``place`` (default:
    the current device, the card unless ``set_device("cpu")``)."""
    d = dtypes.convert_dtype(dtype)
    dev = None if place is None else torch.device(
        "cuda" if str(place).startswith("gpu") else place)
    if isinstance(data, (list, tuple)) and any(
            isinstance(x, Tensor) for x in data):
        data = [x.numpy() if isinstance(x, Tensor) else x for x in data]
    if isinstance(data, Tensor):
        data = data._data
    if isinstance(data, torch.Tensor):
        arr = data.detach().to(device=dev or current_device(), dtype=d)
        if arr is data:
            arr = arr.clone()
    else:
        arr = _as_torch(data, dtype=d, device=dev)
    return Tensor(arr, stop_gradient=stop_gradient)


# --------------------------------------------------------------------------
# dispatch and autograd
# --------------------------------------------------------------------------

def apply_op(fn: Callable, *args, op_name: Optional[str] = None, **attrs):
    """Run ``fn(*torch_tensors, **attrs)`` on the unwrapped arguments and
    wrap the result (a Tensor, or a tuple of them for a tuple). torch
    autograd records the op when an input needs a gradient."""
    out = fn(*(_unwrap(a) for a in args), **attrs)
    if isinstance(out, (tuple, list)):
        return tuple(Tensor._wrap(o) for o in out)
    return Tensor._wrap(out)


def _seed_grad(t: torch.Tensor, g):
    if g is None:
        return torch.ones_like(t)
    g = _unwrap(g)
    if not isinstance(g, torch.Tensor):
        g = _as_torch(g, device=t.device)
    return g.to(t.dtype)


def backward(tensor: Tensor, grad_tensor=None, retain_graph: bool = False):
    """Accumulate d(tensor)/d(leaf) into every leaf's ``.grad`` (a tensor
    of any shape: the seed defaults to ones, as in Paddle)."""
    t = tensor._data
    if not t.requires_grad:
        return
    torch.autograd.backward(t, _seed_grad(t, grad_tensor),
                            retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """paddle.grad parity: the gradients of ``outputs`` w.r.t.
    ``inputs`` as Tensors, without touching any ``.grad``.
    ``no_grad_vars`` is not ported yet."""
    if no_grad_vars:
        raise NotImplementedError("paddle.grad(no_grad_vars=...) is not "
                                  "ported to paddle_tpu_torch yet")
    outs = outputs if isinstance(outputs, (list, tuple)) else [outputs]
    ins = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    if grad_outputs is None:
        grad_outputs = [None] * len(outs)
    elif not isinstance(grad_outputs, (list, tuple)):
        grad_outputs = [grad_outputs]
    if retain_graph is None:
        retain_graph = bool(create_graph)
    touts = [o._data for o in outs]
    gs = torch.autograd.grad(
        touts, [i._data for i in ins],
        [_seed_grad(t, g) for t, g in zip(touts, grad_outputs)],
        retain_graph=retain_graph, create_graph=create_graph,
        allow_unused=allow_unused)
    return [None if g is None else Tensor._wrap(g) for g in gs]
