"""Automatic mixed precision (``paddle_tpu/amp/__init__.py``).

``auto_cast`` turns on a thread-local state that the compute-heavy
functionals read through :func:`maybe_autocast`: ``linear``, ``conv*``
and the matmul family cast their floating inputs to the AMP dtype (bf16
by default) through a cast that autograd records, so gradients come back
in each parameter's own dtype. Everything else keeps its dtype: batch
norm computes its statistics in f32 and returns ``x.dtype``, and a bf16
product plus an f32 bias promotes to f32. This is the reference's
explicit funnel, not ``torch.autocast``.

``decorate(level="O2")`` casts every floating parameter to the AMP dtype
except those of batch norm and LayerNorm. ``GradScaler`` scales the loss
for fp16 runs; with bf16 (the default) it is a no-op unless enabled.

Below bf16 sits the fp8 (e4m3) linear (``amp/fp8.py``).
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

import torch

from ..framework import dtype as dtypes
from ..framework.core import Tensor, _as_torch
from .fp8 import (E4M3_MAX, DelayedScaling, delayed_scale, fp8_linear,
                  fp8_linear_delayed, init_delayed_state, quantize_fp8,
                  update_delayed_state)

__all__ = ["auto_cast", "decorate", "GradScaler", "amp_guard", "amp_state",
           "white_list", "black_list", "E4M3_MAX", "DelayedScaling",
           "delayed_scale", "fp8_linear", "fp8_linear_delayed",
           "init_delayed_state", "quantize_fp8", "update_delayed_state"]

# the reference's default allow and deny lists (fp16_lists.py)
white_list = {"matmul", "matmul_v2", "conv2d", "conv1d", "conv3d", "linear",
              "einsum", "bmm", "mm"}
black_list = {"softmax", "log_softmax", "cross_entropy", "exp", "log",
              "mean", "sum", "norm", "layer_norm", "batch_norm",
              "softmax_with_cross_entropy"}


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = torch.bfloat16
        self.level = "O1"


_amp_state = _AmpState()


def _cast(t, dt):
    """A tracked cast of a floating Tensor to ``dt``; anything else as
    it is."""
    if isinstance(t, Tensor) and t._data.is_floating_point() \
            and t._data.dtype != dt:
        from ..tensor.manipulation import cast

        return cast(t, dt)
    return t


def maybe_autocast(*tensors):
    """The white-list cast: under ``auto_cast``, the floating inputs of
    ``linear``, ``conv*`` and the matmul family go to the AMP dtype.
    Returns the inputs as a tuple."""
    if not _amp_state.enabled:
        return tensors
    return tuple(_cast(t, _amp_state.dtype) for t in tensors)


def maybe_cast_to_amp(x):
    """One input of a matmul-class path, cast when AMP is on."""
    return _cast(x, _amp_state.dtype) if _amp_state.enabled else x


def amp_state():
    return _amp_state


def amp_active() -> bool:
    return _amp_state.enabled


def amp_dtype():
    return _amp_state.dtype


@contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    prev = (_amp_state.enabled, _amp_state.dtype, _amp_state.level)
    _amp_state.enabled = bool(enable)
    _amp_state.dtype = dtypes.convert_dtype(dtype)
    _amp_state.level = level
    try:
        yield
    finally:
        _amp_state.enabled, _amp_state.dtype, _amp_state.level = prev


amp_guard = auto_cast


def decorate(models, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2: cast the floating parameters of ``models`` to ``dtype``, those
    of batch norm and LayerNorm excepted (they stay f32). The Parameter
    objects stay the same, so an optimizer holds them before or after."""
    from ..nn.layer.norm import LayerNorm, _BatchNormBase

    def cast_model(m):
        if level == "O2":
            d = dtypes.convert_dtype(dtype)
            for layer in m.sublayers(include_self=True):
                if isinstance(layer, (_BatchNormBase, LayerNorm)):
                    continue
                for p in layer._parameters.values():
                    if p is not None and p._data.is_floating_point():
                        p._data = p._data.detach().to(d).requires_grad_(
                            p.trainable)
        return m

    if isinstance(models, (list, tuple)):
        models = [cast_model(m) for m in models]
    else:
        models = cast_model(models)
    if optimizers is None:
        return models
    return models, optimizers


class GradScaler:
    """Loss scaling (the reference's ``amp/grad_scaler.py``): ``scale``
    multiplies the loss, ``unscale_`` divides every gradient and reads
    one finite flag for all of them, ``step`` skips the optimizer's step
    on a non-finite gradient, ``update`` grows the scale after
    ``incr_every_n_steps`` good steps and shrinks it after
    ``decr_every_n_nan_or_inf`` bad ones."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        if not self._enable:
            return
        params = [p for p in optimizer._parameter_list or []
                  if p.grad is not None]
        if not params:
            self._found_inf = False
            return
        inv = 1.0 / self._scale
        finite = []
        for p in params:
            g = p._data.grad * inv
            p._data.grad = g
            finite.append(torch.isfinite(g).all())
        # one host read for every gradient's flag
        self._found_inf = not bool(torch.stack(finite).all())

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self.update()

    def update(self):
        if not (self._enable and self._dynamic):
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every_n:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every_n_steps:
                self._scale *= self._incr_ratio
                self._good_steps = 0

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self):
        return Tensor(_as_torch(self._scale))

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def state_dict(self):
        return {"scale": self._scale, "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, d):
        self._scale = d.get("scale", self._scale)
        self._good_steps = d.get("good_steps", 0)
        self._bad_steps = d.get("bad_steps", 0)
