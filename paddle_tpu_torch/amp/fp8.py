"""fp8 (e4m3) training support: quantization, scaling state and the
differentiable fp8 matmul.

Counterpart of ``paddle_tpu/amp/fp8.py``; the kernel lives in
``ops/fp8_matmul.py``. Two per-tensor scaling modes:

- **just-in-time** (:func:`fp8_linear`): scale = amax(tensor) / 448,
  computed on the device on the spot (the GPT MLP wiring,
  ``GPTConfig(fp8=True)`` / ``FLAGS_fp8_matmul``);
- **delayed** (:func:`init_delayed_state` / :func:`delayed_scale` /
  :func:`update_delayed_state`): quantize with the scale of a rolling
  amax history, then record this step's amax. The state is a dict of
  tensors ``{"amax_history": (window,) f32, "scale": () f32}``, and the
  functions are pure (they return a new state); :class:`DelayedScaling`
  keeps named states with a ``state_dict`` / ``load_state_dict``
  surface.

Gradients: the fp8 matmul is a ``torch.autograd.Function`` whose
backward is JAX's straight-through estimator: the products against the
dequantized operands (the e4m3 codes as bf16, the cotangent rounded to
bf16), summed in f32, times the other operand's scale, then one cast;
no gradient flows into the scales. Those two products are plain matmuls
outside any kernel: on the card a bf16 GEMM with f32 output
(``torch.mm(..., out_dtype=torch.float32)``), on the CPU an f32 matmul
of the bf16-rounded operands; both sum exact products in f32.
"""
from __future__ import annotations

import torch

from .. import resolve_device
from ..ops.fp8_matmul import E4M3_MAX, fp8_matmul_arrays

__all__ = ["E4M3_MAX", "quantize_fp8", "fp8_linear", "init_delayed_state",
           "delayed_scale", "update_delayed_state", "fp8_linear_delayed",
           "DelayedScaling"]


def _f32(value, device):
    return torch.as_tensor(value, dtype=torch.float32, device=device)


def quantize_fp8(x, scale, *, k_major=False):
    """x / scale in f32, saturated to the e4m3 range, cast to
    float8_e4m3fn (round half to even). ``scale`` is floored at 1e-12.

    ``k_major=True``, for a weight x (K, N): the same cast writes the
    codes straight into an (N, K)-contiguous buffer, and the result is its
    (K, N) column-major view, which the fp8 kernel reads in place (it
    takes the weight K-major). The values are bit-identical."""
    s = torch.clamp(_f32(scale, x.device), min=1e-12)
    q = torch.clamp(x.float() / s, -E4M3_MAX, E4M3_MAX)
    if not k_major:
        return q.to(torch.float8_e4m3fn)
    buf = torch.empty((x.shape[1], x.shape[0]), dtype=torch.float8_e4m3fn,
                      device=x.device)
    buf.t().copy_(q)
    return buf.t()


def _amax(t):
    return t.detach().float().abs().max()


def _scale_of(amax):
    """max(amax, 1e-12) / 448 as an f32 tensor division (dividing a CUDA
    tensor by a Python number multiplies by its reciprocal, which can
    differ from JAX's division in the last bit)."""
    return torch.clamp(amax, min=1e-12) / _f32(E4M3_MAX, amax.device)


def _jit_scale(t):
    """Just-in-time per-tensor scale: amax / 448 (no gradient)."""
    return _scale_of(_amax(t))


def _mm_f32(a, b):
    """a @ b of bf16 operands with the sum in f32 and an f32 result."""
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _Fp8MM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, sx, sw):
        xq = quantize_fp8(x, sx)
        wq = quantize_fp8(w, sw, k_major=True)
        ctx.save_for_backward(xq, wq, sx, sw)
        ctx.dtypes = (x.dtype, w.dtype)
        return fp8_matmul_arrays(xq, wq, sx, sw, out_dtype=x.dtype)

    @staticmethod
    def backward(ctx, g):
        # STE: grads against the dequantized operands, bf16 operands with
        # f32 sums, times the other operand's scale, then one cast
        xq, wq, sx, sw = ctx.saved_tensors
        xdt, wdt = ctx.dtypes
        K, N = wq.shape
        g16 = g.to(torch.bfloat16).reshape(-1, N)
        xd = xq.to(torch.bfloat16).reshape(-1, K)
        wd = wq.to(torch.bfloat16)
        dx = _mm_f32(g16, wd.t()) * sw
        dw = _mm_f32(xd.t(), g16) * sx
        return (dx.reshape(*xq.shape).to(xdt), dw.to(wdt), None, None)


def _fp8_mm(x, w, sx, sw):
    return _Fp8MM.apply(x, w, _f32(sx, x.device), _f32(sw, x.device))


def fp8_linear(x, w, bias=None):
    """``x @ w (+ bias)`` through the fp8 kernel, just-in-time per-tensor
    scaling, STE gradients. x [..., K] fp; w [K, N] fp; the bias is added
    outside the kernel in the output dtype, as in JAX."""
    y = _fp8_mm(x, w, _jit_scale(x), _jit_scale(w))
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


# -- delayed scaling ---------------------------------------------------------

def init_delayed_state(window: int = 16, device=None):
    """Fresh per-tensor delayed-scaling state on ``device`` (None: the
    card)."""
    dev = resolve_device(device)
    return {"amax_history": torch.zeros((int(window),), dtype=torch.float32,
                                        device=dev),
            "scale": torch.ones((), dtype=torch.float32, device=dev)}


def delayed_scale(state):
    """The scale the CURRENT step quantizes with (history max)."""
    return state["scale"]


def update_delayed_state(state, t):
    """Record ``amax(t)`` and refresh the scale from the history max.
    Returns a new state; the given one is not modified."""
    hist = torch.roll(state["amax_history"], 1).clone()
    hist[0] = _amax(t).to(hist.device)
    return {"amax_history": hist, "scale": _scale_of(hist.max())}


def fp8_linear_delayed(x, w, x_state, w_state, bias=None):
    """Delayed-scaling fp8 linear: quantize with the HISTORY scales, then
    record this step's amaxes. Returns (y, new_x_state, new_w_state)."""
    y = _fp8_mm(x, w, delayed_scale(x_state), delayed_scale(w_state))
    if bias is not None:
        y = y + bias.to(y.dtype)
    return (y, update_delayed_state(x_state, x),
            update_delayed_state(w_state, w))


class DelayedScaling:
    """Named delayed-scaling states with a checkpoint surface.

        fp8 = DelayedScaling(window=16)
        y, fp8["fc_x"], fp8["fc_w"] = fp8_linear_delayed(
            x, w, fp8["fc_x"], fp8["fc_w"])
        ckpt["fp8"] = fp8.state_dict()     # nested dict of numpy arrays
        fp8.load_state_dict(ckpt["fp8"])   # exact round trip

    States are made and loaded on ``device`` (None: the card)."""

    def __init__(self, window: int = 16, device=None):
        self._window = int(window)
        self._device = resolve_device(device)
        self._states: dict = {}

    def __getitem__(self, name):
        if name not in self._states:
            self._states[name] = init_delayed_state(self._window,
                                                    self._device)
        return self._states[name]

    def __setitem__(self, name, state):
        self._states[name] = state

    def names(self):
        return sorted(self._states)

    def state_dict(self):
        return {name: {k: st[k].cpu().numpy().copy()
                       for k in ("amax_history", "scale")}
                for name, st in self._states.items()}

    def load_state_dict(self, d):
        for name, st in d.items():
            self._states[name] = {
                "amax_history": torch.tensor(st["amax_history"],
                                             dtype=torch.float32,
                                             device=self._device),
                "scale": torch.tensor(st["scale"], dtype=torch.float32,
                                      device=self._device)}
