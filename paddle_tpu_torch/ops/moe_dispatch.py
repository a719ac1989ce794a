"""MoE dispatch: the capacity-slot gather as a hand-written CUDA kernel
(``csrc/moe_dispatch.cu``) beside its plain PyTorch version, and the
composed combine.

Counterpart of ``paddle_tpu/ops/moe_dispatch.py``:

- :func:`moe_dispatch_gather` — ``src`` (E·C,) int32 names the token row
  filling each capacity slot (−1 = empty slot); the result is the
  ``(E·C, H)`` packed expert input with empty slots zeroed, without a
  ``(T, E, C)`` one-hot. A ``torch.autograd.Function``: the backward is
  the transpose scatter-add (``index_add_``), as JAX's ``_gather_bwd``
  is composed jnp.
- :func:`moe_combine_scatter` — the un-permute and top-k mix, composed
  (k plain gathers), as in JAX.

CUDA tensors launch the kernel at any T, N and H (bf16 or f32); CPU
tensors run the plain version. The kernel is a copy, so the two are
bit-identical.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["moe_dispatch_gather", "moe_combine_scatter", "LAUNCHES"]

# kernel launches since the last reset (the wrapper adds one per launch)
LAUNCHES = 0

_ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}
_lib = None


def _gather_reference(x, src):
    """Plain version: rows of ``x`` at ``src`` with empty (negative)
    slots zeroed. x (T, H); src (N,) int → (N, H)."""
    rows = x[src.clamp_min(0).long()]
    return torch.where((src >= 0)[:, None], rows, torch.zeros_like(rows))


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("moe_dispatch")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.moe_gather.argtypes = [p, p, p, i, i, i, i, p]
        lib.moe_gather.restype = i
        lib.ptt_error_string.argtypes = [ctypes.c_int]
        lib.ptt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _launch(x, src):
    global LAUNCHES
    if x.dtype not in _ELEM_BYTES:
        raise TypeError(f"moe gather takes f32 or bf16 rows, got {x.dtype}")
    if x.dim() != 2 or src.dim() != 1:
        raise ValueError(f"x {tuple(x.shape)} / src {tuple(src.shape)} are "
                         "not (T, H) / (N,)")
    if src.dtype != torch.int32:
        raise TypeError(f"src must be int32, got {src.dtype}")
    if src.device != x.device:
        raise ValueError("x and src must lie on one device")
    if not (x.is_contiguous() and src.is_contiguous()):
        raise ValueError("moe gather needs contiguous x and src")
    T, H = x.shape
    N = src.shape[0]
    out = torch.empty((N, H), dtype=x.dtype, device=x.device)
    if N == 0 or H == 0:
        return out             # nothing to copy, no launch
    lib = _load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.moe_gather(x.data_ptr(), src.data_ptr(), out.data_ptr(),
                             T, N, H, _ELEM_BYTES[x.dtype], stream)
    _build.check(lib, err, "moe_gather")
    LAUNCHES += 1
    return out


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, src):
        ctx.save_for_backward(src)
        ctx.n_rows = x.shape[0]
        if x.device.type == "cuda":
            return _launch(x.contiguous(), src.contiguous())
        return _gather_reference(x, src)

    @staticmethod
    def backward(ctx, dy):
        # transpose of the permutation: scatter the slot cotangents back
        # to their source rows; empty slots (clamped to row 0) add exact
        # zeros there
        (src,) = ctx.saved_tensors
        dy = torch.where((src >= 0)[:, None], dy, torch.zeros_like(dy))
        dx = torch.zeros((ctx.n_rows, dy.shape[1]), dtype=dy.dtype,
                         device=dy.device)
        return dx.index_add_(0, src.clamp_min(0).long(), dy), None


def moe_dispatch_gather(x, src):
    """Pack routed token rows into the dense (E·C, H) expert grid.

    x (T, H) — the token activations; src (E·C,) int32 — for capacity
    slot ``e*C + c`` the token row that fills it, or −1 for an empty
    slot. Returns (E·C, H) in x.dtype with empty slots zeroed;
    differentiable in ``x``."""
    return _Gather.apply(x, src.to(torch.int32))


def moe_combine_scatter(out, slot, gates):
    """Un-permute expert outputs back to token order and mix the top-k.

    out (E·C, H) — packed expert outputs; slot (T, k) int — the capacity
    slot each token's rank-r assignment landed in (−1 = dropped); gates
    (T, k) f32 — the normalized router weights. Returns (T, H) in
    out.dtype: ``sum_r gates[t, r] * out[slot[t, r]]``, dropped ranks
    contributing zero, summed rank by rank in out.dtype as in JAX."""
    T, k = slot.shape
    y = torch.zeros((T, out.shape[1]), dtype=out.dtype, device=out.device)
    for r in range(k):
        rows = _gather_reference(out, slot[:, r])
        y = y + rows * gates[:, r:r + 1].to(out.dtype)
    return y
