"""int8 weight-quantized matmul: the hand-written CUDA kernel
(``csrc/int8_matmul.cu``) and its plain PyTorch version.

Counterpart of ``paddle_tpu/ops/int8_matmul.py``: int8 activations times
int8 weights with int32 accumulation, the per-channel dequant and the
bias applied in f32 in the kernel's epilogue, ``acc * (xscale *
wscale[n]) + bias``, then the cast to the output dtype.

Entry points:

- :func:`int8_matmul_arrays` — already-quantized operands;
- :func:`dynamic_int8_matmul` — fp activations, quantized per tensor on
  the fly (abs-max, round half to even, clip to ±127, all in f32): the
  serving engine's int8 decode (``InferenceEngine(int8_weights=True)``).

CUDA tensors launch the kernel, at any M, K and N: one launch a call;
:func:`dynamic_int8_matmul` adds one before it that quantizes the
activations (bf16 or f32) once, so the scale never leaves the card, and
the product's weight loads overlap it. CPU tensors run the plain versions
(:func:`_int8_matmul_reference`, :func:`_dynamic_int8_reference`),
bit-identical to the kernels'.
"""
from __future__ import annotations

import ctypes

import torch

from ..monitor.stats import INT8_MATMUL_CALLS
from . import _build

__all__ = ["int8_matmul_arrays", "dynamic_int8_matmul", "LAUNCHES"]

# kernel launches since the last reset (the wrapper adds one per launch)
LAUNCHES = 0

# output dtypes, and the activations the quantizing entry takes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _int8_matmul_reference(xq, wq, wscale, xscale, bias, out_dtype):
    """Plain version. The int32 sum is exact: on the CPU an int32 matmul;
    on the card (no int32 matmul there) an f64 one, exact while |acc| <
    2**53 (|acc| <= K * 127**2). xscale: a 0-dim tensor, or one scale per
    row of xq's leading dims."""
    if xq.device.type == "cuda":
        acc = xq.double() @ wq.double()
    else:
        acc = xq.int() @ wq.int()
    xs = xscale.float()
    if xs.numel() != 1:
        xs = xs.reshape(*xq.shape[:-1], 1)
    else:
        xs = xs.reshape(())
    out = acc.float() * (xs * wscale.float())
    if bias is not None:
        out = out + bias
    return out.to(out_dtype)


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("int8_matmul")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.int8_matmul.argtypes = [p, p, p, i, p, p, p] + [i] * 4 + [p]
        lib.int8_matmul_quantized.argtypes = [p, i, p, p, p, p, p, p] + [
            i] * 4 + [p]
        for fn in (lib.int8_matmul, lib.int8_matmul_quantized):
            fn.restype = i
        lib.ptt_error_string.argtypes = [ctypes.c_int]
        lib.ptt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _launch(x2, wq, wscale, xs, bias, out_dtype):
    """The kernel on x2 (M, K): int8 with ``xs`` its f32 scales (1 or M
    values), one launch; or f32/bf16 with ``xs`` None, quantized per
    tensor by a launch before the product's."""
    global LAUNCHES
    M, K = x2.shape
    if wq.dim() != 2 or wq.shape[0] != K or wq.dtype != torch.int8:
        raise ValueError(f"wq {wq.dtype} {tuple(wq.shape)} is not int8 "
                         f"(K={K}, N)")
    N = wq.shape[1]
    quantize = xs is None
    if x2.dtype != torch.int8 and not (quantize and x2.dtype in _DTYPES):
        raise TypeError(f"int8 matmul takes int8 activations with their "
                        f"scales or f32/bf16 ones without, got {x2.dtype}")
    if out_dtype not in _DTYPES:
        raise TypeError(f"int8 matmul writes f32 or bf16, not {out_dtype}")
    if wscale.shape != (N,) or wscale.dtype != torch.float32:
        raise ValueError(f"wscale must be f32 ({N},), got "
                         f"{wscale.dtype} {tuple(wscale.shape)}")
    if not quantize and (xs.numel() not in (1, M)
                         or xs.dtype != torch.float32):
        raise ValueError(f"xscale must be f32 with 1 or {M} values, got "
                         f"{xs.dtype} {tuple(xs.shape)}")
    if bias is not None and (bias.shape != (N,)
                             or bias.dtype != torch.float32):
        raise ValueError(f"bias must be f32 ({N},)")
    dev = x2.device
    for t in (wq, wscale, xs, bias):
        if t is not None and (t.device != dev or not t.is_contiguous()):
            raise ValueError("int8 matmul operands must be contiguous on "
                             "one device")
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _launch(x2, wq, wscale, xs, bias, out_dtype)
    lib = _load()
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    b = None if bias is None else bias.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if quantize:
        xq = torch.empty((M, K), dtype=torch.int8, device=dev)
        scale = torch.empty(M, dtype=torch.float32, device=dev)
        err = lib.int8_matmul_quantized(
            x2.data_ptr(), _DTYPES[x2.dtype], xq.data_ptr(),
            scale.data_ptr(), wq.data_ptr(), wscale.data_ptr(), b,
            out.data_ptr(), M, K, N, _DTYPES[out_dtype], stream)
    else:
        err = lib.int8_matmul(
            x2.data_ptr(), wq.data_ptr(), xs.data_ptr(), int(xs.numel() != 1),
            wscale.data_ptr(), b, out.data_ptr(), M, K, N,
            _DTYPES[out_dtype], stream)
    _build.check(lib, err, "int8_matmul")
    if M and N:
        LAUNCHES += 2 if quantize else 1
    return out


def _f32(t):
    return None if t is None else t.to(torch.float32).contiguous()


def int8_matmul_arrays(xq, wq, wscale, xscale, bias=None,
                       out_dtype=torch.float32):
    """``dequant(xq @ wq)``: xq int8 [..., K]; wq int8 [K, N]; wscale [N]
    (the dequant multiplier, scale/qmax); xscale a float, a 0-dim tensor
    or one scale per row of xq; bias [N] or None. Returns [..., N] in
    ``out_dtype``."""
    dev = xq.device
    if not isinstance(xscale, torch.Tensor):
        xscale = torch.full((), float(xscale), dtype=torch.float32,
                            device=dev)
    INT8_MATMUL_CALLS.add()
    if dev.type != "cuda":
        return _int8_matmul_reference(xq, wq, wscale, xscale, bias,
                                      out_dtype)
    K = xq.shape[-1]
    out = _launch(xq.reshape(-1, K).contiguous(), wq.contiguous(),
                  _f32(wscale), _f32(xscale).reshape(-1), _f32(bias),
                  out_dtype)
    return out.reshape(*xq.shape[:-1], wq.shape[1])


def _quant_scale(amax):
    """max(amax, 1e-8) / 127 in f32, a true division on every device (a
    CUDA tensor divided by a Python number multiplies by its reciprocal,
    which can differ from JAX's division in the last bit)."""
    return torch.clamp(amax, min=1e-8) / torch.full(
        (), 127.0, dtype=torch.float32, device=amax.device)


def _quantize(x32, scale):
    """round(x / scale) clipped to ±127 as int8 (round half to even, as
    jnp.round); ``scale`` broadcasts against ``x32``."""
    return torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)


def _dynamic_int8_reference(x, wq, wscale, bias=None):
    """Plain version of :func:`dynamic_int8_matmul`'s kernel: the
    per-tensor abs-max quantization in f32, then
    :func:`_int8_matmul_reference`; the output has x's dtype. A NaN or
    inf is left out of the abs-max and makes its own row's scale NaN, so
    it reaches that row of the output and no other (the JAX package's
    per-tensor scale turns every row NaN): a decode batch's poisoned row
    stays in its slot."""
    x32 = x.float()
    bad = ~torch.isfinite(x32)
    xscale = _quant_scale(torch.where(bad, 0.0, x32.abs()).max())
    rows = torch.where(bad.any(-1), torch.nan, xscale)
    return _int8_matmul_reference(
        _quantize(torch.where(bad, 0.0, x32), xscale), wq, wscale, rows,
        bias, x.dtype)


def dynamic_int8_matmul(x, wq, wscale, bias=None):
    """Weight-only int8 matmul for fp activations: per-tensor abs-max
    activation quantization (f32), then the int8 matmul with its dequant
    epilogue; the output has x's dtype. On the card two launches do both
    (x in f32 or bf16)."""
    INT8_MATMUL_CALLS.add()
    if x.device.type != "cuda":
        return _dynamic_int8_reference(x, wq, wscale, bias)
    K = x.shape[-1]
    out = _launch(x.reshape(-1, K).contiguous(), wq.contiguous(),
                  _f32(wscale), None, _f32(bias), x.dtype)
    return out.reshape(*x.shape[:-1], wq.shape[1])
