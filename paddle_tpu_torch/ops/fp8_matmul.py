"""fp8 (e4m3) matmul with the dequant epilogue: the hand-written CUDA
kernel (``csrc/fp8_matmul.cu``) and its plain PyTorch version.

Counterpart of ``paddle_tpu/ops/fp8_matmul.py``: ``float8_e4m3fn``
operands with per-tensor scales, an f32 sum of exact products, and
``acc * (sx * sw) (+ bias)`` in f32 before the cast to the output dtype.
The scales stay device tensors (reading one on the host would sync once
per matmul). Scale management lives in ``amp/fp8.py``.

The kernel reads the weight K-major, as ``wqᵀ`` (N, K) row-major: a
column-major ``wq`` (``wq.t()`` contiguous, as ``amp/fp8.py`` writes it)
goes straight in, a row-major one is transposed once here. Its products
run on f16 wgmma (exact for e4m3, f32 sums). TMA needs 16-byte row
strides and bases, so a K that is not a multiple of 16 is zero-padded
(exact) and an unaligned operand is copied.

CUDA tensors launch the kernel at any M, K and N; CPU tensors run the
plain version.
"""
from __future__ import annotations

import ctypes

import torch

from ..monitor.stats import FP8_MATMUL_CALLS
from . import _build

__all__ = ["fp8_matmul_arrays", "E4M3_MAX", "LAUNCHES"]

E4M3_MAX = 448.0

# kernel launches since the last reset (the wrapper adds one per launch)
LAUNCHES = 0

_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _fp8_matmul_ref(xq, wq, sx, sw, bias, out_dtype):
    """Plain version, the JAX reference's op sequence: e4m3 upcast to f32
    (exact), an f32 matmul (each product of two e4m3 values is exact in
    f32, as in the bf16 dot with f32 accumulation), ``* (sx * sw)``,
    ``+ bias`` in f32, then the cast. The weight is made row-major first,
    so a row-major and a column-major ``wq`` give bit-identical results."""
    acc = xq.float() @ wq.float().contiguous()   # one layout, one order
    out = acc * (sx.float() * sw.float())
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype)


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("fp8_matmul")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fp8_matmul.argtypes = [p, p, p, p, p, p, p, i, i, i, i, p]
        lib.fp8_matmul.restype = i
        lib.ptt_error_string.argtypes = [ctypes.c_int]
        lib.ptt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _aligned(t):
    return t.data_ptr() % 16 == 0


def _k_major(t, kp):
    """``t`` (rows, K) e4m3 as a row-major (rows, kp) array with a
    16-byte-aligned base; columns past K are zero."""
    rows, k = t.shape
    if k == kp and t.is_contiguous() and _aligned(t):
        return t
    out = torch.zeros((rows, kp), dtype=torch.uint8, device=t.device)
    out[:, :k] = t.contiguous().view(torch.uint8)
    return out.view(torch.float8_e4m3fn)


def _launch(x2, wq, sx, sw, bias, out_dtype):
    """The kernel on CUDA tensors: x2 (M, K), wq (K, N) in either layout."""
    global LAUNCHES
    M, K = x2.shape
    if wq.dim() != 2 or wq.shape[0] != K:
        raise ValueError(f"wq {tuple(wq.shape)} is not (K={K}, N)")
    N = wq.shape[1]
    if x2.dtype != torch.float8_e4m3fn or wq.dtype != torch.float8_e4m3fn:
        raise TypeError(f"fp8 matmul takes float8_e4m3fn operands, got "
                        f"{x2.dtype}/{wq.dtype}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"fp8 matmul writes f32 or bf16, not {out_dtype}")
    for name, t in (("sx", sx), ("sw", sw)):
        if t.numel() != 1 or t.dtype != torch.float32:
            raise ValueError(f"{name} must be one f32 value, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if bias is not None and (bias.shape != (N,)
                             or bias.dtype != torch.float32):
        raise ValueError(f"bias must be f32 ({N},)")
    for t in (wq, sx, sw) + ((bias,) if bias is not None else ()):
        if t.device != x2.device:
            raise ValueError("fp8 matmul operands must lie on one device")
    for t in (sx, sw) + ((bias,) if bias is not None else ()):
        if not t.is_contiguous():
            raise ValueError("fp8 matmul needs contiguous scales and bias")
    kp = max(16, -(-K // 16) * 16)
    xk = _k_major(x2, kp)
    wt = _k_major(wq.t(), kp)        # (N, K): no copy for a column-major wq
    lib = _load()
    out = torch.empty((M, N), dtype=out_dtype, device=x2.device)
    # the f16 image of wt the kernel converts it into first
    w16 = torch.empty((N, kp), dtype=torch.float16, device=x2.device)
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        err = lib.fp8_matmul(
            xk.data_ptr(), wt.data_ptr(), w16.data_ptr(), sx.data_ptr(),
            sw.data_ptr(), bias.data_ptr() if bias is not None else None,
            out.data_ptr(), M, kp, N, _OUT_DTYPES[out_dtype], stream)
    _build.check(lib, err, "fp8_matmul")
    LAUNCHES += 1
    return out


def _scalar(s, device):
    if isinstance(s, torch.Tensor):
        return s.to(device=device, dtype=torch.float32)
    return torch.full((), float(s), dtype=torch.float32, device=device)


def fp8_matmul_arrays(xq, wq, sx, sw, bias=None, out_dtype=torch.float32):
    """``(xq @ wq) * sx * sw (+ bias)`` with the dequant in the epilogue.

    xq e4m3 [..., K]; wq e4m3 [K, N], row- or column-major (the kernel
    reads a column-major one in place); sx/sw the per-tensor scales (each
    operand was divided by its scale at quantization; the epilogue
    multiplies them back), floats or one-value f32 tensors; bias [N] or
    None. Returns [..., N] in ``out_dtype``."""
    dev = xq.device
    sx, sw = _scalar(sx, dev), _scalar(sw, dev)
    FP8_MATMUL_CALLS.add()
    if dev.type != "cuda":
        return _fp8_matmul_ref(xq, wq, sx, sw, bias, out_dtype)
    lead = xq.shape[:-1]
    K = xq.shape[-1]
    b = bias.to(torch.float32).contiguous() if bias is not None else None
    out = _launch(xq.reshape(-1, K), wq, sx.reshape(-1).contiguous(),
                  sw.reshape(-1).contiguous(), b, out_dtype)
    return out.reshape(*lead, wq.shape[1])
