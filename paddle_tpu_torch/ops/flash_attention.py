"""Flash attention, forward and backward: the hand-written CUDA kernels
(``csrc/flash_attention_fwd.cu``, ``csrc/flash_attention_bwd.cu``) and
their plain PyTorch versions.

Counterpart of ``paddle_tpu/ops/flash_attention.py``. Layout
``[batch, heads, seq, head_dim]``. On a CUDA tensor the wrappers launch
the kernels (or raise); on a CPU tensor they run the plain versions
(:func:`_attention_reference`, the same math as the JAX package's
composed path, differentiated by autograd).

On the card, :class:`_FlashAttention` makes the forward kernel
differentiable: it saves ``(q, k, v, o, lse)`` and its backward launches
the backward kernel, which recomputes the probabilities from ``lse``
(the JAX package's custom VJP). :func:`_flash_backward_reference` is
that backward's plain version, with the TPU kernel's roundings.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["NEG_INF", "flash_attention_forward", "flash_attention_arrays",
           "LAUNCHES", "BWD_LAUNCHES"]

NEG_INF = -1e30

# kernel launches since the last reset (each wrapper adds one per launch)
LAUNCHES = 0
BWD_LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None
_bwd_lib = None


def _causal_mask(sq, sk, device):
    """(Sq, Sk) bool, True where q_pos + (Sk - Sq) >= k_pos."""
    return torch.ones(sq, sk, dtype=torch.bool, device=device).tril(sk - sq)


def _attention_reference(q, k, v, causal, scale):
    """Composed attention with the JAX package's numerics: scores in the
    input dtype, softmax in f32, probabilities cast back before P·V."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        mask = _causal_mask(s.shape[-2], s.shape[-1], s.device)
        s = torch.where(mask, s, torch.tensor(NEG_INF, dtype=s.dtype,
                                              device=s.device))
    p = torch.softmax(s.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def _flash_forward_reference(q, k, v, causal, scale):
    """Plain version of the forward kernel: (o, lse). ``o`` is
    :func:`_attention_reference`; ``lse`` (B·H, Sq, 1) f32 is the
    log-sum-exp of the f32 scores under the same mask."""
    b, h, sq, _ = q.shape
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = _causal_mask(sq, s.shape[-1], s.device)
        s = torch.where(mask, s, torch.tensor(NEG_INF, device=s.device))
    lse = torch.logsumexp(s, dim=-1).reshape(b * h, sq, 1)
    return _attention_reference(q, k, v, causal, scale), lse


def _flash_backward_reference(q, k, v, o, lse, do, causal, scale):
    """Plain version of the backward kernel: (dq, dk, dv) in the input
    dtypes, with the TPU kernel's numerics (ops/flash_attention.py
    ``_bwd_kernel``): f32 scores, ``p = exp(s - lse)`` (zero where
    masked), ``delta = rowsum(dO·O)`` in f32, ``p`` rounded to dO's dtype
    before ``dV += pᵀ·dO``, ``ds = p·(dp - delta)·scale`` rounded to q's
    dtype before ``dK += dsᵀ·q`` and ``dQ = ds·k``, f32 accumulation."""
    b, h, sq, _ = q.shape
    sk = k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    p = torch.exp(s - lse.reshape(b, h, sq, 1))
    if causal:
        p = torch.where(_causal_mask(sq, sk, p.device), p, 0.0)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    pb = p.to(do.dtype).float()
    dv = torch.einsum("bhqk,bhqd->bhkd", pb, do.float())
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    ds = (p * (dp - delta) * scale).to(q.dtype).float()
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v):
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention takes f32 or bf16 q/k/v of one "
                        f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} are not (B, H, S, D)")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash attention needs contiguous q, k, v")
    if q.shape[3] > 128:
        raise ValueError(f"head_dim {q.shape[3]} > 128 is not supported by "
                         f"the kernel")
    if k.shape[2] < 1:
        raise ValueError("flash attention needs at least one key")


def _launch(q, k, v, causal, scale):
    """Forward kernel on CUDA tensors: (o, lse)."""
    global _lib, LAUNCHES
    _check(q, k, v)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if q.dtype == torch.bfloat16 and d in (64, 128):
        # the TMA kernel's tensor maps need 16-byte-aligned bases
        q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone()
                   for t in (q, k, v))
    o = torch.empty_like(q)
    lse = torch.empty((b * h, sq, 1), dtype=torch.float32, device=q.device)
    if _lib is None:
        lib = _build.load("flash_attention_fwd")
        lib.flash_attention_fwd.argtypes = [
            ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.flash_attention_fwd.restype = ctypes.c_int
        lib.ptt_error_string.argtypes = [ctypes.c_int]
        lib.ptt_error_string.restype = ctypes.c_char_p
        _lib = lib
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b * h, sq, sk, d, float(scale), int(bool(causal)),
            _DTYPES[q.dtype], stream)
    _build.check(_lib, err, "flash_attention_fwd")
    LAUNCHES += 1
    return o, lse


def _launch_bwd(q, k, v, o, lse, do, causal, scale):
    """Backward kernel on CUDA tensors: (dq, dk, dv) in the input dtypes.
    ``delta = rowsum(dO·O)`` is one PyTorch reduction (the JAX package
    computes it outside its kernel too); dQ accumulates in an f32
    (B·H, Sq, D) buffer, then is cast."""
    global _bwd_lib, BWD_LAUNCHES
    _check(q, k, v)
    if do.shape != q.shape or o.shape != q.shape or do.dtype != q.dtype \
            or o.dtype != q.dtype:
        raise ValueError(f"o {tuple(o.shape)}/{o.dtype} and dO "
                         f"{tuple(do.shape)}/{do.dtype} must match q "
                         f"{tuple(q.shape)}/{q.dtype}")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    do = do.contiguous()
    lse = lse.contiguous()
    if lse.dtype != torch.float32 or lse.numel() != b * h * sq:
        raise ValueError("lse must be f32 (B·H, Sq, 1)")
    delta = (do.float() * o.float()).sum(-1).contiguous()
    dq32 = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if _bwd_lib is None:
        lib = _build.load("flash_attention_bwd")
        lib.flash_attention_bwd.argtypes = [
            ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.flash_attention_bwd.restype = ctypes.c_int
        lib.ptt_error_string.argtypes = [ctypes.c_int]
        lib.ptt_error_string.restype = ctypes.c_char_p
        _bwd_lib = lib
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _bwd_lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq32.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b * h, sq, sk, d, float(scale),
            int(bool(causal)), _DTYPES[q.dtype], stream)
    _build.check(_bwd_lib, err, "flash_attention_bwd")
    BWD_LAUNCHES += 1
    return dq32.to(q.dtype), dk, dv


def _flash_backward(q, k, v, o, lse, do, causal, scale):
    """(dq, dk, dv): the backward kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if q.device.type == "cuda":
        return _launch_bwd(q, k, v, o, lse, do, causal, scale)
    return _flash_backward_reference(q, k, v, o, lse, do, causal, scale)


class _FlashAttention(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient
    (the JAX package's ``_flash`` custom VJP). Returns (o, lse); lse
    carries no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = _launch(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_backward(q, k, v, o, lse, do, ctx.causal,
                                     ctx.scale)
        return dq, dk, dv, None, None


def _needs_grad(*ts):
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _on_card(q, k, v, causal, scale):
    if _needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, scale)
    return _launch(q, k, v, causal, scale)


def flash_attention_forward(q, k, v, causal=False, scale=None):
    """(o, lse): o (B, H, Sq, D) in q's dtype, lse (B·H, Sq, 1) f32.

    CUDA tensors launch the kernel (o differentiable through the backward
    kernel); CPU tensors run the plain version."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cuda":
        return _on_card(q, k, v, causal, scale)
    return _flash_forward_reference(q, k, v, causal, scale)


def flash_attention_arrays(q, k, v, causal=False, scale=None):
    """Attention output only (the entry ``models.gpt._attention`` calls);
    differentiable on both devices.

    Unlike the TPU entry there is no shape fallback: any Sq, Sk and
    head_dim <= 128 runs the kernels on a CUDA tensor."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cuda":
        return _on_card(q, k, v, causal, scale)[0]
    return _attention_reference(q, k, v, causal, scale)
