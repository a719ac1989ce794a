"""Fused pre-LN residual MLP and fused residual add + LayerNorm, forward
and backward: the hand-written CUDA kernels (``csrc/fused_ln_mlp.cu``,
``csrc/fused_add_ln.cu``) and their plain PyTorch versions.

Counterpart of ``paddle_tpu/ops/fused_kernels.py``'s
:func:`fused_ln_mlp`::

    y = (x if residual) + act(LN?(x) @ w1 + b1) @ w2 + b2

with ``act`` "gelu" (tanh form), "relu" or "swiglu"
(``silu(h @ w_gate + b_gate) * (h @ w1 + b1)``). ``ln_scale=None`` skips
the LayerNorm. :class:`_FusedLnMlp` is the differentiable entry: its
forward returns y and saves the row statistics ``mu`` and ``rstd``; its
backward recomputes the LN'd input and z and returns the grads of x, the
LN scale/bias, w1, b1, w2, b2 and the gate weights in their input dtypes
(the JAX package's ``_fmlp_bwd_rule``).

On a CUDA tensor the wrappers launch the kernels (or raise: H and the
MLP width must be multiples of 64); on a CPU tensor they run
:func:`_fmlp_forward_reference` / :func:`_fmlp_backward_reference`.
The C entry points pick the mainloop (:func:`mlp_fwd_kernel_for` and
:func:`mlp_bwd_kernel_for` state their rule for reports and tests):
bf16 runs the Hopper GEMMs (TMA loads into an mbarrier ring, wgmma;
every activation: the forward's (2) on 128x256 tiles, 128x192 for
swiglu's two products, (3) on 128x256; the backward's kernel (4) on
128x192 tiles for gelu and relu, 128x64 for swiglu; their tensor maps
need 16-byte-aligned bases, so the wrappers copy any unaligned
operand), f32 the FMA mainloop.
Those plain versions carry the KERNEL's numerics, not the composed
path's (:func:`_ln_mlp_reference`, the unfused model code): the LN in
f32 with ``lnx`` stored in x's dtype, ``z = lnx·w1`` accumulated in f32
plus ``b1`` in f32, the activation in f32, ``a`` rounded to x's dtype
before ``·w2``, and ``y = acc + b2 + x`` rounded once. The composed path
rounds after every op in the compute dtype, so the two differ in bf16
(by a few bf16 ulps) and agree in f32 to the summation order.

Outside the kernels, as the JAX package does them in ``jnp``: ``db2``,
the LayerNorm backward from ``dlnx`` and the residual add (on a CUDA
tensor in fewer passes, the LayerNorm backward as aten's one op:
:func:`_bwd_rows`).

:func:`fused_add_layernorm` is the counterpart of the JAX function of
the same name: ``LN(x + y)``, the post-LN residual pattern, with the
residual add in f32 and the row statistics ``mu``/``rstd`` saved in f32
(:class:`_FusedAddLn`; its backward gives the same ``dx`` for x and y
and the f32 column sums ``ds``/``db``). On a CUDA tensor it launches the
add-LN kernels (or raises: f32 or bf16, H at most ``ADDLN_MAX_H``); on a
CPU tensor it runs :func:`_addln_forward_reference` /
:func:`_addln_backward_reference`, which follow the kernels' numerics.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["fused_ln_mlp", "fused_add_layernorm", "FWD_LAUNCHES",
           "BWD_LAUNCHES", "DW2_LAUNCHES", "ADDLN_FWD_LAUNCHES",
           "ADDLN_BWD_LAUNCHES", "ADDLN_MAX_H"]

# kernel launches since the last reset (each wrapper adds one per launch)
FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
DW2_LAUNCHES = 0
ADDLN_FWD_LAUNCHES = 0
ADDLN_BWD_LAUNCHES = 0

# widest row the add-LN kernels take (256 threads of 32 values: MAX_H in
# csrc/fused_add_ln.cu, which refuses wider rows too)
ADDLN_MAX_H = 8192

_SQRT_2_PI = math.sqrt(2.0 / math.pi)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = {"gelu": 0, "relu": 1, "swiglu": 2}
_lib = None
_addln_lib = None


# --------------------------------------------------------------------------
# activations (closed-form derivatives, as the kernels compute them)
# --------------------------------------------------------------------------

def _act(z, kind):
    if kind == "relu":
        return torch.clamp_min(z, 0.0)
    # tanh-approx gelu (jax.nn.gelu default)
    u = _SQRT_2_PI * (z + 0.044715 * z * z * z)
    return 0.5 * z * (1.0 + torch.tanh(u))


def _act_grad(z, kind):
    if kind == "relu":
        return (z > 0.0).to(z.dtype)
    u = _SQRT_2_PI * (z + 0.044715 * z * z * z)
    t = torch.tanh(u)
    du = _SQRT_2_PI * (1.0 + 3.0 * 0.044715 * z * z)
    return 0.5 * (1.0 + t) + 0.5 * z * (1.0 - t * t) * du


def _silu(z):
    return z * torch.sigmoid(z)


def _silu_grad(z):
    s = torch.sigmoid(z)
    return s * (1.0 + z * (1.0 - s))


# --------------------------------------------------------------------------
# composed reference: the op sequence of the unfused model code
# --------------------------------------------------------------------------

def _layer_norm_ref(x, scale, bias, eps):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def _ln_mlp_reference(x, ln_scale, ln_bias, w1, b1, w2, b2, wg, bg,
                      act, residual, has_ln, eps):
    h = _layer_norm_ref(x, ln_scale, ln_bias, eps) if has_ln else x
    if act == "swiglu":
        a = _silu(h @ wg + bg) * (h @ w1 + b1)
    elif act == "relu":
        a = torch.relu(h @ w1 + b1)
    else:
        a = torch.nn.functional.gelu(h @ w1 + b1, approximate="tanh")
    out = a @ w2 + b2
    return x + out if residual else out


# --------------------------------------------------------------------------
# plain versions of the kernels (the kernels' numerics)
# --------------------------------------------------------------------------

def _mm32(a, b):
    """Product of operands in the compute dtype with f32 accumulation:
    bf16 values are exact in f32, so an f32 product of the upcast
    operands is the kernel's computation up to summation order."""
    return a.float() @ b.float()


def _lnx(x2, lns, lnb, mu, rstd):
    return ((x2.float() - mu) * rstd * lns + lnb).to(x2.dtype)


def _fmlp_forward_reference(x2, lns, lnb, w1, b1, w2, b2, wg, bg, act,
                            residual, has_ln, eps):
    """x2 (R, H); lns/lnb (H,) f32 (ones/zeros when there is no LN);
    weights and biases in x2's dtype. Returns (y (R, H) in x2's dtype,
    mu (R, 1) f32, rstd (R, 1) f32); without LN mu is 0 and rstd 1."""
    x32 = x2.float()
    if has_ln:
        mu = x32.mean(-1, keepdim=True)
        var = (x32 - mu).square().mean(-1, keepdim=True)
        rstd = torch.rsqrt(var + eps)
    else:
        mu = torch.zeros_like(x32[:, :1])
        rstd = torch.ones_like(x32[:, :1])
    lnx = _lnx(x2, lns, lnb, mu, rstd)
    z = _mm32(lnx, w1) + b1.float()
    if act == "swiglu":
        a = _silu(_mm32(lnx, wg) + bg.float()) * z
    else:
        a = _act(z, act)
    out = _mm32(a.to(x2.dtype), w2) + b2.float()
    if residual:
        out = out + x32
    return out.to(x2.dtype), mu, rstd


def _ln_backward(dlnx, x2, lns, mu, rstd, has_ln):
    """(dx f32, dscale, dbias) of ``lnx = (x - mu)·rstd·s + b`` from the
    f32 ``dlnx`` (row-local, as the JAX package does it in jnp)."""
    if not has_ln:
        zeros = torch.zeros(x2.shape[-1], dtype=torch.float32,
                            device=x2.device)
        return dlnx, zeros, zeros.clone()
    xhat = (x2.float() - mu) * rstd
    dscale = (dlnx * xhat).sum(0)
    dbias = dlnx.sum(0)
    dxhat = dlnx * lns
    mean1 = dxhat.mean(-1, keepdim=True)
    mean2 = (dxhat * xhat).mean(-1, keepdim=True)
    return rstd * (dxhat - mean1 - xhat * mean2), dscale, dbias


def _bwd_rows(dlnx, x2, lns, lnb, mu, rstd, dy, residual, has_ln):
    """The kernel path's PyTorch work after the GEMMs: (dx, dscale,
    dbias, db2) in f32 from the kernels' f32 ``dlnx`` (which it may
    overwrite), as :func:`_fmlp_backward_reference` computes them, in
    fewer passes over (R, H): the LayerNorm backward is one aten op
    (``native_layer_norm_backward`` on x in f32: dx, then the column sums
    dscale and dbias), db2 sums dy in f32 without an f32 copy, and the
    residual adds dy in place. The same functions up to f32 summation
    order."""
    db2 = dy.sum(0, dtype=torch.float32)
    if has_ln:
        dx, dscale, dbias = torch.ops.aten.native_layer_norm_backward(
            dlnx, x2.float(), [x2.shape[-1]], mu, rstd, lns, lnb,
            [True, True, True])
    else:
        dx, dscale, dbias = _ln_backward(dlnx, x2, lns, mu, rstd, has_ln)
    if residual:
        dx.add_(dy)
    return dx, dscale, dbias, db2


def _fmlp_backward_reference(x2, lns, lnb, w1, b1, w2, wg, bg, mu, rstd,
                             dy, act, residual, has_ln):
    """Plain version of the backward kernels. Returns f32
    (dx, dscale, dbias, dw1, db1, dw2, db2, dwg, dbg); dwg/dbg are None
    unless act is "swiglu"."""
    dt = x2.dtype
    dy = dy.to(dt)
    lnx = _lnx(x2, lns, lnb, mu, rstd)
    z = _mm32(lnx, w1) + b1.float()
    da = _mm32(dy, w2.t())
    dwg = dbg = None
    if act == "swiglu":
        zg = _mm32(lnx, wg) + bg.float()
        sg = _silu(zg)
        dz = da * sg
        dzg = da * z * _silu_grad(zg)
        dwg = _mm32(lnx.t(), dzg.to(dt))
        dbg = dzg.sum(0)
        a = sg * z
    else:
        dz = da * _act_grad(z, act)
        a = _act(z, act)
    db1 = dz.sum(0)
    dw1 = _mm32(lnx.t(), dz.to(dt))
    dlnx = _mm32(dz.to(dt), w1.t())
    if act == "swiglu":
        dlnx = dlnx + _mm32(dzg.to(dt), wg.t())
    dw2 = _mm32(a.to(dt).t(), dy)
    db2 = dy.float().sum(0)
    dx, dscale, dbias = _ln_backward(dlnx, x2, lns, mu, rstd, has_ln)
    if residual:
        dx = dx + dy.float()
    return dx, dscale, dbias, dw1, db1, dw2, db2, dwg, dbg


# --------------------------------------------------------------------------
# the kernels
# --------------------------------------------------------------------------

def _load():
    global _lib
    if _lib is None:
        lib = _build.load("fused_ln_mlp")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fmlp_forward.argtypes = [p] * 14 + [i] * 3 + [
            ctypes.c_float] + [i] * 4 + [p]
        lib.fmlp_backward.argtypes = [p] * 20 + [i] * 6 + [p]
        lib.fmlp_backward_dw2.argtypes = [p] * 3 + [i] * 3 + [i] + [p]
        for fn in (lib.fmlp_forward, lib.fmlp_backward,
                   lib.fmlp_backward_dw2):
            fn.restype = ctypes.c_int
        lib.ptt_error_string.argtypes = [ctypes.c_int]
        lib.ptt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def mlp_fwd_kernel_for(dtype):
    """Which mainloop the forward's two GEMMs run on a CUDA tensor:
    "wgmma" (bf16: the Hopper GEMMs, every activation) or "fma" (f32).
    Raises for another dtype. The C entry point owns this rule and
    applies it itself; this copy names the route for reports and tests."""
    if dtype not in _DTYPES:
        raise TypeError(f"fused_ln_mlp takes f32 or bf16, got {dtype}")
    return "wgmma" if dtype == torch.bfloat16 else "fma"


def mlp_bwd_kernel_for(dtype):
    """Which mainloop the backward kernels (and dW2's) run on a CUDA
    tensor: "wgmma" (bf16: the Hopper GEMMs, every activation) or "fma"
    (f32). Raises for another dtype. The C entry points own this rule and
    apply it themselves; this copy names the route for reports and
    tests."""
    if dtype not in _DTYPES:
        raise TypeError(f"fused_ln_mlp takes f32 or bf16, got {dtype}")
    return "wgmma" if dtype == torch.bfloat16 else "fma"


def _check_card(x2, w1, w2, wg):
    R, H = x2.shape
    M = w1.shape[1]
    if x2.dtype not in _DTYPES:
        raise TypeError(f"fused_ln_mlp takes f32 or bf16, got {x2.dtype}")
    if H % 64 or M % 64:
        raise ValueError(f"fused_ln_mlp kernels need hidden and MLP widths "
                         f"that are multiples of 64, got H={H}, M={M}")
    if tuple(w1.shape) != (H, M) or tuple(w2.shape) != (M, H) \
            or (wg is not None and tuple(wg.shape) != (H, M)):
        raise ValueError(f"weights w1 {tuple(w1.shape)} w2 "
                         f"{tuple(w2.shape)} do not fit x (R, {H})")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_fwd(x2, lns, lnb, w1, b1, w2, b2, wg, bg, act, residual, has_ln,
                eps):
    """Forward kernels on CUDA tensors: (y, mu, rstd). Three launches in
    one C call: the row pass (mu, rstd and lnx in x's dtype), then
    ``a = act(lnx·w1 + b1)`` (the bias and activation in the GEMM's
    epilogue) into an (R, M) buffer in x's dtype, then
    ``y = a·w2 + b2 + x``. The C entry point picks the GEMMs' mainloop
    (:func:`mlp_fwd_kernel_for` states its rule); the bf16 one reads its
    operands through tensor maps and its biases and x in pairs, from
    16-byte-aligned bases, so an unaligned operand is copied whatever
    the dtype."""
    global FWD_LAUNCHES
    _check_card(x2, w1, w2, wg)
    x2, w1, b1, w2, b2, wg, bg = _build.aligned16(x2, w1, b1, w2, b2, wg,
                                                  bg)
    lib = _load()
    R, H = x2.shape
    M = w1.shape[1]
    dev = x2.device
    y = torch.empty_like(x2)
    mu = torch.empty((R, 1), dtype=torch.float32, device=dev)
    rstd = torch.empty((R, 1), dtype=torch.float32, device=dev)
    a = torch.empty((R, M), dtype=x2.dtype, device=dev)
    lnx = torch.empty_like(x2) if has_ln else None
    with torch.cuda.device(dev):
        err = lib.fmlp_forward(
            x2.data_ptr(), lns.data_ptr(), lnb.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), _ptr(wg),
            _ptr(bg), y.data_ptr(), mu.data_ptr(), rstd.data_ptr(),
            _ptr(lnx), a.data_ptr(), R, H, M, float(eps), _ACTS[act],
            int(bool(residual)), int(bool(has_ln)), _DTYPES[x2.dtype],
            _stream(x2))
    _build.check(lib, err, "fmlp_forward")
    FWD_LAUNCHES += 1
    return y, mu, rstd


def _launch_bwd(x2, lns, lnb, w1, b1, w2, wg, bg, mu, rstd, dy, act,
                residual, has_ln):
    """Backward kernels on CUDA tensors; returns what
    :func:`_fmlp_backward_reference` does. Two C calls: the main
    backward (lnx again from x, mu and rstd; ``da = dy·w2ᵀ`` and
    ``z = lnx·w1`` in one kernel with the ``act'(z)`` epilogue, which
    also writes ``a`` and the f32 column sums db1/dbg; then
    dW1/dWg = lnxᵀ·dz and dlnx = dz·w1ᵀ) and the dW2 = aᵀ·dy kernel (the
    TPU's separate ``_fmlp_bwd_dw2_kernel``); then db2, the LN backward
    and the residual add in PyTorch (:func:`_bwd_rows`). The C
    entry points pick the kernels' mainloop (:func:`mlp_bwd_kernel_for`
    states their rule); the bf16 one reads its operands through tensor
    maps and its biases in pairs, from 16-byte-aligned bases, so an
    unaligned operand is copied whatever the dtype."""
    global BWD_LAUNCHES
    _check_card(x2, w1, w2, wg)
    lib = _load()
    R, H = x2.shape
    M = w1.shape[1]
    dev = x2.device
    dt = x2.dtype
    dy = dy.to(dt).contiguous()
    x2, w1, b1, w2, wg, bg, dy = _build.aligned16(x2, w1, b1, w2, wg, bg,
                                                  dy)
    f32 = dict(dtype=torch.float32, device=dev)
    swiglu = act == "swiglu"
    dz = torch.empty((R, M), dtype=dt, device=dev)
    a = torch.empty((R, M), dtype=dt, device=dev)
    dzg = torch.empty((R, M), dtype=dt, device=dev) if swiglu else None
    db1 = torch.zeros(M, **f32)
    dbg = torch.zeros(M, **f32) if swiglu else None
    dw1 = torch.empty((H, M), **f32)
    dwg = torch.empty((H, M), **f32) if swiglu else None
    dlnx = torch.empty((R, H), **f32)
    lnx = torch.empty_like(x2) if has_ln else None
    mu, rstd = mu.contiguous(), rstd.contiguous()
    with torch.cuda.device(dev):
        err = lib.fmlp_backward(
            x2.data_ptr(), lns.data_ptr(), lnb.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), _ptr(wg), _ptr(bg),
            mu.data_ptr(), rstd.data_ptr(), dy.data_ptr(), _ptr(lnx),
            dz.data_ptr(), _ptr(dzg), a.data_ptr(), db1.data_ptr(),
            _ptr(dbg), dw1.data_ptr(), _ptr(dwg), dlnx.data_ptr(), R, H, M,
            _ACTS[act], int(bool(has_ln)), _DTYPES[dt], _stream(x2))
    _build.check(lib, err, "fmlp_backward")
    BWD_LAUNCHES += 1
    dw2 = _launch_dw2(a, dy)
    dx, dscale, dbias, db2 = _bwd_rows(dlnx, x2, lns, lnb, mu, rstd, dy,
                                       residual, has_ln)
    return dx, dscale, dbias, dw1, db1, dw2, db2, dwg, dbg


def _launch_dw2(a, dy):
    """The dW2 kernel on CUDA tensors: ``aᵀ·dy`` (M, H) f32 from the
    main backward's activation buffer a (R, M) and dy (R, H), both in the
    compute dtype."""
    global DW2_LAUNCHES
    R, M = a.shape
    H = dy.shape[1]
    if dy.shape[0] != R or dy.dtype != a.dtype or a.dtype not in _DTYPES:
        raise ValueError(f"a {tuple(a.shape)}/{a.dtype} and dy "
                         f"{tuple(dy.shape)}/{dy.dtype} do not fit")
    if H % 64 or M % 64:
        raise ValueError(f"the dW2 kernel needs hidden and MLP widths that "
                         f"are multiples of 64, got H={H}, M={M}")
    a, dy = _build.aligned16(a.contiguous(), dy.contiguous())
    lib = _load()
    dw2 = torch.empty((M, H), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = lib.fmlp_backward_dw2(a.data_ptr(), dy.data_ptr(),
                                    dw2.data_ptr(), R, H, M,
                                    _DTYPES[a.dtype], _stream(a))
    _build.check(lib, err, "fmlp_backward_dw2")
    DW2_LAUNCHES += 1
    return dw2


def _fmlp_forward(x2, lns, lnb, w1, b1, w2, b2, wg, bg, act, residual,
                  has_ln, eps):
    if x2.device.type == "cuda":
        return _launch_fwd(x2, lns, lnb, w1, b1, w2, b2, wg, bg, act,
                           residual, has_ln, eps)
    return _fmlp_forward_reference(x2, lns, lnb, w1, b1, w2, b2, wg, bg,
                                   act, residual, has_ln, eps)


def _fmlp_backward(x2, lns, lnb, w1, b1, w2, wg, bg, mu, rstd, dy, act,
                   residual, has_ln):
    if x2.device.type == "cuda":
        return _launch_bwd(x2, lns, lnb, w1, b1, w2, wg, bg, mu, rstd, dy,
                           act, residual, has_ln)
    return _fmlp_backward_reference(x2, lns, lnb, w1, b1, w2, wg, bg, mu,
                                    rstd, dy, act, residual, has_ln)


class _FusedLnMlp(torch.autograd.Function):
    """y of the fused MLP; saves mu and rstd, and the backward kernels
    give every grad in its input's dtype."""

    @staticmethod
    def forward(ctx, x2, lns, lnb, w1, b1, w2, b2, wg, bg, act, residual,
                has_ln, eps):
        y, mu, rstd = _fmlp_forward(x2, lns, lnb, w1, b1, w2, b2, wg, bg,
                                    act, residual, has_ln, eps)
        ctx.save_for_backward(x2, lns, lnb, w1, b1, w2, wg, bg, mu, rstd)
        ctx.act, ctx.residual, ctx.has_ln = act, residual, has_ln
        return y

    @staticmethod
    def backward(ctx, dy):
        x2, lns, lnb, w1, b1, w2, wg, bg, mu, rstd = ctx.saved_tensors
        dx, dscale, dbias, dw1, db1, dw2, db2, dwg, dbg = _fmlp_backward(
            x2, lns, lnb, w1, b1, w2, wg, bg, mu, rstd, dy, ctx.act,
            ctx.residual, ctx.has_ln)
        cast = (lambda g, like: None if g is None else g.to(like.dtype))
        return (dx.to(x2.dtype), dscale.to(lns.dtype), dbias.to(lnb.dtype),
                dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
                db2.to(w2.dtype), cast(dwg, w1), cast(dbg, w1), None, None,
                None, None)


def fused_ln_mlp(x, w1, b1, w2, b2, *, ln_scale=None, ln_bias=None,
                 residual=True, act="gelu", w_gate=None, b_gate=None,
                 eps=1e-5):
    """``(x if residual) + act(LN?(x) @ w1 + b1) @ w2 + b2``, fused.

    x: [..., H]; w1 [H, M]; w2 [M, H]; the weights and biases are cast
    to x's dtype. ``act``: "gelu" | "relu" | "swiglu" (swiglu takes the
    gate projection via w_gate/b_gate). ``ln_scale=None`` skips the input
    LayerNorm. Differentiable: the backward is the backward kernels (the
    plain version on a CPU tensor)."""
    if act not in _ACTS:
        raise ValueError(f"act must be one of {sorted(_ACTS)}, got {act!r}")
    swiglu = act == "swiglu"
    if swiglu and w_gate is None:
        raise ValueError("act='swiglu' needs w_gate")
    has_ln = ln_scale is not None
    H = x.shape[-1]
    dt = x.dtype
    dev = x.device
    lns = (ln_scale.float().reshape(H) if has_ln
           else torch.ones(H, dtype=torch.float32, device=dev))
    lnb = (ln_bias.float().reshape(H) if has_ln
           else torch.zeros(H, dtype=torch.float32, device=dev))
    w1, w2 = w1.to(dt).contiguous(), w2.to(dt).contiguous()
    b1, b2 = b1.to(dt).reshape(-1), b2.to(dt).reshape(-1)
    wg = bg = None
    if swiglu:
        wg = w_gate.to(dt).contiguous()
        bg = (b_gate.to(dt).reshape(-1) if b_gate is not None
              else torch.zeros(w1.shape[1], dtype=dt, device=dev))
    lead = x.shape[:-1]
    x2 = x.reshape(-1, H).contiguous()
    args = (x2, lns.contiguous(), lnb.contiguous(), w1, b1.contiguous(), w2,
            b2.contiguous(), wg, None if bg is None else bg.contiguous())
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in args):
        y = _FusedLnMlp.apply(*args, act, bool(residual), has_ln,
                              float(eps))
    else:
        y = _fmlp_forward(*args, act, bool(residual), has_ln,
                          float(eps))[0]
    return y.reshape(*lead, H)


# --------------------------------------------------------------------------
# fused residual add + LayerNorm: LN(x + y)
# --------------------------------------------------------------------------

def _addln_forward_reference(x2, y2, s, b, eps):
    """Plain version of the forward kernel: x2, y2 (R, H) in one dtype;
    s, b (H,) f32. Returns (out (R, H) in x2's dtype, mu (R, 1) f32,
    rstd (R, 1) f32), with the add in f32 and the two-pass variance."""
    t = x2.float() + y2.float()
    mu = t.mean(-1, keepdim=True)
    var = (t - mu).square().mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    return ((t - mu) * rstd * s + b).to(x2.dtype), mu, rstd


def _addln_backward_reference(x2, y2, s, mu, rstd, do):
    """Plain version of the backward kernels: (dx in x2's dtype, ds f32,
    db f32), with the cotangent first rounded to x2's dtype."""
    xhat = (x2.float() + y2.float() - mu) * rstd
    do = do.to(x2.dtype).float()
    ds = (do * xhat).sum(0)
    db = do.sum(0)
    dxhat = do * s
    mean1 = dxhat.mean(-1, keepdim=True)
    mean2 = (dxhat * xhat).mean(-1, keepdim=True)
    return (rstd * (dxhat - mean1 - xhat * mean2)).to(x2.dtype), ds, db


def _addln_load():
    global _addln_lib
    if _addln_lib is None:
        lib = _build.load("fused_add_ln")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_add_ln_fwd.argtypes = [p] * 7 + [i, i, ctypes.c_float,
                                                   i, p]
        lib.fused_add_ln_bwd.argtypes = [p] * 10 + [i] * 4 + [p]
        lib.fused_add_ln_bwd_blocks.argtypes = [i, i, i]
        for fn in (lib.fused_add_ln_fwd, lib.fused_add_ln_bwd,
                   lib.fused_add_ln_bwd_blocks):
            fn.restype = ctypes.c_int
        lib.ptt_error_string.argtypes = [ctypes.c_int]
        lib.ptt_error_string.restype = ctypes.c_char_p
        _addln_lib = lib
    return _addln_lib


def _addln_check(x2, y2, *ln):
    """The kernels' contract, checked before anything is launched; ``ln``
    is the LayerNorm scale (and bias)."""
    if x2.dtype not in _DTYPES:
        raise TypeError(f"fused_add_layernorm takes f32 or bf16, got "
                        f"{x2.dtype}")
    if y2.dtype != x2.dtype or y2.shape != x2.shape:
        raise ValueError(f"x {tuple(x2.shape)}/{x2.dtype} and y "
                         f"{tuple(y2.shape)}/{y2.dtype} must match")
    R, H = x2.shape
    if not 0 < H <= ADDLN_MAX_H:
        raise ValueError(f"fused_add_layernorm kernels take rows of 1 to "
                         f"{ADDLN_MAX_H} values, got H={H}")
    for t in ln:
        if t.dtype != torch.float32 or t.shape != (H,):
            raise ValueError("LayerNorm scale and bias must be f32 (H,)")
    if any(t.device != x2.device for t in (y2, *ln)):
        raise ValueError("fused_add_layernorm inputs must lie on one device")
    if not all(t.is_contiguous() for t in (x2, y2, *ln)):
        raise ValueError("fused_add_layernorm needs contiguous inputs")


def _addln_launch_fwd(x2, y2, s, b, eps):
    """Forward kernel on CUDA tensors: (out, mu, rstd)."""
    global ADDLN_FWD_LAUNCHES
    _addln_check(x2, y2, s, b)
    lib = _addln_load()
    R, H = x2.shape
    out = torch.empty_like(x2)
    mu = torch.empty((R, 1), dtype=torch.float32, device=x2.device)
    rstd = torch.empty((R, 1), dtype=torch.float32, device=x2.device)
    with torch.cuda.device(x2.device):
        err = lib.fused_add_ln_fwd(
            x2.data_ptr(), y2.data_ptr(), s.data_ptr(), b.data_ptr(),
            out.data_ptr(), mu.data_ptr(), rstd.data_ptr(), R, H,
            float(eps), _DTYPES[x2.dtype], _stream(x2))
    _build.check(lib, err, "fused_add_ln_fwd")
    ADDLN_FWD_LAUNCHES += 1
    return out, mu, rstd


def _addln_launch_bwd(x2, y2, s, mu, rstd, do):
    """Backward kernels on CUDA tensors: (dx, ds f32, db f32). One C
    call: the row pass writes dx and one partial (ds, db) row per block
    into a scratch buffer, a second launch sums the partials."""
    global ADDLN_BWD_LAUNCHES
    _addln_check(x2, y2, s)
    do = do.to(x2.dtype).contiguous()
    mu, rstd = mu.contiguous(), rstd.contiguous()
    if do.shape != x2.shape or mu.numel() != x2.shape[0] \
            or rstd.numel() != x2.shape[0]:
        raise ValueError("dout must match x and mu/rstd hold one value a "
                         "row")
    lib = _addln_load()
    R, H = x2.shape
    dev = x2.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    G = lib.fused_add_ln_bwd_blocks(R, H, sms)
    dx = torch.empty_like(x2)
    part = torch.empty((2, max(G, 1), H), dtype=torch.float32, device=dev)
    ds = torch.empty(H, dtype=torch.float32, device=dev)
    db = torch.empty(H, dtype=torch.float32, device=dev)
    if R == 0:
        return dx, ds.zero_(), db.zero_()
    with torch.cuda.device(dev):
        err = lib.fused_add_ln_bwd(
            x2.data_ptr(), y2.data_ptr(), s.data_ptr(), mu.data_ptr(),
            rstd.data_ptr(), do.data_ptr(), dx.data_ptr(), part.data_ptr(),
            ds.data_ptr(), db.data_ptr(), G, R, H, _DTYPES[x2.dtype],
            _stream(x2))
    _build.check(lib, err, "fused_add_ln_bwd")
    ADDLN_BWD_LAUNCHES += 1
    return dx, ds, db


def _addln_forward(x2, y2, s, b, eps):
    if x2.device.type == "cuda":
        return _addln_launch_fwd(x2, y2, s, b, eps)
    return _addln_forward_reference(x2, y2, s, b, eps)


def _addln_backward(x2, y2, s, mu, rstd, do):
    if x2.device.type == "cuda":
        return _addln_launch_bwd(x2, y2, s, mu, rstd, do)
    return _addln_backward_reference(x2, y2, s, mu, rstd, do)


class _FusedAddLn(torch.autograd.Function):
    """LN(x + y); saves mu and rstd, and the backward kernels give dx
    (for both x and y) and the f32 ds and db (the JAX package's
    ``_addln`` custom VJP)."""

    @staticmethod
    def forward(ctx, x2, y2, s, b, eps):
        out, mu, rstd = _addln_forward(x2, y2, s, b, eps)
        ctx.save_for_backward(x2, y2, s, mu, rstd)
        return out

    @staticmethod
    def backward(ctx, do):
        x2, y2, s, mu, rstd = ctx.saved_tensors
        dx, ds, db = _addln_backward(x2, y2, s, mu, rstd, do)
        return dx, dx, ds, db, None


def fused_add_layernorm(x, y, scale, bias, eps=1e-5):
    """``LN(x + y)`` over the last axis, fused: the post-LN residual
    pattern. x and y [..., H] in one dtype (f32 or bf16), scale and bias
    (H,) (used in f32). Differentiable: the backward is the backward
    kernels (the plain version on a CPU tensor)."""
    H = x.shape[-1]
    lead = x.shape[:-1]
    args = (x.reshape(-1, H).contiguous(), y.reshape(-1, H).contiguous(),
            scale.float().reshape(H).contiguous(),
            bias.float().reshape(H).contiguous())
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        out = _FusedAddLn.apply(*args, float(eps))
    else:
        out = _addln_forward(*args, float(eps))[0]
    return out.reshape(*lead, H)
