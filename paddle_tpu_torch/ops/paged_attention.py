"""Paged-attention decode: the hand-written CUDA kernel
(``csrc/paged_attention.cu``) and its plain PyTorch version.

Counterpart of ``paddle_tpu/ops/paged_attention.py``: one query per slot
attends over that slot's K/V, scattered over a block pool and named by
the slot's block table. The pool may be one layer ``(n_blocks, nh, bs,
hd)`` (the JAX signature) or the engine's whole pool ``(n_blocks, L, nh,
bs, hd)`` with ``layer=i``: the kernel then reads layer ``i`` in place,
and no per-layer slice is copied.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..core import flags
from . import _build
from .flash_attention import NEG_INF

__all__ = ["paged_attention_arrays", "LAUNCHES"]

# kernel launches since the last reset (the wrapper adds one per launch)
LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _paged_attention_reference(q, kb, vb, tables, lengths, scale):
    """Plain version: gather each slot's blocks into a contiguous
    (nh, W·bs, hd) view, mask positions >= length, softmax in f32.

    q (B, nh, hd); kb/vb (n_blocks, nh, bs, hd); tables (B, W) int;
    lengths (B,) int. Returns (B, nh, hd) in q.dtype. A slot of length 0
    gets the uniform average (the kernel returns zeros there)."""
    B, nh, hd = q.shape
    bs = kb.shape[2]
    W = tables.shape[1]
    tables = tables.long()
    k = kb[tables].permute(0, 2, 1, 3, 4).reshape(B, nh, W * bs, hd)
    v = vb[tables].permute(0, 2, 1, 3, 4).reshape(B, nh, W * bs, hd)
    s = torch.einsum("bhd,bhkd->bhk", q, k.to(q.dtype)) * scale
    live = torch.arange(W * bs, device=q.device)[None, :] \
        < lengths.to(q.device)[:, None]
    s = torch.where(live[:, None, :], s,
                    torch.tensor(NEG_INF, dtype=s.dtype, device=s.device))
    w = torch.softmax(s.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhk,bhkd->bhd", w, v.to(q.dtype))


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("paged_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.paged_attention_decode.argtypes = [p] * 6 + [i] * 8 + [
            ctypes.c_float, i, p]
        lib.paged_attention_decode.restype = i
        lib.paged_attention_cluster.argtypes = [i, i, i]
        lib.paged_attention_cluster.restype = i
        lib.paged_attention_smem_bytes.argtypes = [i, i, i]
        lib.paged_attention_smem_bytes.restype = i
        lib.paged_attention_resident.argtypes = [i] * 6
        lib.paged_attention_resident.restype = i
        lib.ptt_error_string.argtypes = [i]
        lib.ptt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def cluster_size(B, nh, W):
    """Blocks of the kernel's cluster per (slot, head) at B slots, nh
    heads and tables of width W: each slot's live blocks are split over
    that many (builds the kernel)."""
    return _load().paged_attention_cluster(B, nh, W)


def _launch(q, kb, vb, tables, lengths, scale, layer):
    global LAUNCHES
    if q.dtype not in _DTYPES or kb.dtype != q.dtype or vb.dtype != q.dtype:
        raise TypeError(f"paged attention takes f32 or bf16 q/pool of one "
                        f"dtype, got {q.dtype}/{kb.dtype}/{vb.dtype}")
    if kb.dim() != 5 or kb.shape != vb.shape or q.dim() != 3:
        raise ValueError(f"q {tuple(q.shape)} / pool {tuple(kb.shape)} are "
                         "not (B, nh, hd) / (n_blocks, L, nh, bs, hd)")
    n_blocks, L, nh, bs, hd = kb.shape
    B = q.shape[0]
    if q.shape[1:] != (nh, hd):
        raise ValueError(f"q {tuple(q.shape)} does not match the pool's "
                         f"heads/head_dim ({nh}, {hd})")
    if tables.dim() != 2 or tables.shape[0] != B or lengths.shape != (B,):
        raise ValueError(f"tables {tuple(tables.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match batch {B}")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("tables and lengths must be int32")
    for t in (kb, vb, tables, lengths):
        if t.device != q.device:
            raise ValueError("q, pool, tables and lengths must lie on one "
                             "device")
    if not all(t.is_contiguous() for t in (q, kb, vb, tables, lengths)):
        raise ValueError("paged attention needs contiguous q, pool, tables "
                         "and lengths")
    if hd not in (32, 64, 128) or bs not in (8, 16, 32):
        raise ValueError(f"head_dim {hd} (needs 32, 64 or 128) or "
                         f"block_size {bs} (needs 8, 16 or 32) is not "
                         "taken by the kernel")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} outside the pool's {L} layers")
    o = torch.empty_like(q)
    if B == 0:
        return o               # nothing to launch
    _load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib.paged_attention_decode(
            q.data_ptr(), kb.data_ptr(), vb.data_ptr(), tables.data_ptr(),
            lengths.data_ptr(), o.data_ptr(), B, nh, hd, bs, tables.shape[1],
            L, int(layer), n_blocks, float(scale), _DTYPES[q.dtype], stream)
    _build.check(_lib, err, "paged_attention_decode")
    LAUNCHES += 1
    return o


def paged_attention_arrays(q, kb, vb, tables, lengths, scale=None,
                           ragged=None, layer=None):
    """Single-token paged attention over a block pool.

    q (B, nh, hd); kb/vb one layer (n_blocks, nh, bs, hd), or the whole
    pool (n_blocks, L, nh, bs, hd) with ``layer``; tables (B, W) int32
    (entries past a slot's live blocks point at a safe block — the engine
    reserves pool block 0); lengths (B,) int32 live tokens.

    ``ragged`` (None follows FLAGS_ragged_decode) is kept for signature
    parity: the kernel only ever walks live blocks, so both settings give
    bit-identical output. CUDA tensors launch the kernel; CPU tensors run
    the plain version."""
    hd = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    if ragged is None:
        ragged = flags.ragged_decode[0]
    del ragged   # the kernel's loop bound already tracks live tokens
    if layer is None:
        kb, vb, layer = kb[:, None], vb[:, None], 0
    if q.device.type == "cuda":
        return _launch(q, kb, vb, tables, lengths, scale, layer)
    return _paged_attention_reference(q, kb[:, layer], vb[:, layer], tables,
                                      lengths, scale)
