"""``diag_embed``, ``gather_tree``, ``temporal_shift`` and
``sparse_attention`` (``paddle_tpu/nn/functional/extension.py``).

``gather_tree`` walks the search tree back from the last step in a
Python loop (the JAX package's reverse ``lax.scan``). ``sparse_attention``
turns the CSR pattern into a dense boolean mask on the host, as the JAX
package does, and computes one masked softmax attention.
"""
from __future__ import annotations

import numpy as np
import torch

from ...framework.core import Tensor, _unwrap, apply_op

__all__ = ["diag_embed", "gather_tree", "temporal_shift", "sparse_attention"]


def _diag_embed(x, offset=0, dim1=-2, dim2=-1):
    return torch.diag_embed(x, offset, dim1, dim2)


def diag_embed(input, offset=0, dim1=-2, dim2=-1):  # noqa: A002
    """Batched diagonal matrices from the last axis of ``input``."""
    return apply_op(_diag_embed, input, offset=int(offset), dim1=int(dim1),
                    dim2=int(dim2))


def _gather_tree(ids, parents):
    # ids / parents [max_time, batch, beam]: carry the beam each sequence
    # occupies at step t + 1 back to step t
    T = ids.shape[0]
    beam = torch.arange(ids.shape[-1], device=ids.device).expand(
        ids.shape[1:]).to(parents.dtype)
    outs = [None] * T
    for t in range(T - 1, -1, -1):
        outs[t] = torch.gather(ids[t], -1, beam.long())
        beam = torch.gather(parents[t], -1, beam.long())
    return torch.stack(outs, 0)


def gather_tree(ids, parents):
    """Whole beam-search sequences from per-step ids and parents
    ([max_time, batch, beam])."""
    return apply_op(_gather_tree, ids, parents)


def _temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW"):
    if data_format == "NHWC":
        x = x.permute(0, 3, 1, 2)
    nt, c, h, w = x.shape
    r = x.reshape(-1, seg_num, c, h, w)
    pad = torch.nn.functional.pad(r, (0, 0, 0, 0, 0, 0, 1, 1))
    c1 = int(c * shift_ratio)
    c2 = int(c * 2 * shift_ratio)
    out = torch.cat([pad[:, :seg_num, :c1],             # from t - 1
                     pad[:, 2:seg_num + 2, c1:c2],      # from t + 1
                     pad[:, 1:seg_num + 1, c2:]], 2)    # unshifted
    out = out.reshape(nt, c, h, w)
    if data_format == "NHWC":
        out = out.permute(0, 2, 3, 1)
    return out


def temporal_shift(x, seg_num, shift_ratio=0.25, name=None,
                   data_format="NCHW"):
    """TSM's channel shift along the segment axis."""
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError("data_format must be NCHW or NHWC")
    return apply_op(_temporal_shift, x, seg_num=int(seg_num),
                    shift_ratio=float(shift_ratio), data_format=data_format)


def _masked_attention(q, k, v, mask):
    d = q.shape[-1]
    s = torch.einsum("bhld,bhmd->bhlm", q, k) / torch.sqrt(
        torch.tensor(float(d), dtype=q.dtype, device=q.device))
    s = torch.where(mask, s, torch.full_like(s, -1e9))
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask, p, torch.zeros_like(p))
    return torch.einsum("bhlm,bhmd->bhld", p, v)


def _host(x):
    x = _unwrap(x)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().astype(np.int64)
    return np.asarray(x, np.int64)


def sparse_attention(query, key, value, sparse_csr_offset,
                     sparse_csr_columns, name=None):
    """Attention restricted to a CSR pattern: q / k / v [B, H, L, D],
    offsets [B, H, L + 1], columns [B, H, nnz]."""
    off, col = _host(sparse_csr_offset), _host(sparse_csr_columns)
    B, H, L, _ = query.shape
    mask = np.zeros((B, H, L, L), bool)
    for b in range(B):
        for h in range(H):
            rows = np.repeat(np.arange(L), np.diff(off[b, h]))
            mask[b, h, rows, col[b, h, :len(rows)]] = True
    m = torch.as_tensor(mask, device=_unwrap(query).device)
    return apply_op(_masked_attention, query, key, value, Tensor(m))
