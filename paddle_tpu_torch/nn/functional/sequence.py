"""The sequence functions (``paddle_tpu/nn/functional/sequence.py``) on
padded tensors with explicit lengths, the JAX package's dense stand-in
for the reference's LoD tensors.

``sequence_mask`` with ``maxlen`` given reads nothing on the host, so a
captured training step can call it; without ``maxlen`` it reads the
longest length, as the JAX package does. ``sequence_unpad``,
``sequence_expand``, ``sequence_concat``, ``sequence_slice`` and the
``ignored_tokens`` of ``edit_distance`` resolve their lengths on the
host, as the JAX package does (their output shapes depend on them).
"""
from __future__ import annotations

import numpy as np
import torch

from ...framework import dtype as dtypes
from ...framework.core import Tensor, _as_torch, _unwrap, apply_op

__all__ = ["sequence_mask", "sequence_pad", "sequence_unpad",
           "sequence_reverse", "sequence_softmax", "sequence_expand",
           "edit_distance", "sequence_pool", "sequence_first_step",
           "sequence_last_step", "sequence_concat", "sequence_enumerate",
           "sequence_expand_as", "sequence_conv", "sequence_reshape",
           "sequence_scatter", "sequence_slice"]


def _data(x):
    x = _unwrap(x)
    return x if isinstance(x, torch.Tensor) else _as_torch(x)


def _host(x):
    return np.asarray(_data(x).detach().cpu().numpy())


def _mask(lengths, maxlen, dtype):
    r = torch.arange(maxlen, device=lengths.device)
    return (r[None, :] < lengths.reshape(-1, 1)).to(dtype)


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """[b] lengths → [b, maxlen] 0/1 mask (reference sequence_mask_op)."""
    if maxlen is None:
        arr = _data(x)
        maxlen = int(arr.max()) if arr.numel() else 0
    return apply_op(_mask, x, maxlen=int(maxlen),
                    dtype=dtypes.convert_dtype(dtype))


def sequence_pad(x, pad_value, maxlen=None, lengths=None, name=None):
    """A list of variable-length rows → (padded [b, maxlen, ...],
    lengths [b] int64); a padded tensor with ``lengths`` passes
    through."""
    if isinstance(x, (list, tuple)):
        seqs = [_data(s) for s in x]
        lens = [int(s.shape[0]) for s in seqs]
        m = int(maxlen) if maxlen is not None else max(lens)
        pv = float(_unwrap(pad_value)) if isinstance(pad_value, Tensor) \
            else float(pad_value)
        rows = []
        for s in seqs:
            s = s[:m]
            pad = torch.full((m - s.shape[0],) + tuple(s.shape[1:]), pv,
                             dtype=s.dtype, device=s.device)
            rows.append(torch.cat([s, pad], 0))
        return (Tensor(torch.stack(rows)),
                Tensor(torch.tensor(lens, dtype=torch.int64,
                                    device=seqs[0].device)))
    if lengths is None:
        raise ValueError("sequence_pad on a dense tensor needs lengths")
    return x, lengths


def sequence_unpad(x, length, name=None):
    """Padded [b, maxlen, ...] + lengths → a list of per-row Tensors."""
    arr = _data(x)
    lens = _host(length)
    return [Tensor._wrap(arr[i, :int(lens[i])]) for i in range(arr.shape[0])]


def _seq_reverse(x, lengths):
    t = x.shape[1]
    idx = torch.arange(t, device=x.device)[None, :]
    L = lengths.reshape(-1, 1).to(idx.dtype)
    rev = torch.where(idx < L, L - 1 - idx, idx)
    rev = rev.reshape(rev.shape + (1,) * (x.ndim - 2)).expand(x.shape)
    return torch.gather(x, 1, rev)


def sequence_reverse(x, lengths=None, name=None):
    """Reverse each row's first ``lengths[i]`` steps, padding in place
    (``lengths=None`` reverses whole rows)."""
    if lengths is None:
        d = _data(x)
        lengths = torch.full((d.shape[0],), d.shape[1], dtype=torch.int64,
                             device=d.device)
    return apply_op(_seq_reverse, x, lengths)


def _seq_softmax(x, lengths):
    t = x.shape[1]
    mask = torch.arange(t, device=x.device)[None, :] < lengths.reshape(-1, 1)
    s = torch.where(mask, x.float(), torch.full_like(x, -1e30,
                                                     dtype=torch.float32))
    p = torch.softmax(s, dim=1)
    return (p * mask).to(x.dtype)


def sequence_softmax(x, lengths, name=None):
    """Per-row softmax over time; padded steps get 0."""
    return apply_op(_seq_softmax, x, lengths)


def _take_rows(a, idx):
    return a.index_select(0, idx)


def sequence_expand(x, ref_lengths, name=None):
    """Row i repeated ``ref_lengths[i]`` times (lengths read on the
    host)."""
    reps = _host(ref_lengths).astype(np.int64)
    d = _data(x)
    idx = torch.as_tensor(np.repeat(np.arange(d.shape[0]), reps),
                          device=d.device)
    return apply_op(_take_rows, x, idx)


def _edit_distance(hyp, hyp_len, ref, ref_len):
    """Levenshtein table row by row over the hypothesis tokens, each row
    vectorized over the reference by the JAX package's cumulative-min
    form of the insertion chain."""
    B, T = hyp.shape
    L = ref.shape[1]
    cols = torch.arange(L + 1, dtype=torch.float32, device=hyp.device)
    prev = cols.expand(B, L + 1)
    for i in range(T):
        tok = hyp[:, i]
        sub = (ref != tok[:, None]).float()
        cand = torch.minimum(prev[:, 1:] + 1.0, prev[:, :-1] + sub)
        seed = torch.cat([prev[:, :1] + 1.0, cand], 1)
        chain = torch.cummin(seed - cols, 1).values + cols
        live = (i < hyp_len)[:, None]
        prev = torch.where(live, chain, prev)
    return prev.gather(1, ref_len.long().reshape(-1, 1))


def edit_distance(input, label, normalized=True, ignored_tokens=None,  # noqa: A002
                  input_length=None, label_length=None, name=None):
    """Levenshtein distance between padded token rows: (distances [B, 1]
    f32, sequence_num [1] int64); ``normalized`` divides by the
    reference's length."""
    hyp, ref = _data(input), _data(label)
    B, T = hyp.shape
    L = ref.shape[1]
    dev = hyp.device
    hl = (_data(input_length) if input_length is not None
          else torch.full((B,), T, dtype=torch.int64, device=dev))
    rl = (_data(label_length) if label_length is not None
          else torch.full((B,), L, dtype=torch.int64, device=dev))
    if ignored_tokens:
        def compact(arr, lens):
            a, ls = _host(arr), _host(lens)
            out, nl = np.zeros_like(a), np.zeros_like(ls)
            for b in range(a.shape[0]):
                row = [t for t in a[b, :ls[b]] if t not in ignored_tokens]
                out[b, :len(row)] = row
                nl[b] = len(row)
            return torch.as_tensor(out, device=dev), \
                torch.as_tensor(nl, device=dev)

        hyp, hl = compact(hyp, hl)
        ref, rl = compact(ref, rl)
    dist = _edit_distance(hyp, hl, ref, rl)
    if normalized:
        dist = dist / torch.clamp_min(rl.float(), 1.0)[:, None]
    return (Tensor(dist),
            Tensor(torch.tensor([B], dtype=torch.int64, device=dev)))


def _seq_time_mask(x, lengths):
    t = x.shape[1]
    m = torch.arange(t, device=x.device)[None, :] < lengths.reshape(-1, 1)
    return m.reshape(m.shape + (1,) * (x.ndim - 2))


def _seq_pool(x, lengths, pool_type="sum"):
    mask = _seq_time_mask(x, lengths).to(x.dtype)
    L = lengths.reshape((-1,) + (1,) * (x.ndim - 2)).to(x.dtype)
    if pool_type == "sum":
        return (x * mask).sum(1)
    if pool_type == "average":
        return (x * mask).sum(1) / torch.clamp_min(L, 1)
    if pool_type == "sqrt":
        return (x * mask).sum(1) / torch.sqrt(torch.clamp_min(L, 1))
    if pool_type == "max":
        return torch.where(mask > 0, x, torch.full_like(x, -1e30)).amax(1)
    if pool_type == "first":
        return x[:, 0]
    if pool_type == "last":
        idx = torch.clamp_min(lengths.long() - 1, 0)
        idx = idx.reshape((-1, 1) + (1,) * (x.ndim - 2)).expand(
            (x.shape[0], 1) + tuple(x.shape[2:]))
        return torch.gather(x, 1, idx)[:, 0]
    raise ValueError(f"unknown pool_type {pool_type!r}")


def sequence_pool(x, lengths, pool_type="sum", name=None):
    """Per-row pooling over the valid steps: sum, average, sqrt, max,
    first or last."""
    return apply_op(_seq_pool, x, lengths, pool_type=str(pool_type).lower())


def sequence_first_step(x, lengths, name=None):
    return sequence_pool(x, lengths, "first")


def sequence_last_step(x, lengths, name=None):
    return sequence_pool(x, lengths, "last")


def sequence_concat(inputs, lengths_list, name=None):
    """Each row's valid steps of every input, concatenated and padded to
    the longest total (lengths read on the host); returns (padded,
    lengths)."""
    arrs = [_data(i) for i in inputs]
    lens = [_host(n).astype(np.int64) for n in lengths_list]
    total = np.sum(lens, axis=0)
    T = int(total.max())
    rows = []
    for b in range(arrs[0].shape[0]):
        row = torch.cat([a[b, :int(n[b])] for a, n in zip(arrs, lens)], 0)
        pad = torch.zeros((T - row.shape[0],) + tuple(row.shape[1:]),
                          dtype=row.dtype, device=row.device)
        rows.append(torch.cat([row, pad], 0))
    return (Tensor(torch.stack(rows)),
            Tensor(torch.as_tensor(total.astype(np.int64),
                                   device=arrs[0].device)))


def _seq_enumerate(x, win_size, pad_value):
    t = x.shape[1]
    idx = (torch.arange(t, device=x.device)[:, None]
           + torch.arange(win_size, device=x.device)[None, :])
    g = x[:, torch.clamp_max(idx, t - 1)]
    return torch.where((idx < t)[None], g, torch.full_like(g, pad_value))


def sequence_enumerate(x, win_size, pad_value=0, name=None):
    """Every window of ``win_size`` ids: [B, T] → [B, T, win]."""
    return apply_op(_seq_enumerate, x, win_size=int(win_size),
                    pad_value=int(pad_value))


def sequence_expand_as(x, y_lengths, name=None):
    return sequence_expand(x, y_lengths)


def _seq_conv(x, lengths, w, context_start):
    B, T, D = x.shape
    ctx = w.shape[0] // D
    mask = _seq_time_mask(x, lengths).to(x.dtype)
    xm = x * mask
    cols = []
    t_all = torch.arange(T, device=x.device)
    for k in range(ctx):
        off = context_start + k
        shifted = torch.roll(xm, -off, 1)
        ok = ((t_all + off >= 0) & (t_all + off < T))[None, :, None]
        cols.append(torch.where(ok, shifted, torch.zeros_like(shifted)))
    out = torch.einsum("btc,cf->btf", torch.cat(cols, -1), w)
    return out * mask


def sequence_conv(x, lengths, weight, context_start=None, padding=True,
                  name=None):
    """Context-window convolution over each row's valid steps: weight
    [filter_size·D, num_filters], the context centred by default."""
    D = x.shape[-1]
    ctx = weight.shape[0] // D
    if context_start is None:
        context_start = -(ctx // 2)
    return apply_op(_seq_conv, x, lengths, weight,
                    context_start=int(context_start))


def _seq_reshape(x, lengths, new_dim):
    B, T, D = x.shape
    if (T * D) % new_dim:
        raise ValueError("T*D must be divisible by new_dim")
    return x.reshape(B, T * D // new_dim, new_dim), lengths * D // new_dim


def sequence_reshape(x, lengths, new_dim, name=None):
    """Each row's payload re-chunked to rows of ``new_dim``; every
    length·D must divide by it (checked on the host)."""
    new_dim = int(new_dim)
    D = int(x.shape[-1])
    if np.any(_host(lengths) * D % new_dim):
        raise ValueError(f"sequence_reshape: every length*input_dim must be "
                         f"divisible by new_dim={new_dim}")
    return apply_op(_seq_reshape, x, lengths, new_dim=new_dim)


def _seq_scatter(x, index, updates, lengths):
    L = index.shape[1]
    mask = (torch.arange(L, device=x.device)[None, :]
            < lengths.reshape(-1, 1))
    flat = torch.where(mask, index, torch.full_like(index, x.shape[0]))
    upd = updates * mask.reshape(mask.shape + (1,) * (updates.ndim - 2)).to(
        updates.dtype)
    grown = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))], 0)
    out = grown.index_add(0, flat.reshape(-1).long(),
                          upd.reshape((-1,) + tuple(updates.shape[2:])))
    return out[:-1]


def sequence_scatter(x, index, updates, lengths, name=None):
    """Scatter-add each row's first ``lengths[b]`` updates into ``x`` at
    ``index`` (duplicates add)."""
    return apply_op(_seq_scatter, x, index, updates, lengths)


def _seq_slice(x, offset, length, out_t):
    B, T = x.shape[0], x.shape[1]
    t_idx = (torch.arange(out_t, device=x.device)[None, :]
             + offset.reshape(-1, 1))
    valid = t_idx < (offset + length).reshape(-1, 1)
    g_idx = torch.clamp(t_idx, 0, T - 1).long()
    g_idx = g_idx.reshape(g_idx.shape + (1,) * (x.ndim - 2)).expand(
        (B, out_t) + tuple(x.shape[2:]))
    g = torch.gather(x, 1, g_idx)
    valid = valid.reshape(valid.shape + (1,) * (x.ndim - 2))
    return torch.where(valid, g, torch.zeros_like(g))


def sequence_slice(x, offset, length, name=None):
    """Each row's steps [offset, offset + length), padded to the longest
    (read on the host); returns (sliced, length)."""
    lens = _host(length)
    out_t = int(lens.max()) if lens.size else 0
    out = apply_op(_seq_slice, x, offset, length, out_t=out_t)
    return out, (length if isinstance(length, Tensor)
                 else Tensor(_data(length)))
