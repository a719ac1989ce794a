"""``cross_entropy`` (``paddle_tpu/nn/functional/loss.py:66``): softmax
(or given probabilities) and the log-likelihood of hard or soft labels,
``ignore_index`` rows masked out of the mean, optional class weights."""
from __future__ import annotations

import torch

from ...framework.core import apply_op

__all__ = ["cross_entropy"]


def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def _cross_entropy(x, label, w=None, soft_label=False, use_softmax=True,
                   ignore_index=-100, reduction="mean", axis=-1):
    if use_softmax:
        logp = torch.log_softmax(x, dim=axis)
    else:
        logp = torch.log(torch.clamp_min(x, 1e-30))
    if soft_label:
        loss = -(label * logp).sum(axis)
        if w is None:
            return _reduce(loss, reduction)
        wt = (label * w).sum(axis)
    else:
        lab = label
        if lab.dim() == x.dim() and lab.shape[axis] == 1:
            lab = lab.squeeze(axis)
        ignored = lab == ignore_index
        safe = torch.where(ignored, torch.zeros_like(lab), lab).long()
        loss = -torch.take_along_dim(logp, safe.unsqueeze(axis),
                                     dim=axis).squeeze(axis)
        mask = (~ignored).to(loss.dtype)
        loss = loss * mask
        if w is None:
            if reduction == "mean":
                return loss.sum() / torch.clamp_min(mask.sum(), 1.0)
            return _reduce(loss, reduction)
        wt = w[safe] * mask
    loss = loss * wt
    if reduction == "mean":
        return loss.sum() / torch.clamp_min(wt.sum(), 1e-12)
    return _reduce(loss, reduction)


def cross_entropy(input, label, weight=None, ignore_index=-100,  # noqa: A002
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, name=None):
    ii = int(ignore_index) if not soft_label else -100
    return apply_op(_cross_entropy, input, label, weight,
                    soft_label=bool(soft_label),
                    use_softmax=bool(use_softmax), ignore_index=ii,
                    reduction=reduction, axis=int(axis))
