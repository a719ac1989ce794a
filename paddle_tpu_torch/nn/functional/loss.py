"""Loss functionals (``paddle_tpu/nn/functional/loss.py``).

``cross_entropy`` (``:66``): softmax (or given probabilities) and the
log-likelihood of hard or soft labels, ``ignore_index`` rows masked out
of the mean, optional class weights. ``nll_loss``, ``mse_loss``,
``l1_loss``, ``smooth_l1_loss``, ``binary_cross_entropy``,
``binary_cross_entropy_with_logits`` and ``kl_div`` (``:100-232``) with
the JAX package's formulas. The rest (ctc, hsigmoid, margin-CE, npair,
focal, dice, triplet, the ranking and embedding losses) is not ported
yet (ROADMAP.md Queue 1 item 8 step 1)."""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...framework.core import apply_op

__all__ = ["cross_entropy", "nll_loss", "mse_loss", "l1_loss",
           "smooth_l1_loss", "binary_cross_entropy",
           "binary_cross_entropy_with_logits", "kl_div", "square_error_cost"]


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


def _nll(x, label, w=None, reduction="mean", ignore_index=-100):
    loss = -torch.take_along_dim(x, label.long().unsqueeze(-1),
                                 dim=-1).squeeze(-1)
    if w is None:
        if ignore_index >= 0:
            mask = (label != ignore_index).to(loss.dtype)
            loss = loss * mask
            if reduction == "mean":
                return loss.sum() / torch.clamp_min(mask.sum(), 1.0)
        return _reduce(loss, reduction)
    wt = w[label.long()]
    if ignore_index >= 0:
        wt = wt * (label != ignore_index).to(loss.dtype)
    loss = loss * wt
    if reduction == "mean":
        return loss.sum() / torch.clamp_min(wt.sum(), 1e-12)
    return _reduce(loss, reduction)


def nll_loss(input, label, weight=None, ignore_index=-100,  # noqa: A002
             reduction="mean", name=None):
    """``input`` holds log-probabilities [N, C, ...]; the class axis is
    moved last, as in the JAX package."""
    def fn(x, lab, w=None):
        if x.dim() > 2:
            x = x.movedim(1, -1)
        return _nll(x, lab, w, reduction=reduction,
                    ignore_index=int(ignore_index))

    return apply_op(fn, input, label, weight)


def mse_loss(input, label, reduction="mean", name=None):  # noqa: A002
    return apply_op(lambda x, y: _reduce(torch.square(x - y), reduction),
                    input, label)


def square_error_cost(input, label):  # noqa: A002
    return apply_op(lambda x, y: torch.square(x - y), input, label)


def l1_loss(input, label, reduction="mean", name=None):  # noqa: A002
    return apply_op(lambda x, y: _reduce(torch.abs(x - y), reduction),
                    input, label)


def _smooth_l1(x, y, reduction, delta):
    diff = torch.abs(x - y)
    loss = torch.where(diff < delta, 0.5 * diff * diff / delta,
                       diff - 0.5 * delta)
    return _reduce(loss, reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0,  # noqa: A002
                   name=None):
    return apply_op(_smooth_l1, input, label, reduction=reduction,
                    delta=float(delta))


def _bce(x, y, w=None, reduction="mean"):
    eps = 1e-12
    loss = -(y * torch.log(torch.clamp_min(x, eps))
             + (1 - y) * torch.log(torch.clamp_min(1 - x, eps)))
    return _reduce(loss if w is None else w * loss, reduction)


def binary_cross_entropy(input, label, weight=None,  # noqa: A002
                         reduction="mean", name=None):
    return apply_op(_bce, input, label, weight, reduction=reduction)


def _bce_logits(x, y, w=None, pw=None, reduction="mean"):
    if pw is not None:
        loss = -(pw * y * TF.logsigmoid(x) + (1 - y) * TF.logsigmoid(-x))
        return _reduce(loss, reduction)
    loss = (torch.clamp_min(x, 0) - x * y
            + torch.log1p(torch.exp(-torch.abs(x))))
    return _reduce(loss if w is None else w * loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    """With ``pos_weight`` the JAX package ignores ``weight``; so does
    the port."""
    if pos_weight is not None:
        return apply_op(_bce_logits, logit, label, None, pos_weight,
                        reduction=reduction)
    return apply_op(_bce_logits, logit, label, weight, reduction=reduction)


def _kl_div(x, y, reduction):
    loss = y * (torch.log(torch.clamp_min(y, 1e-12)) - x)
    if reduction == "batchmean":
        return loss.sum() / x.shape[0]
    return _reduce(loss, reduction)


def kl_div(input, label, reduction="mean", name=None):  # noqa: A002
    return apply_op(_kl_div, input, label, reduction=reduction)
