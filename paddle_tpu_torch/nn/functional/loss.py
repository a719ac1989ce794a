"""Loss functionals (``paddle_tpu/nn/functional/loss.py``).

``cross_entropy`` (``:66``): softmax (or given probabilities) and the
log-likelihood of hard or soft labels, ``ignore_index`` rows masked out
of the mean, optional class weights. ``nll_loss``, ``mse_loss``,
``l1_loss``, ``smooth_l1_loss``, ``binary_cross_entropy``,
``binary_cross_entropy_with_logits`` and ``kl_div`` (``:100-232``), and
``softmax_with_cross_entropy``, the ranking and embedding losses,
``log_loss``, ``sigmoid_focal_loss``, ``dice_loss``, ``npair_loss``,
``ctc_loss``, ``triplet_margin_loss``, ``hsigmoid_loss`` and
``margin_cross_entropy`` (``:234-519``), all with the JAX package's
formulas.

``ctc_loss`` takes log-probabilities [T, N, C] and runs the JAX
package's log-space forward recursion over the blank-extended labels in
a Python loop over time; ``reduction="mean"`` divides each sequence's
loss by its label length first. ``hsigmoid_loss``'s default tree is the
complete binary tree of the reference's ``SimpleCode`` (class c coded as
c + num_classes, node j's weight row j − 1); a custom tree is given by
``path_table`` / ``path_code`` (−1 pads a path). ``margin_cross_entropy``
runs on one process: a group of more than one rank raises, as in the
JAX package."""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...framework.core import apply_op

__all__ = ["cross_entropy", "nll_loss", "mse_loss", "l1_loss",
           "smooth_l1_loss", "binary_cross_entropy",
           "binary_cross_entropy_with_logits", "kl_div", "square_error_cost",
           "softmax_with_cross_entropy", "margin_ranking_loss",
           "hinge_embedding_loss", "cosine_embedding_loss", "ctc_loss",
           "log_loss", "sigmoid_focal_loss", "dice_loss", "npair_loss",
           "triplet_margin_loss", "hsigmoid_loss", "margin_cross_entropy"]


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


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """The per-sample loss with the class axis kept (size 1), and the
    softmax when asked."""
    from ...tensor import unsqueeze
    from .activation import softmax

    loss = unsqueeze(cross_entropy(logits, label, soft_label=soft_label,
                                   ignore_index=ignore_index,
                                   reduction="none", axis=axis), axis)
    if return_softmax:
        return loss, softmax(logits, axis=axis)
    return loss


def _margin_ranking(x, y, label, margin, reduction):
    return _reduce(torch.clamp_min(-label * (x - y) + margin, 0.0),
                   reduction)


def margin_ranking_loss(input, other, label, margin=0.0,  # noqa: A002
                        reduction="mean", name=None):
    return apply_op(_margin_ranking, input, other, label,
                    margin=float(margin), reduction=reduction)


def _hinge_embedding(x, y, margin, reduction):
    return _reduce(torch.where(y == 1.0, x, torch.clamp_min(margin - x,
                                                            0.0)),
                   reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",  # noqa: A002
                         name=None):
    return apply_op(_hinge_embedding, input, label, margin=float(margin),
                    reduction=reduction)


def _cosine_embedding(x1, x2, y, margin, reduction):
    norms = (torch.linalg.vector_norm(x1, dim=-1)
             * torch.linalg.vector_norm(x2, dim=-1))
    cos = (x1 * x2).sum(-1) / torch.clamp_min(norms, 1e-12)
    return _reduce(torch.where(y == 1, 1 - cos,
                               torch.clamp_min(cos - margin, 0.0)),
                   reduction)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    return apply_op(_cosine_embedding, input1, input2, label,
                    margin=float(margin), reduction=reduction)


def _log_loss(x, label, epsilon):
    return (-label * torch.log(x + epsilon)
            - (1 - label) * torch.log(1 - x + epsilon))


def log_loss(input, label, epsilon=1e-4, name=None):  # noqa: A002
    return apply_op(_log_loss, input, label, epsilon=float(epsilon))


def _sigmoid_focal(x, label, normalizer=None, alpha=0.25, gamma=2.0,
                   reduction="sum"):
    p = torch.sigmoid(x)
    ce = (torch.clamp_min(x, 0) - x * label
          + torch.log1p(torch.exp(-torch.abs(x))))
    p_t = p * label + (1 - p) * (1 - label)
    a_t = alpha * label + (1 - alpha) * (1 - label)
    loss = a_t * torch.pow(1 - p_t, gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    return apply_op(_sigmoid_focal, logit, label, normalizer,
                    alpha=float(alpha), gamma=float(gamma),
                    reduction=reduction)


def _dice(x, label, epsilon):
    if label.shape[-1] == 1:
        label = label.squeeze(-1)
    label = TF.one_hot(label.long(), x.shape[-1]).to(x.dtype)
    dims = tuple(range(1, x.ndim))
    inter = (x * label).sum(dims)
    union = x.sum(dims) + label.sum(dims)
    return (1 - (2 * inter + epsilon) / (union + epsilon)).mean()


def dice_loss(input, label, epsilon=1e-5, name=None):  # noqa: A002
    return apply_op(_dice, input, label, epsilon=float(epsilon))


def _npair(anchor, positive, labels, l2_reg):
    reg = ((anchor * anchor).sum(-1).mean()
           + (positive * positive).sum(-1).mean()) * l2_reg * 0.25
    sim = anchor @ positive.T
    lab = labels.reshape(-1)
    target = (lab[:, None] == lab[None, :]).to(anchor.dtype)
    target = target / target.sum(1, keepdim=True)
    ce = -(target * torch.log_softmax(sim, -1)).sum(-1).mean()
    return ce + reg


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    return apply_op(_npair, anchor, positive, labels, l2_reg=float(l2_reg))


_CTC_NEG = -1e30


def _ctc(log_probs, labels, input_lengths, label_lengths, blank=0,
         reduction="mean"):
    T, N, C = log_probs.shape
    L = labels.shape[1]
    S = 2 * L + 1
    dev = log_probs.device
    labels = labels.long()
    ext = torch.full((N, S), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels
    same = torch.cat([torch.ones((N, 2), dtype=torch.bool, device=dev),
                      ext[:, 2:] == ext[:, :-2]], 1)
    can_skip = (ext != blank) & ~same
    neg = torch.full((N, 1), _CTC_NEG, dtype=log_probs.dtype, device=dev)
    neg2 = torch.full((N, 2), _CTC_NEG, dtype=log_probs.dtype, device=dev)
    lp0 = log_probs[0]
    first = torch.gather(lp0, 1, ext[:, :2])
    if L == 0:
        first = torch.cat([first[:, :1], neg], 1)
    alpha = torch.cat([first, torch.full((N, S - 2), _CTC_NEG,
                                         dtype=log_probs.dtype, device=dev)],
                      1)
    alphas = [alpha]
    for t in range(1, T):
        prev1 = torch.cat([neg, alpha[:, :-1]], 1)
        prev2 = torch.cat([neg2, alpha[:, :-2]], 1)
        prev2 = torch.where(can_skip, prev2, torch.full_like(prev2,
                                                             _CTC_NEG))
        m = torch.maximum(torch.maximum(alpha, prev1), prev2)
        m = torch.clamp_min(m, _CTC_NEG)
        summed = (torch.exp(alpha - m) + torch.exp(prev1 - m)
                  + torch.exp(prev2 - m))
        alpha = (m + torch.log(torch.clamp_min(summed, 1e-37))
                 + torch.gather(log_probs[t], 1, ext))
        alphas.append(alpha)
    all_alpha = torch.stack(alphas, 0)                      # [T, N, S]
    rows = torch.arange(N, device=dev)
    t_idx = torch.clamp(input_lengths.long() - 1, 0, T - 1)
    a_t = all_alpha[t_idx, rows]                            # [N, S]
    ll_ = label_lengths.long()
    a1 = a_t[rows, torch.clamp(2 * ll_, 0, S - 1)]
    a2 = a_t[rows, torch.clamp(2 * ll_ - 1, 0, S - 1)]
    m = torch.maximum(a1, a2)
    loss = -(m + torch.log(torch.exp(a1 - m) + torch.exp(a2 - m)))
    if reduction == "mean":
        return (loss / torch.clamp_min(ll_, 1).to(loss.dtype)).mean()
    return _reduce(loss, reduction)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC over log-probabilities [T, N, C], padded labels [N, L]."""
    if norm_by_times:
        raise NotImplementedError("ctc_loss(norm_by_times=True) is not "
                                  "ported")
    return apply_op(_ctc, log_probs, labels, input_lengths, label_lengths,
                    blank=int(blank), reduction=reduction)


def _triplet_margin(a, p, n, margin, p_norm, eps, swap, reduction):
    def d(x, y):
        return torch.pow(torch.pow(torch.abs(x - y) + eps, p_norm).sum(-1),
                         1.0 / p_norm)

    dp, dn = d(a, p), d(a, n)
    if swap:
        dn = torch.minimum(dn, d(p, n))
    return _reduce(torch.clamp_min(dp - dn + margin, 0.0), reduction)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,  # noqa: A002
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    return apply_op(_triplet_margin, input, positive, negative,
                    margin=float(margin), p_norm=float(p),
                    eps=float(epsilon), swap=bool(swap), reduction=reduction)


def _hsigmoid_default(x, label, w, b=None, num_classes=2, depth=1):
    c = label.reshape(-1).long() + num_classes
    length = torch.zeros_like(c)
    for j in range(1, depth + 1):
        length = length + ((c >> j) > 0).long()
    if b is not None:
        b = b.reshape(-1)
    loss = torch.zeros(c.shape, dtype=x.dtype, device=x.device)
    for bit in range(depth):
        idx = (c >> (bit + 1)) - 1
        live = bit < length
        safe = torch.where(live, idx, torch.zeros_like(idx))
        bitv = ((c >> bit) & 1).to(x.dtype)
        pre = (x * w[safe]).sum(-1)
        if b is not None:
            pre = pre + b[safe]
        contrib = TF.softplus(pre) - bitv * pre
        loss = loss + torch.where(live, contrib, torch.zeros_like(contrib))
    return loss[:, None]


def _hsigmoid_custom(x, label, w, path_table, path_code, b=None):
    valid = path_table >= 0
    idx = torch.clamp_min(path_table, 0).long()
    pre = torch.einsum("nd,nld->nl", x, w[idx])
    if b is not None:
        pre = pre + b.reshape(-1)[idx]
    contrib = TF.softplus(pre) - path_code.to(x.dtype) * pre
    return torch.where(valid, contrib, torch.zeros_like(contrib)).sum(
        -1, keepdim=True)


def hsigmoid_loss(input, label, num_classes, weight, bias=None,  # noqa: A002
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid loss [N, 1]: input [N, D], label [N] or
    [N, 1], weight [num_classes − 1, D], bias [num_classes − 1].
    ``is_sparse`` chooses the reference's gradient storage only: the
    gradients here are dense either way."""
    if path_table is not None or path_code is not None:
        if path_table is None or path_code is None:
            raise ValueError("hsigmoid_loss: path_table and path_code must "
                             "be given together for a custom tree")
        return apply_op(_hsigmoid_custom, input, label, weight, path_table,
                        path_code, bias)
    if num_classes < 2:
        raise ValueError("hsigmoid_loss: num_classes must be >= 2")
    depth = int(2 * num_classes - 1).bit_length()
    return apply_op(_hsigmoid_default, input, label, weight, bias,
                    num_classes=int(num_classes), depth=depth)


def _margin_ce(logits, label, m1, m2, m3, scale, reduction,
               return_softmax):
    c = logits.shape[1]
    cos = torch.clamp(logits, -1.0, 1.0)
    one_hot = TF.one_hot(label.reshape(-1).long(), c).to(logits.dtype)
    target = torch.cos(m1 * torch.arccos(cos) + m2) - m3
    adjusted = torch.where(one_hot > 0, target, cos) * scale
    logp = torch.log_softmax(adjusted, -1)
    loss = -(one_hot * logp).sum(-1, keepdim=True)
    loss = _reduce(loss, reduction)
    return (loss, torch.exp(logp)) if return_softmax else loss


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean", name=None):
    """ArcFace / CosFace margin softmax cross-entropy on one process."""
    if group is not None and getattr(group, "nranks", 1) > 1:
        raise ValueError("margin_cross_entropy: a group of more than one "
                         "rank (the class axis sharded) is not ported")
    return apply_op(_margin_ce, logits, label, m1=float(margin1),
                    m2=float(margin2), m3=float(margin3), scale=float(scale),
                    reduction=reduction, return_softmax=bool(return_softmax))
