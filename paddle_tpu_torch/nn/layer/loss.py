"""Loss layers (``paddle_tpu/nn/layer/loss.py``; reference
python/paddle/nn/layer/loss.py), over ``nn/functional/loss.py``.
``HSigmoidLoss`` owns its [num_classes − 1, feature_size] node weights
(Xavier uniform) and biases (zeros)."""
from __future__ import annotations

from .. import functional as F
from .layers import Layer

__all__ = ["CrossEntropyLoss", "MSELoss", "L1Loss", "NLLLoss", "BCELoss",
           "BCEWithLogitsLoss", "SmoothL1Loss", "KLDivLoss",
           "MarginRankingLoss", "HingeEmbeddingLoss", "CosineEmbeddingLoss",
           "CTCLoss", "TripletMarginLoss", "HSigmoidLoss"]


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True, name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.use_softmax = use_softmax

    def forward(self, input, label):  # noqa: A002
        return F.cross_entropy(input, label, weight=self.weight,
                               ignore_index=self.ignore_index, reduction=self.reduction,
                               soft_label=self.soft_label, axis=self.axis,
                               use_softmax=self.use_softmax)


class MSELoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return F.mse_loss(input, label, self.reduction)


class L1Loss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return F.l1_loss(input, label, self.reduction)


class NLLLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean", name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return F.nll_loss(input, label, self.weight, self.ignore_index, self.reduction)


class BCELoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return F.binary_cross_entropy(input, label, self.weight, self.reduction)


class BCEWithLogitsLoss(Layer):
    def __init__(self, weight=None, reduction="mean", pos_weight=None, name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction
        self.pos_weight = pos_weight

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(logit, label, self.weight,
                                                  self.reduction, self.pos_weight)


class SmoothL1Loss(Layer):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__()
        self.reduction = reduction
        self.delta = delta

    def forward(self, input, label):  # noqa: A002
        return F.smooth_l1_loss(input, label, self.reduction, self.delta)


class KLDivLoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return F.kl_div(input, label, self.reduction)


class MarginRankingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input, other, label):  # noqa: A002
        return F.margin_ranking_loss(input, other, label, self.margin,
                                     self.reduction)


class HingeEmbeddingLoss(Layer):
    def __init__(self, margin=1.0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return F.hinge_embedding_loss(input, label, self.margin,
                                      self.reduction)


class CosineEmbeddingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input1, input2, label):
        return F.cosine_embedding_loss(input1, input2, label, self.margin,
                                       self.reduction)


class CTCLoss(Layer):
    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank = blank
        self.reduction = reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          self.blank, self.reduction, norm_by_times)


class TripletMarginLoss(Layer):
    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self.args = (margin, p, epsilon, swap, reduction)

    def forward(self, input, positive, negative):  # noqa: A002
        return F.triplet_margin_loss(input, positive, negative, *self.args)


class HSigmoidLoss(Layer):
    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None):
        super().__init__()
        from .. import initializer as I

        if not is_custom and num_classes < 2:
            raise ValueError("num_classes must be >= 2 for the default "
                             "tree")
        self._num_classes = num_classes
        self._is_custom = is_custom
        self.weight = self.create_parameter(
            shape=[num_classes - 1, feature_size], attr=weight_attr,
            default_initializer=I.XavierUniform())
        self.bias = self.create_parameter(shape=[num_classes - 1],
                                          attr=bias_attr, is_bias=True)

    def forward(self, input, label, path_table=None, path_code=None):  # noqa: A002
        if self._is_custom and (path_table is None or path_code is None):
            raise ValueError("a custom tree needs path_table and path_code")
        return F.hsigmoid_loss(input, label, self._num_classes, self.weight,
                               bias=self.bias, path_table=path_table,
                               path_code=path_code)
