"""The loss layers (port of ``paddle_tpu/nn/layers/loss.py``): each holds
its options and calls its functional in ``nn.functional.loss``;
``HSigmoidLoss`` also holds the internal nodes' weight table
(num_classes - 1, D) and bias."""
from __future__ import annotations

from .. import functional as F
from ..layer import Layer

__all__ = ["CrossEntropyLoss", "MSELoss", "L1Loss", "NLLLoss", "BCELoss",
           "BCEWithLogitsLoss", "KLDivLoss", "SmoothL1Loss",
           "MarginRankingLoss", "HingeEmbeddingLoss", "CosineEmbeddingLoss",
           "TripletMarginLoss", "CTCLoss", "HSigmoidLoss"]


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

    def forward(self, input, label):
        return F.cross_entropy(input, label, weight=self.weight,
                               ignore_index=self.ignore_index,
                               reduction=self.reduction,
                               soft_label=self.soft_label, axis=self.axis,
                               use_softmax=self.use_softmax)


class MSELoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.mse_loss(input, label, self.reduction)


class L1Loss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.l1_loss(input, label, self.reduction)


class NLLLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 name=None):
        super().__init__()
        self.weight, self.ignore_index = weight, ignore_index
        self.reduction = reduction

    def forward(self, input, label):
        return F.nll_loss(input, label, self.weight, self.ignore_index,
                          self.reduction)


class BCELoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight, self.reduction = weight, reduction

    def forward(self, input, label):
        return F.binary_cross_entropy(input, label, self.weight,
                                      self.reduction)


class BCEWithLogitsLoss(Layer):
    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None):
        super().__init__()
        self.weight, self.reduction = weight, reduction
        self.pos_weight = pos_weight

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(
            logit, label, self.weight, self.reduction, self.pos_weight)


class KLDivLoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.kl_div(input, label, self.reduction)


class SmoothL1Loss(Layer):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__()
        self.reduction, self.delta = reduction, delta

    def forward(self, input, label):
        return F.smooth_l1_loss(input, label, self.reduction, self.delta)


class MarginRankingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin, self.reduction = margin, reduction

    def forward(self, input, other, label):
        return F.margin_ranking_loss(input, other, label, self.margin,
                                     self.reduction)


class HingeEmbeddingLoss(Layer):
    def __init__(self, margin=1.0, reduction="mean", name=None):
        super().__init__()
        self.margin, self.reduction = margin, reduction

    def forward(self, input, label):
        return F.hinge_embedding_loss(input, label, self.margin,
                                      self.reduction)


class CosineEmbeddingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin, self.reduction = margin, reduction

    def forward(self, input1, input2, label):
        return F.cosine_embedding_loss(input1, input2, label, self.margin,
                                       self.reduction)


class TripletMarginLoss(Layer):
    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self.margin, self.p, self.epsilon = margin, p, epsilon
        self.swap, self.reduction = swap, reduction

    def forward(self, input, positive, negative):
        return F.triplet_margin_loss(input, positive, negative, self.margin,
                                     self.p, self.epsilon, self.swap,
                                     self.reduction)


class CTCLoss(Layer):
    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank, self.reduction = blank, reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          self.blank, self.reduction, norm_by_times)


class HSigmoidLoss(Layer):
    """Hierarchical sigmoid loss layer (reference nn/layer/loss.py
    HSigmoidLoss). Holds the internal-node weight table (num_classes-1, D)
    and optional bias; see functional.hsigmoid_loss for the tree encoding."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False, name=None):
        super().__init__()
        if not is_custom and num_classes < 2:
            raise ValueError("num_classes must be >= 2 for the default tree")
        self.num_classes = num_classes
        self.is_custom = is_custom
        rows = num_classes - 1 if not is_custom else num_classes
        self.weight = self.create_parameter((rows, feature_size),
                                            attr=weight_attr)
        if bias_attr is False:
            self.bias = None
        else:
            self.bias = self.create_parameter((rows, 1), attr=bias_attr,
                                              is_bias=True)

    def forward(self, input, label, path_table=None, path_code=None):
        bias = self.bias.reshape(-1) if self.bias is not None else None
        return F.hsigmoid_loss(input, label, self.num_classes, self.weight,
                               bias, path_table=path_table,
                               path_code=path_code)
