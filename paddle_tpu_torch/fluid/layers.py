"""fluid.layers (``paddle_tpu/fluid/layers.py``; reference
python/paddle/fluid/layers/).

The 2.x ops under their fluid-1.x names, with thin adapters where the
fluid signature differs (reduce_* dim / keep_dim, elementwise_* axis
broadcasting, probability-input cross_entropy, expand's repeat-times
semantics, 2-D flatten). LoD-coupled ops (dynamic_lstm / dynamic_gru,
lod_reset, op-level beam_search) refuse and name their padded-dense
replacements (paddle.nn.RNN / LSTM / GRU, the lengths-based sequence
ops, nn.decode's BeamSearchDecoder / dynamic_decode), as the JAX package
does. Every function works eagerly and records into a static program.
"""
from __future__ import annotations

import builtins
import math

import numpy as np
import torch
import torch.nn.functional as TF

from ..framework.core import Tensor, apply_op, records
from .. import tensor as _T
from ..nn import functional as _F
from ..static import accuracy, auc, py_func, Print  # noqa: F401
from ..static.nn import (  # noqa: F401
    batch_norm, bilinear_tensor_product, case, cond, conv2d,
    conv2d_transpose, conv3d, conv3d_transpose, crf_decoding, data_norm,
    deform_conv2d, embedding, group_norm, instance_norm, layer_norm,
    multi_box_head, nce, prelu, row_conv, sequence_concat, sequence_conv,
    sequence_enumerate, sequence_expand, sequence_expand_as,
    sequence_first_step, sequence_last_step, sequence_pad, sequence_pool,
    sequence_reshape, sequence_reverse, sequence_scatter, sequence_slice,
    sequence_softmax, sequence_unpad, sparse_embedding, spectral_norm,
    switch_case, while_loop,
)
from ..static import create_global_var  # noqa: F401
from ..tensor.creation import create_parameter  # noqa: F401

# direct re-exports: same name, same semantics
from ..tensor import (  # noqa: F401
    abs, cast, ceil, clip, concat, cos, cumsum, equal, exp, floor, gather,
    gather_nd, greater_equal, greater_than, increment, less_equal,
    less_than, log, logical_and, logical_not, logical_or, logical_xor,
    not_equal, ones, ones_like, pow, reciprocal, round, rsqrt, scale,
    scatter, shard_index, sign, sin, slice, sqrt, square, squeeze, stack,
    tanh, transpose, unsqueeze, unstack, zeros, zeros_like, shape,
    reverse, scatter_nd, scatter_nd_add, argmax, argmin, argsort, sort,
    topk, nonzero, split,
)
from ..nn.functional import (  # noqa: F401
    elu, gelu, hardshrink, hardsigmoid, hardswish, leaky_relu, log_loss,
    log_softmax, maxout, relu, relu6, selu, sigmoid, softmax, softplus,
    softshrink, softsign, swish, thresholded_relu, label_smooth,
    sigmoid_focal_loss, square_error_cost, softmax_with_cross_entropy,
    gather_tree, temporal_shift, affine_grid, one_hot,
    kl_div, npair_loss, edit_distance, sequence_mask, unfold,
    pixel_shuffle,
)
from ..nn.functional import grid_sample as grid_sampler  # noqa: F401
from ..vision.ops import (  # noqa: F401
    anchor_generator, box_clip, box_coder, bipartite_match,
    collect_fpn_proposals, distribute_fpn_proposals, generate_proposals,
    iou_similarity, matrix_nms, multiclass_nms, prior_box, psroi_pool,
    roi_align, roi_pool, yolo_box,
)
from ..vision.ops import yolo_loss as yolov3_loss  # noqa: F401
from ..text import viterbi_decode  # noqa: F401


def _device_of(t):
    d = t._data.device
    if d.type == "meta":
        from ..device import current_device

        return current_device()
    return d


def fc(input=None, size=None, num_flatten_dims=1, param_attr=None,  # noqa: A002
       bias_attr=None, act=None, name=None, x=None, activation=None,
       weight_attr=None):
    """1.x fc spelling (input= / act= / param_attr=) over static.nn.fc."""
    from ..static.nn import fc as _fc

    return _fc(input if input is not None else x, size,
               num_flatten_dims=num_flatten_dims,
               weight_attr=param_attr if param_attr is not None else weight_attr,
               bias_attr=bias_attr,
               activation=act if act is not None else activation, name=name)


def fill_constant(shape, dtype, value, force_cpu=False, out=None, name=None):
    from ..tensor.creation import full

    return full(shape, value, dtype=dtype)


def fill_constant_batch_size_like(input, shape, dtype, value,  # noqa: A002
                                  input_dim_idx=0, output_dim_idx=0):
    from ..tensor.creation import full

    shape = list(shape)
    shape[output_dim_idx] = input.shape[input_dim_idx]
    return full(shape, value, dtype=dtype)


def assign(input, output=None):  # noqa: A002
    from ..tensor.creation import assign as _assign

    return _assign(input, output)


def _reduce(fn, input, dim, keep_dim):  # noqa: A002
    if isinstance(dim, (list, tuple)):
        dim = [int(d) for d in dim]
    return fn(input, axis=dim, keepdim=keep_dim)


def reduce_sum(input, dim=None, keep_dim=False, name=None):  # noqa: A002
    return _reduce(_T.sum, input, dim, keep_dim)


def reduce_mean(input, dim=None, keep_dim=False, name=None):  # noqa: A002
    return _reduce(_T.mean, input, dim, keep_dim)


def reduce_max(input, dim=None, keep_dim=False, name=None):  # noqa: A002
    return _reduce(_T.max, input, dim, keep_dim)


def reduce_min(input, dim=None, keep_dim=False, name=None):  # noqa: A002
    return _reduce(_T.min, input, dim, keep_dim)


def reduce_prod(input, dim=None, keep_dim=False, name=None):  # noqa: A002
    return _reduce(_T.prod, input, dim, keep_dim)


def reduce_all(input, dim=None, keep_dim=False, name=None):  # noqa: A002
    return _reduce(_T.all, input, dim, keep_dim)


def reduce_any(input, dim=None, keep_dim=False, name=None):  # noqa: A002
    return _reduce(_T.any, input, dim, keep_dim)


def mean(x, name=None):
    return _T.mean(x)


def _ew_axis(y, x_ndim, axis):
    """fluid elementwise axis semantics: y's dims align to x's from
    ``axis`` on (elementwise_op_function.h GetMidDims)."""
    if axis == -1 or y.ndim == x_ndim:
        return y
    pad_right = x_ndim - axis - y.ndim
    return _T.reshape(y, list(y.shape) + [1] * pad_right)


def _make_elementwise(fn, name):
    def op(x, y, axis=-1, act=None, name=None):
        out = fn(x, _ew_axis(y, x.ndim, axis))
        if act is not None:
            out = getattr(_F, act)(out)
        return out

    op.__name__ = name
    return op


elementwise_add = _make_elementwise(_T.add, "elementwise_add")
elementwise_sub = _make_elementwise(_T.subtract, "elementwise_sub")
elementwise_mul = _make_elementwise(_T.multiply, "elementwise_mul")
elementwise_div = _make_elementwise(_T.divide, "elementwise_div")
elementwise_max = _make_elementwise(_T.maximum, "elementwise_max")
elementwise_min = _make_elementwise(_T.minimum, "elementwise_min")
elementwise_pow = _make_elementwise(_T.pow, "elementwise_pow")
elementwise_mod = _make_elementwise(_T.remainder, "elementwise_mod")
elementwise_floordiv = _make_elementwise(_T.floor_divide,
                                         "elementwise_floordiv")


def _mul_impl(x, y, x_num_col_dims=1, y_num_col_dims=1):
    xm = x.reshape(math.prod(x.shape[:x_num_col_dims]), -1)
    ym = y.reshape(math.prod(y.shape[:y_num_col_dims]), -1)
    # mul_op shape inference: x.shape[:xd] + y.shape[yd:]
    return (xm @ ym).reshape(tuple(x.shape[:x_num_col_dims])
                             + tuple(y.shape[y_num_col_dims:]))


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    """fluid.layers.mul (mul_op.cc): both sides flattened to 2-D, then a
    matmul."""
    return apply_op(_mul_impl, x, y, x_num_col_dims=int(x_num_col_dims),
                    y_num_col_dims=int(y_num_col_dims), op_name="mul")


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    out = _T.matmul(x, y, transpose_x=transpose_x, transpose_y=transpose_y)
    if alpha != 1.0:
        out = out * alpha
    return out


def _ce_soft_impl(p, lab):
    return -torch.sum(lab * torch.log(torch.clamp(p, min=1e-20)), dim=-1,
                      keepdim=True)


def _ce_prob_impl(p, label, ignore_index):
    lab = label.reshape(p.shape[:-1]).long()
    picked = torch.gather(p, -1, torch.clamp(lab, min=0).unsqueeze(-1)
                          ).squeeze(-1)
    loss = -torch.log(torch.clamp(picked, min=1e-20))
    loss = torch.where(lab == ignore_index, torch.zeros_like(loss), loss)
    return loss.unsqueeze(-1)


def cross_entropy(input, label, soft_label=False, ignore_index=-100):  # noqa: A002
    """fluid cross_entropy takes PROBABILITIES (post-softmax), unlike
    2.x F.cross_entropy's logits (reference cross_entropy_op.h)."""
    if soft_label:
        return apply_op(_ce_soft_impl, input, label,
                        op_name="cross_entropy_soft")
    return apply_op(_ce_prob_impl, input, label,
                    ignore_index=int(ignore_index), op_name="cross_entropy")


def dropout(x, dropout_prob, is_test=False, seed=None,
            dropout_implementation="downgrade_in_infer", name=None):
    mode = ("downscale_in_infer"
            if dropout_implementation == "downgrade_in_infer"
            else "upscale_in_train")
    return _F.dropout(x, p=dropout_prob, training=not is_test, mode=mode)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,  # noqa: A002
           pool_padding=0, global_pooling=False, ceil_mode=False,
           exclusive=True, data_format="NCHW", name=None):
    if data_format != "NCHW":
        raise NotImplementedError(
            "pool2d: NHWC is not wired through the pooling functionals; "
            "transpose to NCHW")
    if global_pooling:
        if pool_type == "max":
            return _F.adaptive_max_pool2d(input, 1)
        return _F.adaptive_avg_pool2d(input, 1)
    if pool_type == "max":
        return _F.max_pool2d(input, pool_size, stride=pool_stride,
                             padding=pool_padding, ceil_mode=ceil_mode)
    return _F.avg_pool2d(input, pool_size, stride=pool_stride,
                         padding=pool_padding, ceil_mode=ceil_mode,
                         exclusive=exclusive)


def flatten(x, axis=1, name=None):
    """fluid flatten → 2-D [prod(shape[:axis]), prod(shape[axis:])] (a
    -1 leading dim, a placeholder's, stays -1)."""
    shape = list(x.shape)
    if axis == 0:
        return _T.reshape(x, [1, -1])
    if any(s < 0 for s in shape[:axis]):
        return _T.reshape(x, [-1, int(np.prod(shape[axis:]))])
    return _T.reshape(x, [int(np.prod(shape[:axis])), -1])


def reshape(x, shape, actual_shape=None, act=None, inplace=False, name=None):  # noqa: A002
    out = _T.reshape(x, shape)
    if act is not None:
        out = getattr(_F, act)(out)
    return out


def expand(x, expand_times, name=None):
    """fluid expand repeats each dim ``expand_times[i]`` times (2.x
    tile)."""
    return _T.tile(x, expand_times)


def expand_as(x, target_tensor, name=None):
    return _T.expand_as(x, target_tensor)


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0,  # noqa: A002
                   name=None):
    from ..tensor.random import uniform

    return uniform(shape, dtype=dtype, min=min, max=max, seed=seed)


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype="float32",
                    name=None):
    from ..tensor.random import normal

    out = normal(mean=mean, std=std, shape=shape)
    return _T.cast(out, dtype)


def range(start, end, step, dtype, name=None):  # noqa: A001
    from ..tensor.creation import arange

    return arange(start, end, step, dtype)


def linspace(start, stop, num, dtype=None, name=None):
    from ..tensor.creation import linspace as _linspace

    return _linspace(start, stop, num, dtype)


def _smooth_l1_impl(x, y, ow, sigma2):
    d = x - y
    ad = torch.abs(d)
    loss = torch.where(ad < 1.0 / sigma2, 0.5 * d * d * sigma2,
                       ad - 0.5 / sigma2)
    loss = loss * ow  # elementwise, BEFORE the per-row sum (smooth_l1_op.h)
    return torch.sum(loss.reshape(loss.shape[0], -1), dim=1, keepdim=True)


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    """smooth_l1_op.cc: per-row summed smooth-L1; inside_weight scales the
    difference, outside_weight each element's loss."""
    sigma2 = (sigma if sigma is not None else 1.0) ** 2
    if inside_weight is not None:
        x = _T.multiply(x, inside_weight)
        y = _T.multiply(y, inside_weight)
    if outside_weight is None:
        outside_weight = Tensor(torch.ones((1, 1), dtype=torch.float32,
                                           device=_device_of(x)))
    return apply_op(_smooth_l1_impl, x, y, outside_weight,
                    sigma2=float(sigma2), op_name="smooth_l1")


def _sce_impl(x, lab, ignore_index, normalize):
    loss = torch.clamp(x, min=0.0) - x * lab \
        + torch.log1p(torch.exp(-torch.abs(x)))
    keep = lab != ignore_index
    loss = torch.where(keep, loss, torch.zeros_like(loss))
    if normalize:
        loss = loss / torch.clamp(keep.sum(), min=1)
    return loss


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100,
                                      normalize=False, name=None):
    return apply_op(_sce_impl, x, label, ignore_index=int(ignore_index),
                    normalize=bool(normalize),
                    op_name="sigmoid_cross_entropy_with_logits")


def _clip_by_norm_impl(x, max_norm):
    n = torch.sqrt(torch.sum(x * x))
    return torch.where(n > max_norm, x * (max_norm / n), x)


def clip_by_norm(x, max_norm, name=None):
    return apply_op(_clip_by_norm_impl, x, max_norm=float(max_norm),
                    op_name="clip_by_norm")


def where(condition):
    """fluid.layers.where = the indices of True (2.x nonzero)."""
    return _T.nonzero(condition)


def has_nan(x):
    return _T.any(_T.isnan(x))


def has_inf(x):
    return _T.any(_T.isinf(x))


def isfinite(x):
    return _T.all(_T.isfinite(x))


def resize_bilinear(input, out_shape=None, scale=None, align_corners=True,  # noqa: A002
                    align_mode=1, data_format="NCHW", name=None):
    return _F.interpolate(input, size=out_shape, scale_factor=scale,
                          mode="bilinear", align_corners=align_corners)


def resize_nearest(input, out_shape=None, scale=None, align_corners=True,  # noqa: A002
                   data_format="NCHW", name=None):
    return _F.interpolate(input, size=out_shape, scale_factor=scale,
                          mode="nearest")


def _pad_impl(x, paddings, pad_value):
    flat = []
    for i in builtins.range(x.dim() - 1, -1, -1):
        flat += [paddings[2 * i], paddings[2 * i + 1]]
    return TF.pad(x, flat, value=pad_value)


def pad(x, paddings, pad_value=0.0, name=None):
    """fluid pad: flat (before, after) per dim."""
    pw = tuple(int(p) for p in paddings)
    return apply_op(_pad_impl, x, paddings=pw, pad_value=float(pad_value),
                    op_name="pad")


def hard_sigmoid(x, slope=0.2, offset=0.5, name=None):
    return _F.hardsigmoid(x, slope=slope, offset=offset)


def brelu(x, t_min=0.0, t_max=24.0, name=None):
    return _F.hardtanh(x, min=t_min, max=t_max)


def _soft_relu_impl(x, threshold):
    return torch.log1p(torch.exp(torch.clamp(x, -threshold, threshold)))


def soft_relu(x, threshold=40.0, name=None):
    return apply_op(_soft_relu_impl, x, threshold=float(threshold),
                    op_name="soft_relu")


def relu_clipped(x, threshold=6.0, name=None):
    return _T.clip(_F.relu(x), 0.0, threshold)


def _l2_normalize_impl(x, axis, epsilon):
    n = torch.sqrt(torch.clamp(torch.sum(x * x, dim=axis, keepdim=True),
                               min=epsilon))
    return x / n


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    return apply_op(_l2_normalize_impl, x, axis=int(axis),
                    epsilon=float(epsilon), op_name="l2_normalize")


def create_tensor(dtype, name=None, persistable=False):
    from ..device import current_device
    from ..framework import dtype as dtypes

    return Tensor(torch.zeros((), dtype=dtypes.convert_dtype(dtype),
                              device=current_device()), name=name)


def array_write(x, i, array=None):
    """LoDTensorArray shim: a Python list and an index."""
    if array is None:
        array = []
    idx = int(i)
    while len(array) <= idx:
        array.append(None)
    array[idx] = x
    return array


def array_read(array, i):
    return array[int(i)]


def array_length(array):
    from ..device import current_device

    return Tensor(torch.tensor(len(array), dtype=torch.int64,
                               device=current_device()))


def create_array(dtype):
    return []


# --- the remaining fluid.layers names -------------------------------------
from ..tensor import (  # noqa: F401,E402
    crop, diag, eye, multiplex, rank, strided_slice, sum, triu, unbind,
    unique, unique_consecutive, stanh, numel as size,
)
from ..tensor import add_n as sums  # noqa: F401,E402  (sum_op: elementwise list add)
from ..nn.functional import (  # noqa: F401,E402
    dice_loss, mse_loss, mish, ctc_loss as warpctc,
    hardswish as hard_swish, kl_div as kldiv_loss,
    adaptive_avg_pool2d as adaptive_pool2d,
    adaptive_avg_pool3d as adaptive_pool3d, interpolate as image_resize,
    pixel_unshuffle as space_to_depth,
)


def _huber_impl(x, y, delta):
    d = y - x
    ad = torch.abs(d)
    return torch.where(ad <= delta, 0.5 * d * d, delta * (ad - 0.5 * delta))


def huber_loss(input, label, delta):  # noqa: A002
    """huber_loss_op: the elementwise Huber residual (no reduction), the
    1.x positional delta."""
    return apply_op(_huber_impl, input, label, delta=float(delta),
                    op_name="huber_loss")


from ..nn.decode import BeamSearchDecoder, dynamic_decode  # noqa: F401,E402
from ..nn import GRUCell, LSTMCell, RNNCellBase as RNNCell  # noqa: F401,E402
from ..distribution import Categorical, Normal, Uniform  # noqa: F401,E402
from ..static import data  # noqa: F401,E402
from ..text import linear_chain_crf  # noqa: F401,E402
from ..vision.ops import (  # noqa: F401,E402
    deform_conv2d as deformable_conv, psroi_pool as prroi_pool,
    read_file,
)

crop_tensor = crop


def pad2d(input, paddings=(0, 0, 0, 0), mode="constant", pad_value=0.0,  # noqa: A002
          data_format="NCHW", name=None):
    """fluid pad2d: [top, bottom, left, right] on the spatial dims."""
    t, b, lft, r = (int(v) for v in paddings)
    return _F.pad(input, [lft, r, t, b], mode=mode, value=pad_value,
                  data_format=data_format)


def pad_constant_like(x, y, pad_value=0.0, name=None):
    """Pad y up to x's shape with trailing constants
    (pad_constant_like_op)."""
    pads = []
    for xs, ys in zip(x.shape, y.shape):
        pads += [0, int(xs) - int(ys)]
    return pad(y, pads, pad_value=pad_value)


def pool3d(input, pool_size=-1, pool_type="max", pool_stride=1,  # noqa: A002
           pool_padding=0, global_pooling=False, ceil_mode=False,
           exclusive=True, data_format="NCDHW", name=None):
    if global_pooling:
        if pool_type == "max":
            return _F.adaptive_max_pool3d(input, 1)
        return _F.adaptive_avg_pool3d(input, 1)
    if pool_type == "max":
        return _F.max_pool3d(input, pool_size, stride=pool_stride,
                             padding=pool_padding, ceil_mode=ceil_mode)
    return _F.avg_pool3d(input, pool_size, stride=pool_stride,
                         padding=pool_padding, ceil_mode=ceil_mode)


def resize_linear(input, out_shape=None, scale=None, align_corners=True,  # noqa: A002
                  align_mode=1, data_format="NCW", name=None):
    return _F.interpolate(input, size=out_shape, scale_factor=scale,
                          mode="linear", align_corners=align_corners)


def resize_trilinear(input, out_shape=None, scale=None, align_corners=True,  # noqa: A002
                     align_mode=1, data_format="NCDHW", name=None):
    return _F.interpolate(input, size=out_shape, scale_factor=scale,
                          mode="trilinear", align_corners=align_corners)


def image_resize_short(input, out_short_len, resample="BILINEAR"):  # noqa: A002
    h, w = int(input.shape[2]), int(input.shape[3])
    ratio = out_short_len / float(builtins.min(h, w))
    return _F.interpolate(input, size=[int(builtins.round(h * ratio)),
                                       int(builtins.round(w * ratio))],
                          mode=resample.lower())


def cos_sim(X, Y):  # noqa: N803
    """cos_sim_op: the row-wise cosine similarity → [N, 1]."""
    return _T.unsqueeze(_F.cosine_similarity(X, Y, axis=-1), -1)


def _mean_iou_impl(pred, label, num_classes):
    pred = pred.reshape(-1).long()
    lab = label.reshape(-1).long()
    idx = pred * num_classes + lab
    cm = torch.zeros(num_classes * num_classes, dtype=torch.float32,
                     device=pred.device).index_add_(
        0, idx, torch.ones_like(idx, dtype=torch.float32))
    cm = cm.reshape(num_classes, num_classes)
    inter = torch.diagonal(cm)
    union = cm.sum(0) + cm.sum(1) - inter
    valid = union > 0
    iou = torch.where(valid, inter / torch.clamp(union, min=1e-9),
                      torch.zeros_like(inter))
    miou = iou.sum() / torch.clamp(valid.sum(), min=1)
    # the reference's output order: (mean_iou, out_wrong, out_correct)
    return miou, (union - inter).to(torch.int32), inter.to(torch.int32)


def mean_iou(input, label, num_classes):  # noqa: A002
    """mean_iou_op: (mean_iou, out_wrong, out_correct), the per-class
    difference counts then the intersection counts."""
    return apply_op(_mean_iou_impl, input, label,
                    num_classes=int(num_classes), op_name="mean_iou")


def _rank_loss_impl(label, left, right):
    p = torch.sigmoid(left - right)
    return -label * torch.log(torch.clamp(p, min=1e-20)) \
        - (1.0 - label) * torch.log(torch.clamp(1.0 - p, min=1e-20))


def rank_loss(label, left, right, name=None):
    """rank_loss_op: RankNet's pairwise loss."""
    return apply_op(_rank_loss_impl, label, left, right, op_name="rank_loss")


def _margin_rank_impl(label, left, right, margin):
    return torch.clamp(-label * (left - right) + margin, min=0.0)


def margin_rank_loss(label, left, right, margin=0.1, name=None):
    """margin_rank_loss_op: max(0, -label * (left - right) + margin)."""
    return apply_op(_margin_rank_impl, label, left, right,
                    margin=float(margin), op_name="margin_rank_loss")


def _bpr_loss_impl(x, label):
    lab = label.reshape(-1).long()
    pos = torch.gather(x, 1, lab[:, None])
    diff = x - pos
    # the positive column itself is left out, as in bpr_loss_op
    mask = torch.arange(x.shape[1], device=x.device)[None, :] != lab[:, None]
    loss = torch.where(mask, torch.log1p(torch.exp(diff)),
                       torch.zeros_like(diff))
    return loss.sum(1, keepdim=True) / builtins.max(x.shape[1] - 1, 1)


def bpr_loss(input, label, name=None):  # noqa: A002
    """bpr_loss_op: Bayesian personalized ranking over score rows."""
    return apply_op(_bpr_loss_impl, input, label, op_name="bpr_loss")


def _shuffle_channel_impl(x, group):
    n, c, h, w = x.shape
    return x.reshape(n, group, c // group, h, w).transpose(1, 2).reshape(
        n, c, h, w)


def shuffle_channel(x, group, name=None):
    return apply_op(_shuffle_channel_impl, x, group=int(group),
                    op_name="shuffle_channel")


@records
def sampling_id(x, min=0.0, max=1.0, seed=0, dtype="int64"):  # noqa: A002
    """sampling_id_op: a category drawn per row of probabilities."""
    from ..framework import random as grandom

    p = x._data
    if seed:
        gen = torch.Generator(device=p.device)
        gen.manual_seed(int(seed))
    else:
        gen = grandom.generator(p.device)
    probs = torch.clamp(p.float(), min=1e-20)
    return Tensor(torch.multinomial(probs, 1, generator=gen).reshape(-1))


@records
def is_empty(x, name=None):
    n = x.size if isinstance(x, Tensor) else int(np.size(x))
    return Tensor(torch.tensor(n == 0, device=_device_of(x)
                               if isinstance(x, Tensor) else None))


def Assert(cond, data=None, summarize=20, name=None):  # noqa: N802
    """An eager check: a false ``cond`` raises. In a static program it
    would be a host read at every run: it raises there."""
    if getattr(cond, "_symbolic", False):
        raise NotImplementedError(
            "fluid.layers.Assert in a static program: the check is a host "
            "read; assert on a fetched value instead")
    ok = bool(cond.numpy()) if isinstance(cond, Tensor) else bool(cond)
    if not ok:
        raise AssertionError(
            "fluid.layers.Assert failed"
            + ("" if data is None else ": %s" % (
                [d.numpy() if isinstance(d, Tensor) else np.asarray(d)
                 for d in data],)))
    return cond


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    from ..device import current_device
    from ..static import default_main_program

    key = counter_name or "@STEP_COUNTER@"
    prog = default_main_program()
    counters = getattr(prog, "_step_counters", None)
    if counters is None:
        counters = prog._step_counters = {}
    val = counters.get(key, begin - step) + step
    counters[key] = val
    return Tensor(torch.tensor(val, dtype=torch.int64,
                               device=current_device()))


def uniform_random_batch_size_like(input, shape, dtype="float32",  # noqa: A002
                                   input_dim_idx=0, output_dim_idx=0,
                                   min=-1.0, max=1.0, seed=0):  # noqa: A002
    shape = list(shape)
    shape[output_dim_idx] = input.shape[input_dim_idx]
    return uniform_random(shape, dtype, min, max, seed)


def gaussian_random_batch_size_like(input, shape, input_dim_idx=0,  # noqa: A002
                                    output_dim_idx=0, mean=0.0, std=1.0,
                                    seed=0, dtype="float32"):
    shape = list(shape)
    shape[output_dim_idx] = input.shape[input_dim_idx]
    return gaussian_random(shape, mean, std, seed, dtype)


# --- the LR decay functions → the scheduler objects the optimizers take
#     (reference layers/learning_rate_scheduler.py builds graph ops; here
#     a schedule is host-side LRScheduler state, the 2.x design) ----------

def _ratio(step, decay_steps, staircase):
    r = step / float(decay_steps)
    return np.floor(r) if staircase else r


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """lr = base * rate^(step / decay_steps)."""
    from ..optimizer.lr import LambdaDecay

    return LambdaDecay(learning_rate, lambda step: decay_rate ** _ratio(
        step, decay_steps, staircase))


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    from ..optimizer.lr import LambdaDecay

    return LambdaDecay(learning_rate, lambda step: float(np.exp(
        -decay_rate * _ratio(step, decay_steps, staircase))))


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    from ..optimizer.lr import LambdaDecay

    return LambdaDecay(learning_rate, lambda step: 1.0 / (
        1.0 + decay_rate * _ratio(step, decay_steps, staircase)))


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    from ..optimizer.lr import PolynomialDecay

    return PolynomialDecay(learning_rate, decay_steps,
                           end_lr=end_learning_rate, power=power, cycle=cycle)


def piecewise_decay(boundaries, values):
    from ..optimizer.lr import PiecewiseDecay

    return PiecewiseDecay(boundaries, values)


def cosine_decay(learning_rate, step_each_epoch, epochs):
    """lr = base * 0.5 * (cos(epoch * pi / epochs) + 1), epoch = step //
    step_each_epoch."""
    from ..optimizer.lr import LambdaDecay

    return LambdaDecay(learning_rate, lambda step: 0.5 * (float(np.cos(
        (step // step_each_epoch) * np.pi / epochs)) + 1.0))


def noam_decay(d_model, warmup_steps, learning_rate=1.0):
    from ..optimizer.lr import NoamDecay

    return NoamDecay(d_model, warmup_steps, learning_rate=learning_rate)


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    from ..optimizer.lr import LinearWarmup

    return LinearWarmup(learning_rate, warmup_steps, start_lr, end_lr)


# --- block-style control flow: guidance shims over the functional forms ----

class While:
    """fluid.layers.While block: use while_loop (the block-style API
    writes into a Program block; the recorded program expresses the loop
    as one while op)."""

    def __init__(self, cond, is_test=False, name=None):
        raise NotImplementedError(
            "block-style While is not supported: express the loop with "
            "fluid.layers.while_loop(cond_fn, body_fn, loop_vars)")


class Switch:
    def __init__(self, name=None):
        raise NotImplementedError(
            "block-style Switch is not supported: use "
            "fluid.layers.case/switch_case")


class IfElse:
    def __init__(self, cond, name=None):
        raise NotImplementedError(
            "block-style IfElse is not supported: use fluid.layers.cond")


# --- functional rnn, the remaining implementations, guided refusals ----------

from ..nn.functional import local_response_norm as lrn  # noqa: F401,E402


def rnn(cell, inputs, initial_states=None, sequence_length=None,
        time_major=False, is_reverse=False, **kwargs):
    """Functional rnn over a cell (reference layers/rnn.py rnn)."""
    from ..nn import RNN

    return RNN(cell, is_reverse=is_reverse, time_major=time_major)(
        inputs, initial_states, sequence_length)


def birnn(cell_fw, cell_bw, inputs, initial_states=None,
          sequence_length=None, time_major=False, **kwargs):
    from ..nn import BiRNN

    return BiRNN(cell_fw, cell_bw, time_major=time_major)(
        inputs, initial_states, sequence_length)


def lstm(input, init_h, init_c, max_len, hidden_size, num_layers,  # noqa: A002
         dropout_prob=0.0, is_bidirec=False, is_test=False, name=None,
         default_initializer=None, seed=-1):
    """fluid's cudnn-style lstm → nn.LSTM (weights made per call as the
    other static helpers make theirs); sequence-major input [seq_len,
    batch, input_dim]."""
    from ..nn import LSTM

    net = LSTM(int(input.shape[-1]), hidden_size, num_layers=num_layers,
               direction="bidirect" if is_bidirec else "forward",
               dropout=dropout_prob, time_major=True)
    out, (h, c) = net(input, (init_h, init_c))
    return out, h, c


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,  # noqa: A002
             activation="tanh", gate_activation="sigmoid",
             origin_mode=False):
    """One GRU step (gru_unit_op): input is the pre-projected [B, size]
    gates; returns (hidden, reset_hidden_pre, gate) as the reference."""
    from .dygraph import GRUUnit

    return GRUUnit(size, param_attr, bias_attr, activation,
                   gate_activation, origin_mode)(input, hidden)


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    from ..nn import LSTMCell

    cell = LSTMCell(int(x_t.shape[-1]), int(hidden_t_prev.shape[-1]))
    out, (h, c) = cell(x_t, (hidden_t_prev, cell_t_prev))
    return h, c


def unique_with_counts(x, dtype="int32"):
    out, idx, counts = _T.unique(x, return_inverse=True, return_counts=True)
    return out, idx, counts


def _affine_channel_impl(x, scale, bias):
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return x * scale.reshape(shape) + bias.reshape(shape)


def affine_channel(x, scale=None, bias=None, data_format="NCHW", act=None,
                   name=None):
    out = apply_op(_affine_channel_impl, x, scale, bias,
                   op_name="affine_channel")
    if act is not None:
        out = getattr(_F, act)(out)
    return out


def _add_pos_enc_impl(x, alpha, beta):
    B, T, D = x.shape
    pos = torch.arange(T, dtype=torch.float32, device=x.device)[:, None]
    half = D // 2
    # a Python base: no host-to-device copy inside a captured run
    div = torch.pow(10000.0, torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half)
    enc = torch.cat([torch.sin(pos / div), torch.cos(pos / div)], dim=1)
    return alpha * x + beta * enc[None, :, :D]


def add_position_encoding(input, alpha, beta, name=None):  # noqa: A002
    """add_position_encoding_op: alpha * x + beta * sinusoid(position)."""
    return apply_op(_add_pos_enc_impl, input, alpha=float(alpha),
                    beta=float(beta), op_name="add_position_encoding")


def _fsp_impl(x, y):
    B, C1 = x.shape[0], x.shape[1]
    C2 = y.shape[1]
    hw = x.shape[2] * x.shape[3]
    return torch.einsum("bch,bdh->bcd", x.reshape(B, C1, hw),
                        y.reshape(B, C2, hw)) / hw


def fsp_matrix(x, y):
    """fsp_op: the flow-of-solution-procedure Gram matrix (distillation)."""
    return apply_op(_fsp_impl, x, y, op_name="fsp_matrix")


def _ts_bce(z, t):
    return torch.clamp(z, min=0.0) - z * t \
        + torch.log1p(torch.exp(-torch.abs(z)))


def _ts_loss_impl(z, lab, ub, lb):
    z = torch.clamp(z, lb, ub)
    # teacher_student_sigmoid_loss_op.h:44-62: the label encodes
    # (teacher-score presence, click): {-2, -1, [0, 1), [1, 2)}
    return torch.where(
        lab < -1.0, _ts_bce(z, 0.0),
        torch.where(lab < 0.0, _ts_bce(z, 1.0),
                    torch.where(lab < 1.0, _ts_bce(z, 0.0) + _ts_bce(z, lab),
                                _ts_bce(z, 1.0) + _ts_bce(z, lab - 1.0))))


def teacher_student_sigmoid_loss(input, label, soft_max_up_bound=15.0,  # noqa: A002
                                 soft_max_lower_bound=-15.0):
    """teacher_student_sigmoid_loss_op: the hard-click CE plus the soft
    teacher-score CE where the label carries one."""
    return apply_op(_ts_loss_impl, input, label,
                    ub=float(soft_max_up_bound),
                    lb=float(soft_max_lower_bound),
                    op_name="teacher_student_sigmoid_loss")


@records
def ctc_greedy_decoder(input, blank, input_length=None, padding_value=0,  # noqa: A002
                       name=None):
    """ctc_align_op greedy mode: argmax, merge repeats, drop blanks. The
    output length depends on the data: host-side, as the reference's CPU
    kernel (a static program cannot record it)."""
    probs = input.numpy()                              # [B, T, C]
    lens = (np.asarray(input_length.numpy() if isinstance(
        input_length, Tensor) else input_length).reshape(-1)
        if input_length is not None
        else np.full((probs.shape[0],), probs.shape[1]))
    ids = probs.argmax(-1)
    rows = []
    for b in builtins.range(ids.shape[0]):
        seq, prev = [], None
        for t in builtins.range(int(lens[b])):
            tok = int(ids[b, t])
            if tok != prev and tok != blank:
                seq.append(tok)
            prev = tok
        rows.append(seq)
    T_out = builtins.max([len(r) for r in rows] + [1])
    out = np.full((len(rows), T_out), padding_value, np.int64)
    for b, r in enumerate(rows):
        out[b, :len(r)] = r
    dev = input._data.device
    return (Tensor(torch.from_numpy(out).to(dev)),
            Tensor(torch.tensor([len(r) for r in rows], dtype=torch.int64,
                                device=dev)))


def _sampled_ce_impl(logits, label, samp):
    lab = label.reshape(-1).long()
    pos = torch.gather(logits, 1, lab[:, None])          # [B, 1]
    neg = logits[:, samp]                                # [B, S]
    z = torch.cat([pos, neg], dim=1)
    return -torch.log_softmax(z, dim=1)[:, :1]


def sampled_softmax_with_cross_entropy(logits, label, num_samples,
                                       num_true=1, remove_accidental_hits=True,
                                       use_customized_samples=False,
                                       customized_samples=None,
                                       customized_probabilities=None,
                                       seed=0):
    """sample_logits_op: softmax CE over the true class and uniformly
    sampled classes (drawn at the call, as nce draws its negatives)."""
    from ..framework import random as grandom

    dev = _device_of(logits)
    if seed:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
    else:
        gen = grandom.generator(dev)
    C = int(logits.shape[-1])
    samp = torch.randint(0, C, (int(num_samples),), generator=gen, device=dev)
    return apply_op(_sampled_ce_impl, logits, label, Tensor(samp),
                    op_name="sampled_softmax_with_cross_entropy")


def detection_output(loc, scores, prior_box, prior_box_var,
                     background_label=0, nms_threshold=0.3, nms_top_k=400,
                     keep_top_k=200, score_threshold=0.01, nms_eta=1.0,
                     return_index=False):
    """SSD detection_output = box_coder (decode_center_size) +
    multiclass_nms (the reference's composition)."""
    decoded = box_coder(prior_box, prior_box_var, loc,
                        code_type="decode_center_size", box_normalized=True)
    return multiclass_nms(decoded, scores, background_label=background_label,
                          score_threshold=score_threshold,
                          nms_top_k=nms_top_k, nms_threshold=nms_threshold,
                          keep_top_k=keep_top_k, nms_eta=nms_eta,
                          return_index=return_index)


class MultivariateNormalDiag:
    """fluid.layers.distributions.MultivariateNormalDiag: an independent
    Normal per dim (diagonal covariance)."""

    def __init__(self, loc, scale):
        self.loc = loc._data if isinstance(loc, Tensor) \
            else torch.as_tensor(np.asarray(loc, np.float32))
        sc = scale._data if isinstance(scale, Tensor) \
            else torch.as_tensor(np.asarray(scale, np.float32))
        # the reference passes a diagonal MATRIX; a vector is taken too
        self.scale = torch.diagonal(sc, dim1=-2, dim2=-1) if sc.dim() >= 2 \
            else sc

    def sample(self, shape=()):
        from ..framework import random as grandom

        z = torch.randn(tuple(shape) + tuple(self.loc.shape),
                        device=self.loc.device,
                        generator=grandom.generator(self.loc.device))
        return Tensor(self.loc + z * self.scale)

    def entropy(self):
        d = self.loc.shape[-1]
        return Tensor(0.5 * d * (1.0 + np.log(2 * np.pi))
                      + torch.sum(torch.log(self.scale), dim=-1))

    def kl_divergence(self, other):
        var_ratio = (self.scale / other.scale) ** 2
        t1 = ((self.loc - other.loc) / other.scale) ** 2
        return Tensor(0.5 * torch.sum(
            var_ratio + t1 - 1.0 - torch.log(var_ratio), dim=-1))


def tensor_array_to_tensor(input, axis=1, use_stack=False):  # noqa: A002
    """Pairs with the array_write / create_array shims."""
    out = _T.stack(list(input), axis=axis) if use_stack \
        else _T.concat(list(input), axis=axis)
    sizes = ([int(t.shape[axis]) for t in input] if not use_stack
             else [1] * len(input))
    return out, Tensor(torch.tensor(sizes, dtype=torch.int64,
                                    device=_device_of(out)))


def random_crop(x, shape, seed=None):
    """random_crop_op: a host-side random spatial crop (input
    pipeline)."""
    arr = x.numpy() if isinstance(x, Tensor) else np.asarray(x)
    out_sh = list(shape)
    lead = arr.ndim - len(out_sh)
    rng = np.random.default_rng(seed)
    starts = []
    for i, s in enumerate(out_sh):
        lim = arr.shape[lead + i] - s
        starts.append(rng.integers(0, lim + 1) if lim > 0 else 0)
    idx = tuple([builtins.slice(None)] * lead
                + [builtins.slice(st, st + s)
                   for st, s in zip(starts, out_sh)])
    return Tensor(np.ascontiguousarray(arr[idx]))


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None,  # noqa: A002
             name=None, path_table=None, path_code=None, is_custom=False,
             is_sparse=False):
    """fluid hsigmoid: makes the tree weights and applies
    F.hsigmoid_loss (hierarchical_sigmoid_op)."""
    from ..device import current_device
    from ..framework.core import Parameter
    from ..nn import initializer as I

    D = int(input.shape[-1])
    if is_custom:
        pt = path_table.numpy() if isinstance(path_table, Tensor) \
            else np.asarray(path_table)
        rows = int(pt.max()) + 1
    else:
        rows = num_classes - 1
    dev = current_device()
    w = Parameter(I.XavierNormal()((rows, D), torch.float32, dev),
                  name="hsig.w")
    b = Parameter(I.Constant(0.0)((rows,), torch.float32, dev),
                  name="hsig.b")
    return _F.hsigmoid_loss(input, label, num_classes, w, bias=b,
                            path_table=path_table, path_code=path_code,
                            is_sparse=is_sparse)


# the reference's doc decorators (internal helpers, identity here)
def templatedoc(op_type=None):
    def deco(fn):
        return fn

    return deco


autodoc = templatedoc


def generate_layer_fn(op_type):
    raise NotImplementedError(
        "generate_layer_fn builds wrappers from the C++ OpProto registry; "
        "this framework has no OpProto: every op is a Python function "
        "already present in this namespace")


generate_activation_fn = generate_layer_fn
generate_inplace_fn = generate_layer_fn


def _lod_refusal(name, replacement):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            "%s is LoD-coupled; use the padded-dense equivalent: %s"
            % (name, replacement))

    fn.__name__ = name
    return fn


dynamic_lstm = _lod_refusal("dynamic_lstm", "paddle.nn.LSTM + lengths")
dynamic_lstmp = _lod_refusal("dynamic_lstmp", "paddle.nn.LSTM + projection")
dynamic_gru = _lod_refusal("dynamic_gru", "paddle.nn.GRU + lengths")
lod_reset = _lod_refusal("lod_reset", "sequence_pad/sequence_unpad")
lod_append = _lod_refusal("lod_append", "sequence_pad/sequence_unpad")
im2sequence = _lod_refusal("im2sequence", "unfold + reshape")
reorder_lod_tensor_by_rank = _lod_refusal(
    "reorder_lod_tensor_by_rank", "gather over a lengths argsort")
get_tensor_from_selected_rows = _lod_refusal(
    "get_tensor_from_selected_rows", "dense grads (SelectedRows decision)")
merge_selected_rows = _lod_refusal(
    "merge_selected_rows", "dense grads (SelectedRows decision)")
py_reader = _lod_refusal("py_reader", "paddle.io.DataLoader")
create_py_reader_by_data = _lod_refusal("create_py_reader_by_data",
                                        "paddle.io.DataLoader")
double_buffer = _lod_refusal("double_buffer",
                             "paddle.io.DataLoader (prefetches natively)")
load = _lod_refusal("load", "paddle.static.load / paddle.load")


def _decode_refusal(name):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            "%s (op-level beam search) is replaced by the decoder: "
            "fluid.layers.BeamSearchDecoder + dynamic_decode "
            "(paddle_tpu_torch.nn.decode)" % name)

    fn.__name__ = name
    return fn


beam_search = _decode_refusal("beam_search")
beam_search_decode = _decode_refusal("beam_search_decode")
DynamicRNN = _decode_refusal("DynamicRNN")
StaticRNN = _decode_refusal("StaticRNN")
Decoder = _decode_refusal("Decoder")
BasicDecoder = _decode_refusal("BasicDecoder")
DecodeHelper = _decode_refusal("DecodeHelper")
TrainingHelper = _decode_refusal("TrainingHelper")
GreedyEmbeddingHelper = _decode_refusal("GreedyEmbeddingHelper")
SampleEmbeddingHelper = _decode_refusal("SampleEmbeddingHelper")


def _det_refusal(name, parts):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            "%s: compose from the implemented detection primitives (%s); "
            "the reference op is this composition fused in C++"
            % (name, parts))

    fn.__name__ = name
    return fn


from ..vision.ops import ssd_loss, target_assign  # noqa: F401,E402
from ..vision.ops import (  # noqa: F401,E402
    retinanet_target_assign, rpn_target_assign,
)
from ..vision.ops import retinanet_detection_output  # noqa: F401,E402
from ..vision.ops import (  # noqa: F401,E402
    locality_aware_nms, polygon_box_transform,
)
box_decoder_and_assign = _det_refusal("box_decoder_and_assign",
                                      "box_coder + argmax gather")
roi_perspective_transform = _det_refusal("roi_perspective_transform",
                                         "grid_sampler + affine_grid")
deformable_roi_pooling = _det_refusal("deformable_roi_pooling",
                                      "deform_conv2d + roi_align")
from ..vision.ops import generate_proposal_labels  # noqa: F401,E402
generate_mask_labels = _det_refusal("generate_mask_labels",
                                    "roi_align over gt masks")
from ..vision.ops import density_prior_box  # noqa: F401,E402


def _ps_refusal(name):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            "%s belongs to the parameter-server / rec-sys stack, which this "
            "framework leaves out" % name)

    fn.__name__ = name
    return fn


continuous_value_model = _ps_refusal("continuous_value_model")
filter_by_instag = _ps_refusal("filter_by_instag")
hash = _ps_refusal("hash")  # noqa: A001


def similarity_focus(input, axis, indexes, name=None):  # noqa: A002
    raise NotImplementedError(
        "similarity_focus: compose from argmax + one-hot scatter masks; "
        "the reference op is that composition fused")


def inplace_abn(input, **kwargs):  # noqa: A002
    raise NotImplementedError(
        "inplace_abn exists to reuse the activation buffer in place; use "
        "batch_norm(act=...)")


_center_registry = {}


def _center_loss_impl(x, lab, c, alpha, update):
    """The loss against the centres as they are, then (``update``) the
    running centres' step in place: c_k -= alpha * (c_k - mean of its
    rows) * n_k / (1 + n_k) for each class k present."""
    lab = lab.reshape(-1).long()
    diff = x - c[lab]
    loss = 0.5 * torch.sum(diff * diff, dim=1, keepdim=True)
    if update:
        xa = x.detach()
        cnt = torch.zeros(c.shape[0], dtype=xa.dtype,
                          device=xa.device).index_add_(
            0, lab, torch.ones_like(lab, dtype=xa.dtype))
        mean = torch.zeros_like(c).index_add_(0, lab, xa) \
            / torch.clamp(cnt, min=1)[:, None]
        step = alpha * (c - mean) * (cnt / (1.0 + cnt))[:, None]
        with torch.no_grad():
            c.sub_(torch.where(cnt[:, None] > 0, step,
                               torch.zeros_like(step)))
    return loss


def center_loss(input, label, num_classes, alpha, param_attr=None,  # noqa: A002
                update_center=True):
    """center_loss_op: 0.5 * ||x - c_y||² with RUNNING class centres:
    they live in a per-(name, shape) registry, so every call of the
    training loop updates the same buffer (the reference's persistable
    centres parameter)."""
    from ..device import current_device
    from ..framework.core import Parameter
    from ..framework.param_attr import ParamAttr

    D = int(input.shape[-1])
    attr = ParamAttr._to_attr(param_attr)
    cname = (attr.name if attr is not None and attr.name
             else "center_loss.centers")
    dev = current_device()
    key = (cname, int(num_classes), D, str(dev))
    centers = _center_registry.get(key)
    if centers is None:
        centers = Parameter(torch.zeros(int(num_classes), D, device=dev),
                            name=cname, trainable=False)
        _center_registry[key] = centers
    a = alpha.numpy() if isinstance(alpha, Tensor) else alpha
    return apply_op(_center_loss_impl, input, label, centers,
                    alpha=float(np.asarray(a).reshape(-1)[0]),
                    update=bool(update_center), op_name="center_loss")


def chunk_eval(input, label, chunk_scheme, num_chunk_types,  # noqa: A002
               excluded_chunk_types=None, seq_length=None):
    """chunk_eval_op: chunk P / R / F1 for IOB / IOE / IOBES tagging; a
    host-side metric, as the reference's CPU-only kernel."""
    schemes = {"IOB": 2, "IOE": 2, "IOBES": 4, "plain": 1}
    if chunk_scheme not in schemes:
        raise ValueError("chunk_scheme must be IOB/IOE/IOBES/plain")
    n_tag = schemes[chunk_scheme]
    excluded = set(excluded_chunk_types or [])

    def extract(seq):
        chunks, start, ctype = [], None, None
        for i, t in enumerate(seq):
            t = int(t)
            if t == num_chunk_types * n_tag:  # the outside tag
                if start is not None:
                    chunks.append((start, i, ctype))
                    start = None
                continue
            # tag = label % num_tag_types, type = label // num_tag_types
            pos, typ = t % n_tag, t // n_tag
            begin = (pos == 0) if chunk_scheme in ("IOB", "IOBES") \
                else (start is None)
            if chunk_scheme == "IOBES" and pos == 3:   # S = single
                if start is not None:
                    chunks.append((start, i, ctype))
                    start = None
                chunks.append((i, i + 1, typ))
                continue
            if begin or typ != ctype:
                if start is not None:
                    chunks.append((start, i, ctype))
                start, ctype = i, typ
            # IOE tags: I=0, E=1; IOBES: B=0, I=1, E=2, S=3
            end_here = (chunk_scheme == "IOE" and pos == 1) or (
                chunk_scheme == "IOBES" and pos == 2)
            if end_here and start is not None:
                chunks.append((start, i + 1, ctype))
                start = None
        if start is not None:
            chunks.append((start, len(seq), ctype))
        return {c for c in chunks if c[2] not in excluded}

    def host(v):
        return v.numpy() if isinstance(v, Tensor) else np.asarray(v)

    pred, lab = host(input), host(label)
    if pred.ndim == 1:
        pred, lab = pred[None], lab[None]
    lens = (host(seq_length).reshape(-1) if seq_length is not None
            else np.full((pred.shape[0],), pred.shape[-1]))
    n_inf = n_lab = n_correct = 0
    for b in builtins.range(pred.shape[0]):
        L = int(lens[b])
        pc = extract(pred[b].reshape(-1)[:L])
        lc = extract(lab[b].reshape(-1)[:L])
        n_inf += len(pc)
        n_lab += len(lc)
        n_correct += len(pc & lc)
    precision = n_correct / n_inf if n_inf else 0.0
    recall = n_correct / n_lab if n_lab else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall else 0.0)

    def mk(v, dt=np.float32):
        return Tensor(np.asarray(v, dt))

    return (mk(precision), mk(recall), mk(f1), mk(n_inf, np.int32),
            mk(n_lab, np.int32), mk(n_correct, np.int32))
