"""paddle.static.nn (``paddle_tpu/static/nn.py``; reference
python/paddle/static/nn/__init__.py): control flow and the static layer
helpers. Each helper makes its Parameters inline on the current device
(the program captures them as leaves, ``static/graph.py``) and applies
the op: the reference's LayerHelper pattern without a LayerHelper. The
helpers work eagerly too.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as TF

from ..framework.core import Parameter, Tensor, apply_op
from .control_flow import case, cond, switch_case, while_loop  # noqa: F401

__all__ = [
    "cond", "while_loop", "case", "switch_case", "fc", "conv2d", "conv3d",
    "conv2d_transpose", "conv3d_transpose", "batch_norm", "layer_norm",
    "group_norm", "instance_norm", "data_norm", "spectral_norm", "embedding",
    "sparse_embedding", "prelu", "bilinear_tensor_product", "row_conv",
    "crf_decoding", "nce", "multi_box_head", "deform_conv2d", "py_func",
    "sequence_concat", "sequence_conv", "sequence_enumerate",
    "sequence_expand", "sequence_expand_as", "sequence_first_step",
    "sequence_last_step", "sequence_pad", "sequence_pool",
    "sequence_reshape", "sequence_reverse", "sequence_scatter",
    "sequence_slice", "sequence_softmax", "sequence_unpad",
]

from ..nn.functional.sequence import (  # noqa: F401,E402
    sequence_concat, sequence_conv, sequence_enumerate, sequence_expand,
    sequence_expand_as, sequence_first_step, sequence_last_step,
    sequence_pad, sequence_pool, sequence_reshape, sequence_reverse,
    sequence_scatter, sequence_slice, sequence_softmax, sequence_unpad,
)


def _uname(base, name):
    """An auto-unique parameter-name prefix (the reference's LayerHelper
    uniquifies every created var; fixed names would collide in
    static.save's name-keyed state). The counters live on the active
    Program, so rebuilding the same graph reproduces the same names."""
    if name is not None:
        return name
    from . import default_main_program

    prog = default_main_program()
    counters = getattr(prog, "_uname_counters", None)
    if counters is None:
        counters = prog._uname_counters = {}
    n = counters.get(base, 0)
    counters[base] = n + 1
    return "%s_%d" % (base, n)


def _param(init, shape, name, trainable=True):
    from ..device import current_device

    return Parameter(init(tuple(int(s) for s in shape), torch.float32,
                          current_device()),
                     name=name, trainable=trainable)


def _act(out, act):
    if act is None:
        return out
    from ..nn import functional as F

    fn = getattr(F, act, None)
    if fn is None:
        raise ValueError("unsupported activation %r" % (act,))
    return fn(out)


def fc(x, size, num_flatten_dims=1, weight_attr=None, bias_attr=None,
       activation=None, name=None):
    """Static fully-connected helper (reference static/nn/common.py fc):
    the dims from ``num_flatten_dims`` on are flattened, then xW + b and
    the activation. The leading dim is reshaped as -1, so a feed of any
    batch size runs the program."""
    from .. import tensor as T
    from ..nn import initializer as I

    name = _uname("fc", name)
    shape = list(x.shape)
    in_features = int(np.prod(shape[num_flatten_dims:]))
    if num_flatten_dims != len(shape) - 1 or len(shape) > 2:
        x = T.reshape(x, [-1] + shape[1:num_flatten_dims] + [in_features])
    w = _param(I.XavierNormal(), (in_features, size), name + ".w")
    out = T.matmul(x, w)
    if bias_attr is not False:
        out = out + _param(I.Constant(0.0), (size,), name + ".b")
    return _act(out, activation)


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,  # noqa: A002
           groups=1, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None, data_format="NCHW"):
    from ..nn import Conv2D

    out = Conv2D(int(input.shape[1]), num_filters, filter_size,
                 stride=stride, padding=padding, dilation=dilation,
                 groups=groups, weight_attr=param_attr, bias_attr=bias_attr,
                 data_format=data_format)(input)
    return _act(out, act)


def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,  # noqa: A002
           groups=1, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None, data_format="NCDHW"):
    from ..nn import Conv3D

    out = Conv3D(int(input.shape[1]), num_filters, filter_size,
                 stride=stride, padding=padding, dilation=dilation,
                 groups=groups, weight_attr=param_attr, bias_attr=bias_attr,
                 data_format=data_format)(input)
    return _act(out, act)


def _deconv_filter(filter_size, output_size, in_spatial, stride, padding):
    """Reference conv2d_transpose: the filter size derived from
    output_size when omitted (k = out - (in - 1) * stride + 2 * pad)."""
    if filter_size is not None:
        return filter_size
    if output_size is None:
        raise ValueError("conv transpose needs filter_size or output_size")
    n = len(in_spatial)
    outs = ([int(output_size)] * n if isinstance(output_size, int)
            else [int(v) for v in output_size])
    st = [int(stride)] * n if isinstance(stride, int) \
        else [int(v) for v in stride]
    pd = [int(padding)] * n if isinstance(padding, int) \
        else [int(v) for v in padding]
    return [outs[i] - (int(in_spatial[i]) - 1) * st[i] + 2 * pd[i]
            for i in range(n)]


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,  # noqa: A002
                     padding=0, stride=1, dilation=1, groups=1,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None, data_format="NCHW"):
    from ..nn import Conv2DTranspose

    filter_size = _deconv_filter(filter_size, output_size, input.shape[2:],
                                 stride, padding)
    out = Conv2DTranspose(int(input.shape[1]), num_filters, filter_size,
                          stride=stride, padding=padding, dilation=dilation,
                          groups=groups, weight_attr=param_attr,
                          bias_attr=bias_attr, data_format=data_format)(input)
    return _act(out, act)


def conv3d_transpose(input, num_filters, output_size=None, filter_size=None,  # noqa: A002
                     padding=0, stride=1, dilation=1, groups=1,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None, data_format="NCDHW"):
    from ..nn import Conv3DTranspose

    filter_size = _deconv_filter(filter_size, output_size, input.shape[2:],
                                 stride, padding)
    out = Conv3DTranspose(int(input.shape[1]), num_filters, filter_size,
                          stride=stride, padding=padding, dilation=dilation,
                          groups=groups, weight_attr=param_attr,
                          bias_attr=bias_attr, data_format=data_format)(input)
    return _act(out, act)


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,  # noqa: A002
               param_attr=None, bias_attr=None, data_layout="NCHW",
               name=None, moving_mean_name=None, moving_variance_name=None,
               do_model_average_for_mean_and_var=True, use_global_stats=False):
    from ..nn import BatchNorm

    bn = BatchNorm(int(input.shape[1]), momentum=momentum, epsilon=epsilon,
                   param_attr=param_attr, bias_attr=bias_attr,
                   data_layout=data_layout, use_global_stats=use_global_stats)
    if is_test:
        bn.eval()
    return _act(bn(input), act)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,  # noqa: A002
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    from ..nn import LayerNorm

    shape = [int(s) for s in input.shape[begin_norm_axis:]]
    ln = LayerNorm(shape, epsilon=epsilon,
                   weight_attr=param_attr if scale else False,
                   bias_attr=bias_attr if shift else False)
    return _act(ln(input), act)


def group_norm(input, groups, epsilon=1e-5, param_attr=None, bias_attr=None,  # noqa: A002
               act=None, data_layout="NCHW", name=None):
    from ..nn import GroupNorm

    gn = GroupNorm(groups, int(input.shape[1]), epsilon=epsilon,
                   weight_attr=param_attr, bias_attr=bias_attr)
    return _act(gn(input), act)


def instance_norm(input, epsilon=1e-5, param_attr=None, bias_attr=None,  # noqa: A002
                  name=None):
    from ..nn import InstanceNorm2D

    return InstanceNorm2D(int(input.shape[1]), epsilon=epsilon,
                          weight_attr=param_attr, bias_attr=bias_attr)(input)


def _dn(x, size, sums, sqs, epsilon):
    mean = sums / size
    var = sqs / size - mean * mean
    return (x - mean) / torch.sqrt(var + epsilon)


def data_norm(input, act=None, epsilon=1e-5, param_attr=None,  # noqa: A002
              data_layout="NCHW", in_place=False, name=None,
              moving_mean_name=None, moving_variance_name=None,
              do_model_average_for_mean_and_var=True, slot_dim=-1,
              sync_stats=False, summary_decay_rate=0.9999999,
              enable_scale_and_shift=False):
    """Reference data_norm_op.cc: normalization by accumulated batch
    statistics (batch_size / batch_sum / batch_square_sum), no learned
    scale: out = (x - sum/size) / sqrt(square_sum/size - mean² + eps).
    The statistics are not trained (trainable=False)."""
    from ..nn import initializer as I

    name = _uname("dn", name)
    D = int(input.shape[1])
    size = _param(I.Constant(1e4), (D,), name + ".size", trainable=False)
    sums = _param(I.Constant(0.0), (D,), name + ".sum", trainable=False)
    sqs = _param(I.Constant(1e4), (D,), name + ".sq", trainable=False)
    return _act(apply_op(_dn, input, size, sums, sqs,
                         epsilon=float(epsilon), op_name="data_norm"), act)


def _sn(w, dim, power_iters, eps):
    wm = torch.movedim(w, dim, 0).reshape(w.shape[dim], -1)
    u = torch.ones(wm.shape[0], dtype=w.dtype, device=w.device) \
        / math.sqrt(wm.shape[0])
    v = torch.ones(wm.shape[1], dtype=w.dtype, device=w.device) \
        / math.sqrt(wm.shape[1])
    for _ in range(max(power_iters, 1)):
        v = wm.t() @ u
        v = v / (torch.linalg.vector_norm(v) + eps)
        u = wm @ v
        u = u / (torch.linalg.vector_norm(u) + eps)
    sigma = u @ wm @ v
    return w / sigma


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    """Power-iteration spectral normalization of a weight (reference
    spectral_norm_op.cc): weight / sigma, u and v starting from the
    normalized ones vectors as in the JAX package."""
    return apply_op(_sn, weight, dim=int(dim), power_iters=int(power_iters),
                    eps=float(eps), op_name="spectral_norm")


def embedding(input, size, is_sparse=False, is_distributed=False,  # noqa: A002
              padding_idx=None, param_attr=None, dtype="float32"):
    from ..nn import Embedding

    emb = Embedding(int(size[0]), int(size[1]), padding_idx=padding_idx,
                    sparse=is_sparse, weight_attr=param_attr)
    return emb(input)


def sparse_embedding(input, size, padding_idx=None, is_test=False,  # noqa: A002
                     entry=None, param_attr=None, dtype="float32"):
    """Reference sparse_embedding (a parameter-server table): dense here,
    as in the JAX package; ``entry`` admission configs are ignored."""
    return embedding(input, size, is_sparse=True, padding_idx=padding_idx,
                     param_attr=param_attr, dtype=dtype)


def prelu(x, mode="all", param_attr=None, name=None):
    from ..nn import functional as F
    from ..nn import initializer as I

    if mode == "all":
        shape = (1,)
    elif mode == "channel":
        shape = (int(x.shape[1]),)
    elif mode == "element":
        shape = tuple(int(s) for s in x.shape[1:])
    else:
        raise ValueError("mode must be all/channel/element")
    alpha = _param(I.Constant(0.25), shape,
                   _uname("prelu", name) + ".alpha")
    if mode == "element":
        return apply_op(_prelu_element, x, alpha, op_name="prelu")
    return F.prelu(x, alpha)


def _prelu_element(x, a):
    return torch.where(x >= 0, x, a.unsqueeze(0) * x)


def _btp(x, y, w, b):
    return torch.einsum("bd,kde,be->bk", x, w, y) + b


def bilinear_tensor_product(x, y, size, act=None, name=None,
                            param_attr=None, bias_attr=None):
    """out_k = x W_k yᵀ + b (reference bilinear_tensor_product_op.cc)."""
    from ..nn import initializer as I

    name = _uname("btp", name)
    dx, dy = int(x.shape[-1]), int(y.shape[-1])
    w = _param(I.XavierNormal(), (size, dx, dy), name + ".w")
    b = _param(I.Constant(0.0), (size,), name + ".b")
    return _act(apply_op(_btp, x, y, w, b, op_name="bilinear_tensor_product"),
                act)


def _rc(x, w):
    T = x.shape[1]
    out = torch.zeros_like(x)
    t = torch.arange(T, device=x.device)
    for i in range(w.shape[0]):
        shifted = torch.roll(x, -i, dims=1)
        ok = (t + i < T)[None, :, None]
        out = out + torch.where(ok, shifted, torch.zeros_like(shifted)) * w[i]
    return out


def row_conv(input, future_context_size, param_attr=None, act=None):  # noqa: A002
    """Lookahead row convolution (reference row_conv_op.cc):
    out[t] = sum_{i=0..ctx} w[i] * x[t+i], per feature."""
    from ..nn import initializer as I

    D = int(input.shape[-1])
    ctx = int(future_context_size) + 1
    w = _param(I.XavierNormal(), (ctx, D), _uname("row_conv", None) + ".w")
    return _act(apply_op(_rc, input, w, op_name="row_conv"), act)


def _crf_emissions(emis, trans, lens):
    """Fold the start row into the first step's emissions and the stop
    row into each sequence's last."""
    B = emis.shape[0]
    emis = emis.clone()
    emis[:, 0] = emis[:, 0] + trans[0]
    last = torch.clamp(lens.reshape(-1).long() - 1, min=0)
    bi = torch.arange(B, device=emis.device)
    emis[bi, last] = emis[bi, last] + trans[1]
    return emis, trans[2:].contiguous(), lens.reshape(-1).long()


def _crf_check(p, l):
    return (p == l.reshape(p.shape)).long()


def crf_decoding(input, param_attr, label=None, length=None):  # noqa: A002
    """Viterbi decode with learned CRF transitions (reference
    crf_decoding_op.h). ``param_attr`` IS the transition tensor
    ([num_tags + 2, num_tags]: rows 0 / 1 are start / stop, as in
    linear_chain_crf_op), captured directly where the reference resolves
    a parameter name through the Scope."""
    from ..text import viterbi_decode

    trans = param_attr if isinstance(param_attr, Tensor) \
        else Tensor(np.asarray(param_attr, np.float32))
    if length is None:
        B, T = int(input.shape[0]), int(input.shape[1])
        from ..text import _device

        length = Tensor(torch.full((B,), T, dtype=torch.int64,
                                   device=_device(input)))
    emis, pair, lens = apply_op(_crf_emissions, input, trans, length,
                                op_name="crf_emissions")
    _, path = viterbi_decode(emis, pair, lens, include_bos_eos_tag=False)
    if label is not None:
        return apply_op(_crf_check, path, label, op_name="crf_decoding_check")
    return path


def _nce(x, lab, w, b, neg, num_neg_samples, num_total_classes):
    lab = lab.reshape(-1).long()
    pos_logit = torch.sum(x * w[lab], -1) + b[lab]
    neg_logit = x @ w[neg].t() + b[neg]                  # [B, S]
    # P(noise) = 1 / num_total_classes under the uniform sampler
    log_noise = math.log(num_neg_samples / num_total_classes)
    pos = TF.softplus(-(pos_logit - log_noise))
    negl = TF.softplus(neg_logit - log_noise)
    return (pos + torch.sum(negl, -1))[:, None]


def nce(input, label, num_total_classes, sample_weight=None,  # noqa: A002
        param_attr=None, bias_attr=None, num_neg_samples=10, name=None,
        sampler="uniform", custom_dist=None, seed=0, is_sparse=False):
    """Noise-contrastive estimation loss (reference nce_op.h): binary
    logistic on the true class against ``num_neg_samples`` uniform
    negatives. The negatives are drawn at the call (eagerly each call;
    in a program once, at build time, as every random draw of the JAX
    package's programs is): from the device's generator, or with
    ``seed`` from a generator seeded by (seed, the call's index in the
    program), so rebuilding the program reproduces them."""
    from ..device import current_device
    from ..framework import random as grandom
    from ..nn import initializer as I

    if sampler != "uniform" or custom_dist is not None:
        raise NotImplementedError("nce: only the uniform sampler is "
                                  "implemented")
    name = _uname("nce", name)
    D = int(input.shape[-1])
    w = _param(I.XavierNormal(), (num_total_classes, D), name + ".w")
    b = _param(I.Constant(0.0), (num_total_classes,), name + ".b")
    dev = current_device()
    if seed:
        from . import default_main_program

        prog = default_main_program()
        idx = getattr(prog, "_nce_counter", 0) + 1
        prog._nce_counter = idx
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed) * 1000003 + idx)
    else:
        gen = grandom.generator(dev)
    neg = torch.randint(0, int(num_total_classes), (int(num_neg_samples),),
                        generator=gen, device=dev)
    return apply_op(_nce, input, label, w, b, Tensor(neg),
                    num_neg_samples=int(num_neg_samples),
                    num_total_classes=int(num_total_classes), op_name="nce")


def multi_box_head(inputs, image, base_size, num_classes, aspect_ratios,
                   min_ratio=None, max_ratio=None, min_sizes=None,
                   max_sizes=None, steps=None, step_w=None, step_h=None,
                   offset=0.5, variance=(0.1, 0.1, 0.2, 0.2), flip=True,
                   clip=False, kernel_size=1, pad=0, stride=1, name=None,
                   min_max_aspect_ratios_order=False):
    """SSD detection head (reference detection.py multi_box_head): per
    feature map, conv loc / conf predictions and prior boxes; outputs
    concatenated (mbox_locs [N, M, 4], mbox_confs [N, M, C], prior boxes
    [M, 4], variances [M, 4])."""
    from .. import tensor as T
    from ..vision.ops import prior_box

    if min_sizes is None:
        num_layer = len(inputs)
        min_sizes, max_sizes = [], []
        step = (int(np.floor((max_ratio - min_ratio) / (num_layer - 2)))
                if num_layer > 2 else (max_ratio - min_ratio))
        for ratio in range(min_ratio, max_ratio + 1, max(step, 1)):
            min_sizes.append(base_size * ratio / 100.0)
            max_sizes.append(base_size * (ratio + step) / 100.0)
        min_sizes = ([base_size * 0.10] + min_sizes)[:num_layer]
        max_sizes = ([base_size * 0.20] + max_sizes)[:num_layer]

    locs, confs, boxes, vars_ = [], [], [], []
    for i, feat in enumerate(inputs):
        ar = aspect_ratios[i] if isinstance(aspect_ratios[i], (list, tuple)) \
            else [aspect_ratios[i]]
        mins = min_sizes[i] if isinstance(min_sizes[i], (list, tuple)) \
            else [min_sizes[i]]
        maxs = max_sizes[i] if isinstance(max_sizes[i], (list, tuple)) \
            else [max_sizes[i]]
        box, var = prior_box(feat, image, mins, maxs, ar, list(variance),
                             flip=flip, clip=clip,
                             steps=([steps[i], steps[i]] if steps
                                    else [0.0, 0.0]),
                             offset=offset,
                             min_max_aspect_ratios_order=(
                                 min_max_aspect_ratios_order))
        num_priors = int(box.shape[0] * box.shape[1] * box.shape[2]) // (
            int(feat.shape[2]) * int(feat.shape[3]))
        loc = conv2d(feat, num_priors * 4, kernel_size, stride=stride,
                     padding=pad)
        conf = conv2d(feat, num_priors * num_classes, kernel_size,
                      stride=stride, padding=pad)
        n = int(feat.shape[0])
        locs.append(T.reshape(T.transpose(loc, [0, 2, 3, 1]), [n, -1, 4]))
        confs.append(T.reshape(T.transpose(conf, [0, 2, 3, 1]),
                               [n, -1, num_classes]))
        boxes.append(T.reshape(box, [-1, 4]))
        vars_.append(T.reshape(var, [-1, 4]))
    return (T.concat(locs, 1), T.concat(confs, 1), T.concat(boxes, 0),
            T.concat(vars_, 0))


def deform_conv2d(x, offset, mask, num_filters, filter_size, stride=1,
                  padding=0, dilation=1, groups=1, deformable_groups=1,
                  im2col_step=1, weight_attr=None, bias_attr=None, name=None):
    from ..nn import initializer as I
    from ..vision.ops import deform_conv2d as _dc

    name = _uname("dcn", name)
    k = filter_size if isinstance(filter_size, (list, tuple)) \
        else (filter_size, filter_size)
    cin = int(x.shape[1])
    w = _param(I.XavierNormal(), (num_filters, cin // groups, k[0], k[1]),
               name + ".w")
    b = None
    if bias_attr is not False:
        b = _param(I.Constant(0.0), (num_filters,), name + ".b")
    return _dc(x, offset, w, bias=b, stride=stride, padding=padding,
               dilation=dilation, deformable_groups=deformable_groups,
               groups=groups, mask=mask)


class _PyFunc:
    """A host-Python op: the arrays go to the host as numpy, ``func``
    runs there, and its results come back as tensors of the declared
    shapes and dtypes. A program holding it runs uncaptured."""

    __name__ = "py_func"
    host_read = True

    def __init__(self, func, specs, multi):
        self.func = func
        self.specs = specs
        self.multi = multi

    def __call__(self, *arrays):
        dev = arrays[0].device if arrays else torch.device("cpu")
        if dev.type == "meta":
            return tuple(torch.empty(s, dtype=d, device="meta")
                         for s, d in self.specs) if self.multi else \
                torch.empty(self.specs[0][0], dtype=self.specs[0][1],
                            device="meta")
        hs = [a.detach().cpu().numpy() for a in arrays]
        res = self.func(*hs)
        res = res if self.multi else (res,)
        outs = tuple(torch.as_tensor(np.asarray(r)).to(device=dev, dtype=d)
                     .reshape(s) for r, (s, d) in zip(res, self.specs))
        return outs if self.multi else outs[0]


def py_func(func, x, out, backward_func=None, skip_vars_in_backward_input=None):
    """Host-Python op (reference py_func_op.cc): ``func`` runs on the
    host values; ``out`` is the template Tensor(s) declaring the result
    shapes and dtypes. ``backward_func`` is refused, as in the JAX
    package: compose differentiable ops instead."""
    if backward_func is not None:
        raise NotImplementedError(
            "py_func backward_func is not supported; compose differentiable "
            "ops instead")
    xs = x if isinstance(x, (list, tuple)) else [x]
    outs = out if isinstance(out, (list, tuple)) else [out]
    specs = [(tuple(int(s) for s in o.shape), o.dtype) for o in outs]
    return apply_op(_PyFunc(func, specs, isinstance(out, (list, tuple))),
                    *xs, op_name="py_func")
