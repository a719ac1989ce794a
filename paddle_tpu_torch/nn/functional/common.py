"""The common functionals (``paddle_tpu/nn/functional/common.py``).
``linear`` takes Paddle's ``(in, out)`` weight and, under
``amp.auto_cast``, casts ``x`` and the weight (not the bias) to the AMP
dtype; the dropouts and ``class_center_sample`` draw from the input
device's seeded generator.

``interpolate`` without ``align_corners`` resizes as the reference's
``jax.image.resize`` does, not as ``torch.nn.functional.interpolate``:
half-pixel centres everywhere (``nearest`` reads source
floor((i + 0.5)·in / out), torch's ``nearest-exact``); ``linear`` and
``cubic`` weights come from the triangle and the Keys cubic (a = −0.5,
torch's is −0.75) kernels, widened by in / out when downsampling (an
antialiasing filter on every axis and rank), normalized, and zero for a
sample outside the input; ``area`` is ``linear``. The weights are built
per axis (:func:`_resize_weights`) and applied axis by axis. With
``align_corners`` it samples ``linspace(0, in - 1, out)``: ``nearest``
rounds half to even, every other mode interpolates linearly (``bicubic``
too, as the reference does).

``class_center_sample`` keeps every class of the batch and fills up to
``num_samples`` with other classes drawn without replacement (one
process; the reference raises ``NotImplementedError``)."""
from __future__ import annotations

import math
import warnings

import numpy as np
import torch
import torch.nn.functional as TF

from ...framework import random as grandom
from ...framework.core import Tensor, apply_op, records
from ...tensor.creation import one_hot  # noqa: F401
from ...tensor.manipulation import pad  # noqa: F401

__all__ = [
    "linear", "dropout", "dropout2d", "dropout3d", "alpha_dropout",
    "embedding", "interpolate", "upsample", "one_hot", "pad", "unfold",
    "fold", "cosine_similarity", "pixel_shuffle", "pixel_unshuffle",
    "normalize", "label_smooth", "class_center_sample", "bilinear",
    "grid_sample", "affine_grid",
]


def _linear(x, w, b=None):
    y = torch.matmul(x, w)
    return y if b is None else y + b


def linear(x, weight, bias=None, name=None):
    from ...amp import maybe_autocast

    x, weight = maybe_autocast(x, weight)
    if bias is None:
        return apply_op(_linear, x, weight)
    return apply_op(_linear, x, weight, bias)


def _dropout_train(x, keep, p, mode):
    if mode == "upscale_in_train":
        return x * keep / (1.0 - p)
    return x * keep


def _scale_by(x, factor):
    return x * factor


@records
def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return apply_op(_scale_by, x, factor=1.0 - p)
        return x
    xa = x._data
    if axis is None:
        mshape = xa.shape
    else:
        axes = (axis,) if isinstance(axis, int) else tuple(axis)
        mshape = tuple(s if i in axes else 1 for i, s in enumerate(xa.shape))
    keep = torch.empty(mshape, dtype=xa.dtype, device=xa.device).bernoulli_(
        1.0 - p, generator=grandom.generator(xa.device))
    return apply_op(_dropout_train, x, keep.expand(xa.shape), p=float(p),
                    mode=mode)


def _embedding(weight, ids, padding_idx=None):
    out = weight[ids]
    if padding_idx is not None:
        out = out * (ids != padding_idx).unsqueeze(-1).to(out.dtype)
    return out


_sparse_warned = [False]


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` at the integer ids ``x``; rows of
    ``padding_idx`` read as zeros. ``sparse=True`` takes the dense
    backward, as the JAX package does without a device mesh."""
    if sparse and not _sparse_warned[0]:
        _sparse_warned[0] = True
        warnings.warn("Embedding(sparse=True) runs the dense backward in "
                      "paddle_tpu_torch (values and gradients are the "
                      "same)", stacklevel=2)
    ids = x if isinstance(x, Tensor) else Tensor(x)
    return apply_op(_embedding, weight, ids.astype("int64"),
                    padding_idx=padding_idx)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    """Whole channels zeroed (one mask element a sample and channel)."""
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p, axis=axis, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p, axis=axis, training=training)


_SELU_ALPHA, _SELU_SCALE = 1.6732632423543772, 1.0507009873554805


def _alpha_dropout_apply(x, keep, alpha_p, a, b):
    return (torch.where(keep, x, torch.full_like(x, alpha_p)) * a
            + b).to(x.dtype)


@records
def alpha_dropout(x, p=0.5, training=True, name=None):
    """Dropout for SELU nets: dropped elements take SELU's negative
    saturation value, and an affine map keeps mean and variance."""
    if not training or p == 0.0:
        return x
    xa = x._data
    keep = torch.empty(xa.shape, device=xa.device).bernoulli_(
        1.0 - p, generator=grandom.generator(xa.device)).bool()
    alpha_p = -_SELU_ALPHA * _SELU_SCALE
    a = 1.0 / ((1 - p) * (1 + p * alpha_p ** 2)) ** 0.5
    return apply_op(_alpha_dropout_apply, x, keep, alpha_p=alpha_p, a=a,
                    b=-a * alpha_p * p)


# -- resizing ----------------------------------------------------------------

def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x):
    return torch.clamp(1.0 - torch.abs(x), min=0.0)


def _resize_weights(n_in, n_out, kernel, device):
    """The (n_in, n_out) weights of one axis, as ``jax.image.resize``
    builds them (half-pixel centres, antialiased when downsampling)."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = ((torch.arange(n_out, dtype=torch.float32, device=device) + 0.5)
              * inv_scale - 0.5)
    dist = torch.abs(sample[None, :] - torch.arange(
        n_in, dtype=torch.float32, device=device)[:, None]) / kernel_scale
    w = kernel(dist)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _along(x, d, fn):
    """``fn`` on ``x`` with axis ``d`` moved last, the axis put back."""
    return fn(x.movedim(d, -1)).movedim(-1, d)


def _interpolate(x, out_size, mode, align_corners):
    if not align_corners:
        for i, n_out in enumerate(out_size):
            d, n_in = 2 + i, x.shape[2 + i]
            if n_in == n_out:
                continue
            if mode == "nearest":
                src = torch.floor(((torch.arange(
                    n_out, dtype=torch.float32, device=x.device) + 0.5)
                    * n_in / n_out)).long()
                x = torch.index_select(x, d, src)
                continue
            kernel = _keys_cubic if mode == "bicubic" else _triangle
            w = _resize_weights(n_in, n_out, kernel, x.device).to(x.dtype)
            x = _along(x, d, lambda v: v @ w)
        return x
    for i, n_out in enumerate(out_size):
        d, n_in = 2 + i, x.shape[2 + i]
        # the sample positions i·(in − 1)/(out − 1), exact in f64
        g = (torch.arange(n_out, dtype=torch.float64, device=x.device)
             * (n_in - 1) / max(n_out - 1, 1))
        if mode == "nearest":
            x = torch.index_select(x, d, torch.round(g).long())
            continue
        lo = torch.floor(g).long()
        hi = torch.clamp(lo + 1, max=n_in - 1)
        shape = [1] * x.dim()
        shape[d] = n_out
        w = (g - lo).to(x.dtype).reshape(shape)
        x = (torch.index_select(x, d, lo) * (1 - w)
             + torch.index_select(x, d, hi) * w)
    return x


_MODES = {"nearest": "nearest", "bilinear": "linear", "trilinear": "linear",
          "linear": "linear", "bicubic": "bicubic", "area": "linear"}


def _interp_size(x, size, scale_factor, n_spatial):
    if size is not None:
        if isinstance(size, Tensor):
            size = size.tolist()
        return tuple(int(s.item()) if isinstance(s, Tensor) else int(s)
                     for s in size)
    if isinstance(scale_factor, (int, float)):
        scale_factor = [scale_factor] * n_spatial
    return tuple(int(math.floor(s * f))
                 for s, f in zip(x.shape[2:], scale_factor))


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    if data_format not in ("NCHW", "NCL", "NCDHW"):
        raise NotImplementedError("channels-last interpolate is not ported "
                                  "(the reference raises too)")
    out_size = _interp_size(x, size, scale_factor, x.ndim - 2)
    return apply_op(_interpolate, x, out_size=out_size, mode=_MODES[mode],
                    align_corners=bool(align_corners))


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


# -- patches -----------------------------------------------------------------

def _pair(v):
    return (int(v), int(v)) if isinstance(v, (int, np.integer)) \
        else tuple(int(a) for a in v)


def _pads4(paddings):
    """(top, bottom, left, right) from an int, a pair or four values."""
    if isinstance(paddings, (int, np.integer)):
        return (int(paddings),) * 4
    if len(paddings) == 2:
        return (paddings[0], paddings[0], paddings[1], paddings[1])
    return tuple(int(p) for p in paddings)


def _unfold(x, k, strides, pads, dils):
    x = TF.pad(x, (pads[2], pads[3], pads[0], pads[1]))
    return TF.unfold(x, k, dilation=dils, stride=strides)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: (N, C·kh·kw, L), channel-major as the reference's."""
    return apply_op(_unfold, x, k=_pair(kernel_sizes), strides=_pair(strides),
                    pads=_pads4(paddings), dils=_pair(dilations))


def _fold(x, output_sizes, k, strides, pads, dils):
    oh, ow = output_sizes
    ph, pw = oh + pads[0] + pads[1], ow + pads[2] + pads[3]
    out = TF.fold(x, (ph, pw), k, dilation=dils, stride=strides)
    return out[:, :, pads[0]:ph - pads[1], pads[2]:pw - pads[3]]


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im: the sum of overlapping patches back into (N, C, H, W)."""
    return apply_op(_fold, x, output_sizes=_pair(output_sizes),
                    k=_pair(kernel_sizes), strides=_pair(strides),
                    pads=_pads4(paddings), dils=_pair(dilations))


# -- similarity, shuffles, normalization -----------------------------------------

def _cosine_similarity(x1, x2, axis=1, eps=1e-8):
    dot = torch.sum(x1 * x2, dim=axis)
    n1 = torch.sqrt(torch.sum(x1 * x1, dim=axis))
    n2 = torch.sqrt(torch.sum(x2 * x2, dim=axis))
    return dot / torch.clamp(n1 * n2, min=eps)


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    return apply_op(_cosine_similarity, x1, x2, axis=int(axis),
                    eps=float(eps))


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    return apply_op(TF.pixel_shuffle, x, upscale_factor=int(upscale_factor))


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    return apply_op(TF.pixel_unshuffle, x,
                    downscale_factor=int(downscale_factor))


def _normalize(x, p=2.0, axis=1, epsilon=1e-12):
    norm = torch.pow(torch.sum(torch.pow(torch.abs(x), p), dim=axis,
                               keepdim=True), 1.0 / p)
    return x / torch.clamp(norm, min=epsilon)


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    return apply_op(_normalize, x, p=float(p), axis=int(axis),
                    epsilon=float(epsilon))


def _label_smooth(label, prior=None, epsilon=0.1):
    if prior is None:
        return label * (1.0 - epsilon) + epsilon / label.shape[-1]
    return label * (1.0 - epsilon) + epsilon * prior


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    if prior_dist is None:
        return apply_op(_label_smooth, label, epsilon=float(epsilon))
    return apply_op(_label_smooth, label, prior_dist, epsilon=float(epsilon))


@records
def class_center_sample(label, num_classes, num_samples, group=None):
    """(remapped label, sampled class centres): every class of ``label``
    (sorted) followed by other classes drawn without replacement from
    the device's generator (sorted) up to ``num_samples`` in all; the
    label remapped to its class's position among them."""
    if group is not None:
        raise NotImplementedError("class_center_sample over a process group "
                                  "needs multi-GPU (ROADMAP.md item 7)")
    lab = label._data.detach().long()
    pos = torch.unique(lab)
    n_neg = max(int(num_samples) - pos.numel(), 0)
    keys = torch.rand(int(num_classes), device=lab.device,
                      generator=grandom.generator(lab.device))
    keys[pos] = 2.0
    neg = torch.sort(torch.topk(keys, n_neg, largest=False).indices).values
    centers = torch.cat([pos, neg])
    remapped = torch.searchsorted(pos, lab.reshape(-1)).reshape(lab.shape)
    return Tensor(remapped), Tensor(centers)


def _bilinear(x1, x2, w, b=None):
    y = torch.einsum("bi,oij,bj->bo", x1, w, x2)
    return y if b is None else y + b


def bilinear(x1, x2, weight, bias=None, name=None):
    if bias is None:
        return apply_op(_bilinear, x1, x2, weight)
    return apply_op(_bilinear, x1, x2, weight, bias)


# -- grid sampling ---------------------------------------------------------------

def _bilinear_batch(feat, ys, xs, bounds="zero_corner", index=None):
    """The bilinear gather that RoI align, PS-RoI pool and deformable
    convolution share (``paddle_tpu/nn/functional/common.py:353``), over
    a batch: feat [N, C, H, W], ys/xs [B, ...] float coordinates ->
    [B, C, ...], row b reading feature map ``index[b]`` (default b).
    The JAX function gathers one [C, H, W] map and its callers vmap it;
    the four corners here are one advanced-index gather each from the
    [N, H·W, C] view, so the backward is one index_put with
    accumulation.

    - bounds="zero_corner": an out-of-range corner contributes zero (the
      reference's grid_sampler zeros mode, deformable_conv_op.h
      DmcnIm2colBilinear).
    - bounds="clamp_sample": corner indices clamp to the edge; only whole
      samples outside [-1, H]x[-1, W] are zeroed (roi_align_op.h
      bilinear_interpolate).
    """
    N, C, H, W = feat.shape
    B, shape = ys.shape[0], ys.shape[1:]
    ys, xs = ys.reshape(B, -1), xs.reshape(B, -1)
    flat = feat.permute(0, 2, 3, 1).reshape(N, H * W, C)
    rows = (index if index is not None
            else torch.arange(B, device=feat.device)).reshape(B, 1)
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy1, wx1 = (ys - y0)[..., None], (xs - x0)[..., None]

    def at(yy, xx):
        yi = yy.clamp(0, H - 1).long()
        xi = xx.clamp(0, W - 1).long()
        v = flat[rows, yi * W + xi]                       # [B, P, C]
        if bounds == "clamp_sample":
            return v
        ok = (yy >= 0) & (yy <= H - 1) & (xx >= 0) & (xx <= W - 1)
        return torch.where(ok[..., None], v, 0.0)

    out = (at(y0, x0) * (1 - wy1) * (1 - wx1)
           + at(y0, x0 + 1) * (1 - wy1) * wx1
           + at(y0 + 1, x0) * wy1 * (1 - wx1)
           + at(y0 + 1, x0 + 1) * wy1 * wx1)
    if bounds == "clamp_sample":
        ok = (ys >= -1) & (ys <= H) & (xs >= -1) & (xs <= W)
        out = torch.where(ok[..., None], out, 0.0)
    return out.transpose(1, 2).reshape(B, C, *shape)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """Sample x [N,C,H,W] at the normalized grid [N,Ho,Wo,2] (Paddle's
    default ``align_corners=True``): an out-of-range corner adds zero in
    ``zeros`` mode; ``border`` clamps and ``reflection`` folds the
    coordinates first. Differentiable in x and the grid."""
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"grid_sample mode must be bilinear|nearest, got "
                         f"{mode}")
    if padding_mode not in ("zeros", "border", "reflection"):
        raise ValueError(f"bad padding_mode {padding_mode}")
    return apply_op(TF.grid_sample, x, grid, mode=mode,
                    padding_mode=padding_mode,
                    align_corners=bool(align_corners))


def _affine_grid(theta, h, w, align_corners):
    dev, dt = theta.device, theta.dtype
    if align_corners:
        xs = torch.linspace(-1.0, 1.0, w, device=dev)
        ys = torch.linspace(-1.0, 1.0, h, device=dev)
    else:
        xs = (torch.arange(w, device=dev) * 2.0 + 1.0) / w - 1.0
        ys = (torch.arange(h, device=dev) * 2.0 + 1.0) / h - 1.0
    gy, gx = torch.meshgrid(ys.to(dt), xs.to(dt), indexing="ij")
    # multiply-adds, not a matmul: no reduced-precision product on the
    # sampling coordinates
    t = theta[:, None, None, :, :]
    return (gx[None, :, :, None] * t[..., 0] + gy[None, :, :, None]
            * t[..., 1] + t[..., 2])


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """The sampling grid [N,H,W,2] of the 2-D affine maps theta [N,2,3]
    for ``out_shape`` [N,C,H,W] (with :func:`grid_sample`, the spatial
    transformer)."""
    if isinstance(out_shape, Tensor):
        out_shape = out_shape.tolist()
    _, _, h, w = (int(v) for v in out_shape)
    return apply_op(_affine_grid, theta, h=h, w=w,
                    align_corners=bool(align_corners))
