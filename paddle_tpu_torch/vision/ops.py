"""Detection ops of ``paddle.vision.ops`` (``paddle_tpu/vision/ops.py``).

Two kinds, as in the JAX package:

- Device ops: plain PyTorch on the input's device, differentiable where
  the reference is (``yolo_box``, ``yolo_loss``, ``roi_align``,
  ``roi_pool``, ``psroi_pool``, ``deform_conv2d``, ``box_coder``,
  ``box_iou``, ``iou_similarity``, ``box_clip``,
  ``polygon_box_transform`` and ``ssd_loss``'s loss). ``yolo_loss``
  reads nothing back to the host, so it runs inside a captured
  ``jit.TrainStep``. The bilinear gathers of RoI align and deformable
  convolution share ``nn/functional/common.py``'s ``_bilinear_batch``.
- Host ops with data-dependent output sizes (the prior and anchor
  generators, matching, target assignment, proposal generation and the
  samplers): numpy on the host, as the JAX package runs them, with the
  result on the current device. The samplers draw from a numpy
  generator seeded from ``paddle.seed`` and the process rank
  (:func:`_det_rng`), so their draws equal the JAX package's.

``nms``, ``multiclass_nms`` and ``matrix_nms`` run on the input's device.
Where the JAX ``multiclass_nms`` builds the IoU of all M boxes of an
image on the host (M = 22,743 at YOLOv3's 608 input), the port builds it
only among each class's at most ``nms_top_k`` candidates, and runs the
greedy sweep for every (image, class) at once: one boolean mask update
per candidate position. The output is the JAX function's.

``read_file`` and ``decode_jpeg`` read and decode on the host (PIL,
imported when called).
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch

from ..framework import random as grandom
from ..framework.core import Tensor, _as_torch, apply_op
from ..nn import initializer as I
from ..nn.functional.common import _bilinear_batch
from ..nn.layer.layers import Layer

__all__ = ["yolo_box", "roi_align", "roi_pool", "psroi_pool", "nms",
           "box_iou", "prior_box", "box_coder", "bipartite_match",
           "multiclass_nms", "matrix_nms", "deform_conv2d", "iou_similarity",
           "box_clip", "anchor_generator", "generate_proposals",
           "distribute_fpn_proposals", "collect_fpn_proposals",
           "RoIAlign", "RoIPool", "yolo_loss", "DeformConv2D", "PSRoIPool",
           "read_file", "decode_jpeg", "ssd_loss", "target_assign",
           "density_prior_box", "rpn_target_assign",
           "generate_proposal_labels", "retinanet_target_assign",
           "retinanet_detection_output", "polygon_box_transform",
           "locality_aware_nms"]

_F32 = torch.float32


def _arr(x):
    """The torch tensor of a Tensor; other data as a tensor on the
    current device."""
    if isinstance(x, Tensor):
        return x._data
    if isinstance(x, torch.Tensor):
        return x
    return _as_torch(x)


def _np(x, dtype=None):
    """x as a host numpy array (a device tensor is copied back)."""
    t = x._data if isinstance(x, Tensor) else x
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        a = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    else:
        a = np.asarray(t)
    return a if dtype is None else a.astype(dtype, copy=False)


def _out(a):
    """A host result as a Tensor on the current device."""
    return Tensor(np.ascontiguousarray(a))


_CONSTS: dict = {}


def _const(values, device, dtype=_F32):
    """A small constant tensor (anchors, masks) made once per device and
    kept: the first call of a captured step is eager, so a capture finds
    it made and copies nothing from the host."""
    key = (tuple(values), str(device), dtype)
    t = _CONSTS.get(key)
    if t is None:
        t = torch.tensor(list(values), dtype=dtype, device=device)
        _CONSTS[key] = t
    return t


def _clip(x, lo, hi):
    """jnp.clip(x, lo, hi) with tensor bounds: min(max(x, lo), hi)."""
    return torch.minimum(torch.clamp(x, min=lo), hi)


# -- yolo_box ---------------------------------------------------------------

def _yolo_box(x, img_size, anchors, class_num, conf_thresh,
              downsample_ratio, clip_bbox, scale_x_y):
    n, c, h, w = x.shape
    s = len(anchors) // 2
    an = _const(anchors, x.device).reshape(s, 2)
    x = x.reshape(n, s, 5 + class_num, h, w)
    grid_x = torch.arange(w, dtype=_F32, device=x.device)[None, :]
    grid_y = torch.arange(h, dtype=_F32, device=x.device)[:, None]
    alpha = scale_x_y
    beta = -0.5 * (scale_x_y - 1.0)
    bx = (torch.sigmoid(x[:, :, 0]) * alpha + beta + grid_x) / w
    by = (torch.sigmoid(x[:, :, 1]) * alpha + beta + grid_y) / h
    bw = torch.exp(x[:, :, 2]) * an[None, :, 0, None, None] / (
        downsample_ratio * w)
    bh = torch.exp(x[:, :, 3]) * an[None, :, 1, None, None] / (
        downsample_ratio * h)
    conf = torch.sigmoid(x[:, :, 4])
    probs = torch.sigmoid(x[:, :, 5:])
    img_h = img_size[:, 0].to(_F32).reshape(n, 1, 1, 1)
    img_w = img_size[:, 1].to(_F32).reshape(n, 1, 1, 1)
    x1 = (bx - bw / 2) * img_w
    y1 = (by - bh / 2) * img_h
    x2 = (bx + bw / 2) * img_w
    y2 = (by + bh / 2) * img_h
    if clip_bbox:
        x1, x2 = _clip(x1, 0, img_w - 1), _clip(x2, 0, img_w - 1)
        y1, y2 = _clip(y1, 0, img_h - 1), _clip(y2, 0, img_h - 1)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1).reshape(n, s * h * w, 4)
    score = conf[:, :, None] * probs                      # [n,s,cls,h,w]
    keep = (conf > conf_thresh).to(score.dtype)[:, :, None]
    score = (score * keep).permute(0, 1, 3, 4, 2).reshape(
        n, s * h * w, class_num)
    return boxes, score


def yolo_box(x, img_size, anchors, class_num, conf_thresh,
             downsample_ratio, clip_bbox=True, name=None, scale_x_y=1.0,
             iou_aware=False, iou_aware_factor=0.5):
    """Decode a YOLOv3 head's output: (boxes [N, S·H·W, 4], scores
    [N, S·H·W, class_num]); a prediction whose objectness is at most
    ``conf_thresh`` scores 0."""
    if iou_aware:
        raise NotImplementedError("yolo_box: iou_aware not supported")
    return apply_op(_yolo_box, x, img_size,
                    anchors=tuple(int(a) for a in anchors),
                    class_num=int(class_num),
                    conf_thresh=float(conf_thresh),
                    downsample_ratio=int(downsample_ratio),
                    clip_bbox=bool(clip_bbox), scale_x_y=float(scale_x_y))


# -- roi align / pool -------------------------------------------------------

def _box_image(boxes_num, device):
    bn = _np(boxes_num).astype(np.int64).reshape(-1)
    return torch.as_tensor(np.repeat(np.arange(len(bn)), bn),
                           device=device)


def _roi_align(x, boxes, box_image, output_size, spatial_scale,
               sampling_ratio, aligned, sr_max):
    oh, ow = output_size
    off = 0.5 if aligned else 0.0
    adaptive = sampling_ratio <= 0
    sr = sr_max if adaptive else sampling_ratio
    R, dev = boxes.shape[0], x.device
    x1, y1, x2, y2 = (boxes * spatial_scale - off).unbind(-1)      # [R]
    rw = torch.clamp(x2 - x1, min=1e-6 if aligned else 1.0)
    rh = torch.clamp(y2 - y1, min=1e-6 if aligned else 1.0)
    bin_h, bin_w = rh / oh, rw / ow
    if adaptive:
        # roi_align_op: ceil(roi size / pooled size) samples a bin, per
        # RoI; the grid is padded to the batch's largest and masked
        sry = torch.clamp(torch.ceil(bin_h), 1, sr)
        srx = torch.clamp(torch.ceil(bin_w), 1, sr)
    else:
        sry = srx = torch.full_like(rh, float(sr))
    j = torch.arange(sr, dtype=_F32, device=dev)
    iy, my = (j + 0.5) / sry[:, None], j < sry[:, None]            # [R,sr]
    ix, mx = (j + 0.5) / srx[:, None], j < srx[:, None]
    gy = y1[:, None, None] + (torch.arange(oh, device=dev)[None, :, None]
                              + iy[:, None, :]) * bin_h[:, None, None]
    gx = x1[:, None, None] + (torch.arange(ow, device=dev)[None, :, None]
                              + ix[:, None, :]) * bin_w[:, None, None]
    ys = gy.reshape(R, -1, 1).expand(R, oh * sr, ow * sr)
    xs = gx.reshape(R, 1, -1).expand(R, oh * sr, ow * sr)
    sample = _bilinear_batch(x, ys, xs, bounds="clamp_sample",
                             index=box_image)
    sample = sample.reshape(R, -1, oh, sr, ow, sr)
    w = (my.to(sample.dtype)[:, None, None, :, None, None]
         * mx.to(sample.dtype)[:, None, None, None, None, :])
    return (torch.sum(sample * w, dim=(3, 5))
            / (sry * srx)[:, None, None, None])


def roi_align(x, boxes, boxes_num, output_size, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True, name=None):
    """RoIAlign: x [N, C, H, W]; boxes [R, 4] (x1, y1, x2, y2);
    boxes_num [N] RoIs an image. Returns [R, C, oh, ow].
    ``sampling_ratio <= 0`` takes the reference's adaptive
    ceil(roi size / output size) samples a bin, per RoI."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    oh, ow = (int(s) for s in output_size)
    box_image = _box_image(boxes_num, _arr(x).device)
    sr_max = int(sampling_ratio)
    if sampling_ratio <= 0:
        b = _np(boxes, np.float64)
        floor = 1e-6 if aligned else 1.0
        rw = np.maximum((b[:, 2] - b[:, 0]) * spatial_scale, floor)
        rh = np.maximum((b[:, 3] - b[:, 1]) * spatial_scale, floor)
        sr_max = int(max(1, np.max(np.ceil(np.concatenate(
            [rh / oh, rw / ow]))))) if len(b) else 1
    return apply_op(_roi_align, x, boxes, box_image, output_size=(oh, ow),
                    spatial_scale=float(spatial_scale),
                    sampling_ratio=int(sampling_ratio), aligned=bool(aligned),
                    sr_max=sr_max)


def _roi_bins(boxes, spatial_scale, H, W, oh, ow):
    """roi_pool's integer RoI corners and each pixel row's and column's
    bin: (ymask [R, oh, H], xmask [R, ow, W])."""
    dev = boxes.device
    x1, y1, x2, y2 = torch.round(boxes * spatial_scale).unbind(-1)
    rw = torch.clamp(x2 - x1 + 1, min=1.0)
    rh = torch.clamp(y2 - y1 + 1, min=1.0)
    ys = torch.arange(H, dtype=_F32, device=dev)[None, :]
    xs = torch.arange(W, dtype=_F32, device=dev)[None, :]
    ybin = torch.clamp(torch.floor((ys - y1[:, None]) / (rh / oh)[:, None]),
                       -1, oh).long()
    xbin = torch.clamp(torch.floor((xs - x1[:, None]) / (rw / ow)[:, None]),
                       -1, ow).long()
    in_y = (ys >= y1[:, None]) & (ys <= y2[:, None])
    in_x = (xs >= x1[:, None]) & (xs <= x2[:, None])
    ymask = (ybin[:, None, :] == torch.arange(oh, device=dev)[None, :, None]
             ) & in_y[:, None, :]
    xmask = (xbin[:, None, :] == torch.arange(ow, device=dev)[None, :, None]
             ) & in_x[:, None, :]
    return ymask, xmask


def _roi_pool(x, boxes, box_image, output_size, spatial_scale):
    oh, ow = output_size
    C, H, W = x.shape[1:]
    ymask, xmask = _roi_bins(boxes, spatial_scale, H, W, oh, ow)
    feat = x[box_image]                                   # [R, C, H, W]
    big_neg = torch.tensor(-1e30, dtype=x.dtype, device=x.device)
    # the bin's max is separable: over its columns, then over its rows
    colmax = torch.where(xmask[:, None, None, :, :], feat[:, :, :, None, :],
                         big_neg).amax(-1)                 # [R, C, H, ow]
    out = torch.where(ymask[:, None, :, :, None], colmax[:, :, None, :, :],
                      big_neg).amax(3)                     # [R, C, oh, ow]
    empty = ~(ymask.any(-1)[:, :, None] & xmask.any(-1)[:, None, :])
    return torch.where(empty[:, None], 0.0, out)


def roi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0, name=None):
    """RoIPool: the max of each RoI bin (0 for an empty bin)."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    box_image = _box_image(boxes_num, _arr(x).device)
    return apply_op(_roi_pool, x, boxes, box_image,
                    output_size=tuple(int(s) for s in output_size),
                    spatial_scale=float(spatial_scale))


class RoIAlign(Layer):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self._output_size = output_size
        self._spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return roi_align(x, boxes, boxes_num, self._output_size,
                         self._spatial_scale)


class RoIPool(Layer):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self._output_size = output_size
        self._spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return roi_pool(x, boxes, boxes_num, self._output_size,
                        self._spatial_scale)


# -- box utilities ----------------------------------------------------------

def _box_iou(a, b):
    area1 = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area2 = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area1[:, None] + area2[None, :] - inter + 1e-10)


def box_iou(boxes1, boxes2):
    """Pairwise IoU [R1, R2] of (x1, y1, x2, y2) boxes."""
    return apply_op(lambda a, b: _box_iou(a.to(_F32), b.to(_F32)),
                    boxes1, boxes2)


def _greedy_keep(iou, valid, thr, eta=1.0):
    """The greedy NMS sweep for G groups at once: ``iou`` [G, K, K] among
    each group's candidates in descending score order, ``valid`` [G, K]
    the real candidates. Candidate i, if still alive, is kept and
    suppresses every later candidate whose IoU with it exceeds the
    group's threshold; with ``eta < 1`` that threshold shrinks by eta
    after each kept box while it is above 0.5 (nms_util.h NMSFast). The
    threshold steps in f64 and compares in f32, as the JAX package's
    Python float against a numpy f32 IoU does. Returns keep [G, K]."""
    G, K = valid.shape
    alive = valid.clone()
    if K == 0:
        return alive
    thr64 = torch.full((G,), float(thr), dtype=torch.float64,
                       device=iou.device)
    thr32 = thr64.to(_F32)
    last = int(valid.sum(1).max()) if G else 0
    for i in range(min(last, K - 1)):
        k = alive[:, i]
        alive[:, i + 1:] &= ~((iou[:, i, i + 1:] > thr32[:, None])
                              & k[:, None])
        if eta < 1.0:
            thr64 = torch.where(k & (thr64 > 0.5), thr64 * eta, thr64)
            thr32 = thr64.to(_F32)
    return alive


def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None):
    """Hard NMS on the boxes' device: the kept indices (int64) in
    descending score order (input order without scores). With
    ``category_idxs``, NMS runs per category."""
    b = _arr(boxes).to(_F32)
    n, dev = b.shape[0], b.device
    sc = (_arr(scores).to(_F32) if scores is not None
          else torch.arange(n, 0, -1, dtype=_F32, device=dev))
    iou = _box_iou(b, b)

    def nms_one(idxs):
        order = idxs[torch.sort(-sc[idxs], stable=True).indices]
        sub = iou[order][:, order]
        valid = torch.ones((1, len(order)), dtype=torch.bool, device=dev)
        return order[_greedy_keep(sub[None], valid, iou_threshold)[0]]

    if category_idxs is None:
        keep = nms_one(torch.arange(n, device=dev))
    else:
        cats = _arr(category_idxs).to(dev)
        cat_list = (list(categories) if categories is not None
                    else torch.unique(cats).tolist())
        keep = torch.cat([nms_one(torch.nonzero(cats == c).reshape(-1))
                          for c in cat_list]) if cat_list else \
            torch.zeros(0, dtype=torch.long, device=dev)
        keep = keep[torch.sort(-sc[keep], stable=True).indices]
    if top_k is not None:
        keep = keep[:top_k]
    return Tensor(keep.long())


# -- SSD detection family ---------------------------------------------------

def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),  # noqa: A002
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, min_max_aspect_ratios_order=False,
              name=None):
    """SSD prior boxes (prior_box_op.h:52's emission order, with the
    min_max_aspect_ratios_order switch): (boxes [H, W, P, 4], variances
    [H, W, P, 4]), host geometry from the shapes alone."""
    fh, fw = int(input.shape[2]), int(input.shape[3])
    ih, iw = int(image.shape[2]), int(image.shape[3])
    min_sizes = [float(s) for s in np.atleast_1d(min_sizes)]
    max_sizes = ([float(s) for s in np.atleast_1d(max_sizes)]
                 if max_sizes else [])
    if max_sizes:
        assert len(max_sizes) == len(min_sizes), \
            "max_sizes must pair with min_sizes"
    # ExpandAspectRatios (prior_box_op.h:27): dedup, keep 1.0 first, flip
    ars = [1.0]
    for ar in aspect_ratios:
        ar = float(ar)
        if any(abs(ar - e) < 1e-6 for e in ars):
            continue
        ars.append(ar)
        if flip:
            ars.append(1.0 / ar)
    step_w = float(steps[0]) or iw / fw
    step_h = float(steps[1]) or ih / fh

    rows = []
    for h in range(fh):
        row = []
        for w in range(fw):
            cell = []
            cx = (w + offset) * step_w
            cy = (h + offset) * step_h

            def emit(bw, bh):
                cell.append(((cx - bw) / iw, (cy - bh) / ih,
                             (cx + bw) / iw, (cy + bh) / ih))

            for s, ms in enumerate(min_sizes):
                if min_max_aspect_ratios_order:
                    emit(ms / 2.0, ms / 2.0)
                    if max_sizes:
                        r = math.sqrt(ms * max_sizes[s]) / 2.0
                        emit(r, r)
                    for ar in ars:
                        if abs(ar - 1.0) < 1e-6:
                            continue
                        emit(ms * math.sqrt(ar) / 2.0,
                             ms / math.sqrt(ar) / 2.0)
                else:
                    for ar in ars:
                        emit(ms * math.sqrt(ar) / 2.0,
                             ms / math.sqrt(ar) / 2.0)
                    if max_sizes:
                        r = math.sqrt(ms * max_sizes[s]) / 2.0
                        emit(r, r)
            row.append(cell)
        rows.append(row)
    out = np.asarray(rows, np.float32)                 # [H,W,P,4]
    if clip:
        out = np.clip(out, 0.0, 1.0)
    var = np.broadcast_to(np.asarray(variance, np.float32), out.shape)
    return _out(out), _out(var)


def _box_coder(pb, tb, var_arr, var_list, code_type, norm, axis):
    off = 0.0 if norm else 1.0
    pw = pb[:, 2] - pb[:, 0] + off
    ph = pb[:, 3] - pb[:, 1] + off
    pcx = pb[:, 0] + pw / 2
    pcy = pb[:, 1] + ph / 2
    if code_type == "encode_center_size":
        # tb [N, 4] targets against pb [M, 4] priors -> [N, M, 4]
        tw = tb[:, 2] - tb[:, 0] + off
        th = tb[:, 3] - tb[:, 1] + off
        tcx = (tb[:, 0] + tb[:, 2]) / 2
        tcy = (tb[:, 1] + tb[:, 3]) / 2
        out = torch.stack([
            (tcx[:, None] - pcx[None, :]) / pw[None, :],
            (tcy[:, None] - pcy[None, :]) / ph[None, :],
            torch.log(torch.abs(tw[:, None] / pw[None, :])),
            torch.log(torch.abs(th[:, None] / ph[None, :])),
        ], dim=-1)
        if var_arr is not None:
            out = out / var_arr[None, :, :]
        elif var_list is not None:
            out = out / var_list[None, None, :]
        return out
    # tb [N, M, 4] deltas; the priors broadcast along axis (0: per column
    # j, 1: per row i)
    exp = (lambda a: a[None, :]) if axis == 0 else (lambda a: a[:, None])
    if var_arr is not None:
        v = var_arr[None, :, :] if axis == 0 else var_arr[:, None, :]
    elif var_list is not None:
        v = var_list[None, None, :]
    else:
        v = torch.ones((1, 1, 4), dtype=_F32, device=pb.device)
    cx = v[..., 0] * tb[..., 0] * exp(pw) + exp(pcx)
    cy = v[..., 1] * tb[..., 1] * exp(ph) + exp(pcy)
    w = torch.exp(v[..., 2] * tb[..., 2]) * exp(pw)
    h = torch.exp(v[..., 3] * tb[..., 3]) * exp(ph)
    return torch.stack([cx - w / 2, cy - h / 2,
                        cx + w / 2 - off, cy + h / 2 - off], dim=-1)


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True, axis=0,
              name=None):
    """Encode or decode boxes against priors (box_coder_op.h:41
    EncodeCenterSize, :118 DecodeCenterSize; the +1 convention for
    unnormalized boxes)."""
    if code_type not in ("encode_center_size", "decode_center_size"):
        raise ValueError(f"unknown code_type {code_type!r}")
    pb = _arr(prior_box).to(_F32)
    var_list = None
    var = ()
    if prior_box_var is not None:
        if isinstance(prior_box_var, (list, tuple)):
            var_list = torch.tensor(prior_box_var, dtype=_F32,
                                    device=pb.device)
        else:
            var = (prior_box_var,)

    def impl(pb_, tb_, *v):
        return _box_coder(pb_.to(_F32), tb_.to(_F32),
                          v[0].to(_F32) if v else None, var_list, code_type,
                          bool(box_normalized), axis)

    return apply_op(impl, prior_box, target_box, *var)


def bipartite_match(dist_matrix, match_type=None, dist_threshold=None,
                    name=None):
    """Greedy bipartite matching (bipartite_match_op.cc): rows are
    entities (gt boxes), columns candidates (priors). Returns
    (match_indices [1, M] int32, -1 unmatched; match_dist [1, M]).
    ``match_type='per_prediction'`` also gives each unmatched column its
    best row where that distance exceeds ``dist_threshold``."""
    d = _np(dist_matrix, np.float32)
    assert d.ndim == 2, "bipartite_match expects a 2-D distance matrix"
    match_idx, match_dist = _bipartite(d, match_type, dist_threshold)
    return _out(match_idx[None, :]), _out(match_dist[None, :])


def _bipartite(d, match_type, dist_threshold):
    rows, cols = d.shape
    match_idx = np.full((cols,), -1, np.int32)
    match_dist = np.zeros((cols,), np.float32)
    work = d.copy()
    for _ in range(min(rows, cols)):
        i, j = np.unravel_index(np.argmax(work), work.shape)
        if work[i, j] <= 0:
            break
        match_idx[j] = i
        match_dist[j] = d[i, j]
        work[i, :] = -1.0
        work[:, j] = -1.0
    if match_type == "per_prediction":
        thr = float(dist_threshold if dist_threshold is not None else 0.5)
        best_row = d.argmax(axis=0)
        best = d.max(axis=0)
        extra = (match_idx == -1) & (best > thr)
        match_idx[extra] = best_row[extra]
        match_dist[extra] = best[extra]
    return match_idx, match_dist


# -- multiclass / matrix NMS ------------------------------------------------

def _pair_iou(bb, off):
    """IoU among the boxes of each group: bb [..., K, 4] -> [..., K, K]
    (multiclass_nms's formula, in f32)."""
    x1, y1, x2, y2 = bb.unbind(-1)
    area = (x2 - x1 + off) * (y2 - y1 + off)
    ix1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    iy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    ix2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    iy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    iw = torch.clamp(ix2 - ix1 + off, min=0)
    ih = torch.clamp(iy2 - iy1 + off, min=0)
    inter = iw * ih
    return inter / (area[..., :, None] + area[..., None, :] - inter + 1e-10)


# the IoU blocks of one greedy sweep hold at most this many entries
_NMS_BLOCK = 1 << 28


def _class_candidates(s, score_threshold, top_k, background_label):
    """Each (image, class)'s candidates: the boxes scoring above the
    threshold, in descending score order (ties by index), the first
    ``top_k`` (all with top_k None). Returns (order [N, C, K] box
    indices, scores [N, C, K], valid [N, C, K])."""
    N, C, M = s.shape
    masked = torch.where(s > score_threshold, s, -math.inf)
    if 0 <= background_label < C:
        masked[:, background_label] = -math.inf
    K = M if top_k is None else min(top_k, M)
    order = torch.sort(-masked, dim=-1, stable=True).indices[..., :K]
    cs = torch.gather(masked, -1, order)
    return order, cs, cs > -math.inf


def _gather_boxes(b, order):
    N = b.shape[0]
    return b[torch.arange(N, device=b.device)[:, None, None], order]


def _mc_nms(b, s, score_threshold, nms_top_k, keep_top_k, nms_threshold,
            normalized, nms_eta, background_label):
    """multiclass_nms over b [N, M, 4], s [N, C, M] on their device:
    (rows [K, 6], per-image counts [N], flat indices n·M + i)."""
    N, C, M = s.shape
    dev = s.device
    order, cs, valid = _class_candidates(
        s, score_threshold, nms_top_k if nms_top_k > 0 else None,
        background_label)
    K = order.shape[-1]
    cb = _gather_boxes(b, order).reshape(N * C, K, 4)
    valid = valid.reshape(N * C, K)
    keep = torch.zeros_like(valid)
    step = max(1, _NMS_BLOCK // max(K * K, 1))
    off = 0.0 if normalized else 1.0
    for g in range(0, N * C, step):
        iou = _pair_iou(cb[g:g + step], off)
        keep[g:g + step] = _greedy_keep(iou, valid[g:g + step],
                                        nms_threshold, nms_eta)
        del iou
    keep = keep.reshape(N, C * K)
    cs = cs.reshape(N, C * K)
    order = order.reshape(N, C * K)
    rows, idx, nums = [], [], []
    for n in range(N):
        sel = torch.nonzero(keep[n]).reshape(-1)      # (class, rank) order
        o = torch.sort(-cs[n, sel], stable=True).indices
        if keep_top_k > 0:
            o = o[:keep_top_k]
        sel = sel[o]
        box = order[n, sel]
        rows.append(torch.cat([(sel // K).to(_F32)[:, None],
                               cs[n, sel][:, None], b[n, box]], dim=1))
        idx.append(n * M + box)
        nums.append(len(sel))
    out = torch.cat(rows) if rows else torch.zeros((0, 6), device=dev)
    idx = torch.cat(idx) if idx else torch.zeros(0, dtype=torch.long,
                                                 device=dev)
    return out, torch.tensor(nums, dtype=torch.int32, device=dev), idx


def multiclass_nms(bboxes, scores, score_threshold=0.0, nms_top_k=-1,
                   keep_top_k=-1, nms_threshold=0.3, normalized=True,
                   nms_eta=1.0, background_label=0, return_index=False,
                   rois_num=None, name=None):
    """Multi-class NMS (multiclass_nms_op.cc): bboxes [N, M, 4], scores
    [N, C, M]; or bboxes [M_total, 4], scores [C, M_total] with
    ``rois_num`` [N] the boxes of each image (multiclass_nms3). Returns
    (out [K, 6] rows (label, score, x1, y1, x2, y2), rois_num [N]), and
    the kept flat indices with ``return_index``."""
    b = _arr(bboxes).to(_F32)
    s = _arr(scores).to(_F32).to(b.device)
    args = (score_threshold, nms_top_k, keep_top_k, nms_threshold,
            normalized, nms_eta, background_label)
    if s.ndim == 2:
        if rois_num is None:
            raise ValueError(
                "multiclass_nms with 2-D scores needs rois_num (per-image "
                "box counts, reference multiclass_nms3 RoisNum input)")
        counts = [int(v) for v in _np(rois_num).reshape(-1)]
        bounds = np.cumsum([0] + counts)
        outs = [_mc_nms(b[None, lo:hi], s[None, :, lo:hi], *args)
                for lo, hi in zip(bounds[:-1], bounds[1:])]
        if outs:
            out = torch.cat([o[0] for o in outs])
            nums = torch.cat([o[1] for o in outs])
            idx = torch.cat([o[2] + int(lo) for o, lo in zip(outs, bounds)])
        else:
            out = torch.zeros((0, 6), device=b.device)
            nums = torch.zeros(0, dtype=torch.int32, device=b.device)
            idx = torch.zeros(0, dtype=torch.long, device=b.device)
    else:
        if rois_num is not None:
            raise ValueError("rois_num only applies to the 2-D LoD-style "
                             "inputs; batched [N,C,M] scores already carry "
                             "the image grouping")
        out, nums, idx = _mc_nms(b, s, *args)
    res = (Tensor(out), Tensor(nums))
    return res + (Tensor(idx),) if return_index else res


def _matrix_iou(bb, off):
    """matrix_nms's IoU (no epsilon; 0 without overlap): [..., K, K]."""
    x1, y1, x2, y2 = bb.unbind(-1)
    area = (x2 - x1 + off) * (y2 - y1 + off)
    iw = (torch.minimum(x2[..., :, None], x2[..., None, :])
          - torch.maximum(x1[..., :, None], x1[..., None, :]) + off)
    ih = (torch.minimum(y2[..., :, None], y2[..., None, :])
          - torch.maximum(y1[..., :, None], y1[..., None, :]) + off)
    inter = iw * ih
    iou = inter / (area[..., :, None] + area[..., None, :] - inter)
    return torch.where((iw > 0) & (ih > 0), iou, 0.0)


def matrix_nms(bboxes, scores, score_threshold, post_threshold=0.0,
               nms_top_k=-1, keep_top_k=-1, use_gaussian=False,
               gaussian_sigma=2.0, background_label=0, normalized=True,
               return_index=False, return_rois_num=True, name=None):
    """Matrix NMS (matrix_nms_op.cc NMSMatrix, SOLOv2's decay): each
    candidate's score times the least, over the higher-scored candidates
    j of its class, of decay(iou(i, j), iou_max(j)). bboxes [N, M, 4],
    scores [N, C, M]; returns (out [K, 6], rois_num [N][, index])."""
    b = _arr(bboxes).to(_F32)
    s = _arr(scores).to(_F32).to(b.device)
    N, C, M = s.shape
    dev = b.device
    order, cs, valid = _class_candidates(
        s, score_threshold, nms_top_k if nms_top_k > -1 else None,
        background_label)
    K = order.shape[-1]
    ds = cs
    if K:
        iou = _matrix_iou(_gather_boxes(b, order),
                          0.0 if normalized else 1.0)
        lower = torch.ones((K, K), dtype=torch.bool, device=dev).tril(-1)
        iou = torch.where(lower, iou, 0.0)                # j < i only
        iou_max = iou.amax(-1)                            # [N, C, K]
        if use_gaussian:
            decay = torch.exp((iou_max[..., None, :] ** 2 - iou ** 2)
                              * gaussian_sigma)
        else:
            decay = (1.0 - iou) / (1.0 - iou_max[..., None, :])
        # the first candidate keeps its score; each later one takes the
        # least decay over the candidates above it
        decay = torch.where(lower, decay, math.inf).amin(-1)
        ds = torch.where(torch.arange(K, device=dev) == 0, cs, decay * cs)
    keep = valid & (ds > post_threshold)
    ds, keep, order = (t.reshape(N, C * K) for t in (ds, keep, order))
    rows, idx, nums = [], [], []
    for n in range(N):
        sel = torch.nonzero(keep[n]).reshape(-1)
        o = torch.sort(-ds[n, sel], stable=True).indices
        if keep_top_k > -1:
            o = o[:keep_top_k]
        sel = sel[o]
        box = order[n, sel]
        rows.append(torch.cat([(sel // max(K, 1)).to(_F32)[:, None],
                               ds[n, sel][:, None], b[n, box]], dim=1))
        idx.append(n * M + box)
        nums.append(len(sel))
    res = [Tensor(torch.cat(rows) if rows
                  else torch.zeros((0, 6), device=dev))]
    if return_rois_num:
        res.append(Tensor(torch.tensor(nums, dtype=torch.int32, device=dev)))
    if return_index:
        res.append(Tensor(torch.cat(idx) if idx else
                          torch.zeros(0, dtype=torch.long, device=dev)))
    return tuple(res) if len(res) > 1 else res[0]


# -- psroi_pool -------------------------------------------------------------

def _psroi_pool(x, boxes, box_image, output_size, spatial_scale,
                out_channels):
    oh, ow = output_size
    H, W = x.shape[2:]
    dev = x.device
    x1, y1, x2, y2 = torch.round(boxes * spatial_scale).unbind(-1)
    rw = torch.clamp(x2 - x1, min=0.1)
    rh = torch.clamp(y2 - y1, min=0.1)
    bin_w, bin_h = rw / ow, rh / oh
    ys = torch.arange(H, dtype=_F32, device=dev)[None, :]
    xs = torch.arange(W, dtype=_F32, device=dev)[None, :]
    ybin = torch.floor((ys - y1[:, None]) / bin_h[:, None]).long()
    xbin = torch.floor((xs - x1[:, None]) / bin_w[:, None]).long()
    in_y = (ys >= y1[:, None]) & (ys < y2[:, None])
    in_x = (xs >= x1[:, None]) & (xs < x2[:, None])
    my = ((ybin[:, None, :] == torch.arange(oh, device=dev)[None, :, None])
          & in_y[:, None, :]).to(x.dtype)                   # [R, oh, H]
    mx = ((xbin[:, None, :] == torch.arange(ow, device=dev)[None, :, None])
          & in_x[:, None, :]).to(x.dtype)                   # [R, ow, W]
    # output channel c, bin (i, j) pools input channel c·oh·ow + i·ow + j
    featp = x[box_image].reshape(-1, out_channels, oh, ow, H, W)
    sums = torch.einsum("rcijhw,rih,rjw->rcij", featp, my, mx)
    counts = torch.einsum("rih,rjw->rij", my, mx)
    return sums / torch.clamp(counts, min=1.0)[:, None]


def psroi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0,
               name=None):
    """Position-sensitive RoI pooling (psroi_pool_op.h): x
    [N, out_c·oh·ow, H, W] -> [R, out_c, oh, ow], bin (i, j) averaging
    input channel c·oh·ow + i·ow + j over the bin."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    oh, ow = (int(v) for v in output_size)
    C = int(x.shape[1])
    if C % (oh * ow) != 0:
        raise ValueError(
            f"psroi_pool needs channels ({C}) divisible by "
            f"output_size^2 ({oh * ow})")
    box_image = _box_image(boxes_num, _arr(x).device)
    return apply_op(_psroi_pool, x, boxes, box_image, output_size=(oh, ow),
                    spatial_scale=float(spatial_scale),
                    out_channels=C // (oh * ow))


class PSRoIPool(Layer):
    """Position-sensitive RoI pooling layer."""

    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return psroi_pool(x, boxes, boxes_num, self.output_size,
                          self.spatial_scale)


# -- deformable convolution -------------------------------------------------

def _deform_conv2d(x, offset, mask, weight, bias, stride, padding, dilation,
                   deformable_groups, groups):
    N, Cin, H, W = x.shape
    Cout, Cin_g, kh, kw = weight.shape
    sh, sw = stride
    ph, pw = padding
    dh, dw = dilation
    Ho = (H + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    Wo = (W + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    K, dg, dev = kh * kw, deformable_groups, x.device
    # the sampling grid [K, Ho, Wo] plus the learned (dy, dx) of each
    # kernel point, the offsets in the reference's (dg, K, (y, x)) layout
    oy = torch.arange(Ho, device=dev) * sh - ph
    ox = torch.arange(Wo, device=dev) * sw - pw
    ky, kx = torch.meshgrid(torch.arange(kh, device=dev) * dh,
                            torch.arange(kw, device=dev) * dw, indexing="ij")
    base_y = ky.reshape(K, 1, 1) + oy[None, :, None]
    base_x = kx.reshape(K, 1, 1) + ox[None, None, :]
    off = offset.reshape(N, dg, K, 2, Ho, Wo)
    ys = (base_y + off[:, :, :, 0]).reshape(N * dg, K, Ho, Wo)
    xs = (base_x + off[:, :, :, 1]).reshape(N * dg, K, Ho, Wo)
    cols = _bilinear_batch(x.reshape(N * dg, Cin // dg, H, W), ys, xs,
                           bounds="zero_corner")      # [N·dg, cpg, K, Ho, Wo]
    if mask is not None:
        cols = cols * mask.reshape(N * dg, 1, K, Ho, Wo)
    # the grouped convolution as a product over (Cin_g, K)
    cols = cols.reshape(N, groups, Cin_g, K, Ho, Wo)
    wg = weight.reshape(groups, Cout // groups, Cin_g, K)
    out = torch.einsum("ngckyz,gock->ngoyz", cols, wg).reshape(
        N, Cout, Ho, Wo)
    if bias is not None:
        out = out + bias.reshape(1, Cout, 1, 1)
    return out


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None,
                  name=None):
    """Deformable convolution v1, or v2 with ``mask`` (the reference's
    modulated im2col + GEMM): offset [N, 2·dg·kh·kw, Ho, Wo] with (y, x)
    interleaved per kernel point, mask [N, dg·kh·kw, Ho, Wo]. A sample's
    out-of-range corners add zero."""
    def norm2(v):
        return (v, v) if isinstance(v, int) else tuple(v)

    args = [x, offset, weight] + ([bias] if bias is not None else []) + \
        ([mask] if mask is not None else [])

    def impl(x_, off_, w_, *rest):
        b_ = rest[0] if bias is not None else None
        m_ = rest[-1] if mask is not None else None
        return _deform_conv2d(x_, off_, m_, w_, b_, norm2(stride),
                              norm2(padding), norm2(dilation),
                              int(deformable_groups), int(groups))

    return apply_op(impl, *args)


class DeformConv2D(Layer):
    """Deformable convolution layer over :func:`deform_conv2d`."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, deformable_groups=1, groups=1,
                 weight_attr=None, bias_attr=None):
        super().__init__()
        k = kernel_size if isinstance(kernel_size, (list, tuple)) \
            else (kernel_size, kernel_size)
        self._attrs = (stride, padding, dilation, deformable_groups, groups)
        self.weight = self.create_parameter(
            shape=[out_channels, in_channels // groups, k[0], k[1]],
            attr=weight_attr, default_initializer=I.XavierNormal())
        self.bias = self.create_parameter(
            shape=[out_channels], attr=bias_attr, is_bias=True)

    def forward(self, x, offset, mask=None):
        s, p, d, dg, g = self._attrs
        return deform_conv2d(x, offset, self.weight, bias=self.bias,
                             stride=s, padding=p, dilation=d,
                             deformable_groups=dg, groups=g, mask=mask)


# -- box helpers of the detection batch -------------------------------------

def iou_similarity(x, y, box_normalized=True, name=None):
    """Pairwise IoU [N, M] (iou_similarity_op.h; box_normalized=False
    adds the +1 pixel convention)."""
    off = 0.0 if box_normalized else 1.0

    def impl(a, b):
        a, b = a.to(_F32), b.to(_F32)
        area1 = (a[:, 2] - a[:, 0] + off) * (a[:, 3] - a[:, 1] + off)
        area2 = (b[:, 2] - b[:, 0] + off) * (b[:, 3] - b[:, 1] + off)
        lt = torch.maximum(a[:, None, :2], b[None, :, :2])
        rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
        wh = torch.clamp(rb - lt + off, min=0)
        inter = wh[..., 0] * wh[..., 1]
        return inter / (area1[:, None] + area2[None, :] - inter + 1e-10)

    return apply_op(impl, x, y)


def _box_clip(boxes, h, w, scale):
    """Clip to (round(w / scale) - 1, round(h / scale) - 1); h, w and
    scale broadcast against boxes[..., 0]."""
    x_hi = torch.round(w / scale) - 1.0
    y_hi = torch.round(h / scale) - 1.0
    x1 = _clip(boxes[..., 0], 0, x_hi)
    y1 = _clip(boxes[..., 1], 0, y_hi)
    x2 = _clip(boxes[..., 2], 0, x_hi)
    y2 = _clip(boxes[..., 3], 0, y_hi)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def box_clip(input, im_info, name=None):  # noqa: A002
    """Clip boxes to the image (box_clip_op over bbox_util.h
    ClipTiledBoxes): input [N, 4] (or [B, N, 4] with im_info [B, 3]);
    im_info rows are (height, width, scale)."""
    def impl(bb, ii):
        ii = ii.to(_F32)
        ii = ii[:, None, :] if bb.ndim == 3 else ii.reshape(-1, 3)[0]
        return _box_clip(bb, ii[..., 0], ii[..., 1], ii[..., 2])

    return apply_op(impl, input, im_info)


def anchor_generator(input, anchor_sizes, aspect_ratios=(1.0,),  # noqa: A002
                     variances=(0.1, 0.1, 0.2, 0.2), stride=(16.0, 16.0),
                     offset=0.5, name=None):
    """Faster R-CNN anchors (anchor_generator_op.h:40: aspect ratios
    outer, sizes inner, the pixel-centre convention): (anchors
    [H, W, A, 4], variances [H, W, A, 4]) in pixels."""
    fh, fw = int(input.shape[2]), int(input.shape[3])
    sw, sh = float(stride[0]), float(stride[1])
    cell = []
    for ar in aspect_ratios:
        for size in anchor_sizes:
            base_w = round(math.sqrt(sw * sh / ar))
            base_h = round(base_w * ar)
            cell.append(((size / sw) * base_w, (size / sh) * base_h))
    rows = []
    for h in range(fh):
        row = []
        for w in range(fw):
            x_ctr = w * sw + offset * (sw - 1)
            y_ctr = h * sh + offset * (sh - 1)
            row.append([(x_ctr - 0.5 * (aw - 1), y_ctr - 0.5 * (ah - 1),
                         x_ctr + 0.5 * (aw - 1), y_ctr + 0.5 * (ah - 1))
                        for aw, ah in cell])
        rows.append(row)
    anchors = np.asarray(rows, np.float32)
    var = np.broadcast_to(np.asarray(variances, np.float32), anchors.shape)
    return _out(anchors), _out(var)


# -- RPN / FPN proposal pipeline (host) -------------------------------------

_BBOX_CLIP = math.log(1000.0 / 16.0)


def _decode_deltas(anchor, vr, delta):
    """bbox_util.h BoxCoder with the +1 convention and the w/h delta
    clipped at log(1000/16)."""
    aw = anchor[:, 2] - anchor[:, 0] + 1.0
    ah = anchor[:, 3] - anchor[:, 1] + 1.0
    acx = anchor[:, 0] + 0.5 * aw
    acy = anchor[:, 1] + 0.5 * ah
    dx, dy, dw, dh = delta[:, 0], delta[:, 1], delta[:, 2], delta[:, 3]
    if vr is not None:
        dx, dy = vr[:, 0] * dx, vr[:, 1] * dy
        dw, dh = vr[:, 2] * dw, vr[:, 3] * dh
    cx = dx * aw + acx
    cy = dy * ah + acy
    w = np.exp(np.minimum(dw, _BBOX_CLIP)) * aw
    h = np.exp(np.minimum(dh, _BBOX_CLIP)) * ah
    return np.stack([cx - w / 2, cy - h / 2,
                     cx + w / 2 - 1.0, cy + h / 2 - 1.0], axis=1)


def generate_proposals(scores, bbox_deltas, img_size, anchors, variances=None,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0,
                       return_rois_num=True, name=None):
    """RPN proposals (generate_proposals_op.cc ProposalForOneImage): per
    image the pre_nms_top_n best scores, their deltas decoded against the
    anchors, clipped to the image, boxes under min_size (in the original
    image's scale) or centred outside dropped, NMS, the first
    post_nms_top_n kept. scores [N, A, H, W]; bbox_deltas [N, 4A, H, W];
    img_size [N, 3] (h, w, scale); anchors [H, W, A, 4] or [M, 4].
    Returns (rois [K, 4], roi_probs [K, 1][, rois_num [N]])."""
    s = _np(scores, np.float32)
    d = _np(bbox_deltas, np.float32)
    info = _np(img_size, np.float32)
    anc = _np(anchors, np.float32).reshape(-1, 4)
    var = (_np(variances, np.float32).reshape(-1, 4)
           if variances is not None else None)
    N, A, H, W = s.shape
    all_rois, all_probs, per_img = [], [], []
    for n in range(N):
        # [A,H,W] -> [H,W,A] flat, the anchors' [H,W,A,4] order
        sc = s[n].transpose(1, 2, 0).reshape(-1)
        dl = d[n].reshape(A, 4, H, W).transpose(2, 3, 0, 1).reshape(-1, 4)
        order = np.argsort(-sc, kind="stable")
        if 0 < pre_nms_top_n < len(order):
            order = order[:pre_nms_top_n]
        props = _decode_deltas(anc[order],
                               var[order] if var is not None else None,
                               dl[order])
        im_h, im_w, im_scale = info[n]
        props[:, 0] = np.clip(props[:, 0], 0, im_w - 1)
        props[:, 1] = np.clip(props[:, 1], 0, im_h - 1)
        props[:, 2] = np.clip(props[:, 2], 0, im_w - 1)
        props[:, 3] = np.clip(props[:, 3], 0, im_h - 1)
        # FilterBoxes (bbox_util.h:190)
        ms = max(float(min_size), 1.0)
        ws = props[:, 2] - props[:, 0] + 1
        hs = props[:, 3] - props[:, 1] + 1
        ws_orig = (props[:, 2] - props[:, 0]) / im_scale + 1
        hs_orig = (props[:, 3] - props[:, 1]) / im_scale + 1
        cx = props[:, 0] + ws / 2
        cy = props[:, 1] + hs / 2
        keep = np.where((ws_orig >= ms) & (hs_orig >= ms)
                        & (cx <= im_w) & (cy <= im_h))[0]
        props, psc = props[keep], sc[order][keep]
        # NMS with the eta-adaptive threshold, each round's rejection
        # vectorized
        areas = (props[:, 2] - props[:, 0] + 1) * (props[:, 3] - props[:, 1]
                                                   + 1)
        alive_idx = np.arange(len(props))
        sel = []
        thr = nms_thresh
        while alive_idx.size:
            i = alive_idx[0]
            sel.append(i)
            if 0 < post_nms_top_n <= len(sel):
                break
            rest = alive_idx[1:]
            iw = (np.minimum(props[i, 2], props[rest, 2])
                  - np.maximum(props[i, 0], props[rest, 0]) + 1)
            ih = (np.minimum(props[i, 3], props[rest, 3])
                  - np.maximum(props[i, 1], props[rest, 1]) + 1)
            inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
            iou = inter / (areas[i] + areas[rest] - inter)
            alive_idx = rest[iou <= thr]
            if eta < 1.0 and thr > 0.5:
                thr *= eta
        all_rois.append(props[sel])
        all_probs.append(psc[sel])
        per_img.append(len(sel))
    rois = (np.concatenate(all_rois) if all_rois
            else np.zeros((0, 4), np.float32))
    probs = (np.concatenate(all_probs)[:, None] if all_probs
             else np.zeros((0, 1), np.float32))
    out = (_out(rois), _out(probs))
    if return_rois_num:
        out += (_out(np.asarray(per_img, np.int32)),)
    return out


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, pixel_offset=True, rois_num=None,
                             name=None):
    """Route RoIs to FPN levels (distribute_fpn_proposals_op.h:113:
    floor(log2(sqrt(area) / refer_scale + 1e-6) + refer_level), clipped).
    Returns (the RoIs of each level, low to high; restore_index [R, 1]
    mapping their concatenation back to input order[; each level's
    per-image counts])."""
    r = _np(fpn_rois, np.float32)
    off = 1.0 if pixel_offset else 0.0
    w = r[:, 2] - r[:, 0] + off
    h = r[:, 3] - r[:, 1] + off
    area = np.where((w > 0) & (h > 0), w * h, 0.0)
    lvl = np.floor(np.log2(np.sqrt(area) / refer_scale + 1e-6) + refer_level)
    lvl = np.clip(lvl, min_level, max_level).astype(np.int64)
    multi, order = [], []
    for L in range(min_level, max_level + 1):
        idx = np.where(lvl == L)[0]
        multi.append(_out(r[idx]))
        order.append(idx)
    order = np.concatenate(order) if order else np.zeros((0,), np.int64)
    restore = np.empty_like(order)
    restore[order] = np.arange(len(order))
    out = (multi, _out(restore[:, None].astype(np.int32)))
    if rois_num is not None:
        rn = _np(rois_num).astype(np.int64).reshape(-1)
        img_id = np.repeat(np.arange(len(rn)), rn)
        return out + ([_out(np.bincount(img_id[lvl == L], minlength=len(rn))
                            .astype(np.int32))
                       for L in range(min_level, max_level + 1)],)
    return out


def collect_fpn_proposals(multi_rois, multi_scores, min_level, max_level,
                          post_nms_top_n, rois_num_per_level=None, name=None):
    """Merge the levels' RoIs and keep the post_nms_top_n best by score
    (collect_fpn_proposals_op.h); with per-level counts, regrouped by
    image with each image's count."""
    rois = (np.concatenate([_np(r, np.float32) for r in multi_rois])
            if multi_rois else np.zeros((0, 4), np.float32))
    scores = (np.concatenate([_np(s, np.float32).reshape(-1)
                              for s in multi_scores])
              if multi_scores else np.zeros((0,), np.float32))
    order = np.argsort(-scores, kind="stable")[:post_nms_top_n]
    if rois_num_per_level is None:
        return _out(rois[order])
    per_level = [_np(c).astype(np.int64).reshape(-1)
                 for c in rois_num_per_level]
    n_img = len(per_level[0]) if per_level else 0
    img_id = (np.concatenate([np.repeat(np.arange(len(c)), c)
                              for c in per_level])
              if per_level else np.zeros((0,), np.int64))
    sel_img = img_id[order]
    regroup = np.argsort(sel_img, kind="stable")
    return (_out(rois[order][regroup]),
            _out(np.bincount(sel_img, minlength=n_img).astype(np.int32)))


# -- YOLOv3 loss ------------------------------------------------------------

def _bce_logits_soft(x, t):
    # SigmoidCrossEntropy (yolov3_loss_op.h:35) with soft targets
    return torch.clamp(x, min=0.0) - x * t + torch.log1p(torch.exp(-x.abs()))


def _yolo_loss_impl(x, gt_box, gt_label, gt_score, anchors, anchor_mask,
                    class_num, ignore_thresh, downsample_ratio,
                    use_label_smooth, scale_x_y):
    N, C, H, W = x.shape
    dev = x.device
    mask_num = len(anchor_mask)
    an_num = len(anchors) // 2
    input_size = downsample_ratio * H
    anc = _const(anchors, dev).reshape(an_num, 2)
    amask = _const(anchor_mask, dev, torch.long)
    p = x.reshape(N, mask_num, 5 + class_num, H, W)
    scale, bias = scale_x_y, -0.5 * (scale_x_y - 1.0)
    label_pos, label_neg = 1.0, 0.0
    if use_label_smooth:
        sw = min(1.0 / class_num, 1.0 / 40)
        label_pos, label_neg = 1.0 - sw, sw

    # the ignore mask: each prediction's best IoU against any valid gt
    gx = torch.arange(W, dtype=_F32, device=dev)[None, :]
    gy = torch.arange(H, dtype=_F32, device=dev)[:, None]
    masked_anc = anc[amask]                                    # [m, 2]
    px = (torch.sigmoid(p[:, :, 0]) * scale + bias + gx) / W  # [N,m,H,W]
    py = (torch.sigmoid(p[:, :, 1]) * scale + bias + gy) / H
    pw = torch.exp(p[:, :, 2]) * masked_anc[:, 0][None, :, None, None] \
        / input_size
    ph = torch.exp(p[:, :, 3]) * masked_anc[:, 1][None, :, None, None] \
        / input_size
    gt_valid = (gt_box[:, :, 2] > 0) & (gt_box[:, :, 3] > 0)   # [N,B]

    def iou_cwh(x1, y1, w1, h1, x2, y2, w2, h2):
        li = torch.maximum(x1 - w1 / 2, x2 - w2 / 2)
        ri = torch.minimum(x1 + w1 / 2, x2 + w2 / 2)
        ti = torch.maximum(y1 - h1 / 2, y2 - h2 / 2)
        bi = torch.minimum(y1 + h1 / 2, y2 + h2 / 2)
        inter = torch.clamp(ri - li, min=0) * torch.clamp(bi - ti, min=0)
        return inter / (w1 * h1 + w2 * h2 - inter + 1e-10)

    g = gt_box[:, None, None, None]                            # [N,1,1,1,B,4]
    ious = iou_cwh(px[..., None], py[..., None], pw[..., None],
                   ph[..., None], g[..., 0], g[..., 1], g[..., 2],
                   g[..., 3])                                  # [N,m,H,W,B]
    ious = torch.where(gt_valid[:, None, None, None, :], ious, 0.0)
    best_iou = ious.amax(-1)
    obj = torch.where(best_iou > ignore_thresh, -1.0, 0.0)     # [N,m,H,W]

    # each gt's best anchor (wh IoU at the origin) over all anchors
    aw = anc[:, 0] / input_size
    ah = anc[:, 1] / input_size
    inter = (torch.minimum(gt_box[..., 2][..., None], aw)
             * torch.minimum(gt_box[..., 3][..., None], ah))   # [N,B,an]
    a_iou = inter / (gt_box[..., 2][..., None] * gt_box[..., 3][..., None]
                     + aw * ah - inter + 1e-10)
    best_n = a_iou.argmax(-1)                                  # [N,B]
    hit = best_n[..., None] == amask
    mask_idx = hit.to(torch.int32).argmax(-1)
    in_mask = hit.any(-1) & gt_valid

    gi = torch.clamp((gt_box[..., 0] * W).long(), 0, W - 1)
    gj = torch.clamp((gt_box[..., 1] * H).long(), 0, H - 1)
    ni = torch.arange(N, device=dev)[:, None]
    pred_at = p[ni, mask_idx, :, gj, gi]                       # [N,B,5+cls]
    tx = gt_box[..., 0] * W - gi
    ty = gt_box[..., 1] * H - gj
    tw = torch.log(torch.clamp(gt_box[..., 2], min=1e-9) * input_size
                   / anc[best_n, 0])
    th = torch.log(torch.clamp(gt_box[..., 3], min=1e-9) * input_size
                   / anc[best_n, 1])
    loc_scale = (2.0 - gt_box[..., 2] * gt_box[..., 3]) * gt_score
    loc = (_bce_logits_soft(pred_at[..., 0], tx)
           + _bce_logits_soft(pred_at[..., 1], ty)
           + torch.abs(pred_at[..., 2] - tw)
           + torch.abs(pred_at[..., 3] - th)) * loc_scale
    cls_t = torch.where(torch.arange(class_num, device=dev)[None, None, :]
                        == gt_label[..., None], label_pos, label_neg)
    cls = _bce_logits_soft(pred_at[..., 5:], cls_t).sum(-1) * gt_score
    per_gt = torch.where(in_mask, loc + cls, 0.0)
    loss = per_gt.sum(1)                                       # [N]

    # positive cells take the gt score over the ignore mask; the gts
    # outside this level's mask write to a spare last column
    flat_obj = obj.reshape(N, -1)
    pos_flat = (mask_idx * H + gj) * W + gi                    # [N,B]
    safe_idx = torch.where(in_mask, pos_flat, mask_num * H * W)
    grown = torch.cat([flat_obj, torch.zeros((N, 1), dtype=flat_obj.dtype,
                                             device=dev)], dim=1)
    grown = grown.index_put((ni.expand_as(safe_idx), safe_idx),
                            torch.where(in_mask, gt_score, 0.0).to(
                                grown.dtype))
    obj = grown[:, :-1].reshape(N, mask_num, H, W)
    conf = p[:, :, 4]
    obj_loss = torch.where(
        obj > 1e-5, _bce_logits_soft(conf, 1.0) * obj,
        torch.where(obj > -0.5, _bce_logits_soft(conf, 0.0), 0.0))
    return loss + obj_loss.sum((1, 2, 3))


def yolo_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
              ignore_thresh, downsample_ratio, gt_score=None,
              use_label_smooth=True, name=None, scale_x_y=1.0):
    """YOLOv3 loss (yolov3_loss_op.h): each gt assigned its best anchor,
    soft-target sigmoid CE on x/y, L1 on w/h scaled by (2 - w·h),
    objectness with an ignore zone above ``ignore_thresh``, label
    smoothing. gt_box [N, B, 4] (cx, cy, w, h) in [0, 1], a row with w
    or h at 0 empty. Returns the loss of each image [N]. No host read:
    it runs inside a captured step."""
    if gt_score is None:
        gt_score = Tensor(torch.ones(tuple(gt_label.shape), dtype=_F32,
                                     device=_arr(x).device))
    return apply_op(
        _yolo_loss_impl, x, gt_box, gt_label, gt_score,
        anchors=tuple(int(a) for a in anchors),
        anchor_mask=tuple(int(a) for a in anchor_mask),
        class_num=int(class_num), ignore_thresh=float(ignore_thresh),
        downsample_ratio=int(downsample_ratio),
        use_label_smooth=bool(use_label_smooth),
        scale_x_y=float(scale_x_y))


# -- image IO ---------------------------------------------------------------

def read_file(filename, name=None):
    """A file's bytes as a uint8 tensor."""
    with open(filename, "rb") as f:
        data = f.read()
    return _out(np.frombuffer(data, np.uint8))


def decode_jpeg(x, mode="unchanged", name=None):
    """Decode JPEG bytes to a CHW uint8 tensor, on the host with PIL."""
    import io

    from PIL import Image

    img = Image.open(io.BytesIO(_np(x, np.uint8).tobytes()))
    if mode == "gray":
        img = img.convert("L")
    elif mode == "rgb":
        img = img.convert("RGB")
    arr = np.asarray(img, np.uint8)
    arr = arr[None] if arr.ndim == 2 else arr.transpose(2, 0, 1)
    return _out(arr)


# -- SSD training loss ------------------------------------------------------

def _ssd_loss_impl(loc, conf, loc_t, conf_t, pos_mask, sel_mask,
                   loc_loss_weight, conf_loss_weight, normalizer):
    d = loc - loc_t
    ad = torch.abs(d)
    sl1 = torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5).sum(-1)
    loc_l = sl1 * pos_mask * loc_loss_weight
    ce = (torch.logsumexp(conf, dim=-1)
          - torch.gather(conf, -1, conf_t[..., None])[..., 0])
    conf_l = ce * sel_mask * conf_loss_weight
    return ((loc_l + conf_l) / normalizer).reshape(-1, 1)


def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, background_label=0, overlap_threshold=0.5,
             neg_pos_ratio=3.0, neg_overlap=0.5, loc_loss_weight=1.0,
             conf_loss_weight=1.0, match_type="per_prediction",
             mining_type="max_negative", normalize=True, sample_size=None):
    """SSD multibox loss: matching, targets encoded against the priors
    and max-negative hard mining on the host (as the JAX package does
    them), then smooth-L1 + softmax CE on the device, normalized by the
    matched count. gt_box [N, B, 4] (rows with w <= 0 empty), gt_label
    [N, B(, 1)], location [N, M, 4], confidence [N, M, C], prior_box
    [M, 4]. Returns each prior's loss [N·M, 1], differentiable in
    location and confidence."""
    if mining_type != "max_negative":
        raise NotImplementedError("ssd_loss: only max_negative mining")
    conf_a = _np(confidence, np.float32)
    gtb = _np(gt_box, np.float32)
    gtl = _np(gt_label).reshape(gtb.shape[0], -1)
    pb = _np(prior_box, np.float32)
    pbv = (_np(prior_box_var, np.float32) if prior_box_var is not None
           else np.tile(np.asarray([0.1, 0.1, 0.2, 0.2], np.float32),
                        (len(pb), 1)))
    N, M = conf_a.shape[:2]
    loc_t = np.zeros((N, M, 4), np.float32)
    conf_t = np.zeros((N, M), np.int64)
    pos_mask = np.zeros((N, M), np.float32)
    sel_mask = np.zeros((N, M), np.float32)
    n_matched = 0
    for n in range(N):
        valid = (gtb[n, :, 2] - gtb[n, :, 0]) > 0
        g = gtb[n][valid]
        gl = gtl[n][valid]
        if len(g) == 0:
            continue
        iou = _np_iou(g, pb)
        match, _dist = _bipartite(iou.astype(np.float32), match_type,
                                  overlap_threshold)
        pos = match >= 0
        n_pos = int(pos.sum())
        n_matched += n_pos
        if n_pos:
            loc_t[n][pos] = _encode_pairs(pb[pos], g[match[pos]], pbv[pos])
            conf_t[n][pos] = gl[match[pos]]
        # hard negatives by the background class's CE
        best_iou = iou.max(axis=0)
        neg_cand = (~pos) & (best_iou < neg_overlap)
        z = conf_a[n] - conf_a[n].max(-1, keepdims=True)
        ce_bg = np.log(np.exp(z).sum(-1)) - z[:, background_label]
        n_neg = int(min(neg_pos_ratio * max(n_pos, 1), neg_cand.sum()))
        if sample_size is not None:
            n_neg = min(n_neg, int(sample_size))
        if n_neg > 0:
            cand_idx = np.where(neg_cand)[0]
            hard = cand_idx[np.argsort(-ce_bg[cand_idx])[:n_neg]]
            sel_mask[n][hard] = 1.0
            conf_t[n][hard] = background_label
        sel_mask[n][pos] = 1.0
        pos_mask[n][pos] = 1.0
    normalizer = float(n_matched) if (normalize and n_matched) else 1.0
    dev = _arr(location).device
    as_dev = (lambda a: torch.as_tensor(a, device=dev))
    return apply_op(_ssd_loss_impl, location, confidence, as_dev(loc_t),
                    as_dev(conf_t), as_dev(pos_mask), as_dev(sel_mask),
                    loc_loss_weight=float(loc_loss_weight),
                    conf_loss_weight=float(conf_loss_weight),
                    normalizer=normalizer)


def target_assign(input, matched_indices, negative_indices=None,  # noqa: A002
                  mismatch_value=0, name=None):
    """Per-column targets by match index (target_assign_op.h): out[j] =
    input[matched[j]] where matched[j] >= 0, else mismatch_value; weight
    1 for the matched (and the listed negatives), else 0."""
    rows = _np(input)
    match = _np(matched_indices).reshape(-1)
    M = len(match)
    feat = rows.shape[-1] if rows.ndim > 1 else 1
    out = np.full((M, feat), mismatch_value, rows.dtype)
    w = np.zeros((M, 1), np.float32)
    pos = match >= 0
    out[pos] = rows.reshape(-1, feat)[match[pos]]
    w[pos] = 1.0
    if negative_indices is not None:
        w[_np(negative_indices).reshape(-1).astype(np.int64)] = 1.0
    return _out(out), _out(w)


def density_prior_box(input, image, densities, fixed_sizes, fixed_ratios,  # noqa: A002
                      variance=(0.1, 0.1, 0.2, 0.2), clip=False,
                      steps=(0.0, 0.0), offset=0.5, flatten_to_2d=False,
                      name=None):
    """Density prior boxes (density_prior_box_op.h): for each cell and
    each (density, fixed size, fixed ratio), a density x density shifted
    grid of boxes of size fixed_size·sqrt(ratio)."""
    H, W = int(input.shape[2]), int(input.shape[3])
    img_h, img_w = int(image.shape[2]), int(image.shape[3])
    step_h = steps[1] if steps[1] else img_h / H
    step_w = steps[0] if steps[0] else img_w / W
    step_average = int((step_w + step_h) * 0.5)
    boxes = []
    for y in range(H):
        for x in range(W):
            cx = (x + offset) * step_w
            cy = (y + offset) * step_h
            cell = []
            for dens, fs in zip(densities, fixed_sizes):
                for ratio in fixed_ratios:
                    bw = fs * math.sqrt(ratio)
                    bh = fs / math.sqrt(ratio)
                    shift = int(step_average / dens)
                    for dy in range(dens):
                        for dx in range(dens):
                            ccx = (cx - step_average / 2.0 + shift / 2.0
                                   + dx * shift)
                            ccy = (cy - step_average / 2.0 + shift / 2.0
                                   + dy * shift)
                            cell.append([(ccx - bw / 2.0) / img_w,
                                         (ccy - bh / 2.0) / img_h,
                                         (ccx + bw / 2.0) / img_w,
                                         (ccy + bh / 2.0) / img_h])
            boxes.append(cell)
    out = np.asarray(boxes, np.float32).reshape(H, W, -1, 4)
    if clip:
        out = np.clip(out, 0.0, 1.0)
    var = np.tile(np.asarray(variance, np.float32)[None, None, None, :],
                  (H, W, out.shape[2], 1))
    if flatten_to_2d:
        out, var = out.reshape(-1, 4), var.reshape(-1, 4)
    return _out(out), _out(var)


# -- RPN / RCNN target assignment (host, seeded samplers) -------------------

_DET_RNG_STATE = {"key": None, "rng": None}


def _rank():
    """The process rank: torch.distributed's once it is initialized,
    else PADDLE_TRAINER_ID (0 unset), as the JAX package's get_rank."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank()
    return int(os.environ.get("PADDLE_TRAINER_ID", 0))


def _det_rng():
    """The samplers' numpy generator: ``SeedSequence(spawn_key=(rank,),
    entropy=seed)`` from the last ``paddle.seed`` (renewed by every seed
    call, even with the same value) and the process rank, as in the JAX
    package, so both draw the same subsets."""
    rank = _rank()
    seed, epoch = grandom.seed_key()
    key = (seed, epoch, rank)
    if _DET_RNG_STATE["key"] != key:
        _DET_RNG_STATE["key"] = key
        _DET_RNG_STATE["rng"] = np.random.default_rng(
            np.random.SeedSequence(spawn_key=(rank,), entropy=seed))
    return _DET_RNG_STATE["rng"]


def _np_iou_off(a, b, off):
    """Pairwise IoU with the unnormalized +off pixel convention."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt + off, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    ar_a = (a[:, 2] - a[:, 0] + off) * (a[:, 3] - a[:, 1] + off)
    ar_b = (b[:, 2] - b[:, 0] + off) * (b[:, 3] - b[:, 1] + off)
    return inter / np.maximum(ar_a[:, None] + ar_b[None, :] - inter, 1e-10)


def _np_iou(a, b):
    """Pairwise IoU of [n, 4] x [m, 4] corner boxes."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    ar_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    ar_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(ar_a[:, None] + ar_b[None, :] - inter, 1e-10)


def _encode_pairs(priors, gts, var):
    """EncodeCenterSize of each (prior, gt) pair, divided by var."""
    pw = priors[:, 2] - priors[:, 0]
    ph = priors[:, 3] - priors[:, 1]
    pcx = (priors[:, 0] + priors[:, 2]) / 2
    pcy = (priors[:, 1] + priors[:, 3]) / 2
    gw = gts[:, 2] - gts[:, 0]
    gh = gts[:, 3] - gts[:, 1]
    gcx = (gts[:, 0] + gts[:, 2]) / 2
    gcy = (gts[:, 1] + gts[:, 3]) / 2
    return np.stack(
        [(gcx - pcx) / pw / var[:, 0], (gcy - pcy) / ph / var[:, 1],
         np.log(np.maximum(gw / pw, 1e-10)) / var[:, 2],
         np.log(np.maximum(gh / ph, 1e-10)) / var[:, 3]], axis=1)


def _valid_gts(gtb, crowd, n):
    return ((gtb[n, :, 2] - gtb[n, :, 0]) > 0) & (crowd[n] == 0)


def _crowd(is_crowd, gtb):
    return (_np(is_crowd).reshape(gtb.shape[0], -1) if is_crowd is not None
            else np.zeros(gtb.shape[:2], np.int64))


def _cat(xs, shape):
    return np.concatenate(xs) if xs else np.zeros(shape, np.float32)


def rpn_target_assign(bbox_pred, cls_logits, anchor_box, anchor_var,
                      gt_boxes, is_crowd, im_info,
                      rpn_batch_size_per_im=256, rpn_straddle_thresh=0.0,
                      rpn_fg_fraction=0.5, rpn_positive_overlap=0.7,
                      rpn_negative_overlap=0.3, use_random=True):
    """RPN anchor sampling (rpn_target_assign_op.cc): the straddle
    filter, each gt's best anchor forced positive, the IoU thresholds,
    rpn_batch_size_per_im anchors sampled at rpn_fg_fraction. gt rows
    with w <= 0 are empty. Returns (score_pred, loc_pred, score_target,
    loc_target, bbox_inside_weight) over the sampled anchors, the batch
    concatenated."""
    bp = _np(bbox_pred, np.float32)
    cl = _np(cls_logits, np.float32)
    anchors = _np(anchor_box, np.float32).reshape(-1, 4)
    avar = _np(anchor_var, np.float32).reshape(-1, 4)
    gtb = _np(gt_boxes, np.float32)
    crowd = _crowd(is_crowd, gtb)
    info = _np(im_info, np.float32)
    rng = _det_rng()
    sp, lp, st, lt, iw = [], [], [], [], []
    for n in range(bp.shape[0]):
        im_h, im_w = float(info[n, 0]), float(info[n, 1])
        if rpn_straddle_thresh >= 0:
            inside = ((anchors[:, 0] >= -rpn_straddle_thresh)
                      & (anchors[:, 1] >= -rpn_straddle_thresh)
                      & (anchors[:, 2] < im_w + rpn_straddle_thresh)
                      & (anchors[:, 3] < im_h + rpn_straddle_thresh))
        else:
            inside = np.ones(len(anchors), bool)
        idx_in = np.where(inside)[0]
        g = gtb[n][_valid_gts(gtb, crowd, n)]
        if len(idx_in) == 0:
            continue
        if len(g):
            iou = _np_iou(anchors[idx_in], g)          # [A, G]
            max_iou = iou.max(axis=1)
            argmax_g = iou.argmax(axis=1)
            labels = -np.ones(len(idx_in), np.int64)
            labels[max_iou < rpn_negative_overlap] = 0
            labels[iou.argmax(axis=0)] = 1
            labels[max_iou >= rpn_positive_overlap] = 1
        else:
            # an image without gts still gives sampled negatives
            labels = np.zeros(len(idx_in), np.int64)
            argmax_g = np.zeros(len(idx_in), np.int64)
        fg_idx = np.where(labels == 1)[0]
        bg_idx = np.where(labels == 0)[0]
        n_fg = int(min(len(fg_idx), rpn_fg_fraction * rpn_batch_size_per_im))
        if len(fg_idx) > n_fg:
            fg_idx = (rng.permutation(fg_idx)[:n_fg] if use_random
                      else fg_idx[:n_fg])
        n_bg = int(min(len(bg_idx), rpn_batch_size_per_im - n_fg))
        if len(bg_idx) > n_bg:
            bg_idx = (rng.permutation(bg_idx)[:n_bg] if use_random
                      else bg_idx[:n_bg])
        sel = np.concatenate([fg_idx, bg_idx])
        gidx = idx_in[sel]
        sp.append(cl[n].reshape(-1)[gidx])
        lp.append(bp[n].reshape(-1, 4)[gidx])
        st.append(np.concatenate([np.ones(len(fg_idx), np.int32),
                                  np.zeros(len(bg_idx), np.int32)]))
        tgt = np.zeros((len(sel), 4), np.float32)
        if len(fg_idx):
            fa = idx_in[fg_idx]
            tgt[: len(fg_idx)] = _encode_pairs(
                anchors[fa], g[argmax_g[fg_idx]], avar[fa])
        lt.append(tgt)
        w = np.zeros((len(sel), 4), np.float32)
        w[: len(fg_idx)] = 1.0
        iw.append(w)
    return (_out(_cat(sp, (0,))[:, None]), _out(_cat(lp, (0, 4))),
            _out(_cat(st, (0,)).astype(np.int32)[:, None]),
            _out(_cat(lt, (0, 4))), _out(_cat(iw, (0, 4))))


def generate_proposal_labels(rpn_rois, gt_classes, is_crowd, gt_boxes,
                             im_info, batch_size_per_im=256,
                             fg_fraction=0.25, fg_thresh=0.25,
                             bg_thresh_hi=0.5, bg_thresh_lo=0.0,
                             bbox_reg_weights=(0.1, 0.1, 0.2, 0.2),
                             class_nums=None, use_random=True,
                             is_cls_agnostic=False, is_cascade_rcnn=False,
                             *, rois_num=None):
    """RCNN proposal sampling (generate_proposal_labels_op.cc
    SampleRoisForOneImage): the gts appended to the RoIs, fg
    (IoU >= fg_thresh) and bg (bg_thresh_lo <= IoU < bg_thresh_hi)
    sampled at fg_fraction, per-class box targets. ``rois_num`` groups
    the RoIs by image. Returns (rois, labels_int32, bbox_targets,
    bbox_inside_weights, bbox_outside_weights[, rois_num])."""
    rois = _np(rpn_rois, np.float32)
    rn = (_np(rois_num).reshape(-1).astype(np.int64)
          if rois_num is not None else np.asarray([len(rois)], np.int64))
    gtb = _np(gt_boxes, np.float32)
    gtc = _np(gt_classes).reshape(gtb.shape[0], -1)
    crowd = _crowd(is_crowd, gtb)
    C = int(class_nums) if class_nums else int(gtc.max()) + 1
    ncls = 1 if is_cls_agnostic else C
    wts = np.asarray(bbox_reg_weights, np.float32)
    rng = _det_rng()
    info = _np(im_info, np.float32)
    out_rois, out_lab, out_tgt, out_in, out_num = [], [], [], [], []
    off = 0
    for n in range(len(rn)):
        r = rois[off: off + int(rn[n])]
        off += int(rn[n])
        # the RoIs back in the original image's frame, as the gts are
        scale = float(info[n, 2]) if info.shape[1] > 2 else 1.0
        if scale != 1.0:
            r = r / scale
        valid = _valid_gts(gtb, crowd, n)
        g = gtb[n][valid]
        gcls = gtc[n][valid]
        cand = np.concatenate([r, g]) if len(g) and not is_cascade_rcnn \
            else r
        if len(cand) == 0 or len(g) == 0:
            out_num.append(0)
            continue
        iou = _np_iou(cand, g)
        max_iou = iou.max(axis=1)
        gt_of = iou.argmax(axis=1)
        fg = np.where(max_iou >= fg_thresh)[0]
        bg = np.where((max_iou < bg_thresh_hi) & (max_iou >= bg_thresh_lo))[0]
        n_fg = int(min(len(fg), fg_fraction * batch_size_per_im))
        if len(fg) > n_fg:
            fg = rng.permutation(fg)[:n_fg] if use_random else fg[:n_fg]
        n_bg = int(min(len(bg), batch_size_per_im - n_fg))
        if len(bg) > n_bg:
            bg = rng.permutation(bg)[:n_bg] if use_random else bg[:n_bg]
        sel = np.concatenate([fg, bg]).astype(np.int64)
        labels = np.concatenate([gcls[gt_of[fg]],
                                 np.zeros(len(bg), np.int64)])
        enc = np.zeros((len(sel), 4), np.float32)
        if len(fg):
            # BoxToDelta divides each delta by its weight
            enc[: len(fg)] = _encode_pairs(
                cand[fg], g[gt_of[fg]], np.tile(wts, (len(fg), 1)))
        tgt = np.zeros((len(sel), 4 * ncls), np.float32)
        inw = np.zeros_like(tgt)
        for i in range(len(fg)):
            c = 0 if is_cls_agnostic else int(labels[i])
            tgt[i, 4 * c: 4 * c + 4] = enc[i]
            inw[i, 4 * c: 4 * c + 4] = 1.0
        out_rois.append(cand[sel])
        out_lab.append(labels)
        out_tgt.append(tgt)
        out_in.append(inw)
        out_num.append(len(sel))
    inw_all = _cat(out_in, (0, 4 * ncls))
    outs = (_out(_cat(out_rois, (0, 4))),
            _out(_cat(out_lab, (0,)).astype(np.int32)[:, None]),
            _out(_cat(out_tgt, (0, 4 * ncls))), _out(inw_all),
            _out(inw_all.copy()))
    if rois_num is None:
        return outs
    return outs + (_out(np.asarray(out_num, np.int32)),)


def retinanet_target_assign(bbox_pred, cls_logits, anchor_box, anchor_var,
                            gt_boxes, gt_labels, is_crowd, im_info,
                            num_classes=1, positive_overlap=0.5,
                            negative_overlap=0.4):
    """RetinaNet anchor assignment: rpn_target_assign's labelling
    without subsampling (the focal loss takes every anchor), the gt
    class as the score target (-1 an ignore band), and the foreground
    count. Returns (score_pred [K, num_classes], loc_pred, score_target
    [K, 1], loc_target, bbox_inside_weight, fg_num [1, 1])."""
    bp = _np(bbox_pred, np.float32)
    cl = _np(cls_logits, np.float32)
    anchors = _np(anchor_box, np.float32).reshape(-1, 4)
    avar = _np(anchor_var, np.float32).reshape(-1, 4)
    gtb = _np(gt_boxes, np.float32)
    gtl = _np(gt_labels).reshape(gtb.shape[0], -1)
    crowd = _crowd(is_crowd, gtb)
    sp, lp, st, lt, iw = [], [], [], [], []
    fg_total = 0
    for n in range(bp.shape[0]):
        valid = _valid_gts(gtb, crowd, n)
        g, gl = gtb[n][valid], gtl[n][valid]
        if len(g):
            iou = _np_iou(anchors, g)
            max_iou = iou.max(axis=1)
            argmax_g = iou.argmax(axis=1)
            labels = -np.ones(len(anchors), np.int64)
            labels[max_iou < negative_overlap] = 0
            labels[iou.argmax(axis=0)] = 1
            labels[max_iou >= positive_overlap] = 1
        else:
            labels = np.zeros(len(anchors), np.int64)
            argmax_g = np.zeros(len(anchors), np.int64)
        fg = labels == 1
        fg_total += int(fg.sum())
        sel = np.where(labels >= 0)[0]
        sp.append(cl[n].reshape(len(anchors), -1)[sel])
        lp.append(bp[n].reshape(-1, 4)[sel])
        tgt_lab = np.zeros(len(sel), np.int32)
        fg_sel = fg[sel]
        tgt_lab[fg_sel] = gl[argmax_g[sel][fg_sel]].astype(np.int32)
        st.append(tgt_lab)
        enc = np.zeros((len(sel), 4), np.float32)
        if fg_sel.any():
            fa = sel[fg_sel]
            enc[fg_sel] = _encode_pairs(anchors[fa], g[argmax_g[fa]],
                                        avar[fa])
        lt.append(enc)
        w = np.zeros((len(sel), 4), np.float32)
        w[fg_sel] = 1.0
        iw.append(w)
    return (_out(_cat(sp, (0, max(num_classes, 1)))), _out(_cat(lp, (0, 4))),
            _out(_cat(st, (0,)).astype(np.int32)[:, None]),
            _out(_cat(lt, (0, 4))), _out(_cat(iw, (0, 4))),
            _out(np.asarray([[max(fg_total, 1)]], np.int32)))


def _nms_fast_off(dets, nms_threshold, eta):
    """Greedy NMS over [K, 5] rows (box, score) with the +1 pixel IoU and
    the adaptive eta threshold (retinanet_detection_output_op.cc
    NMSFast): the kept rows in selection order."""
    order = np.argsort(-dets[:, 4], kind="stable")
    iou = _np_iou_off(dets[:, :4], dets[:, :4], 1.0)
    kept: list = []
    adaptive = nms_threshold
    for i in order:
        i = int(i)
        if kept and (iou[i, kept] > adaptive).any():
            continue
        kept.append(i)
        if eta < 1 and adaptive > 0.5:
            adaptive *= eta
    return kept


def retinanet_detection_output(bboxes, scores, anchors, im_info,
                               score_threshold=0.05, nms_top_k=1000,
                               keep_top_k=100, nms_threshold=0.3,
                               nms_eta=1.0):
    """RetinaNet inference (retinanet_detection_output_op.cc): per FPN
    level the nms_top_k best (anchor, class) scores above the threshold
    (0 for the highest level) decoded with the +1 convention, class-wise
    NMS across the levels, keep_top_k an image; labels are class + 1.
    Lists are per level."""
    info = _np(im_info, np.float32)
    L = len(list(scores))
    all_det = []
    for n in range(info.shape[0]):
        preds = {}                      # class -> [x1, y1, x2, y2, score]
        for lvl, (bb, sc, an) in enumerate(zip(bboxes, scores, anchors)):
            b = _np(bb, np.float32)[n]
            s = _np(sc, np.float32)[n]
            a = _np(an, np.float32).reshape(-1, 4)
            C = s.shape[1]
            thresh = score_threshold if lvl < L - 1 else 0.0
            flat = s.reshape(-1)
            ok = np.where(flat > thresh)[0]
            order = ok[np.argsort(-flat[ok], kind="stable")]
            if nms_top_k > -1:
                order = order[:nms_top_k]
            if len(order) == 0:
                continue
            aidx, cidx = order // C, order % C
            aw = a[aidx, 2] - a[aidx, 0] + 1
            ah = a[aidx, 3] - a[aidx, 1] + 1
            acx = a[aidx, 0] + aw / 2
            acy = a[aidx, 1] + ah / 2
            d = b[aidx]
            cx = d[:, 0] * aw + acx
            cy = d[:, 1] * ah + acy
            w = np.exp(d[:, 2]) * aw
            h = np.exp(d[:, 3]) * ah
            scale = float(info[n, 2]) if info.shape[1] > 2 else 1.0
            im_h = np.round(info[n, 0] / scale)
            im_w = np.round(info[n, 1] / scale)
            x1 = np.clip((cx - w / 2) / scale, 0, im_w - 1)
            y1 = np.clip((cy - h / 2) / scale, 0, im_h - 1)
            x2 = np.clip((cx + w / 2 - 1) / scale, 0, im_w - 1)
            y2 = np.clip((cy + h / 2 - 1) / scale, 0, im_h - 1)
            rows = np.stack([x1, y1, x2, y2, flat[order]], axis=1)
            for c in np.unique(cidx):
                preds.setdefault(int(c), []).append(rows[cidx == c])
        dets = []                       # (score, label, box)
        for c, chunks in preds.items():
            cls = np.concatenate(chunks)
            for i in _nms_fast_off(cls, nms_threshold, nms_eta):
                dets.append((cls[i, 4], c, cls[i, :4]))
        dets.sort(key=lambda t: -t[0])
        if keep_top_k > 0:
            dets = dets[:keep_top_k]
        out = np.asarray([[c + 1, sc_, *box] for sc_, c, box in dets],
                         np.float32)
        all_det.append(out.reshape(-1, 6))
    out = np.concatenate(all_det) if all_det else np.zeros((0, 6), np.float32)
    return _out(out), _out(np.asarray([len(d) for d in all_det], np.int32))


def polygon_box_transform(input, name=None):  # noqa: A002
    """polygon_box_transform_op.cc: offsets to absolute quad coordinates
    on the 4x-downsampled grid: even channels 4·j - in, odd 4·i - in."""
    def impl(x):
        n, c, h, w = x.shape
        jj = torch.arange(w, device=x.device).to(x.dtype)[None, None, None]
        ii = torch.arange(h, device=x.device).to(x.dtype)[None, None, :,
                                                          None]
        even = (torch.arange(c, device=x.device) % 2 == 0)[None, :, None,
                                                           None]
        return torch.where(even, 4.0 * jj - x, 4.0 * ii - x)

    return apply_op(impl, input)


def locality_aware_nms(bboxes, scores, score_threshold, nms_top_k,
                       keep_top_k, nms_threshold=0.3, normalized=True,
                       nms_eta=1.0, background_label=-1, name=None):
    """EAST's NMS (locality_aware_nms_op.cc): a sequential pass merges
    consecutive boxes whose IoU with the running box exceeds
    nms_threshold (score-weighted, scores adding), then class-wise NMS
    (:func:`multiclass_nms`) on the merged set. Rectangles only."""
    bx = _np(bboxes, np.float32)
    sc = _np(scores, np.float32)
    if bx.shape[-1] != 4:
        raise NotImplementedError(
            "locality_aware_nms: quad boxes (PolyIoU) not supported; "
            "rectangles only")
    off = 0.0 if normalized else 1.0
    outs, nums = [], []
    for n in range(bx.shape[0]):
        b, s = bx[n], sc[n]                    # s [C, M]
        dets = []
        for c in range(s.shape[0]):
            if c == background_label:
                continue
            box_c, s_c = b.copy(), s[c].copy()
            skip = np.ones(len(box_c), bool)
            idx = -1
            for i in range(len(box_c)):
                if idx > -1:
                    ov = _np_iou_off(box_c[i][None], box_c[idx][None],
                                     off)[0, 0]
                    if ov > nms_threshold:
                        tot = s_c[i] + s_c[idx]
                        box_c[idx] = (box_c[i] * s_c[i]
                                      + box_c[idx] * s_c[idx]) / tot
                        s_c[idx] = tot
                    else:
                        skip[idx] = False
                        idx = i
                else:
                    idx = i
            if idx > -1:
                skip[idx] = False
            keep = (~skip) & (s_c > score_threshold)
            if not keep.any():
                continue
            det_c, _ = multiclass_nms(
                box_c[keep][None], s_c[keep][None, None, :],
                score_threshold=0.0, nms_top_k=nms_top_k, keep_top_k=-1,
                nms_threshold=nms_threshold, normalized=normalized,
                nms_eta=nms_eta, background_label=-1)
            for row in _np(det_c).reshape(-1, 6):
                dets.append([float(c), *row[1:]])
        dets.sort(key=lambda r: -r[1])
        if keep_top_k > 0:
            dets = dets[:keep_top_k]
        outs.append(np.asarray(dets, np.float32).reshape(-1, 6))
        nums.append(len(dets))
    return _out(np.concatenate(outs)), _out(np.asarray(nums, np.int32))
