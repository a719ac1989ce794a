"""``paddle_tpu_torch.vision.ops`` against ``paddle_tpu.vision.ops`` on the
CPU: the same numpy inputs from a seed through both packages' public
functions, gradients through each package's own autograd against a
seeded cotangent.

Tolerances, as max |Δ| / max(|JAX|, 1):

- 1e-5 for the f32 device ops and their gradients (``yolo_box``,
  ``yolo_loss``, ``deform_conv2d``, ``roi_align``, ``psroi_pool``,
  ``box_coder``, the IoUs, ``ssd_loss``): the same formulas, summed in
  another order (torch's einsum and index_put against XLA's);
- exact for the host geometry and matching (``prior_box``,
  ``anchor_generator``, ``density_prior_box``, ``bipartite_match``,
  ``target_assign``, the FPN routing), for every index output and for
  ``nms`` / ``multiclass_nms`` (the port builds the IoU among the
  candidates only, with the same f32 formula, and sweeps on the device);
  the inputs are drawn so that no two scores tie;
- ``matrix_nms`` scores 1e-6 (the gaussian decay's exp in f32 where JAX
  takes Python's f64 exp), its kept set exact.

``multiclass_nms``, the samplers and the transforms have their own
files (``test_torch_detection_targets.py``,
``test_torch_vision_transforms.py``).
"""
import io

import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu.vision import ops as jops
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.vision import ops as tops
from torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)

TOL = 1e-5
PKGS = (paddle_tpu, paddle_tpu_torch)


@pytest.fixture(autouse=True)
def on_cpu():
    old = tdevice._current[0]
    paddle_tpu_torch.set_device("cpu")
    yield
    tdevice._current[0] = old


def _ops(pkg):
    return jops if pkg is paddle_tpu else tops


def _close(want, got, tol=TOL):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert want.shape == got.shape, (want.shape, got.shape)
    if want.size:
        err = np.abs(want - got).max()
        assert err <= tol * max(np.abs(want).max(), 1.0), err


def _equal(want, got):
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape, (want.shape, got.shape)
    np.testing.assert_array_equal(want, got)


def _np(t):
    return np.asarray(t.numpy())


def _run(fn, arrays, wrt=(), seed=0):
    """``fn(pkg, ops, *tensors)`` on both packages; with ``wrt``, also
    the gradients of sum(out · w) for a seeded w in each package's own
    autograd. Returns [(outs, grads)] for JAX and the port."""
    res = []
    for pkg in PKGS:
        ts = [pkg.to_tensor(a, stop_gradient=i not in wrt)
              for i, a in enumerate(arrays)]
        out = fn(pkg, _ops(pkg), *ts)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        grads = []
        if wrt:
            w = np.random.default_rng(seed).normal(
                size=tuple(outs[0].shape)).astype("float32")
            (outs[0] * pkg.to_tensor(w)).sum().backward()
            grads = [_np(ts[i].grad) for i in wrt]
        res.append(([_np(o) for o in outs], grads))
    return res


def _check(res, tol=TOL, exact=False):
    (jo, jg), (to, tg) = res
    for a, b in zip(jo + jg, to + tg):
        _equal(a, b) if exact else _close(a, b, tol)


def _boxes(rng, n, size=32.0, lo=2.0, hi=12.0):
    xy = rng.uniform(0, size - hi, (n, 2))
    wh = rng.uniform(lo, hi, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype("float32")


# -- YOLOv3 -----------------------------------------------------------------

ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119]


@pytest.mark.parametrize("clip", [True, False])
def test_yolo_box(clip):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 3 * 9, 5, 6)).astype("float32")
    img = np.asarray([[160, 192], [150, 170]], np.int32)
    _check(_run(lambda p, o, x_, i_: o.yolo_box(
        x_, i_, ANCHORS[:6], 4, 0.4, 32, clip_bbox=clip, scale_x_y=1.05),
        [x, img]))


def _gts(rng, n, b, empty=2):
    box = np.concatenate([rng.uniform(0.1, 0.9, (n, b, 2)),
                          rng.uniform(0.05, 0.5, (n, b, 2))], -1)
    box[:, -empty:] = 0.0                     # padded, empty rows
    label = rng.integers(0, 4, (n, b)).astype("int32")
    return box.astype("float32"), label


@pytest.mark.parametrize("smooth,mask", [(True, [3, 4, 5]),
                                         (False, [0, 1, 2])])
def test_yolo_loss_and_grad(smooth, mask):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 3 * 9, 8, 8)).astype("float32")
    box, label = _gts(rng, 2, 6)
    score = rng.uniform(0.5, 1.0, (2, 6)).astype("float32")
    _check(_run(lambda p, o, x_, b_, l_, s_: o.yolo_loss(
        x_, b_, l_, ANCHORS, mask, 4, 0.5, 16, gt_score=s_,
        use_label_smooth=smooth), [x, box, label, score], wrt=(0,)))


def test_yolo_loss_default_score():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, 3 * 9, 4, 4)).astype("float32")
    box, label = _gts(rng, 1, 3, empty=1)
    _check(_run(lambda p, o, x_, b_, l_: o.yolo_loss(
        x_, b_, l_, ANCHORS, [0, 1, 2], 4, 0.7, 8), [x, box, label],
        wrt=(0,)))


# -- deformable convolution -------------------------------------------------

@pytest.mark.parametrize("masked,dg,groups,stride", [
    (False, 1, 1, 1), (True, 1, 1, 1), (True, 2, 1, 1), (True, 2, 2, 2)])
def test_deform_conv2d_and_grads(masked, dg, groups, stride):
    rng = np.random.default_rng(4)
    N, Cin, H, W, Cout, k = 2, 4, 7, 6, 6, 3
    Ho = (H + 2 - 3) // stride + 1
    Wo = (W + 2 - 3) // stride + 1
    x = rng.normal(size=(N, Cin, H, W)).astype("float32")
    off = (rng.normal(size=(N, 2 * dg * k * k, Ho, Wo)) * 1.5).astype(
        "float32")
    w = rng.normal(size=(Cout, Cin // groups, k, k)).astype("float32")
    b = rng.normal(size=(Cout,)).astype("float32")
    m = rng.uniform(size=(N, dg * k * k, Ho, Wo)).astype("float32")
    arrays = [x, off, w, b] + ([m] if masked else [])

    def fn(p, o, x_, off_, w_, b_, *m_):
        return o.deform_conv2d(x_, off_, w_, b_, stride=stride, padding=1,
                               deformable_groups=dg, groups=groups,
                               mask=m_[0] if m_ else None)

    _check(_run(fn, arrays, wrt=tuple(range(len(arrays)))))


def test_deform_conv2d_layer():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(1, 4, 5, 5)).astype("float32")
    off = rng.normal(size=(1, 18, 5, 5)).astype("float32")
    m = rng.uniform(size=(1, 9, 5, 5)).astype("float32")
    paddle_tpu.seed(5)
    jl = jops.DeformConv2D(4, 3, 3, padding=1)
    tl = tops.DeformConv2D(4, 3, 3, padding=1)
    tl.set_state_dict({k: v.numpy() for k, v in jl.state_dict().items()})
    want = jl(*(paddle_tpu.to_tensor(a) for a in (x, off, m))).numpy()
    got = tl(*(paddle_tpu_torch.to_tensor(a) for a in (x, off, m))).numpy()
    _close(want, got)
    assert [tuple(p.shape) for p in tl.parameters()] == [(3, 4, 3, 3), (3,)]


# -- RoI --------------------------------------------------------------------

def _rois(rng, n_img=2, per=(3, 2), size=28.0):
    boxes = np.concatenate([_boxes(rng, k, size, 1.0, 14.0) for k in per])
    return boxes, np.asarray(per, np.int32)


@pytest.mark.parametrize("sr,aligned", [(-1, True), (2, False), (0, False)])
def test_roi_align_and_grad(sr, aligned):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 3, 8, 8)).astype("float32")
    boxes, num = _rois(rng)
    _check(_run(lambda p, o, x_, b_, n_: o.roi_align(
        x_, b_, n_, 3, spatial_scale=0.25, sampling_ratio=sr,
        aligned=aligned), [x, boxes, num], wrt=(0,)))


def test_roi_pool():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 3, 8, 8)).astype("float32")
    boxes, num = _rois(rng)
    boxes[0] = [40.0, 40.0, 44.0, 44.0]      # outside: empty bins give 0
    _check(_run(lambda p, o, x_, b_, n_: o.roi_pool(
        x_, b_, n_, (2, 3), spatial_scale=0.25), [x, boxes, num]))


def test_psroi_pool_and_grad():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 2 * 4, 8, 8)).astype("float32")
    boxes, num = _rois(rng)
    _check(_run(lambda p, o, x_, b_, n_: o.psroi_pool(
        x_, b_, n_, 2, spatial_scale=0.25), [x, boxes, num], wrt=(0,)))


@pytest.mark.parametrize("layer", ["RoIAlign", "RoIPool", "PSRoIPool"])
def test_roi_layers(layer):
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 4, 8, 8)).astype("float32")
    boxes, num = _rois(rng)
    _check(_run(lambda p, o, x_, b_, n_: getattr(o, layer)(2, 0.25)(
        x_, b_, n_), [x, boxes, num]))


# -- box utilities ----------------------------------------------------------

def test_box_iou_and_iou_similarity():
    rng = np.random.default_rng(10)
    a, b = _boxes(rng, 5), _boxes(rng, 4)
    _check(_run(lambda p, o, a_, b_: (
        o.box_iou(a_, b_), o.iou_similarity(a_, b_),
        o.iou_similarity(a_, b_, box_normalized=False)), [a, b]))


def test_box_clip():
    rng = np.random.default_rng(11)
    b2 = (rng.normal(size=(6, 4)) * 30 + 10).astype("float32")
    b3 = (rng.normal(size=(2, 5, 4)) * 30 + 10).astype("float32")
    info = np.asarray([[20, 30, 1.0], [40, 25, 2.0]], np.float32)
    _check(_run(lambda p, o, b2_, b3_, i_, i1_: (
        o.box_clip(b3_, i_), o.box_clip(b2_, i1_)),
        [b2, b3, info, info[1]]))


@pytest.mark.parametrize("var", ["list", "array", "none"])
@pytest.mark.parametrize("normalized", [True, False])
def test_box_coder(var, normalized):
    rng = np.random.default_rng(12)
    pb = _boxes(rng, 5)
    tb = _boxes(rng, 3)
    deltas = (rng.normal(size=(3, 5, 4)) * 0.3).astype("float32")
    pv = rng.uniform(0.1, 0.3, (5, 4)).astype("float32")

    def fn(p, o, pb_, tb_, d_, pv_):
        v = {"list": [0.1, 0.1, 0.2, 0.2], "array": pv_, "none": None}[var]
        return (o.box_coder(pb_, v, tb_, "encode_center_size", normalized),
                o.box_coder(pb_, v, d_, "decode_center_size", normalized,
                            axis=0))

    _check(_run(fn, [pb, tb, deltas, pv]))


def test_box_coder_decode_axis1():
    rng = np.random.default_rng(13)
    pb = _boxes(rng, 3)
    deltas = (rng.normal(size=(3, 5, 4)) * 0.3).astype("float32")
    _check(_run(lambda p, o, pb_, d_: o.box_coder(
        pb_, [0.1, 0.1, 0.2, 0.2], d_, "decode_center_size", axis=1),
        [pb, deltas]))


# -- prior / anchor generators ----------------------------------------------

@pytest.mark.parametrize("order,flip,clip", [(False, True, False),
                                             (True, False, True)])
def test_prior_box(order, flip, clip):
    feat = np.zeros((1, 2, 3, 4), np.float32)
    img = np.zeros((1, 3, 30, 40), np.float32)
    _check(_run(lambda p, o, f_, i_: o.prior_box(
        f_, i_, [4.0, 9.0], [8.0, 16.0], aspect_ratios=[2.0, 0.5, 3.0],
        flip=flip, clip=clip, min_max_aspect_ratios_order=order),
        [feat, img]), exact=True)


def test_density_prior_box_and_anchor_generator():
    feat = np.zeros((1, 2, 3, 3), np.float32)
    img = np.zeros((1, 3, 48, 48), np.float32)
    _check(_run(lambda p, o, f_, i_: o.density_prior_box(
        f_, i_, [2, 1], [8.0, 16.0], [1.0, 2.0], clip=True,
        flatten_to_2d=True) + o.anchor_generator(
        f_, [32.0, 64.0], [0.5, 1.0, 2.0], stride=[16.0, 16.0]),
        [feat, img]), exact=True)


# -- matching ---------------------------------------------------------------

@pytest.mark.parametrize("match_type", [None, "per_prediction"])
def test_bipartite_match_and_target_assign(match_type):
    rng = np.random.default_rng(14)
    d = rng.uniform(size=(3, 7)).astype("float32")
    rows = rng.normal(size=(3, 4)).astype("float32")
    neg = np.asarray([1, 5], np.int32)

    def fn(p, o, d_, r_, n_):
        idx, dist = o.bipartite_match(d_, match_type, 0.3)
        return (idx, dist) + o.target_assign(r_, idx, n_, mismatch_value=-1)

    _check(_run(fn, [d, rows, neg]), exact=True)


def test_ssd_loss_and_grads():
    rng = np.random.default_rng(15)
    M, C = 12, 4
    pb = np.clip(_boxes(rng, M, 1.0, 0.1, 0.4), 0, 1)
    loc = rng.normal(size=(2, M, 4)).astype("float32")
    conf = rng.normal(size=(2, M, C)).astype("float32")
    gt = np.clip(_boxes(rng, 6, 1.0, 0.15, 0.4), 0, 1).reshape(2, 3, 4)
    gt[1, 2] = 0.0                              # an empty row
    lab = rng.integers(1, C, (2, 3, 1)).astype("int32")
    _check(_run(lambda p, o, l_, c_, g_, gl_, pb_: o.ssd_loss(
        l_, c_, g_, gl_, pb_), [loc, conf, gt, lab, pb], wrt=(0, 1)))


# -- NMS --------------------------------------------------------------------

def _scored(rng, n, size=32.0):
    boxes = _boxes(rng, n, size)
    scores = rng.permutation(n).astype("float32") / n + 0.01
    return boxes, scores


@pytest.mark.parametrize("case", ["scores", "no_scores", "categories",
                                  "top_k"])
def test_nms(case):
    rng = np.random.default_rng(16)
    boxes, scores = _scored(rng, 24, size=24.0)
    cats = rng.integers(0, 3, 24).astype("int64")

    def fn(p, o, b_, s_, c_):
        if case == "no_scores":
            return o.nms(b_, 0.3)
        if case == "categories":
            return o.nms(b_, 0.4, s_, c_, [0, 1, 2])
        return o.nms(b_, 0.35, s_, top_k=5 if case == "top_k" else None)

    _check(_run(fn, [boxes, scores, cats]), exact=True)


@pytest.mark.parametrize("gaussian", [False, True])
def test_matrix_nms(gaussian):
    rng = np.random.default_rng(17)
    N, C, M = 2, 3, 10
    boxes = np.stack([_boxes(rng, M, 20.0) for _ in range(N)])
    scores = rng.permutation(N * C * M).reshape(N, C, M).astype(
        "float32") / (N * C * M)
    res = _run(lambda p, o, b_, s_: o.matrix_nms(
        b_, s_, 0.2, post_threshold=0.1, nms_top_k=6, keep_top_k=8,
        use_gaussian=gaussian, normalized=False, return_index=True),
        [boxes, scores])
    (jo, _), (to, _) = res
    _close(jo[0], to[0], 1e-6)
    _equal(jo[1], to[1])
    _equal(jo[2], to[2])


# -- proposals --------------------------------------------------------------

def _rpn_inputs(rng, N=2, A=3, H=4, W=5):
    scores = rng.permutation(N * A * H * W).reshape(N, A, H, W).astype(
        "float32") / (N * A * H * W)
    deltas = (rng.normal(size=(N, 4 * A, H, W)) * 0.2).astype("float32")
    anchors = np.asarray(jops.anchor_generator(
        paddle_tpu.to_tensor(np.zeros((1, 1, H, W), np.float32)),
        [16.0, 32.0, 64.0][:A], [1.0], stride=[8.0, 8.0])[0].numpy())
    info = np.asarray([[40, 48, 1.0], [36, 40, 0.8]], np.float32)[:N]
    return scores, deltas, anchors, info


@pytest.mark.parametrize("eta", [1.0, 0.9])
def test_generate_proposals(eta):
    rng = np.random.default_rng(18)
    scores, deltas, anchors, info = _rpn_inputs(rng)
    var = np.full_like(anchors, 0.5)
    res = _run(lambda p, o, s_, d_, i_, a_, v_: o.generate_proposals(
        s_, d_, i_, a_, v_, pre_nms_top_n=40, post_nms_top_n=12,
        nms_thresh=0.6, min_size=2.0, eta=eta),
        [scores, deltas, info, anchors, var])
    _check(res, 1e-6)
    _equal(res[0][0][2], res[1][0][2])


def test_distribute_and_collect_fpn_proposals():
    rng = np.random.default_rng(19)
    rois = _boxes(rng, 14, 400.0, 10.0, 300.0)
    num = np.asarray([8, 6], np.int32)
    scores = rng.permutation(14).astype("float32") / 14
    outs = []
    for pkg in PKGS:
        o = _ops(pkg)
        multi, restore, counts = o.distribute_fpn_proposals(
            pkg.to_tensor(rois), 2, 5, 4, 224, rois_num=pkg.to_tensor(num))
        lens = [int(m.shape[0]) for m in multi]
        sc = np.split(scores, np.cumsum(lens)[:-1])
        top = o.collect_fpn_proposals(multi, [pkg.to_tensor(s) for s in sc],
                                      2, 5, 9)
        grouped = o.collect_fpn_proposals(
            multi, [pkg.to_tensor(s) for s in sc], 2, 5, 9,
            rois_num_per_level=counts)
        outs.append([_np(m) for m in multi] + [_np(restore)]
                    + [_np(c) for c in counts] + [_np(top)]
                    + [_np(g) for g in grouped])
    for a, b in zip(*outs):
        _equal(a, b)


def test_retinanet_detection_output():
    rng = np.random.default_rng(20)
    feats = [(4, 4), (2, 2)]
    bbs, scs, ancs = [], [], []
    for i, (h, w) in enumerate(feats):
        anc = np.asarray(jops.anchor_generator(
            paddle_tpu.to_tensor(np.zeros((1, 1, h, w), np.float32)),
            [16.0 * 2 ** i], [1.0], stride=[8.0 * 2 ** i] * 2)[0].numpy())
        M = h * w
        bbs.append((rng.normal(size=(2, M, 4)) * 0.2).astype("float32"))
        scs.append((rng.permutation(2 * M * 3).reshape(2, M, 3)
                    / (2 * M * 3)).astype("float32"))
        ancs.append(anc.reshape(-1, 4))
    info = np.asarray([[32, 32, 1.0], [30, 28, 1.0]], np.float32)
    outs = []
    for pkg in PKGS:
        t = [pkg.to_tensor(a) for a in bbs + scs + ancs]
        outs.append([_np(x) for x in _ops(pkg).retinanet_detection_output(
            t[0:2], t[2:4], t[4:6], pkg.to_tensor(info),
            score_threshold=0.3, nms_top_k=10, keep_top_k=12,
            nms_threshold=0.4)])
    _close(outs[0][0], outs[1][0], 1e-6)
    _equal(outs[0][1], outs[1][1])


def test_polygon_box_transform():
    rng = np.random.default_rng(21)
    x = rng.normal(size=(2, 8, 3, 4)).astype("float32")
    _check(_run(lambda p, o, x_: o.polygon_box_transform(x_), [x]))


def test_locality_aware_nms():
    rng = np.random.default_rng(22)
    base = _boxes(rng, 6, 40.0, 6.0, 12.0)
    boxes = np.repeat(base, 2, axis=0) + rng.normal(
        size=(12, 4)).astype("float32") * 0.5
    scores = (rng.permutation(2 * 12).reshape(1, 2, 12) / 24 + 0.05).astype(
        "float32")
    res = _run(lambda p, o, b_, s_: o.locality_aware_nms(
        b_, s_, 0.1, 8, 6, nms_threshold=0.3, normalized=False,
        background_label=-1), [boxes[None], scores])
    _check(res, 1e-6)


# -- image IO ---------------------------------------------------------------

@pytest.mark.parametrize("mode", ["unchanged", "gray", "rgb"])
def test_read_file_and_decode_jpeg(tmp_path, mode):
    from PIL import Image

    rng = np.random.default_rng(23)
    img = rng.integers(0, 256, (12, 10, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG")
    path = tmp_path / "a.jpg"
    path.write_bytes(buf.getvalue())
    outs = []
    for pkg in PKGS:
        raw = _ops(pkg).read_file(str(path))
        outs.append((_np(raw), _np(_ops(pkg).decode_jpeg(raw, mode=mode))))
    _equal(outs[0][0], np.frombuffer(buf.getvalue(), np.uint8))
    for a, b in zip(*outs):
        _equal(a, b)
    assert outs[1][1].shape == ((1, 12, 10) if mode == "gray"
                                else (3, 12, 10))


def test_every_name_resolves():
    assert set(jops.__all__) == set(tops.__all__)
    assert all(hasattr(tops, n) for n in jops.__all__)
