"""``multiclass_nms`` and the seeded samplers of ``vision.ops`` against
``paddle_tpu.vision.ops`` on the CPU.

- ``multiclass_nms``: the port computes IoU only among each class's
  ``nms_top_k`` candidates and sweeps every (image, class) at once on the
  tensor's device; its rows, counts and indices must equal the JAX
  function's (which builds the IoU of all M boxes an image) exactly,
  batched and in the 2-D ``rois_num`` form, with ``nms_eta`` < 1, a
  background class, ``normalized=False`` and ``keep_top_k``. Scores are
  a permutation of distinct values, so no two tie.
- The samplers (``rpn_target_assign``, ``generate_proposal_labels``)
  draw from a numpy generator seeded like the JAX package's
  (``SeedSequence(spawn_key=(rank,), entropy=seed)``, renewed on every
  ``paddle.seed``): under the same seed the sampled subsets and targets
  equal JAX's, and reseeding with the same value restarts the stream.
  ``retinanet_target_assign`` (no sampling) is equal too.
"""
import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu.vision import ops as jops
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.vision import ops as tops
from torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)

PKGS = ((paddle_tpu, jops), (paddle_tpu_torch, tops))


@pytest.fixture(autouse=True)
def on_cpu():
    old = tdevice._current[0]
    paddle_tpu_torch.set_device("cpu")
    yield
    tdevice._current[0] = old


def _boxes(rng, n, size, lo, hi):
    xy = rng.uniform(0, size - hi, (n, 2))
    wh = rng.uniform(lo, hi, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype("float32")


def _equal_outs(outs):
    (a, b) = outs
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = np.asarray(x.numpy()), np.asarray(y.numpy())
        assert x.shape == y.shape, (x.shape, y.shape)
        np.testing.assert_array_equal(x, y)


def _nms_inputs(seed, N=2, C=4, M=40):
    rng = np.random.default_rng(seed)
    boxes = np.stack([_boxes(rng, M, 30.0, 3.0, 12.0) for _ in range(N)])
    scores = (rng.permutation(N * C * M).reshape(N, C, M)
              / (N * C * M)).astype("float32")
    return boxes, scores


@pytest.mark.parametrize("kw", [
    dict(score_threshold=0.3, nms_top_k=10, keep_top_k=12,
         nms_threshold=0.3),
    dict(score_threshold=0.1, nms_top_k=-1, keep_top_k=-1,
         nms_threshold=0.6, nms_eta=0.9, background_label=-1),
    dict(score_threshold=0.05, nms_top_k=16, keep_top_k=-1,
         nms_threshold=0.5, normalized=False, background_label=2),
], ids=["top_k", "eta", "unnormalized_background"])
def test_multiclass_nms_equals_jax(kw):
    boxes, scores = _nms_inputs(31)
    _equal_outs([o.multiclass_nms(p.to_tensor(boxes), p.to_tensor(scores),
                                  return_index=True, **kw)
                 for p, o in PKGS])


def test_multiclass_nms_rois_num_form():
    boxes, scores = _nms_inputs(32, N=1, M=30)
    flat_b = boxes[0]
    flat_s = scores[0]
    num = np.asarray([12, 0, 18], np.int32)
    _equal_outs([o.multiclass_nms(
        p.to_tensor(flat_b), p.to_tensor(flat_s), score_threshold=0.2,
        nms_top_k=8, keep_top_k=10, nms_threshold=0.4, return_index=True,
        rois_num=p.to_tensor(num)) for p, o in PKGS])


def test_multiclass_nms_refusals():
    boxes, scores = _nms_inputs(33)
    for p, o in PKGS:
        with pytest.raises(ValueError):
            o.multiclass_nms(p.to_tensor(boxes[0]), p.to_tensor(scores[0]))
        with pytest.raises(ValueError):
            o.multiclass_nms(p.to_tensor(boxes), p.to_tensor(scores),
                             rois_num=p.to_tensor(np.asarray([40, 40])))


def _rpn_case(seed):
    rng = np.random.default_rng(seed)
    anchors = _boxes(rng, 300, 64.0, 4.0, 30.0)
    var = np.full_like(anchors, 0.5)
    gt = np.stack([_boxes(rng, 5, 60.0, 8.0, 30.0) for _ in range(2)])
    gt[1, 4] = 0.0                                      # an empty row
    crowd = np.zeros((2, 5), np.int32)
    crowd[0, 1] = 1
    info = np.asarray([[64, 64, 1.0], [60, 62, 1.0]], np.float32)
    bp = rng.normal(size=(2, 300, 4)).astype("float32")
    cl = rng.normal(size=(2, 300, 1)).astype("float32")
    return bp, cl, anchors, var, gt, crowd, info


def _rpn(p, o, case, **kw):
    bp, cl, anchors, var, gt, crowd, info = case
    t = p.to_tensor
    return o.rpn_target_assign(t(bp), t(cl), t(anchors), t(var), t(gt),
                               t(crowd), t(info), **kw)


@pytest.mark.parametrize("use_random", [True, False])
def test_rpn_target_assign_draws_equal_jax(use_random):
    case = _rpn_case(34)
    outs = []
    for p, o in PKGS:
        p.seed(7)
        first = _rpn(p, o, case, rpn_batch_size_per_im=32,
                     use_random=use_random)
        second = _rpn(p, o, case, rpn_batch_size_per_im=32,
                      use_random=use_random)
        p.seed(7)                       # the same seed restarts the draws
        again = _rpn(p, o, case, rpn_batch_size_per_im=32,
                     use_random=use_random)
        outs.append(first + second + again)
    _equal_outs(outs)
    port = [np.asarray(t.numpy()) for t in outs[1]]
    np.testing.assert_array_equal(port[0], port[10])
    if use_random:                      # the stream advances between calls
        assert not np.array_equal(port[0], port[5])


def test_generate_proposal_labels_draws_equal_jax():
    rng = np.random.default_rng(35)
    rois = np.concatenate([_boxes(rng, 40, 64.0, 4.0, 40.0),
                           _boxes(rng, 30, 64.0, 4.0, 40.0)])
    num = np.asarray([40, 30], np.int32)
    gt = np.stack([_boxes(rng, 4, 60.0, 8.0, 30.0) for _ in range(2)])
    cls = rng.integers(1, 5, (2, 4)).astype("int32")
    crowd = np.zeros((2, 4), np.int32)
    info = np.asarray([[64, 64, 1.0], [64, 64, 2.0]], np.float32)
    outs = []
    for p, o in PKGS:
        p.seed(11)
        t = p.to_tensor
        outs.append(
            o.generate_proposal_labels(
                t(rois), t(cls), t(crowd), t(gt), t(info),
                batch_size_per_im=24, fg_fraction=0.25, fg_thresh=0.4,
                bg_thresh_hi=0.4, class_nums=5, rois_num=t(num))
            + o.generate_proposal_labels(
                t(rois[:40]), t(cls[:1]), None, t(gt[:1]), t(info[:1]),
                batch_size_per_im=16, is_cls_agnostic=True, class_nums=5))
    _equal_outs(outs)


def test_retinanet_target_assign_equals_jax():
    bp, cl, anchors, var, gt, crowd, info = _rpn_case(36)
    cl3 = np.random.default_rng(36).normal(size=(2, 300, 3)).astype(
        "float32")
    labels = np.random.default_rng(37).integers(1, 4, (2, 5)).astype("int32")
    _equal_outs([o.retinanet_target_assign(
        p.to_tensor(bp), p.to_tensor(cl3), p.to_tensor(anchors),
        p.to_tensor(var), p.to_tensor(gt), p.to_tensor(labels),
        p.to_tensor(crowd), p.to_tensor(info), num_classes=3)
        for p, o in PKGS])
