"""chip_smoke.py's YOLOv3-R50vd-DCN detector (PaddleDetection's
``yolov3_r50vd_dcn_270e_coco``) at phase 48b's narrow two-level size,
built from the port's layers against the same network built from
paddle_tpu's, on the CPU, the JAX model's weights carried across by
``set_state_dict`` as numpy (the deformable convolutions' offset
convolutions seeded, so the sampling points move).

On one seeded batch (2 images of 64x64, up to 6 gt boxes each):

- the train-mode loss (``yolo_loss`` over both levels) within 1e-5
  relative: the same f32 math summed in another order;
- every parameter's gradient, the deformable convolutions' weights and
  their offset / mask convolutions included, within 1e-4 of its largest
  value (backbone, FPN and head: ~25 layers of f32 sums in another
  order, the batch norms dividing by batch statistics of 2 images);
- one Momentum step (0.9, L2 5e-4; the batch norms' scale and bias
  without decay) in the port against the reference's update applied to
  JAX's gradients: every parameter within 1e-5 of its largest value
  plus the learning rate times the gradients' bound (a zero-initialised
  bias moves by lr·g alone);
- the detections (``yolo_box`` per level + ``multiclass_nms`` at the
  config's thresholds) of that forward: equal, or different only at a
  near tie that ``chip_smoke.detections_agree`` names (none is expected
  and the test requires none).
"""
import numpy as np
import pytest

import chip_smoke as cs
import paddle_tpu
import paddle_tpu_torch
from paddle_tpu_torch import device as tdevice
from torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)

LOSS_REL = 1e-5
GRAD_TOL = 1e-4
STEP_TOL = 1e-5


@pytest.fixture(autouse=True)
def on_cpu():
    old = tdevice._current[0]
    paddle_tpu_torch.set_device("cpu")
    yield
    tdevice._current[0] = old


@pytest.fixture(scope="module")
def runs():
    """Both packages' loss, gradients, stepped params and detections:
    the port eager, JAX through one ``jax.jit`` of ``value_and_grad``
    over ``paddle_tpu.jit.functional_call`` (eager JAX compiles each op
    and its gradient on its own: several times slower)."""
    old = tdevice._current[0]
    paddle_tpu_torch.set_device("cpu")
    try:
        paddle_tpu_torch.seed(48)
        tm = cs.yolov3_model(paddle_tpu_torch, **cs.YOLO_SMALL)
        state = cs.yolov3_small_state(tm, 48)
        missing, unexpected = tm.set_state_dict(state)
        assert not missing and not unexpected
        # the JAX model with constant initializers (its per-shape random
        # ones are most of its build time), then the same state
        I = paddle_tpu.nn.initializer
        I.set_global_initializer(I.Constant(0.0), I.Constant(0.0))
        try:
            jm = cs.yolov3_model(paddle_tpu, **cs.YOLO_SMALL)
        finally:
            I.set_global_initializer(None, None)
        jm.set_state_dict(state)
        batch = cs.yolov3_batch(np.random.default_rng(48),
                                num_classes=cs.YOLO_SMALL["num_classes"],
                                **cs.YOLO_SMALL_BATCH)
        return _jax_run(jm, batch), _port_run(tm, batch)
    finally:
        tdevice._current[0] = old


C = cs.YOLO_SMALL["num_classes"]


def _decode(paddle, outs, im_size, res):
    with paddle.no_grad():
        boxes, scores = cs.yolov3_boxes(paddle, outs, im_size, C)
        res["dets"] = tuple(np.asarray(t.numpy())
                            for t in cs.yolov3_nms(paddle, boxes, scores))
    res["boxes"] = np.asarray(boxes.numpy())
    res["scores"] = np.asarray(scores.numpy())
    return res


def _jax_run(model, batch):
    import jax

    from paddle_tpu.framework.core import Tensor
    from paddle_tpu.jit import functional_call

    params = {k: p._data for k, p in model.named_parameters()}
    buffers = {k: b._data for k, b in model.named_buffers() if b is not None}

    def loss_of(params, im, gb, gl):
        outs, _ = functional_call(model, params, buffers, Tensor(im),
                                  training=True)
        loss = cs.yolov3_loss(paddle_tpu, outs, Tensor(gb), Tensor(gl), C)
        return loss._data, [o._data for o in outs]

    (loss, outs), grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(
        params, *batch[:3])
    res = {"loss": float(loss),
           "grads": {k: np.asarray(g) for k, g in grads.items()},
           "params": {k: np.asarray(v) for k, v in params.items()}}
    return _decode(paddle_tpu, [Tensor(o) for o in outs],
                   paddle_tpu.to_tensor(batch[3]), res)


def _port_run(model, batch):
    P = paddle_tpu_torch
    images, gt_box, gt_label, im_size = (P.to_tensor(a) for a in batch)
    outs = model(images)
    loss = cs.yolov3_loss(P, outs, gt_box, gt_label, C)
    loss.backward()
    res = {"loss": float(loss),
           "grads": {n: np.asarray(p.grad.numpy())
                     for n, p in model.named_parameters()}}
    _decode(P, outs, im_size, res)
    opt = P.optimizer.Momentum(
        learning_rate=cs.YOLO_LR["base"], momentum=cs.YOLO_LR["momentum"],
        parameters=model.parameters(),
        weight_decay=P.regularizer.L2Decay(cs.YOLO_LR["l2"]))
    opt.step()
    res["stepped"] = {n: np.asarray(p.numpy())
                      for n, p in model.named_parameters()}
    res["decayed"] = {n: p.regularizer is None
                      for n, p in model.named_parameters()}
    return res


def _rel_to_max(want, got):
    return np.abs(want - got).max() / max(np.abs(want).max(), 1e-30)


def test_loss(runs):
    j, t = runs
    assert abs(j["loss"] - t["loss"]) / abs(j["loss"]) <= LOSS_REL


def test_every_gradient(runs):
    j, t = runs
    assert j["grads"].keys() == t["grads"].keys()
    assert any("conv_offset" in n for n in j["grads"])
    worst = {n: _rel_to_max(j["grads"][n], t["grads"][n])
             for n in j["grads"]}
    assert max(worst.values()) <= GRAD_TOL, sorted(
        worst.items(), key=lambda kv: -kv[1])[:5]
    offsets = [n for n in j["grads"] if "conv_offset" in n]
    assert all(np.abs(j["grads"][n]).max() > 0 for n in offsets)


def test_momentum_step(runs):
    """The port's first Momentum step against the reference's update
    from JAX's gradients: v = g + 5e-4·p (no decay on the batch norms'
    scale and bias), p - lr·v."""
    j, t = runs
    lr, l2 = cs.YOLO_LR["base"], cs.YOLO_LR["l2"]
    assert not all(t["decayed"].values()) and any(t["decayed"].values())
    for n, p in j["params"].items():
        g = j["grads"][n]
        want = p - lr * (g + (l2 * p if t["decayed"][n] else 0.0))
        err = np.abs(want - t["stepped"][n]).max()
        # the update's own rounding, plus lr times the gradients' bound
        # (a zero-initialised bias moves by lr·g alone)
        assert err <= (STEP_TOL * np.abs(want).max()
                       + lr * GRAD_TOL * np.abs(g).max()), n


def test_detections_equal(runs):
    j, t = runs
    ok, ties, err = cs.detections_agree(j["dets"], t["dets"], j["boxes"],
                                        j["scores"])
    assert ok and not ties, (ties, err)
    assert int(j["dets"][1].sum()) > 0
    np.testing.assert_array_equal(j["dets"][1], t["dets"][1])
    np.testing.assert_array_equal(j["dets"][2], t["dets"][2])
