"""The port's AlexNet, VGG, MobileNet V1 / V2 and ResNeXt against
paddle_tpu's, on the CPU, each at a small size.

The JAX model is built (with constant initializers: its own per-shape
random initializers are most of a test's time on the CPU) and given
weights from a seeded numpy generator (He-normal for the weights, batch
norm's scale 1 and shift 0, running mean 0 and variance 1); its state
(numpy f32 under its ``state_dict()`` names, batch-norm buffers
included) is carried into the port's model by ``set_state_dict``, which
must find every name with its shape.

One training-mode forward (batch norm normalizing with the batch's
statistics and updating its running ones), each model's dropout
probability set to 0 (the two packages' generators differ), on one
seeded batch; the JAX model runs through ``paddle_tpu.jit.to_static``
(one compiled program: eager JAX compiles each op on its own, which
tripled the test's time), which writes its running statistics back:
- the logits within 5e-4 of their largest value (f32 convolutions summed
  in another order through up to 50 conv / BN layers, the last batch
  norms normalizing 8 values a channel; 0.8e-4 to 1.3e-4 measured);
- the cross-entropy loss within 1e-4 relative;
- every running mean and variance within 1e-3 of its largest value
  (``test_torch_vision.py``'s bound).

VGG runs without its classifier (``num_classes=0``: the 512·7·7 → 4096
layers alone hold 120M parameters), its loss the mean square of the
pooled features.
Sizes: ``mobilenet_v2(scale=0.25)`` and ``mobilenet_v1(scale=0.25)`` at
2×3×64×64 (not 32×32: there the last batch norms normalize two values a
channel, which turns the packages' 1e-6 summation differences into 1%,
``test_torch_vision.py``'s note), ``vgg11(batch_norm=True)`` at
2×3×32×32, AlexNet and ``resnext50_32x4d`` at 2×3×64×64; ten classes.
"""
import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu_torch import device as tdevice
from torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)

LOGIT_TOL = 5e-4
LOSS_REL = 1e-4
STATE_TOL = 1e-3


@pytest.fixture(autouse=True)
def on_cpu():
    old = tdevice._current[0]
    paddle_tpu_torch.set_device("cpu")
    yield
    tdevice._current[0] = old


def _close(want, got, tol):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert want.shape == got.shape
    err = np.abs(want - got).max()
    assert err <= tol * max(np.abs(want).max(), 0.1), err


def _seeded_state(model, seed=0):
    """He-normal weights, unit BN scales, zero shifts and means, unit
    variances: numpy f32 under ``model``'s state names."""
    rng = np.random.default_rng(seed)
    state = {}
    for k, v in model.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("_variance") or (k.endswith("weight") and
                                       len(shape) == 1):
            state[k] = np.ones(shape, np.float32)
        elif len(shape) <= 1:
            state[k] = np.zeros(shape, np.float32)
        else:
            fan_in = shape[0] if len(shape) == 2 else int(np.prod(shape[1:]))
            state[k] = (rng.normal(size=shape) * np.sqrt(2.0 / fan_in)
                        ).astype(np.float32)
    return state


def _carried(build):
    I = paddle_tpu.nn.initializer
    I.set_global_initializer(I.Constant(0.0), I.Constant(0.0))
    try:
        jm = build(paddle_tpu)
    finally:
        I.set_global_initializer(None, None)
    jm.set_state_dict(_seeded_state(jm))
    tm = build(paddle_tpu_torch)
    state = {k: np.asarray(v.numpy(), np.float32)
             for k, v in jm.state_dict().items()}
    missing, unexpected = tm.set_state_dict(state)
    assert missing == [] and unexpected == []
    return jm, tm


def _forward(paddle, model, images, labels, head):
    for layer in model.sublayers():
        if isinstance(layer, paddle.nn.Dropout):
            layer.p = 0.0
    run = paddle.jit.to_static(model) if paddle is paddle_tpu else model
    out = run(paddle.to_tensor(images))
    if head:
        loss = paddle.nn.functional.cross_entropy(out,
                                                  paddle.to_tensor(labels))
    else:
        loss = (out * out).mean()
    stats = {k: v.numpy() for k, v in model.state_dict().items()
             if k.endswith("_mean") or k.endswith("_variance")}
    return out.numpy(), float(loss.numpy()), stats


MODELS = {
    "mobilenet_v2": (lambda p: p.vision.models.mobilenet_v2(
        scale=0.25, num_classes=10), 64, True),
    "mobilenet_v1": (lambda p: p.vision.models.mobilenet_v1(
        scale=0.25, num_classes=10), 64, True),
    "vgg11_bn": (lambda p: p.vision.models.vgg11(
        batch_norm=True, num_classes=0), 32, False),
    "alexnet": (lambda p: p.vision.models.alexnet(num_classes=10), 64, True),
    "resnext50_32x4d": (lambda p: p.vision.models.resnext50_32x4d(
        num_classes=10), 64, True),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_train_forward_matches_jax(name):
    build, side, head = MODELS[name]
    jm, tm = _carried(build)
    rng = np.random.default_rng(16)
    images = rng.normal(size=(2, 3, side, side)).astype("float32")
    labels = rng.integers(0, 10, (2,)).astype("int64")
    (oj, lj, sj), (ot, lt, st) = (
        _forward(p, m, images, labels, head)
        for p, m in ((paddle_tpu, jm), (paddle_tpu_torch, tm)))
    _close(oj, ot, LOGIT_TOL)
    assert abs(lt - lj) <= LOSS_REL * abs(lj), (lj, lt)
    assert set(sj) == set(st)
    assert bool(sj) == (name != "alexnet")
    for k in sj:
        _close(sj[k], st[k], STATE_TOL)


def test_every_model_name_is_exported_and_pretrained_raises():
    names = paddle_tpu.vision.models.__all__ if hasattr(
        paddle_tpu.vision.models, "__all__") else []
    for n in names:
        assert hasattr(paddle_tpu_torch.vision.models, n), n
    for fn in (paddle_tpu_torch.vision.models.alexnet,
               paddle_tpu_torch.vision.models.vgg11,
               paddle_tpu_torch.vision.models.mobilenet_v2,
               paddle_tpu_torch.vision.models.resnext50_32x4d):
        with pytest.raises(RuntimeError):
            fn(pretrained=True)
