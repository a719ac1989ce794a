"""The port's convolutions, pooling, batch norm, ``flatten`` and Kaiming
initializers against paddle_tpu's, through each package's Paddle
surface on the CPU.

- conv1d/2d/3d with int, per-axis, asymmetric (2n and (n+2)-pair),
  ``"SAME"`` and ``"VALID"`` padding, strides, dilations and groups:
  outputs and the gradients of x, weight and bias;
- max and avg pooling (1/2/3-d) with ``ceil_mode`` (the reference pads
  the high edge by stride − 1), ``exclusive``, padding, ``"SAME"`` and
  ``divisor_override``: outputs and input gradients;
- adaptive avg and max pooling at divisible and non-divisible sizes;
- ``batch_norm`` in train and eval mode, f32 and bf16 input, NCHW and
  NHWC: outputs, gradients, and the running statistics after two calls;
- ``flatten`` (and the Tensor method), ``KaimingUniform`` /
  ``KaimingNormal`` bounds and spread, and the conv layers' default
  initializer.

Inputs from numpy with a seed. Tolerances: f32 1e-5 of the largest
reference value (0.1 at least): the same f32 math summed in another
order. bf16 outputs and gradients 1e-2 of the largest value: both sides
compute the statistics in f32 and round once to bf16, and an f32 sum in
another order can cross one bf16 rounding (3.9e-3 of a value). The
running statistics are f32 on both sides (1e-5).
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu_torch import device as tdevice
from torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)

TOL = 1e-5
BF16_TOL = 1e-2


@pytest.fixture(autouse=True)
def on_cpu():
    old = tdevice._current[0]
    paddle_tpu_torch.set_device("cpu")
    yield
    tdevice._current[0] = old


def _close(want, got, tol=TOL):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert want.shape == got.shape, (want.shape, got.shape)
    # a window wholly in padding is -inf (max) on both sides
    np.testing.assert_array_equal(np.isfinite(want), np.isfinite(got))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(want[~fin], got[~fin])
    if fin.any():
        err = np.abs(want[fin] - got[fin]).max()
        assert err <= tol * max(np.abs(want[fin]).max(), 0.1), err


def _both(fn):
    return fn(paddle_tpu), fn(paddle_tpu_torch)


def _leaf(paddle, arr, dtype="float32"):
    t = paddle.to_tensor(arr).astype(dtype)
    t.stop_gradient = False
    return t


def _loss(paddle, y):
    """sum(y·C) in f32 for a fixed cotangent C of y's shape (a gradient
    that is not y's own, whose projection batch norm would cancel)."""
    c = 1.0 + 0.5 * np.cos(np.arange(math.prod(y.shape), dtype=np.float32))
    return (y.astype("float32")
            * paddle.to_tensor(c.reshape(y.shape))).sum()


# ==========================================================================
# convolution
# ==========================================================================

# (n, x shape, weight shape, bias, stride, padding, dilation, groups)
CONV_CASES = [
    (1, (2, 4, 11), (6, 4, 3), True, 2, 1, 1, 1),
    (1, (2, 4, 11), (6, 4, 3), False, 1, [2], 1, 1),
    (1, (2, 4, 11), (6, 4, 3), True, 1, [1, 2], 1, 1),
    (1, (2, 4, 11), (6, 4, 3), True, 2, "SAME", 1, 1),
    (1, (2, 4, 11), (6, 2, 3), True, 1, "VALID", 2, 2),
    (2, (2, 4, 9, 10), (6, 4, 3, 3), True, 1, 1, 1, 1),
    (2, (2, 4, 9, 10), (6, 4, 3, 3), False, 2, [1, 2], 1, 1),
    (2, (2, 4, 9, 10), (6, 4, 3, 3), True, 1, [0, 1, 2, 1], 1, 1),
    (1, (2, 4, 11), (6, 4, 3), True, 2, [[0, 0], [0, 0], [2, 1]], 1, 1),
    (2, (2, 4, 9, 10), (6, 4, 3, 3), True, 2, "SAME", 1, 1),
    (2, (2, 4, 9, 10), (6, 4, 3, 3), False, 1, "same", 2, 1),
    (2, (2, 4, 9, 10), (6, 4, 3, 2), True, (2, 1), "VALID", 1, 1),
    (2, (2, 4, 9, 10), (6, 2, 3, 3), True, 1, 1, (1, 2), 2),
    (2, (2, 4, 9, 10), (8, 1, 3, 3), False, 2, 1, 1, 4),
    (2, (2, 3, 16, 16), (8, 3, 7, 7), False, 2, 3, 1, 1),
    (3, (1, 2, 5, 6, 7), (4, 2, 3, 3, 3), True, 2, 1, 1, 1),
    (3, (1, 2, 5, 6, 7), (4, 2, 3, 2, 3), False, 1, "SAME", 1, 1),
    (3, (1, 2, 5, 6, 7), (4, 1, 2, 3, 3), True, 1, [1, 0, 0, 1, 2, 1], 1,
     2),
    (3, (1, 2, 5, 6, 7), (4, 2, 3, 3, 3), False, 1,
     [[0, 0], [0, 0], [1, 0], [0, 2], [1, 1]], 1, 1),
]


@pytest.mark.parametrize("case", CONV_CASES,
                         ids=[f"conv{c[0]}d-{i}"
                              for i, c in enumerate(CONV_CASES)])
def test_conv_outputs_and_grads(case):
    n, xs, ws, has_b, stride, padding, dilation, groups = case
    rng = np.random.default_rng(7)
    x_np = rng.standard_normal(xs).astype(np.float32)
    w_np = rng.standard_normal(ws).astype(np.float32) * 0.3
    b_np = rng.standard_normal(ws[0]).astype(np.float32)

    def run(paddle):
        x, w = _leaf(paddle, x_np), _leaf(paddle, w_np)
        b = _leaf(paddle, b_np) if has_b else None
        fn = getattr(paddle.nn.functional, f"conv{n}d")
        y = fn(x, w, b, stride=stride, padding=padding, dilation=dilation,
               groups=groups)
        _loss(paddle, y).backward()
        grads = [x.grad.numpy(), w.grad.numpy()]
        return [y.numpy()] + grads + ([b.grad.numpy()] if has_b else [])

    want, got = _both(run)
    for a, b in zip(want, got):
        _close(a, b)


def test_conv2d_pair_padding_equals_the_flat_form():
    """The [[0, 0], [0, 0], [lo, hi], [lo, hi]] form at n = 2, which the
    reference's parser misreads as four flat values, against the same
    pads given flat."""
    rng = np.random.default_rng(9)
    x = paddle_tpu_torch.to_tensor(rng.standard_normal((2, 3, 7, 8)).astype(
        np.float32))
    w = paddle_tpu_torch.to_tensor(rng.standard_normal((4, 3, 3, 3)).astype(
        np.float32))
    F = paddle_tpu_torch.nn.functional
    a = F.conv2d(x, w, padding=[[0, 0], [0, 0], [1, 0], [2, 1]], stride=2)
    b = F.conv2d(x, w, padding=[1, 0, 2, 1], stride=2)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_conv_layers_match_jax_with_carried_weights():
    rng = np.random.default_rng(3)
    x_np = rng.standard_normal((2, 3, 12, 12)).astype(np.float32)

    def build(paddle):
        nn = paddle.nn
        return nn.Sequential(nn.Conv2D(3, 8, 3, stride=2, padding=1),
                             nn.Conv2D(8, 4, 1, bias_attr=False),
                             nn.Conv2D(4, 4, 3, padding="SAME", groups=2))

    jm, tm = _both(build)
    state = {k: v.numpy() for k, v in jm.state_dict().items()}
    assert [(k, v.shape) for k, v in tm.state_dict().items()] \
        == [(k, v.shape) for k, v in jm.state_dict().items()]
    tm.set_state_dict(state)
    assert tm[1].bias is None
    _close(jm(paddle_tpu.to_tensor(x_np)).numpy(),
           tm(paddle_tpu_torch.to_tensor(x_np)).numpy())


# ==========================================================================
# pooling
# ==========================================================================

# (op, n, x shape, kwargs)
POOL_CASES = [
    ("max", 2, (2, 3, 9, 9), dict(kernel_size=3, stride=2, padding=1)),
    ("max", 2, (2, 3, 8, 8), dict(kernel_size=2, stride=2)),
    ("max", 2, (2, 3, 9, 10), dict(kernel_size=3, stride=2, ceil_mode=True)),
    ("max", 2, (2, 3, 9, 10), dict(kernel_size=3, stride=2, padding=1,
                                   ceil_mode=True)),
    ("max", 2, (2, 3, 9, 10), dict(kernel_size=3, stride=2, padding="SAME")),
    ("max", 2, (2, 3, 9, 10), dict(kernel_size=(2, 3), stride=(2, 1),
                                   padding=[0, 1, 1, 0])),
    ("avg", 2, (2, 3, 9, 9), dict(kernel_size=3, stride=2, padding=1)),
    ("avg", 2, (2, 3, 9, 9), dict(kernel_size=3, stride=2, padding=1,
                                  exclusive=False)),
    ("avg", 2, (2, 3, 9, 10), dict(kernel_size=3, stride=2,
                                   ceil_mode=True)),
    ("avg", 2, (2, 3, 9, 10), dict(kernel_size=3, stride=2, ceil_mode=True,
                                   exclusive=False)),
    ("avg", 2, (2, 3, 9, 10), dict(kernel_size=3, stride=2,
                                   padding="SAME")),
    ("avg", 2, (2, 3, 9, 10), dict(kernel_size=2, stride=2,
                                   padding="SAME", exclusive=False)),
    ("avg", 2, (2, 3, 9, 10), dict(kernel_size=3, stride=2, padding=1,
                                   divisor_override=4)),
    ("max", 1, (2, 3, 11), dict(kernel_size=3, stride=2, padding=1,
                                ceil_mode=True)),
    ("max", 1, (2, 3, 11), dict(kernel_size=2)),
    ("avg", 1, (2, 3, 11), dict(kernel_size=3, stride=2, padding=1,
                                ceil_mode=True)),
    ("avg", 1, (2, 3, 11), dict(kernel_size=3, stride=2, padding=1,
                                exclusive=False)),
    ("max", 3, (1, 2, 5, 6, 7), dict(kernel_size=3, stride=2, padding=1,
                                     ceil_mode=True)),
    ("avg", 3, (1, 2, 5, 6, 7), dict(kernel_size=3, stride=2, padding=1,
                                     ceil_mode=True)),
    ("avg", 3, (1, 2, 5, 6, 7), dict(kernel_size=3, stride=2, padding=1,
                                     exclusive=False)),
]


@pytest.mark.parametrize("case", POOL_CASES,
                         ids=[f"{c[0]}{c[1]}d-{i}"
                              for i, c in enumerate(POOL_CASES)])
def test_pool_outputs_and_grads(case):
    op, n, xs, kw = case
    x_np = np.random.default_rng(11).standard_normal(xs).astype(np.float32)

    def run(paddle):
        x = _leaf(paddle, x_np)
        y = getattr(paddle.nn.functional, f"{op}_pool{n}d")(x, **kw)
        _loss(paddle, y).backward()
        return y.numpy(), x.grad.numpy()

    want, got = _both(run)
    for a, b in zip(want, got):
        _close(a, b)


# (op, n, x shape, output size)
ADAPTIVE_CASES = [
    ("avg", 2, (2, 3, 7, 9), (3, 4)),
    ("avg", 2, (2, 3, 8, 8), (2, 4)),
    ("avg", 2, (2, 3, 7, 7), (1, 1)),
    ("avg", 2, (2, 3, 7, 9), (2, 9)),
    ("avg", 1, (2, 3, 10), 4),
    ("avg", 3, (1, 2, 5, 6, 7), (2, 3, 3)),
    ("max", 2, (2, 3, 7, 9), (3, 4)),
    ("max", 2, (2, 3, 8, 8), 2),
    ("max", 1, (2, 3, 10), 3),
    ("max", 3, (1, 2, 5, 6, 7), (2, 4, 3)),
]


@pytest.mark.parametrize("case", ADAPTIVE_CASES,
                         ids=[f"adaptive_{c[0]}{c[1]}d-{i}"
                              for i, c in enumerate(ADAPTIVE_CASES)])
def test_adaptive_pool_outputs_and_grads(case):
    op, n, xs, out = case
    x_np = np.random.default_rng(13).standard_normal(xs).astype(np.float32)

    def run(paddle):
        x = _leaf(paddle, x_np)
        y = getattr(paddle.nn.functional, f"adaptive_{op}_pool{n}d")(x, out)
        _loss(paddle, y).backward()
        return y.numpy(), x.grad.numpy()

    want, got = _both(run)
    for a, b in zip(want, got):
        _close(a, b)


def test_pool_layers_match_functionals():
    x_np = np.random.default_rng(5).standard_normal((2, 3, 9, 9)).astype(
        np.float32)

    def run(paddle):
        nn = paddle.nn
        x = paddle.to_tensor(x_np)
        return [m(x).numpy() for m in (
            nn.MaxPool2D(3, 2, 1), nn.AvgPool2D(3, 2, 1, ceil_mode=True),
            nn.AdaptiveAvgPool2D((1, 1)), nn.AdaptiveMaxPool2D((3, 2)))]

    for a, b in zip(*_both(run)):
        _close(a, b)
    # None keeps that axis (the reference's parser takes ints only)
    x = paddle_tpu_torch.to_tensor(x_np)
    F = paddle_tpu_torch.nn.functional
    np.testing.assert_array_equal(F.adaptive_avg_pool2d(x, (2, None)).numpy(),
                                  F.adaptive_avg_pool2d(x, (2, 9)).numpy())


def test_max_pool_window_in_padding_is_minus_inf():
    """ceil_mode's extra high pad can leave a window with no input
    element: -inf, as the reference's reduce_window gives."""
    x_np = np.random.default_rng(2).standard_normal((1, 1, 5)).astype(
        np.float32)

    def run(paddle):
        return paddle.nn.functional.max_pool1d(
            paddle.to_tensor(x_np), 2, 2, padding=1, ceil_mode=True).numpy()

    want, got = _both(run)
    assert np.isneginf(want[0, 0, -1]) and np.isneginf(got[0, 0, -1])
    _close(want, got)


# ==========================================================================
# batch norm
# ==========================================================================

@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
def test_batch_norm(training, dtype, data_format):
    rng = np.random.default_rng(17)
    shape = (4, 6, 5, 5) if data_format == "NCHW" else (4, 5, 5, 6)
    x_np = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    w_np = rng.standard_normal(6).astype(np.float32)
    b_np = rng.standard_normal(6).astype(np.float32)
    rm_np = rng.standard_normal(6).astype(np.float32) * 0.1
    rv_np = rng.uniform(0.5, 2.0, 6).astype(np.float32)
    tol = TOL if dtype == "float32" else BF16_TOL

    def run(paddle):
        F = paddle.nn.functional
        x = _leaf(paddle, x_np, dtype)
        w, b = _leaf(paddle, w_np), _leaf(paddle, b_np)
        rm, rv = paddle.to_tensor(rm_np), paddle.to_tensor(rv_np)
        y1 = F.batch_norm(x, rm, rv, w, b, training=training,
                          data_format=data_format)
        y = F.batch_norm(x * 1.5, rm, rv, w, b, training=training,
                         momentum=0.8, data_format=data_format)
        _loss(paddle, y1 + y).backward()
        return (str(y.dtype).split(".")[-1], [y1.numpy(), y.numpy(),
                x.grad.numpy(), w.grad.numpy(), b.grad.numpy()],
                [rm.numpy(), rv.numpy()])

    (jdt, jouts, jstats), (tdt, touts, tstats) = _both(run)
    assert jdt == tdt == dtype
    for a, b in zip(jouts, touts):
        _close(a, b, tol)
    for a, b in zip(jstats, tstats):
        _close(a, b)
    if training:
        assert not np.allclose(tstats[0], 0.0)


def test_batch_norm_layers_train_eval_and_buffers():
    rng = np.random.default_rng(19)
    x_np = rng.standard_normal((3, 4, 6)).astype(np.float32)
    x2_np = rng.standard_normal((4, 4, 3, 3, 2)).astype(np.float32)

    def run(paddle):
        nn = paddle.nn
        bn1, bn3 = nn.BatchNorm1D(4), nn.BatchNorm3D(4)
        fluid = nn.BatchNorm(4, act="relu")
        sync = nn.SyncBatchNorm(4)
        x, x2 = paddle.to_tensor(x_np), paddle.to_tensor(x2_np)
        outs = [bn1(x), bn3(x2), fluid(x2[:, :, 0]), sync(x2[:, :, 0])]
        for m in (bn1, bn3, fluid, sync):
            m.eval()
        outs += [bn1(x), bn3(x2), fluid(x2[:, :, 0]), sync(x2[:, :, 0])]
        names = [(k, tuple(v.shape)) for k, v in bn3.state_dict().items()]
        return ([o.numpy() for o in outs] + [b.numpy() for b in bn3.buffers()],
                names, [k for k, _ in bn1.named_buffers()])

    (jv, jn, jb), (tv, tn, tb) = _both(run)
    assert jn == tn and jb == tb == ["_mean", "_variance"]
    for a, b in zip(jv, tv):
        _close(a, b)


def test_buffers_state_dict_and_device_moves():
    nn = paddle_tpu_torch.nn

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.bn = nn.BatchNorm2D(3)
            self.register_buffer("step", paddle_tpu_torch.to_tensor([0.0]))
            self.register_buffer("scratch", paddle_tpu_torch.to_tensor(
                [1.0]), persistable=False)

    net = Net()
    sd = net.state_dict()
    assert list(sd) == ["bn.weight", "bn.bias", "step", "bn._mean",
                        "bn._variance"]
    assert [k for k, _ in net.named_buffers()] == [
        "step", "scratch", "bn._mean", "bn._variance"]
    state = {k: np.full(v.shape, 2.0, np.float32) for k, v in sd.items()}
    missing, unexpected = net.set_state_dict({**state, "extra": 1})
    assert missing == [] and unexpected == ["extra"]
    assert net.bn._variance.numpy().tolist() == [2.0] * 3
    assert net.bn._mean.stop_gradient
    net.to(dtype="bfloat16")
    assert net.bn._mean.dtype == torch.bfloat16
    assert net.bn.weight.dtype == torch.bfloat16 and not \
        net.bn.weight.stop_gradient
    net.step = paddle_tpu_torch.to_tensor([5.0])
    assert net.state_dict()["step"].numpy().tolist() == [5.0]
    del net.scratch
    assert [k for k, _ in net.named_buffers()][:1] == ["step"]


def test_sync_batch_norm_converts_and_keeps_buffers():
    nn = paddle_tpu_torch.nn
    model = nn.Sequential(nn.Conv2D(3, 4, 3), nn.BatchNorm2D(4))
    model[1]._mean.set_value(np.arange(4, dtype=np.float32))
    sync = nn.SyncBatchNorm.convert_sync_batchnorm(model)
    assert isinstance(sync[1], nn.SyncBatchNorm)
    assert sync[1]._mean is model[1]._mean
    assert sync[1].weight is model[1].weight


# ==========================================================================
# flatten and the Kaiming initializers
# ==========================================================================

@pytest.mark.parametrize("start,stop", [(0, -1), (1, -1), (1, 2), (-2, -1),
                                        (2, 2)])
def test_flatten(start, stop):
    x_np = np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5)

    def run(paddle):
        x = paddle.to_tensor(x_np)
        a = paddle.flatten(x, start, stop)
        b = x.flatten(start_axis=start, stop_axis=stop)
        return a.shape, a.numpy(), b.numpy()

    (js, ja, jb), (ts, ta, tb) = _both(run)
    assert js == ts
    np.testing.assert_array_equal(ja, ta)
    np.testing.assert_array_equal(jb, tb)


def test_flatten_scalar_and_grad():
    x = paddle_tpu_torch.to_tensor(np.float32(3.0))
    assert paddle_tpu_torch.flatten(x).shape == [1]
    y = _leaf(paddle_tpu_torch, np.ones((2, 3, 4), np.float32))
    (paddle_tpu_torch.flatten(y, 1) * 2.0).sum().backward()
    assert y.grad.numpy().tolist() == np.full((2, 3, 4), 2.0).tolist()


@pytest.mark.parametrize("cls,kw", [("KaimingUniform", {}),
                                    ("KaimingUniform", {"fan_in": 50}),
                                    ("KaimingNormal", {}),
                                    ("KaimingNormal",
                                     {"nonlinearity": "leaky_relu",
                                      "negative_slope": 0.2})])
def test_kaiming_bounds_and_spread(cls, kw):
    shape = (64, 32, 3, 3)
    fan_in = kw.get("fan_in", 32 * 9)
    gain = (math.sqrt(2.0 / (1 + 0.2 ** 2)) if "negative_slope" in kw
            else math.sqrt(2.0))
    std = gain / math.sqrt(fan_in)       # uniform: limit / sqrt(3) = std

    def draw(paddle):
        paddle.seed(0)
        init = getattr(paddle.nn.initializer, cls)(**kw)
        attr = paddle.ParamAttr(initializer=init)
        return paddle.nn.Conv2D(32, 64, 3, weight_attr=attr).weight.numpy()

    for w in _both(draw):
        assert w.shape == shape
        assert abs(w.std() - std) < 0.03 * std
        assert abs(w.mean()) < 0.03 * std
        if cls == "KaimingUniform":
            limit = gain * math.sqrt(3.0 / fan_in)
            assert np.abs(w).max() <= limit
            assert np.abs(w).max() > 0.99 * limit


def test_conv_default_init_is_kaiming_uniform_over_fan_in():
    paddle_tpu_torch.seed(1)
    conv = paddle_tpu_torch.nn.Conv2D(8, 16, 3, groups=2)
    limit = math.sqrt(2.0) * math.sqrt(3.0 / (4 * 9))
    w = conv.weight.numpy()
    assert np.abs(w).max() <= limit and np.abs(w).max() > 0.95 * limit
    assert conv.bias.numpy().tolist() == [0.0] * 16
