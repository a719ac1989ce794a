"""The port's activations (``nn/functional/activation.py``) and their
layers against paddle_tpu's, on the CPU, from seeded numpy inputs.

- every deterministic functional, forward (f32 rtol 1e-5, atol 1e-6:
  the same elementwise formula on two backends) and, for the
  differentiable ones, the gradient of ``sum(y · w)`` for a fixed w
  (rtol 1e-5, atol 1e-5 of the largest gradient: each backend
  differentiates the formula in its own order, and a small element's
  rounding is the largest's); the inputs keep |x| away from each kink
  (0, ±0.5, ±1, ±3, 6) so the two sides' subgradients cannot differ;
- the layers of ``nn/layer/activation.py`` with their default and
  non-default arguments (``PReLU``'s weight carried across);
- the random ones by shape and statistics: ``rrelu`` in training draws
  slopes in [lower, upper] with the right mean and is the mean slope in
  eval; ``gumbel_softmax`` rows sum to 1, ``hard`` gives one-hots whose
  argmax frequencies follow softmax(x), and its gradient is the soft
  one's;
- the in-place forms: the same values, a non-leaf keeps its graph, a
  leaf that needs a gradient is refused as the reference refuses it.
"""
import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu_torch import device as tdevice
from torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)

RTOL, ATOL = 1e-5, 1e-6
GRAD_ATOL = 1e-5          # of the largest gradient


@pytest.fixture(autouse=True)
def on_cpu():
    old = tdevice._current[0]
    paddle_tpu_torch.set_device("cpu")
    yield
    tdevice._current[0] = old


def _x(shape=(4, 6, 5), seed=0, lo=0.05):
    """Normal values scaled by 3, each kept ``lo`` away from the kinks."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype("float32") * 3
    for k in (0.0, 0.5, 1.0, 3.0, 6.0):
        for s in (1, -1):
            near = np.abs(x - s * k) < lo
            x[near] += lo * 2
    return x


def _run(paddle, fn, x, w, grad):
    t = paddle.to_tensor(x, stop_gradient=not grad)
    y = fn(paddle, t)
    if not grad:
        return y.numpy(), None
    (y * paddle.to_tensor(w)).sum().backward()
    return y.numpy(), t.grad.numpy()


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(b, np.float64),
                               np.asarray(a, np.float64), rtol=rtol,
                               atol=atol)


# name -> (call on a package, differentiable)
FUNCS = {
    "relu": (lambda p, x: p.nn.functional.relu(x), True),
    "relu6": (lambda p, x: p.nn.functional.relu6(x), True),
    "gelu": (lambda p, x: p.nn.functional.gelu(x), True),
    "gelu_tanh": (lambda p, x: p.nn.functional.gelu(x, approximate=True),
                  True),
    "sigmoid": (lambda p, x: p.nn.functional.sigmoid(x), True),
    "tanh": (lambda p, x: p.nn.functional.tanh(x), True),
    "softmax": (lambda p, x: p.nn.functional.softmax(x, axis=1), True),
    "log_softmax": (lambda p, x: p.nn.functional.log_softmax(x), True),
    "leaky_relu": (lambda p, x: p.nn.functional.leaky_relu(x, 0.2), True),
    "elu": (lambda p, x: p.nn.functional.elu(x, 0.7), True),
    "selu": (lambda p, x: p.nn.functional.selu(x), True),
    "celu": (lambda p, x: p.nn.functional.celu(x, 1.3), True),
    "silu": (lambda p, x: p.nn.functional.silu(x), True),
    "swish": (lambda p, x: p.nn.functional.swish(x), True),
    "mish": (lambda p, x: p.nn.functional.mish(x), True),
    "hardshrink": (lambda p, x: p.nn.functional.hardshrink(x, 1.0), True),
    "hardsigmoid": (lambda p, x: p.nn.functional.hardsigmoid(x), True),
    "hardswish": (lambda p, x: p.nn.functional.hardswish(x), True),
    "hardtanh": (lambda p, x: p.nn.functional.hardtanh(x, -3.0, 3.0), True),
    "softplus": (lambda p, x: p.nn.functional.softplus(x, 2.0, 5.0), True),
    "softshrink": (lambda p, x: p.nn.functional.softshrink(x, 0.5), True),
    "softsign": (lambda p, x: p.nn.functional.softsign(x), True),
    "tanhshrink": (lambda p, x: p.nn.functional.tanhshrink(x), True),
    "thresholded_relu": (lambda p, x: p.nn.functional.thresholded_relu(x),
                         True),
    "maxout": (lambda p, x: p.nn.functional.maxout(x, 3, axis=1), True),
    "glu": (lambda p, x: p.nn.functional.glu(x, axis=1), True),
    "log_sigmoid": (lambda p, x: p.nn.functional.log_sigmoid(x), True),
    "rrelu_eval": (lambda p, x: p.nn.functional.rrelu(x, training=False),
                   True),
}


@pytest.mark.parametrize("name", sorted(FUNCS))
def test_functional_and_gradient_match_jax(name):
    fn, diff = FUNCS[name]
    x = _x()
    w = np.random.default_rng(1).normal(size=fn(
        paddle_tpu_torch, paddle_tpu_torch.to_tensor(x)).shape).astype(
            "float32")
    (yj, gj), (yt, gt) = (_run(p, fn, x, w, diff)
                          for p in (paddle_tpu, paddle_tpu_torch))
    assert yt.dtype == np.float32
    _close(yj, yt)
    if diff:
        _close(gj, gt, atol=GRAD_ATOL * np.abs(gj).max())


@pytest.mark.parametrize("mode", ["scalar", "channel", "element"])
def test_prelu_weight_modes_match_jax(mode):
    x = _x((2, 3, 4))
    wshape = {"scalar": (1,), "channel": (3,), "element": (3, 4)}[mode]
    wv = np.random.default_rng(2).uniform(0.05, 0.5, wshape).astype(
        "float32")
    outs = []
    for p in (paddle_tpu, paddle_tpu_torch):
        t = p.to_tensor(x, stop_gradient=False)
        wt = p.to_tensor(wv, stop_gradient=False)
        y = p.nn.functional.prelu(t, wt)
        y.sum().backward()
        outs.append((y.numpy(), t.grad.numpy(), wt.grad.numpy()))
    for a, b in zip(*outs):
        _close(a, b, atol=GRAD_ATOL * np.abs(a).max())


LAYERS = {
    "ReLU": (), "ReLU6": (), "GELU": (True,), "Sigmoid": (), "Tanh": (),
    "Softmax": (1,), "LogSoftmax": (), "LeakyReLU": (0.3,), "ELU": (0.5,),
    "SELU": (), "CELU": (0.8,), "Silu": (), "Swish": (), "Mish": (),
    "Hardshrink": (0.7,), "Hardsigmoid": (), "Hardswish": (),
    "Hardtanh": (-2.0, 2.0), "Softplus": (1.5, 10.0), "Softshrink": (0.2,),
    "Softsign": (), "Tanhshrink": (), "ThresholdedReLU": (0.8,),
    "Maxout": (2,), "LogSigmoid": (), "GLU": (),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_jax(name):
    x = _x((2, 6, 4))
    outs = [getattr(p.nn, name)(*LAYERS[name])(p.to_tensor(x)).numpy()
            for p in (paddle_tpu, paddle_tpu_torch)]
    _close(*outs)


def test_prelu_layer_with_carried_weight_matches_jax():
    x = _x((2, 6, 4))
    layers = [p.nn.PReLU(num_parameters=6, init=0.1)
              for p in (paddle_tpu, paddle_tpu_torch)]
    w = np.linspace(0.05, 0.6, 6).astype("float32")
    for layer in layers:
        layer.set_state_dict({"weight": w})
    outs = [layer(p.to_tensor(x)).numpy()
            for p, layer in zip((paddle_tpu, paddle_tpu_torch), layers)]
    _close(*outs)
    assert list(layers[1].state_dict()) == list(layers[0].state_dict())


def test_rrelu_training_draws_slopes_in_range():
    tp = paddle_tpu_torch
    tp.seed(0)
    x = -np.abs(_x((200, 500))) - 0.1
    y = tp.nn.functional.rrelu(tp.to_tensor(x), 0.1, 0.3, training=True)
    slope = (y.numpy() / x)
    assert slope.min() >= 0.1 and slope.max() <= 0.3
    assert abs(slope.mean() - 0.2) < 2e-3
    assert abs(slope.std() - 0.2 / np.sqrt(12)) < 2e-3
    pos = np.abs(_x((3, 4)))
    np.testing.assert_array_equal(
        tp.nn.functional.rrelu(tp.to_tensor(pos)).numpy(), pos)
    layer = tp.nn.RReLU(0.1, 0.3)
    layer.eval()
    _close(x * 0.2, layer(tp.to_tensor(x)).numpy())


def test_gumbel_softmax_statistics():
    tp = paddle_tpu_torch
    tp.seed(1)
    logits = np.log(np.array([[0.5, 0.3, 0.15, 0.05]], "float32"))
    x = np.repeat(logits, 20000, axis=0)
    soft = tp.nn.functional.gumbel_softmax(tp.to_tensor(x), temperature=0.5)
    assert soft.shape == [20000, 4]
    _close(np.ones(20000), soft.numpy().sum(-1), rtol=1e-5)
    hard = tp.nn.functional.gumbel_softmax(tp.to_tensor(x), hard=True)
    h = hard.numpy()
    assert set(np.unique(h)) == {0.0, 1.0}
    np.testing.assert_array_equal(h.sum(-1), np.ones(20000))
    freq = h.mean(0)
    np.testing.assert_allclose(freq, np.exp(logits[0]), atol=0.015)
    t = tp.to_tensor(x[:4], stop_gradient=False)
    y = tp.nn.functional.gumbel_softmax(t, hard=True)
    (y * tp.to_tensor(np.arange(16, dtype="float32").reshape(4, 4))
     ).sum().backward()
    assert t.grad is not None and np.abs(t.grad.numpy()).sum() > 0


@pytest.mark.parametrize("name,kw", [("relu_", {}), ("elu_", {"alpha": 0.5}),
                                     ("softmax_", {"axis": 0}),
                                     ("tanh_", {})])
def test_inplace_forms_match_jax_and_keep_the_graph(name, kw):
    x = _x((3, 5))
    outs = []
    for p in (paddle_tpu, paddle_tpu_torch):
        leaf = p.to_tensor(x, stop_gradient=False)
        mid = leaf * 2.0
        out = getattr(p.nn.functional, name)(mid, **kw)
        assert out is mid
        (mid * p.to_tensor(np.arange(15, dtype="float32").reshape(3, 5))
         ).sum().backward()
        outs.append((mid.numpy(), leaf.grad.numpy()))
        with pytest.raises(ValueError):
            getattr(p.nn.functional, name)(leaf, **kw)
    for a, b in zip(*outs):
        _close(a, b, atol=GRAD_ATOL * np.abs(a).max())
