"""The port's random sampling (``tensor/random.py``) and ``autograd``
(``PyLayer``) on the CPU.

The random values are not compared with the JAX package's (the
generators differ): shapes, dtypes and ranges; means and variances on
10⁵ draws within 5 standard errors of the distribution's (the variance's
standard error from the fourth central moment); ``randperm`` a
permutation and ``multinomial`` without replacement distinct; the same
draws after ``paddle.seed``; ``uniform(seed=s)`` its own stream.
``PyLayer``'s forward and backward against the JAX package's ``PyLayer``
(one output and two, a non-Tensor argument, a gradient left None).
"""
import math

import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch as paddle
from paddle_tpu_torch import device as tdevice

N = 10**5
SE = 5.0


@pytest.fixture(autouse=True)
def on_cpu():
    old = tdevice._current[0]
    paddle.set_device("cpu")
    yield
    tdevice._current[0] = old


# name: (draw, dtype, mean, variance, fourth central moment, range)
DISTS = {
    "rand": (lambda: paddle.rand([N]), "float32", 0.5, 1 / 12, 1 / 80,
             (0.0, 1.0)),
    "randn": (lambda: paddle.randn([N]), "float32", 0.0, 1.0, 3.0, None),
    "standard_normal": (lambda: paddle.standard_normal([N], "float64"),
                        "float64", 0.0, 1.0, 3.0, None),
    "uniform": (lambda: paddle.uniform([N], min=-2.0, max=3.0), "float32",
                0.5, 25 / 12, 625 / 80, (-2.0, 3.0)),
    "normal": (lambda: paddle.normal(1.0, 2.0, [N]), "float32", 1.0, 4.0,
               48.0, None),
    "normal_tensors": (lambda: paddle.normal(
        paddle.full([N], 1.0), paddle.full([N], 2.0)), "float32", 1.0, 4.0,
        48.0, None),
    "randint": (lambda: paddle.randint(0, 10, [N]), "int64", 4.5, 8.25,
                120.8625, (0, 9)),
    "randint_high_only": (lambda: paddle.randint(10, shape=[N],
                                                 dtype="int32"),
                          "int32", 4.5, 8.25, 120.8625, (0, 9)),
    "randint_like": (lambda: paddle.randint_like(paddle.zeros([N]), 0, 10),
                     "int64", 4.5, 8.25, 120.8625, (0, 9)),
    "bernoulli": (lambda: paddle.bernoulli(paddle.full([N], 0.3)),
                  "float32", 0.3, 0.21, 0.21 * (1 - 3 * 0.21), (0, 1)),
    "poisson": (lambda: paddle.poisson(paddle.full([N], 4.0)), "float32",
                4.0, 4.0, 52.0, (0, None)),
    "uniform_": (lambda: paddle.uniform_(paddle.zeros([N]), 0.0, 1.0),
                 "float32", 0.5, 1 / 12, 1 / 80, (0.0, 1.0)),
    "normal_": (lambda: paddle.normal_(paddle.zeros([N]), 2.0, 0.5),
                "float32", 2.0, 0.25, 3 * 0.0625, None),
    "exponential_": (lambda: paddle.exponential_(paddle.zeros([N]), 2.0),
                     "float32", 0.5, 0.25, 9 / 16, (0.0, None)),
}


@pytest.mark.parametrize("name", sorted(DISTS))
def test_moments_dtype_range_and_reseeding(name):
    draw, dtype, mu, var, m4, rng = DISTS[name]
    paddle.seed(11)
    x = draw()
    paddle.seed(11)
    y = draw()
    assert x.shape == [N] and str(x.dtype).endswith(dtype)
    np.testing.assert_array_equal(x.numpy(), y.numpy())
    v = x.numpy().astype(np.float64)
    if rng is not None:
        assert v.min() >= rng[0]
        if rng[1] is not None:
            assert v.max() <= rng[1]
    assert abs(v.mean() - mu) <= SE * math.sqrt(var / N)
    assert abs(v.var() - var) <= SE * math.sqrt((m4 - var * var) / N)
    paddle.seed(12)
    assert not np.array_equal(draw().numpy(), v.astype(x.numpy().dtype))


def test_shapes_from_tensors_and_dtypes():
    assert paddle.rand(paddle.to_tensor([2, 3])).shape == [2, 3]
    assert paddle.randn([2, paddle.to_tensor(4)]).shape == [2, 4]
    assert str(paddle.rand([2], "float64").dtype) == "torch.float64"
    assert str(paddle.randperm(5, "int32").dtype) == "torch.int32"
    assert paddle.normal(shape=[3, 2]).shape == [3, 2]


def test_randperm_and_multinomial_without_replacement():
    paddle.seed(3)
    perm = paddle.randperm(1000).numpy()
    np.testing.assert_array_equal(np.sort(perm), np.arange(1000))
    w = paddle.to_tensor(np.random.default_rng(0).uniform(
        0.1, 1.0, (50, 40)).astype("float32"))
    m = paddle.multinomial(w, 25).numpy()
    assert m.shape == (50, 25) and m.dtype == np.int64
    assert all(len(set(r)) == 25 for r in m)
    one = paddle.multinomial(paddle.to_tensor(np.array([0.0, 1.0, 0.0],
                                                       "float32")), 1)
    assert one.numpy().tolist() == [1]


def test_multinomial_frequencies():
    p = np.array([0.1, 0.2, 0.3, 0.4])
    paddle.seed(4)
    draws = paddle.multinomial(paddle.to_tensor(p.astype("float32")), N,
                               replacement=True).numpy()
    freq = np.bincount(draws, minlength=4) / N
    assert np.all(np.abs(freq - p) <= SE * np.sqrt(p * (1 - p) / N))


def test_uniform_with_its_own_seed():
    a = paddle.uniform([100], seed=7)
    paddle.seed(1)
    b = paddle.uniform([100], seed=7)
    c = paddle.uniform([100])
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert not np.array_equal(a.numpy(), c.numpy())


def _scaled_tanh(pkg):
    class ScaledTanh(pkg.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, scale):
            y = pkg.tanh(x) * scale
            ctx.save_for_backward(y)
            ctx.scale = scale
            return y

        @staticmethod
        def backward(ctx, dy):
            y, = ctx.saved_tensor
            return dy * (ctx.scale - y * y / ctx.scale)
    return ScaledTanh


def _split_pair(pkg):
    class Pair(pkg.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, w):
            ctx.save_for_backward(x, w)
            return x * w, x + w

        @staticmethod
        def backward(ctx, da, db):
            x, w = ctx.saved_tensor
            return da * w + db, None
    return Pair


def _pylayer_run(pkg, make, two):
    rng = np.random.default_rng(2)
    x = pkg.to_tensor(rng.normal(size=(4, 5)).astype("float32"),
                      stop_gradient=False)
    w = pkg.to_tensor(rng.normal(size=(4, 5)).astype("float32"),
                      stop_gradient=False)
    g = pkg.to_tensor(rng.normal(size=(4, 5)).astype("float32"))
    if two:
        a, b = make(pkg).apply(x, w)
        ((a * g).sum() + (b * b).sum()).backward()
        return [a.numpy(), b.numpy(), x.grad.numpy()], w.grad
    y = make(pkg).apply(x, 1.5)
    (y * g).sum().backward()
    return [y.numpy(), x.grad.numpy()], None


@pytest.mark.parametrize("two", [False, True])
def test_pylayer_matches_jax(two):
    make = _split_pair if two else _scaled_tanh
    want, _ = _pylayer_run(paddle_tpu, make, two)
    got, w_grad = _pylayer_run(paddle, make, two)
    for a, b in zip(want, got):
        np.testing.assert_allclose(np.asarray(a), b, rtol=1e-5, atol=1e-6)
    assert w_grad is None


def test_autograd_namespace():
    from paddle_tpu_torch import autograd

    x = paddle.to_tensor(np.array([1.0, 2.0], "float32"),
                         stop_gradient=False)
    y = (x * x).sum()
    g, = autograd.grad(y, x)
    np.testing.assert_allclose(g.numpy(), [2.0, 4.0])
    with autograd.no_grad():
        assert (x * 2).stop_gradient
    autograd.backward((x * 3).sum())
    np.testing.assert_allclose(x.grad.numpy(), [3.0, 3.0])
    assert {"PyLayer", "PyLayerContext", "enable_grad"} <= set(
        autograd.__all__)
