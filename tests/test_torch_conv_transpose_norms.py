"""The port's transposed convolutions, pooling masks and the other norms
against paddle_tpu's and against plain loops, on the CPU:

- ``conv1d/2d/3d_transpose`` with groups, dilation, ``output_padding``
  and Paddle's padding forms against the JAX package (values 1e-5 of the
  largest, gradients 1e-4); ``output_size`` (dropped by the JAX package)
  against ``torch.nn.ConvTranspose*d``'s own output-size rule; ``"SAME"``
  (Paddle's pads, not the JAX package's) against the explicit pads;
  the layers with the JAX weights;
- pooling masks exactly: ``max_pool2d`` against the JAX package's
  ``_max_pool_indices``; with ``ceil_mode``, in 1-d and 3-d and the
  adaptive pools against a plain loop over Paddle's windows (the first
  maximum in window order, flat over the unpadded input; -1 for a window
  over padding alone); ``max_unpool2d`` exactly against the JAX package;
- ``instance_norm``, ``group_norm``, ``local_response_norm``, their
  layers and ``SpectralNorm`` (the JAX layer's u and v carried across)
  within 1e-5 with gradients; the arguments the port refuses.
"""
import itertools
import math

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu_torch import device as tdevice

TOL, GRAD_TOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def on_cpu():
    old = tdevice._current[0]
    paddle_tpu_torch.set_device("cpu")
    yield
    tdevice._current[0] = old


def _close(want, got, tol=TOL):
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    assert want.shape == got.shape, (want.shape, got.shape)
    err = np.abs(want - got).max()
    assert err <= tol * max(np.abs(want).max(), 1.0), err


def _both(fn, arrays, grad=True, seed=0):
    """fn(paddle, *tensors) on both packages: outputs and the input
    gradients of a weighted sum of the first output."""
    outs = []
    w = None
    for paddle in (paddle_tpu, paddle_tpu_torch):
        ts = [paddle.to_tensor(a, stop_gradient=not (grad and a.dtype.kind
                                                     == "f"))
              for a in arrays]
        out = fn(paddle, *ts)
        out = list(out) if isinstance(out, (tuple, list)) else [out]
        grads = []
        if grad:
            if w is None:
                w = np.random.default_rng(seed).normal(
                    size=out[0].shape).astype("float32")
            (out[0] * paddle.to_tensor(w)).sum().backward()
            grads = [None if t.grad is None else t.grad.numpy()
                     for t in ts if not t.stop_gradient]
        outs.append(([np.asarray(o.numpy()) for o in out], grads))
    return outs


def _check(fn, arrays, grad=True):
    (wo, wg), (to, tg) = _both(fn, arrays, grad)
    for a, b in zip(wo, to):
        if a.dtype.kind in "iub":
            np.testing.assert_array_equal(a, b)
        else:
            _close(a, b)
    assert len(wg) == len(tg)
    for a, b in zip(wg, tg):
        assert (a is None) == (b is None)
        if a is not None:
            _close(a, b, GRAD_TOL)


RNG = np.random.default_rng(17)


def _f(*shape):
    return RNG.normal(size=shape).astype("float32")


CT_CASES = {
    "1d_int_pad": (1, dict(stride=2, padding=1), (2, 4, 9), (4, 3, 3)),
    "1d_groups_dilation": (1, dict(stride=3, padding=[1, 2], groups=2,
                                   dilation=2), (2, 4, 9), (4, 3, 3)),
    "2d_output_padding": (2, dict(stride=2, padding=1, output_padding=1),
                          (2, 4, 6, 5), (4, 3, 3, 3)),
    "2d_four_pads": (2, dict(stride=2, padding=[0, 1, 2, 1]), (2, 4, 6, 5),
                     (4, 3, 3, 3)),
    "3d_pairs": (3, dict(stride=[2, 1, 2], padding=[[0, 0], [0, 0], [1, 2],
                                                     [0, 1], [1, 0]]),
                 (1, 4, 4, 5, 3), (4, 3, 3, 2, 2)),
    "2d_valid_groups": (2, dict(stride=2, padding="VALID", groups=4),
                        (2, 4, 6, 5), (4, 2, 3, 3)),
    "2d_big_output_padding": (2, dict(stride=3, padding=1, dilation=2,
                                      output_padding=2), (2, 4, 5, 5),
                              (4, 3, 2, 2)),
    "3d": (3, dict(stride=2, padding=1, output_padding=1, groups=2),
           (1, 4, 4, 3, 5), (4, 3, 3, 3, 3)),
}


@pytest.mark.parametrize("name", sorted(CT_CASES))
def test_conv_transpose_matches_jax(name):
    n, kw, xs, ws = CT_CASES[name]
    fn_name = f"conv{n}d_transpose"
    _check(lambda p, x, w, b: getattr(p.nn.functional, fn_name)(
        x, w, b, **kw), [_f(*xs), _f(*ws), _f(ws[1] * kw.get("groups", 1))])


@pytest.mark.parametrize("n", [1, 2, 3])
def test_conv_transpose_output_size_is_torchs_rule(n):
    cin, cout, k, s, p, d, g = 4, 6, 3, 3, 1, 2, 2
    x = _f(2, cin, *([5] * n))
    w = _f(cin, cout // g, *([k] * n))
    base = (5 - 1) * s - 2 * p + d * (k - 1) + 1
    for extra in range(s):
        size = [base + extra] * n
        got = getattr(paddle_tpu_torch.nn.functional, f"conv{n}d_transpose")(
            paddle_tpu_torch.to_tensor(x), paddle_tpu_torch.to_tensor(w),
            stride=s, padding=p, dilation=d, groups=g, output_size=size)
        m = getattr(torch.nn, f"ConvTranspose{n}d")(
            cin, cout, k, stride=s, padding=p, dilation=d, groups=g,
            bias=False)
        m.weight.data = torch.from_numpy(w)
        want = m(torch.from_numpy(x), output_size=size).detach().numpy()
        assert list(got.shape[2:]) == size
        _close(want, got.numpy())
    with pytest.raises(ValueError):
        paddle_tpu_torch.nn.functional.conv1d_transpose(
            paddle_tpu_torch.to_tensor(_f(2, 4, 5)),
            paddle_tpu_torch.to_tensor(_f(4, 3, 3)), stride=2,
            output_size=[20])


def test_conv_transpose_pair_padding_at_2d_is_the_flat_form():
    """[[0, 0], [0, 0], [lo, hi], ...] at n = 2 (the reference's parser
    reads it as the flat form and fails): the flat form's result."""
    F = paddle_tpu_torch.nn.functional
    x, w = (paddle_tpu_torch.to_tensor(a) for a in (_f(2, 4, 6, 5),
                                                    _f(4, 3, 3, 2)))
    pairs = F.conv2d_transpose(x, w, stride=[2, 1],
                               padding=[[0, 0], [0, 0], [1, 2], [0, 1]])
    flat = F.conv2d_transpose(x, w, stride=[2, 1], padding=[1, 2, 0, 1])
    np.testing.assert_array_equal(pairs.numpy(), flat.numpy())


def test_conv_transpose_same_takes_paddles_pads():
    """Paddle's "SAME": the pads of a forward "SAME" convolution over
    the input (the JAX package pads min(k - 1, k // 2) at each end)."""
    F = paddle_tpu_torch.nn.functional
    x, w = _f(2, 4, 7, 6), _f(4, 3, 3, 4)
    got = F.conv2d_transpose(paddle_tpu_torch.to_tensor(x),
                             paddle_tpu_torch.to_tensor(w), stride=2,
                             padding="SAME")
    pads = []
    for size, k in zip((7, 6), (3, 4)):
        total = max((math.ceil(size / 2) - 1) * 2 + k - size, 0)
        pads += [total // 2, total - total // 2]
    want = F.conv2d_transpose(paddle_tpu_torch.to_tensor(x),
                              paddle_tpu_torch.to_tensor(w), stride=2,
                              padding=pads)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert got.shape == [2, 3, 13, 12]


@pytest.mark.parametrize("n", [1, 2, 3])
def test_conv_transpose_layers_match_jax(n):
    layers = [getattr(p.nn, f"Conv{n}DTranspose")(4, 6, 3, stride=2,
                                                   padding=1, groups=2)
              for p in (paddle_tpu, paddle_tpu_torch)]
    state = {k: v.numpy() for k, v in layers[0].state_dict().items()}
    assert not any(layers[1].set_state_dict(state))
    x = _f(2, 4, *([5] * n))
    outs = [lay(p.to_tensor(x)).numpy() for p, lay in
            zip((paddle_tpu, paddle_tpu_torch), layers)]
    _close(*outs)
    assert list(layers[1].weight.shape) == [4, 3] + [3] * n


def test_channels_last_and_running_stats_raise():
    F = paddle_tpu_torch.nn.functional
    x = paddle_tpu_torch.to_tensor(_f(2, 5, 5, 4))
    with pytest.raises(NotImplementedError):
        F.conv2d_transpose(x, paddle_tpu_torch.to_tensor(_f(4, 3, 3, 3)),
                           data_format="NHWC")
    with pytest.raises(NotImplementedError):
        F.max_pool2d(x, 2, return_mask=True, data_format="NHWC")
    with pytest.raises(NotImplementedError):
        F.group_norm(x, 2, data_format="NHWC")
    with pytest.raises(NotImplementedError):
        F.instance_norm(x, running_mean=paddle_tpu_torch.zeros([5]),
                        running_var=paddle_tpu_torch.ones([5]))
    with pytest.raises(NotImplementedError):
        F.instance_norm(x, use_input_stats=False)


# -- pooling masks ------------------------------------------------------------

def _plain_max_pool(x, k, s, pads, ceil_mode):
    """Paddle's max pool with index over a plain loop: windows from
    o·s − lo, clipped to the input; the first maximum in window order;
    the flat index over the unpadded spatial axes, −1 for an empty
    window."""
    n = len(k)
    sizes = x.shape[2:]
    outs = []
    for size, kk, ss, (lo, hi) in zip(sizes, k, s, pads):
        span = size + lo + hi - kk
        outs.append((-(-span // ss) if ceil_mode else span // ss) + 1)
    vals = np.full(x.shape[:2] + tuple(outs), -np.inf, np.float32)
    mask = np.full(x.shape[:2] + tuple(outs), -1, np.int64)
    for o in itertools.product(*[range(v) for v in outs]):
        lo_ = [max(o[d] * s[d] - pads[d][0], 0) for d in range(n)]
        hi_ = [min(o[d] * s[d] - pads[d][0] + k[d], sizes[d])
               for d in range(n)]
        for pos in itertools.product(*[range(a, b) for a, b in zip(lo_,
                                                                  hi_)]):
            v = x[(slice(None), slice(None)) + pos]
            flat = int(np.ravel_multi_index(pos, sizes))
            better = v > vals[(slice(None), slice(None)) + o]
            vals[(slice(None), slice(None)) + o] = np.where(
                better, v, vals[(slice(None), slice(None)) + o])
            mask[(slice(None), slice(None)) + o] = np.where(
                better, flat, mask[(slice(None), slice(None)) + o])
    return vals, mask


def test_max_pool2d_mask_equals_jax():
    x = _f(2, 3, 9, 8)
    F = paddle_tpu.nn.functional
    want_v, want_m = F.max_pool2d(paddle_tpu.to_tensor(x), 3, 2, 1,
                                  return_mask=True)
    got_v, got_m = paddle_tpu_torch.nn.functional.max_pool2d(
        paddle_tpu_torch.to_tensor(x), 3, 2, 1, return_mask=True)
    np.testing.assert_array_equal(np.asarray(want_m.numpy()), got_m.numpy())
    np.testing.assert_array_equal(np.asarray(want_v.numpy()), got_v.numpy())
    assert got_m.dtype == torch.int32


POOL_CASES = {
    "1d_ceil": (1, (2, 3, 11), (3,), (2,), [(1, 1)], True),
    "2d_ceil": (2, (2, 3, 9, 8), (3, 2), (2, 3), [(0, 0), (1, 1)], True),
    "2d_ceil_empty_window": (2, (1, 2, 5, 5), (1, 1), (3, 3),
                             [(0, 0), (0, 0)], True),
    "3d": (3, (1, 2, 5, 6, 7), (2, 3, 2), (2, 2, 3), [(1, 1), (0, 0),
                                                       (1, 1)], False),
    "3d_ceil": (3, (1, 2, 5, 6, 7), (2, 2, 2), (2, 2, 2),
                [(0, 0)] * 3, True),
}


@pytest.mark.parametrize("name", sorted(POOL_CASES))
def test_max_pool_mask_equals_the_plain_loop(name):
    n, shape, k, s, pads, ceil = POOL_CASES[name]
    x = _f(*shape)
    want_v, want_m = _plain_max_pool(x, k, s, pads, ceil)
    fn = getattr(paddle_tpu_torch.nn.functional, f"max_pool{n}d")
    padding = [p for lo_hi in pads for p in lo_hi]
    got_v, got_m = fn(paddle_tpu_torch.to_tensor(x), list(k), list(s),
                      padding, ceil_mode=ceil, return_mask=True)
    np.testing.assert_array_equal(got_m.numpy(), want_m)
    got = got_v.numpy()
    np.testing.assert_array_equal(got[want_m >= 0], want_v[want_m >= 0])
    if name == "2d_ceil_empty_window":
        assert (want_m == -1).any()


@pytest.mark.parametrize("n", [1, 2, 3])
def test_adaptive_max_pool_mask_equals_the_plain_loop(n):
    x = _f(2, 3, *([7, 5, 6][:n]))
    out = [3, 4, 2][:n]
    got_v, got_m = getattr(paddle_tpu_torch.nn.functional,
                           f"adaptive_max_pool{n}d")(
        paddle_tpu_torch.to_tensor(x), out, return_mask=True)
    sizes = x.shape[2:]
    want = np.zeros(x.shape[:2] + tuple(out), np.int64)
    for o in itertools.product(*[range(v) for v in out]):
        win = [range(o[d] * sizes[d] // out[d],
                     -(-(o[d] + 1) * sizes[d] // out[d])) for d in range(n)]
        pos = list(itertools.product(*win))
        vals = np.stack([x[(slice(None), slice(None)) + p] for p in pos], -1)
        first = vals.argmax(-1)
        flat = np.array([np.ravel_multi_index(p, sizes) for p in pos])
        want[(slice(None), slice(None)) + o] = flat[first]
    np.testing.assert_array_equal(got_m.numpy(), want)
    np.testing.assert_array_equal(
        got_v.numpy(), np.take_along_axis(
            x.reshape(x.shape[:2] + (-1,)), want.reshape(
                want.shape[:2] + (-1,)), -1).reshape(want.shape))
    layer = getattr(paddle_tpu_torch.nn, f"AdaptiveMaxPool{n}D")(
        out, return_mask=True)
    np.testing.assert_array_equal(layer(paddle_tpu_torch.to_tensor(x))[1]
                                  .numpy(), want)


def test_max_unpool2d_equals_jax():
    x = _f(2, 3, 8, 6)
    outs = []
    for p in (paddle_tpu, paddle_tpu_torch):
        v, m = p.nn.functional.max_pool2d(p.to_tensor(x), 2, 2,
                                          return_mask=True)
        outs.append(np.asarray(p.nn.functional.max_unpool2d(
            v, m, 2, 2).numpy()))
        outs.append(np.asarray(p.nn.functional.max_unpool2d(
            v, m, 2, 2, output_size=[9, 7]).numpy()))
    np.testing.assert_array_equal(outs[0], outs[2])
    np.testing.assert_array_equal(outs[1], outs[3])


def test_pool_layers_return_the_mask():
    x = paddle_tpu_torch.to_tensor(_f(2, 3, 9, 8))
    v, m = paddle_tpu_torch.nn.MaxPool2D(3, 2, 1, return_mask=True,
                                         ceil_mode=True)(x)
    want = paddle_tpu_torch.nn.functional.max_pool2d(
        x, 3, 2, 1, ceil_mode=True, return_mask=True)
    np.testing.assert_array_equal(m.numpy(), want[1].numpy())
    v1, m1 = paddle_tpu_torch.nn.MaxPool1D(2, return_mask=True)(x[:, :, 0])
    assert m1.shape == [2, 3, 4]


# -- norms -----------------------------------------------------------------------

NORM_CASES = {
    "instance_norm": lambda p, x, w, b: p.nn.functional.instance_norm(
        x, weight=w, bias=b, eps=1e-5),
    "instance_norm_3d": lambda p, x, w, b: p.nn.functional.instance_norm(
        p.reshape(x, [2, 8, 3, 5, 4]), weight=w, bias=b),
    "group_norm": lambda p, x, w, b: p.nn.functional.group_norm(
        x, 4, 1e-5, w, b),
    "local_response_norm": lambda p, x, w, b: p.nn.functional
    .local_response_norm(x * w.reshape([1, 8, 1, 1]) + 1.0, 5),
    "local_response_norm_even": lambda p, x, w, b: p.nn.functional
    .local_response_norm(x, 4, alpha=1e-2, beta=0.5, k=2.0),
}


@pytest.mark.parametrize("name", sorted(NORM_CASES))
def test_norm_matches_jax(name):
    _check(NORM_CASES[name], [_f(2, 8, 15, 4), _f(8), _f(8)])


@pytest.mark.parametrize("layer", ["GroupNorm", "InstanceNorm1D",
                                   "InstanceNorm2D", "InstanceNorm3D",
                                   "LocalResponseNorm"])
def test_norm_layers_match_jax(layer):
    args = {"GroupNorm": (4, 8), "LocalResponseNorm": (3,)}.get(layer, (8,))
    shape = {"InstanceNorm1D": (2, 8, 10), "InstanceNorm3D": (2, 8, 3, 4, 5)
             }.get(layer, (2, 8, 5, 6))
    layers = [getattr(p.nn, layer)(*args) for p in (paddle_tpu,
                                                    paddle_tpu_torch)]
    rng = np.random.default_rng(3)
    state = {k: rng.normal(size=v.shape).astype("float32")
             for k, v in layers[0].state_dict().items()}
    layers[0].set_state_dict(state)
    assert not any(layers[1].set_state_dict(state))
    x = _f(*shape)
    outs = [lay(p.to_tensor(x)).numpy() for p, lay in
            zip((paddle_tpu, paddle_tpu_torch), layers)]
    _close(*outs)


def test_spectral_norm_with_jax_vectors():
    paddle_tpu.seed(4)
    jl = paddle_tpu.nn.SpectralNorm([6, 4, 3], dim=1, power_iters=3)
    tl = paddle_tpu_torch.nn.SpectralNorm([6, 4, 3], dim=1, power_iters=3)
    assert not any(tl.set_state_dict({"weight_u": jl.weight_u.numpy(),
                                      "weight_v": jl.weight_v.numpy()}))
    u0 = tl.weight_u.numpy().copy()
    _check(lambda p, w: (jl if p is paddle_tpu else tl)(w), [_f(6, 4, 3)])
    np.testing.assert_array_equal(tl.weight_u.numpy(), u0)
