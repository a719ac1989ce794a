"""The port's ``amp`` against paddle_tpu's, on the CPU.

- under ``auto_cast`` (O1 and O2), ``linear``, ``conv2d``, ``matmul``,
  ``bmm`` and ``batch_norm`` give the JAX package's output dtypes and
  values, and every gradient comes back in its input's own dtype;
- outside ``auto_cast`` nothing is cast; the state nests and restores;
- ``decorate(level="O2")`` casts every floating parameter to bf16 but
  those of batch norm and LayerNorm, and keeps the Parameter objects
  (an optimizer built before it sees the casts); O1 casts nothing;
- ``GradScaler``: scaling, unscaling, the skipped step and the scale's
  growth and backoff against the JAX scaler, and its state round-trips;
- ``Momentum`` and ``Adam`` (with and without ``multi_precision``) on
  bf16 leaves: parameters and slots, with their dtypes, after two steps.

Tolerances: bf16 results 1e-2 of the largest value (both sides multiply
bf16 operands exactly and sum in f32, in another order, then round once
to bf16: the sums can cross one bf16 rounding, 3.9e-3 of a value); f32
results 1e-5.
"""
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


def _close(want, got, tol):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert want.shape == got.shape
    err = np.abs(want - got).max()
    assert err <= tol * max(np.abs(want).max(), 0.1), err


def _both(fn):
    return fn(paddle_tpu), fn(paddle_tpu_torch)


def _dt(t):
    return str(t.dtype).split(".")[-1]


def _leaf(paddle, arr, dtype="float32"):
    t = paddle.to_tensor(arr).astype(dtype)
    t.stop_gradient = False
    return t


RNG = np.random.default_rng(23)
X2 = RNG.standard_normal((4, 8)).astype(np.float32)
W2 = RNG.standard_normal((8, 6)).astype(np.float32)
B1 = RNG.standard_normal(6).astype(np.float32)
X4 = RNG.standard_normal((2, 3, 6, 6)).astype(np.float32)
WC = RNG.standard_normal((5, 3, 3, 3)).astype(np.float32) * 0.3
BC = RNG.standard_normal(5).astype(np.float32)
XB = RNG.standard_normal((3, 4, 5)).astype(np.float32)
YB = RNG.standard_normal((3, 5, 2)).astype(np.float32)


def _op(name, paddle, params_dtype):
    """One op on fresh leaves whose parameters are ``params_dtype``
    (bf16 = what O2's decorate leaves them)."""
    F = paddle.nn.functional
    if name == "linear":
        ins = [_leaf(paddle, X2), _leaf(paddle, W2, params_dtype),
               _leaf(paddle, B1, params_dtype)]
        return ins, F.linear(*ins)
    if name == "linear_nobias":
        ins = [_leaf(paddle, X2), _leaf(paddle, W2, params_dtype)]
        return ins, F.linear(*ins)
    if name == "conv2d":
        ins = [_leaf(paddle, X4), _leaf(paddle, WC, params_dtype),
               _leaf(paddle, BC, params_dtype)]
        return ins, F.conv2d(ins[0], ins[1], ins[2], stride=2, padding=1)
    if name == "matmul":
        ins = [_leaf(paddle, X2), _leaf(paddle, W2, params_dtype)]
        return ins, paddle.matmul(*ins)
    if name == "bmm":
        ins = [_leaf(paddle, XB), _leaf(paddle, YB, params_dtype)]
        return ins, paddle.bmm(*ins)
    if name == "batch_norm":
        # a bf16 activation (what a cast conv gives) into f32 BN
        ins = [_leaf(paddle, X4, "bfloat16"), _leaf(paddle, BC[:3]),
               _leaf(paddle, BC[2:])]
        rm = paddle.to_tensor(np.zeros(3, np.float32))
        rv = paddle.to_tensor(np.ones(3, np.float32))
        return ins, F.batch_norm(ins[0], rm, rv, ins[1], ins[2],
                                 training=True)
    raise KeyError(name)


OPS = ["linear", "linear_nobias", "conv2d", "matmul", "bmm", "batch_norm"]


@pytest.mark.parametrize("level,params_dtype", [("O1", "float32"),
                                                ("O2", "bfloat16")])
@pytest.mark.parametrize("name", OPS)
def test_auto_cast_dtypes_values_and_grad_dtypes(name, level, params_dtype):
    def run(paddle):
        with paddle.amp.auto_cast(enable=True, level=level):
            ins, y = _op(name, paddle, params_dtype)
        (y.astype("float32") * 0.5).sum().backward()
        return (_dt(y), y.astype("float32").numpy(),
                [(_dt(t.grad), t.grad.astype("float32").numpy())
                 for t in ins])

    (jdt, jy, jg), (tdt, ty, tg) = _both(run)
    assert jdt == tdt
    _close(jy, ty, BF16_TOL)
    for (jgd, jgv), (tgd, tgv) in zip(jg, tg):
        assert jgd == tgd
        _close(jgv, tgv, BF16_TOL)


def test_auto_cast_promotions_as_jnp():
    """A bf16 product plus an f32 bias is f32; with a bf16 bias, bf16;
    batch norm returns its input's dtype."""
    F = paddle_tpu_torch.nn.functional
    with paddle_tpu_torch.amp.auto_cast():
        assert _op("linear", paddle_tpu_torch, "float32")[1].dtype \
            == torch.float32
        assert _op("linear", paddle_tpu_torch, "bfloat16")[1].dtype \
            == torch.bfloat16
        assert _op("linear_nobias", paddle_tpu_torch, "float32")[1].dtype \
            == torch.bfloat16
        assert _op("batch_norm", paddle_tpu_torch, "float32")[1].dtype \
            == torch.bfloat16
        ids = paddle_tpu_torch.to_tensor(np.arange(6).reshape(2, 3))
        assert F.linear(ids.astype("float32"),
                        paddle_tpu_torch.to_tensor(W2[:3])).dtype \
            == torch.bfloat16


def test_auto_cast_off_casts_nothing_and_nests():
    amp = paddle_tpu_torch.amp
    assert not amp.amp_active()
    ins, y = _op("linear", paddle_tpu_torch, "float32")
    assert y.dtype == torch.float32
    with amp.auto_cast(level="O2"):
        assert amp.amp_active() and amp.amp_state().level == "O2"
        assert amp.amp_dtype() == torch.bfloat16
        with amp.amp_guard(enable=False):
            assert not amp.amp_active()
            assert _op("matmul", paddle_tpu_torch, "float32")[1].dtype \
                == torch.float32
        assert amp.amp_active()
        x = paddle_tpu_torch.to_tensor(X2)
        assert amp.maybe_cast_to_amp(x).dtype == torch.bfloat16
    assert not amp.amp_active() and amp.amp_state().level == "O1"
    assert amp.maybe_cast_to_amp(x) is x
    assert "conv2d" in amp.white_list and "batch_norm" in amp.black_list


def _decorated(paddle, level):
    nn = paddle.nn
    model = nn.Sequential(nn.Conv2D(3, 4, 3), nn.BatchNorm2D(4),
                          nn.LayerNorm(4), nn.Linear(4, 2))
    opt = paddle.optimizer.Momentum(0.1, parameters=model.parameters())
    model, opt2 = paddle.amp.decorate(model, opt, level=level,
                                      dtype="bfloat16")
    assert opt2 is opt
    return ([(k, _dt(v)) for k, v in model.state_dict().items()],
            [_dt(p) for p in opt._parameter_list])


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_decorate_keeps_norms_f32(level):
    (jnames, jopt), (tnames, topt) = _both(lambda p: _decorated(p, level))
    assert jnames == tnames and jopt == topt
    got = dict(tnames)
    assert got["1._mean"] == got["1.weight"] == got["2.bias"] == "float32"
    want = "bfloat16" if level == "O2" else "float32"
    assert got["0.weight"] == got["0.bias"] == got["3.weight"] == want


def test_decorated_params_stay_trainable_leaves():
    nn = paddle_tpu_torch.nn
    model = paddle_tpu_torch.amp.decorate(nn.Linear(4, 3), level="O2")
    assert model.weight.dtype == torch.bfloat16 and model.weight.is_leaf
    assert not model.weight.stop_gradient
    x = paddle_tpu_torch.to_tensor(X2[:, :4])
    with paddle_tpu_torch.amp.auto_cast(level="O2"):
        y = model(x)
    y.astype("float32").sum().backward()
    assert model.weight.grad.dtype == torch.bfloat16


def _scaler_run(paddle, grads):
    """A scaler over one parameter whose gradients are ``grads`` in
    turn: the scale, the flag and the parameter after each step."""
    lin = paddle.nn.Linear(3, 1)
    opt = paddle.optimizer.SGD(0.5, parameters=[lin.bias])
    scaler = paddle.amp.GradScaler(init_loss_scaling=8.0, incr_every_n_steps=2,
                                   decr_every_n_nan_or_inf=1)
    out = []
    for g in grads:
        lin.bias.grad = paddle.to_tensor(np.asarray(g, np.float32))
        scaler.step(opt)
        out.append((float(scaler.get_loss_scaling().numpy()),
                    bool(scaler._found_inf), lin.bias.numpy().tolist(),
                    dict(scaler.state_dict())))
        opt.clear_grad()
    scaled = scaler.scale(paddle.to_tensor(np.float32(2.0)))
    return out, float(scaled.numpy())


def test_grad_scaler_matches_jax_and_round_trips():
    grads = [[8.0], [16.0], [np.inf], [4.0], [np.nan], [8.0]]
    want, got = _both(lambda p: _scaler_run(p, grads))
    assert want == got
    s = paddle_tpu_torch.amp.GradScaler(init_loss_scaling=1024.0)
    s._good_steps, s._bad_steps = 7, 1
    state = s.state_dict()
    t = paddle_tpu_torch.amp.GradScaler()
    t.load_state_dict(state)
    assert t.state_dict() == state == {"scale": 1024.0, "good_steps": 7,
                                       "bad_steps": 1}
    off = paddle_tpu_torch.amp.GradScaler(enable=False)
    x = paddle_tpu_torch.to_tensor(np.float32(3.0))
    assert off.scale(x) is x and not off.is_enable()


@pytest.mark.parametrize("opt_name,kw", [
    ("Momentum", {"learning_rate": 0.1, "momentum": 0.9}),
    ("Momentum", {"learning_rate": 0.1, "momentum": 0.9,
                  "use_nesterov": True}),
    ("Adam", {"learning_rate": 1e-2}),
    ("Adam", {"learning_rate": 1e-2, "multi_precision": True})])
def test_optimizers_on_bf16_leaves(opt_name, kw):
    rng = np.random.default_rng(29)
    p_np = rng.standard_normal((4, 5)).astype(np.float32)
    g_np = [rng.standard_normal((4, 5)).astype(np.float32) for _ in range(2)]

    def run(paddle):
        lin = paddle.nn.Linear(4, 5, bias_attr=False)
        lin.set_state_dict({"weight": p_np})
        paddle.amp.decorate(lin, level="O2")
        opt = getattr(paddle.optimizer, opt_name)(
            parameters=lin.parameters(), **kw)
        for g in g_np:
            lin.weight.grad = paddle.to_tensor(g).astype("bfloat16")
            opt.step()
            opt.clear_grad()
        slots = {k.split(".")[-1]: (_dt(v), v.astype("float32").numpy())
                 for k, v in opt.state_dict().items()}
        return _dt(lin.weight), lin.weight.astype("float32").numpy(), slots

    (jdt, jp, js), (tdt, tp, ts) = _both(run)
    assert jdt == tdt == "bfloat16"
    _close(jp, tp, BF16_TOL)
    assert sorted(js) == sorted(ts)
    for name, (dt, v) in js.items():
        assert ts[name][0] == dt, name
        _close(v, ts[name][1], BF16_TOL if dt == "bfloat16" else TOL)
