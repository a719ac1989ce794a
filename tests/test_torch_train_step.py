"""The port's ``jit.TrainStep`` (uncaptured on the CPU), ``to_static``,
``paddle.save`` / ``paddle.load`` and ``AsyncLoss`` against paddle_tpu's,
with the JAX model's weights carried across by ``set_state_dict``.

- ``TrainStep`` for 3 steps, LeNet at batch 8 and a small conv +
  ``BatchNorm2D`` + linear net, with Adam at ``FLAGS_fused_optimizer`` 0
  and 1 (the JAX package's row 7 through its plain path on the CPU, the
  port's fused update from the optimizer's slots) and with Momentum:
  losses, params, every slot of ``optimizer.state_dict()`` after
  ``sync()`` (the same keys) and the batch-norm buffers within 1e-5 of
  the largest value (f32 sums in another order, through 3 updates);
- ``scale_lr`` and a ``grad_postprocess`` in both packages;
- ``TrainStep`` with the optimizer's ``grad_clip`` against the JAX
  package's eager step (``loss.backward(); opt.step()``), which applies
  the clip, where the JAX ``TrainStep`` does not (the port follows
  Paddle);
- ``steps(k)``, the ``FLAGS_fast_step`` loss handle and its sync count;
- ``to_static`` on a Layer and on a function, and
  ``ProgramTranslator().enable(False)``;
- ``paddle.save`` / ``paddle.load``: a state dict the JAX package wrote
  (f32 and bf16) loads into the port's model, which then gives the JAX
  model's outputs; the port's own round trip keeps bf16 bits;
- the entry points this slice does not port raise ``NotImplementedError``
  naming their ROADMAP item.
"""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu_torch import device as tdevice

TOL = 1e-5


@pytest.fixture(autouse=True)
def on_cpu():
    old = tdevice._current[0]
    paddle_tpu_torch.set_device("cpu")
    yield
    tdevice._current[0] = old


@pytest.fixture
def fused_flag():
    olds = (paddle_tpu.get_flags("FLAGS_fused_optimizer"),
            paddle_tpu_torch.get_flags("FLAGS_fused_optimizer"))

    def set_(v):
        paddle_tpu.set_flags({"FLAGS_fused_optimizer": v})
        paddle_tpu_torch.set_flags({"FLAGS_fused_optimizer": v})

    yield set_
    paddle_tpu.set_flags(olds[0])
    paddle_tpu_torch.set_flags(olds[1])


def _convbn(P):
    class Net(P.nn.Layer):
        def __init__(self):
            super().__init__()
            # no conv bias: batch norm removes it, so its gradient is
            # rounding noise that Adam would blow up to ±lr steps
            self.conv = P.nn.Conv2D(3, 4, 3, padding=1, bias_attr=False)
            self.bn = P.nn.BatchNorm2D(4)
            self.fc = P.nn.Linear(4 * 4 * 4, 5)

        def forward(self, x):
            y = P.nn.functional.relu(self.bn(self.conv(x)))
            y = P.nn.functional.max_pool2d(y, 2)
            return self.fc(P.flatten(y, 1))

    return Net()


def _lenet(P):
    return P.vision.models.LeNet()


_NETS = {"lenet": (_lenet, (8, 1, 28, 28), 10),
         "convbn": (_convbn, (6, 3, 8, 8), 5)}


def _carried(net):
    paddle_tpu.seed(2)
    build = _NETS[net][0]
    jm, tm = build(paddle_tpu), build(paddle_tpu_torch)
    missing, unexpected = tm.set_state_dict(
        {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    assert missing == [] and unexpected == []
    return jm, tm


def _batches(net, n=3, seed=0):
    _, shape, classes = _NETS[net]
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=shape).astype("float32"),
             rng.integers(0, classes, (shape[0],)).astype("int64"))
            for _ in range(n)]


def _opt(P, name, params, clip=None):
    if name == "momentum":
        return P.optimizer.Momentum(0.01, 0.9, parameters=params,
                                    grad_clip=clip)
    return P.optimizer.Adam(1e-3, parameters=params, grad_clip=clip)


def _ce(P):
    return lambda run_model, x, y: P.nn.functional.cross_entropy(
        run_model(x), y)


def _slots_by_structure(model, opt_state):
    """An optimizer state dict keyed by the parameters' structured names:
    its own keys use ``Parameter.name``, which each package numbers per
    process (so they part once other tests have made layers)."""
    names = {p.name: k for k, p in model.named_parameters()}
    out = {}
    for key, v in opt_state.items():
        if key == "LR_Scheduler":
            out[key] = v
            continue
        pname, slot = key.rsplit(".", 1)
        out[f"{names[pname]}.{slot}"] = v
    return out


def _close(want, got, tol=TOL):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert want.shape == got.shape
    err = np.abs(want - got).max() if want.size else 0.0
    assert err <= tol * max(np.abs(want).max(), 1e-3), err


def _step_run(P, model, opt_name, batches, **kw):
    opt = _opt(P, opt_name, model.parameters())
    step = P.jit.TrainStep(model, _ce(P), opt, **kw)
    losses = []
    for i, (x, y) in enumerate(batches):
        if i == 1:
            step.scale_lr(0.5)
        losses.append(float(step(P.to_tensor(x), P.to_tensor(y))))
    step.sync()
    return losses, step, opt


@pytest.mark.parametrize("net,opt_name,fused", [
    ("lenet", "adam", 0), ("lenet", "adam", 1), ("lenet", "momentum", 0),
    ("convbn", "adam", 0), ("convbn", "adam", 1),
    ("convbn", "momentum", 0)])
def test_train_step_matches_jax(net, opt_name, fused, fused_flag):
    fused_flag(fused)
    jm, tm = _carried(net)
    batches = _batches(net)
    lj, _, oj = _step_run(paddle_tpu, jm, opt_name, batches)
    lt, st, ot = _step_run(paddle_tpu_torch, tm, opt_name, batches)
    assert st._use_fused == bool(fused and opt_name == "adam")
    assert st._step_count == 3 and st.captures == 0
    np.testing.assert_allclose(lt, lj, rtol=TOL)
    sj, stt = jm.state_dict(), tm.state_dict()
    assert list(sj) == list(stt)
    for k in sj:
        _close(sj[k].numpy(), stt[k].numpy())
    oj = _slots_by_structure(jm, oj.state_dict())
    ot = _slots_by_structure(tm, ot.state_dict())
    assert set(oj) == set(ot)
    for k in oj:
        _close(np.asarray(oj[k].numpy()), ot[k].numpy())


def test_grad_postprocess_runs_inside_the_step():
    jm, tm = _carried("convbn")
    (x, y), = _batches("convbn", 1)
    halve = lambda grads: {k: g * 0.5 for k, g in grads.items()}  # noqa
    for P, m in ((paddle_tpu, jm), (paddle_tpu_torch, tm)):
        opt = _opt(P, "momentum", m.parameters())
        P.jit.TrainStep(m, _ce(P), opt, grad_postprocess=halve)(
            P.to_tensor(x), P.to_tensor(y))
    for (k, w), (_, g) in zip(jm.state_dict().items(),
                              tm.state_dict().items()):
        _close(w.numpy(), g.numpy())


@pytest.mark.parametrize("opt_name,fused", [("adam", 1), ("momentum", 0)])
def test_train_step_grad_clip_follows_the_eager_step(opt_name, fused,
                                                     fused_flag):
    """The port's step applies ``grad_clip`` as the JAX eager step does;
    a schedule moves the rate between steps."""
    fused_flag(fused)
    jm, tm = _carried("convbn")
    batches = _batches("convbn")

    def sched(P):
        return P.optimizer.lr.LinearWarmup(
            P.optimizer.lr.CosineAnnealingDecay(0.05, T_max=4), 2, 0.0, 0.05)

    sj = sched(paddle_tpu)
    oj = _opt(paddle_tpu, opt_name, jm.parameters(),
              paddle_tpu.nn.ClipGradByGlobalNorm(0.1))
    oj._learning_rate = sj
    want = []
    for x, y in batches:
        loss = paddle_tpu.nn.functional.cross_entropy(
            jm(paddle_tpu.to_tensor(x)), paddle_tpu.to_tensor(y))
        loss.backward()
        oj.step()
        oj.clear_grad()
        sj.step()
        want.append(float(loss.numpy()))
    st_ = sched(paddle_tpu_torch)
    ot = _opt(paddle_tpu_torch, opt_name, tm.parameters(),
              paddle_tpu_torch.nn.ClipGradByGlobalNorm(0.1))
    ot._learning_rate = st_
    step = paddle_tpu_torch.jit.TrainStep(tm, _ce(paddle_tpu_torch), ot)
    got = []
    for x, y in batches:
        got.append(float(step(paddle_tpu_torch.to_tensor(x),
                              paddle_tpu_torch.to_tensor(y))))
        st_.step()
    np.testing.assert_allclose(got, want, rtol=TOL)
    for (k, w), (_, g) in zip(jm.state_dict().items(),
                              tm.state_dict().items()):
        _close(w.numpy(), g.numpy())


def test_steps_and_the_async_loss():
    from paddle_tpu_torch.framework.core import AsyncLoss
    from paddle_tpu_torch.monitor import stat_get

    _, a = _carried("convbn")
    _, b = _carried("convbn")
    (x, y), = _batches("convbn", 1)
    P = paddle_tpu_torch
    xs, ys = P.to_tensor(x), P.to_tensor(y)
    sa = P.jit.TrainStep(a, _ce(P), _opt(P, "adam", a.parameters()))
    sb = P.jit.TrainStep(b, _ce(P), _opt(P, "adam", b.parameters()))
    last = sa.steps(3, xs, ys)
    for _ in range(3):
        out = sb(xs, ys)
    assert sa._step_count == sb._step_count == 3
    assert isinstance(last, AsyncLoss) and isinstance(out, AsyncLoss)
    s0 = stat_get("step_async_syncs")
    assert float(last) == float(out)
    float(last)
    assert stat_get("step_async_syncs") - s0 == 2      # once per handle
    for (k, va), (_, vb) in zip(a.state_dict().items(),
                                b.state_dict().items()):
        assert torch.equal(va._data, vb._data), k
    old = P.get_flags("FLAGS_fast_step")
    P.set_flags({"FLAGS_fast_step": 0})
    try:
        plain = sb(xs, ys)
        assert type(plain) is P.Tensor
    finally:
        P.set_flags(old)


def test_to_static_layer_function_and_translator_switch():
    jm, tm = _carried("convbn")
    (x, _), = _batches("convbn", 1)
    tm.eval()
    jm.eval()
    want = jm(paddle_tpu.to_tensor(x)).numpy()
    sl = paddle_tpu_torch.jit.to_static(tm)
    _close(want, sl(paddle_tpu_torch.to_tensor(x)).numpy())
    assert sl.fc is tm.fc                     # the layer's attributes

    @paddle_tpu_torch.jit.to_static
    def f(a, b):
        return a * 2 + b if float(a.sum()) > 0 else a - b

    a = paddle_tpu_torch.to_tensor(np.ones(3, "float32"))
    np.testing.assert_array_equal(f(a, a).numpy(), [3.0, 3.0, 3.0])
    pt = paddle_tpu_torch.jit.ProgramTranslator()
    pt.enable(False)
    try:
        np.testing.assert_array_equal(f(-a, a).numpy(), [-2.0] * 3)
        _close(want, sl(paddle_tpu_torch.to_tensor(x)).numpy())
    finally:
        pt.enable(True)


def test_jax_saved_state_dict_loads_and_gives_jax_outputs(tmp_path):
    jm, _ = _carried("convbn")
    tm = _convbn(paddle_tpu_torch)
    jm.eval()
    tm.eval()
    sd = jm.state_dict()
    sd["extra_bf16"] = paddle_tpu.to_tensor(
        np.array([1.0, -2.5, 3.140625], "float32")).astype("bfloat16")
    path = str(tmp_path / "jax.pdparams")
    paddle_tpu.save(sd, path)
    loaded = paddle_tpu_torch.load(path)
    extra = loaded.pop("extra_bf16")
    assert extra.dtype == torch.bfloat16
    np.testing.assert_array_equal(extra.numpy(), [1.0, -2.5, 3.140625])
    assert tm.set_state_dict(loaded) == ([], [])
    (x, _), = _batches("convbn", 1)
    _close(jm(paddle_tpu.to_tensor(x)).numpy(),
           tm(paddle_tpu_torch.to_tensor(x)).numpy())
    arrays = paddle_tpu_torch.load(path, return_numpy=True)
    assert isinstance(arrays["fc.weight"], np.ndarray)
    np.testing.assert_array_equal(arrays["fc.weight"], sd["fc.weight"].numpy())


def test_port_save_load_round_trip_keeps_bf16_bits(tmp_path):
    P = paddle_tpu_torch
    t = torch.randn(5, 7).to(torch.bfloat16)
    obj = {"a": P.Tensor(t), "b": [P.Tensor(torch.arange(4)), 3],
           "c": {"s": "x"}}
    path = str(tmp_path / "sub" / "o.pdparams")
    P.save(obj, path)
    back = P.load(path)
    assert torch.equal(back["a"]._data.view(torch.int16), t.view(torch.int16))
    assert torch.equal(back["b"][0]._data, torch.arange(4))
    assert back["b"][1] == 3 and back["c"] == {"s": "x"}


def test_unported_entry_points_raise():
    P = paddle_tpu_torch
    m = P.nn.Linear(2, 2)
    opt = P.optimizer.SGD(0.1, parameters=m.parameters())
    with pytest.raises(NotImplementedError, match="item 9"):
        P.jit.TrainStep(m, _ce(P), opt, sentinel=True)
    step = P.jit.TrainStep(m, lambda r, x: r(x).mean(), opt)
    P.set_flags({"FLAGS_fault_inject": "input_stall@step=1"})
    try:
        with pytest.raises(NotImplementedError, match="item 9"):
            step(P.to_tensor(np.ones((1, 2), "float32")))
    finally:
        P.set_flags({"FLAGS_fault_inject": ""})
    for call in (lambda: P.jit.save(m, "x"), lambda: P.jit.load("x"),
                 lambda: P.jit.TracedLayer.trace(m, []),
                 lambda: P.jit.TranslatedLayer("x")):
        with pytest.raises(NotImplementedError, match="item 11"):
            call()
    with pytest.raises(NotImplementedError, match="item 8 step 7"):
        P.enable_static()
