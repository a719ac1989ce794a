"""The port's LR schedulers, gradient clips and optimizers against
paddle_tpu's, on the CPU.

- every scheduler of ``optimizer/lr.py`` stepped 30 times (ReduceOnPlateau
  on one metric sequence): ``last_lr`` within 1e-12 of the JAX
  package's at every step, and a scheduler rebuilt from a mid-run
  ``state_dict`` continues the same sequence;
- ``ClipGradByValue``, ``ClipGradByNorm`` and ``ClipGradByGlobalNorm`` on
  seeded gradients: rtol 1e-6; the global norm stays a tensor;
- every optimizer for 3 eager steps (``loss.backward(); step();
  clear_grad()``) under a scheduler and ``ClipGradByGlobalNorm``, from
  the JAX model's weights on the same batches: params and every slot of
  ``state_dict()`` within 1e-6 of the largest value (f32 sums in another
  order); ``Dpsgd`` at ``sigma=0`` against JAX, and with noise against
  its own formula on the draws of the port's seeded generator;
- ``ExponentialMovingAverage`` against JAX's.
"""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu_torch import device as tdevice

TOL = 1e-6


@pytest.fixture(autouse=True)
def on_cpu():
    old = tdevice._current[0]
    paddle_tpu_torch.set_device("cpu")
    yield
    tdevice._current[0] = old


def _schedulers(lr):
    return {
        "noam": lambda: lr.NoamDecay(64, 8, learning_rate=2.0),
        "piecewise": lambda: lr.PiecewiseDecay([3, 9, 20],
                                               [0.1, 0.05, 0.01, 0.001]),
        "natural_exp": lambda: lr.NaturalExpDecay(0.5, 0.1),
        "inverse_time": lambda: lr.InverseTimeDecay(0.5, 0.1),
        "polynomial": lambda: lr.PolynomialDecay(0.5, 10, 0.01, 2.0),
        "polynomial_cycle": lambda: lr.PolynomialDecay(0.5, 7, 0.01, 1.0,
                                                       cycle=True),
        "linear_warmup": lambda: lr.LinearWarmup(0.3, 5, 0.0, 0.3),
        "linear_warmup_cos": lambda: lr.LinearWarmup(
            lr.CosineAnnealingDecay(1e-3, T_max=20), 5, 0.0, 1e-3),
        "exponential": lambda: lr.ExponentialDecay(0.5, 0.9),
        "multistep": lambda: lr.MultiStepDecay(0.5, [4, 11, 17], 0.3),
        "step": lambda: lr.StepDecay(0.5, 4, 0.5),
        "lambda": lambda: lr.LambdaDecay(0.5, lambda e: 0.95 ** e),
        "multiplicative": lambda: lr.MultiplicativeDecay(
            0.5, lambda e: 0.97),
        "cosine": lambda: lr.CosineAnnealingDecay(0.5, 12, eta_min=0.01),
        "one_cycle": lambda: lr.OneCycleLR(0.1, 30),
        "one_cycle_linear": lambda: lr.OneCycleLR(
            0.1, 30, anneal_strategy="linear", phase_pct=0.4),
        "cyclic": lambda: lr.CyclicLR(0.01, 0.1, 4, 6),
        "cyclic_tri2": lambda: lr.CyclicLR(0.01, 0.1, 3,
                                           mode="triangular2"),
        "cyclic_exp": lambda: lr.CyclicLR(0.01, 0.1, 3, mode="exp_range",
                                          exp_gamma=0.9),
    }


@pytest.mark.parametrize("name", sorted(_schedulers(paddle_tpu.optimizer.lr)))
def test_scheduler_matches_jax(name):
    want_s = _schedulers(paddle_tpu.optimizer.lr)[name]()
    got_s = _schedulers(paddle_tpu_torch.optimizer.lr)[name]()
    want, got = [want_s()], [got_s()]
    resumed = None
    for i in range(30):
        want_s.step()
        got_s.step()
        want.append(want_s())
        got.append(got_s())
        if i == 14:
            resumed = _schedulers(paddle_tpu_torch.optimizer.lr)[name]()
            resumed.set_state_dict(got_s.state_dict())
            assert resumed.state_dict() == got_s.state_dict()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    if "warmup_cos" not in name and name != "multiplicative":
        # (those two keep state outside state_dict, in JAX too)
        tail = []
        for _ in range(15):
            resumed.step()
            tail.append(resumed())
        np.testing.assert_allclose(tail, want[16:], rtol=0, atol=1e-12)


def test_reduce_on_plateau_matches_jax():
    metrics = [1.0, 0.9, 0.91, 0.92, 0.93, 0.5, 0.51, 0.52, 0.53, 0.54,
               0.55, 0.2, 0.2, 0.2, 0.2, 0.2, 0.2, 0.19, 0.3, 0.3, 0.3,
               0.3, 0.3, 0.3, 0.3, 0.3, 0.3, 0.3, 0.3, 0.3]
    for mode, thr_mode in (("min", "rel"), ("max", "abs")):
        mk = lambda P: P.optimizer.lr.ReduceOnPlateau(  # noqa: E731
            1.0, mode=mode, factor=0.5, patience=2, threshold=1e-3,
            threshold_mode=thr_mode, cooldown=1, min_lr=0.01)
        ws, gs = mk(paddle_tpu), mk(paddle_tpu_torch)
        for m in metrics:
            ws.step(m)
            # a Tensor metric is read as the JAX package reads one
            gs.step(paddle_tpu_torch.to_tensor(np.float32(m)))
            assert gs.last_lr == pytest.approx(ws.last_lr, abs=1e-12)
            assert gs.num_bad_epochs == ws.num_bad_epochs
        assert gs.state_dict() == ws.state_dict()


def _grads(seed=11):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype("float32") * sc
            for s, sc in (((7, 5), 3.0), ((5,), 0.01), ((3, 3, 2), 1.0))]


@pytest.mark.parametrize("make", [
    lambda nn: nn.ClipGradByValue(0.5),
    lambda nn: nn.ClipGradByValue(0.2, min=-0.7),
    lambda nn: nn.ClipGradByNorm(1.5),
    lambda nn: nn.ClipGradByGlobalNorm(1.0),
    lambda nn: nn.ClipGradByGlobalNorm(1e3),
], ids=["value", "value_min", "norm", "global_norm", "global_norm_loose"])
def test_clip_matches_jax(make):
    gs = _grads()

    def run(P):
        pairs = [(_Param(i == 1), P.to_tensor(g)) for i, g in enumerate(gs)]
        return [g.numpy() for _, g in make(P.nn)(pairs)]

    want, got = run(paddle_tpu), run(paddle_tpu_torch)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)


class _Param:
    """A parameter stand-in; the second of the three is excluded."""

    def __init__(self, frozen):
        self.need_clip = not frozen


def test_global_norm_clip_takes_bare_tensors_and_stays_on_device():
    """jit.TrainStep hands bare torch gradients: the clip keeps them bare
    and its scale is a tensor (no host read)."""
    gs = [torch.from_numpy(g) for g in _grads()]
    out = paddle_tpu_torch.nn.ClipGradByGlobalNorm(1.0)(
        [(_Param(False), g) for g in gs])
    norm = torch.sqrt(sum(torch.sum(g * g) for g in gs))
    for (_, o), g in zip(out, gs):
        assert isinstance(o, torch.Tensor)
        torch.testing.assert_close(o, g * (1.0 / norm), rtol=1e-6,
                                   atol=1e-7)


# -- optimizers -----------------------------------------------------------------

def _mlp(P):
    return P.nn.Sequential(P.nn.Linear(6, 8), P.nn.ReLU(), P.nn.Linear(8, 3))


def _carried():
    paddle_tpu.seed(1)
    jm, tm = _mlp(paddle_tpu), _mlp(paddle_tpu_torch)
    tm.set_state_dict({k: np.asarray(v.numpy())
                       for k, v in jm.state_dict().items()})
    return jm, tm


_OPTS = {
    "sgd": lambda o, s, p, c: o.SGD(s, parameters=p, grad_clip=c),
    "momentum": lambda o, s, p, c: o.Momentum(s, 0.9, parameters=p,
                                              grad_clip=c),
    "momentum_nesterov_l2": lambda o, s, p, c: o.Momentum(
        s, 0.9, parameters=p, use_nesterov=True, weight_decay=0.01,
        grad_clip=c),
    "adam": lambda o, s, p, c: o.Adam(s, parameters=p, grad_clip=c),
    "adamw": lambda o, s, p, c: o.AdamW(s, parameters=p, grad_clip=c,
                                        weight_decay=0.05),
    "lamb": lambda o, s, p, c: o.Lamb(s, parameters=p, grad_clip=c),
    "adamax": lambda o, s, p, c: o.Adamax(s, parameters=p, grad_clip=c),
    "adagrad": lambda o, s, p, c: o.Adagrad(
        s, parameters=p, grad_clip=c, initial_accumulator_value=0.1),
    "adadelta": lambda o, s, p, c: o.Adadelta(s, parameters=p, grad_clip=c),
    "rmsprop": lambda o, s, p, c: o.RMSProp(s, parameters=p, grad_clip=c,
                                            momentum=0.5),
    "rmsprop_centered": lambda o, s, p, c: o.RMSProp(
        s, parameters=p, grad_clip=c, centered=True),
    "lars": lambda o, s, p, c: o.LarsMomentum(s, 0.9, parameters=p,
                                              grad_clip=c, lars_coeff=0.01),
    "ftrl": lambda o, s, p, c: o.Ftrl(s, l1=0.01, l2=0.02, parameters=p,
                                      grad_clip=c),
    # l1 0 here: x = l1·sign(l) − l cancels where |l| is near l1, and
    # there the ulp by which torch's and XLA's pow(·, 0.7) differ grows
    # to 5e-4 of the element (the lr_power −0.5 case keeps l1)
    "ftrl_power": lambda o, s, p, c: o.Ftrl(s, l1=0.0, l2=0.02,
                                            lr_power=-0.7, parameters=p,
                                            grad_clip=c),
    "decayed_adagrad": lambda o, s, p, c: o.DecayedAdagrad(
        s, parameters=p, grad_clip=c),
    "dpsgd_sigma0": lambda o, s, p, c: o.Dpsgd(
        s, clip=0.5, batch_size=4.0, sigma=0.0, parameters=p, grad_clip=c),
}


def _train(P, model, name, batches, clip=True):
    sched = P.optimizer.lr.StepDecay(0.05, 1, 0.5)
    opt = _OPTS[name](P.optimizer, sched, model.parameters(),
                      P.nn.ClipGradByGlobalNorm(0.5) if clip else None)
    losses = []
    for x, y in batches:
        loss = P.nn.functional.mse_loss(model(P.to_tensor(x)),
                                        P.to_tensor(y))
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()
        losses.append(float(loss.numpy()))
    return losses, opt


def _batches(n=3, seed=4):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(5, 6)).astype("float32"),
             rng.normal(size=(5, 3)).astype("float32")) for _ in range(n)]


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
    assert np.abs(want - got).max() <= tol * max(np.abs(want).max(), 1e-3)


@pytest.mark.parametrize("name", sorted(_OPTS))
def test_optimizer_matches_jax_eager_step(name):
    jm, tm = _carried()
    batches = _batches()
    lj, oj = _train(paddle_tpu, jm, name, batches)
    lt, ot = _train(paddle_tpu_torch, tm, name, batches)
    np.testing.assert_allclose(lt, lj, rtol=1e-6)
    for (k, w), (_, g) in zip(jm.state_dict().items(),
                              tm.state_dict().items()):
        _close(w.numpy(), g.numpy())
    sj = _slots_by_structure(jm, oj.state_dict())
    st = _slots_by_structure(tm, ot.state_dict())
    assert set(sj) == set(st)
    for k in sj:
        if k == "LR_Scheduler":
            assert st[k] == sj[k]
        else:
            _close(np.asarray(sj[k].numpy()), st[k].numpy())


def test_optimizer_state_dict_round_trip_carries_the_schedule():
    _, tm = _carried()
    _, opt = _train(paddle_tpu_torch, tm, "adam", _batches(2))
    sd = opt.state_dict()
    sched = paddle_tpu_torch.optimizer.lr.StepDecay(0.05, 1, 0.5)
    fresh = paddle_tpu_torch.optimizer.Adam(sched,
                                            parameters=tm.parameters())
    fresh.set_state_dict(sd)
    assert sched.last_epoch == 2 and fresh.get_lr() == opt.get_lr()
    for k, v in fresh.state_dict().items():
        if k != "LR_Scheduler":
            assert torch.equal(v._data, sd[k]._data)


def test_dpsgd_noise_follows_its_formula():
    """With sigma > 0 the port draws one N(0, 1) per parameter and step
    from the device's seeded generator: replaying those draws through
    the formula gives the step's parameters."""
    from paddle_tpu_torch.framework import random as grandom

    _, tm = _carried()
    paddle_tpu_torch.seed(123)
    gen = grandom.generator(torch.device("cpu"))
    state = gen.get_state()
    before = [p._data.clone() for p in tm.parameters()]
    opt = paddle_tpu_torch.optimizer.Dpsgd(0.1, clip=0.5, batch_size=4.0,
                                           sigma=2.0,
                                           parameters=tm.parameters())
    x, y = _batches(1)[0]
    loss = paddle_tpu_torch.nn.functional.mse_loss(
        tm(paddle_tpu_torch.to_tensor(x)), paddle_tpu_torch.to_tensor(y))
    loss.backward()
    grads = [p.grad._data.clone() for p in tm.parameters()]
    opt.step()
    gen.set_state(state)
    for p, p0, g in zip(tm.parameters(), before, grads):
        z = torch.randn((), generator=gen)
        l2 = torch.sqrt(torch.sum(g * g))
        scale = l2 / 0.5 if l2 > 0.5 else torch.tensor(1.0)
        want = p0 - 0.1 * (g / scale + 2.0 * z / 4.0)
        torch.testing.assert_close(p._data, want, rtol=1e-6, atol=1e-7)


def test_ema_matches_jax():
    jm, tm = _carried()
    batches = _batches(3)
    ema_j = paddle_tpu.optimizer.ExponentialMovingAverage(0.9,
                                                          thres_steps=None)
    ema_t = paddle_tpu_torch.optimizer.ExponentialMovingAverage(0.9)
    for P, m, ema in ((paddle_tpu, jm, ema_j), (paddle_tpu_torch, tm, ema_t)):
        opt = P.optimizer.SGD(0.1, parameters=m.parameters())
        for x, y in batches:
            loss = P.nn.functional.mse_loss(m(P.to_tensor(x)),
                                            P.to_tensor(y))
            loss.backward()
            opt.step()
            opt.clear_grad()
            ema.update(m.parameters())
    live = [p.numpy().copy() for p in tm.parameters()]
    with ema_j.apply_guard(), ema_t.apply_guard():
        for pj, pt in zip(jm.parameters(), tm.parameters()):
            _close(pj.numpy(), pt.numpy())
    for p, want in zip(tm.parameters(), live):
        np.testing.assert_array_equal(p.numpy(), want)
