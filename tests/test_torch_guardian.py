"""paddle_tpu_torch's guarded training (``resilience/guardian.py``, the
sentinel inside ``DistributedTrainStep`` and ``jit.TrainStep``) against
paddle_tpu.

- gpt_nano (2 layers, hidden 64, f32) under
  ``DistributedTrainStep(sentinel=True)``, weights carried from the JAX
  init, the batch holding a float per-token weight of ones (the int
  token ids give ``nan_grad`` nothing to poison, as in the reference):
  the same losses (1e-5 absolute, the training parity tests' bound),
  the same health and trips as the JAX step, the tripped step's params
  and optimizer state bit-identical to the step before, and every param
  within 5e-5 of JAX's after it (``PARAM_ABS``: a twentieth of one
  update); pure and fused AdamW.
- The reference's ``TestLeNetAcceptance`` mirrored: LeNet through
  ``jit.TrainStep(sentinel=True)`` under a ``TrainGuardian`` with
  ``nan_grad@step=5:repeat=3``: the same actions and rollbacks as the
  JAX guardian's, params within ``rtol=1e-5, atol=1e-6`` of JAX's and
  equal to a fault-free port run. Both Adams take eps 1e-4 (``ADAM_KW``):
  at 1e-8 one element in 48,000 of LeNet's fc weight ends 3e-5 apart
  between the packages (a near-zero gradient's sign).
- Crash then auto-resume, SIGTERM with a priority save, and a
  ``restore_latest`` that continues bit-exactly (on the CPU); the
  watchdog's stack dump, and an I/O wait of the guardian's reported as
  an I/O stall, not a stalled step; ``lr_backoff`` writing the step's device
  learning-rate scalar; the buffers of a tripped step (batch norm's
  running statistics, written in the forward) restored.
"""
import os
import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu.models import gpt as jg
from paddle_tpu.resilience import configure_faults as jconfigure
from paddle_tpu.resilience.guardian import TrainGuardian as JGuardian
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.core import flags
from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.monitor import flight as tflight
from paddle_tpu_torch.monitor import stat_get
from paddle_tpu_torch.parallel import DistributedTrainStep
from paddle_tpu_torch.parallel import train_step as tts
from paddle_tpu_torch.resilience import (InjectedCrash, TrainGuardian,
                                         TrainingAborted, configure_faults)
from torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)

LOSS_TOL = 1e-5
# params after the 4 applied updates, absolute: one Adam step moves an
# element by up to ~lr (1e-3), which a skip applied wrongly (or a count
# advanced) would add; the packages' f32 gradients differ by up to 2e-3
# of a leaf's largest value (test_torch_train.py), which four damped
# updates carry to ~1e-5
PARAM_ABS = 5e-5
N_GPT = 5
# eps well above the noise of a near-zero gradient: with the default 1e-8
# Adam's first steps move each such element by ~lr whatever the sign its
# last bits give (2e-3 of the largest weight between two packages), so
# only a damped update can hold params to 1e-5
ADAM_KW = {"eps": 1e-4}


@pytest.fixture(autouse=True)
def on_cpu():
    old = tdevice._current[0]
    # a watchdog guardian arms the process-wide flight recorder, which
    # stays armed: put back what the test found, so a later test on the
    # same worker (test_torch_observability.py) sees it as it was
    recorder = tflight.get_flight_recorder()
    paddle_tpu_torch.set_device("cpu")
    yield
    tdevice._current[0] = old
    tflight.FLIGHT[0] = recorder
    configure_faults("")
    jconfigure("")


def _gpt_batch(i):
    rng = np.random.default_rng(40 + i)
    return (rng.integers(0, 512, (2, 64)).astype(np.int32),
            rng.integers(0, 512, (2, 64)).astype(np.int32),
            np.ones((2, 64), np.float32))


def _flat(tree):
    return {tuple(k.key for k in path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def jax_gpt():
    """The JAX step's losses, verdicts and params, per optimizer mode."""
    from jax.sharding import PartitionSpec as P

    from paddle_tpu.parallel import (DistributedTrainStep as JStep,
                                     create_mesh, set_mesh)

    cfg = jg.gpt_nano(dtype=jnp.float32)
    p0 = jg.gpt_init(cfg, seed=1)
    out = {"init": p0}
    old = paddle_tpu.get_flags("FLAGS_fused_optimizer")[
        "FLAGS_fused_optimizer"]
    try:
        for fused in (0, 1):
            paddle_tpu.set_flags({"FLAGS_fused_optimizer": fused})
            mesh = create_mesh(dp=1, devices=jax.devices()[:1])
            step = JStep(lambda p, b: jg.gpt_loss(cfg, p, (b[0], b[1]))
                         * jnp.mean(b[2]), p0,
                         jax.tree.map(lambda _: P(), p0), optimizer="adamw",
                         lr=1e-3, mesh=mesh, sentinel=True,
                         opt_kwargs=ADAM_KW)
            jconfigure("nan_grad@step=2")
            rows = []
            for i in range(N_GPT):
                loss = step(_gpt_batch(i))
                rows.append((float(loss), bool(loss.health["trip"]),
                             int(loss.health["trips"])))
            jconfigure("")
            out[fused] = (rows, _flat(step.params))
            set_mesh(None)
    finally:
        paddle_tpu.set_flags({"FLAGS_fused_optimizer": old})
        jconfigure("")
    return out


@pytest.mark.parametrize("fused", [0, 1])
def test_gpt_sentinel_step_matches_jax(jax_gpt, fused):
    cfg = tg.gpt_nano(dtype=torch.float32)
    params = tg.params_from_jax(jax.tree.map(np.asarray, jax_gpt["init"]),
                                device="cpu")
    old = flags.fused_optimizer[0]
    flags.fused_optimizer[0] = bool(fused)
    try:
        step = DistributedTrainStep(
            lambda p, b: tg.gpt_loss(cfg, p, (b[0], b[1])) * b[2].mean(),
            params, optimizer="adamw", lr=1e-3, device="cpu", sentinel=True,
            opt_kwargs=ADAM_KW)
    finally:
        flags.fused_optimizer[0] = old
    assert (step._update_fn is tts.pure_adamw_update) == (not fused)
    want, want_params = jax_gpt[fused]
    configure_faults("nan_grad@step=2")
    rows, before = [], None
    for i in range(N_GPT):
        if i == 2:
            before = step.state_dict()
        loss = step(_gpt_batch(i))
        rows.append((float(loss), bool(loss.health["trip"]),
                     int(loss.health["trips"])))
        if i == 2:
            after = step.state_dict()
            for key in ("params", "opt_state"):
                for path, t in tts._paths(before[key]):
                    assert torch.equal(tts._get(after[key], path), t), path
    configure_faults("")
    assert [r[1:] for r in rows] == [r[1:] for r in want]
    assert [r[1] for r in rows] == [False, False, True, False, False]
    for (lt, _, _), (lj, _, _) in zip(rows, want):
        assert (np.isnan(lt) and np.isnan(lj)) or abs(lt - lj) <= LOSS_TOL
    got = {path: t.detach().numpy() for path, t in tts._paths(step.params)}
    for path, w in want_params.items():
        err = np.abs(got[path] - w).max()
        assert err <= PARAM_ABS, (path, err)


# -- the reference's TestLeNetAcceptance, mirrored ----------------------------

def _lenet_batch(paddle, i, n=8):
    rng = np.random.default_rng(1000 + i)
    return (paddle.to_tensor(rng.normal(size=(n, 1, 28, 28))
                             .astype("float32")),
            paddle.to_tensor(rng.integers(0, 10, (n,)).astype("int64")))


def _lenet(paddle, state=None):
    net = paddle.vision.models.LeNet(num_classes=10)
    if state is not None:
        net.set_state_dict(state)
    opt = paddle.optimizer.Adam(learning_rate=1e-3, epsilon=ADAM_KW["eps"],
                                parameters=net.parameters())
    step = paddle.jit.TrainStep(
        net, lambda run, x, y: paddle.nn.functional.cross_entropy(run(x), y),
        opt, sentinel=True)
    return net, step


def _guarded(paddle, step, guardian, n_steps):
    i, actions = 0, []
    while i < n_steps:
        loss = step(*_lenet_batch(paddle, i))
        action = guardian.after_step(i, loss)
        actions.append((i, action))
        if action == "rollback":
            i = guardian.resume_step
            continue
        if action == "preempt":
            break
        i += 1
    return actions


SPEC = "nan_grad@step=5:repeat=3"


@pytest.fixture(scope="module")
def lenet_state():
    paddle_tpu.seed(0)
    net = paddle_tpu.vision.models.LeNet(num_classes=10)
    return {k: np.asarray(v.numpy(), np.float32)
            for k, v in net.state_dict().items()}


@pytest.fixture(scope="module")
def jax_lenet(lenet_state):
    from paddle_tpu import monitor as jmon

    net, step = _lenet(paddle_tpu, lenet_state)
    g = JGuardian(step, snapshot_every=2, skip_limit=2, max_rollbacks=2)
    rb0 = jmon.stat_get("rollbacks")
    jconfigure(SPEC)
    try:
        actions = _guarded(paddle_tpu, step, g, 10)
    finally:
        jconfigure("")
        g.close()
    return (actions, jmon.stat_get("rollbacks") - rb0,
            {k: np.asarray(v.numpy()) for k, v in net.state_dict().items()})


def test_lenet_nan_burst_rolls_back_as_jax(jax_lenet, lenet_state):
    P = paddle_tpu_torch
    clean_net, clean_step = _lenet(P, lenet_state)
    for i in range(10):
        clean_step(*_lenet_batch(P, i))
    net, step = _lenet(P, lenet_state)
    g = TrainGuardian(step, snapshot_every=2, skip_limit=2, max_rollbacks=2)
    rb0, trips0 = stat_get("rollbacks"), stat_get("sentinel_trips")
    configure_faults(SPEC)
    try:
        actions = _guarded(P, step, g, 10)
    finally:
        configure_faults("")
        g.close()
    want_actions, want_rb, want_params = jax_lenet
    assert actions == want_actions
    assert stat_get("rollbacks") - rb0 == want_rb == 1
    assert stat_get("sentinel_trips") - trips0 == 3
    assert g.data_seed == 1
    got = {k: v.numpy() for k, v in net.state_dict().items()}
    clean = {k: v.numpy() for k, v in clean_net.state_dict().items()}
    for k, w in want_params.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-6,
                                   err_msg=k)
        assert np.array_equal(got[k], clean[k]), k


def test_abort_after_max_rollbacks(lenet_state):
    P = paddle_tpu_torch
    _, step = _lenet(P, lenet_state)
    g = TrainGuardian(step, snapshot_every=1, skip_limit=0, max_rollbacks=1)
    configure_faults("nan_grad@step=2:repeat=100")
    with pytest.raises(TrainingAborted):
        _guarded(P, step, g, 50)
    g.close()


# -- crash, preemption, restore, watchdog, backoff, buffers -------------------

def _mlp(paddle, seed, sentinel=True, bn=False):
    paddle.seed(seed)
    layers = [paddle.nn.Linear(8, 16)]
    if bn:
        layers.append(paddle.nn.BatchNorm1D(16))
    layers += [paddle.nn.ReLU(), paddle.nn.Linear(16, 4)]
    net = paddle.nn.Sequential(*layers)
    opt = paddle.optimizer.Adam(learning_rate=1e-2,
                                parameters=net.parameters())
    step = paddle.jit.TrainStep(
        net, lambda run, x, y: paddle.nn.functional.cross_entropy(run(x), y),
        opt, sentinel=sentinel)
    return net, step


def _mlp_batch(i, n=16):
    rng = np.random.default_rng(100 + i)
    P = paddle_tpu_torch
    return (P.to_tensor(rng.normal(size=(n, 8)).astype("float32")),
            P.to_tensor(rng.integers(0, 4, (n,)).astype("int64")))


def _loop(step, g, n, start=0):
    i, actions = start, []
    while i < n:
        action = g.after_step(i, step(*_mlp_batch(i)))
        actions.append((i, action))
        if action == "rollback":
            i = g.resume_step
            continue
        if action == "preempt":
            break
        i += 1
    return actions


def _params(net):
    return {k: v.numpy().copy() for k, v in net.state_dict().items()}


def test_crash_then_auto_resume_is_bit_exact(tmp_path):
    P = paddle_tpu_torch
    clean_net, clean_step = _mlp(P, 0)
    for i in range(6):
        clean_step(*_mlp_batch(i))
    ckpt = str(tmp_path / "ckpt")
    _, step = _mlp(P, 0)
    g = TrainGuardian(step, ckpt_dir=ckpt, snapshot_every=2,
                      async_snapshot=True)
    configure_faults("crash@step=3")
    with pytest.raises(InjectedCrash):
        _loop(step, g, 6)
    g.close()
    configure_faults("")
    net2, step2 = _mlp(P, 1)                      # another init
    g2 = TrainGuardian(step2, ckpt_dir=ckpt, snapshot_every=2)
    start = g2.restore_latest()
    assert start == 3 and step2._step_count == 3
    _loop(step2, g2, 6, start)
    g2.close()
    got, want = _params(net2), _params(clean_net)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def test_sigterm_priority_save_restores_bit_exact(tmp_path):
    P = paddle_tpu_torch
    ckpt = str(tmp_path / "ckpt")
    net, step = _mlp(P, 0)
    g = TrainGuardian(step, ckpt_dir=ckpt, snapshot_every=100,
                      save_interval_steps=100)
    assert g.install_preemption_handler()
    saves0 = stat_get("preempt_saves")
    configure_faults("preempt@step=2")
    actions = _loop(step, g, 10)
    configure_faults("")
    assert actions[-1] == (2, "preempt") and g.preempted
    assert stat_get("preempt_saves") - saves0 == 1
    assert g.last_priority_save["step"] == 2
    g.close()
    assert signal.getsignal(signal.SIGTERM) is not None
    net2, step2 = _mlp(P, 1)
    g2 = TrainGuardian(step2, ckpt_dir=ckpt)
    assert g2.restore_latest() == 3
    saved = _params(net)
    for k, v in _params(net2).items():
        assert np.array_equal(v, saved[k]), k
    slots = lambda s: [t.clone() for v in s._slot_values.values() for t in v]
    assert all(torch.equal(a, b) for a, b in zip(slots(step2), slots(step)))
    for k in step.sentinel_state:
        assert torch.equal(step2.sentinel_state[k], step.sentinel_state[k])
    # both continue identically
    for i in range(3, 6):
        a, b = step(*_mlp_batch(i)), step2(*_mlp_batch(i))
        assert float(a) == float(b)
    g2.close()


def test_watchdog_dumps_stacks(tmp_path):
    P = paddle_tpu_torch
    _, step = _mlp(P, 0, sentinel=False)
    g = TrainGuardian(step, ckpt_dir=None, snapshot_every=1000,
                      sentinel=False, watchdog_timeout=0.15)
    g.ckpt_dir = str(tmp_path)
    stalls0 = stat_get("watchdog_stalls")
    float(step(*_mlp_batch(0)))
    g.after_step(0)
    with pytest.warns(UserWarning, match="watchdog"):
        time.sleep(0.6)
    g.close()
    assert stat_get("watchdog_stalls") - stalls0 >= 1
    dump = os.path.join(str(tmp_path), "watchdog_stall.txt")
    assert "watchdog stall" in open(dump).read()


def test_lr_backoff_writes_the_device_scalar():
    P = paddle_tpu_torch
    _, step = _mlp(P, 0)
    g = TrainGuardian(step, snapshot_every=2, skip_limit=0, lr_backoff=0.5)
    configure_faults("nan_grad@step=3")
    actions = _loop(step, g, 5)
    g.close()
    assert (3, "rollback") in actions
    lr = step._lr_dev
    assert lr.dim() == 0 and float(lr) == pytest.approx(0.5e-2, rel=1e-7)
    assert step._lr_dev is lr                   # written in place


def test_tripped_step_restores_batch_norm_buffers():
    P = paddle_tpu_torch
    net, step = _mlp(P, 0, bn=True)
    for i in range(2):
        step(*_mlp_batch(i))
    bufs = {k: b._data for k, b in net.named_buffers()}
    before = {k: t.clone() for k, t in bufs.items()}
    configure_faults("nan_grad@step=2")
    loss = step(*_mlp_batch(2))
    configure_faults("")
    assert bool(loss.health["trip"])
    for k, t in net.named_buffers():
        assert t._data is bufs[k] and torch.equal(t._data, before[k]), k
    step(*_mlp_batch(3))
    assert not all(torch.equal(bufs[k], before[k]) for k in bufs)


def test_unported_parts_raise():
    P = paddle_tpu_torch
    _, step = _mlp(P, 0)
    for kw in (dict(elastic=object()), dict(rebuild=lambda d: d)):
        with pytest.raises(NotImplementedError, match="item 7"):
            TrainGuardian(step, **kw)
    g = TrainGuardian(step)
    with pytest.raises(NotImplementedError, match="item 7"):
        g.resize(["h1"])
    g.close()


def test_async_saves_count_the_step_in_flight(tmp_path):
    """With the writer still busy on step 0, the interval runs from step
    0: no later step is queued (the disk alone reads 'nothing saved')."""
    P = paddle_tpu_torch
    _, step = _mlp(P, 0)
    g = TrainGuardian(step, ckpt_dir=str(tmp_path), snapshot_every=100,
                      async_snapshot=True, save_interval_steps=1000)
    save = g._ckpt.save_behind

    def slow(i, state):
        time.sleep(0.3)
        return save(i, state)

    g._ckpt.save_behind = slow
    _loop(step, g, 5)
    g.close()
    assert sorted(os.listdir(str(tmp_path))) == ["0"]


def test_watchdog_times_from_its_start():
    """The time before the watchdog starts (a slow attach: pinning the
    host buffers) is no stalled step."""
    P = paddle_tpu_torch
    _, step = _mlp(P, 0)
    g = TrainGuardian(None, sentinel=False, watchdog_timeout=0.3)
    time.sleep(0.5)
    stalls0 = stat_get("watchdog_stalls")
    g.attach(step)
    time.sleep(0.2)
    g.close()
    assert stat_get("watchdog_stalls") == stalls0


def test_waiting_for_the_writer_is_no_stall(tmp_path):
    """``drain_snapshots`` (the loop waiting for the async writer) is no
    stalled step; outlasting the timeout, it is reported once as an I/O
    stall, with the stack dump."""
    P = paddle_tpu_torch
    _, step = _mlp(P, 0)
    g = TrainGuardian(step, ckpt_dir=str(tmp_path), snapshot_every=100,
                      async_snapshot=True, watchdog_timeout=0.2,
                      save_interval_steps=100)
    save = g._ckpt.save_behind

    def slow(i, state):
        time.sleep(0.8)
        return save(i, state)

    g._ckpt.save_behind = slow
    stalls0 = stat_get("watchdog_stalls")
    g.after_step(0, step(*_mlp_batch(0)))
    with pytest.warns(UserWarning, match="writer drain has waited"):
        g.drain_snapshots()
    g.after_step(1, step(*_mlp_batch(1)))
    g.close()
    assert stat_get("watchdog_stalls") == stalls0
    assert [k for _, _, k in g.stall_log] == ["writer drain"]
    dump = open(os.path.join(str(tmp_path), "watchdog_stall.txt")).read()
    assert "guardian I/O stall in the writer drain" in dump


def test_a_wedged_priority_save_is_reported(tmp_path):
    """A priority save stuck on the filesystem past the timeout gives an
    I/O stall report while it waits, not silence."""
    P = paddle_tpu_torch
    _, step = _mlp(P, 0)
    g = TrainGuardian(step, ckpt_dir=str(tmp_path), snapshot_every=100,
                      watchdog_timeout=0.2)
    save = g._ckpt.save

    def wedged(i, state):
        time.sleep(0.8)
        return save(i, state)

    g._ckpt.save = wedged
    stalls0 = stat_get("watchdog_stalls")
    g.after_step(0, step(*_mlp_batch(0)))
    g._preempted = True
    with pytest.warns(UserWarning, match="priority save has waited"):
        assert g.after_step(1, step(*_mlp_batch(1))) == "preempt"
    g.close()
    assert stat_get("watchdog_stalls") == stalls0
    assert [k for _, _, k in g.stall_log] == ["priority save"]
