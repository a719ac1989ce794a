"""``hapi.Model.fit(resilience=...)`` and the ``Monitor`` callback of
paddle_tpu_torch against paddle_tpu, on the CPU.

- A NaN burst (``nan_grad@step=2:repeat=2``) under
  ``fit(resilience={snapshot_every: 1, skip_limit: 0, ...})``: the same
  per-batch losses as the JAX fit (NaN where it is NaN, 1e-5 otherwise,
  from the same carried weights), the same rollbacks, finite params;
- ``resilience=True`` with no fault matches a plain ``fit`` bit for bit;
- ``Monitor`` puts the same keys in the step logs as the JAX callback
  (``step_time_s``, ``recompiles``, ``examples_per_sec``), and its
  summary has the same keys.
"""
import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu import monitor as jmon
from paddle_tpu.resilience import configure_faults as jconfigure
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import monitor as tmon
from paddle_tpu_torch.resilience import configure_faults
from torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)

LOSS_TOL = 1e-5


@pytest.fixture(autouse=True)
def on_cpu():
    old = tdevice._current[0]
    paddle_tpu_torch.set_device("cpu")
    yield
    tdevice._current[0] = old
    configure_faults("")
    jconfigure("")


class _DS:
    def __len__(self):
        return 32

    def __getitem__(self, i):
        rng = np.random.default_rng(i)
        x = rng.normal(size=(8,)).astype("float32")
        return x, np.array(int(x[0] > 0), dtype="int64")


@pytest.fixture(scope="module")
def weights():
    paddle_tpu.seed(1)
    net = paddle_tpu.nn.Sequential(paddle_tpu.nn.Linear(8, 16),
                                   paddle_tpu.nn.ReLU(),
                                   paddle_tpu.nn.Linear(16, 2))
    return {k: np.asarray(v.numpy()) for k, v in net.state_dict().items()}


def _model(paddle, weights):
    net = paddle.nn.Sequential(paddle.nn.Linear(8, 16), paddle.nn.ReLU(),
                               paddle.nn.Linear(16, 2))
    net.set_state_dict(weights)
    opt = paddle.optimizer.Adam(learning_rate=1e-2,
                                parameters=net.parameters())
    m = paddle.Model(net)
    m.prepare(optimizer=opt, loss=paddle.nn.CrossEntropyLoss())
    return m


def _fit(paddle, weights, resilience, callbacks=()):
    losses, keys = [], []

    class Rec(paddle.callbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            losses.append(logs["loss"])
            keys.append(sorted(logs))

    m = _model(paddle, weights)
    m.fit(_DS(), batch_size=8, epochs=2, verbose=0, log_freq=1,
          shuffle=False, callbacks=list(callbacks) + [Rec()],
          resilience=resilience)
    return m, losses, keys


RES = {"snapshot_every": 1, "skip_limit": 0, "max_rollbacks": 3}


@pytest.fixture(scope="module")
def jax_burst(weights):
    rb0 = jmon.stat_get("rollbacks")
    jconfigure("nan_grad@step=2:repeat=2")
    try:
        _, losses, _ = _fit(paddle_tpu, weights, dict(RES))
    finally:
        jconfigure("")
    return losses, jmon.stat_get("rollbacks") - rb0


def test_fit_resilience_survives_a_nan_burst_as_jax(weights, jax_burst):
    rb0 = tmon.stat_get("rollbacks")
    configure_faults("nan_grad@step=2:repeat=2")
    m, losses, _ = _fit(paddle_tpu_torch, weights, dict(RES))
    configure_faults("")
    want, want_rb = jax_burst
    assert tmon.stat_get("rollbacks") - rb0 == want_rb >= 1
    assert len(losses) == len(want)
    for got, w in zip(losses, want):
        assert (np.isnan(got) and np.isnan(w)) or abs(got - w) <= LOSS_TOL
    assert sum(np.isnan(losses)) == 2
    for _, p in m.network.named_parameters():
        assert np.all(np.isfinite(p.numpy()))


def test_fit_resilience_unset_matches_plain_fit(weights):
    _, plain, _ = _fit(paddle_tpu_torch, weights, None)
    _, guarded, _ = _fit(paddle_tpu_torch, weights, True)
    assert plain == guarded and len(plain) == 8


def test_monitor_logs_the_reference_keys(weights):
    mons = {}
    keys = {}
    for name, paddle in (("jax", paddle_tpu), ("port", paddle_tpu_torch)):
        mon = paddle.callbacks.Monitor()
        _, _, k = _fit(paddle, weights, None, callbacks=[mon])
        mons[name], keys[name] = mon, k
    assert keys["port"] == keys["jax"]
    assert {"step_time_s", "recompiles", "examples_per_sec"} <= set(
        keys["port"][0])
    assert sorted(mons["port"].summary()) == sorted(mons["jax"].summary())
    hist = mons["port"].telemetry.history
    assert len(hist) == 8 and all(h["step_time_s"] > 0 for h in hist)
    assert hist[1]["examples_per_sec"] == pytest.approx(
        8 / hist[1]["step_time_s"])
