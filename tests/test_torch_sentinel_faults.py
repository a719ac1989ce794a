"""The training sentinel and the train-step fault hooks of
paddle_tpu_torch against paddle_tpu.

- ``sentinel.update`` on seeded (loss, grad norm) sequences holding a
  NaN loss, an inf norm and a spike after the warm-up: every state field
  (f32 mean and var, int32 n and trips, bool last_trip) EXACTLY equal to
  the JAX function's at every step (the same f32 operations in the same
  order, each rounded once); ``gate`` exactly; ``global_grad_norm`` over
  an f32 / bf16 tree within 1e-6 relative (the two sums reduce in
  different orders).
- The registries: the same spec fires the same kinds at the same step
  indices in both, a rollback replay of spent faults included; the
  ``p=`` draws, ``on_input``, ``on_ckpt_io`` and ``on_train_step`` (its
  crash, and nan_grad's corruption of float leaves only).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.monitor import stats as jstats
from paddle_tpu.resilience import faults as jfaults
from paddle_tpu.resilience import sentinel as jsent
from paddle_tpu_torch.monitor import stats as tstats
from paddle_tpu_torch.resilience import faults as tfaults
from paddle_tpu_torch.resilience import sentinel as tsent
from torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)

CFG = {"z_thresh": 3.0, "warmup": 5, "ema_decay": 0.9}
FIELDS = ("mean", "var", "n", "trips", "last_trip")


def _sequence(seed):
    rng = np.random.default_rng(seed)
    loss = (2.0 + 0.1 * rng.normal(size=24)).astype(np.float32)
    gn = (1.0 + 0.05 * rng.normal(size=24)).astype(np.float32)
    loss[8] = np.nan                    # a NaN loss
    gn[11] = np.inf                     # an infinite norm
    gn[14] = 50.0                       # a spike after the warm-up
    gn[15] = 1.0e-3                     # and a dip
    loss[19] = -np.inf
    return loss, gn


@pytest.fixture(scope="module")
def jax_states():
    """The JAX sentinel's state after each step of each sequence."""
    out = {}
    for seed in (0, 1):
        loss, gn = _sequence(seed)
        st = jsent.init_state()
        seq = []
        for lo, g in zip(loss, gn):
            st = jsent.update(st, jnp.float32(lo), jnp.float32(g), CFG)
            seq.append({k: np.asarray(v) for k, v in st.items()})
        out[seed] = seq
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_update_matches_jax_exactly(jax_states, seed):
    loss, gn = _sequence(seed)
    st = tsent.init_state("cpu")
    assert {k: v.dtype for k, v in st.items()} == {
        "mean": torch.float32, "var": torch.float32, "n": torch.int32,
        "trips": torch.int32, "last_trip": torch.bool}
    trips = []
    for i, (lo, g) in enumerate(zip(loss, gn)):
        ids = {k: id(v) for k, v in st.items()}
        out = tsent.update(st, torch.tensor(lo), torch.tensor(g), CFG)
        assert out is st and {k: id(v) for k, v in st.items()} == ids
        want = jax_states[seed][i]
        for k in FIELDS:
            got = st[k].numpy()
            assert got.dtype == want[k].dtype, k
            assert got.tobytes() == want[k].tobytes(), (i, k, got, want[k])
        trips.append(bool(st["last_trip"]))
    # the NaN, the inf, the spike and -inf all tripped
    assert {8, 11, 14, 19} <= {i for i, t in enumerate(trips) if t}
    assert tsent.read_health(st) == jsent.read_health(
        {k: jnp.asarray(v) for k, v in jax_states[seed][-1].items()})


def test_gate_and_norm_match_jax():
    rng = np.random.default_rng(3)
    tree = {"b": {"w": rng.normal(size=(7, 5)).astype(np.float32)},
            "a": rng.normal(size=(33,)).astype(np.float32),
            "c": (rng.normal(size=(4, 4)) * 3).astype(np.float32)}
    old = {k: (v * 0 + 1 if not isinstance(v, dict) else
               {"w": v["w"] * 0 + 1}) for k, v in tree.items()}
    tt = lambda t: ({k: tt(v) for k, v in t.items()}
                    if isinstance(t, dict) else torch.tensor(t))
    jt = lambda t: ({k: jt(v) for k, v in t.items()}
                    if isinstance(t, dict) else jnp.asarray(t))
    for trip in (False, True):
        want = jsent.gate(jnp.bool_(trip), jt(tree), jt(old))
        got = tsent.gate(torch.tensor(trip), tt(tree), tt(old))
        for k in ("a", "c"):
            assert np.array_equal(got[k].numpy(), np.asarray(want[k]))
        assert np.array_equal(got["b"]["w"].numpy(),
                              np.asarray(want["b"]["w"]))
    # a bf16 leaf: each leaf goes to f32 before it is squared
    tree["d"] = rng.normal(size=(9,)).astype(np.float32)
    jtree = jt(tree)
    jtree["d"] = jtree["d"].astype(jnp.bfloat16)
    ttree = tt(tree)
    ttree["d"] = ttree["d"].to(torch.bfloat16)
    want = float(jsent.global_grad_norm(jtree))
    got = tsent.global_grad_norm(ttree)
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-6 * want
    # in place: the state tensors keep their storage through gate_
    a, b = torch.ones(3), torch.zeros(3)
    ptr = a.data_ptr()
    tsent.gate_(torch.tensor(True), [a], [b])
    assert a.data_ptr() == ptr and torch.equal(a, b)


SPEC = ("nan_grad@step=2:repeat=2,crash@step=5,stall@step=3:secs=0,"
        "preempt@step=7,nan_grad@step=9,host_loss@step=4:host=h1,"
        "kv_partition@step=6:secs=0")
KINDS = ("crash", "stall", "preempt", "nan_grad", "host_loss",
         "kv_partition")
# a rollback after step 4 replays 3 and 4; then a second rewind
STEPS = [0, 1, 2, 3, 4, 3, 4, 5, 6, 7, 8, 6, 7, 8, 9, 10, 9, 10]


def _fired(mod):
    mod.FAULTS.configure(SPEC)
    try:
        return [(s, k) for s in STEPS for k in KINDS
                if mod.FAULTS.take(k, s) is not None]
    finally:
        mod.FAULTS.configure("")


def test_step_faults_fire_at_the_same_steps():
    want = _fired(jfaults)
    assert _fired(tfaults) == want
    # each step fault fires once per budget unit, spent faults stay quiet
    # on the replay: nan_grad at 2 and 3 only, never again at 3
    assert [s for s, k in want if k == "nan_grad"] == [2, 3, 9]
    assert [s for s, k in want if k == "stall"] == [3]
    # a second take of the same index hands nothing out again
    tfaults.FAULTS.configure("crash@step=1")
    try:
        assert tfaults.FAULTS.take("crash", 1) is not None
        assert tfaults.FAULTS.take("crash", 1) is None
    finally:
        tfaults.FAULTS.configure("")


def _p_and_hooks(mod, stats):
    mod.FAULTS.configure("ckpt_io_error@p=0.5:seed=7:repeat=4,"
                         "input_stall@step=2:secs=0:repeat=2")
    try:
        n0 = stats.stat_get("faults_injected")
        io = []
        for _ in range(12):
            try:
                mod.FAULTS.on_ckpt_io()
                io.append(False)
            except OSError:
                io.append(True)
        for i in range(6):
            mod.FAULTS.on_input(i)
        return io, stats.stat_get("faults_injected") - n0
    finally:
        mod.FAULTS.configure("")


def test_p_faults_and_hooks_match_jax():
    want = _p_and_hooks(jfaults, jstats)
    assert _p_and_hooks(tfaults, tstats) == want
    assert sum(want[0]) == 4 and want[1] == 6


def test_on_train_step_crash_and_nan_grad():
    from paddle_tpu_torch.framework.core import Tensor

    tfaults.FAULTS.configure("crash@step=1,nan_grad@step=2")
    try:
        batch = (Tensor(torch.ones(2, 3)), np.arange(4, dtype=np.int64),
                 {"w": torch.ones(3, dtype=torch.bfloat16),
                  "ids": torch.arange(3)}, [np.ones(2, np.float32)])
        assert tfaults.FAULTS.on_train_step(0, batch) is batch
        with pytest.raises(tfaults.InjectedCrash):
            tfaults.FAULTS.on_train_step(1, batch)
        out = tfaults.FAULTS.on_train_step(2, batch)
    finally:
        tfaults.FAULTS.configure("")
    assert type(out) is tuple and isinstance(out[0], Tensor)
    assert torch.isnan(out[0]._data).all()
    assert np.array_equal(out[1], batch[1])
    assert out[2]["w"].dtype == torch.bfloat16 and torch.isnan(
        out[2]["w"]).all()
    assert torch.equal(out[2]["ids"], batch[2]["ids"])
    assert np.isnan(out[3][0]).all()
    # the reference corrupts the same leaves
    jout = jfaults._corrupt_batch((np.ones(2, np.float32),
                                   np.arange(4, dtype=np.int64)))
    assert np.isnan(jout[0]).all() and np.array_equal(jout[1], np.arange(4))


def test_resilience_gauges_exist_in_both():
    names = ("sentinel_trips", "rollbacks", "preempt_saves",
             "watchdog_stalls", "guardian_heartbeat_ms", "pod_hosts_alive",
             "elastic_resizes", "host_memory_bytes", "device_memory_bytes")
    for n in names:
        assert n in jstats.stat_names() and n in tstats.stat_names(), n
    got = tstats.update_memory_stats()
    assert got["host_memory_bytes"] > 0
    assert set(got) == {"host_memory_bytes", "device_memory_bytes"}
