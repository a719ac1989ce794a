"""paddle_tpu_torch's ReplicaSupervisor against paddle_tpu's.

- the restart ladder: for attempts 0..max_restarts a death and a failed
  spawn put the slot on the same rung (immediate, backoff delay,
  quarantine hold, give-up) in both packages, with the same spans, the
  same ``ReplicaFailed`` message on the orphans, and the same
  (host, replica) ladder switch on ``note_host_offer`` (a clock both
  supervisors read, over a router stand-in);
- restart and rejoin: a whole-set death (``replica_crash``) parks the
  streams as orphans, the first respawn fails (``spawn_fail``), the
  second rejoins and adopts them: greedy streams equal the JAX
  supervised router's and the fault-free JAX engine's, fixed and paged;
  sampled streams and the request-id space equal the port's undisturbed
  run; ``replica_flap`` climbs the ladder; the ladder's give-up fails
  the orphans loudly;
- the prefix re-warm of a rejoined replica (``prefix_warm_tokens``, the
  radix tree holds the hot prefix, less prefill work than a cold
  engine);
- autoscaling: a sustained rung grows the set, an idle one drains it,
  and a drained victim's open stream migrates and equals the JAX
  engine's stream.

gpt_nano, f32, block matrices x4 so greedy streams vary. No test pins a
wall-clock bound: waits are on conditions.
"""
import functools
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import monitor as jmon
from paddle_tpu.models import gpt as jg
from paddle_tpu.resilience import faults as jfaults
from paddle_tpu.serving import EngineRouter as JaxRouter
from paddle_tpu.serving import InferenceEngine as JaxEngine
from paddle_tpu.serving import ReplicaSupervisor as JaxSupervisor
from paddle_tpu.serving import lifecycle as jlife
from paddle_tpu_torch import monitor
from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.resilience import faults as tfaults
from paddle_tpu_torch.serving import (EngineRouter, InferenceEngine,
                                      OverloadController, ReplicaFailed,
                                      ReplicaSupervisor)
from paddle_tpu_torch.serving import lifecycle as tlife
from paddle_tpu_torch.serving.overload import (RUNG_HEALTHY, RUNG_NO_SPEC,
                                               RUNG_SMALL_CHUNKS)
from torch_jax_util import scaled_params

CFG_J = jg.gpt_nano(dtype=jnp.float32, seq_len=128)
CFG = tg.gpt_nano(dtype=torch.float32, seq_len=128)
KW = dict(n_slots=2, block_size=8, prefill_chunk=16, seed=0)
FAST = dict(poll_s=0.02, backoff_s=0.02, backoff_cap_s=0.1,
            quarantine_s=0.1, stable_s=0.3)
REJOIN = "replica_crash@step=4:replica=0,spawn_fail@restart=1"
NEW = 12


@functools.lru_cache(maxsize=None)
def _params():
    return scaled_params(CFG_J, seed=7)


def _prompts(n=3, length=9, seed=0):
    rng = np.random.default_rng(300 + seed)
    return [rng.integers(0, CFG.vocab_size, length).astype(np.int32)
            for _ in range(n)]


def _wait(pred, timeout=120.0, poll=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(poll)
    return pred()


@pytest.fixture
def engine():
    engines = []

    def make(paged=True, **kw):
        _, params = _params()
        eng = InferenceEngine(CFG, params, device="cpu", paged=paged,
                              **{**KW, **kw})
        engines.append(eng)
        return eng

    yield make
    tfaults.configure_faults("")
    for eng in engines:
        eng.shutdown(drain=False, timeout=30)


def _supervised(engine, n=1, factory_kw=None, **sup_kw):
    factory_kw = dict(factory_kw or {})

    def factory():
        return engine(**factory_kw)

    router = EngineRouter([factory() for _ in range(n)])
    sup = ReplicaSupervisor(router, factory, **{**FAST, **sup_kw})
    return router, sup


@functools.lru_cache(maxsize=None)
def _jax_streams(paged, supervised, prompts=None, new=NEW):
    """Greedy streams of ``prompts`` (default ``_prompts()``): through a
    1-replica JAX router with a supervisor under REJOIN, or one 4-slot
    JAX engine (fault-free)."""
    prompts = _prompts() if prompts is None else [np.asarray(p, np.int32)
                                                  for p in prompts]
    tree, _ = _params()
    jt = jax.tree.map(jnp.asarray, tree)
    kw = {**KW, "paged": paged}
    if not supervised:
        eng = JaxEngine(CFG_J, jt, **{**kw, "n_slots": 4})
        try:
            return [eng.generate(p, max_new_tokens=new) for p in prompts]
        finally:
            eng.shutdown()

    def factory():
        return JaxEngine(CFG_J, jt, **kw)

    jfaults.configure_faults(REJOIN)
    router = JaxRouter([factory()])
    JaxSupervisor(router, factory, **FAST)
    try:
        reqs = [router.submit(p, max_new_tokens=new) for p in prompts]
        return [r.result(timeout=180) for r in reqs]
    finally:
        jfaults.configure_faults("")
        router.shutdown(drain=False, timeout=60)


# ==========================================================================
# the restart ladder, against the JAX supervisor
# ==========================================================================

class _Router:
    """The router surface a supervisor calls, with one replica id and no
    engines behind it."""

    def __init__(self):
        self.supervisor = None
        self.n_replicas = 1
        self.tick_age_budget_s = 5.0
        self.overload = None
        self.engines = [types.SimpleNamespace(replica_id=0, host=None)]
        self.orphans_failed = []

    def engine_for(self, rid):
        raise KeyError(rid)

    def remove_replica(self, rid):
        return None

    def fail_orphans(self, err=None):
        self.orphans_failed.append(str(err))
        return 0


def _ladder(sup_cls, mon, life, cfg, monkeypatch):
    """Every rung of ``sup_cls``'s ladder on a frozen clock: for each
    attempt count, the slot's state and delay after a death and after a
    failed spawn, the spans, the orphans' error, then a host swap."""
    clock = [1000.0]
    monkeypatch.setattr(life.time, "monotonic", lambda: clock[0])
    router = _Router()
    sup = sup_cls(router, lambda: None, poll_s=1e6, **cfg)
    writer = mon.start_tracing()
    out = []
    try:
        st = sup._slots[0]
        dead = types.SimpleNamespace(_rid=5, host=None,
                                     evacuate=lambda: None)
        for a in range(sup.max_restarts + 1):
            st.state, st.attempts = "live", a
            sup._on_death(0, st, dead, "dead")
            out.append(("death", a, st.state, st.next_try_t - clock[0]))
            if a:
                st.state, st.attempts = "pending", a
                sup._on_spawn_failure(0, st, RuntimeError("boom"))
                out.append(("spawn", a, st.state, st.next_try_t - clock[0],
                            st.cause))
        st.state, st.attempts, st.host = "quarantined", 2, "a"
        sup._ladders[("b", 0)] = 1
        out.append(("offer", sup.note_host_offer(0, "b"), st.state,
                    st.attempts, st.next_try_t - clock[0],
                    sup.note_host_offer(0, "b")))
        st.state, st.host = "live", "b"
        sup._on_death(0, st, types.SimpleNamespace(
            _rid=9, host="c", evacuate=lambda: None), "wedged")
        out.append(("swap", st.state, st.attempts, st.host, st.old_rid,
                    sorted(sup._ladders.items(), key=str)))
    finally:
        mon.stop_tracing()
        sup.close()
    out.append(("orphans", router.orphans_failed))
    out.append(("spans", [(e["name"], e["args"]) for e in writer.events()]))
    return out


@pytest.mark.parametrize("cfg", [
    dict(max_restarts=3, quarantine_after=2),
    dict(max_restarts=5, quarantine_after=3, backoff_s=0.1,
         backoff_cap_s=0.25, quarantine_s=2.0),
    dict(max_restarts=1, quarantine_after=1, quarantine_s=0.5),
], ids=["default", "capped", "one"])
def test_ladder_matches_jax(cfg, monkeypatch):
    got = _ladder(ReplicaSupervisor, monitor, tlife, cfg, monkeypatch)
    want = _ladder(JaxSupervisor, jmon, jlife, cfg, monkeypatch)
    assert got == want
    rungs = {s for r in got if r[0] in ("death", "spawn") for s in [r[2]]}
    assert rungs >= {"pending", "failed"}
    assert any(name == "lifecycle.give_up" for name, _ in got[-1][1])


def test_supervisor_validation(engine):
    router = EngineRouter([engine()])
    with pytest.raises(ValueError, match="min_replicas"):
        ReplicaSupervisor(router, engine, min_replicas=0)
    with pytest.raises(ValueError, match="max_replicas"):
        ReplicaSupervisor(router, engine, min_replicas=2, max_replicas=1)
    with pytest.raises(ValueError, match="quarantine_after"):
        ReplicaSupervisor(router, engine, quarantine_after=9,
                          max_restarts=3)
    sup = ReplicaSupervisor(router, engine, poll_s=0.02)
    with pytest.raises(ValueError, match="already has a supervisor"):
        ReplicaSupervisor(router, engine)
    assert sup.target_replicas == 1 and "live" in repr(sup)
    sup.close()


# ==========================================================================
# restart and rejoin
# ==========================================================================

@pytest.mark.parametrize("paged", [True, False])
def test_restart_rejoin_streams_equal_jax(engine, paged):
    rs0 = monitor.stat_get("serving_replica_restarts")
    tfaults.configure_faults(REJOIN)
    router, sup = _supervised(engine, factory_kw={"paged": paged})
    reqs = [router.submit(p, max_new_tokens=NEW) for p in _prompts()]
    outs = [r.result(timeout=180) for r in reqs]
    assert outs == _jax_streams(paged, True) == _jax_streams(paged, False)
    assert all(r.finish_reason == "length" for r in reqs)
    assert _wait(lambda: sup.snapshot()["rejoins"] == 1)
    snap = sup.snapshot()
    assert snap["spawns"] == 2                  # the first one failed
    assert snap["replicas"]["0"]["state"] == "live"
    assert monitor.stat_get("serving_replica_restarts") == rs0 + 2
    assert router.healthy_replicas() == [0]
    router.shutdown(drain=True, timeout=60)


@pytest.mark.parametrize("paged", [True, False])
def test_sampled_streams_and_rid_space_survive_rejoin(engine, paged):
    kw = dict(max_new_tokens=10, temperature=0.9, top_k=7)
    prompts = _prompts(4, seed=1)
    ref = engine(paged=paged, n_slots=4)
    want = [ref.generate(p, **kw) for p in prompts]
    tfaults.configure_faults("replica_crash@step=4:replica=0")
    router, sup = _supervised(engine, factory_kw={"paged": paged})
    reqs = [router.submit(p, **kw) for p in prompts[:3]]
    assert [r.result(timeout=180) for r in reqs] == want[:3]
    assert _wait(lambda: sup.snapshot()["rejoins"] == 1)
    late = router.submit(prompts[3], **kw)
    assert late.result(timeout=120) == want[3]
    assert late.rid == 3                # numbering carried past the dead
    router.shutdown(drain=True, timeout=60)


def test_flapping_replica_climbs_the_ladder(engine):
    p = _prompts(1, seed=2)[0]
    tfaults.configure_faults("replica_crash@step=4:replica=0,"
                             "replica_flap@restart=1:times=2")
    router, sup = _supervised(engine, max_restarts=5)
    req = router.submit(p, max_new_tokens=24)
    assert req.result(timeout=240) == _jax_streams(
        True, False, (tuple(p),), 24)[0]
    assert _wait(lambda: sup.snapshot()["replicas"]["0"]["state"]
                 == "live" and sup.snapshot()["rejoins"] >= 3)
    router.shutdown(drain=True, timeout=60)


def test_give_up_fails_orphans_loudly(engine):
    writer = monitor.start_tracing()
    tfaults.configure_faults("replica_crash@step=3:replica=0,"
                             "spawn_fail@restart=1:times=10")
    try:
        router, sup = _supervised(engine, max_restarts=3,
                                  quarantine_after=2)
        req = router.submit(_prompts(1, 8, seed=3)[0], max_new_tokens=16)
        with pytest.raises(RuntimeError) as ei:
            req.result(timeout=120)
        assert isinstance(ei.value.__cause__, ReplicaFailed)
        assert _wait(lambda: sup.snapshot()["replicas"]["0"]["state"]
                     == "failed")
        assert sup.snapshot()["spawns"] == 3
    finally:
        monitor.stop_tracing()
    names = [e["name"] for e in writer.events()]
    assert names.count("lifecycle.restart") == 3
    assert "lifecycle.quarantine" in names
    assert "lifecycle.give_up" in names
    router.shutdown(drain=False, timeout=30)


def test_supervisor_without_faults_never_wakes(engine):
    p = _prompts(1, 12, seed=4)[0]
    expected = EngineRouter([engine()]).generate(p, max_new_tokens=NEW)
    router, sup = _supervised(engine)
    assert router.generate(p, max_new_tokens=NEW) == expected
    assert sup.snapshot()["spawns"] == 0
    router.shutdown(drain=True, timeout=60)


def test_rejoin_rewarms_the_prefix_tree(engine):
    head = _prompts(1, 48, seed=5)[0]
    tails = [np.concatenate([head, t]) for t in _prompts(4, 6, seed=6)]
    kw = {"prefix_cache": True, "n_blocks": 65}
    warm0 = monitor.stat_get("prefix_warm_tokens")
    tfaults.configure_faults("replica_crash@step=60:replica=0")
    router, sup = _supervised(engine, factory_kw=kw)
    for t in tails[:2]:
        router.submit(t, max_new_tokens=2).result(timeout=120)
    router.submit(tails[2], max_new_tokens=80).result(timeout=180)
    assert _wait(lambda: sup.snapshot()["rejoins"] == 1
                 and sup.snapshot()["replicas"]["0"]["state"] == "live")
    assert monitor.stat_get("prefix_warm_tokens") - warm0 >= 48
    eng = router.engine_for(0)
    assert eng.run_on_scheduler(lambda e: e._prefix.peek(head),
                                timeout=60) == 48

    def prefill_work(fn):
        writer = monitor.start_tracing()
        try:
            fn()
        finally:
            monitor.stop_tracing()
        return sum(e["args"]["chunk"] for e in writer.events()
                   if e["name"] == "serving.prefill_chunk")

    warm = prefill_work(lambda: router.submit(
        tails[3], max_new_tokens=2).result(timeout=120))
    cold = engine(**kw)
    assert warm < prefill_work(
        lambda: cold.generate(tails[3], max_new_tokens=2))
    router.shutdown(drain=True, timeout=60)


# ==========================================================================
# autoscaling
# ==========================================================================

def _ctl():
    return OverloadController(queue_wait_budget_ms=1e9, tick_budget_ms=1e9)


def test_scale_up_on_a_sustained_rung(engine):
    ctl = _ctl()
    ev0 = monitor.stat_get("serving_scale_events")
    router, sup = _supervised(
        engine, factory_kw={"overload": ctl}, max_replicas=2,
        scale_up_rung=RUNG_NO_SPEC, scale_up_after=3,
        scale_down_after=1000, scale_cooldown_s=0.05)
    ctl.force_rung(RUNG_SMALL_CHUNKS)
    assert _wait(lambda: router.n_replicas == 2
                 and sup.snapshot()["scale_ups"] == 1)
    assert sorted(router.healthy_replicas()) == [0, 1]
    assert monitor.stat_get("serving_replicas_target") == 2
    assert monitor.stat_get("serving_scale_events") == ev0 + 1
    ctl.force_rung(RUNG_HEALTHY)
    router.shutdown(drain=True, timeout=60)


def test_scale_down_drains_to_the_floor(engine):
    ctl = _ctl()
    router, sup = _supervised(
        engine, n=2, factory_kw={"overload": ctl}, min_replicas=1,
        max_replicas=2, scale_up_after=1000, scale_down_after=3,
        scale_down_occupancy=0.5, scale_cooldown_s=0.05)
    assert _wait(lambda: router.n_replicas == 1
                 and sup.snapshot()["scale_downs"] == 1)
    assert monitor.stat_get("serving_replicas_target") == 1
    assert router.healthy_replicas() == [0]     # ties: the highest id goes
    router.shutdown(drain=True, timeout=60)


def test_drain_migrates_open_streams_equal_jax(engine):
    ctl = _ctl()
    pm = _prompts(1, 10, seed=7)[0]
    router, sup = _supervised(
        engine, n=2, factory_kw={"overload": ctl}, min_replicas=1,
        scale_up_after=1000, scale_down_after=3, scale_down_occupancy=1.1,
        scale_cooldown_s=0.05, drain_timeout_s=0.1)
    # load replica 0 harder so the least-loaded victim is replica 1,
    # whose ticks a slow_tick fault stretches past the drain timeout
    tfaults.configure_faults("slow_tick@step=0:secs=0.01:repeat=100000:"
                             "replica=1")
    hogs = [router.submit(p, max_new_tokens=40)
            for p in _prompts(3, 8, seed=8)]
    mig = router.submit(pm, max_new_tokens=48)
    assert mig._replica == 1
    assert _wait(lambda: router.n_replicas == 1)
    assert mig.result(timeout=180) == _jax_streams(
        True, False, (tuple(pm),), 48)[0]
    assert mig._replica == 0                    # adopted by the survivor
    for h in hogs:
        h.result(timeout=180)
    assert _wait(lambda: sup.snapshot()["scale_downs"] == 1)
    router.shutdown(drain=True, timeout=60)
