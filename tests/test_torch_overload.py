"""paddle_tpu_torch's brownout controller and serving fault specs against
paddle_tpu's.

``serving/overload.py`` and ``resilience/faults.py`` are pure Python in
both packages: the same observation sequence must step both controllers
through the same rungs with the same gauges and snapshots, every spec
string the reference parses must parse here to the same fields, and the
request-, tick-, restart- and connection-keyed claims must follow the
same budgets. Mirrors
``tests/test_serving_overload.py``'s controller and fault-spec cases.
"""
import numpy as np
import pytest

from paddle_tpu import monitor as jmonitor
from paddle_tpu.resilience import faults as jfaults
from paddle_tpu.serving import overload as jover
from paddle_tpu_torch import monitor as tmonitor
from paddle_tpu_torch.resilience import faults as tfaults
from paddle_tpu_torch.serving import overload as tover


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    jfaults.configure_faults("")
    tfaults.configure_faults("")


def _sequences():
    rng = np.random.default_rng(11)
    storm = [("tick", float(v)) for v in rng.uniform(0, 400, 40)]
    waits = [("wait", float(v)) for v in rng.uniform(0, 900, 30)]
    return {
        "hysteresis_up": [("tick", 500.0)] * 4,
        "band_resets_streak": [("tick", 500.0), ("tick", 80.0),
                               ("tick", 500.0), ("tick", 500.0)],
        "full_ladder_and_back": [("tick", 1000.0)] * 7
        + [("tick", 0.0)] * 60,
        "random_storm": storm,
        "queue_waits": waits + [("tick", 10.0)] * 20,
    }


SEQS = _sequences()
KNOBS = [dict(), dict(tick_budget_ms=100, step_up_after=2, low_water=0.5,
                      alpha=1.0),
         dict(tick_budget_ms=100, alpha=1.0, step_up_after=1,
              step_down_after=3),
         dict(queue_wait_budget_ms=150, tick_budget_ms=50, alpha=0.5,
              step_up_after=2, step_down_after=2)]


@pytest.mark.parametrize("knobs", range(len(KNOBS)))
@pytest.mark.parametrize("seq", sorted(SEQS))
def test_same_observations_same_rungs_and_gauges(seq, knobs):
    kw = KNOBS[knobs]
    j, t = jover.OverloadController(**kw), tover.OverloadController(**kw)
    steps0 = (jmonitor.stat_get("brownout_steps"),
              tmonitor.stat_get("brownout_steps"))
    for kind, v in SEQS[seq]:
        for ctl in (j, t):
            (ctl.observe_tick if kind == "tick"
             else ctl.observe_queue_wait)(v)
        assert t.rung == j.rung and t.rung_name == j.rung_name
        assert tmonitor.stat_get("brownout_rung") \
            == jmonitor.stat_get("brownout_rung") == j.rung
        assert t.pressure() == j.pressure()
        js, ts = j.snapshot(), t.snapshot()
        js.pop("rung_held_s")
        ts.pop("rung_held_s")
        assert ts == js
    assert tmonitor.stat_get("brownout_steps") - steps0[1] \
        == jmonitor.stat_get("brownout_steps") - steps0[0]


@pytest.mark.parametrize("rung", range(6))
def test_knobs_per_rung_match(rung):
    j = jover.OverloadController(token_cap=8, chunk_shrink=4)
    t = tover.OverloadController(token_cap=8, chunk_shrink=4)
    j.force_rung(rung)
    t.force_rung(rung)
    assert t.spec_allowed() == j.spec_allowed()
    for base in (None, 16, 64, 100):
        assert t.prefill_chunk(base) == j.prefill_chunk(base)
    for lane in ("gold", "silver", "bronze"):
        assert t.cap_max_tokens(lane, 100) == j.cap_max_tokens(lane, 100)
        assert t.sheds(lane) == j.sheds(lane)
    assert t.rung_name == j.rung_name == tover.RUNG_NAMES[rung]


def test_brownout_spans_match():
    events = []
    for mon, over in ((jmonitor, jover), (tmonitor, tover)):
        writer = mon.start_tracing()
        try:
            ctl = over.OverloadController(tick_budget_ms=100, alpha=1.0,
                                          step_up_after=1)
            ctl.observe_tick(1000)
        finally:
            mon.stop_tracing()
        events.append([(e["name"], e["ph"], e.get("args"))
                       for e in writer.events()
                       if e["name"].startswith("serving.brownout")])
    assert events[1] == events[0]
    assert events[1][1][2]["rung"] == 1 and events[1][1][2]["from"] == 0


def test_validation_matches():
    for kw in (dict(alpha=0.0), dict(low_water=1.0, high_water=1.0),
               dict(chunk_shrink=0)):
        for over in (jover, tover):
            with pytest.raises(ValueError):
                over.OverloadController(**kw)
    for over in (jover, tover):
        with pytest.raises(ValueError):
            over.OverloadController().force_rung(9)


SPECS = [
    "serving_nan@step=3",
    "serving_nan@step=0:repeat=2",
    "replica_crash@step=30:replica=0,slow_tick@step=5:secs=0.2:repeat=3",
    "conn_drop@step=2",
    "nan_grad@step=50:repeat=3,crash@step=120",
    "ckpt_io_error@p=0.5:seed=7:repeat=4",
    "stall@step=80:secs=2;preempt@step=200",
    "host_loss@step=40:host=h2,kv_partition@step=10:secs=0.5",
    "spawn_fail@restart=1:times=2",
    "replica_flap@restart=1:times=3",
    "rpc_drop@call=3:method=export_range:host=h0:repeat=99",
    "rpc_delay@call=1:secs=0.5,rpc_corrupt@call=2",
    "net_partition@step=0:secs=1:hosts=router|h2",
    "slow_tick@p=0.25:seed=3:secs=0.01",
    "",
]
BAD_SPECS = ["serving_nan", "slow_tick@step", "slow_tick@step=1:p=0.5",
             "spawn_fail@step=1", "rpc_drop@step=1", "host_loss@step=1",
             "net_partition@step=0:hosts=a", "slow_tick@step=1:hosts=a|b"]
FIELDS = ("kind", "step", "p", "restart", "call", "repeat", "secs", "seed",
          "host", "replica", "method", "hosts", "remaining")


@pytest.mark.parametrize("spec", SPECS)
def test_parse_spec_matches(spec):
    want = jfaults.parse_spec(spec)
    got = tfaults.parse_spec(spec)
    assert [[getattr(f, k) for k in FIELDS] for f in got] \
        == [[getattr(f, k) for k in FIELDS] for f in want]


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_parse_spec_refusals_match(spec):
    with pytest.raises(ValueError):
        jfaults.parse_spec(spec)
    with pytest.raises(ValueError):
        tfaults.parse_spec(spec)


def _claims(faults, calls):
    out = []
    for kind, key, idx in calls:
        if kind == "serving_nan":
            f = faults.FAULTS.take_request(kind, idx)
        else:
            f = faults.FAULTS.take_tick(kind, key, idx)
        out.append(None if f is None else (f.kind, f.remaining))
    return out


TICK_CASES = {
    "replica_filter_and_budget": (
        "replica_crash@step=10:replica=1",
        [("replica_crash", 0, 50), ("replica_crash", 1, 9),
         ("replica_crash", 1, 10), ("replica_crash", 1, 11)]),
    "slow_tick_repeat": (
        "slow_tick@step=5:secs=0.01:repeat=3",
        [("slow_tick", None, t) for t in range(3, 12)]),
    "any_replica_first_claims": (
        "replica_crash@step=2",
        [("replica_crash", 4, 1), ("replica_crash", 4, 2),
         ("replica_crash", 0, 3), ("replica_crash", None, 9)]),
    "request_ids": (
        "serving_nan@step=2:repeat=2",
        [("serving_nan", None, r) for r in (0, 1, 2, 2, 3, 4, 5)]),
    "request_and_tick_spaces_apart": (
        "serving_nan@step=1,slow_tick@step=1:secs=0.01",
        [("slow_tick", None, 0), ("serving_nan", None, 0),
         ("serving_nan", None, 1), ("slow_tick", None, 1),
         ("slow_tick", None, 2)]),
    "random_ticks_seeded": (
        "slow_tick@p=0.5:seed=3:secs=0.01",
        [("slow_tick", None, t) for t in range(12)]),
}


@pytest.mark.parametrize("case", sorted(TICK_CASES))
def test_take_tick_and_take_request_follow_the_budgets(case):
    spec, calls = TICK_CASES[case]
    jfaults.configure_faults(spec)
    tfaults.configure_faults(spec)
    assert tfaults.ENABLED[0] is True
    assert _claims(tfaults, calls) == _claims(jfaults, calls)


def _restart_and_conn_claims(faults, calls):
    out = []
    for kind, idx in calls:
        if kind == "conn":
            f = faults.FAULTS.take_conn(idx)
        else:
            f = faults.FAULTS.take_restart(kind, idx)
        out.append(None if f is None else (f.kind, f.remaining))
    return out


RESTART_CONN_CASES = {
    "spawn_fail_times": (
        "spawn_fail@restart=2:times=2",
        [("spawn_fail", i) for i in (1, 2, 3, 4, 5)]),
    "flap_and_spawn_apart": (
        "spawn_fail@restart=1,replica_flap@restart=2:times=3",
        [("replica_flap", 1), ("spawn_fail", 1), ("replica_flap", 2),
         ("spawn_fail", 2), ("replica_flap", 7), ("replica_flap", 8),
         ("replica_flap", 9)]),
    "restart_budget_invisible_elsewhere": (
        "spawn_fail@restart=1:times=2,conn_drop@step=2",
        [("conn", 1), ("spawn_fail", 0), ("conn", 2), ("conn", 3),
         ("spawn_fail", 1), ("replica_flap", 5), ("spawn_fail", 9),
         ("spawn_fail", 10)]),
    "conn_drop_repeat": (
        "conn_drop@step=3:repeat=2", [("conn", i) for i in range(1, 8)]),
    "conn_drop_seeded": (
        "conn_drop@p=0.4:seed=5", [("conn", i) for i in range(1, 16)]),
}


@pytest.mark.parametrize("case", sorted(RESTART_CONN_CASES))
def test_take_restart_and_take_conn_match(case):
    spec, calls = RESTART_CONN_CASES[case]
    jfaults.configure_faults(spec)
    tfaults.configure_faults(spec)
    assert _restart_and_conn_claims(tfaults, calls) \
        == _restart_and_conn_claims(jfaults, calls)
    # the tick and request spaces never claim these kinds
    assert tfaults.FAULTS.take_tick("replica_crash", 0, 99) is None
    assert tfaults.FAULTS.take_request("serving_nan", 99) is None


def test_flag_reconfigures_the_registry():
    from paddle_tpu_torch import get_flags, set_flags

    set_flags({"FLAGS_fault_inject": "serving_nan@step=4"})
    assert tfaults.ENABLED[0]
    assert get_flags("FLAGS_fault_inject")["FLAGS_fault_inject"] \
        == "serving_nan@step=4"
    assert [f.kind for f in tfaults.FAULTS.faults] == ["serving_nan"]
    tfaults.configure_faults("")
    assert not tfaults.ENABLED[0] and not tfaults.FAULTS.faults
