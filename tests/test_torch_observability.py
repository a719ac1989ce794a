"""paddle_tpu_torch's observability against paddle_tpu's.

- ``monitor/stats.py``: the same observations give equal histogram
  snapshots, deltas, quantiles and ``stat_snapshot`` values, and
  ``prometheus_text`` over the same registry contents equals the
  reference's byte for byte; the router's, supervisor's and front end's
  stats carry the reference's names;
- ``monitor/trace.py`` / ``tracectx.py``: spans, flows, instants and
  ``TraceContext`` args give the same event names, phases and args;
- ``monitor/flight.py``: a dump has the reference's keys, and
  ``tools/trace_report.py``'s ``flight_report`` reads both to the same
  rows;
- trace parity of the engines: a traced port engine and a traced JAX
  engine on the same prompts give per-request events of the same names
  and arg keys, and ``request_report`` / ``serving_report`` read both to
  the same counts (gpt_nano, f32, fixed and paged).

Only host-side bookkeeping is compared: timestamps, durations, pids and
thread ids differ by nature.
"""
import functools
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import monitor as jmon
from paddle_tpu.models import gpt as jg
from paddle_tpu.monitor import flight as jflight
from paddle_tpu.monitor import stats as jstats
from paddle_tpu.monitor import trace as jtrace
from paddle_tpu.serving import InferenceEngine as JaxEngine
from paddle_tpu_torch import monitor as tmon
from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.monitor import flight as tflight
from paddle_tpu_torch.monitor import stats as tstats
from paddle_tpu_torch.monitor import trace as ttrace
from paddle_tpu_torch.serving import InferenceEngine

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@functools.lru_cache(maxsize=None)
def trace_report():
    spec = importlib.util.spec_from_file_location(
        "trace_report", os.path.join(_ROOT, "tools", "trace_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


OBS = {
    "spread": [0.01, 0.125, 0.2, 1.0, 3.3, 17.0, 250.0, 8192.0, 9000.0],
    "random": list(np.random.default_rng(5).exponential(20.0, 200)),
    "empty": [],
}


@pytest.mark.parametrize("case", sorted(OBS))
def test_histogram_snapshots_match(case):
    jh, th = jstats.Histogram("h"), tstats.Histogram("h")
    for v in OBS[case][:len(OBS[case]) // 2]:
        jh.observe(v)
        th.observe(v)
    j0, t0 = jh.snapshot(), th.snapshot()
    for v in OBS[case][len(OBS[case]) // 2:]:
        jh.observe(v)
        th.observe(v)
    assert th.snapshot() == jh.snapshot()
    assert tstats.hist_delta(t0, th.snapshot()) \
        == jstats.hist_delta(j0, jh.snapshot())
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert th.quantile(q) == jh.quantile(q)
    with pytest.raises(ValueError):
        tstats.Histogram("bad", bounds=(2.0, 1.0))
    with pytest.raises(ValueError):
        tstats.hist_delta({"bounds": [1.0]}, th.snapshot())


def test_registry_snapshots_match():
    regs = (jstats.StatRegistry(), tstats.StatRegistry())
    for reg in regs:
        reg.add("a", 3)
        reg.get_stat("b").set(7)
        reg.get_stat("c").add(-2)
        reg.reset("a")
        reg.add("a", 5)
        for v in (0.5, 4.0, 40.0):
            reg.get_histogram("lat").observe(v)
    assert regs[1].snapshot() == regs[0].snapshot()
    assert regs[1].names() == regs[0].names()
    assert regs[1].histogram_snapshot() == regs[0].histogram_snapshot()
    for reg in regs:
        reg.reset_all()
    assert regs[1].snapshot() == regs[0].snapshot() == {"a": 0, "b": 0,
                                                         "c": 0}
    assert regs[1].histogram_snapshot() == regs[0].histogram_snapshot()


def test_engine_stats_and_histograms_carry_the_reference_names():
    names = ("serving_watchdog_trips", "serving_watchdog_restarts",
             "brownout_rung", "brownout_steps", "faults_injected")
    snap, jsnap = tstats.stat_snapshot(), jstats.stat_snapshot()
    for n in names:
        assert n in snap and n in jsnap
    hists = tstats.histogram_snapshot()
    for n, _ in tstats.DEFAULT_HISTOGRAMS:
        assert n in hists and n in jstats.HISTOGRAM_HELP
        assert hists[n]["bounds"] == list(jstats.DEFAULT_BUCKETS_MS)
    assert tstats.SERVING_QUEUE_WAIT_MS is tstats.get_histogram(
        "serving_queue_wait_ms")


def _fill(reg):
    """One scripted registry: counters and gauges (negative, zero, names a
    Prometheus exposition must sanitize), the engine histograms and one
    with default help text."""
    for name, v in (("frontend_requests", 7), ("frontend_active_streams", -1),
                    ("router_failovers", 0), ("kv_blocks_used", 12),
                    ("device_memory_bytes.data", 4096),
                    ("op@grad_jit_compile", 3), ("9lives", 9)):
        reg.get_stat(name).set(v)
    obs = np.random.default_rng(15).exponential(30.0, 60)
    for name, _ in tstats.DEFAULT_HISTOGRAMS:
        h = reg.get_histogram(name)
        for v in obs[:len(name)]:
            h.observe(float(v))
    reg.get_histogram("custom_ms").observe(0.3)
    reg.get_histogram("custom_ms").observe(1e6)
    reg.get_histogram("empty_ms")


@pytest.mark.parametrize("prefix", ["paddle_tpu_", "svc:"])
def test_prometheus_text_is_the_references_byte_for_byte(monkeypatch,
                                                         prefix):
    regs = {mod: mod.StatRegistry() for mod in (jstats, tstats)}
    for mod, reg in regs.items():
        _fill(reg)
        monkeypatch.setattr(mod, "_registry", reg)
    got, want = tstats.prometheus_text(prefix), jstats.prometheus_text(prefix)
    assert got == want
    assert f"{prefix}device_memory_bytes_data 4096\n" in got
    assert f"{prefix}_9lives 9\n" in got
    assert f'{prefix}custom_ms_bucket{{le="+Inf"}} 2\n' in got
    assert f"# HELP {prefix}serving_queue_wait_ms " \
        f"{jstats.HISTOGRAM_HELP['serving_queue_wait_ms']}\n" in got
    for v in (0.125, 8192.0, 1e-7, 3.0, 2.5e10):
        assert tstats._prom_num(v) == jstats._prom_num(v)
    for n in ("a.b", "x@y", "0ab", "ok_name:sub"):
        assert tstats._prom_name(n) == jstats._prom_name(n)


def test_orchestration_stats_carry_the_reference_names():
    names = ("router_failovers", "serving_replicas_healthy",
             "serving_replica_restarts", "serving_replicas_target",
             "serving_scale_events", "prefix_warm_tokens", "frontend_429s",
             "frontend_active_streams", "frontend_load_sheds",
             "frontend_requests", "frontend_queue_wait_ms")
    snap = tstats.stat_snapshot()
    for n in names:
        assert n in snap and n in jstats.DEFAULT_STATS
        const = getattr(tstats, n.upper())
        assert const is tstats._registry.get_stat(n)
    assert tmon.prometheus_text is tstats.prometheus_text
    for n, help_txt in tstats.DEFAULT_HISTOGRAMS:
        assert help_txt == jstats.HISTOGRAM_HELP[n]


def _events(mon, trace_mod, ctx_mod):
    """One scripted run of every event kind through a package's tracing
    surface; returns its events without clocks, pids and thread ids."""
    writer = mon.start_tracing()
    try:
        ctx = ctx_mod.TraceContext(0x1234)
        with trace_mod.span("serving.prefill", cat="serving",
                            args=ctx.args(rid=3, slot=1), flow=ctx.trace_id):
            pass
        with trace_mod.span("serving.decode_step", cat="serving",
                            args={"batch": 2, "tick": 5}):
            pass
        ctx.hop(0, 1)
        trace_mod.emit_complete("serving.decode_tick", 1.5, 0.002,
                                cat="serving",
                                args=ctx.args(rid=3, tokens=1, tick=5))
        trace_mod.emit_instant("serving.watchdog_stall", 2.0, cat="serving")
        trace_mod.emit_flow("f", ctx.trace_id, 2.5)
        writer.add_counter("gauges", 3.0, {"x": 1})
        writer.add_begin("b", 3.1)
        writer.add_end("b", 3.2)
    finally:
        mon.stop_tracing()
    out = [{k: v for k, v in e.items() if k not in ("ts", "dur", "pid",
                                                     "tid")}
           for e in writer.events()]
    writer.clear()
    return out, repr(ctx).split(",")[1:], ctx.hops


def test_span_flow_and_context_events_match():
    from paddle_tpu.monitor import tracectx as jctx
    from paddle_tpu_torch.monitor import tracectx as tctx

    want = _events(jmon, jtrace, jctx)
    got = _events(tmon, ttrace, tctx)
    assert got == want
    assert [e["name"] for e in got[0]][:4] == [
        "request", "serving.prefill", "serving.decode_step",
        "serving.decode_tick"]
    # minted ids are pid-salted and distinct
    a, b = tmon.mint_trace(), tmon.mint_trace()
    assert a.trace_id != b.trace_id
    assert a.trace_id >> 40 == b.trace_id >> 40 == os.getpid() & 0xFFFF
    assert not ttrace.recording() and not ttrace.is_tracing()


def _dump(mon, flight_mod, trace_mod, d):
    flight_mod.disarm_flight_recorder()
    rec = flight_mod.arm_flight_recorder(str(d), capacity=8, gauge_every=3)
    assert flight_mod.arm_flight_recorder() is rec        # idempotent
    assert mon.get_flight_recorder() is rec and trace_mod.recording()
    try:
        for i in range(12):
            with trace_mod.span("serving.decode_step", cat="serving",
                                args={"tick": i}):
                pass
        mon.stat_add("serving_watchdog_trips", 1)
        path = flight_mod.dump_flight("serving_watchdog_restart",
                                      extra={"replica": 0, "restart": 1})
        assert flight_mod.dump_flight("x", trace_dir=str(d / "y")) \
            .startswith(str(d / "y"))
    finally:
        flight_mod.disarm_flight_recorder()
    assert flight_mod.dump_flight("unarmed") is None
    return path, len(rec)


def test_flight_dump_matches_the_reference(tmp_path):
    jpath, jn = _dump(jmon, jflight, jtrace, tmp_path / "jax")
    tpath, tn = _dump(tmon, tflight, ttrace, tmp_path / "torch")
    assert tn == jn == 8                                  # the ring's cap
    assert os.path.basename(tpath).split("_", 3)[3] \
        == os.path.basename(jpath).split("_", 3)[3]
    assert os.path.basename(tpath).startswith(
        f"flight_{tflight.host_id()}_{os.getpid()}_")
    with open(jpath) as f:
        jd = json.load(f)
    with open(tpath) as f:
        td = json.load(f)
    assert sorted(td) == sorted(jd)
    assert sorted(td["flight"]) == sorted(jd["flight"])
    assert [e["ph"] for e in td["traceEvents"]] \
        == [e["ph"] for e in jd["traceEvents"]]
    tr = trace_report()
    flights = [tr.load_trace(p).get("flight") for p in (jpath, tpath)]
    sink = open(os.devnull, "w")
    jrep = tr.flight_report([flights[0]], file=sink)
    trep = tr.flight_report([flights[1]], file=sink)
    # the rows' gauge columns read each registry's process-wide values
    # (failovers, restarts, rollbacks: stats of layers the port has not
    # ported, moved by whatever ran before in this process)
    assert sorted(trep["dumps"][0]) == sorted(jrep["dumps"][0])
    assert trep["hosts"] == jrep["hosts"]
    for k in ("host", "reason", "events"):
        assert trep["dumps"][0][k] == jrep["dumps"][0][k], k
    assert trep["dumps"][0]["reason"] == "serving_watchdog_restart"
    assert trep["dumps"][0]["watchdog_trips"] >= 1
    tflight.set_host_id("h7")
    try:
        assert tflight.host_id() == "h7"
    finally:
        tflight.set_host_id("h0")


# -- trace parity of the two engines ---------------------------------------

CFG_J = jg.gpt_nano(dtype=jnp.float32, seq_len=64)
CFG = tg.gpt_nano(dtype=torch.float32, seq_len=64)
PROMPT_LENS = (5, 21, 37)
NEW = 6
ENGINE_KW = dict(n_slots=2, max_len=64, block_size=8, prefill_chunk=16)


@functools.lru_cache(maxsize=None)
def _params():
    tree = jax.tree.map(np.asarray, jg.gpt_init(CFG_J, seed=0))
    return tree, tg.params_from_jax(tree, device="cpu")


def _prompts():
    rng = np.random.default_rng(3)
    return [rng.integers(0, CFG.vocab_size, n).astype(np.int32)
            for n in PROMPT_LENS]


def _traced_run(mon, make, mint):
    """One request at a time (so the batch never depends on the
    scheduler's timing), each with a trace context."""
    eng = make()
    writer = mon.start_tracing()
    try:
        for p in _prompts():
            eng.generate(p, max_new_tokens=NEW, trace=mint())
    finally:
        mon.stop_tracing()
        eng.shutdown()
    events = writer.events()
    writer.clear()
    return events


@functools.lru_cache(maxsize=None)
def _jax_trace(paged):
    tree, _ = _params()
    return _traced_run(jmon, lambda: JaxEngine(
        CFG_J, jax.tree.map(jnp.asarray, tree), paged=paged, **ENGINE_KW),
        jmon.mint_trace)


def _per_request(events):
    out = {}
    for e in events:
        a = e.get("args") or {}
        if "trace" in a:
            out.setdefault(a["trace"], []).append(
                (e["name"], e["ph"], tuple(sorted(a))))
    return sorted(out.values())


def _flows(events):
    return sorted(e["ph"] for e in events if e["name"] == "request")


@pytest.mark.parametrize("paged", [False, True])
def test_engine_trace_parity(paged):
    _, params = _params()
    got = _traced_run(tmon, lambda: InferenceEngine(
        CFG, params, paged=paged, device="cpu", **ENGINE_KW),
        tmon.mint_trace)
    want = _jax_trace(paged)
    assert _per_request(got) == _per_request(want)
    assert _flows(got) == _flows(want)
    done = [e for e in got if e["name"] == "serving.request_done"]
    assert len(done) == len(PROMPT_LENS)
    assert _flows(got).count("f") == len(PROMPT_LENS)
    tr = trace_report()
    sink = open(os.devnull, "w")
    reps = []
    for events in (want, got):
        req = tr.request_report(events, file=sink)
        srv = tr.serving_report(tr.aggregate(events), file=sink,
                                events=events)
        reps.append((
            req["requests"], req["completed"], req["failovers_survived"],
            sorted((r["decode_ticks"], r["prefill_chunks"], r["tokens"],
                    r["finish"]) for r in req["slowest"]),
            {k: srv[k] for k in ("prefills", "prefill_chunks",
                                 "decode_steps")},
            srv.get("max_consecutive_starved_ticks")))
    assert reps[1] == reps[0]
    assert reps[1][0] == reps[1][1] == len(PROMPT_LENS)
