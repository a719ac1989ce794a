"""paddle_tpu_torch's cross-host serving fleet against paddle_tpu's.

- ``distributed/elastic.py``: a ``FileKVStore`` record written by one
  package is read by the other, both ways, with the same torn / corrupt
  / oversize / partition outcomes;
- ``FleetRegistry``'s alive / stale / corrupt-record verdicts on a
  frozen clock, and ``FleetScheduler.plan_roles`` / ``pool_plan`` /
  ``desired_replicas``, equal the JAX ones;
- an in-process fleet (a prefill-role and a decode-role ``HostAgent``
  over real loopback RPC and a ``FileKVStore`` registry) gives the JAX
  fleet's greedy streams through the disaggregated path, and
  ``tools/trace_report.py``'s ``fleet_report`` reads both fleets' spans
  to the same keys and counts;
- sampled streams through the fleet equal the port's monolithic
  engine's; a decode host closed mid-stream reroutes token-identically;
  a prefill host lost mid-stream leaves a received prefix whose tail the
  decode replica prefills itself (``fleet_kv_resume_tails``);
- the replica supervisor's give-up calls a fleet router's
  ``collect_flight_async``.

gpt_nano, f32, block matrices x4 so greedy streams vary; weights carry
across through ``params_from_jax``. Waits are on conditions, bounded.
"""
import functools
import importlib.util
import io
import json
import os
import tempfile
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import monitor as jmon
from paddle_tpu.distributed import elastic as jel
from paddle_tpu.models import gpt as jg
from paddle_tpu.resilience import faults as jfaults
from paddle_tpu.serving import InferenceEngine as JaxEngine
from paddle_tpu.serving import pod as jpod
from paddle_tpu_torch import monitor
from paddle_tpu_torch.distributed import elastic as tel
from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.resilience import faults as tfaults
from paddle_tpu_torch.serving import (FleetRouter, InferenceEngine,
                                      ReplicaSupervisor, pod as tpod)
from paddle_tpu_torch.serving.engine import GenerationRequest
from torch_jax_util import scaled_params
from torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_J = jg.gpt_nano(dtype=jnp.float32, seq_len=128)
CFG = tg.gpt_nano(dtype=torch.float32, seq_len=128)
KW = dict(n_slots=2, paged=True, block_size=8, prefill_chunk=16, seed=0,
          prefix_cache=True, n_blocks=129)
# three prompts long enough to prefill on the prefill host (>= 2 blocks),
# one that stays direct
LENS = (40, 33, 24, 9)
NEW = 12


@functools.lru_cache(maxsize=None)
def _params():
    return scaled_params(CFG_J, seed=11)


def _prompts(lens=LENS, seed=0):
    rng = np.random.default_rng(1400 + seed)
    return [rng.integers(0, CFG.vocab_size, n).astype(np.int32)
            for n in lens]


def _wait(pred, timeout=60.0, poll=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(poll)
    return pred()


@functools.lru_cache(maxsize=None)
def _trace_report():
    spec = importlib.util.spec_from_file_location(
        "trace_report", os.path.join(_ROOT, "tools", "trace_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fleet_run(pod, store_cls, mon, factory, prompts, new, roles):
    """One traced in-process fleet: sequential greedy submits through
    ``connect_fleet``; returns (streams, fleet_prefill_routed delta,
    trace events). Everything it starts is stopped before it returns."""
    root = tempfile.mkdtemp(prefix="fleet_test_")
    store = store_cls(root)
    agents, router = [], None
    routed0 = mon.stat_get("fleet_prefill_routed")
    writer = mon.start_tracing()
    try:
        for host, role in roles:
            agents.append(pod.HostAgent(store, "j", host, factory,
                                        role=role, heartbeat_s=0.1))
        router = pod.connect_fleet(store, "j", min_hosts=len(roles),
                                   registry_ttl=2.0, poll_s=0.2,
                                   monitor_poll_s=0.1)
        router.fleet_scan()
        streams = [router.submit(p, max_new_tokens=new).result(timeout=120)
                   for p in prompts]
        routed = mon.stat_get("fleet_prefill_routed") - routed0
    finally:
        mon.stop_tracing()
        if router is not None:
            router.shutdown(drain=False)
        for a in agents:
            a.close()
    events = writer.events()
    writer.clear()
    return streams, routed, events


ROLES = (("pf", "prefill"), ("dec", "decode"))


@functools.lru_cache(maxsize=None)
def _jax_fleet():
    tree, _ = _params()
    jt = jax.tree.map(jnp.asarray, tree)

    def factory():
        return JaxEngine(CFG_J, jt, **KW)

    return _fleet_run(jpod, jel.FileKVStore, jmon, factory, _prompts(),
                      NEW, ROLES)


def _factory(**kw):
    _, params = _params()

    def make():
        return InferenceEngine(CFG, params, device="cpu", **{**KW, **kw})
    return make


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    tfaults.configure_faults("")
    jfaults.configure_faults("")


@pytest.fixture
def fleet(tmp_path):
    """In-process port HostAgents over real loopback RPC and a
    FileKVStore registry; every agent, router and engine is stopped at
    teardown (an abruptly closed agent's engines too)."""
    made = {"agents": [], "routers": [], "engines": []}
    store = tel.FileKVStore(str(tmp_path / "kv"))

    def make(roles, job="j", **connect_kw):
        agents = {}
        for host, role in roles:
            agents[host] = tpod.HostAgent(store, job, host, _factory(),
                                          role=role, heartbeat_s=0.1)
            made["agents"].append(agents[host])
        connect_kw.setdefault("min_hosts", len(roles))
        connect_kw.setdefault("registry_ttl", 0.8)
        connect_kw.setdefault("poll_s", 0.2)
        connect_kw.setdefault("monitor_poll_s", 0.1)
        router = tpod.connect_fleet(store, job, **connect_kw)
        made["routers"].append(router)
        return agents, router

    def mono():
        eng = _factory()()
        made["engines"].append(eng)
        return eng

    yield make, mono
    for router in made["routers"]:
        router.shutdown(drain=False)
    for a in made["agents"]:
        a.close()
    for e in made["engines"]:
        e.shutdown(drain=False, timeout=30)


# ==========================================================================
# the membership store and the registry
# ==========================================================================

@pytest.mark.parametrize("writer,reader", [(tel, jel), (jel, tel)],
                         ids=["port_writes", "jax_writes"])
def test_file_kv_store_records_cross_both_ways(tmp_path, writer, reader):
    w = writer.FileKVStore(str(tmp_path))
    r = reader.FileKVStore(str(tmp_path))
    payload = json.dumps({"host": "h1", "seq": 3}).encode() + bytes(range(256))
    w.put_bytes("fleet/j/hosts/h1", payload)
    w.put("fleet/j/hosts/plain", "text")
    assert r.get_bytes("fleet/j/hosts/h1") == payload
    assert r.get("fleet/j/hosts/plain") == b"text"
    assert sorted(r.get_prefix("fleet/j/hosts/")) == [
        "fleet/j/hosts/h1", "fleet/j/hosts/plain"]
    assert r.get_bytes("fleet/j/hosts/none") is None
    path = os.path.join(str(tmp_path), "fleet/j/hosts/h1")
    with open(path, "rb") as f:
        raw = f.read()
    outcomes = []
    for bad in (raw[:-3], b"XXXX" + raw[4:], raw[:-1] + bytes([raw[-1] ^ 1]),
                b"KV"):
        with open(path, "wb") as f:
            f.write(bad)
        for store in (w, r):
            with pytest.raises(ValueError) as ei:
                store.get_bytes("fleet/j/hosts/h1")
            outcomes.append(str(ei.value))
    assert outcomes[0::2] == outcomes[1::2]
    w.delete("fleet/j/hosts/h1")
    assert r.get("fleet/j/hosts/h1") is None
    for store in (w, r):
        with pytest.raises(ValueError, match="size guard"):
            store.put_bytes("k", b"x" * 9, max_bytes=8)
        with pytest.raises(ValueError, match="bad key"):
            store.put("../up", b"x")


def test_kv_partition_makes_both_stores_raise(tmp_path, monkeypatch):
    for store_mod, faults in ((tel, tfaults), (jel, jfaults)):
        store = store_mod.FileKVStore(str(tmp_path / store_mod.__name__))
        monkeypatch.setattr(store, "PUT_BACKOFF", 0.0)
        faults.configure_faults("rpc_delay@call=1")     # arms the hooks
        faults.begin_kv_partition(30.0)
        for op in (lambda: store.get("a"), lambda: store.put("a", b"x"),
                   lambda: store.get_prefix("a"), lambda: store.delete("a")):
            with pytest.raises(OSError, match="injected kv partition"):
                op()
        faults.configure_faults("")
        store.put("a", b"x")
        assert store.get("a") == b"x"


class _Clock:
    def __init__(self):
        self.t = 500.0

    def monotonic(self):
        return self.t


def test_registry_verdicts_equal_the_references(tmp_path, monkeypatch):
    def run(pod, store_mod):
        clock = _Clock()
        monkeypatch.setattr(pod, "time", types.SimpleNamespace(
            monotonic=clock.monotonic, perf_counter=time.perf_counter,
            sleep=time.sleep))
        store = store_mod.FileKVStore(str(tmp_path / pod.__name__))
        reg = pod.FleetRegistry(store, "job", ttl=2.0)
        log = []

        def look():
            log.append(sorted((h, r.get("seq")) for h, r in
                              reg.alive().items()))

        reg.announce("h1", {"host": "h1", "seq": 1})
        reg.announce("h2", {"host": "h2", "seq": 1})
        look()
        clock.t += 1.0
        reg.announce("h1", {"host": "h1", "seq": 2})
        look()
        clock.t += 1.5                  # h2 unchanged for 2.5 s > ttl
        look()
        reg.announce("h2", {"host": "h2", "seq": 2})
        look()                          # a changed payload is fresh again
        with open(os.path.join(store.root, "fleet/job/hosts/h2"),
                  "wb") as f:
            f.write(b"KVB1torn")        # a torn record: skipped, not fatal
        store.put_bytes("fleet/job/hosts/h3", b"{not json")
        look()
        reg.retire("h1")
        look()
        return log

    got, want = run(tpod, tel), run(jpod, jel)
    assert got == want
    assert got[2] == [("h1", 2)] and got[-1] == []


def test_scheduling_plans_equal_the_references():
    for hosts in ([], ["a"], ["b", "a"], ["d2", "d0", "p", "d1"]):
        assert tpod.FleetScheduler.plan_roles(hosts) \
            == jpod.FleetScheduler.plan_roles(hosts)
    for role in ("prefill", "decode", "mixed"):
        for kw in ({}, {"n_slots": 8, "n_blocks": 65, "block_size": 32,
                        "prefill_chunk": 32}, {"n_slots": 1}):
            assert tpod.FleetScheduler.pool_plan(role, **kw) \
                == jpod.FleetScheduler.pool_plan(role, **kw)
    for rate, cap in ((6.0, 8), (2.5, 3)):
        scheds = []
        for pod in (tpod, jpod):
            s = object.__new__(pod.FleetScheduler)   # no router, no thread
            s.rps_per_replica, s.max_replicas = rate, cap
            scheds.append(s)
        for rps in (0.0, 0.1, 6.0, 6.01, 17.9, 100.0):
            assert scheds[0].desired_replicas(rps) \
                == scheds[1].desired_replicas(rps)
    fc = tpod.ArrivalRateForecaster(window_s=5.0)
    gaps = monitor.get_histogram("fleet_arrival_gap_ms").snapshot()["count"]
    for _ in range(3):
        fc.note_arrival()
    assert fc.rps() > 0.0
    assert monitor.get_histogram("fleet_arrival_gap_ms").snapshot()[
        "count"] - gaps == 2


# ==========================================================================
# the fleet end to end
# ==========================================================================

def test_greedy_fleet_streams_and_report_equal_the_jax_fleets():
    jstreams, jrouted, jevents = _jax_fleet()
    streams, routed, events = _fleet_run(
        tpod, tel.FileKVStore, monitor, _factory(), _prompts(), NEW, ROLES)
    assert streams == jstreams
    assert routed == jrouted == sum(n >= 16 for n in LENS)
    tr = _trace_report()
    sink = io.StringIO()
    want, got = tr.fleet_report(jevents, file=sink), \
        tr.fleet_report(events, file=sink)
    assert sorted(got) == sorted(want)
    for k in ("kv_transfers", "kv_bytes", "kv_tokens_streamed"):
        assert got[k] == want[k], k
    strip = [{k: r[k] for k in ("host", "role", "replicas", "lost")}
             for r in got["hosts"]]
    assert strip == [{k: r[k] for k in ("host", "role", "replicas", "lost")}
                     for r in want["hosts"]]
    assert {r["host"]: r["role"] for r in got["hosts"]
            if r["host"] in ("pf", "dec")} == {"pf": "prefill",
                                               "dec": "decode"}


def test_sampled_streams_equal_the_monolithic_engines(fleet):
    make, mono = fleet
    agents, router = make(ROLES)
    assert router.n_replicas == 1          # the prefill pool takes none
    eng = mono()
    prompts = _prompts((40, 33), seed=1)
    kw = dict(max_new_tokens=NEW, temperature=0.7, top_k=5)
    routed0 = monitor.stat_get("fleet_prefill_routed")
    # sequential submits: the decode engine's rid order is the oracle's
    for p in prompts:
        got = router.submit(p, **kw).result(timeout=120)
        assert got == eng.generate(p, **kw)
    assert monitor.stat_get("fleet_prefill_routed") - routed0 == 2
    assert router.last_stream_stats["acked_tokens"] == 32
    members = router.fleet_members()
    assert members["prefill/0"]["role"] == "prefill"
    assert members["registry"]["reachable"] is True


def test_decode_host_loss_reroutes_token_identically(fleet):
    make, _ = fleet
    agents, router = make(ROLES[:1] + (("d0", "decode"), ("d1", "decode")))
    assert router.n_replicas == 2
    jstreams, _, _ = _jax_fleet()
    p = _prompts()[0]
    rr0 = monitor.stat_get("fleet_reroutes")
    tfaults.configure_faults("slow_tick@step=3:secs=0.05:repeat=12")
    req = router.submit(p, max_new_tokens=NEW)
    assert _wait(lambda: len(req.tokens) >= 3, timeout=60.0)
    victim = router.engine_for(req._replica)
    agents[victim.host].close(abrupt=True)
    assert req.result(timeout=120) == jstreams[0]
    assert req.finish_reason == "length"
    assert monitor.stat_get("fleet_reroutes") > rr0


@pytest.mark.parametrize("sampled", [False, True])
def test_prefill_loss_mid_stream_resumes_with_a_local_tail(fleet,
                                                           sampled):
    make, mono = fleet
    agents, router = make(ROLES, kv_chunk_blocks=2)
    # the whole disaggregated path once, faults off
    router.submit(_prompts((40,), seed=2)[0], max_new_tokens=2).result(
        timeout=120)
    p = _prompts((120,), seed=3)[0]
    kw = dict(temperature=0.7, top_k=5) if sampled else {}
    r0 = monitor.stat_get("fleet_kv_resume_tails")
    c0 = monitor.stat_get("fleet_kv_chunks_streamed")
    # router -> pf call indices: 1 prefill_start, 2 the first export_range
    # (ships a chunk), 3 on blackholed: the prefill host dies mid-stream
    tfaults.configure_faults("rpc_drop@call=3:method=export_range:host=pf:"
                             "repeat=1000")
    req = router.submit(p, max_new_tokens=NEW, **kw)
    toks = req.result(timeout=120)
    tfaults.configure_faults("")
    stats = router.last_stream_stats
    assert monitor.stat_get("fleet_kv_resume_tails") - r0 == 1
    assert monitor.stat_get("fleet_kv_chunks_streamed") - c0 == 1
    assert stats["resumed"] and 0 < stats["acked_tokens"] \
        < stats["target_tokens"]
    oracle = mono()
    o = GenerationRequest(p, NEW, kw.get("temperature", 0.0),
                          kw.get("top_k", 0), 1.0, None, None)
    o.rid = req.rid                        # sampled streams: (seed, rid)
    oracle.adopt_request(o)
    assert toks == o.result(timeout=120)


def test_supervisor_give_up_collects_the_fleets_flight(monkeypatch):
    """A FleetRouter with no registry is an EngineRouter; its supervisor's
    give-up pulls every host's ring through ``collect_flight_async``
    (here no host: the local dump and the sweep's count)."""
    reasons = []
    make = _factory()
    router = FleetRouter([make()])
    orig = router.collect_flight_async

    def spy(reason, min_gap_s=5.0):
        reasons.append(reason)
        return orig(reason, min_gap_s=min_gap_s)

    monkeypatch.setattr(router, "collect_flight_async", spy)
    sweeps = monitor.stat_get("flight_collects")
    tfaults.configure_faults("replica_crash@step=3:replica=0,"
                             "spawn_fail@restart=1:times=10")
    sup = ReplicaSupervisor(router, make, max_restarts=2,
                            quarantine_after=2, quarantine_s=0.05,
                            backoff_s=0.01, backoff_cap_s=0.02, poll_s=0.02)
    try:
        req = router.submit(_prompts((9,))[0], max_new_tokens=16)
        with pytest.raises(RuntimeError):
            req.result(timeout=120)
        assert _wait(lambda: sup.snapshot()["replicas"]["0"]["state"]
                     == "failed")
        assert reasons == ["give_up_r0"]
        assert _wait(lambda: monitor.stat_get("flight_collects") > sweeps,
                     timeout=10.0)
    finally:
        tfaults.configure_faults("")
        router.shutdown(drain=False, timeout=30)
