"""paddle_tpu_torch's EngineRouter against paddle_tpu's.

- placement: the same serially submitted prompt sequence, over replica
  stand-ins whose loads and health follow one script, is routed to the
  same replica ids by both routers (prefix affinity, least-loaded
  fall-back, warming / draining / removed replicas), and
  ``hot_prefixes`` returns the same re-warm list;
- failover: under ``replica_crash@step=4:replica=0`` the port's greedy
  router streams equal the JAX EngineRouter's token for token (and the
  fault-free engine's), fixed and paged; sampled streams equal the
  port's undisturbed run; the survivor set, ``router_failovers``,
  ``serving_replicas_healthy`` and the ``router.replica_down`` span;
- real-engine affinity, a whole-set death without a supervisor, the
  single-replica pass-through and the validation errors.

gpt_nano, f32, block matrices x4 so greedy streams vary. No test pins a
wall-clock bound: waits are on conditions.
"""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import gpt as jg
from paddle_tpu.resilience import faults as jfaults
from paddle_tpu.serving import EngineRouter as JaxRouter
from paddle_tpu.serving import InferenceEngine as JaxEngine
from paddle_tpu_torch import monitor
from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.resilience import faults as tfaults
from paddle_tpu_torch.serving import EngineRouter, InferenceEngine
from torch_jax_util import scaled_params

CFG_J = jg.gpt_nano(dtype=jnp.float32, seq_len=128)
CFG = tg.gpt_nano(dtype=torch.float32, seq_len=128)
KW = dict(n_slots=2, block_size=8, prefill_chunk=16, seed=0)
CRASH = "replica_crash@step=4:replica=0"
NEW = 12


@functools.lru_cache(maxsize=None)
def _params():
    return scaled_params(CFG_J, seed=5)


def _prompts(n=4, length=9, seed=0):
    rng = np.random.default_rng(200 + seed)
    return [rng.integers(0, CFG.vocab_size, length).astype(np.int32)
            for _ in range(n)]


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


@functools.lru_cache(maxsize=None)
def _jax_streams(paged, crash):
    """Greedy streams of ``_prompts()`` through a 2-replica JAX router
    (``crash``: under CRASH) or one 4-slot JAX engine (fault-free)."""
    tree, _ = _params()
    jt = jax.tree.map(jnp.asarray, tree)
    kw = {**KW, "paged": paged}
    if not crash:
        eng = JaxEngine(CFG_J, jt, **{**kw, "n_slots": 4})
        try:
            return [eng.generate(p, max_new_tokens=NEW) for p in _prompts()]
        finally:
            eng.shutdown()
    jfaults.configure_faults(CRASH)
    router = JaxRouter([JaxEngine(CFG_J, jt, **kw) for _ in range(2)])
    try:
        reqs = [router.submit(p, max_new_tokens=NEW) for p in _prompts()]
        return [r.result(timeout=120) for r in reqs]
    finally:
        jfaults.configure_faults("")
        router.shutdown(drain=False, timeout=60)


# ==========================================================================
# placement, against the JAX router over the same replica stand-ins
# ==========================================================================

class _Stub:
    """The engine surface the router reads, with a scripted load."""

    def __init__(self, prefix=True):
        self.cfg = types.SimpleNamespace(vocab_size=CFG.vocab_size)
        self._prefix = object() if prefix else None
        self.block_size = 8
        self.alive = True
        self.busy = False
        self.queue_depth = 0
        self.occupancy = 0

    def tick_age(self):
        return 0.0

    def pool_headroom(self):
        return 1.0

    def submit(self, prompt=None, **kw):
        return types.SimpleNamespace(prompt=prompt)


def _placements(router_cls):
    """Drive one router over three stand-ins through a seeded script of
    prompts (shared heads, fresh prompts, sub-block prompts), loads and
    health events; returns what it decided at every step."""
    rng = np.random.default_rng(41)
    V = CFG.vocab_size
    heads = [rng.integers(0, V, n).astype(np.int32) for n in (16, 24, 40)]
    stubs = [_Stub() for _ in range(3)]
    router = router_cls(stubs)
    out = []
    for step in range(48):
        for s in stubs:
            s.queue_depth = int(rng.integers(0, 5))
            s.occupancy = int(rng.integers(0, 2))
        if step == 12:
            router.remove_replica(1)
            out.append(("hot", [h.tolist() for h in router.hot_prefixes(4)]))
            router.add_replica(stubs[1], replica_id=1, warming=True)
        if step == 18:
            router.mark_ready(1)
        if step == 26:
            router.begin_drain(2)
        if step == 34:
            stubs[0].busy = True            # alive but not ticking
            stubs[0].tick_age = lambda: 1e9
        if step == 40:
            stubs[0].busy = False
        kind = int(rng.integers(0, 4))
        if kind == 3:
            prompt = rng.integers(0, V, int(rng.integers(1, 8)))
        elif kind == 2:
            prompt = rng.integers(0, V, int(rng.integers(8, 30)))
        else:
            tail = rng.integers(0, V, int(rng.integers(0, 12)))
            prompt = np.concatenate([heads[int(rng.integers(0, 3))], tail])
        prompt = prompt.astype(np.int32)
        out.append(("place", router.place(prompt)))
        req = router.submit(prompt, max_new_tokens=1)
        out.append(("submit", req._replica))
    out.append(("healthy", router.healthy_replicas()))
    out.append(("hot", [h.tolist() for h in router.hot_prefixes(8)]))
    out.append(("health", router.health()))
    return out


def test_placement_and_hot_prefixes_match_jax():
    got, want = _placements(EngineRouter), _placements(JaxRouter)
    assert got == want
    # the script exercises affinity, least-loaded and every health state
    picks = [v for k, v in got if k == "submit"]
    assert set(picks) == {0, 1, 2}
    assert any(k == "hot" and v for k, v in got)


def test_place_without_a_prefix_cache_is_least_loaded():
    stubs = [_Stub(prefix=False) for _ in range(3)]
    jstubs = [_Stub(prefix=False) for _ in range(3)]
    router, jrouter = EngineRouter(stubs), JaxRouter(jstubs)
    for loads in ((2, 0, 1), (0, 0, 0), (3, 2, 2), (1, 1, 0)):
        for s, js, n in zip(stubs, jstubs, loads):
            s.queue_depth = js.queue_depth = n
        p = np.arange(32, dtype=np.int32)
        assert router.place(p) == jrouter.place(p) == int(np.argmin(loads))
    assert router.hot_prefixes() == jrouter.hot_prefixes() == []


# ==========================================================================
# failover with real engines
# ==========================================================================

@pytest.mark.parametrize("paged", [True, False])
def test_failover_greedy_streams_equal_jax_router(engine, paged):
    fo0 = monitor.stat_get("router_failovers")
    tfaults.configure_faults(CRASH)
    router = EngineRouter([engine(paged=paged) for _ in range(2)])
    reqs = [router.submit(p, max_new_tokens=NEW) for p in _prompts()]
    outs = [r.result(timeout=120) for r in reqs]
    assert outs == _jax_streams(paged, True) == _jax_streams(paged, False)
    assert all(r.finish_reason == "length" for r in reqs)
    assert monitor.stat_get("router_failovers") > fo0
    assert router.healthy_replicas() == [1]
    assert router.health()[0]["failed_over"]
    assert monitor.stat_get("serving_replicas_healthy") == 1
    assert all(r._replica == 1 for r in reqs)


def test_failover_sampled_streams_equal_undisturbed(engine):
    kw = dict(max_new_tokens=NEW, temperature=0.9, top_k=7)
    ref = engine(n_slots=4)
    want = [ref.generate(p, **kw) for p in _prompts()]
    tfaults.configure_faults(CRASH)
    router = EngineRouter([engine() for _ in range(2)])
    assert [router.submit(p, **kw).result(timeout=120)
            for p in _prompts()] == want


def test_replica_down_span_and_gauge(engine):
    tfaults.configure_faults("replica_crash@step=3:replica=0")
    writer = monitor.start_tracing()
    try:
        router = EngineRouter([engine() for _ in range(2)])
        reqs = [router.submit(p, max_new_tokens=10)
                for p in _prompts(3, 8, seed=1)]
        for r in reqs:
            r.result(timeout=120)
    finally:
        monitor.stop_tracing()
    downs = [e for e in writer.events()
             if e["name"] == "router.replica_down"]
    assert len(downs) == 1 and downs[0]["args"]["replica"] == 0
    assert downs[0]["args"]["error"].startswith("InjectedCrash")
    decs = [e for e in writer.events() if e["name"] == "serving.decode_step"]
    assert {e["args"].get("replica") for e in decs} <= {0, 1}
    assert monitor.stat_get("serving_replicas_healthy") == 1


def test_all_replicas_dead_fails_loudly(engine):
    tfaults.configure_faults("replica_crash@step=2:replica=0,"
                             "replica_crash@step=2:replica=1")
    router = EngineRouter([engine() for _ in range(2)])
    reqs = [router.submit(p, max_new_tokens=16)
            for p in _prompts(2, 8, seed=2)]
    failed = 0
    for r in reqs:
        try:
            r.result(timeout=120)
        except RuntimeError:
            failed += 1
    assert failed >= 1                      # never a silent hang
    assert router.healthy_replicas() == []
    with pytest.raises(RuntimeError, match="no healthy replica"):
        router.submit(_prompts(1, 4)[0], max_new_tokens=2)


# ==========================================================================
# placement and surface with real engines
# ==========================================================================

def test_prefix_affinity_routes_to_matching_replica(engine):
    router = EngineRouter([engine(prefix_cache=True, n_blocks=33)
                           for _ in range(2)])
    head = _prompts(1, 24, seed=3)[0]
    tails = [np.concatenate([head, t]) for t in _prompts(3, 8, seed=4)]
    first = router.submit(tails[0], max_new_tokens=2)
    first.result(timeout=120)
    for t in tails[1:]:
        assert router.place(t) == first._replica
        req = router.submit(t, max_new_tokens=2)
        req.result(timeout=120)
        assert req._replica == first._replica


def test_single_replica_and_text_pass_through(engine):
    from paddle_tpu_torch.serving import ByteTokenizer

    p = _prompts(1, 12, seed=5)[0]
    want = engine().generate(p, max_new_tokens=10)
    router = EngineRouter([engine()])
    assert router.generate(p, max_new_tokens=10) == want
    assert router.n_replicas == 1 and router.cfg is router.engines[0].cfg
    assert router.prefill_chunk == 16 and router.overload is None
    tok = ByteTokenizer()
    _, params = _params()
    cfg = tg.gpt_nano(dtype=torch.float32, seq_len=128,
                      vocab_size=tok.vocab_size)
    params = tg.gpt_init(cfg, seed=3, device="cpu")
    eng = InferenceEngine(cfg, params, device="cpu", tokenizer=tok, **KW)
    try:
        text_router = EngineRouter([eng])
        req = text_router.submit(text="hello", max_new_tokens=4)
        assert req.result(timeout=60) == eng.generate(
            tok.encode("hello"), max_new_tokens=4, eos_id=tok.eos_id)
        with pytest.raises(ValueError, match="prompt OR text"):
            text_router.submit(p, text="x")
    finally:
        eng.shutdown()


def test_validation(engine):
    with pytest.raises(ValueError, match="at least one"):
        EngineRouter([])
    other = tg.gpt_nano(dtype=torch.float32, seq_len=64, vocab_size=300)
    odd = InferenceEngine(other, tg.gpt_init(other, seed=3, device="cpu"),
                          device="cpu", **KW)
    try:
        with pytest.raises(ValueError, match="diverge"):
            EngineRouter([engine(), odd])
    finally:
        odd.shutdown()
    router = EngineRouter([engine()])
    with pytest.raises(ValueError, match="already live"):
        router.add_replica(engine(), replica_id=0)
    assert router.add_replica(engine()) == 1
    assert router.remove_replica(1) is not None
    assert router.remove_replica(1) is None
    with pytest.raises(ValueError, match="provide a prompt"):
        router.submit()
