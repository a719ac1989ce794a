"""paddle_tpu_torch's KV streaming, failover and health surface against
paddle_tpu's.

- ``export_kv_prefix``: the port's payload equals the JAX engine's for
  the same params and prompt (keys, block layout (n_blocks, layers,
  heads, block_size, head_dim), dtype string; K/V within 1e-5, the same
  f32 arithmetic in another summation order); the JAX payload (numpy)
  imports into a port engine, and a port payload into a second port
  engine gives a prefix hit and the source's tokens, greedy and sampled,
  and greedy streams after an import equal the JAX engine's;
- ``export_kv_range`` / ``import_kv_chunk``: chunked streaming is
  token-identical, a mid-prefill export ships only full blocks, a gap
  rewinds, re-delivery is idempotent, bad shapes raise (mirrors
  ``tests/test_fleet_faults.py`` and ``tests/test_serving_fleet.py``);
- ``evacuate`` on one engine whose ``failover`` hook adopts into another:
  every stream ends there, token-identical to an undisturbed run, greedy
  and sampled, fixed and paged, as the same evacuation between two JAX
  engines is; greedy adopted streams equal the JAX engines' token for
  token (sampled ones draw from each package's own RNG streams);
- ``fail_at_tick`` and ``replica_crash``: ``InjectedCrash``, a flight
  dump, a closed engine whose ``submit`` names the cause;
- ``run_on_scheduler`` from another thread; ``alive``, ``busy``,
  ``tick_age`` and ``pool_headroom`` against the JAX engine's, and the
  constructor's fleet arguments (``tps_window_ticks``, ``replica_id``,
  ``flight_dir``, ``overload``) where the JAX engine keeps them.

gpt_nano, f32, block matrices x4 so greedy streams vary.
"""
import functools
import glob
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import gpt as jg
from paddle_tpu.resilience import faults as jfaults
from paddle_tpu.serving import InferenceEngine as JaxEngine
from paddle_tpu_torch import monitor
from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.monitor import flight
from paddle_tpu_torch.resilience import faults as tfaults
from paddle_tpu_torch.serving import InferenceEngine
from torch_jax_util import scaled_params
from torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)

CFG_J = jg.gpt_nano(dtype=jnp.float32, seq_len=128)
CFG = tg.gpt_nano(dtype=torch.float32, seq_len=128)
KW = dict(n_slots=2, paged=True, block_size=8, prefill_chunk=16,
          prefix_cache=True)
TOL = 1e-5
SAMPLED = dict(temperature=0.8, top_k=7)


@functools.lru_cache(maxsize=None)
def _params():
    return scaled_params(CFG_J, seed=5)


def _prompt(n, seed=0):
    return np.random.default_rng(100 + seed).integers(
        0, CFG.vocab_size, n).astype(np.int32)


@pytest.fixture
def engine():
    engines = []

    def make(**kw):
        _, params = _params()
        eng = InferenceEngine(CFG, params, device="cpu", **{**KW, **kw})
        engines.append(eng)
        return eng

    yield make
    for eng in engines:
        eng.shutdown(drain=False, timeout=30)
    tfaults.configure_faults("")


@functools.lru_cache(maxsize=None)
def _jax_export(n):
    tree, _ = _params()
    eng = JaxEngine(CFG_J, jax.tree.map(jnp.asarray, tree), **KW)
    try:
        eng.warm_prefix(_prompt(n)).result(timeout=120)
        return eng.export_kv_prefix(_prompt(n)), eng.pool_headroom()
    finally:
        eng.shutdown()


@functools.lru_cache(maxsize=None)
def _jax_greedy(n, new):
    """The JAX engine's greedy stream for ``_prompt(n)``."""
    tree, _ = _params()
    eng = JaxEngine(CFG_J, jax.tree.map(jnp.asarray, tree), **KW)
    try:
        return eng.generate(_prompt(n), max_new_tokens=new)
    finally:
        eng.shutdown()


def test_export_payload_matches_jax(engine):
    p = _prompt(41)
    src = engine()
    src.warm_prefix(p).result(timeout=120)
    got = src.export_kv_prefix(p)
    want, _ = _jax_export(41)
    assert sorted(got) == sorted(want)
    for k in ("matched_len", "block_size", "dtype", "shape"):
        assert got[k] == want[k], k
    assert got["matched_len"] == 40 and got["dtype"] == "float32"
    assert got["shape"] == [5, CFG.n_layers, CFG.n_heads, 8, CFG.head_dim]
    for k in ("kb", "vb"):
        assert isinstance(got[k], torch.Tensor)
        assert got[k].device.type == "cpu"
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=TOL,
                                   atol=TOL)
    assert src.export_kv_prefix(_prompt(30, seed=9)) is None


def test_jax_payload_imports_into_the_port(engine):
    p = _prompt(41)
    want, _ = _jax_export(41)
    mono, dst = engine(), engine()
    expected = mono.generate(p, max_new_tokens=12)
    assert dst.import_kv_prefix(p, want["kb"], want["vb"],
                                want["matched_len"]) >= 40
    assert dst.generate(p, max_new_tokens=12) == expected \
        == _jax_greedy(41, 12)


@pytest.mark.parametrize("sampled", [False, True])
def test_import_gives_a_hit_and_the_same_tokens(engine, sampled):
    kw = SAMPLED if sampled else {}
    p = _prompt(33)
    src, dst, mono = engine(), engine(), engine()
    expected = mono.generate(p, max_new_tokens=16, **kw)
    src.warm_prefix(p).result(timeout=120)
    exp = src.export_kv_prefix(p)
    assert exp["matched_len"] == 32                 # the len-1 cap
    m0 = monitor.stat_get("prefix_matched_tokens")
    assert dst.import_kv_prefix(p, exp["kb"], exp["vb"],
                                exp["matched_len"]) >= 32
    assert dst.generate(p, max_new_tokens=16, **kw) == expected
    assert monitor.stat_get("prefix_matched_tokens") - m0 == 32
    if not sampled:
        assert expected == _jax_greedy(33, 16)


def test_import_is_idempotent_and_validates(engine):
    p = _prompt(33)
    src, dst = engine(), engine()
    src.warm_prefix(p).result(timeout=120)
    exp = src.export_kv_prefix(p)
    c1 = dst.import_kv_prefix(p, exp["kb"], exp["vb"], exp["matched_len"])
    free = dst.cache.free_blocks_count
    c2 = dst.import_kv_prefix(p, exp["kb"], exp["vb"], exp["matched_len"])
    assert c2 >= c1 >= 32 and dst.cache.free_blocks_count == free
    with pytest.raises(ValueError):
        dst.import_kv_prefix(p, exp["kb"][:-1], exp["vb"][:-1],
                             exp["matched_len"])
    with pytest.raises(ValueError):
        dst.import_kv_prefix(p, exp["kb"][:, :1], exp["vb"][:, :1],
                             exp["matched_len"])
    with pytest.raises(RuntimeError, match="prefix_cache"):
        engine(prefix_cache=False).export_kv_prefix(p)


def _stream(src, dst, p, chunk_blocks=2, stop_after_tokens=None):
    """export_kv_range -> import_kv_chunk until done (or until
    ``stop_after_tokens`` are acked). Returns (acked tokens, chunks)."""
    ack, chunks = 0, 0
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        exp = src.export_kv_range(p, start_block=ack // 8,
                                  max_blocks=chunk_blocks)
        if exp["n_blocks"] > 0:
            got = dst.import_kv_chunk(p, exp["kb"], exp["vb"],
                                      exp["start_block"],
                                      exp["covered_tokens"])
            chunks += 1
            if got <= ack:
                break
            ack = got
            if stop_after_tokens is not None and ack >= stop_after_tokens:
                break
        if exp["done"] and ack >= exp["matched_len"]:
            break
        time.sleep(0.005)
    return ack, chunks


@pytest.mark.parametrize("partial", [False, True])
def test_chunk_streaming_is_token_identical(engine, partial):
    p = _prompt(41)
    src, dst, mono = engine(), engine(), engine()
    expected = mono.generate(p, max_new_tokens=12)
    src.warm_prefix(p).result(timeout=120)
    ack, chunks = _stream(src, dst, p,
                          stop_after_tokens=16 if partial else None)
    if partial:
        assert 16 <= ack < 40           # the decode side prefills the rest
    else:
        assert ack == 40 and chunks == 3
    assert dst.generate(p, max_new_tokens=12) == expected \
        == _jax_greedy(41, 12)


def test_export_visible_mid_prefill(engine):
    """Finished FULL blocks are exportable while the prompt still
    prefills (the live-slot scan); ``slow_tick`` stretches each tick so
    the window is not a race with the CPU's speed."""
    p = _prompt(96)                      # 6 chunks of 16
    src, dst, mono = engine(), engine(), engine()
    expected = mono.generate(p, max_new_tokens=10)
    tfaults.configure_faults("slow_tick@step=1:secs=0.05:repeat=500")
    req = src.warm_prefix(p)
    partial = None
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        exp = src.export_kv_range(p, start_block=0)
        if exp["done"]:
            break
        if exp["n_blocks"] > 0:
            partial = exp
            break
        time.sleep(0.003)
    assert partial is not None, "no mid-prefill export observed"
    assert not partial["done"] and partial["covered_tokens"] % 8 == 0
    assert 0 < partial["covered_tokens"] < 95
    assert dst.import_kv_chunk(p, partial["kb"], partial["vb"],
                               partial["start_block"],
                               partial["covered_tokens"]) \
        == partial["covered_tokens"]
    tfaults.configure_faults("")
    req.result(timeout=120)
    ack, _ = _stream(src, dst, p, chunk_blocks=None)
    assert ack == 95
    assert dst.generate(p, max_new_tokens=10) == expected


def test_gap_rewinds_and_redelivery_is_idempotent(engine):
    p = _prompt(41)
    src, dst = engine(), engine()
    src.warm_prefix(p).result(timeout=120)
    exp = src.export_kv_range(p, start_block=2)       # skip ahead
    assert exp["n_blocks"] > 0
    assert dst.import_kv_chunk(p, exp["kb"], exp["vb"], exp["start_block"],
                               exp["covered_tokens"]) == 0
    first = src.export_kv_range(p, start_block=0, max_blocks=2)
    a1 = dst.import_kv_chunk(p, first["kb"], first["vb"], 0,
                             first["covered_tokens"])
    a2 = dst.import_kv_chunk(p, first["kb"], first["vb"], 0,
                             first["covered_tokens"])
    assert a1 == a2 == 16
    assert _stream(src, dst, p)[0] == 40


def test_chunk_geometry_validated(engine):
    p = _prompt(33)
    src, dst = engine(), engine()
    src.warm_prefix(p).result(timeout=120)
    exp = src.export_kv_range(p, start_block=0)
    with pytest.raises(ValueError):
        dst.import_kv_chunk(p, exp["kb"][:-1], exp["vb"][:-1], 0,
                            exp["covered_tokens"])
    with pytest.raises(ValueError):
        dst.import_kv_chunk(p, exp["kb"], exp["vb"], 0, 0)
    with pytest.raises(ValueError):
        dst.import_kv_chunk(p, exp["kb"], exp["vb"][:, :, :1], 0,
                            exp["covered_tokens"])


def _evacuated_run(make, prompts, kw, faults=tfaults):
    """A (replica 0, each tick stretched by slow_tick) serves the prompts
    and is evacuated once every stream has 3 tokens; its failover hook
    adopts each stream into B. ``make`` and ``faults`` are the port's or
    the JAX package's; returns (streams, finish reasons, adopted rids)."""
    a, b = make(replica_id=0), make(replica_id=1)
    adopted = []

    def hook(req, err):
        assert type(err).__name__ == "ReplicaEvacuated"
        b.adopt_request(req)
        adopted.append(req.rid)
        return True

    a.failover = hook
    faults.configure_faults(
        "slow_tick@step=1:secs=0.02:repeat=100000:replica=0")
    try:
        reqs = [a.submit(p, max_new_tokens=14, **kw) for p in prompts]
        deadline = time.monotonic() + 120
        while not all(len(r.tokens) >= 3 for r in reqs):
            assert time.monotonic() < deadline
            time.sleep(0.002)
        a.evacuate()
        outs = [r.result(timeout=120) for r in reqs]
    finally:
        faults.configure_faults("")
    assert sorted(adopted) == [r.rid for r in reqs]
    assert not a.alive and b.alive
    return outs, [r.finish_reason for r in reqs], sorted(adopted)


def _evac_prompts():
    return [_prompt(n, seed=n) for n in (11, 26)]


def _evac_kw(paged):
    return dict(paged=paged, prefix_cache=paged, max_len=128)


@functools.lru_cache(maxsize=None)
def _jax_evacuated(paged, sampled):
    """The JAX engines' undisturbed and evacuated runs of the port test's
    prompts and kwargs, made once per (paged, sampled)."""
    tree, _ = _params()
    jparams = jax.tree.map(jnp.asarray, tree)
    engines = []

    def make(**kw):
        eng = JaxEngine(CFG_J, jparams, **{**KW, **_evac_kw(paged), **kw})
        engines.append(eng)
        return eng

    kw = SAMPLED if sampled else {}
    try:
        ref = make()
        undisturbed = [r.result(timeout=120) for r in
                       [ref.submit(p, max_new_tokens=14, **kw)
                        for p in _evac_prompts()]]
        return undisturbed, _evacuated_run(make, _evac_prompts(), kw,
                                           jfaults)
    finally:
        for eng in engines:
            eng.shutdown(drain=False, timeout=30)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("sampled", [False, True])
def test_evacuate_and_adopt_are_token_identical(engine, paged, sampled):
    kw = SAMPLED if sampled else {}
    prompts = _evac_prompts()
    make = functools.partial(engine, **_evac_kw(paged))
    expected = [r.result(timeout=120) for r in
                [m.submit(p, max_new_tokens=14, **kw)
                 for m in [make()] for p in prompts]]
    got, reasons, adopted = _evacuated_run(make, prompts, kw)
    j_undisturbed, (j_got, j_reasons, j_adopted) = _jax_evacuated(
        paged, sampled)
    assert got == expected and j_got == j_undisturbed
    assert reasons == j_reasons == ["length"] * len(prompts)
    assert adopted == j_adopted
    if not sampled:
        assert got == j_got


def test_adopted_trace_records_the_hop(engine):
    a, b = engine(replica_id=0), engine(replica_id=1)
    a.failover = lambda req, err: (b.adopt_request(req), True)[1]
    writer = monitor.start_tracing()
    try:
        tfaults.configure_faults(
            "slow_tick@step=1:secs=0.02:repeat=100000:replica=0")
        req = a.submit(_prompt(9), max_new_tokens=10,
                       trace=monitor.mint_trace())
        while len(req.tokens) < 2:
            time.sleep(0.002)
        a.evacuate()
        req.result(timeout=120)
    finally:
        monitor.stop_tracing()
    hops = [e for e in writer.events()
            if e["name"] == "serving.failover_hop"]
    writer.clear()
    assert len(hops) == 1 and hops[0]["args"]["hop_to"] == 1
    assert req.trace.hops == [(None, 1)]


@pytest.mark.parametrize("how", ["fail_at_tick", "replica_crash"])
def test_crash_dumps_and_closes_the_engine(engine, tmp_path, how):
    flight.disarm_flight_recorder()
    eng = engine(flight_dir=str(tmp_path), replica_id=3)
    try:
        if how == "fail_at_tick":
            eng.fail_at_tick(2)
        else:
            tfaults.configure_faults("replica_crash@step=2:replica=3")
        req = eng.submit(_prompt(20), max_new_tokens=30)
        with pytest.raises(RuntimeError) as ei:
            req.result(timeout=120)
        assert isinstance(ei.value.__cause__, tfaults.InjectedCrash)
        assert req.finish_reason == "error"
        eng._thread.join(30)
        assert not eng.alive
        with pytest.raises(RuntimeError, match="InjectedCrash"):
            eng.submit(_prompt(5), max_new_tokens=2)
        with pytest.raises(RuntimeError, match="InjectedCrash"):
            eng.run_on_scheduler(lambda e: 1)
        dumps = glob.glob(str(tmp_path / "flight_*engine_abort_"
                              "InjectedCrash.json"))
        assert len(dumps) == 1
    finally:
        flight.disarm_flight_recorder()


@pytest.mark.parametrize("paged", [False, True])
def test_health_surface_matches_jax(engine, paged):
    tree, _ = _params()
    kw = dict(paged=paged, prefix_cache=paged, max_len=128)
    jeng = JaxEngine(CFG_J, jax.tree.map(jnp.asarray, tree),
                     **{**KW, **kw})
    eng = engine(**kw)
    try:
        p = _prompt(41)
        for e in (jeng, eng):
            assert e.alive and not e.busy
            assert 0 <= e.tick_age() < 5
            assert e.pool_headroom() == 1.0
            e.warm_prefix(p).result(timeout=120)
            e.generate(_prompt(9, seed=4), max_new_tokens=3)
            time.sleep(1.2)                  # the idle loop beats every
            assert e.tick_age() < 1.0        # 50 ms: the age stays fresh
            assert not e.busy
        assert eng.pool_headroom() == jeng.pool_headroom()
        if paged:
            assert eng.pool_headroom() < 1.0
    finally:
        jeng.shutdown()
    eng.shutdown()
    assert not eng.alive and not jeng.alive


def test_run_on_scheduler(engine):
    eng = engine()
    seen = {}

    def fn(e):
        seen["thread"] = threading.current_thread()
        # from the scheduler thread itself the call runs inline
        return e.run_on_scheduler(lambda e2: e2.cache.free_blocks_count)

    out = []
    t = threading.Thread(target=lambda: out.append(eng.run_on_scheduler(
        fn, timeout=30)))
    t.start()
    t.join(60)
    assert not t.is_alive()
    assert out == [eng.cache.free_blocks_count]
    assert seen["thread"] is eng._thread
    with pytest.raises(ZeroDivisionError):
        eng.run_on_scheduler(lambda e: 1 / 0, timeout=30)
    assert eng.alive                       # a host-call error is the caller's
    eng.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        eng.run_on_scheduler(lambda e: 1)


def test_constructor_surface_matches_jax(engine, tmp_path):
    """The fleet-facing constructor arguments land where the JAX engine
    keeps them: the tokens/s window, the replica id, the flight
    directory (arming the process's recorder), the overload controller,
    and no failover hook until a router installs one."""
    from paddle_tpu.monitor import flight as jflight
    from paddle_tpu_torch.serving import OverloadController

    tree, _ = _params()
    kw = dict(tps_window_ticks=5, replica_id=7, flight_dir=str(tmp_path))
    jeng = JaxEngine(CFG_J, jax.tree.map(jnp.asarray, tree),
                     overload=None, **kw)
    ctl = OverloadController()
    eng = engine(overload=ctl, **kw)
    try:
        for e in (jeng, eng):
            assert e._window.maxlen == 5 and e.replica_id == 7
            assert e.flight_dir == str(tmp_path) and e.failover is None
        assert eng.overload is ctl
        assert flight.get_flight_recorder().trace_dir == str(tmp_path)
        assert engine(tps_window_ticks=1)._window.maxlen == 2
    finally:
        jeng.shutdown()
        jflight.disarm_flight_recorder()
        flight.disarm_flight_recorder()
