"""paddle_tpu_torch's serving watchdog and overload knobs against
paddle_tpu's.

- ``resilience.sentinel.logits_finite`` against the reference's on logits
  with NaN and inf rows;
- the fixed, paged and speculative (paged) engines with
  ``FLAGS_fault_inject=serving_nan@step=1``: the poisoned request ends
  ``"watchdog"`` with ``WatchdogTripped``, and every stream and finish
  reason equals the JAX engine's under the same fault and the unarmed
  port engine's (greedy, f32, gpt_nano with block matrices x4 so streams
  vary);
- the latency rung, with a ``slow_tick`` fault armed, trips as often in
  the port as in the JAX engine;
- with ``max_restarts`` spent every request fails with WatchdogTripped;
- an ``OverloadController`` at rung 0 leaves the tokens of
  ``overload=None``; at rung 2 the paged chunks shrink by the
  controller's ``chunk_shrink`` (re-rounded to the block size) and at
  rung 1 a speculative engine stops speculating.

The JAX engine runs are the expensive part: each is made once per
module (``lru_cache``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import gpt as jg
from paddle_tpu.resilience import faults as jfaults
from paddle_tpu.resilience import sentinel as jsentinel
from paddle_tpu.serving import InferenceEngine as JaxEngine
from paddle_tpu_torch import monitor
from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.resilience import faults as tfaults
from paddle_tpu_torch.resilience.sentinel import logits_finite
from paddle_tpu_torch.serving import (InferenceEngine, OverloadController,
                                      WatchdogTripped)
from torch_jax_util import scaled_params
from torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)

CFG_J = jg.gpt_nano(dtype=jnp.float32, seq_len=64)
CFG = tg.gpt_nano(dtype=torch.float32, seq_len=64)
PROMPT_LENS = (5, 17, 30, 12)
NEW = 10
ENGINE_KW = dict(n_slots=2, max_len=64, block_size=8, prefill_chunk=16)
SPEC_K = 2
NAN_RID = 1


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    jfaults.configure_faults("")
    tfaults.configure_faults("")


@functools.lru_cache(maxsize=None)
def _params():
    return scaled_params(CFG_J)


def _prompts():
    rng = np.random.default_rng(17)
    return [rng.integers(0, CFG.vocab_size, n).astype(np.int32)
            for n in PROMPT_LENS]


def _collect(eng, prompts=None, **kw):
    reqs = [eng.submit(p, max_new_tokens=NEW, **kw)
            for p in (prompts if prompts is not None else _prompts())]
    outs = []
    try:
        for r in reqs:
            try:
                outs.append((tuple(r.result(timeout=120)), r.finish_reason))
            except RuntimeError as e:
                outs.append(("FAILED", r.finish_reason,
                             type(e.__cause__).__name__))
    finally:
        eng.shutdown()
    return outs


@functools.lru_cache(maxsize=None)
def _jax_run(mode, nan):
    tree, _ = _params()
    jparams = jax.tree.map(jnp.asarray, tree)
    jfaults.configure_faults(f"serving_nan@step={NAN_RID}" if nan else "")
    try:
        kw = {}
        if mode == "spec":
            kw = dict(draft=jg.gpt_truncate(CFG_J, jparams, 1),
                      spec_k=SPEC_K)
        eng = JaxEngine(CFG_J, jparams, paged=mode != "fixed",
                        watchdog=True if nan else None,
                        **{**ENGINE_KW, **kw})
        return _collect(eng)
    finally:
        jfaults.configure_faults("")


def _port_engine(mode, **kw):
    _, params = _params()
    if mode == "spec":
        kw.update(draft=tg.gpt_truncate(CFG, params, 1), spec_k=SPEC_K)
    return InferenceEngine(CFG, params, paged=mode != "fixed", device="cpu",
                           **{**ENGINE_KW, **kw})


@functools.lru_cache(maxsize=None)
def _port_run(mode, nan):
    tfaults.configure_faults(f"serving_nan@step={NAN_RID}" if nan else "")
    try:
        return _collect(_port_engine(mode, watchdog=True if nan else None))
    finally:
        tfaults.configure_faults("")


def test_logits_finite_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((6, 3, 40)).astype(np.float32)
    x[1, 0, 7] = np.nan
    x[3, 2, 0] = np.inf
    x[4, 1, 39] = -np.inf
    for a in (x[:, 0], x.reshape(6, -1)):
        want = np.asarray(jsentinel.logits_finite(jnp.asarray(a)))
        got = logits_finite(torch.from_numpy(a)).numpy()
        assert got.dtype == np.bool_
        np.testing.assert_array_equal(got, want)
    got = logits_finite(torch.from_numpy(x))       # (B, K+1, V): per row
    np.testing.assert_array_equal(got.numpy(), [1, 0, 1, 0, 0, 1])
    bf = logits_finite(torch.from_numpy(x).bfloat16())
    np.testing.assert_array_equal(bf.numpy(), got.numpy())


@pytest.mark.parametrize("mode", ["fixed", "paged", "spec"])
def test_serving_nan_matches_jax_and_the_unarmed_engine(mode):
    trips0 = monitor.stat_get("serving_watchdog_trips")
    rest0 = monitor.stat_get("serving_watchdog_restarts")
    inj0 = monitor.stat_get("faults_injected")
    got = _port_run(mode, True)
    assert got[NAN_RID] == ("FAILED", "watchdog", "WatchdogTripped")
    assert monitor.stat_get("serving_watchdog_trips") - trips0 == 1
    assert monitor.stat_get("serving_watchdog_restarts") - rest0 == 1
    assert monitor.stat_get("faults_injected") - inj0 == 1
    base = _port_run(mode, False)
    for i, (toks, reason) in enumerate(base):
        assert len(toks) == NEW and reason == "length"
        if i != NAN_RID:
            assert got[i] == base[i], i
    assert len({t for toks, _ in base for t in toks}) > NEW   # not stuck
    assert got == _jax_run(mode, True)


def test_watchdog_off_is_inert():
    """Unarmed, a poisoned slot streams whatever its NaN logits give; no
    request fails and no watchdog stat moves."""
    trips0 = monitor.stat_get("serving_watchdog_trips")
    tfaults.configure_faults(f"serving_nan@step={NAN_RID}")
    outs = _collect(_port_engine("paged"))
    assert all(o[0] != "FAILED" for o in outs)
    assert monitor.stat_get("serving_watchdog_trips") == trips0


def test_latency_rung_with_slow_ticks_matches_jax():
    """Every CPU tick blows a 0.1 µs budget: one stall verdict every
    ``latency_trips`` ticks, while ``slow_tick`` stalls the scheduler
    between ticks (its sleep lies outside the tick's span, in both
    packages). Requests run one at a time, so both engines run the same
    ticks."""
    from paddle_tpu import monitor as jmonitor

    spec = "slow_tick@step=1:secs=0.01:repeat=3"
    wd = {"latency_budget_ms": 0.0001, "latency_trips": 2}
    tree, params = _params()
    counts = []
    for faults, mon, make in (
            (jfaults, jmonitor, lambda: JaxEngine(
                CFG_J, jax.tree.map(jnp.asarray, tree), watchdog=wd,
                **ENGINE_KW)),
            (tfaults, monitor, lambda: InferenceEngine(
                CFG, params, device="cpu", watchdog=wd, **ENGINE_KW))):
        faults.configure_faults(spec)
        t0, f0 = (mon.stat_get("serving_watchdog_trips"),
                  mon.stat_get("faults_injected"))
        eng = make()
        waits = mon.get_histogram("serving_queue_wait_ms")
        for p in _prompts()[:2]:
            eng.generate(p, max_new_tokens=NEW)
        eng.shutdown()
        counts.append((mon.stat_get("serving_watchdog_trips") - t0,
                       mon.stat_get("faults_injected") - f0))
        assert waits.snapshot()["count"] > 0
    assert counts[1] == counts[0]
    assert counts[1][0] == NEW - 1 and counts[1][1] == 3


def test_restart_budget_exhaustion_fails_open_requests():
    tfaults.configure_faults("serving_nan@step=0:repeat=2")
    eng = _port_engine("fixed", watchdog={"max_restarts": 1})
    r0 = eng.submit([1, 2, 3], max_new_tokens=6)
    with pytest.raises(RuntimeError) as ei:
        r0.result(timeout=120)             # restart 1: r0 fails alone
    assert r0.finish_reason == "watchdog"
    assert isinstance(ei.value.__cause__, WatchdogTripped)
    r1 = eng.submit([4, 5, 6], max_new_tokens=6)
    r2 = eng.submit([7, 8, 9, 10], max_new_tokens=6)
    for r in (r1, r2):
        with pytest.raises(RuntimeError) as ei:
            r.result(timeout=120)          # restart 2 > budget: abort
        assert isinstance(ei.value.__cause__, WatchdogTripped)
        assert r.finish_reason in ("error", "watchdog")
    assert not eng.alive
    with pytest.raises(RuntimeError, match="crashed"):
        eng.submit([7, 8], max_new_tokens=2)
    eng.shutdown()


def test_watchdog_option_validation():
    _, params = _params()
    with pytest.raises(ValueError, match="unknown watchdog"):
        InferenceEngine(CFG, params, device="cpu", watchdog={"bogus": 1})
    eng = InferenceEngine(CFG, params, device="cpu",
                          watchdog={"max_restarts": 5})
    try:
        assert eng._watchdog == {"latency_budget_ms": None,
                                 "latency_trips": 3, "max_restarts": 5}
    finally:
        eng.shutdown()


def _holding_controller():
    """A controller whose pressure stays inside its hysteresis band (huge
    budgets, a tiny low-water mark): it holds whatever rung it is put
    on."""
    return OverloadController(queue_wait_budget_ms=1e9, tick_budget_ms=1e9,
                              low_water=1e-15)


@pytest.mark.parametrize("mode", ["fixed", "paged", "spec"])
def test_overload_rung0_is_token_identical(mode):
    ctl = _holding_controller()
    got = _collect(_port_engine(mode, overload=ctl))
    assert got == _port_run(mode, False)
    assert ctl.rung == 0


def _chunks(eng, prompt):
    writer = monitor.start_tracing()
    try:
        toks = eng.generate(prompt, max_new_tokens=4)
    finally:
        monitor.stop_tracing()
        eng.shutdown()
    chunks = [e["args"]["chunk"] for e in writer.events()
              if e["name"] == "serving.prefill_chunk"]
    writer.clear()
    return toks, chunks


def test_overload_rung2_shrinks_the_chunks():
    prompt = _prompts()[2]                  # 30 tokens
    _, params = _params()
    want, plain = _chunks(_port_engine("paged"), prompt)
    ctl = OverloadController(chunk_shrink=2)
    ctl.force_rung(2)
    got, small = _chunks(_port_engine("paged", overload=ctl), prompt)
    assert plain == [16, 14] and small == [8, 8, 8, 6]
    assert got == want                      # chunking keeps the tokens


def test_overload_rung1_stops_speculation():
    ctl = _holding_controller()
    eng = _port_engine("spec", overload=ctl)
    p0 = monitor.stat_get("spec_proposed")
    eng.generate(_prompts()[0], max_new_tokens=NEW)
    mid = monitor.stat_get("spec_proposed")
    assert mid > p0
    ctl.force_rung(1)
    eng.generate(_prompts()[1], max_new_tokens=NEW)
    eng.shutdown()
    assert monitor.stat_get("spec_proposed") == mid
    assert monitor.stat_get("brownout_rung") == 1
