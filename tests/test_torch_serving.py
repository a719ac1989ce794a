"""paddle_tpu_torch serving engine, KV caches and sampling against
paddle_tpu.

Greedy token streams of the port's ``InferenceEngine`` must equal the
JAX ``InferenceEngine``'s, token for token, with shared params in f32,
in both cache modes; the port's paged mode must equal its fixed mode,
also when a small pool forces preemption. Sampled streams cannot
reproduce JAX's bits (another generator); they are held to their own
contract: a stream depends on (seed, request id) only, never on its
batch neighbours. The sampling filter chain is compared with JAX's on
the same logits (tolerance 1e-6: the same f32 arithmetic).
"""
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import gpt as jg
from paddle_tpu.serving import InferenceEngine as JaxEngine
from paddle_tpu.serving import sampling as jsampling
from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.monitor.stats import stat_get
from paddle_tpu_torch.serving import (InferenceEngine, KVCache,
                                      PagedKVCache, sampling)
from torch_jax_util import scaled_params
from torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)

CFG_J = jg.gpt_tiny(dtype=jnp.float32, seq_len=64)
CFG = tg.gpt_tiny(dtype=torch.float32, seq_len=64)
PROMPT_LENS = (5, 17, 30, 41)
NEW_TOKENS = 10
ENGINE_KW = dict(n_slots=2, max_len=64, block_size=8, prefill_chunk=16)


@functools.lru_cache(maxsize=None)
def _params():
    return scaled_params(CFG_J)


def _prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(0, CFG.vocab_size, n).astype(np.int32)
            for n in PROMPT_LENS]


def _run(engine, prompts, **kw):
    reqs = [engine.submit(p, max_new_tokens=NEW_TOKENS, **kw)
            for p in prompts]
    try:
        return [r.result(timeout=120) for r in reqs]
    finally:
        engine.shutdown()


@functools.lru_cache(maxsize=None)
def _jax_streams(paged):
    tree, _ = _params()
    eng = JaxEngine(CFG_J, jax.tree.map(jnp.asarray, tree), paged=paged,
                    **ENGINE_KW)
    return _run(eng, _prompts())


@functools.lru_cache(maxsize=None)
def _port_streams(paged):
    _, params = _params()
    eng = InferenceEngine(CFG, params, paged=paged, device="cpu",
                          **ENGINE_KW)
    return _run(eng, _prompts())


@pytest.mark.parametrize("paged", [False, True])
def test_greedy_streams_match_jax_engine(paged):
    got = _port_streams(paged)
    assert got == _jax_streams(paged)
    assert all(len(t) == NEW_TOKENS for t in got)
    assert len({tok for t in got for tok in t}) > NEW_TOKENS  # not stuck


@pytest.mark.parametrize("paged", [False, True])
def test_fused_mlp_engine_matches_jax_engine(paged):
    """An engine with fused_mlp=True (the fused LN-MLP in every block, its
    plain version on the CPU) gives the JAX fused engine's greedy
    stream (f32; off-TPU the JAX fused entry is the composed math)."""
    import dataclasses

    tree, params = _params()
    cfg_j = dataclasses.replace(CFG_J, fused_mlp=True)
    cfg_t = dataclasses.replace(CFG, fused_mlp=True)
    want = _run(JaxEngine(cfg_j, jax.tree.map(jnp.asarray, tree),
                          paged=paged, **ENGINE_KW), _prompts())
    eng = InferenceEngine(cfg_t, params, paged=paged, device="cpu",
                          **ENGINE_KW)
    assert eng.cfg.fused_mlp is True
    assert _run(eng, _prompts()) == want


def test_engine_pins_fused_kernels_flag():
    from paddle_tpu_torch.core import flags

    _, params = _params()
    old = flags.fused_kernels[0]
    try:
        flags.fused_kernels[0] = True
        eng = InferenceEngine(CFG, params, device="cpu", **ENGINE_KW)
    finally:
        flags.fused_kernels[0] = old
    try:
        assert CFG.fused_mlp is None and eng.cfg.fused_mlp is True
    finally:
        eng.shutdown()


def test_paged_equals_fixed():
    assert _port_streams(True) == _port_streams(False)


def test_forced_preemption_is_token_identical():
    """A pool of 9 usable blocks x 8 tokens cannot hold three streams of
    up to 35 tokens at once: the youngest slot is preempted, re-prefills
    prompt + generated tokens on resume, and its stream is unchanged."""
    _, params = _params()
    prompts = _prompts()[1:]
    before = stat_get("serving_preemptions")
    eng = InferenceEngine(CFG, params, device="cpu", paged=True, n_slots=3,
                          block_size=8, n_blocks=10, prefill_chunk=16)
    got = _run(eng, prompts)
    assert stat_get("serving_preemptions") > before
    assert got == _port_streams(False)[1:]


def _sampled(neighbours, paged=False):
    _, params = _params()
    eng = InferenceEngine(CFG, params, device="cpu", paged=paged, seed=11,
                          **ENGINE_KW)
    prompts = _prompts()
    reqs = [eng.submit(prompts[0], max_new_tokens=NEW_TOKENS,
                       temperature=0.9, top_k=50, top_p=0.95)]
    for i in range(neighbours):
        reqs.append(eng.submit(prompts[1 + i % 3],
                               max_new_tokens=NEW_TOKENS,
                               temperature=0.7 if i % 2 else 0.0))
    try:
        return [r.result(timeout=120) for r in reqs]
    finally:
        eng.shutdown()


@pytest.mark.parametrize("paged", [False, True])
def test_sampled_stream_independent_of_batch_neighbours(paged):
    alone = _sampled(0, paged)[0]
    crowded = _sampled(3, paged)
    assert crowded[0] == alone
    assert all(0 <= t < CFG.vocab_size for r in crowded for t in r)
    assert alone != _port_streams(False)[0]   # really sampled


def test_stream_yields_the_result_and_finish_reasons():
    _, params = _params()
    first = _port_streams(False)[0][0]
    eng = InferenceEngine(CFG, params, device="cpu", **ENGINE_KW)
    try:
        prompt = _prompts()[0]
        r = eng.submit(prompt, max_new_tokens=4)
        assert list(r.stream(timeout=60)) == r.result() \
            == _port_streams(False)[0][:4]
        assert r.finish_reason == "length"
        r = eng.submit(prompt, max_new_tokens=8, eos_id=first)
        assert r.result(timeout=60) == [first] and r.finish_reason == "eos"
        r = eng.submit(prompt, max_new_tokens=8, deadline_s=0.0)
        time.sleep(0.01)
        r.result(timeout=60)
        assert r.finish_reason == "deadline"
        r = eng.submit(prompt, max_new_tokens=40)
        r.cancel()
        r.result(timeout=60)
        assert r.finish_reason == "cancelled"
        with pytest.raises(ValueError):
            eng.submit(np.zeros(64, np.int32))
    finally:
        eng.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        eng.submit(prompt)


def test_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    _, params = _params()
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(CFG, params)


def test_filter_chain_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((4, 97)).astype(np.float32) * 3
    temps = np.asarray([0.5, 1.0, 1.3, 0.8], np.float32)
    top_k = np.asarray([0, 5, 40, 1], np.int32)
    top_p = np.asarray([0.9, 1.0, 0.5, 0.99], np.float32)
    want = jsampling._filter_logits(jnp.asarray(logits), jnp.asarray(temps),
                                    jnp.asarray(top_k), jnp.asarray(top_p))
    got = sampling._filter_logits(torch.from_numpy(logits),
                                  torch.from_numpy(temps),
                                  torch.from_numpy(top_k),
                                  torch.from_numpy(top_p))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_sampling_streams_are_pure_functions_of_seed_rid_draw():
    logits = torch.randn(3, 50, generator=torch.Generator().manual_seed(0))
    args = ([0.0, 1.0, 1.0], [0, 0, 0], [1.0, 1.0, 1.0])
    a = sampling.sample_tokens_streams(logits, *args, seed=5, rids=[0, 1, 2],
                                       draws=[0, 3, 3])
    b = sampling.sample_tokens_streams(logits[1:2], [1.0], [0], [1.0],
                                       seed=5, rids=[1], draws=[3])
    assert int(a[0]) == int(logits[0].argmax())
    assert int(a[1]) == int(b[0])
    assert sampling.stream_seed(5, 1, 3) != sampling.stream_seed(5, 1, 4)


def test_paged_cache_accounting():
    pool = PagedKVCache(CFG, n_slots=2, n_blocks=5, block_size=8,
                        device="cpu")
    s = pool.alloc()
    assert pool.grow(s, 17) and len(pool.block_tables[s]) == 3
    assert not pool.grow(s, 48)                # all or nothing
    assert len(pool.block_tables[s]) == 3
    row = pool.table_row(s)
    assert row.shape == (8,) and row[3:].tolist() == [0] * 5
    assert pool.tables_array([]).sum() == 0    # all lanes on the sink
    with pytest.raises(AssertionError):
        pool.free_blocks([pool.block_tables[s][0]] * 2)
    fixed = KVCache(CFG, n_slots=1, device="cpu")
    slot = fixed.alloc()
    assert fixed.alloc() is None
    fixed.release(slot)
    with pytest.raises(ValueError):
        fixed.release(slot)
