"""paddle_tpu_torch radix prefix cache against paddle_tpu.

Greedy streams of the port's paged engine with ``prefix_cache=True``
must equal the cold engine's (and the JAX prefix engine's), token for
token, in f32; copy-on-write must leave the tree's shared block as it
was; a small pool must reclaim tree leaves before it preempts; every
block refcount must return to the tree's own at shutdown; and on the same
request sequence the hit-rate, copy-on-write and eviction stats must
equal the JAX engine's (they count the same host-side decisions).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import monitor as jmonitor
from paddle_tpu.models import gpt as jg
from paddle_tpu.serving import InferenceEngine as JaxEngine
from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.monitor.stats import stat_get
from paddle_tpu_torch.serving import InferenceEngine, PagedKVCache
from torch_jax_util import scaled_params
from torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)

CFG_J = jg.gpt_tiny(dtype=jnp.float32, seq_len=64)
CFG = tg.gpt_tiny(dtype=torch.float32, seq_len=64)
KW = dict(n_slots=2, paged=True, block_size=8, prefill_chunk=16)
NEW = 8
STATS = ("prefix_matched_tokens", "prefix_lookup_tokens",
         "prefix_cow_copies", "prefix_evictions")


@functools.lru_cache(maxsize=None)
def _params():
    return scaled_params(CFG_J)


def _shared_prompts():
    """Three prompts sharing a 30-token head (3 full blocks of 8 and 6
    tokens into the fourth), each with its own 6-token tail."""
    rng = np.random.default_rng(5)
    head = rng.integers(0, CFG.vocab_size, 30).astype(np.int32)
    return [np.concatenate([head, rng.integers(0, CFG.vocab_size, 6)
                            .astype(np.int32)]) for _ in range(3)]


def _distinct(i):
    return np.random.default_rng(100 + i).integers(
        0, CFG.vocab_size, 24).astype(np.int32)


def _sequence():
    """The request sequence of the stats comparison: the shared prompts
    twice (hits, copy-on-write of the partial head block), then distinct
    prompts that overflow a 17-block pool (LRU evictions)."""
    p = _shared_prompts()
    return p + p + [_distinct(i) for i in range(5)]


def _port(prefix, **kw):
    _, params = _params()
    return InferenceEngine(CFG, params, device="cpu", prefix_cache=prefix,
                           **{**KW, **kw})


def _generate_all(eng, prompts):
    try:
        return [eng.generate(p, max_new_tokens=NEW) for p in prompts]
    finally:
        eng.shutdown()


@functools.lru_cache(maxsize=None)
def _cold_streams():
    return _generate_all(_port(False, n_blocks=33), _sequence())


def _tree_refs_only(eng):
    """Every pool refcount after shutdown: the tree's own, nothing else."""
    cache, tree = eng.cache, eng._prefix
    blocks = tree.blocks()
    assert len(blocks) == len(set(blocks)) == tree.block_count
    return cache._refs == {b: 1 for b in blocks} \
        and cache.free_blocks_count + len(blocks) == cache.n_blocks - 1


def test_prefix_streams_equal_cold_and_refcounts_return():
    before = {k: stat_get(k) for k in STATS}
    eng = _port(True, n_blocks=33)
    got = _generate_all(eng, _sequence())
    assert got == _cold_streams()
    assert eng._prefix.hit_rate > 0.2
    assert stat_get("prefix_cow_copies") > before["prefix_cow_copies"]
    assert _tree_refs_only(eng)


def test_concurrent_streams_share_spliced_blocks():
    """Two streams of one prompt decode at once from the same spliced
    blocks: the reader's masked attention never sees the writer's
    extensions."""
    prompts = _shared_prompts()
    eng = _port(True, n_blocks=33)
    try:
        first = eng.generate(prompts[0], max_new_tokens=NEW)
        reqs = [eng.submit(prompts[0], max_new_tokens=NEW) for _ in range(2)]
        got = [r.result(timeout=120) for r in reqs]
    finally:
        eng.shutdown()
    assert got == [first, first] == [_cold_streams()[0]] * 2
    assert _tree_refs_only(eng)


def test_copy_on_write_leaves_the_shared_block_unchanged():
    p = np.random.default_rng(6).integers(0, CFG.vocab_size, 21) \
        .astype(np.int32)                   # 2 full blocks + 5 in the tail
    eng = _port(True, n_blocks=33)
    try:
        first = eng.generate(p, max_new_tokens=NEW)
        m_len, blocks = eng._prefix.match(p)
        assert m_len == 20 and len(blocks) == 3
        shared = blocks[-1]                 # the partly used leaf block
        k0 = eng.cache.kb[shared].clone()
        v0 = eng.cache.vb[shared].clone()
        c0 = stat_get("prefix_cow_copies")
        second = eng.generate(p, max_new_tokens=NEW)
    finally:
        eng.shutdown()
    assert second == first
    assert stat_get("prefix_cow_copies") == c0 + 1
    assert torch.equal(eng.cache.kb[shared], k0)
    assert torch.equal(eng.cache.vb[shared], v0)


def test_small_pool_reclaims_leaves_before_preempting():
    p0, e0 = stat_get("serving_preemptions"), stat_get("prefix_evictions")
    eng = _port(True, n_blocks=17)
    got = _generate_all(eng, [_distinct(i) for i in range(7)])
    assert stat_get("prefix_evictions") > e0
    assert stat_get("serving_preemptions") == p0
    assert got[:5] == _cold_streams()[6:]
    assert _tree_refs_only(eng)


def test_warm_prefix_serves_later_requests():
    prompts = _shared_prompts()
    eng = _port(True, n_blocks=33)
    try:
        warm = eng.warm_prefix(prompts[0][:30])
        assert warm.result(timeout=120) and warm.rid >= 2**30
        m0 = stat_get("prefix_matched_tokens")
        got = eng.generate(prompts[1], max_new_tokens=NEW)
        assert eng._rid == 1                # warming took no live rid
    finally:
        eng.shutdown()
    assert stat_get("prefix_matched_tokens") - m0 == 30   # the warm head
    assert got == _cold_streams()[1]


def test_stats_equal_the_jax_engine():
    tree, _ = _params()
    prompts = _sequence()
    j0 = {k: jmonitor.stat_get(k) for k in STATS}
    jeng = JaxEngine(CFG_J, jax.tree.map(jnp.asarray, tree), n_blocks=17,
                     prefix_cache=True, **KW)
    want = _generate_all(jeng, prompts)
    want_stats = {k: jmonitor.stat_get(k) - j0[k] for k in STATS}
    t0 = {k: stat_get(k) for k in STATS}
    eng = _port(True, n_blocks=17)
    got = _generate_all(eng, prompts)
    got_stats = {k: stat_get(k) - t0[k] for k in STATS}
    assert got == want
    assert got_stats == want_stats
    assert got_stats["prefix_evictions"] > 0
    assert eng._prefix.block_count == jeng._prefix.block_count
    assert stat_get("prefix_hit_rate") == jmonitor.stat_get("prefix_hit_rate")


def test_idle_engine_reclaims_a_whole_chain():
    """A fault of the JAX package's tree, repaired in the port: with one
    40-token prompt cached as a chain of five full blocks, a distinct
    40-token prompt needs 6 of the 8 usable blocks; 3 are free and the
    chain has one childless node, so the JAX admission gate (free +
    childless nodes) waits for ever on an idle engine. The port counts
    every node leaves-first eviction can reach and admits it."""
    tree, _ = _params()
    rng = np.random.default_rng(12)
    a, b = (rng.integers(0, CFG.vocab_size, 40).astype(np.int32)
            for _ in range(2))
    jeng = JaxEngine(CFG_J, jax.tree.map(jnp.asarray, tree), n_blocks=9,
                     prefix_cache=True, **KW)
    try:
        jeng.generate(a, max_new_tokens=4)
        with pytest.raises(TimeoutError):
            jeng.submit(b, max_new_tokens=4).result(timeout=3)
    finally:
        jeng.shutdown(drain=False, timeout=30)
    e0 = stat_get("prefix_evictions")
    eng = _port(True, n_blocks=9)
    try:
        eng.generate(a, max_new_tokens=4)
        assert eng._prefix.evictable_count() == 5
        got = eng.submit(b, max_new_tokens=4).result(timeout=60)
    finally:
        eng.shutdown()
    assert stat_get("prefix_evictions") - e0 >= 3
    cold = _port(False, n_blocks=9)
    assert got == _generate_all(cold, [b])[0][:4]


def test_pool_refcounts():
    pool = PagedKVCache(CFG, n_slots=2, n_blocks=6, block_size=8,
                        device="cpu")
    a, b = pool.alloc(), pool.alloc()
    assert pool.grow(a, 16)
    shared = pool.block_tables[a][1]
    pool.splice(b, pool.block_tables[a])
    assert pool.ref_count(shared) == 2
    nb = pool.alloc_block()
    assert pool.replace_block(b, 1, nb) == shared
    assert pool.ref_count(shared) == 1 and pool.ref_count(nb) == 1
    pool.release(a)
    assert pool.ref_count(shared) == 0      # its last reference went
    assert pool.ref_count(pool.block_tables[b][0]) == 1
    pool.release(b)
    assert pool.free_blocks_count == 5 and not pool._refs
    with pytest.raises(AssertionError, match="double"):
        pool.unref_block(shared)
    with pytest.raises(AssertionError, match="not allocated"):
        pool.ref_block(shared)
    with pytest.raises(AssertionError, match="sink"):
        pool.unref_block(0)


def test_refusals_match_jax():
    _, params = _params()
    with pytest.raises(ValueError, match="paged"):
        InferenceEngine(CFG, params, device="cpu", paged=False,
                        prefix_cache=True)
    with pytest.raises(ValueError, match="MoE"):
        InferenceEngine(tg.gpt_tiny(moe_experts=4),
                        tg.gpt_init(tg.gpt_tiny(moe_experts=4), device="cpu"),
                        device="cpu", paged=True, prefix_cache=True)
