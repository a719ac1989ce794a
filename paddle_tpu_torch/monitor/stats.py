"""Minimal gauge registry: the serving and KV-pool gauges the ported
engine and cache set, the ``train_steps`` counter the train step bumps,
the ``fused_optimizer_steps`` / ``int8_matmul_calls`` /
``fp8_matmul_calls`` counters of the fused optimizer and the int8 and
fp8 matmuls, the MoE router's ``moe_expert_load`` gauge and
``moe_tokens_dropped`` counter, the ``fused_kernel_calls`` counter of
``ops/fused.py``, and the engine's speculative-decoding, prefix-cache and
constrained-decoding stats (a subset of ``paddle_tpu/monitor/stats.py``,
with its names).

A :class:`Stat` is a named int64 gauge; :class:`StatRegistry` is the
process-wide thread-safe registry. Tracing spans and latency histograms
wait for a later slice.
"""
from __future__ import annotations

import threading

__all__ = ["Stat", "StatRegistry", "stat_get"]


class Stat:
    """One named int64 counter/gauge."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def add(self, delta: int = 1) -> None:
        with self._lock:
            self._value += delta

    def set(self, value: int) -> None:
        with self._lock:
            self._value = int(value)

    def get(self) -> int:
        return self._value

    def __repr__(self):
        return f"Stat({self.name}={self._value})"


class StatRegistry:
    """Thread-safe name → Stat map."""

    def __init__(self):
        self._stats: dict = {}
        self._lock = threading.Lock()

    def get_stat(self, name: str) -> Stat:
        with self._lock:
            return self._stats.setdefault(name, Stat(name))


_registry = StatRegistry()


def stat_get(name: str) -> int:
    return _registry.get_stat(name).get()


SERVING_QUEUE_DEPTH = _registry.get_stat("serving_queue_depth")
SERVING_SLOT_OCCUPANCY = _registry.get_stat("serving_slot_occupancy")
SERVING_PREFILL_MS = _registry.get_stat("serving_prefill_ms")
SERVING_DECODE_MS = _registry.get_stat("serving_decode_ms")
SERVING_TOKENS_PER_S = _registry.get_stat("serving_tokens_per_s")
SERVING_EVICTIONS = _registry.get_stat("serving_evictions")
SERVING_PREEMPTIONS = _registry.get_stat("serving_preemptions")
SERVING_DEADLINE_SHEDS = _registry.get_stat("serving_deadline_sheds")
KV_BLOCKS_FREE = _registry.get_stat("kv_blocks_free")
KV_BLOCKS_USED = _registry.get_stat("kv_blocks_used")
KV_FRAGMENTATION = _registry.get_stat("kv_fragmentation")
TRAIN_STEPS = _registry.get_stat("train_steps")
FUSED_OPTIMIZER_STEPS = _registry.get_stat("fused_optimizer_steps")
INT8_MATMUL_CALLS = _registry.get_stat("int8_matmul_calls")
FP8_MATMUL_CALLS = _registry.get_stat("fp8_matmul_calls")
# busiest expert's share of the routed tokens of the last decode tick, ppm
MOE_EXPERT_LOAD = _registry.get_stat("moe_expert_load")
# routed assignments dropped past expert capacity
MOE_TOKENS_DROPPED = _registry.get_stat("moe_tokens_dropped")
# fused_feedforward calls that took the fused kernels (FLAGS_fused_kernels)
FUSED_KERNEL_CALLS = _registry.get_stat("fused_kernel_calls")
# speculative decoding: draft tokens proposed / accepted by the target's
# verify pass, and the lifetime acceptance percentage (gauge)
SPEC_PROPOSED = _registry.get_stat("spec_proposed")
SPEC_ACCEPTED = _registry.get_stat("spec_accepted")
SPEC_ACCEPTANCE_RATE = _registry.get_stat("spec_acceptance_rate")
# radix prefix cache: prompt tokens served from the tree / looked up at
# admission, their percentage (gauge), pool blocks pinned by the tree
# (gauge), LRU-reclaimed leaves, copy-on-write duplications
PREFIX_MATCHED_TOKENS = _registry.get_stat("prefix_matched_tokens")
PREFIX_LOOKUP_TOKENS = _registry.get_stat("prefix_lookup_tokens")
PREFIX_HIT_RATE = _registry.get_stat("prefix_hit_rate")
PREFIX_CACHE_BLOCKS = _registry.get_stat("prefix_cache_blocks")
PREFIX_EVICTIONS = _registry.get_stat("prefix_evictions")
PREFIX_COW_COPIES = _registry.get_stat("prefix_cow_copies")
# constrained decoding: requests under a token-mask automaton, and
# speculative ticks dropped to the one-token tick for them
CONSTRAINED_REQUESTS = _registry.get_stat("constrained_requests")
CONSTRAINED_FALLBACK_TICKS = _registry.get_stat("constrained_fallback_ticks")
