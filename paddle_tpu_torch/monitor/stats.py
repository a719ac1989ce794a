"""Gauge and histogram registry: the serving and KV-pool gauges the
ported engine and cache set, the ``train_steps`` counter the train step
bumps, the ``fused_optimizer_steps`` / ``int8_matmul_calls`` /
``fp8_matmul_calls`` counters of the fused optimizer and the int8 and
fp8 matmuls, the MoE router's ``moe_expert_load`` gauge and
``moe_tokens_dropped`` counter, the ``fused_kernel_calls`` counter of
``ops/fused.py``, the engine's speculative-decoding, prefix-cache and
constrained-decoding stats, its watchdog and brownout stats, the
injected-fault counter, the router's, replica supervisor's and HTTP front
end's stats, the cross-host fleet's and its RPC transport's stats, and
the latency histograms of the engine, the fleet's KV stream, its
arrivals and its RPC round trips, the training resilience gauges
(sentinel trips, rollbacks, preemption saves, watchdog stalls, the
guardian's heartbeat, the pod's live hosts and resizes) and the memory
gauges (a subset of ``paddle_tpu/monitor/stats.py``, with its names).

A :class:`Stat` is a named int64 gauge; a :class:`Histogram` a
fixed-bucket (log2) latency histogram with count and sum;
:class:`StatRegistry` the process-wide thread-safe registry of both.
:func:`prometheus_text` renders the registry as the front end's
``GET /metrics`` serves it, under the reference's metric names.
:func:`update_memory_stats` refreshes ``host_memory_bytes`` (the
process's peak RSS) and ``device_memory_bytes`` (the bytes the caching
allocator holds in use on every visible card, from
``torch.cuda.memory_stats``).
"""
from __future__ import annotations

import re
import threading

__all__ = ["Stat", "StatRegistry", "stat_get", "stat_add", "stat_reset",
           "stat_names", "stat_snapshot", "reset_all_stats", "Histogram",
           "DEFAULT_HISTOGRAMS", "hist_observe", "get_histogram",
           "histogram_snapshot", "hist_delta", "hist_quantile",
           "prometheus_text", "update_memory_stats"]


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

    def reset(self) -> None:
        with self._lock:
            self._value = 0

    def __repr__(self):
        return f"Stat({self.name}={self._value})"


# log2-spaced bucket bounds (milliseconds): 0.125 ms .. 8.192 s, shared by
# every default histogram so quantiles of two metrics read off one
# resolution
DEFAULT_BUCKETS_MS = tuple(2.0 ** k for k in range(-3, 14))


class Histogram:
    """Fixed-bucket latency histogram (Prometheus semantics: per-bucket
    counts with a +Inf overflow bucket, count and sum). The bounds never
    move, so two snapshots diff cleanly (:func:`hist_delta`)."""

    __slots__ = ("name", "bounds", "_counts", "_count", "_sum", "_lock")

    def __init__(self, name: str, bounds=DEFAULT_BUCKETS_MS):
        self.name = name
        self.bounds = tuple(float(b) for b in bounds)
        if list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError(f"histogram bounds must be strictly "
                             f"increasing, got {bounds}")
        self._counts = [0] * (len(self.bounds) + 1)   # +1 = +Inf overflow
        self._count = 0
        self._sum = 0.0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        v = float(value)
        i = 0
        for b in self.bounds:
            if v <= b:
                break
            i += 1
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v

    def snapshot(self) -> dict:
        """{"bounds", "counts" (per bucket, not cumulative, +Inf last),
        "count", "sum"}."""
        with self._lock:
            return {"bounds": list(self.bounds),
                    "counts": list(self._counts),
                    "count": self._count, "sum": self._sum}

    def quantile(self, q: float) -> float:
        return hist_quantile(self.snapshot(), q)

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self.bounds) + 1)
            self._count = 0
            self._sum = 0.0

    def __repr__(self):
        return f"Histogram({self.name}, count={self._count})"


def hist_delta(before: dict, after: dict) -> dict:
    """The observations made between two snapshots of one histogram."""
    if before["bounds"] != after["bounds"]:
        raise ValueError("histogram snapshots have different bounds")
    return {"bounds": list(after["bounds"]),
            "counts": [a - b for a, b in zip(after["counts"],
                                             before["counts"])],
            "count": after["count"] - before["count"],
            "sum": after["sum"] - before["sum"]}


def hist_quantile(snap: dict, q: float) -> float:
    """Quantile estimate from a snapshot: linear interpolation inside the
    bucket where the cumulative count crosses ``q`` (the +Inf bucket
    clamps to the last finite bound); 0.0 for an empty snapshot."""
    count = snap["count"]
    if count <= 0:
        return 0.0
    rank = q * count
    cum = 0
    lo = 0.0
    for i, c in enumerate(snap["counts"]):
        nxt = cum + c
        if nxt >= rank and c > 0:
            if i >= len(snap["bounds"]):
                return float(snap["bounds"][-1])
            hi = snap["bounds"][i]
            return float(lo + (hi - lo) * (rank - cum) / c)
        cum = nxt
        if i < len(snap["bounds"]):
            lo = snap["bounds"][i]
    return float(snap["bounds"][-1])


class StatRegistry:
    """Thread-safe registry of Stats and Histograms by name."""

    def __init__(self):
        self._stats: dict = {}
        self._hists: dict = {}
        self._lock = threading.Lock()

    def get_stat(self, name: str) -> Stat:
        with self._lock:
            return self._stats.setdefault(name, Stat(name))

    def get_histogram(self, name: str,
                      bounds=DEFAULT_BUCKETS_MS) -> Histogram:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram(name, bounds)
            return h

    def histogram_snapshot(self) -> dict:
        with self._lock:
            hists = sorted(self._hists.items())
        return {n: h.snapshot() for n, h in hists}

    def add(self, name: str, delta: int = 1) -> None:
        self.get_stat(name).add(delta)

    def get(self, name: str) -> int:
        return self.get_stat(name).get()

    def reset(self, name: str) -> None:
        self.get_stat(name).reset()

    def reset_all(self) -> None:
        with self._lock:
            for s in self._stats.values():
                s.reset()
            for h in self._hists.values():
                h.reset()

    def names(self):
        with self._lock:
            return sorted(self._stats)

    def snapshot(self) -> dict:
        with self._lock:
            return {n: s.get() for n, s in sorted(self._stats.items())}


_registry = StatRegistry()


def stat_add(name: str, delta: int = 1) -> None:
    _registry.add(name, delta)


def stat_get(name: str) -> int:
    return _registry.get(name)


def stat_reset(name: str) -> None:
    _registry.reset(name)


def stat_names():
    return _registry.names()


def stat_snapshot() -> dict:
    return _registry.snapshot()


def reset_all_stats() -> None:
    _registry.reset_all()


def hist_observe(name: str, value: float) -> None:
    _registry.get_histogram(name).observe(value)


def get_histogram(name: str) -> Histogram:
    return _registry.get_histogram(name)


def histogram_snapshot() -> dict:
    return _registry.histogram_snapshot()


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
# captured train-step graphs made (jit.TrainStep: one a new batch
# signature, the port's counterpart of a recompile)
JIT_COMPILE = _registry.get_stat("jit_compile")
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
# serving watchdog: NaN-tick / latency-stall verdicts, and engine
# restarts from the last healthy state
SERVING_WATCHDOG_TRIPS = _registry.get_stat("serving_watchdog_trips")
SERVING_WATCHDOG_RESTARTS = _registry.get_stat("serving_watchdog_restarts")
# brownout ladder: the current rung (gauge) and transitions taken
BROWNOUT_RUNG = _registry.get_stat("brownout_rung")
BROWNOUT_STEPS = _registry.get_stat("brownout_steps")
# FLAGS_fault_inject faults that fired
FAULTS_INJECTED = _registry.get_stat("faults_injected")
# the HTTP front end: generation requests accepted, tenant-admission
# rejections (429), the cumulative lane wait before submission (ms), open
# generation streams (gauge), requests answered 503 (overload or deadline
# shed)
FRONTEND_REQUESTS = _registry.get_stat("frontend_requests")
FRONTEND_429S = _registry.get_stat("frontend_429s")
FRONTEND_QUEUE_WAIT_MS = _registry.get_stat("frontend_queue_wait_ms")
FRONTEND_ACTIVE_STREAMS = _registry.get_stat("frontend_active_streams")
FRONTEND_LOAD_SHEDS = _registry.get_stat("frontend_load_sheds")
# the replica router: streams adopted by a survivor, and the routable
# replicas (gauge)
ROUTER_FAILOVERS = _registry.get_stat("router_failovers")
SERVING_REPLICAS_HEALTHY = _registry.get_stat("serving_replicas_healthy")
# the replica supervisor: the replica count it steers toward (gauge),
# respawns, completed scale events, prompt tokens replayed to re-warm a
# rejoined replica's radix tree
SERVING_REPLICAS_TARGET = _registry.get_stat("serving_replicas_target")
SERVING_REPLICA_RESTARTS = _registry.get_stat("serving_replica_restarts")
SERVING_SCALE_EVENTS = _registry.get_stat("serving_scale_events")
PREFIX_WARM_TOKENS = _registry.get_stat("prefix_warm_tokens")
# the cross-host serving fleet (serving/pod.py) and its RPC transport
# (serving/rpc.py); the reference's comments, one per name:
# gauge: fleet hosts with a fresh heartbeat
FLEET_HOSTS = _registry.get_stat("fleet_hosts")
# gauge: remote replica proxies attached to the router
FLEET_REPLICAS = _registry.get_stat("fleet_replicas")
# KV block bytes streamed prefill-host -> decode-host
FLEET_KV_TRANSFER_BYTES = _registry.get_stat("fleet_kv_transfer_bytes")
# prefix exports served by prefill-role replicas
FLEET_KV_EXPORTS = _registry.get_stat("fleet_kv_exports")
# prefix imports spliced into decode-role pools
FLEET_KV_IMPORTS = _registry.get_stat("fleet_kv_imports")
# requests whose prefill ran on a prefill-role host
FLEET_PREFILL_ROUTED = _registry.get_stat("fleet_prefill_routed")
# disaggregated submits that fell back to direct decode
FLEET_DIRECT_FALLBACKS = _registry.get_stat("fleet_direct_fallbacks")
# host-loss events that re-routed streams to survivors
FLEET_REROUTES = _registry.get_stat("fleet_reroutes")
# replicas pre-warmed by the arrival-rate forecaster
FLEET_PREWARMS = _registry.get_stat("fleet_prewarms")
# RPC round trips issued by remote replica proxies
RPC_CALLS = _registry.get_stat("rpc_calls")
# RPC round trips that failed (transport or remote)
RPC_ERRORS = _registry.get_stat("rpc_errors")
# idempotent RPC calls re-sent after a transport error
RPC_RETRIES = _registry.get_stat("rpc_retries")
# gauge: per-peer circuit breakers currently OPEN
RPC_BREAKER_STATE = _registry.get_stat("rpc_breaker_state")
# frames shed by the receiver: deadline already expired
RPC_DEADLINE_SHEDS = _registry.get_stat("rpc_deadline_sheds")
# KV chunks shipped by the resumable streaming path
FLEET_KV_CHUNKS_STREAMED = _registry.get_stat("fleet_kv_chunks_streamed")
# decode-side local tail prefills after a mid-stream loss
FLEET_KV_RESUME_TAILS = _registry.get_stat("fleet_kv_resume_tails")
# fleet-wide flight-recorder collection sweeps
FLIGHT_COLLECTS = _registry.get_stat("flight_collects")

# training resilience (resilience/guardian.py, resilience/pod.py): the
# sentinel's verdict trips the guardian has read, snapshot rollbacks,
# preemption priority saves, watchdog-detected stalled steps, the last
# guardian heartbeat (monotonic ms, gauge), the pod's live hosts (gauge)
# and elastic resizes
SENTINEL_TRIPS = _registry.get_stat("sentinel_trips")
ROLLBACKS = _registry.get_stat("rollbacks")
PREEMPT_SAVES = _registry.get_stat("preempt_saves")
WATCHDOG_STALLS = _registry.get_stat("watchdog_stalls")
GUARDIAN_HEARTBEAT_MS = _registry.get_stat("guardian_heartbeat_ms")
POD_HOSTS_ALIVE = _registry.get_stat("pod_hosts_alive")
ELASTIC_RESIZES = _registry.get_stat("elastic_resizes")
# memory gauges (update_memory_stats): the process's peak RSS and the
# caching allocator's in-use bytes over the visible cards
HOST_MEMORY_BYTES = _registry.get_stat("host_memory_bytes")
DEVICE_MEMORY_BYTES = _registry.get_stat("device_memory_bytes")


def update_memory_stats() -> dict:
    """Refresh the host and device memory gauges and return them
    ({name: bytes}). The host side reads the process's peak RSS; the
    device side sums ``allocated_bytes.all.current`` of
    ``torch.cuda.memory_stats`` over the visible cards (nothing is read,
    and the gauge keeps its value, where no card is initialised)."""
    try:
        import resource

        rss_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        HOST_MEMORY_BYTES.set(int(rss_kb) * 1024)
    except Exception:  # noqa: BLE001 - a platform without getrusage
        pass
    try:
        import torch

        if torch.cuda.is_available() and torch.cuda.is_initialized():
            total = 0
            for i in range(torch.cuda.device_count()):
                st = torch.cuda.memory_stats(i)
                total += int(st.get("allocated_bytes.all.current", 0))
            DEVICE_MEMORY_BYTES.set(total)
    except Exception:  # noqa: BLE001 - a card that cannot be read
        pass
    return {"host_memory_bytes": HOST_MEMORY_BYTES.get(),
            "device_memory_bytes": DEVICE_MEMORY_BYTES.get()}


# the engine's latency histograms, recorded at the source (ms)
DEFAULT_HISTOGRAMS = (
    ("serving_first_token_ms",
     "submit-to-first-token latency per request (ms)"),
    ("serving_per_token_ms",
     "steady-state inter-token latency per request, "
     "(t_last - t_first)/(n-1) (ms)"),
    ("serving_queue_wait_ms",
     "queue wait before work starts: WFQ lane wait and engine "
     "admission wait (ms)"),
    ("serving_decode_tick_ms",
     "batched decode tick wall latency (ms)"),
    ("serving_prefill_chunk_ms",
     "prefill work quantum wall latency: one chunk (paged) or one "
     "whole-prompt prefill (fixed) (ms)"),
    ("fleet_kv_transfer_ms",
     "prefill-host -> decode-host KV block stream wall latency per "
     "prompt: export + transport + pool splice (ms)"),
    ("fleet_arrival_gap_ms",
     "inter-arrival gap between fleet submissions (ms) — the "
     "arrival-rate series the pre-warm forecaster reads (rps = "
     "1000/median gap)"),
    ("rpc_call_ms",
     "remote-replica RPC round-trip wall latency (ms)"),
)

HISTOGRAM_HELP = dict(DEFAULT_HISTOGRAMS)

for _n, _ in DEFAULT_HISTOGRAMS:
    _registry.get_histogram(_n)

SERVING_FIRST_TOKEN_MS = _registry.get_histogram("serving_first_token_ms")
SERVING_PER_TOKEN_MS = _registry.get_histogram("serving_per_token_ms")
SERVING_QUEUE_WAIT_MS = _registry.get_histogram("serving_queue_wait_ms")
SERVING_DECODE_TICK_MS = _registry.get_histogram("serving_decode_tick_ms")
SERVING_PREFILL_CHUNK_MS = _registry.get_histogram(
    "serving_prefill_chunk_ms")
FLEET_KV_TRANSFER_MS = _registry.get_histogram("fleet_kv_transfer_ms")
FLEET_ARRIVAL_GAP_MS = _registry.get_histogram("fleet_arrival_gap_ms")
RPC_CALL_MS = _registry.get_histogram("rpc_call_ms")


# -- Prometheus text exposition (the front end's GET /metrics) --------------

_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str, prefix: str = "paddle_tpu_") -> str:
    """Sanitize to a legal Prometheus metric name: invalid characters
    (a per-axis gauge's ``.``, a benchmark row's ``@``) become ``_``, and
    a leading digit is prefixed. The prefix is the reference's, so a
    scrape of the port reads like a scrape of the reference."""
    n = _PROM_BAD.sub("_", str(name))
    if n and n[0].isdigit():
        n = "_" + n
    return prefix + n


def _prom_num(v: float) -> str:
    """Format a float the Prometheus text format accepts (no trailing
    noise: 0.125 -> '0.125', 8192.0 -> '8192')."""
    return format(float(v), "g")


def prometheus_text(prefix: str = "paddle_tpu_") -> str:
    """The full registry in Prometheus text exposition format 0.0.4:
    every gauge with ``# HELP``/``# TYPE``, every histogram as
    cumulative ``_bucket{le=...}`` series plus ``_sum``/``_count``. It
    reads registry snapshots only, so a scrape never waits on a
    scheduler tick."""
    lines = []
    for name, value in stat_snapshot().items():
        m = _prom_name(name, prefix)
        lines.append(f"# HELP {m} int64 gauge {name}")
        lines.append(f"# TYPE {m} gauge")
        lines.append(f"{m} {int(value)}")
    for name, snap in histogram_snapshot().items():
        m = _prom_name(name, prefix)
        help_txt = HISTOGRAM_HELP.get(name, f"latency histogram {name}")
        lines.append(f"# HELP {m} {help_txt}")
        lines.append(f"# TYPE {m} histogram")
        cum = 0
        for bound, c in zip(snap["bounds"], snap["counts"]):
            cum += c
            lines.append(f'{m}_bucket{{le="{_prom_num(bound)}"}} {cum}')
        lines.append(f'{m}_bucket{{le="+Inf"}} {snap["count"]}')
        lines.append(f"{m}_sum {_prom_num(snap['sum'])}")
        lines.append(f"{m}_count {snap['count']}")
    return "\n".join(lines) + "\n"
# gauge: batches DevicePrefetcher holds staged on the card
PREFETCH_QUEUE_DEPTH = _registry.get_stat("prefetch_queue_depth")
# host ms spent issuing DevicePrefetcher's copies to the card
H2D_COPY_MS = _registry.get_stat("h2d_copy_ms")
# AsyncLoss handles whose value was read on the host (one each)
STEP_ASYNC_SYNCS = _registry.get_stat("step_async_syncs")
