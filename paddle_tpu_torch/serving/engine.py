"""Continuous-batching inference engine over the KV cache.

Counterpart of ``paddle_tpu/serving/engine.py`` (the fixed-slot and
paged paths). Request lifecycle::

    submit() ──► bounded queue ──► [admit: prefill into a free slot]
                                        │
        stream()/result() ◄── tokens ◄──┤  one decode step per tick,
                                        │  batched over ALL slots
                  [evict: eos / max_new_tokens / length / deadline / cancel]

One scheduler thread owns the device state (params, cache buffers) and
runs every model call under ``torch.inference_mode()``; ``submit`` may be
called from any thread and only touches the queue.

Fixed slots (default, ``FLAGS_paged_kv=0``): admission prefills the whole
prompt, end-padded to the next power of two from 16 (causality makes the
padding exact), writes its K/V into the slot and streams the first token.
The prefill's attention is the flash-attention kernel on the card.

Paged (``paged=True`` or ``FLAGS_paged_kv=1``): a block pool with per-slot
block tables. Admission is gated on free blocks (a prompt up to
``cfg.seq_len - 1`` tokens waits at the head of the queue until blocks
free up); prompts prefill in ``prefill_chunk``-token chunks, one chunk
per slot per tick, interleaved with decode; the decode step's table
width is bucketed to the next power of two of the live maximum; when the
pool runs dry the youngest slot is preempted back to the queue head and
later resumes by re-prefilling prompt + generated tokens (its stream is
unaffected). The decode's attention is the paged-attention kernel on the
card.

int8 weights (``int8_weights=True``): the block matmul weights are
quantized once, per channel, into a second tree that only the decode
tick uses (the int8 matmul kernel on the card); prefill and chunked
prefill keep the fp weights.

Mixture of experts (``cfg.moe_experts > 0``): every path routes
droplessly (the dispatch-gather kernel on the card); each decode tick's
router counts ride back to the host in the same copy as the sampled
tokens, and set the ``moe_expert_load`` gauge (the busiest expert's
share of the tick's routed tokens, ppm) and the ``moe_tokens_dropped``
counter. fp8 (``cfg.fp8``, or ``FLAGS_fp8_matmul`` pinned at
construction) runs the fixed-slot prefill's MLP matmuls in e4m3.

Speculative decoding (``draft=(draft_cfg, draft_params)``, ``spec_k``):
a small draft model with its own fixed-slot cache (seeded alongside the
target's at admission) proposes ``spec_k`` tokens per slot per tick, the
target scores all k+1 positions in one verify pass
(``models.gpt.gpt_verify_step`` / ``gpt_verify_step_paged``), and the
rejection-sampling rule (``sampling.spec_accept``) keeps the target's
distribution: greedy output is token-identical to ``draft=None``. A tick
falls back to the one-token decode when a slot is near its cap, the
paged grow for k+1 positions fails, or a row is constrained.

Prefix sharing (``prefix_cache=True`` or ``FLAGS_prefix_cache=1``, paged
only): admission walks a radix tree of cached prompt prefixes
(``serving/prefix_cache.py``), splices the matched refcounted blocks
into the new slot's table and prefills only the uncached tail, in
chunks that start at the unaligned matched length; a partly used last
block is copied first (copy-on-write). Finished prompts enter the tree;
when the pool runs dry the scheduler reclaims LRU tree leaves before it
preempts. Greedy output is token-identical to the cold cache.

Text and constraints: ``tokenizer=`` (``serving/tokenizer.py``) enables
``submit(text=...)`` and ``GenerationRequest.stream_text()`` / ``text()``;
``submit(constraint=...)`` (``serving/constrained.py``) masks every
sampled token through a byte-DFA cursor that advances on the host, and a
completed (or dead) automaton ends the stream with finish_reason
``"stop"``.

Resilience: ``watchdog=`` arms a per-tick NaN/latency sentinel. Each
decode tick also computes a per-slot all-finite verdict over the logits
(``resilience.sentinel.logits_finite``), which reaches the host in the
same copy as the sampled tokens; a poisoned slot fails only its own
request (finish_reason ``"watchdog"``, :class:`WatchdogTripped`), and the
engine restarts: healthy open streams are requeued with their token
history and replayed through the preemption-resume path (token-identical
continuations), and the cache, prefix tree and draft cache are zeroed in
place. ``overload=`` (``serving.overload.OverloadController``) gets the
queue waits and tick latencies and steps the brownout ladder: rung 1
drops speculative decoding, rung 2 shrinks prefill chunks.
``FLAGS_fault_inject`` (``resilience/faults.py``) drives the serving
faults: ``serving_nan`` poisons a request's cached K/V, ``slow_tick``
stalls the scheduler, ``replica_crash`` kills it; ``fail_at_tick`` is
the deterministic crash.

Fleet hooks: ``replica_id`` tags the engine's spans and fault specs;
``failover`` holds a router's adoption hook, stamped onto each request
and offered the request when the engine dies; ``adopt_request`` replays
another engine's stream here (token-identical when the engines share
the seed, since the request keeps its id); ``evacuate`` fails every open
stream with :class:`ReplicaEvacuated`; ``run_on_scheduler`` runs a
closure on the scheduler thread between ticks, which the KV streaming
(``export_kv_prefix`` / ``import_kv_prefix``, ``export_kv_range`` /
``import_kv_chunk``) uses to copy pool blocks; ``alive``, ``busy``,
``tick_age`` and ``pool_headroom`` are the health surface.

Observability: latency histograms (``serving_first_token_ms``,
``serving_per_token_ms``, ``serving_queue_wait_ms``,
``serving_decode_tick_ms``, ``serving_prefill_chunk_ms``); the
``serving.prefill`` / ``serving.prefill_chunk`` / ``serving.decode_step``
spans (``monitor/trace.py``); a request submitted with
``trace=TraceContext`` stamps every span it touches, a
``serving.decode_tick`` event per tick it rides and a
``serving.request_done`` event with the flow's finish; ``flight_dir=``
arms the process's flight recorder (``monitor/flight.py``), which the
scheduler abort and the watchdog restart dump. Spans time the host: a
tick's span ends at its device-to-host copy.

Not ported yet (see ROADMAP.md): the serving mesh (``mesh=``, a sharded
pool) and the ranker (``rank``, ``embedding_tables``).
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..core import flags
from ..models.gpt import (_check_ported, _head, gpt_decode_step,
                          gpt_decode_step_paged, gpt_verify_step,
                          gpt_verify_step_paged, prefill_chunk_hidden,
                          prefill_hidden, quantize_gpt_weights)
from ..monitor.flight import arm_flight_recorder, dump_flight
from ..monitor.stats import (CONSTRAINED_FALLBACK_TICKS,
                             CONSTRAINED_REQUESTS, FAULTS_INJECTED,
                             MOE_EXPERT_LOAD, MOE_TOKENS_DROPPED,
                             PREFIX_COW_COPIES, SERVING_DEADLINE_SHEDS,
                             SERVING_DECODE_MS, SERVING_DECODE_TICK_MS,
                             SERVING_EVICTIONS, SERVING_FIRST_TOKEN_MS,
                             SERVING_PER_TOKEN_MS, SERVING_PREEMPTIONS,
                             SERVING_PREFILL_CHUNK_MS, SERVING_PREFILL_MS,
                             SERVING_QUEUE_DEPTH, SERVING_QUEUE_WAIT_MS,
                             SERVING_SLOT_OCCUPANCY, SERVING_TOKENS_PER_S,
                             SERVING_WATCHDOG_RESTARTS,
                             SERVING_WATCHDOG_TRIPS, SPEC_ACCEPTANCE_RATE,
                             SPEC_ACCEPTED, SPEC_PROPOSED)
from ..monitor.trace import (emit_complete, emit_flow, emit_instant,
                             recording, span)
from ..resilience import faults as _faults
from ..resilience.sentinel import logits_finite
from .kv_cache import KVCache, PagedKVCache, cache_insert
from .prefix_cache import RadixPrefixCache
from .sampling import DRAFT_SALT, sample_tokens_streams, spec_accept

__all__ = ["InferenceEngine", "GenerationRequest", "QueueFull",
           "WatchdogTripped", "ReplicaEvacuated"]


class QueueFull(RuntimeError):
    """submit() backpressure: the bounded request queue is at capacity."""


# finish reasons
EOS = "eos"
LENGTH = "length"
DEADLINE = "deadline"
CANCELLED = "cancelled"
SHUTDOWN = "shutdown"
ERROR = "error"
STOP = "stop"        # constrained decoding: the automaton's match is
#                      complete (or dead) — nothing more to emit
WATCHDOG = "watchdog"  # the per-tick NaN sentinel found this stream's
#                        logits poisoned; the engine restarted around it

# rid floor of the prefix re-warm request space: warm prefills draw RNG
# streams that never collide with, or shift the numbering of, live ids
_WARM_RID_BASE = 2**30


class WatchdogTripped(RuntimeError):
    """The ``error`` of a request the serving watchdog failed: its decode
    logits went non-finite. Healthy streams of the same batch resume,
    token-identical."""


class ReplicaEvacuated(RuntimeError):
    """Raised by the scheduler when :meth:`InferenceEngine.evacuate` asks
    it to stop: every open stream fails with this cause, which a
    ``failover`` hook turns into adoption by another engine."""


class GenerationRequest:
    """Per-request handle returned by :meth:`InferenceEngine.submit`:
    ``stream()`` yields tokens live, ``result()`` blocks for the list,
    ``finish_reason`` says why generation stopped. Engines built with a
    tokenizer also offer ``stream_text()`` / ``text()``."""

    def __init__(self, prompt, max_new_tokens: int, temperature: float,
                 top_k: int, top_p: float, eos_id: Optional[int],
                 deadline: Optional[float], constraint=None):
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.eos_id = eos_id
        self.deadline = deadline          # absolute time.monotonic() or None
        self.constraint = constraint      # ConstraintCursor (scheduler-owned)
        self.rid = 0                      # engine-assigned: the RNG stream id
        self.trace = None                 # TraceContext or None: the
        #                                   request's causal identity
        self._tokenizer = None            # the engine's tokenizer, if any
        self.tokens: List[int] = []       # generated ids (includes eos)
        self.finish_reason: Optional[str] = None
        self.error: Optional[BaseException] = None
        self._cancelled = False
        # paged preemption: (cached-prefix tokens, last token) to
        # re-prefill from when the request is re-admitted
        self._resume = None
        # a router's failover hook: called (req, err) when the owning
        # engine dies; True means another engine adopted the request and
        # the error must not finish it
        self._failover = None
        self._t_submit = 0.0              # monotonic enqueue time
        self._t_first = None              # monotonic time of the 1st token
        self._cv = threading.Condition()

    # -- scheduler side ------------------------------------------------------
    def _push(self, tok: int) -> None:
        with self._cv:
            self.tokens.append(tok)
            if self._t_first is None:
                self._t_first = time.monotonic()
                if self._t_submit:
                    SERVING_FIRST_TOKEN_MS.observe(
                        (self._t_first - self._t_submit) * 1e3)
            self._cv.notify_all()

    def _finish(self, reason: str, error: Optional[BaseException] = None):
        if reason == ERROR and self._failover is not None:
            # the engine died (never a per-request verdict): offer the
            # stream to the router first — adoption replays it elsewhere
            handler, self._failover = self._failover, None
            try:
                if handler(self, error):
                    return          # adopted: another engine owns it now
            except Exception:  # noqa: BLE001 — a failing hook must not
                pass           # mask the original error: fall through
        finished = False
        with self._cv:
            if self.finish_reason is None:
                self.finish_reason = reason
                self.error = error
                finished = True
            self._cv.notify_all()
        if not finished:
            return
        if self._t_first is not None and len(self.tokens) >= 2:
            # the inter-token rate the client saw, stalls included
            SERVING_PER_TOKEN_MS.observe(
                (time.monotonic() - self._t_first) * 1e3
                / (len(self.tokens) - 1))
        if self.trace is not None and recording():
            t = time.perf_counter()
            emit_complete("serving.request_done", t, 0.0, cat="serving",
                          args=self.trace.args(rid=self.rid, reason=reason,
                                               tokens=len(self.tokens)))
            emit_flow("f", self.trace.trace_id, t)

    # -- user side -----------------------------------------------------------
    @property
    def done(self) -> bool:
        return self.finish_reason is not None

    def cancel(self) -> None:
        """Drop this request at the scheduler's next tick."""
        self._cancelled = True

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block until generation stops; returns the generated ids (a
        deadline/cancel result is the partial sequence)."""
        with self._cv:
            if not self._cv.wait_for(lambda: self.finish_reason is not None,
                                     timeout):
                raise TimeoutError("generation still in progress")
        if self.error is not None:
            raise RuntimeError("generation failed") from self.error
        return list(self.tokens)

    def stream(self, timeout: Optional[float] = None):
        """Yield token ids as they are generated; returns when finished."""
        i = 0
        while True:
            with self._cv:
                if not self._cv.wait_for(
                        lambda: len(self.tokens) > i
                        or self.finish_reason is not None, timeout):
                    raise TimeoutError("generation still in progress")
                fresh = self.tokens[i:]
                finished = self.finish_reason is not None
            yield from fresh
            i += len(fresh)
            if finished and i >= len(self.tokens):
                if self.error is not None:
                    raise RuntimeError("generation failed") from self.error
                return

    def _need_tokenizer(self):
        if self._tokenizer is None:
            raise RuntimeError("engine has no tokenizer — pass "
                               "InferenceEngine(tokenizer=...)")
        return self._tokenizer

    def stream_text(self, timeout: Optional[float] = None):
        """Yield decoded text pieces as tokens arrive (the engine must
        have a tokenizer). Special ids are skipped; a token that ends
        mid-utf-8 is held until its sequence completes."""
        detok = self._need_tokenizer().stream_detokenizer()
        for tok in self.stream(timeout):
            piece = detok.push(tok)
            if piece:
                yield piece
        tail = detok.flush()
        if tail:
            yield tail

    def text(self, timeout: Optional[float] = None) -> str:
        """Block until generation stops; returns the decoded text."""
        return self._need_tokenizer().decode(self.result(timeout),
                                             skip_special=True)


class _HostCall:
    """One closure parked for the scheduler thread
    (:meth:`InferenceEngine.run_on_scheduler`): its result or error, and
    the event the calling thread waits on."""

    __slots__ = ("fn", "result", "error", "done")

    def __init__(self, fn):
        self.fn = fn
        self.result = None
        self.error: Optional[BaseException] = None
        self.done = threading.Event()

    def run(self, eng) -> None:
        try:
            self.result = self.fn(eng)
        except Exception as e:  # noqa: BLE001 — the caller's error, never
            self.error = e      # a scheduler crash
        self.done.set()

    def fail(self, err: BaseException) -> None:
        self.error = err
        self.done.set()


class _Slot:
    """Host-side state of one occupied cache slot."""

    __slots__ = ("req", "length", "last_token", "generated", "pending",
                 "resume_last", "admit_order")

    def __init__(self, req: GenerationRequest, length: int, last_token: int):
        self.req = req
        self.length = length          # tokens whose K/V are in the cache
        self.last_token = last_token  # input of the next decode step
        self.generated = 1            # prefill already streamed one token
        self.pending = None           # paged: prompt tokens not yet prefilled
        self.resume_last = None       # paged: last token of a preempted run
        self.admit_order = 0          # paged: preemption picks the youngest


def _dtype_name(dtype) -> str:
    """A torch dtype's numpy-style name (``"bfloat16"``, ``"float32"``),
    the reference payload's ``dtype`` string."""
    return str(dtype).replace("torch.", "")


def _host_tensor(x) -> torch.Tensor:
    """A streamed K/V payload as a tensor: tensors pass through, numpy
    arrays are wrapped (an ``ml_dtypes`` bfloat16 array by its bits)."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.array(x)                   # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _pin_flags(cfg):
    """Pin the flag-following MLP choices now, as the JAX engine does: a
    FLAGS_fused_kernels or FLAGS_fp8_matmul flip mid-serving would
    otherwise split one engine's calls between two MLPs."""
    if cfg.fused_mlp is None:
        cfg = dataclasses.replace(cfg, fused_mlp=bool(flags.fused_kernels[0]))
    if cfg.fp8 is None:
        cfg = dataclasses.replace(cfg, fp8=bool(flags.fp8_matmul[0]))
    return cfg


_MATMUL_LEAVES = ("qkv_w", "qkv_b", "proj_w", "proj_b", "fc_w", "fc_b",
                  "out_w", "out_b")
# the expert weights; the router weight stays f32 (routing upcasts it)
_EXPERT_LEAVES = ("w_in", "b_in", "w_out", "b_out")


def _serving_params(cfg, params, device):
    """Params on ``device`` with the leaves every call casts to the
    compute dtype (block matmul weights and biases, expert weights, wte,
    wpe) cast once here; LayerNorm leaves and the MoE router keep their
    dtype. The model functions' own casts are then no-ops, so the
    numbers are unchanged. An int8 weight (``{"q", "s"}``, see
    ``quantize_gpt_weights``) keeps ``q`` int8 and ``s`` f32."""
    cd = cfg.dtype

    def put(t, cast):
        if isinstance(t, dict):
            return {"q": torch.as_tensor(t["q"]).to(device, torch.int8),
                    "s": torch.as_tensor(t["s"]).to(device, torch.float32)}
        t = torch.as_tensor(t).to(device)
        return t.to(cd) if cast else t

    blocks = {k: put(v, k in _MATMUL_LEAVES)
              for k, v in params["blocks"].items()}
    out = {"wte": put(params["wte"], True), "wpe": put(params["wpe"], True),
           "blocks": blocks, "lnf_s": put(params["lnf_s"], False),
           "lnf_b": put(params["lnf_b"], False)}
    if "moe" in params:
        out["moe"] = {k: put(v, k in _EXPERT_LEAVES)
                      for k, v in params["moe"].items()}
    return out


class InferenceEngine:
    """Continuous-batching generation server for the functional GPT.

    ::

        eng = InferenceEngine(cfg, params, n_slots=8)
        req = eng.submit(prompt_ids, max_new_tokens=64, temperature=0.8)
        for tok in req.stream(): ...
        eng.shutdown()

    ``params`` is a gpt_init-layout dict (``models.gpt.gpt_init`` or
    ``models.gpt.params_from_jax``). ``device`` None runs on the card
    and raises ``RuntimeError`` when there is none; ``device="cpu"`` runs
    every kernel's plain PyTorch version.

    ``paged`` (None follows FLAGS_paged_kv) swaps the fixed-slot cache
    for the block pool: ``max_len`` is then ignored (the per-slot ceiling
    is ``cfg.seq_len``), ``block_size`` tokens per block, ``n_blocks``
    defaults to the worst case (every slot at seq_len; size it smaller to
    overcommit), prompts prefill ``prefill_chunk`` tokens per tick.
    Greedy output is token-identical to ``paged=False``.

    ``int8_weights=True`` quantizes the block matmul weights to int8 per
    channel (``models.gpt.quantize_gpt_weights``, from the caller's f32
    weights) for the decode tick only, which then runs the int8 matmul
    kernel; prefill keeps the fp weights. Decode tokens are close to the
    fp engine's but not pinned to them (weight rounding). It does not
    combine with MoE or a mesh (``ValueError``, as in JAX).

    A MoE config serves with dropless routing in both cache modes; its
    router load per decode tick goes to the ``moe_expert_load`` gauge
    and ``moe_tokens_dropped`` counter.

    ``draft=(draft_cfg, draft_params)`` enables speculative decoding:
    ``spec_k`` proposals per slot per tick from the draft, one target
    verify pass, rejection-sampling acceptance — greedy token-identical
    to ``draft=None``, sampled output keeps the target distribution. The
    draft shares the vocabulary and its positional table covers the
    engine's ``max_len`` (``models.gpt.gpt_truncate`` builds one from
    the target). Its proposals, verify and acceptance counts go to
    ``spec_proposed`` / ``spec_accepted`` / ``spec_acceptance_rate``.

    ``tokenizer`` (``serving.tokenizer.ByteTokenizer`` or the same
    encode/decode/stream_detokenizer surface) enables
    ``submit(text=...)`` and the request's ``stream_text()``.

    ``prefix_cache`` (None follows FLAGS_prefix_cache; paged mode only,
    not with ``draft`` or MoE) turns on radix-tree prefix sharing with
    copy-on-write of a partly used last block and LRU leaf reclaim ahead
    of preemption; its gauges are ``prefix_hit_rate`` (with
    ``prefix_matched_tokens`` / ``prefix_lookup_tokens``),
    ``prefix_cache_blocks``, ``prefix_evictions`` and
    ``prefix_cow_copies``. Greedy output stays token-identical to the
    cold cache.

    ``watchdog`` (True or a dict; default off, and off a tick launches
    and returns exactly what it did without it) arms the per-tick
    NaN/latency sentinel and the auto-restart (module docstring).
    Options: ``latency_budget_ms`` (None disables the latency rung) with
    ``latency_trips`` consecutive slow ticks per stall verdict, and
    ``max_restarts`` before the engine fails every open request.

    ``overload`` (a ``serving.overload.OverloadController``) steps the
    brownout ladder from this engine's queue waits and tick latencies;
    ``replica_id`` names the engine in spans and fault specs;
    ``flight_dir`` arms the process's flight recorder, dumped there on a
    scheduler abort or a watchdog restart; ``tps_window_ticks`` is the
    window of the ``serving_tokens_per_s`` gauge.
    """

    def __init__(self, cfg, params, n_slots: int = 4,
                 max_len: Optional[int] = None, queue_size: int = 64,
                 eos_id: Optional[int] = None, seed: int = 0,
                 int8_weights: bool = False, paged: Optional[bool] = None,
                 block_size: int = 16, n_blocks: Optional[int] = None,
                 prefill_chunk: int = 64, tps_window_ticks: int = 64,
                 draft=None, spec_k: int = 4, mesh=None, tokenizer=None,
                 prefix_cache: Optional[bool] = None, watchdog=None,
                 overload=None, replica_id: Optional[int] = None,
                 flight_dir: Optional[str] = None, device=None):
        if watchdog:
            defaults = {"latency_budget_ms": None, "latency_trips": 3,
                        "max_restarts": 3}
            if watchdog is not True:
                unknown = set(dict(watchdog)) - set(defaults)
                if unknown:
                    raise ValueError(f"unknown watchdog option(s) "
                                     f"{sorted(unknown)}")
                defaults.update(dict(watchdog))
            self._watchdog = defaults
        else:
            self._watchdog = None
        self._restarts = 0
        self._slow_ticks = 0
        if mesh is not None:
            if int8_weights:
                raise ValueError("int8_weights and mesh are not yet "
                                 "combinable (no spec table for the "
                                 "quantized pytree)")
            raise NotImplementedError("the serving mesh is not ported to "
                                      "paddle_tpu_torch yet (see "
                                      "ROADMAP.md)")
        if int8_weights and cfg.moe_experts > 0:
            raise ValueError("int8_weights and MoE are not combinable (no "
                             "quantized layout for the expert pytree)")
        if draft is not None and cfg.moe_experts > 0:
            raise ValueError("draft= and MoE are not combinable: "
                             "speculative verify has no routed-expert "
                             "path (gpt_verify_step rejects MoE)")
        self.device = resolve_device(device)
        cfg = _pin_flags(cfg)
        self._moe = bool(cfg.moe_layer_ids)
        if self._moe:
            # no mesh: the single-device dispatch (as the JAX engine)
            cfg = dataclasses.replace(cfg, moe_axis=None)
        _check_ported(cfg)
        self.cfg = cfg
        self._params = _serving_params(cfg, params, self.device)
        self.int8_weights = bool(int8_weights)
        if self.int8_weights:
            # quantized once from the caller's weights, on the device;
            # only the decode tick reads this tree
            dev_blocks = {k: torch.as_tensor(v).to(self.device)
                          for k, v in params["blocks"].items()}
            self._decode_params = _serving_params(
                cfg, quantize_gpt_weights({**params, "blocks": dev_blocks}),
                self.device)
            del dev_blocks
        else:
            self._decode_params = self._params
        self.paged = flags.paged_kv[0] if paged is None else bool(paged)
        if self.paged:
            self.cache = PagedKVCache(cfg, n_slots, n_blocks=n_blocks,
                                      block_size=block_size,
                                      device=self.device)
            self.block_size = self.cache.block_size
            self.max_len = cfg.seq_len   # positional table = per-slot cap
            if prefill_chunk % self.block_size != 0:
                raise ValueError(
                    f"prefill_chunk={prefill_chunk} must be a multiple of "
                    f"block_size={self.block_size} (as in the JAX engine)")
            self.prefill_chunk = int(prefill_chunk)
        else:
            self.cache = KVCache(cfg, n_slots, max_len, device=self.device)
            self.max_len = self.cache.max_len
            self.prefill_chunk = None
        self.n_slots = self.cache.n_slots
        use_prefix = flags.prefix_cache[0] if prefix_cache is None \
            else bool(prefix_cache)
        if use_prefix and not self.paged:
            raise ValueError("prefix_cache requires the paged KV cache "
                             "(FLAGS_paged_kv=1 or paged=True) — sharing "
                             "needs block-table indirection")
        if use_prefix and draft is not None:
            raise ValueError("prefix_cache and draft= are not combinable: "
                             "the draft's fixed cache holds no K/V for a "
                             "skipped prefix, so every hit would force a "
                             "full draft prefill")
        if use_prefix and self._moe:
            raise ValueError("prefix_cache and MoE are not combinable "
                             "(as in the JAX engine, whose prefix tail "
                             "verifies through a step with no "
                             "routed-expert path)")
        self._prefix = RadixPrefixCache(self.cache) if use_prefix else None
        self._init_draft(draft, spec_k, params)
        self.tokenizer = tokenizer
        self.eos_id = eos_id
        self.seed = int(seed)
        self._queue: collections.deque = collections.deque()
        self._queue_size = int(queue_size)
        self._cv = threading.Condition()
        self._slots: List[Optional[_Slot]] = [None] * self.n_slots
        self._stop = False
        self._drain = True
        self._error: Optional[BaseException] = None
        self._rid = 0            # next request id (per-request RNG stream)
        self._warm_seq = 0       # warm_prefix sequence (its own rid space)
        self._ticks = 0          # scheduler loop iterations that did work
        self._admit_seq = 0
        self._spec_prop = 0      # lifetime draft proposals / acceptances
        self._spec_acc = 0       # behind the acceptance-rate gauge
        # float running totals behind the int ms gauges
        self._prefill_ms = 0.0
        self._decode_ms = 0.0
        # tokens/s over the last N tick completions
        self._window: collections.deque = collections.deque(
            maxlen=max(2, int(tps_window_ticks)))
        self.overload = overload
        self.replica_id = replica_id
        self.failover = None     # a router's adoption hook, stamped on
        #                          each request at submit
        self._evacuate = False   # the scheduler raises ReplicaEvacuated
        #                          at its next loop check
        self._die_tick = None    # fail_at_tick's target tick
        self.flight_dir = flight_dir
        if flight_dir:
            arm_flight_recorder(flight_dir)
        self._last_tick_t = time.monotonic()
        # closures other threads park for the scheduler to run between
        # ticks (run_on_scheduler; guarded by self._cv)
        self._host_calls: collections.deque = collections.deque()
        self._thread = threading.Thread(target=self._run,
                                        name="serving-scheduler", daemon=True)
        self._thread.start()

    # -- speculative-decoding setup ------------------------------------------
    def _init_draft(self, draft, spec_k: int, params) -> None:
        if draft is None:
            self.draft_cfg = None
            self.draft_cache = None
            self.spec_k = 0
            return
        draft_cfg, draft_params = draft
        if int(spec_k) < 1:
            raise ValueError(f"spec_k={spec_k} must be >= 1")
        if draft_cfg.vocab_size != self.cfg.vocab_size:
            raise ValueError(
                f"draft vocab {draft_cfg.vocab_size} != target vocab "
                f"{self.cfg.vocab_size} (the acceptance rule compares "
                "distributions over one vocabulary)")
        # paged chunks are block-padded, so the draft cache (and its
        # positional table) must cover max_len rounded up to a block
        draft_len = self.max_len if not self.paged else \
            -(-self.max_len // self.block_size) * self.block_size
        if draft_cfg.seq_len < draft_len:
            raise ValueError(
                f"draft seq_len {draft_cfg.seq_len} < engine cache span "
                f"{draft_len} — the draft must reach every position the "
                "target can")
        self.draft_cfg = _pin_flags(draft_cfg)
        _check_ported(self.draft_cfg)
        dparams = _serving_params(self.draft_cfg, draft_params, self.device)
        for k in ("wte", "wpe", "lnf_s", "lnf_b"):
            # a gpt_truncate draft shares these tensors with the target:
            # share their serving copies too
            if draft_params[k] is params[k]:
                dparams[k] = self._params[k]
        self._draft_params = dparams
        self.spec_k = int(spec_k)
        # the draft decodes against its own fixed-slot cache: k short
        # steps over a small model need no paging
        self.draft_cache = KVCache(self.draft_cfg, self.n_slots,
                                   max_len=draft_len, device=self.device)

    # -- public API ----------------------------------------------------------
    def submit(self, prompt: Optional[Sequence[int]] = None,
               max_new_tokens: int = 32,
               temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
               eos_id: Optional[int] = None,
               deadline_s: Optional[float] = None, block: bool = True,
               timeout: Optional[float] = None, text: Optional[str] = None,
               constraint=None, trace=None) -> GenerationRequest:
        """Queue a generation request; returns its streaming handle.

        Exactly one of ``prompt`` (token ids) and ``text`` is given;
        ``text`` needs the engine's tokenizer, encodes through it and
        defaults ``eos_id`` to the tokenizer's. When the bounded queue is
        full, ``block=True`` waits (up to ``timeout`` seconds) for space
        and raises :class:`QueueFull` on timeout; ``block=False`` raises
        at once. ``deadline_s`` is a wall-clock budget from now: a
        request over budget is evicted with ``finish_reason="deadline"``
        wherever it is. ``constraint`` (``serving.constrained.
        TokenConstraint``) masks every sampled token through its
        automaton; the stream finishes with ``finish_reason="stop"``
        when the match completes. ``trace`` (``monitor.TraceContext``)
        is the request's causal tracing identity, stamped onto every span
        it touches; it never changes a token."""
        if text is not None:
            if prompt is not None:
                raise ValueError("pass prompt OR text, not both")
            if self.tokenizer is None:
                raise ValueError("submit(text=...) needs an engine "
                                 "tokenizer: InferenceEngine(tokenizer=...)")
            prompt = self.tokenizer.encode(text)
            if eos_id is None and self.eos_id is None:
                eos_id = self.tokenizer.eos_id
        if prompt is None:
            raise ValueError("provide a prompt (token ids) or text")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must hold at least one token")
        if prompt.size >= self.max_len:
            raise ValueError(
                f"prompt length {prompt.size} leaves no room to generate "
                + (f"(positional table seq_len={self.max_len})" if self.paged
                   else f"(cache max_len={self.max_len})"))
        if self.paged and self.cache.blocks_for(prompt.size + 1) \
                > self.cache.max_slot_blocks:
            raise ValueError(
                f"prompt length {prompt.size} can never fit the block pool "
                f"({self.cache.max_slot_blocks} blocks x {self.block_size} "
                "tokens)")
        cursor = None
        if constraint is not None:
            if getattr(constraint, "vocab_size", self.cfg.vocab_size) \
                    > self.cfg.vocab_size:
                raise ValueError(
                    f"constraint vocab {constraint.vocab_size} exceeds the "
                    f"model vocab {self.cfg.vocab_size}")
            cursor = constraint.cursor() if hasattr(constraint, "cursor") \
                else constraint
            CONSTRAINED_REQUESTS.add(1)
        req = GenerationRequest(
            prompt, max_new_tokens, temperature, top_k, top_p,
            self.eos_id if eos_id is None else eos_id,
            None if deadline_s is None else time.monotonic() + deadline_s,
            constraint=cursor)
        req.trace = trace
        req._tokenizer = self.tokenizer
        with self._cv:
            self._check_open()
            if len(self._queue) >= self._queue_size:
                if not block:
                    raise QueueFull(
                        f"serving queue at capacity ({self._queue_size})")
                ok = self._cv.wait_for(
                    lambda: self._stop
                    or len(self._queue) < self._queue_size, timeout)
                if not ok:
                    raise QueueFull(
                        f"serving queue still full after {timeout}s")
                self._check_open()
            # the request id is the RNG stream identity: assigned in
            # submission order, so a sampled stream is a pure function of
            # (seed, rid) — batch neighbours cannot perturb it
            req.rid = self._rid
            self._rid += 1
            req._failover = self.failover
            req._t_submit = time.monotonic()
            self._queue.append(req)
            SERVING_QUEUE_DEPTH.set(len(self._queue))
            self._cv.notify_all()
        return req

    def generate(self, prompt: Optional[Sequence[int]] = None,
                 **kw) -> List[int]:
        """Blocking convenience wrapper: submit + result."""
        return self.submit(prompt, **kw).result()

    def warm_prefix(self, prompt) -> GenerationRequest:
        """Queue a prefill-only request: the prompt is prefilled (and, with
        the prefix cache, inserted into the radix tree) and one token is
        generated, for the caller to discard. Its request id comes from a
        space above ``2**30``, so warming neither collides with nor
        shifts the numbering of live request ids (their sampled streams
        stay functions of (seed, rid))."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1 or prompt.size >= self.max_len:
            raise ValueError(f"warm prefix length {prompt.size} outside "
                             f"(0, {self.max_len})")
        req = GenerationRequest(prompt, 1, 0.0, 0, 1.0, None, None)
        req._tokenizer = self.tokenizer
        with self._cv:
            self._check_open()
            req.rid = _WARM_RID_BASE + self._warm_seq
            self._warm_seq += 1
            req._t_submit = time.monotonic()
            self._queue.append(req)     # warming runs before traffic: the
            SERVING_QUEUE_DEPTH.set(len(self._queue))   # bound is moot
            self._cv.notify_all()
        return req

    def adopt_request(self, req: GenerationRequest) -> None:
        """Failover entry: enqueue a request ANOTHER engine was serving
        when it died. The preemption-resume contract rebuilds decode
        state from ``prompt + generated[:-1]`` with the last token
        restored, and the request keeps its id: with engines sharing a
        seed the continuation is token-identical to the run the dead
        engine would have given. Bypasses the queue bound (failover must
        not drop work a caller already holds a handle to)."""
        if req.trace is not None:
            # the causal timeline continues here: record the hop
            prev = getattr(req, "_replica", None)
            req.trace.hop(prev, self.replica_id)
            if recording():
                t = time.perf_counter()
                emit_complete(
                    "serving.failover_hop", t, 0.0, cat="serving",
                    args=req.trace.args(rid=req.rid, hop_from=prev,
                                        hop_to=self.replica_id))
                emit_flow("t", req.trace.trace_id, t)
        with self._cv:
            self._check_open()
            req._resume = self._resume_record(req)
            req._failover = self.failover
            req._t_submit = time.monotonic()
            # keep later ids clear of the adopted one: a collision would
            # alias two requests onto one RNG stream
            self._rid = max(self._rid, req.rid + 1)
            self._queue.append(req)
            SERVING_QUEUE_DEPTH.set(len(self._queue))
            self._cv.notify_all()

    def evacuate(self) -> None:
        """Ask the scheduler to stop by FAILING every open stream with
        :class:`ReplicaEvacuated`: through the ``failover`` hook each one
        is adopted by another engine and replayed token-identically.
        Callers must already have stopped sending work here."""
        with self._cv:
            self._evacuate = True
            self._cv.notify_all()

    def fail_at_tick(self, ticks_ahead: int = 1) -> None:
        """Make the scheduler raise ``InjectedCrash`` ``ticks_ahead`` busy
        ticks from now: a deterministic crash, real in every observable
        way (failover, flight dump, closed engine)."""
        with self._cv:
            self._die_tick = self._ticks + max(1, int(ticks_ahead))
            self._cv.notify_all()

    def run_on_scheduler(self, fn, timeout: Optional[float] = None):
        """Run ``fn(engine)`` on the scheduler thread, between ticks, and
        return its result (re-raising its exception): the only safe way
        for another thread to touch the pool buffers or the radix tree,
        since between ticks no model call is in flight and the refcounts
        are consistent. Called from the scheduler thread itself, it runs
        inline."""
        if threading.current_thread() is self._thread:
            return fn(self)
        call = _HostCall(fn)
        with self._cv:
            self._check_open()
            self._host_calls.append(call)
            self._cv.notify_all()
        if not call.done.wait(timeout):
            raise TimeoutError("scheduler did not service the host call "
                               f"within {timeout}s")
        if call.error is not None:
            raise call.error
        return call.result

    # -- KV-block streaming --------------------------------------------------
    def _blocks_payload(self, blocks):
        """Pool rows ``blocks`` of K and V as CPU tensors (copies, safe to
        ship): (n_blocks, layers, heads, block_size, head_dim). numpy has
        no bf16 without ml_dtypes, so the payload carries torch tensors;
        its ``dtype`` string is the reference's name."""
        idx = torch.as_tensor(blocks, dtype=torch.long, device=self.device)
        kb = self.cache.kb.index_select(0, idx).cpu()
        vb = self.cache.vb.index_select(0, idx).cpu()
        return kb, vb

    def _write_blocks(self, blocks, kb, vb) -> None:
        """Write streamed K/V rows into pool ``blocks``, in place."""
        idx = torch.as_tensor(blocks, dtype=torch.long, device=self.device)
        for buf, rows in ((self.cache.kb, kb), (self.cache.vb, vb)):
            buf.index_copy_(0, idx, rows.to(self.device, buf.dtype))

    def export_kv_prefix(self, tokens, timeout: Optional[float] = None):
        """Serialize the cached KV blocks covering ``tokens`` (the
        prefill side of disaggregated serving): the radix tree's longest
        cached prefix (capped at len-1, as every splice), gathered to
        host memory on the scheduler thread. Returns None when nothing is
        cached, else a dict with ``matched_len``, ``block_size``,
        ``dtype`` (``"bfloat16"``, ``"float32"``), ``shape`` and CPU
        tensors ``kb``/``vb`` of shape (n_blocks, layers, heads,
        block_size, head_dim)."""
        if self._prefix is None:
            raise RuntimeError("export_kv_prefix needs prefix_cache=True")
        toks = np.asarray(tokens, np.int32).reshape(-1)

        def _export(eng):
            m_len, blocks = eng._prefix.match(toks)
            if m_len <= 0 or not blocks:
                return None
            kb, vb = eng._blocks_payload(blocks)
            return {"matched_len": int(m_len),
                    "block_size": int(eng.block_size),
                    "dtype": _dtype_name(kb.dtype), "shape": list(kb.shape),
                    "kb": kb, "vb": vb}

        return self.run_on_scheduler(_export, timeout=timeout)

    def _alloc_import(self, n: int):
        """``n`` fresh pool blocks for an import, reclaiming LRU tree
        leaves for a shortfall; None (nothing taken) when the pool has no
        room."""
        if self.cache.free_blocks_count + self._prefix.evictable_count() < n:
            return None
        short = n - self.cache.free_blocks_count
        if short > 0 and self._prefix.evict(short) < short:
            return None
        blocks = []
        for _ in range(n):
            b = self.cache.alloc_block()
            if b is None:
                for bb in blocks:
                    self.cache.unref_block(bb)
                return None
            blocks.append(b)
        return blocks

    def import_kv_prefix(self, tokens, kb, vb, matched_len: int,
                         timeout: Optional[float] = None) -> int:
        """Splice streamed KV blocks (an :meth:`export_kv_prefix`
        payload; ``kb``/``vb`` tensors or numpy arrays) into this
        engine's pool and radix tree — the decode side of disaggregated
        serving. Returns the number of prefix tokens now cached (0 when
        the pool has no room); a later ``submit`` of the prompt splices
        them exactly like a local prefix hit."""
        if self._prefix is None:
            raise RuntimeError("import_kv_prefix needs prefix_cache=True")
        toks = np.asarray(tokens, np.int32).reshape(-1)[:int(matched_len)]
        kb, vb = _host_tensor(kb), _host_tensor(vb)
        n = int(kb.shape[0])
        if toks.size <= 0 or n == 0:
            return 0
        if n != self.cache.blocks_for(toks.size) \
                or tuple(kb.shape) != tuple(vb.shape):
            raise ValueError(
                f"import_kv_prefix: {n} streamed blocks do not cover "
                f"{toks.size} tokens at block_size {self.block_size}")
        self._check_block_shape(kb)

        def _import(eng):
            have = eng._prefix.peek(toks)
            if have >= toks.size:        # already warm: keep the local copy
                return int(have)
            blocks = eng._alloc_import(n)
            if blocks is None:
                return 0
            eng._write_blocks(blocks, kb, vb)
            eng._prefix.insert(toks, blocks)
            # insert() took a tree reference on each chunk it adopted:
            # drop the allocation's, so the tree is the sole owner and
            # duplicates of chunks it already held free at once
            for b in blocks:
                eng.cache.unref_block(b)
            eng.cache.update_gauges()
            return int(eng._prefix.peek(toks))

        return self.run_on_scheduler(_import, timeout=timeout)

    def export_kv_range(self, tokens, start_block: int,
                        max_blocks: Optional[int] = None,
                        timeout: Optional[float] = None):
        """Incremental slice of :meth:`export_kv_prefix` for resumable
        chunked streaming: the cached blocks from ``start_block`` on, so
        finished prefill chunks ship while the next chunk computes. While
        the prompt is still prefilling only FULL blocks go (a partial
        tail block is rewritten by the next chunk); once the whole
        prefix is cached (``done``) the partial tail block goes too.
        Returns ``matched_len``, ``start_block``, ``n_blocks``,
        ``block_size``, ``done``, ``covered_tokens`` and, when
        ``n_blocks`` > 0, CPU tensors ``kb``/``vb``."""
        if self._prefix is None:
            raise RuntimeError("export_kv_range needs prefix_cache=True")
        toks = np.asarray(tokens, np.int32).reshape(-1)
        start = int(start_block)

        def _export(eng):
            m_len, blocks = eng._prefix.match(toks)
            bs = int(eng.block_size)
            # match() caps at len-1, so "whole prefix cached" is
            # m_len >= size-1, the terminal every splice uses
            done = m_len >= toks.size - 1
            avail = len(blocks) if done else m_len // bs
            if not done:
                # a slot still prefilling this prompt is not in the tree
                # yet: ship its finished full blocks (never rewritten
                # once filled; this runs between ticks)
                for slot in range(eng.n_slots):
                    st = eng._slots[slot]
                    if st is None:
                        continue
                    pr = st.req.prompt
                    n_full = min(int(st.length), toks.size) // bs
                    if (n_full > avail and pr.size >= toks.size
                            and np.array_equal(pr[:toks.size], toks)):
                        tbl = eng.cache.block_tables[slot]
                        blocks = [int(b) for b in tbl[:n_full]]
                        avail, m_len = n_full, n_full * bs
            lo = min(start, avail)
            hi = avail if max_blocks is None \
                else min(avail, lo + int(max_blocks))
            out = {"matched_len": int(m_len), "start_block": int(lo),
                   "n_blocks": int(hi - lo), "block_size": bs,
                   "done": bool(done),
                   # prefix tokens covered by blocks [0, hi): the
                   # n_tokens a receiver passes to import_kv_chunk
                   "covered_tokens": int(min(m_len, hi * bs))}
            if hi > lo:
                out["kb"], out["vb"] = eng._blocks_payload(blocks[lo:hi])
            return out

        return self.run_on_scheduler(_export, timeout=timeout)

    def import_kv_chunk(self, tokens, kb, vb, start_block: int,
                        n_tokens: int,
                        timeout: Optional[float] = None) -> int:
        """Splice ONE streamed chunk (an :meth:`export_kv_range` slice)
        into the pool and radix tree, extending a prefix whose earlier
        blocks came in previous chunks. Returns the number of prefix
        tokens now cached, the ack the sender resumes from: a chunk past
        what this engine holds (a gap) is dropped and the current mark
        returned, so a lost chunk rewinds the stream; re-delivery is
        idempotent."""
        if self._prefix is None:
            raise RuntimeError("import_kv_chunk needs prefix_cache=True")
        n_tok = int(n_tokens)
        toks = np.asarray(tokens, np.int32).reshape(-1)[:n_tok]
        kb, vb = _host_tensor(kb), _host_tensor(vb)
        n = int(kb.shape[0])
        start = int(start_block)
        if toks.size != n_tok or n_tok <= 0:
            raise ValueError(f"import_kv_chunk: prompt carries {toks.size} "
                             f"tokens, chunk claims {n_tok}")
        if n == 0 or tuple(kb.shape) != tuple(vb.shape) \
                or start + n != self.cache.blocks_for(n_tok):
            raise ValueError(
                f"import_kv_chunk: {n} blocks at {start} do not land on "
                f"{n_tok} tokens at block_size {self.block_size}")
        self._check_block_shape(kb)

        def _import(eng):
            bs = int(eng.block_size)
            have = eng._prefix.peek(toks)
            if have >= n_tok:
                return int(have)           # idempotent re-delivery
            if have < start * bs:
                return int(have)           # gap: the sender must rewind
            _, ex_blocks = eng._prefix.match(toks)
            blocks = eng._alloc_import(n)
            if blocks is None:
                return int(have)
            eng._write_blocks(blocks, kb, vb)
            # the first ``start`` blocks are the tree's own nodes from
            # earlier chunks: insert() dedupes them and adopts the tail
            eng._prefix.insert(toks, list(ex_blocks[:start]) + blocks)
            for b in blocks:
                eng.cache.unref_block(b)
            eng.cache.update_gauges()
            return int(eng._prefix.peek(toks))

        return self.run_on_scheduler(_import, timeout=timeout)

    def _check_block_shape(self, kb) -> None:
        want = tuple(self.cache.kb.shape[1:])
        if tuple(kb.shape[1:]) != want:
            raise ValueError(f"streamed blocks of shape {tuple(kb.shape)} "
                             f"do not fit this pool's blocks {want}")

    # -- health surface ------------------------------------------------------
    @property
    def alive(self) -> bool:
        """Scheduler running and able to make progress."""
        return self._thread.is_alive() and not self._stop \
            and self._error is None

    @property
    def busy(self) -> bool:
        return bool(self._queue) or any(s is not None for s in self._slots)

    def tick_age(self) -> float:
        """Seconds since the scheduler last began a loop iteration (fresh
        when idle too: the idle wait beats every 50 ms)."""
        with self._cv:
            return time.monotonic() - self._last_tick_t

    def pool_headroom(self) -> float:
        """Free fraction of the KV capacity (blocks when paged, slots
        otherwise)."""
        if self.paged:
            total = self.cache.n_blocks - 1
            return self.cache.free_blocks_count / max(1, total)
        return self.cache.free_count / max(1, self.n_slots)

    def cancel(self, req: GenerationRequest) -> None:
        """Drop ``req`` at the scheduler's next tick (queued or live)."""
        req.cancel()

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        """Stop the scheduler. ``drain=True`` finishes every submitted
        request first; ``drain=False`` evicts them with
        ``finish_reason="shutdown"``."""
        with self._cv:
            self._stop = True
            self._drain = drain
            self._cv.notify_all()
        self._thread.join(timeout)

    @property
    def occupancy(self) -> int:
        return self.cache.occupancy

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    # -- scheduler -----------------------------------------------------------
    def _run(self) -> None:
        try:
            with torch.inference_mode():
                if self.device.type == "cuda":
                    torch.cuda.set_device(self.device)
                while True:
                    with self._cv:
                        self._last_tick_t = time.monotonic()
                        if self._evacuate:
                            # raised here, on the scheduler thread, never
                            # racing a live tick: every open stream fails
                            # with the adoption-triggering cause
                            raise ReplicaEvacuated(
                                f"replica {self.replica_id} evacuated")
                        busy = bool(self._queue) or any(
                            s is not None for s in self._slots)
                        if self._stop and (not self._drain or not busy):
                            break
                        # run_on_scheduler closures: popped under the
                        # lock, run outside it, between ticks
                        calls = list(self._host_calls)
                        self._host_calls.clear()
                        if not busy and not calls:
                            self._cv.wait(0.05)
                            continue
                        die = self._die_tick
                    for c in calls:
                        c.run(self)
                    if not busy:
                        continue
                    self._ticks += 1
                    if die is not None and self._ticks >= die:
                        raise _faults.InjectedCrash(
                            f"injected crash (replica {self.replica_id}, "
                            f"tick {self._ticks})")
                    if _faults.ENABLED[0]:
                        self._tick_faults()
                    self._admit()
                    if self.paged:
                        self._prefill_chunk_tick()
                    if any(s is not None for s in self._slots):
                        self._decode_tick()
        except BaseException as e:  # noqa: BLE001 — fail every request
            self._abort(e)
        finally:
            with self._cv:
                self._stop = True
                leftovers = list(self._queue)
                self._queue.clear()
                stranded = list(self._host_calls)
                self._host_calls.clear()
                SERVING_QUEUE_DEPTH.set(0)
                self._cv.notify_all()
            for c in stranded:
                c.fail(RuntimeError(
                    "engine shut down before the host call ran"))
            for req in leftovers:
                req._finish(SHUTDOWN)
            for s, st in enumerate(self._slots):
                if st is not None:
                    self._evict(s, SHUTDOWN)

    def _tick_faults(self) -> None:
        """The tick-keyed serving faults (``FLAGS_fault_inject``):
        ``slow_tick`` stalls the scheduler between ticks (queue waits,
        which the brownout EWMA reads, and ``tick_age`` see it; a tick's
        own time does not), ``replica_crash`` kills it."""
        f = _faults.FAULTS.take_tick("slow_tick", self.replica_id,
                                     self._ticks)
        if f is not None:
            FAULTS_INJECTED.add()
            time.sleep(f.secs)
        f = _faults.FAULTS.take_tick("replica_crash", self.replica_id,
                                     self._ticks)
        if f is not None:
            FAULTS_INJECTED.add()
            raise _faults.InjectedCrash(
                f"injected replica crash (replica {self.replica_id}, "
                f"tick {self._ticks})")

    def _check_open(self) -> None:
        if not self._stop:
            return
        if self._error is not None:
            raise RuntimeError(
                f"InferenceEngine scheduler crashed: "
                f"{type(self._error).__name__}: {self._error}") \
                from self._error
        raise RuntimeError("InferenceEngine is shut down")

    def _abort(self, err: BaseException) -> None:
        # the flight recorder's dump at the moment of death (no-op when
        # none is armed; never raises)
        dump_flight(f"engine_abort_{type(err).__name__}",
                    extra={"replica": self.replica_id,
                           "error": f"{type(err).__name__}: {err}"})
        with self._cv:
            # close the engine BEFORE failing requests so a racing
            # submit() cannot slip into the dead queue
            self._error = err
            self._stop = True
            leftovers = list(self._queue)
            self._queue.clear()
            self._cv.notify_all()
        for s, st in enumerate(self._slots):
            if st is not None:
                # cleared FIRST: a failover hook may leave the request
                # unfinished (adopted), and the finally block must not
                # finish it as shutdown
                self._slots[s] = None
                st.req._finish(ERROR, err)
        for req in leftovers:
            req._finish(ERROR, err)

    def _shed_expired(self) -> None:
        """Cancelled or deadline-expired requests leave the queue at the
        next tick, before any prefill is spent on them."""
        now = time.monotonic()
        shed: List[GenerationRequest] = []
        with self._cv:
            keep: collections.deque = collections.deque()
            for req in self._queue:
                if req._cancelled or (req.deadline is not None
                                      and now > req.deadline):
                    shed.append(req)
                else:
                    keep.append(req)
            if not shed:
                return
            self._queue = keep
            SERVING_QUEUE_DEPTH.set(len(self._queue))
            self._cv.notify_all()   # wake submitters blocked on full
        for req in shed:
            if req._cancelled:
                req._finish(CANCELLED)
            else:
                SERVING_DEADLINE_SHEDS.add(1)
                req._finish(DEADLINE)

    def _admit(self) -> None:
        """Move queued requests into free slots. Fixed mode: prefill on
        the spot. Paged mode: admit the head of the queue only when the
        pool has blocks for its prompt (+1 token) — with the prefix cache
        for its uncached tail, reclaimable tree leaves counting — else it
        waits there for evictions; the (tail of the) prompt is parked on
        the slot for the chunked-prefill tick."""
        self._shed_expired()
        while self.cache.free_count > 0:
            with self._cv:
                if not self._queue:
                    break
                if self.paged:
                    head = self._queue[0]
                    seq = head._resume[0] if head._resume is not None \
                        else head.prompt
                    place = self._admit_place(seq)
                    if place is None:
                        break   # head-of-line waits for blocks to free up
                req = self._queue.popleft()
                SERVING_QUEUE_DEPTH.set(len(self._queue))
                self._cv.notify_all()
            if req._t_submit:
                wait_ms = (time.monotonic() - req._t_submit) * 1e3
                SERVING_QUEUE_WAIT_MS.observe(wait_ms)
                if self.overload is not None:
                    self.overload.observe_queue_wait(wait_ms)
            slot = self.cache.alloc()
            if self.paged:
                st = _Slot(req, length=0, last_token=-1)
                st.generated = len(req.tokens)   # nonzero on resume
                self._admit_seq += 1
                st.admit_order = self._admit_seq
                if req._resume is not None:
                    seq, st.resume_last = req._resume
                    req._resume = None
                else:
                    seq = req.prompt
                m_len, m_blocks = place
                if self._prefix is not None:
                    m_len = self._splice_prefix(slot, m_len, m_blocks)
                    self._prefix.note_lookup(m_len, seq.size)
                st.length = m_len
                self.cache.lengths[slot] = m_len
                st.pending = seq[m_len:]
                self._slots[slot] = st
                continue
            try:
                self._prefill(req, slot)
            except BaseException as e:  # noqa: BLE001
                # in neither the queue nor a slot: fail it here, then let
                # the scheduler unwind
                if self._slots[slot] is None:
                    self.cache.release(slot)
                req._finish(ERROR, e)
                raise
        SERVING_SLOT_OCCUPANCY.set(self.cache.occupancy)

    def _admit_place(self, seq):
        """``(matched_len, matched_blocks)`` for the head request, or None
        to queue until blocks free up. With the prefix cache the pool
        only needs blocks for the UNCACHED tail (+1 when the last matched
        block is partly used and must be copied), and LRU tree leaves
        count toward capacity: the shortfall is reclaimed here, then the
        prompt re-matched (the eviction may have clipped its own path)."""
        need_total = int(seq.size) + 1
        if self._prefix is None:
            return (0, []) if self.cache.can_admit(need_total) else None

        def need(m_len, m_blocks):
            return self.cache.blocks_for(need_total) - len(m_blocks) \
                + (1 if m_len % self.block_size else 0)

        m_len, m_blocks = self._prefix.match(seq)
        if need(m_len, m_blocks) > self.cache.free_blocks_count \
                + self._prefix.evictable_count():
            return None
        short = need(m_len, m_blocks) - self.cache.free_blocks_count
        if short > 0:
            self._prefix.evict(short)
            m_len, m_blocks = self._prefix.match(seq)
            if need(m_len, m_blocks) > self.cache.free_blocks_count:
                return None
        return m_len, m_blocks

    def _splice_prefix(self, slot: int, m_len: int, m_blocks) -> int:
        """Wire a radix match into a fresh slot's table: one reference
        per matched block, and a copy of the last block when the match
        ends mid-block (the slot will write offsets the tree's readers
        must never see change). Returns the matched length kept (cut to
        the block boundary when no block is free for the copy)."""
        if m_len == 0:
            return 0
        self.cache.splice(slot, m_blocks)
        if m_len % self.block_size == 0:
            return m_len
        nb = self.cache.alloc_block()
        if nb is None:
            # no block for the copy: drop the partial block from the
            # match instead (its full-block prefix is still shared)
            self.cache.block_tables[slot].pop()
            self.cache.unref_block(m_blocks[-1])
            return (m_len // self.block_size) * self.block_size
        src = int(m_blocks[-1])
        # one block's rows across all layers, in place in the pool
        self.cache.kb[nb].copy_(self.cache.kb[src])
        self.cache.vb[nb].copy_(self.cache.vb[src])
        self.cache.replace_block(slot, len(m_blocks) - 1, nb)
        PREFIX_COW_COPIES.add(1)
        return m_len

    def _reclaim_blocks(self, slot: int, n_tokens: int) -> bool:
        """Try to make ``grow(slot, n_tokens)`` succeed by evicting LRU
        prefix-tree leaves — the step that runs BEFORE youngest-first
        preemption."""
        if self._prefix is None:
            return False
        missing = self.cache.blocks_for(n_tokens) \
            - len(self.cache.block_tables[slot]) \
            - self.cache.free_blocks_count
        if missing <= 0:
            return True
        return self._prefix.evict(missing) >= missing

    def _bucket(self, n: int) -> int:
        b = 16
        while b < n:
            b *= 2
        return min(b, self.max_len)

    def _width_bucket(self, n_blocks: int) -> int:
        b = 1
        while b < n_blocks:
            b *= 2
        return min(b, self.cache.table_width)

    def _mask_row(self, req: GenerationRequest) -> Optional[np.ndarray]:
        """(V,) bool sampling mask of a request's next token: None when
        unconstrained, else the automaton's live-token set padded to the
        model vocab."""
        if req.constraint is None:
            return None
        m = req.constraint.mask()
        if m.shape[0] == self.cfg.vocab_size:
            return m
        out = np.zeros(self.cfg.vocab_size, bool)
        out[:m.shape[0]] = m
        return out

    def _sample_one(self, logits_row, req: GenerationRequest, draw: int):
        m = self._mask_row(req)
        mask = None if m is None else torch.tensor(
            m[None], device=logits_row.device)
        return int(sample_tokens_streams(
            logits_row, [req.temperature], [req.top_k], [req.top_p],
            self.seed, [req.rid], [draw], mask=mask)[0])

    def _prefill(self, req: GenerationRequest, slot: int) -> None:
        # a resume record (a watchdog restart or an adoption) re-prefills
        # prompt + generated[:-1] and rebuilds decode state without
        # emitting: the paged preemption-resume contract on fixed slots
        resume = req._resume
        req._resume = None
        seq = resume[0] if resume is not None else req.prompt
        S = int(seq.size)
        if resume is not None and S + 1 > self.max_len:
            self.cache.release(slot)
            req._finish(LENGTH)
            return
        t0 = time.perf_counter()
        pf_args = {"slot": slot, "prompt_len": S}
        flow = None
        if req.trace is not None and recording():
            pf_args.update(req.trace.args(rid=req.rid))
            flow = req.trace.trace_id
        tok = None
        with span("serving.prefill", cat="serving", args=pf_args,
                  flow=flow):
            # end-padded to a power-of-two bucket: causality keeps
            # positions < S exact, and the cache rows past S are
            # overwritten by decode before they are ever attended
            toks = np.zeros((1, self._bucket(S)), np.int64)
            toks[0, :S] = seq
            toks = torch.from_numpy(toks).to(self.device)
            x, (ke, ve) = prefill_hidden(self.cfg, self._params, toks)
            cache_insert(self.cache.k, self.cache.v, slot, ke[0], ve[0])
            if self.draft_cache is not None:
                # seed the draft's cache for the same slot, so the first
                # speculative tick can draft at once
                _, (dke, dve) = prefill_hidden(self.draft_cfg,
                                               self._draft_params, toks)
                cache_insert(self.draft_cache.k, self.draft_cache.v, slot,
                             dke[0], dve[0])
            if resume is None:
                logits = _head(self.cfg, self._params, x[:, S - 1])
                tok = self._sample_one(logits, req, 0)
        pf_ms = (time.perf_counter() - t0) * 1e3
        self._note_ms(SERVING_PREFILL_MS, "_prefill_ms", pf_ms)
        SERVING_PREFILL_CHUNK_MS.observe(pf_ms)
        st = _Slot(req, length=S, last_token=tok)
        self._slots[slot] = st
        self.cache.lengths[slot] = S
        if resume is not None:
            # tokens through resume[1] were streamed before: rebuild
            # decode state, emit nothing
            st.last_token = resume[1]
            st.generated = len(req.tokens)
            return
        self._emit(slot, st, tok)

    def _emit(self, slot: int, st: _Slot, tok: int) -> None:
        st.req._push(tok)
        self._note_tokens(1)
        reason = self._finish_reason(st, tok)
        if reason is not None:
            self._evict(slot, reason)

    # -- paged mode: chunked prefill + preemption ----------------------------
    def _prefill_chunk_tick(self) -> None:
        """Advance every mid-prefill slot by at most one prefill_chunk;
        the decode tick follows in the same scheduler iteration."""
        for slot in range(self.n_slots):
            st = self._slots[slot]
            if st is None or st.pending is None:
                continue
            if st.req._cancelled:
                self._evict(slot, CANCELLED)
            elif st.req.deadline is not None \
                    and time.monotonic() > st.req.deadline:
                self._evict(slot, DEADLINE)
            else:
                self._prefill_one_chunk(slot, st)

    def _prefill_one_chunk(self, slot: int, st: _Slot) -> None:
        pending = st.pending
        bs = self.block_size
        chunk_cap = self.prefill_chunk
        if self.overload is not None:
            # brownout rung 2: smaller chunks, so long prompts yield the
            # scheduler to open streams more often (re-rounded to the
            # block size, at least one block)
            chunk_cap = max(bs, (self.overload.prefill_chunk(chunk_cap)
                                 // bs) * bs)
        c_true = min(int(pending.size), chunk_cap)
        # end-padded to the next block boundary (a prefix-matched slot
        # starts mid-block), which the table covers
        c_pad = -(-(st.length + c_true) // bs) * bs - st.length
        while not self.cache.grow(slot, st.length + c_pad):
            # pool exhausted: reclaim LRU prefix-tree leaves first, then
            # preempt strictly-younger work, else wait for an eviction
            # (the oldest slot is never preempted, so the engine always
            # makes progress)
            if self._reclaim_blocks(slot, st.length + c_pad):
                continue
            victim = self._youngest_slot(exclude=slot)
            if victim is None \
                    or self._slots[victim].admit_order <= st.admit_order:
                return
            self._preempt(victim)
        last = c_true == pending.size
        t0 = time.perf_counter()
        ck_args = {"slot": slot, "start": st.length, "chunk": c_true,
                   "tick": self._ticks,
                   "open_streams": self._open_decode_streams()}
        flow = None
        if st.req.trace is not None and recording():
            ck_args.update(st.req.trace.args(rid=st.req.rid))
            flow = st.req.trace.trace_id
        # the span times the chunk's launches (no synchronisation: a
        # non-final chunk returns nothing to the host)
        with span("serving.prefill_chunk", cat="serving", args=ck_args,
                  flow=flow):
            toks = np.zeros((1, c_pad), np.int64)
            toks[0, :c_true] = pending[:c_true]
            row = self.cache.table_row(slot)[:self._width_bucket(
                self.cache.blocks_for(st.length + c_pad))]
            dev = self.device
            row = torch.from_numpy(row).to(dev)
            toks = torch.from_numpy(toks).to(dev)
            pool = (self.cache.kb, self.cache.vb)
            x = prefill_chunk_hidden(self.cfg, self._params, pool, row,
                                     toks, st.length)
            if self.draft_cache is not None:
                # the same chunk appended to the draft's fixed cache row
                gpt_verify_step(
                    self.draft_cfg, self._draft_params,
                    (self.draft_cache.k[slot:slot + 1],
                     self.draft_cache.v[slot:slot + 1]),
                    torch.tensor([st.length], device=dev), toks)
        SERVING_PREFILL_CHUNK_MS.observe((time.perf_counter() - t0) * 1e3)
        st.length += c_true
        self.cache.lengths[slot] = st.length
        st.pending = None if last else pending[c_true:]
        self.cache.update_gauges()
        if not last:
            self._note_ms(SERVING_PREFILL_MS, "_prefill_ms",
                          (time.perf_counter() - t0) * 1e3)
            return
        if self._prefix is not None and st.length >= st.req.prompt.size:
            # the whole prompt is cached now: register it, so the next
            # identical prefix splices these blocks instead of computing
            self._prefix.insert(st.req.prompt, self.cache.block_tables[slot])
        if st.resume_last is not None:
            # resumed after preemption: the next token was already
            # streamed before the preemption — just rebuild decode state
            st.last_token = st.resume_last
            st.resume_last = None
            self._note_ms(SERVING_PREFILL_MS, "_prefill_ms",
                          (time.perf_counter() - t0) * 1e3)
            return
        logits = _head(self.cfg, self._params, x[:, c_true - 1])
        tok = self._sample_one(logits, st.req, 0)
        self._note_ms(SERVING_PREFILL_MS, "_prefill_ms",
                      (time.perf_counter() - t0) * 1e3)
        st.last_token = tok
        st.generated = 1
        self._emit(slot, st, tok)

    def _open_decode_streams(self) -> int:
        return sum(1 for st in self._slots
                   if st is not None and st.pending is None)

    def _youngest_slot(self, exclude: int) -> Optional[int]:
        best = None
        for s, st in enumerate(self._slots):
            if st is None or s == exclude:
                continue
            if best is None \
                    or st.admit_order > self._slots[best].admit_order:
                best = s
        return best

    def _preempt(self, slot: int) -> None:
        """Return a slot's blocks to the pool and its request to the HEAD
        of the queue; it resumes by re-prefilling prompt + generated
        (recompute preemption — tokens already streamed are unaffected)."""
        st = self._slots[slot]
        self._slots[slot] = None
        self.cache.release(slot)
        SERVING_PREEMPTIONS.add(1)
        st.req._resume = self._resume_record(st.req)
        with self._cv:
            self._queue.appendleft(st.req)
            SERVING_QUEUE_DEPTH.set(len(self._queue))
        SERVING_SLOT_OCCUPANCY.set(self.cache.occupancy)

    @staticmethod
    def _resume_record(req: GenerationRequest):
        """Where a requeued request resumes: (prompt + tokens[:-1],
        tokens[-1]) — the cache held the first, the last is the next
        decode input — or None when nothing was emitted (start over)."""
        if not req.tokens:
            return None
        seq = np.concatenate([req.prompt, np.asarray(req.tokens[:-1],
                                                     np.int32)])
        return seq.astype(np.int32), int(req.tokens[-1])

    def _grow_for_decode(self, active: List[int]) -> List[int]:
        """Ensure each decoding slot's table covers its next write
        position, preempting the youngest slot when the pool runs dry.
        Oldest slots get blocks first."""
        ready = []
        for s in sorted(active, key=lambda s: self._slots[s].admit_order):
            st = self._slots[s]
            if st is None:       # preempted as a victim earlier this tick
                continue
            while not self.cache.grow(s, st.length + 1):
                if self._reclaim_blocks(s, st.length + 1):
                    continue
                victim = self._youngest_slot(exclude=s)
                if victim is None:
                    # alone and the pool is spent: cache capacity reached
                    self._evict(s, LENGTH)
                    break
                if self._slots[victim].admit_order <= st.admit_order:
                    break        # only younger work is preemptible: stall
                self._preempt(victim)
            else:
                ready.append(s)
        return [s for s in ready if self._slots[s] is not None]

    def _try_spec_grow(self, active: List[int]) -> bool:
        """Paged speculation headroom: grow every active table to cover
        the k proposals + bonus WITHOUT preempting anyone (speculation
        is never worth evicting work for). False: this tick takes the
        one-token decode."""
        return all(self.cache.grow(s, self._slots[s].length + self.spec_k
                                   + 1) for s in active)

    def _decode_tick(self) -> None:
        now = time.monotonic()
        for s, st in enumerate(self._slots):
            if st is None:
                continue
            if st.req._cancelled:
                self._evict(s, CANCELLED)
            elif st.req.deadline is not None and now > st.req.deadline:
                self._evict(s, DEADLINE)
        active = [s for s in range(self.n_slots)
                  if self._slots[s] is not None
                  and self._slots[s].pending is None]
        if not active:
            return
        # speculation needs k+1 positions of headroom on every active
        # slot: a near-cap slot drops the whole tick to the one-token
        # decode rather than splitting the batch. Constrained rows force
        # the same fallback: the draft's proposals are not mask-aware.
        # Brownout rung 1 turns speculation off.
        constrained = [s for s in active
                       if self._slots[s].req.constraint is not None]
        use_spec = (self.draft_cfg is not None
                    and (self.overload is None
                         or self.overload.spec_allowed())
                    and all(self._slots[s].length + self.spec_k + 1
                            <= self.max_len for s in active))
        if use_spec and constrained:
            use_spec = False
            CONSTRAINED_FALLBACK_TICKS.add(1)
        if self.paged:
            if use_spec:
                use_spec = self._try_spec_grow(active)
            if not use_spec:
                active = self._grow_for_decode(active)
                if not active:
                    return

        if _faults.ENABLED[0]:
            # serving_nan (keyed by request id): NaN the slot's cached
            # K/V, the deterministic stand-in for a poisoned pool
            for s in active:
                f = _faults.FAULTS.take_request("serving_nan",
                                                self._slots[s].req.rid)
                if f is not None:
                    FAULTS_INJECTED.add()
                    self._poison_slot(s)

        positions = np.zeros(self.n_slots, np.int32)
        tokens = np.zeros(self.n_slots, np.int32)
        temps = [0.0] * self.n_slots
        top_ks = [0] * self.n_slots
        top_ps = [1.0] * self.n_slots
        rids = [0] * self.n_slots
        draws = [0] * self.n_slots
        for s in active:
            st = self._slots[s]
            positions[s] = st.length
            tokens[s] = st.last_token
            temps[s] = st.req.temperature
            top_ks[s] = st.req.top_k
            top_ps[s] = st.req.top_p
            rids[s] = st.req.rid
            draws[s] = len(st.req.tokens)
        span_args = {"batch": len(active), "tick": self._ticks}
        if self.replica_id is not None:
            span_args["replica"] = self.replica_id
        if use_spec:
            span_args["spec_k"] = self.spec_k
        t0 = time.perf_counter()
        n_emit = health = None
        # the span ends at the tick's device-to-host copy; its args are
        # serialized when it closes, so the spec counts added below land
        with span("serving.decode_step", cat="serving", args=span_args):
            dev = self.device
            pos_t = torch.from_numpy(positions).to(dev)
            tok_t = torch.from_numpy(tokens).to(dev)
            tables = None
            if self.paged:
                # table width bucketed to the live maximum (next pow2):
                # the decode's work tracks live tokens, not the
                # worst-case table
                tables = self.cache.tables_array(active)
                tables = torch.from_numpy(np.ascontiguousarray(
                    tables[:, :self._width_bucket(
                        max(len(self.cache.block_tables[s])
                            for s in active))])).to(dev)
            samp = (temps, top_ks, top_ps, self.seed, rids, draws)
            if use_spec:
                out, n_emit, health = self._spec_dispatch(
                    tables, pos_t, tok_t, self._draft_inputs(active), samp)
                span_args["proposed"] = self.spec_k * len(active)
                span_args["accepted"] = int(sum(int(n_emit[s]) - 1
                                               for s in active))
            else:
                out, health = self._plain_dispatch(
                    tables, pos_t, tok_t, constrained, samp, span_args)
        tick_ms = (time.perf_counter() - t0) * 1e3
        self._note_ms(SERVING_DECODE_MS, "_decode_ms", tick_ms)
        SERVING_DECODE_TICK_MS.observe(tick_ms)
        if self.overload is not None:
            self.overload.observe_tick(tick_ms)
        if self._watchdog is not None:
            poisoned = [s for s in active if not health[s]]
            if poisoned:
                SERVING_WATCHDOG_TRIPS.add(len(poisoned))
                # the whole tick's outputs are dropped: poisoned streams
                # fail, healthy ones resume by replay, token-identical
                self._watchdog_restart(poisoned)
                return
            self._watchdog_latency(tick_ms)
        emitted = 0
        traced = []       # (request, tokens pushed) of traced riders
        for s in active:
            st = self._slots[s]
            burst = [int(out[s])] if n_emit is None \
                else [int(x) for x in out[s, :int(n_emit[s])]]
            pushed = 0
            for tok in burst:
                st.length += 1
                st.generated += 1
                st.last_token = tok
                self.cache.lengths[s] = st.length
                st.req._push(tok)
                emitted += 1
                pushed += 1
                reason = self._finish_reason(st, tok)
                if reason is not None:
                    self._evict(s, reason)
                    break
            if st.req.trace is not None:
                traced.append((st.req, pushed))
        if traced and recording():
            # one per-request event per traced rider: the causal twin of
            # the batched serving.decode_step span
            dur = tick_ms / 1e3
            for req, n_toks in traced:
                rq_args = req.trace.args(rid=req.rid, tokens=n_toks,
                                         tick=self._ticks)
                if self.replica_id is not None:
                    rq_args["replica"] = self.replica_id
                emit_complete("serving.decode_tick", t0, dur,
                              cat="serving", args=rq_args)
                emit_flow("t", req.trace.trace_id, t0)
        if use_spec:
            self._note_spec(self.spec_k * len(active),
                            int(sum(int(n_emit[s]) - 1 for s in active)))
        self._note_tokens(emitted)
        SERVING_SLOT_OCCUPANCY.set(self.cache.occupancy)
        if self.paged:
            self.cache.update_gauges()

    def _plain_dispatch(self, tables, pos_t, tok_t, constrained, samp,
                        span_args):
        """The one-token decode and its sampling. Returns (tokens (B,),
        health (B,) or None) as host arrays: the armed watchdog's verdict
        and the MoE router's stats ride in the tokens' device-to-host
        copy."""
        if self.paged:
            got = gpt_decode_step_paged(
                self.cfg, self._decode_params,
                (self.cache.kb, self.cache.vb), tables, pos_t, tok_t)
        else:
            got = gpt_decode_step(
                self.cfg, self._decode_params,
                (self.cache.k, self.cache.v), pos_t, tok_t)
        mask = None
        if constrained:
            # per-slot sampling mask: each constrained row carries its
            # automaton's live-token set, every other row allows all
            masks = np.ones((self.n_slots, self.cfg.vocab_size), bool)
            for s in constrained:
                masks[s] = self._mask_row(self._slots[s].req)
            mask = torch.from_numpy(masks).to(self.device)
        toks = sample_tokens_streams(got[0], *samp, mask=mask)
        parts = [toks.long()]
        if self._watchdog is not None:
            parts.append(logits_finite(got[0]).long())
        if self._moe:
            counts, dropped = got[2]
            parts += [counts.long(), dropped.long().reshape(1)]
        if len(parts) == 1:
            return toks.cpu().numpy(), None
        host = torch.cat(parts).cpu().numpy()
        B = self.n_slots
        health = None
        if self._watchdog is not None:
            health = host[B:2 * B].astype(bool)
        if self._moe:
            off = B * (len(parts) - 2)     # past the tokens and verdict
            self._note_moe(host[off:-1], int(host[-1]), span_args)
        return host[:B], health

    def _draft_inputs(self, active: List[int]):
        """(positions, prev) (B,) device tensors of a tick's draft steps.
        An active row drafts from its length, ``prev`` the token before
        its last (at length - 1, which the first step rewrites). Every
        other lane writes its garbage where its own draft row holds
        nothing yet: from its length on (a mid-prefill slot keeps the
        K/V its chunks appended), clamped to the cache; a slot past the
        clamp is too near its cap ever to draft again."""
        pos = np.zeros(self.n_slots, np.int64)
        prev = np.zeros(self.n_slots, np.int64)
        cap = self.draft_cache.max_len - self.spec_k
        for s in range(self.n_slots):
            st = self._slots[s]
            if s in active:
                pos[s] = st.length
                req = st.req
                prev[s] = req.tokens[-2] if len(req.tokens) >= 2 \
                    else req.prompt[-1]
            else:
                pos[s] = min((st.length if st is not None else 0) + 1, cap)
        return (torch.from_numpy(pos).to(self.device),
                torch.from_numpy(prev).to(self.device))

    def _draft_propose(self, draft_in, tokens, samp):
        """``spec_k`` draft steps over the draft's fixed cache, each
        sampled from the request's stream under the draft salt. Returns
        the proposals (B, K) and the logits they were drawn from
        (B, K, V).

        The draft never consumes its own last proposal, so after a tick
        that accepts all k its cache has no K/V at the new length - 1.
        The first step therefore takes two tokens, ``prev`` at
        ``positions - 1`` and ``tokens`` at ``positions``
        (``draft_in`` is :meth:`_draft_inputs`): it fills that hole, and
        otherwise rewrites an accepted token's K/V. One 2-token step
        reads the weights once, as a 1-token step does."""
        temps, top_ks, top_ps, seed, rids, draws = samp
        positions, prev = draft_in
        cache = (self.draft_cache.k, self.draft_cache.v)
        cur = tokens
        d_toks, d_logits = [], []
        for j in range(self.spec_k):
            if j == 0:
                lg = gpt_verify_step(
                    self.draft_cfg, self._draft_params, cache,
                    positions - 1,
                    torch.stack([prev, cur.long()], dim=1))[0][:, 1]
            else:
                lg = gpt_decode_step(self.draft_cfg, self._draft_params,
                                     cache, positions + j, cur)[0]
            cur = sample_tokens_streams(lg, temps, top_ks, top_ps, seed,
                                        rids, [d + j for d in draws],
                                        salt=DRAFT_SALT)
            d_toks.append(cur)
            d_logits.append(lg)
        return torch.stack(d_toks, dim=1), torch.stack(d_logits, dim=1)

    def _spec_dispatch(self, tables, positions, tokens, draft_in, samp):
        """One speculative tick: the draft proposes spec_k, the target
        verifies k+1 positions in one pass, the acceptance rule picks.
        Returns (tokens (B, k+1), n_emit (B,), health (B,) or None) as
        host arrays; the armed watchdog's verdict covers every verify
        position and rides in the same copy."""
        d_toks, d_logits = self._draft_propose(draft_in, tokens, samp)
        vtokens = torch.cat([tokens.long()[:, None], d_toks.long()], dim=1)
        if self.paged:
            t_logits, _ = gpt_verify_step_paged(
                self.cfg, self._decode_params,
                (self.cache.kb, self.cache.vb), tables, positions, vtokens)
        else:
            t_logits, _ = gpt_verify_step(
                self.cfg, self._decode_params, (self.cache.k, self.cache.v),
                positions, vtokens)
        out, n_emit = spec_accept(t_logits, d_logits, d_toks, *samp)
        parts = [out.reshape(-1), n_emit]
        if self._watchdog is not None:
            parts.append(logits_finite(t_logits).long())
        host = torch.cat(parts).cpu().numpy()
        B = self.n_slots
        K1 = out.shape[1]
        health = None if self._watchdog is None \
            else host[B * (K1 + 1):].astype(bool)
        return (host[:B * K1].reshape(B, K1), host[B * K1:B * (K1 + 1)],
                health)

    def _finish_reason(self, st: _Slot, tok: int) -> Optional[str]:
        """Why generation stops after emitting ``tok`` (None = go on).
        Called once per emitted token, so this is also where a
        constrained request's automaton consumes it."""
        if st.req.eos_id is not None and tok == st.req.eos_id:
            return EOS
        if st.req.constraint is not None:
            alive = st.req.constraint.advance(tok)
            if st.req.constraint.finished or not alive:
                return STOP    # match complete, or a token killed it
        if st.generated >= st.req.max_new_tokens:
            return LENGTH
        if st.length >= self.max_len:
            return LENGTH      # cache slot full — nothing further fits
        return None

    def _evict(self, slot: int, reason: str) -> None:
        st = self._slots[slot]
        self._slots[slot] = None
        self.cache.release(slot)
        SERVING_EVICTIONS.add(1)
        SERVING_SLOT_OCCUPANCY.set(self.cache.occupancy)
        st.req._finish(reason)

    # -- watchdog: NaN/latency sentinel + auto-restart -----------------------
    def _poison_slot(self, slot: int) -> None:
        """serving_nan's effect: the slot's cached K/V become NaN, in
        place (every block of its table when paged)."""
        nan = float("nan")
        if self.paged:
            rows = torch.as_tensor(self.cache.block_tables[slot],
                                   dtype=torch.long, device=self.device)
            self.cache.kb.index_fill_(0, rows, nan)
            self.cache.vb.index_fill_(0, rows, nan)
        else:
            self.cache.k[slot] = nan
            self.cache.v[slot] = nan

    def _watchdog_latency(self, tick_ms: float) -> None:
        """The sentinel's latency rung: ``latency_trips`` consecutive
        ticks over ``latency_budget_ms`` is a stall verdict, counted and
        marked in the trace, not restarted (a restart cannot make compute
        faster)."""
        budget = self._watchdog["latency_budget_ms"]
        if not budget:
            return
        if tick_ms <= float(budget):
            self._slow_ticks = 0
            return
        self._slow_ticks += 1
        if self._slow_ticks >= int(self._watchdog["latency_trips"]):
            self._slow_ticks = 0
            SERVING_WATCHDOG_TRIPS.add()
            if recording():
                emit_instant("serving.watchdog_stall", time.perf_counter(),
                             cat="serving")

    def _watchdog_restart(self, poisoned: List[int]) -> None:
        """Restart from the last healthy state: fail only the poisoned
        requests, requeue every healthy open stream with its token history
        (admission replays it through the preemption-resume path, so its
        continuation is token-identical: the sampling streams are pure
        functions of (seed, request id, draw)), and reset the cache, the
        prefix tree and the draft cache."""
        self._restarts += 1
        if self._restarts > int(self._watchdog["max_restarts"]):
            # the last rung: the scheduler's _abort fails every open
            # request with this cause (and writes the flight dump)
            raise WatchdogTripped(
                f"watchdog restart budget exhausted "
                f"(max_restarts={self._watchdog['max_restarts']})")
        SERVING_WATCHDOG_RESTARTS.add()
        dump_flight("serving_watchdog_restart",
                    extra={"replica": self.replica_id,
                           "poisoned": sorted(poisoned),
                           "restart": self._restarts})
        bad = set(poisoned)
        healthy = sorted(
            ((st.admit_order, s) for s, st in enumerate(self._slots)
             if st is not None and s not in bad), reverse=True)
        with span("serving.watchdog_restart", cat="serving",
                  args={"poisoned": sorted(bad), "healthy": len(healthy),
                        "restart": self._restarts, "tick": self._ticks}):
            for s in bad:
                st = self._slots[s]
                self._slots[s] = None
                SERVING_EVICTIONS.add(1)
                st.req._finish(WATCHDOG, WatchdogTripped(
                    f"non-finite decode logits (request {st.req.rid})"))
            # youngest first through appendleft: the oldest ends at the
            # queue head, keeping the admission order on replay
            for _, s in healthy:
                st = self._slots[s]
                self._slots[s] = None
                st.req._resume = self._resume_record(st.req)
                with self._cv:
                    self._queue.appendleft(st.req)
            self._reset_cache()
        with self._cv:
            SERVING_QUEUE_DEPTH.set(len(self._queue))
        SERVING_SLOT_OCCUPANCY.set(0)

    def _reset_cache(self) -> None:
        """Zero the cache buffers in place and reset their accounting, and
        start a fresh prefix tree (cached prefixes may name poisoned
        blocks: dropping them costs recompute, never correctness) and a
        zeroed draft cache (its K/V were computed beside the poisoned
        rows). In place, so a restart allocates nothing."""
        self.cache.reset()
        if self._prefix is not None:
            self._prefix = RadixPrefixCache(self.cache)
        if self.draft_cache is not None:
            self.draft_cache.reset()

    # -- gauges --------------------------------------------------------------
    def _note_moe(self, counts, dropped: int, span_args=None) -> None:
        """Publish a tick's router stats: the busiest expert's share of
        the routed tokens (ppm gauge) and the dropped assignments
        (cumulative counter; decode is dropless, so it stays 0 there).
        Stale slots route too, as in JAX."""
        total = int(counts.sum())
        if total > 0:
            MOE_EXPERT_LOAD.set(int(float(counts.max() / total) * 1e6))
        if dropped:
            MOE_TOKENS_DROPPED.add(dropped)
        if span_args is not None and total > 0:
            span_args["moe_busiest_pct"] = round(
                float(counts.max()) / total * 100.0, 2)
            span_args["moe_dropped"] = dropped

    def _note_ms(self, gauge, attr: str, ms: float) -> None:
        old = getattr(self, attr)
        new = old + ms
        setattr(self, attr, new)
        gauge.add(int(new) - int(old))

    def _note_spec(self, proposed: int, accepted: int) -> None:
        SPEC_PROPOSED.add(proposed)
        SPEC_ACCEPTED.add(accepted)
        self._spec_prop += proposed
        self._spec_acc += accepted
        if self._spec_prop > 0:
            SPEC_ACCEPTANCE_RATE.set(
                int(round(100.0 * self._spec_acc / self._spec_prop)))

    def _note_tokens(self, n: int) -> None:
        # sliding window over the last ticks: the gauge tracks the recent
        # rate, not a lifetime average
        now = time.monotonic()
        self._window.append((now, n))
        window_span = now - self._window[0][0]
        if len(self._window) >= 2 and window_span > 0:
            total = sum(c for _, c in self._window)
            SERVING_TOKENS_PER_S.set(max(1, int(total / window_span)))
