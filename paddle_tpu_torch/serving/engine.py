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

Not ported yet (see ROADMAP.md): the serving mesh, the watchdog,
overload control, KV export/import, the ranker, the flight recorder and
tracing spans.
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
from ..monitor.stats import (CONSTRAINED_FALLBACK_TICKS,
                             CONSTRAINED_REQUESTS, MOE_EXPERT_LOAD,
                             MOE_TOKENS_DROPPED, PREFIX_COW_COPIES,
                             SERVING_DEADLINE_SHEDS, SERVING_DECODE_MS,
                             SERVING_EVICTIONS, SERVING_PREEMPTIONS,
                             SERVING_PREFILL_MS, SERVING_QUEUE_DEPTH,
                             SERVING_SLOT_OCCUPANCY, SERVING_TOKENS_PER_S,
                             SPEC_ACCEPTANCE_RATE, SPEC_ACCEPTED,
                             SPEC_PROPOSED)
from .kv_cache import KVCache, PagedKVCache, cache_insert
from .prefix_cache import RadixPrefixCache
from .sampling import DRAFT_SALT, sample_tokens_streams, spec_accept

__all__ = ["InferenceEngine", "GenerationRequest", "QueueFull"]


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

# rid floor of the prefix re-warm request space: warm prefills draw RNG
# streams that never collide with, or shift the numbering of, live ids
_WARM_RID_BASE = 2**30


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
        self._tokenizer = None            # the engine's tokenizer, if any
        self.tokens: List[int] = []       # generated ids (includes eos)
        self.finish_reason: Optional[str] = None
        self.error: Optional[BaseException] = None
        self._cancelled = False
        # paged preemption: (cached-prefix tokens, last token) to
        # re-prefill from when the request is re-admitted
        self._resume = None
        self._cv = threading.Condition()

    # -- scheduler side ------------------------------------------------------
    def _push(self, tok: int) -> None:
        with self._cv:
            self.tokens.append(tok)
            self._cv.notify_all()

    def _finish(self, reason: str, error: Optional[BaseException] = None):
        with self._cv:
            if self.finish_reason is None:
                self.finish_reason = reason
                self.error = error
            self._cv.notify_all()

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
    """

    def __init__(self, cfg, params, n_slots: int = 4,
                 max_len: Optional[int] = None, queue_size: int = 64,
                 eos_id: Optional[int] = None, seed: int = 0,
                 int8_weights: bool = False, paged: Optional[bool] = None,
                 block_size: int = 16, n_blocks: Optional[int] = None,
                 prefill_chunk: int = 64, draft=None, spec_k: int = 4,
                 mesh=None, tokenizer=None,
                 prefix_cache: Optional[bool] = None, device=None):
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
        self._window: collections.deque = collections.deque(maxlen=64)
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
               constraint=None) -> GenerationRequest:
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
        when the match completes."""
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
            self._queue.append(req)     # warming runs before traffic: the
            SERVING_QUEUE_DEPTH.set(len(self._queue))   # bound is moot
            self._cv.notify_all()
        return req

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
                        busy = bool(self._queue) or any(
                            s is not None for s in self._slots)
                        if self._stop and (not self._drain or not busy):
                            break
                        if not busy:
                            self._cv.wait(0.05)
                            continue
                    self._ticks += 1
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
                SERVING_QUEUE_DEPTH.set(0)
                self._cv.notify_all()
            for req in leftovers:
                req._finish(SHUTDOWN)
            for s, st in enumerate(self._slots):
                if st is not None:
                    self._evict(s, SHUTDOWN)

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
        seq = req.prompt
        S = int(seq.size)
        t0 = time.perf_counter()
        # end-padded to a power-of-two bucket: causality keeps positions
        # < S exact, and the cache rows past S are overwritten by decode
        # before they are ever attended
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
        logits = _head(self.cfg, self._params, x[:, S - 1])
        tok = self._sample_one(logits, req, 0)
        self._note_ms(SERVING_PREFILL_MS, "_prefill_ms",
                      (time.perf_counter() - t0) * 1e3)
        st = _Slot(req, length=S, last_token=tok)
        self._slots[slot] = st
        self.cache.lengths[slot] = S
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
        c_true = min(int(pending.size), self.prefill_chunk)
        bs = self.block_size
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
        toks = np.zeros((1, c_pad), np.int64)
        toks[0, :c_true] = pending[:c_true]
        row = self.cache.table_row(slot)[:self._width_bucket(
            self.cache.blocks_for(st.length + c_pad))]
        dev = self.device
        row = torch.from_numpy(row).to(dev)
        toks = torch.from_numpy(toks).to(dev)
        pool = (self.cache.kb, self.cache.vb)
        x = prefill_chunk_hidden(self.cfg, self._params, pool, row, toks,
                                 st.length)
        if self.draft_cache is not None:
            # the same chunk appended to the draft's fixed cache row
            gpt_verify_step(
                self.draft_cfg, self._draft_params,
                (self.draft_cache.k[slot:slot + 1],
                 self.draft_cache.v[slot:slot + 1]),
                torch.tensor([st.length], device=dev), toks)
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
        if st.req.tokens:
            # the cache held prompt + tokens[:-1]; tokens[-1] is the next
            # decode input
            seq = np.concatenate(
                [st.req.prompt,
                 np.asarray(st.req.tokens[:-1], np.int32)]).astype(np.int32)
            st.req._resume = (seq, int(st.req.tokens[-1]))
        else:
            st.req._resume = None       # mid-prefill: just start over
        with self._cv:
            self._queue.appendleft(st.req)
            SERVING_QUEUE_DEPTH.set(len(self._queue))
        SERVING_SLOT_OCCUPANCY.set(self.cache.occupancy)

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
        constrained = [s for s in active
                       if self._slots[s].req.constraint is not None]
        use_spec = self.draft_cfg is not None and all(
            self._slots[s].length + self.spec_k + 1 <= self.max_len
            for s in active)
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
        t0 = time.perf_counter()
        dev = self.device
        pos_t = torch.from_numpy(positions).to(dev)
        tok_t = torch.from_numpy(tokens).to(dev)
        tables = None
        if self.paged:
            # table width bucketed to the live maximum (next pow2): the
            # decode's work tracks live tokens, not the worst-case table
            tables = self.cache.tables_array(active)
            tables = torch.from_numpy(np.ascontiguousarray(
                tables[:, :self._width_bucket(
                    max(len(self.cache.block_tables[s]) for s in active))]
            )).to(dev)
        samp = (temps, top_ks, top_ps, self.seed, rids, draws)
        n_emit = None
        if use_spec:
            out, n_emit = self._spec_dispatch(
                tables, pos_t, tok_t, self._draft_inputs(active), samp)
        else:
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
                mask = torch.from_numpy(masks).to(dev)
            toks = sample_tokens_streams(got[0], *samp, mask=mask)
            if self._moe:
                # the router stats ride in the tokens' device-to-host copy
                counts, dropped = got[2]
                host = torch.cat([toks.long(), counts.long(),
                                  dropped.long().reshape(1)]).cpu().numpy()
                out = host[:self.n_slots]
                self._note_moe(host[self.n_slots:-1], int(host[-1]))
            else:
                out = toks.cpu().numpy()
        self._note_ms(SERVING_DECODE_MS, "_decode_ms",
                      (time.perf_counter() - t0) * 1e3)
        emitted = 0
        for s in active:
            st = self._slots[s]
            burst = [int(out[s])] if n_emit is None \
                else [int(x) for x in out[s, :int(n_emit[s])]]
            for tok in burst:
                st.length += 1
                st.generated += 1
                st.last_token = tok
                self.cache.lengths[s] = st.length
                st.req._push(tok)
                emitted += 1
                reason = self._finish_reason(st, tok)
                if reason is not None:
                    self._evict(s, reason)
                    break
        if use_spec:
            self._note_spec(self.spec_k * len(active),
                            int(sum(int(n_emit[s]) - 1 for s in active)))
        self._note_tokens(emitted)
        SERVING_SLOT_OCCUPANCY.set(self.cache.occupancy)
        if self.paged:
            self.cache.update_gauges()

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
        Returns (tokens (B, k+1), n_emit (B,)) as host arrays."""
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
        host = torch.cat([out.reshape(-1), n_emit]).cpu().numpy()
        B = self.n_slots
        return host[:-B].reshape(B, -1), host[-B:]

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

    # -- gauges --------------------------------------------------------------
    def _note_moe(self, counts, dropped: int) -> None:
        """Publish a tick's router stats: the busiest expert's share of
        the routed tokens (ppm gauge) and the dropped assignments
        (cumulative counter; decode is dropless, so it stays 0 there).
        Stale slots route too, as in JAX."""
        total = int(counts.sum())
        if total > 0:
            MOE_EXPERT_LOAD.set(int(float(counts.max() / total) * 1e6))
        if dropped:
            MOE_TOKENS_DROPPED.add(dropped)

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
