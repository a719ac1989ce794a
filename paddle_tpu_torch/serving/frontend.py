"""Multi-tenant OpenAI-style HTTP front end for the serving engine (the
port of ``paddle_tpu/serving/frontend.py``).

    python -m paddle_tpu_torch.serving.frontend --port 8000
    curl -s localhost:8000/v1/completions \\
         -H "Authorization: Bearer demo-key" \\
         -d '{"model":"gpt-tiny","prompt":"hello","max_tokens":16}'

Pure stdlib ``asyncio``, no web framework: one event loop owns every
connection, parses a minimal HTTP/1.1 request per connection, and bridges
to the :class:`~paddle_tpu_torch.serving.engine.InferenceEngine` (or an
:class:`~paddle_tpu_torch.serving.router.EngineRouter`) through the
loop's executor (``submit`` may block on engine backpressure; token
streams are pumped from an executor thread into an ``asyncio.Queue``).
The engine keeps its own scheduler thread: the front end is a CLIENT of
the engine, never a second writer to device state.

Routes:

- ``POST /v1/completions``: prompt (string or token-id list) to
  ``text_completion`` JSON, or Server-Sent Events when ``"stream":
  true`` (chunked transfer encoding, ``data: [DONE]`` terminator);
- ``POST /v1/chat/completions``: ``messages`` flattened through a
  deterministic template (``role: content\\n`` + ``assistant:``), so a
  shared system prompt is a shared PREFIX the radix cache serves from
  blocks; SSE deltas when streaming;
- ``GET /v1/models``: the single served model;
- ``GET /metrics``: Prometheus text exposition: every registry gauge
  with ``# HELP``/``# TYPE`` and sanitized names, every latency histogram
  (first-token, per-token, queue wait, decode tick, prefill chunk,
  recorded at the source) as cumulative ``_bucket{le=...}`` / ``_sum`` /
  ``_count`` series, rendered from registry snapshots so a scrape never
  blocks a scheduler tick;
- ``GET /healthz`` (liveness) and ``GET /readyz`` (readiness, below);
- ``POST /v1/rank``: 404 "ranking not enabled", as the reference answers
  for an engine without a ranker (the port has no ranker yet).

Causal tracing: every generation request gets a ``monitor.TraceContext``
minted at admission; the flow-start event, the WFQ ``frontend.queue_wait``
span and every downstream engine span (prefill chunks, decode ticks,
failover hops, completion) carry its trace id. Tracing off leaves the
token streams bit-identical.

Tenancy and SLO scheduling: every request authenticates with
``Authorization: Bearer <api-key>`` against a :class:`Tenant` table.
Admission is a per-tenant token bucket (``rate`` req/s, ``burst``) plus a
``max_streams`` cap on concurrent streams; exhaustion answers **429**
with ``Retry-After``. Admitted requests queue in their tenant's PRIORITY
LANE, and one dispatcher drains the lanes by weighted fair queuing where
a request's cost is its PREFILL CHUNK count
(``ceil(prompt_tokens / prefill_chunk)``): a gold one-liner overtakes a
bronze novella, but bronze keeps its weight share.

Structured output: ``response_format`` of ``{"type": "json_schema",
"json_schema": {...}}`` (or ``{"type": "regex", "regex": ...}``) compiles
through ``serving.constrained`` into a token-mask automaton riding the
engine's sampling; the stream ends with ``finish_reason: "stop"`` when
the match completes.

Overload, the 429-against-503 contract: **429** means YOUR tenant broke
its own admission contract (token bucket, stream cap) and other tenants
are unaffected; **503** + ``Retry-After`` means the SERVER cannot take
the work: engine queue saturated, the request's ``deadline_s`` expired
before generation started (in the WFQ lane or in the engine queue;
``frontend_load_sheds``), or the brownout ladder (``serving.overload``)
reached a shed rung for your lane. Deadlines propagate end to end:
``deadline_s`` starts the clock at HTTP admission, the lane wait burns
it, the ENGINE gets only the remainder, and the response waits use the
remainder too; a request that produced tokens before expiring returns
them with ``finish_reason "deadline"`` (or ``"timeout"`` when the wait
itself lapsed). A client that DISCONNECTS mid-stream is seen by the
read-side EOF watcher and its engine request is cancelled, releasing its
slot, paged blocks and prefix-tree references. ``conn_drop@step=N``
(``FLAGS_fault_inject``) makes the front end abort its Nth streaming
response after the first piece, the deterministic stand-in for such a
client.

``/readyz``: engine (or >= 1 router replica) alive, block-pool headroom
above 0, brownout ladder below its shed rungs, with the failing checks in
the 503 body. Over a router every check is replica-aware: a supervisor's
replacement still RE-WARMING its prefix tree shows in the replica checks
(``warming``) but is not counted ready, and an attached
:class:`~paddle_tpu_torch.serving.lifecycle.ReplicaSupervisor`'s state
(target replica count, ladder positions) rides in ``checks.lifecycle``.
"""
from __future__ import annotations

import argparse
import asyncio
import collections
import json
import threading
import time
import uuid
from datetime import datetime, timezone
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..monitor.stats import (FAULTS_INJECTED, FRONTEND_429S,
                             FRONTEND_ACTIVE_STREAMS, FRONTEND_LOAD_SHEDS,
                             FRONTEND_QUEUE_WAIT_MS, FRONTEND_REQUESTS,
                             SERVING_QUEUE_WAIT_MS, prometheus_text,
                             stat_get)
from ..monitor.trace import emit_complete, emit_flow, recording, span
from ..monitor.tracectx import mint_trace
from ..resilience import faults as _faults
from .constrained import compile_constraint
from .engine import QueueFull

__all__ = ["ServingFrontend", "Tenant", "TokenBucket", "LANE_WEIGHTS"]

# default lane weights: a gold chunk is worth 4 bronze chunks of service
LANE_WEIGHTS = {"gold": 4.0, "silver": 2.0, "bronze": 1.0}


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/s refill up to ``burst``.
    ``take()`` returns 0.0 on success or the seconds until a token will
    exist (the 429 Retry-After). Thread-safe — handlers run on the loop
    thread but tenants may be probed from tests/operators."""

    def __init__(self, rate: float, burst: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self._tokens = float(burst)
        self._t = time.monotonic()
        self._lock = threading.Lock()

    def take(self, n: float = 1.0) -> float:
        with self._lock:
            now = time.monotonic()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._t) * self.rate)
            self._t = now
            if self._tokens >= n:
                self._tokens -= n
                return 0.0
            return (n - self._tokens) / self.rate if self.rate > 0 \
                else float("inf")


class Tenant:
    """One API key's admission contract: rate/burst token bucket,
    concurrent-stream cap, and the SLO lane its requests queue in."""

    def __init__(self, name: str, api_key: str, rate: float = 10.0,
                 burst: float = 20.0, max_streams: int = 8,
                 lane: str = "silver"):
        if lane not in LANE_WEIGHTS:
            raise ValueError(f"unknown lane {lane!r} "
                             f"(choose from {sorted(LANE_WEIGHTS)})")
        self.name = name
        self.api_key = api_key
        self.bucket = TokenBucket(rate, burst)
        self.max_streams = int(max_streams)
        self.lane = lane
        self._active = 0
        self._lock = threading.Lock()

    def acquire_stream(self) -> bool:
        with self._lock:
            if self._active >= self.max_streams:
                return False
            self._active += 1
        FRONTEND_ACTIVE_STREAMS.add(1)
        return True

    def release_stream(self) -> None:
        with self._lock:
            self._active -= 1
        FRONTEND_ACTIVE_STREAMS.add(-1)

    @property
    def active_streams(self) -> int:
        return self._active


class _WfqScheduler:
    """Weighted fair queuing over prefill chunks (loop-thread only).

    Each lane keeps a virtual finish tag; enqueue stamps the item with
    ``max(lane_v, global_v) + cost / weight`` and the dispatcher always
    serves the smallest tag — textbook WFQ, with cost measured in
    prefill chunks so service share is PROMPT WORK, not request count."""

    def __init__(self, weights: Dict[str, float]):
        self._weights = dict(weights)
        self._lanes: Dict[str, collections.deque] = {
            lane: collections.deque() for lane in weights}
        self._lane_v = {lane: 0.0 for lane in weights}
        self._vtime = 0.0
        self._ready = asyncio.Event()

    def put(self, lane: str, cost: float, item) -> None:
        start = max(self._vtime, self._lane_v[lane])
        finish = start + float(cost) / self._weights[lane]
        self._lane_v[lane] = finish
        self._lanes[lane].append((finish, item))
        self._ready.set()

    def __len__(self):
        return sum(len(q) for q in self._lanes.values())

    async def get(self):
        while True:
            best_lane = None
            for lane, q in self._lanes.items():
                if q and (best_lane is None
                          or q[0][0] < self._lanes[best_lane][0][0]):
                    best_lane = lane
            if best_lane is not None:
                finish, item = self._lanes[best_lane].popleft()
                self._vtime = max(self._vtime, finish)
                return item
            self._ready.clear()
            await self._ready.wait()


class _Job:
    """One admitted generation request waiting in its WFQ lane."""

    __slots__ = ("tenant", "kwargs", "future", "t_enqueued", "deadline_t")

    def __init__(self, tenant: Tenant, kwargs: dict, future,
                 deadline_t: Optional[float] = None):
        self.tenant = tenant
        self.kwargs = kwargs
        self.future = future
        self.t_enqueued = time.monotonic()
        self.deadline_t = deadline_t    # absolute monotonic, or None


class _Shed(Exception):
    """Server-side load shed (503 material): the request expired in the
    WFQ lane before the engine ever saw it."""


class _HttpError(Exception):
    def __init__(self, status: int, message: str, headers=None):
        super().__init__(message)
        self.status = status
        self.message = message
        self.headers = headers or {}


_STATUS_TEXT = {200: "OK", 400: "Bad Request", 401: "Unauthorized",
                404: "Not Found", 405: "Method Not Allowed",
                429: "Too Many Requests", 500: "Internal Server Error",
                503: "Service Unavailable"}


class ServingFrontend:
    """The asyncio HTTP server wrapping one InferenceEngine.

    ::

        fe = ServingFrontend(engine, tenants=[Tenant("acme", "sk-acme",
                                                     lane="gold")])
        fe.start()                      # loop thread; fe.port is bound
        ...
        fe.close()

    ``engine`` must carry a tokenizer (text prompts and constraints
    need the byte table). ``tenants`` defaults to a single open
    "default" tenant with key ``"demo-key"``.
    """

    def __init__(self, engine, tenants: Optional[List[Tenant]] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 model_id: str = "paddle-tpu-gpt",
                 default_max_tokens: int = 64,
                 default_timeout_s: float = 600.0):
        if engine.tokenizer is None:
            raise ValueError("ServingFrontend needs an engine with a "
                             "tokenizer (InferenceEngine(tokenizer=...))")
        self.engine = engine            # an InferenceEngine OR EngineRouter
        self.host = host
        self.port = int(port)           # rewritten to the bound port
        self.model_id = model_id
        self.default_max_tokens = int(default_max_tokens)
        # response-wait cap for requests WITHOUT a deadline_s; requests
        # with one wait exactly their remaining budget instead
        self.default_timeout_s = float(default_timeout_s)
        # the brownout ladder rides in on the engine/router (engine
        # constructor arg overload=); None = no ladder, no admission
        # sheds, no token caps
        self._overload = getattr(engine, "overload", None)
        self._conn_seq = 0              # streaming-connection index
        #                                 (the conn_drop fault key)
        tenants = tenants if tenants is not None else [
            Tenant("default", "demo-key")]
        self.tenants: Dict[str, Tenant] = {t.api_key: t for t in tenants}
        self._chunk = engine.prefill_chunk or 64
        self._constraints: Dict[str, object] = {}   # schema/regex -> compiled
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server = None
        # built here, used only on the loop thread (asyncio.Event binds
        # its loop lazily on first wait, so off-loop construction is ok)
        self._wfq = _WfqScheduler(LANE_WEIGHTS)
        self._dispatcher: Optional[asyncio.Task] = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        self._startup_error: Optional[BaseException] = None
        self._closing = False

    # -- lifecycle -----------------------------------------------------------
    def start(self, timeout: float = 30.0) -> "ServingFrontend":
        """Run the server on a dedicated loop thread; returns once the
        socket is bound (``self.port`` holds the real port)."""
        self._thread = threading.Thread(target=self._run_loop,
                                        name="serving-frontend", daemon=True)
        self._thread.start()
        if not self._started.wait(timeout):
            raise RuntimeError("frontend did not start in time")
        if self._startup_error is not None:
            raise RuntimeError("frontend failed to start") \
                from self._startup_error
        return self

    def _run_loop(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop
        try:
            loop.run_until_complete(self._serve())
        except Exception as e:  # noqa: BLE001 — surface startup failures
            self._startup_error = e
            self._started.set()
        finally:
            loop.close()

    async def _serve(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._dispatcher = asyncio.ensure_future(self._dispatch())
        self._started.set()
        async with self._server:
            try:
                await self._server.serve_forever()
            except asyncio.CancelledError:
                pass
        self._dispatcher.cancel()

    def close(self, timeout: float = 10.0) -> None:
        """Stop accepting connections and join the loop thread (the
        engine is NOT shut down — it belongs to the caller)."""
        self._closing = True
        loop = self._loop
        if loop is not None and self._server is not None:
            def _stop():
                self._server.close()
                for task in asyncio.all_tasks(loop):
                    task.cancel()
            loop.call_soon_threadsafe(_stop)
        if self._thread is not None:
            self._thread.join(timeout)

    # -- dispatcher (WFQ lanes -> engine admission) --------------------------
    async def _dispatch(self) -> None:
        """Single drain of the fair-queued lanes: engine submission
        happens in the executor because a full engine queue BLOCKS —
        that backpressure paces the dispatcher, so lane order is
        preserved all the way into the engine."""
        loop = asyncio.get_running_loop()
        while True:
            job = await self._wfq.get()
            wait_ms = (time.monotonic() - job.t_enqueued) * 1e3
            if self._overload is not None:
                self._overload.observe_queue_wait(wait_ms)
            if job.deadline_t is not None:
                remaining = job.deadline_t - time.monotonic()
                if remaining <= 0:
                    # expired in the WFQ lane: shed before the engine
                    # spends anything on it (503 + Retry-After upstream)
                    if not job.future.done():
                        job.future.set_exception(_Shed(
                            "deadline expired while queued "
                            f"({wait_ms:.0f}ms in lane)"))
                    continue
                # the engine gets the REMAINING budget, not a fresh one
                job.kwargs["deadline_s"] = remaining
            try:
                req = await loop.run_in_executor(
                    None, lambda: self.engine.submit(**job.kwargs))
            except Exception as e:  # noqa: BLE001 — fail THIS job only
                if not job.future.done():
                    job.future.set_exception(e)
                continue
            FRONTEND_QUEUE_WAIT_MS.add(int(wait_ms))
            SERVING_QUEUE_WAIT_MS.observe(wait_ms)
            if not job.future.done():
                job.future.set_result((req, wait_ms))

    # -- HTTP plumbing -------------------------------------------------------
    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        try:
            method, path, headers, body = await self._read_request(reader)
        except (asyncio.IncompleteReadError, ConnectionError,
                ValueError):
            writer.close()
            return
        status = 500
        tenant_name = "?"
        lane = "?"
        t0 = time.perf_counter()
        try:
            if path == "/v1/models" and method == "GET":
                status = await self._models(writer)
            elif path == "/metrics" and method == "GET":
                status = await self._metrics(writer)
            elif path == "/healthz" and method == "GET":
                status = await self._healthz(writer)
            elif path == "/readyz" and method == "GET":
                status = await self._readyz(writer)
            elif path in ("/v1/completions", "/v1/chat/completions"):
                if method != "POST":
                    raise _HttpError(405, "POST required")
                tenant = self._authenticate(headers)
                tenant_name, lane = tenant.name, tenant.lane
                status = await self._generate(
                    tenant, body, writer, reader,
                    chat=path == "/v1/chat/completions")
            elif path == "/v1/rank":
                if method != "POST":
                    raise _HttpError(405, "POST required")
                tenant = self._authenticate(headers)
                tenant_name, lane = tenant.name, tenant.lane
                status = await self._rank(writer)
            else:
                raise _HttpError(404, f"no route {path}")
        except _HttpError as e:
            status = e.status
            await self._send_json(writer, e.status,
                                  {"error": {"message": e.message,
                                             "type": "invalid_request_error"
                                             if e.status < 500 else
                                             "server_error"}},
                                  extra=e.headers)
        except (ConnectionError, asyncio.CancelledError):
            raise
        except Exception as e:  # noqa: BLE001 — answer 500, keep serving
            status = 500
            try:
                await self._send_json(
                    writer, 500,
                    {"error": {"message": f"{type(e).__name__}: {e}",
                               "type": "server_error"}})
            except ConnectionError:
                pass
        finally:
            if path.startswith("/v1/c"):   # generation routes only
                with span("frontend.request", cat="frontend",
                          args={"tenant": tenant_name, "lane": lane,
                                "status": status, "path": path,
                                "ms": (time.perf_counter() - t0) * 1e3,
                                "prefix_hit_rate":
                                    stat_get("prefix_hit_rate")}):
                    pass
            try:
                await writer.drain()
            except ConnectionError:
                pass
            writer.close()

    @staticmethod
    async def _read_request(reader) -> Tuple[str, str, dict, bytes]:
        line = await reader.readline()
        if not line:
            raise ConnectionError("empty request")
        parts = line.decode("latin-1").split()
        if len(parts) < 2:
            raise ValueError(f"bad request line {line!r}")
        method, path = parts[0].upper(), parts[1]
        headers = {}
        while True:
            hl = await reader.readline()
            if hl in (b"\r\n", b"\n", b""):
                break
            k, _, v = hl.decode("latin-1").partition(":")
            headers[k.strip().lower()] = v.strip()
        n = int(headers.get("content-length", "0") or "0")
        body = await reader.readexactly(n) if n else b""
        return method, path, headers, body

    async def _send_json(self, writer, status: int, obj: dict,
                         extra: Optional[dict] = None) -> None:
        payload = json.dumps(obj).encode("utf-8")
        headers = {"Content-Type": "application/json",
                   "Content-Length": str(len(payload)),
                   "Connection": "close"}
        headers.update(extra or {})
        writer.write(self._head(status, headers) + payload)
        await writer.drain()

    @staticmethod
    def _head(status: int, headers: dict) -> bytes:
        lines = [f"HTTP/1.1 {status} {_STATUS_TEXT.get(status, '')}"]
        lines += [f"{k}: {v}" for k, v in headers.items()]
        return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")

    # -- routes --------------------------------------------------------------
    def _authenticate(self, headers: dict) -> Tenant:
        auth = headers.get("authorization", "")
        key = auth[7:].strip() if auth.lower().startswith("bearer ") else ""
        tenant = self.tenants.get(key)
        if tenant is None:
            raise _HttpError(401, "unknown or missing API key")
        return tenant

    async def _models(self, writer) -> int:
        await self._send_json(writer, 200, {
            "object": "list",
            "data": [{"id": self.model_id, "object": "model",
                      "owned_by": "paddle_tpu"}]})
        return 200

    async def _metrics(self, writer) -> int:
        """Prometheus text exposition 0.0.4: every gauge with
        ``# HELP``/``# TYPE`` and sanitized names (the per-axis ``.``
        gauges become ``_``), every latency histogram as cumulative
        ``_bucket{le=...}``/``_sum``/``_count`` series. Renders from
        registry snapshots on the loop thread — the scrape never touches
        engine state, so it cannot block a scheduler tick."""
        payload = prometheus_text().encode("utf-8")
        writer.write(self._head(200, {
            "Content-Type": "text/plain; version=0.0.4",
            "Content-Length": str(len(payload)),
            "Connection": "close"}) + payload)
        await writer.drain()
        return 200

    # -- health (k8s-style liveness/readiness probes) ------------------------
    async def _healthz(self, writer) -> int:
        """Liveness: the loop answered, the process serves."""
        await self._send_json(writer, 200, {"status": "ok"})
        return 200

    async def _rank(self, writer) -> int:
        """POST /v1/rank: sparse features to scores through the engine's
        embedding tables. The port has no ranker yet, so it answers as
        the reference does for an engine built without one."""
        raise _HttpError(404, "ranking not enabled on this server")

    def _engine_checks(self) -> dict:
        e = self.engine
        checks: dict = {}
        if hasattr(e, "healthy_replicas"):          # EngineRouter
            healthy = e.healthy_replicas()
            checks["engine_alive"] = bool(healthy)
            # health() carries per-replica warming/draining flags — a
            # lifecycle replacement mid-re-warm is visible but NOT ready
            checks["replicas"] = {str(k): v for k, v in e.health().items()}
            heads = []
            for i in healthy:
                try:
                    heads.append(e.engine_for(i).pool_headroom())
                except KeyError:
                    continue        # removed between snapshot and read
            checks["pool_headroom"] = round(max(heads), 4) if heads else 0.0
            sup = getattr(e, "supervisor", None)
            if sup is not None:
                checks["lifecycle"] = sup.snapshot()
            # fleet membership: host id, role and last-heartbeat age per
            # replica, beside the lifecycle view
            fleet = getattr(e, "fleet_members", None)
            if callable(fleet):
                checks["fleet"] = {str(k): v for k, v in fleet().items()}
        else:
            checks["engine_alive"] = bool(e.alive)
            checks["pool_headroom"] = round(e.pool_headroom(), 4)
        if self._overload is not None:
            checks["brownout"] = self._overload.snapshot()
        return checks

    async def _readyz(self, writer) -> int:
        """Readiness: would a generation request admitted NOW be served?
        Engine (or at least one router replica) alive, block-pool
        headroom left, and the brownout ladder below its shed rungs."""
        checks = self._engine_checks()
        ready = checks["engine_alive"] and checks["pool_headroom"] > 0.0
        if self._overload is not None and self._overload.sheds("bronze"):
            ready = False           # shed rung: stop ADMITTING via the LB
        status = 200 if ready else 503
        await self._send_json(
            writer, status,
            {"status": "ok" if ready else "unready", "checks": checks},
            extra=None if ready else {"Retry-After": "2"})
        return status

    # -- generation ----------------------------------------------------------
    def _chat_prompt(self, messages) -> str:
        """Deterministic flattening: the shared system prompt becomes a
        shared radix-cache PREFIX across every conversation using it."""
        if not isinstance(messages, list) or not messages:
            raise _HttpError(400, "messages must be a non-empty list")
        parts = []
        for m in messages:
            role = str(m.get("role", "user"))
            parts.append(f"{role}: {m.get('content', '')}\n")
        parts.append("assistant:")
        return "".join(parts)

    def _constraint_for(self, body: dict):
        rf = body.get("response_format")
        if not rf:
            return None
        kind = rf.get("type")
        try:
            if kind == "json_schema":
                schema = rf.get("json_schema") or rf.get("schema")
                if isinstance(schema, dict) and "schema" in schema:
                    schema = schema["schema"]   # OpenAI nests it
                key = "s:" + json.dumps(schema, sort_keys=True)
                if key not in self._constraints:
                    self._constraints[key] = compile_constraint(
                        tokenizer=self.engine.tokenizer, json_schema=schema,
                        vocab_size=self.engine.cfg.vocab_size)
                return self._constraints[key]
            if kind == "regex":
                key = "r:" + rf["regex"]
                if key not in self._constraints:
                    self._constraints[key] = compile_constraint(
                        tokenizer=self.engine.tokenizer, regex=rf["regex"],
                        vocab_size=self.engine.cfg.vocab_size)
                return self._constraints[key]
            if kind in (None, "text"):
                return None
        except ValueError as e:
            raise _HttpError(400, f"bad response_format: {e}")
        raise _HttpError(400, f"unsupported response_format type {kind!r}")

    async def _generate(self, tenant: Tenant, raw: bytes, writer, reader,
                        chat: bool) -> int:
        try:
            body = json.loads(raw.decode("utf-8")) if raw else {}
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise _HttpError(400, f"bad JSON body: {e}")
        # -- brownout shed (503, server-side): checked BEFORE the token
        # bucket so a shed never burns the tenant's own budget ----------
        if self._overload is not None and self._overload.sheds(tenant.lane):
            FRONTEND_LOAD_SHEDS.add(1)
            raise _HttpError(
                503, f"overloaded (brownout rung "
                     f"{self._overload.rung_name}): {tenant.lane} lane "
                     "admissions are shed",
                headers={"Retry-After": "2"})
        if chat:
            prompt_ids = self.engine.tokenizer.encode(
                self._chat_prompt(body.get("messages")))
        else:
            prompt = body.get("prompt", "")
            if isinstance(prompt, list):
                prompt_ids = np.asarray(prompt, np.int32)
            else:
                prompt_ids = self.engine.tokenizer.encode(str(prompt))
        if prompt_ids.size < 1:
            raise _HttpError(400, "empty prompt")
        # -- admission: token bucket, then the stream cap ------------------
        retry = tenant.bucket.take()
        if retry > 0:
            FRONTEND_429S.add(1)
            raise _HttpError(
                429, f"tenant {tenant.name} over rate limit",
                headers={"Retry-After": str(max(1, int(retry + 0.999)))})
        if not tenant.acquire_stream():
            FRONTEND_429S.add(1)
            raise _HttpError(
                429, f"tenant {tenant.name} at max_streams "
                     f"({tenant.max_streams})",
                headers={"Retry-After": "1"})
        FRONTEND_REQUESTS.add(1)
        try:
            return await self._generate_admitted(
                tenant, body, prompt_ids, writer, reader, chat)
        finally:
            tenant.release_stream()

    async def _generate_admitted(self, tenant, body, prompt_ids, writer,
                                 reader, chat: bool) -> int:
        max_toks = int(body.get("max_tokens", self.default_max_tokens))
        if self._overload is not None:
            # brownout rung 3: non-gold generations are capped — they
            # finish early instead of holding slots through the storm
            max_toks = self._overload.cap_max_tokens(tenant.lane, max_toks)
        kwargs = dict(
            prompt=prompt_ids,
            max_new_tokens=max_toks,
            temperature=float(body.get("temperature", 0.0)),
            top_k=int(body.get("top_k", 0)),
            top_p=float(body.get("top_p", 1.0)),
            constraint=self._constraint_for(body),
            timeout=60.0)
        # the deadline clock starts at HTTP admission: WFQ lane wait
        # burns it, the engine receives only the remainder (dispatcher),
        # and the response waits below use the remainder too
        deadline_t = None
        if body.get("deadline_s") is not None:
            deadline_t = time.monotonic() + float(body["deadline_s"])
        if kwargs["constraint"] is None:
            kwargs["eos_id"] = self.engine.tokenizer.eos_id
        # causal tracing: mint the request's trace context at
        # HTTP admission — the flow-START anchor every downstream span
        # (lane wait, prefill chunks, decode ticks, failover hops) chains
        # from. Minting never touches sampling: tracing-off token
        # streams are pinned bit-identical.
        ctx = mint_trace()
        kwargs["trace"] = ctx
        if recording():
            t = time.perf_counter()
            emit_flow("s", ctx.trace_id, t)
            emit_complete("frontend.admission", t, 0.0, cat="frontend",
                          args=ctx.args(tenant=tenant.name,
                                        lane=tenant.lane,
                                        prompt_tokens=int(prompt_ids.size)))
        cost = max(1.0, -(-int(prompt_ids.size) // self._chunk))
        fut = asyncio.get_running_loop().create_future()
        self._wfq.put(tenant.lane, cost,
                      _Job(tenant, kwargs, fut, deadline_t=deadline_t))
        try:
            req, wait_ms = await fut
        except QueueFull as e:
            FRONTEND_LOAD_SHEDS.add(1)
            raise _HttpError(503, f"engine queue saturated: {e}",
                             headers={"Retry-After": "1"})
        except _Shed as e:
            FRONTEND_LOAD_SHEDS.add(1)
            raise _HttpError(503, str(e), headers={"Retry-After": "1"})
        qw_args = {"tenant": tenant.name, "lane": tenant.lane,
                   "wait_ms": wait_ms,
                   "prompt_tokens": int(prompt_ids.size)}
        if recording():
            qw_args.update(ctx.args())
        with span("frontend.queue_wait", cat="frontend", args=qw_args,
                  flow=ctx.trace_id):
            pass
        rid = f"cmpl-{uuid.uuid4().hex[:20]}"
        created = int(datetime.now(timezone.utc).timestamp())
        if body.get("stream"):
            return await self._stream_response(req, writer, rid, created,
                                               chat, reader, deadline_t)
        loop = asyncio.get_running_loop()
        finish = None
        try:
            tokens = await loop.run_in_executor(
                None, lambda: req.result(timeout=self._wait_s(deadline_t)))
        except TimeoutError:
            # the WAIT lapsed (deadline or default cap): cancel so the
            # engine releases the slot/blocks, answer with what exists
            req.cancel()
            tokens = list(req.tokens)
            finish = "timeout"
        finish = finish or req.finish_reason
        if finish in ("deadline", "timeout") and not tokens:
            # expired before the first token: a shed, not a result —
            # 503 + Retry-After, never a silent empty 200
            FRONTEND_LOAD_SHEDS.add(1)
            raise _HttpError(503, "deadline exceeded before generation "
                                  "started", headers={"Retry-After": "1"})
        text = self.engine.tokenizer.decode(tokens, skip_special=True)
        choice = {"index": 0, "finish_reason": finish,
                  "logprobs": None}
        if chat:
            choice["message"] = {"role": "assistant", "content": text}
            obj_type = "chat.completion"
        else:
            choice["text"] = text
            obj_type = "text_completion"
        await self._send_json(writer, 200, {
            "id": rid, "object": obj_type, "created": created,
            "model": self.model_id, "choices": [choice],
            "usage": {"prompt_tokens": int(prompt_ids.size),
                      "completion_tokens": len(tokens),
                      "total_tokens": int(prompt_ids.size) + len(tokens)}})
        return 200

    def _wait_s(self, deadline_t: Optional[float]) -> float:
        """Response-wait budget: the request's REMAINING deadline, or
        the configured default for deadline-less requests."""
        if deadline_t is None:
            return self.default_timeout_s
        return max(1e-3, deadline_t - time.monotonic())

    @staticmethod
    async def _watch_disconnect(reader) -> None:
        """Resolves when the CLIENT goes away: EOF or reset on the
        connection's read side. Any stray pipelined bytes are drained
        and ignored — SSE clients do not speak mid-stream."""
        try:
            while True:
                data = await reader.read(4096)
                if not data:
                    return
        except ConnectionError:
            return

    # -- SSE streaming -------------------------------------------------------
    async def _stream_response(self, req, writer, rid: str, created: int,
                               chat: bool, reader,
                               deadline_t: Optional[float] = None) -> int:
        writer.write(self._head(200, {
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
            "Transfer-Encoding": "chunked",
            "Connection": "close"}))
        await writer.drain()
        loop = asyncio.get_running_loop()
        queue: asyncio.Queue = asyncio.Queue()
        wait_s = self._wait_s(deadline_t)

        def pump():
            """Executor thread: blockingly iterate the token stream and
            hand text pieces to the loop (utf-8-safe via the engine's
            streaming detokenizer)."""
            try:
                try:
                    for piece in req.stream_text(timeout=wait_s):
                        loop.call_soon_threadsafe(queue.put_nowait,
                                                  ("piece", piece))
                    loop.call_soon_threadsafe(queue.put_nowait,
                                              ("done", req.finish_reason))
                except TimeoutError:
                    # the wait (deadline remainder) lapsed between
                    # tokens: cancel and close the stream cleanly
                    req.cancel()
                    loop.call_soon_threadsafe(queue.put_nowait,
                                              ("done", "timeout"))
            except Exception as e:  # noqa: BLE001 — surface in-stream
                try:
                    loop.call_soon_threadsafe(queue.put_nowait, ("err", e))
                except RuntimeError:
                    pass                # loop already closed

        task = loop.run_in_executor(None, pump)
        # disconnect watcher: an SSE client that vanishes must CANCEL
        # its engine request (slot + paged blocks + prefix refs) instead
        # of leaving it decoding to nobody
        eof = asyncio.ensure_future(self._watch_disconnect(reader))
        # conn_drop chaos spec: the front end aborts this connection
        # after its first piece — the deterministic stand-in for the
        # vanished client above
        self._conn_seq += 1
        drop = _faults.ENABLED[0] \
            and _faults.FAULTS.take_conn(self._conn_seq) is not None
        if drop:
            FAULTS_INJECTED.add()
        sent = 0
        obj_type = "chat.completion.chunk" if chat else "text_completion"
        try:
            while True:
                getter = asyncio.ensure_future(queue.get())
                done, _ = await asyncio.wait(
                    {getter, eof}, return_when=asyncio.FIRST_COMPLETED)
                if eof in done and getter not in done:
                    getter.cancel()
                    raise ConnectionResetError("client disconnected "
                                               "mid-stream")
                kind, payload = await getter
                if kind == "piece":
                    if chat:
                        choice = {"index": 0, "finish_reason": None,
                                  "delta": {"content": payload}}
                    else:
                        choice = {"index": 0, "finish_reason": None,
                                  "text": payload}
                    await self._sse(writer, {
                        "id": rid, "object": obj_type, "created": created,
                        "model": self.model_id, "choices": [choice]})
                    sent += 1
                    if drop and sent >= 1:
                        writer.transport.abort()
                        raise ConnectionResetError("injected conn_drop")
                elif kind == "done":
                    choice = {"index": 0, "finish_reason": payload}
                    if chat:
                        choice["delta"] = {}
                    else:
                        choice["text"] = ""
                    await self._sse(writer, {
                        "id": rid, "object": obj_type, "created": created,
                        "model": self.model_id, "choices": [choice]})
                    await self._sse_raw(writer, b"data: [DONE]\n\n")
                    break
                else:
                    await self._sse(writer, {"error": {
                        "message": f"{type(payload).__name__}: {payload}"}})
                    break
            writer.write(b"0\r\n\r\n")      # chunked terminator
            await writer.drain()
        except ConnectionError:
            # client is gone: cancel so the engine evicts the stream and
            # returns its slot, paged blocks and prefix-tree references
            req.cancel()
        finally:
            eof.cancel()
            if not task.done():
                await asyncio.wait([task])
        return 200

    async def _sse(self, writer, obj: dict) -> None:
        await self._sse_raw(
            writer, b"data: " + json.dumps(obj).encode("utf-8") + b"\n\n")

    @staticmethod
    async def _sse_raw(writer, payload: bytes) -> None:
        writer.write(f"{len(payload):x}\r\n".encode("latin-1") + payload
                     + b"\r\n")
        await writer.drain()


# ==========================================================================
# python -m paddle_tpu_torch.serving.frontend
# ==========================================================================

def _demo_engine(paged: bool = True, prefix: bool = True, device=None):
    """A gpt_tiny engine with the byte tokenizer: the zero-config demo
    target (swap in real weights by constructing ServingFrontend
    directly). ``device`` None is the card, and raises without one."""
    import torch

    from ..models.gpt import gpt_init, gpt_tiny
    from .engine import InferenceEngine
    from .tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    cfg = gpt_tiny(seq_len=256, vocab_size=512, dtype=torch.float32)
    params = gpt_init(cfg, seed=0, device=device)
    return InferenceEngine(cfg, params, n_slots=8, paged=paged,
                           block_size=16, prefill_chunk=64,
                           prefix_cache=prefix and paged, tokenizer=tok,
                           device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="paddle_tpu_torch.serving.frontend",
        description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--api-key", default="demo-key",
                    help="single-tenant API key (use ServingFrontend "
                         "programmatically for a real tenant table)")
    ap.add_argument("--lane", default="silver",
                    choices=sorted(LANE_WEIGHTS))
    ap.add_argument("--rate", type=float, default=10.0)
    ap.add_argument("--no-prefix-cache", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device of the engine (default: the card; "
                         "'cpu' runs every kernel's plain version)")
    args = ap.parse_args(argv)

    engine = _demo_engine(prefix=not args.no_prefix_cache,
                          device=args.device)
    fe = ServingFrontend(
        engine, tenants=[Tenant("default", args.api_key, rate=args.rate,
                                lane=args.lane)],
        host=args.host, port=args.port)
    fe.start()
    print(f"serving {fe.model_id} on http://{fe.host}:{fe.port} "
          f"(key: {args.api_key}, device: {engine.device})", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        fe.close()
        engine.shutdown(drain=False)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
