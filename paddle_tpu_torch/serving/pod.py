"""Cross-host serving fleet with disaggregated prefill/decode (the port of
``paddle_tpu/serving/pod.py``).

The in-process serving stack — :class:`~.router.EngineRouter` affinity +
token-replay failover, :class:`~.lifecycle.ReplicaSupervisor`, the
overload ladder, the HTTP front end — tops out at one Python process,
because every replica is an in-process :class:`~.engine.InferenceEngine`.
This module carries the SAME replica protocol across hosts:

- :class:`FleetRegistry` — host registration/heartbeat records over
  :class:`~paddle_tpu_torch.distributed.elastic.FileKVStore`
  (binary-framed ``put_bytes`` records, put-retry and partition
  tolerance, and a monotonic payload-change staleness discipline —
  wall-clock skew between hosts cannot kill a live one).
- :class:`HostAgent` — runs on each host: owns that host's engines,
  serves them over a :class:`~.rpc.RpcServer` (submit / long-poll wait /
  adopt / health / KV export + import / ensure_replicas), heartbeats the
  registry.
- :class:`RemoteReplica` — the client-side proxy. It exposes the
  in-process engine surface (``submit``/``adopt_request``/``alive``/
  ``tick_age``/``pool_headroom``/``warm_prefix``/…), so EngineRouter,
  ReplicaSupervisor and the frontend compose UNCHANGED. Each submitted
  request gets a local :class:`~.engine.GenerationRequest` mirror fed by
  a per-request pump thread long-polling the host; a transport death
  finishes the mirror with ``error``, which fires the router failover
  hook — the token-identical replay adoption, now across hosts.
- :class:`FleetRouter` — an EngineRouter that also: watches the registry
  and turns a lost host into immediate re-routes of its open streams
  (``fleet_reroutes``); offers returned hosts to the supervisor's
  per-(host, replica) quarantine ladder (``note_host_offer``); and runs
  the **disaggregated submit path**: long prompts prefill on a
  prefill-ROLE replica, whose finished KV blocks stream back (serialized
  pool rows, bf16-safe over the RPC blob channel) and splice into the
  chosen decode replica's radix tree via the refcounted block machinery
  — so a plain ``submit`` then hits the prefix cache and decode ticks
  never stall on a long prompt. Identity rides the prefix-splice
  guarantee: streamed-KV output is token-identical to a monolithic
  engine, greedy and sampled. The blocks leave the card only on the
  engine's scheduler thread (``export_kv_range`` copies them to host
  tensors there) and enter it the same way (``import_kv_chunk``): the
  RPC threads carry host bytes, bf16 as its raw 16-bit words.
- :class:`ArrivalRateForecaster` / :class:`FleetScheduler` — assigns
  roles, sizes pools per phase, and pre-warms decode replicas from the
  measured arrival rate (``fleet_arrival_gap_ms``) instead of reacting
  to brownout rungs after the storm arrives.

Per-host flight-recorder dumps are named by host (monitor/flight.py), so
``tools/trace_report.py`` ``merge_traces`` stitches a fleet incident
into one timeline; its ``fleet`` section reads the spans this module
emits (``fleet.members`` / ``fleet.kv_stream`` / ``fleet.direct`` /
``fleet.host_lost`` / ``fleet.prewarm``).

Locking: registry state under ``FleetRegistry._lock``,
agent request-registry under ``HostAgent._lock``, proxy open-stream map
and health cache under ``RemoteReplica._lock``, fleet host sets under
``FleetRouter._fleet_lock`` — and no method calls out of the module
while holding any of them, so no ordering cycle with the router lock or
a request's condition variable is possible.
"""
from __future__ import annotations

import collections
import json
import math
import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from ..monitor.flight import dump_flight, get_flight_recorder
from ..monitor.stats import (FLEET_ARRIVAL_GAP_MS, FLEET_DIRECT_FALLBACKS,
                             FLEET_HOSTS, FLEET_KV_CHUNKS_STREAMED,
                             FLEET_KV_EXPORTS, FLEET_KV_IMPORTS,
                             FLEET_KV_RESUME_TAILS, FLEET_KV_TRANSFER_BYTES,
                             FLEET_KV_TRANSFER_MS, FLEET_PREFILL_ROUTED,
                             FLEET_PREWARMS, FLEET_REPLICAS, FLEET_REROUTES,
                             FLIGHT_COLLECTS, stat_snapshot)
from ..monitor.trace import emit_complete, recording
from .engine import ERROR, LENGTH, GenerationRequest, QueueFull
from .router import EngineRouter
from .rpc import (BREAKER_OPEN, CircuitBreaker, RetryPolicy, RpcClient,
                  RpcError, RpcRemoteError, RpcServer)

__all__ = ["FleetRegistry", "HostAgent", "RemoteReplica",
           "RemoteReplicaError", "FleetRouter", "FleetScheduler",
           "ArrivalRateForecaster", "connect_fleet"]


class RemoteReplicaError(RuntimeError):
    """Carried as a mirrored request's ``error`` when the remote side
    failed it (or its host stopped answering) — the failover trigger."""


# ===========================================================================
# registry
# ===========================================================================
class FleetRegistry:
    """Host registration/heartbeat over the shared FileKVStore.

    Records live under ``fleet/<job>/hosts/<host>`` as framed binary
    JSON (:meth:`FileKVStore.put_bytes` — checksummed, so a torn NFS
    read is detected, never consumed). Liveness follows the elastic
    trainers' discipline: a host is alive while its record PAYLOAD keeps
    changing within ``ttl`` seconds of this observer's monotonic clock —
    each heartbeat bumps a ``seq`` counter, so identical-payload
    staleness cannot false-positive, and wall-clock skew is irrelevant.
    """

    def __init__(self, store, job: str, ttl: float = 2.0):
        self.store = store
        self.job = str(job)
        self.ttl = float(ttl)
        self._lock = threading.Lock()      # guards _seen
        self._seen: Dict[str, tuple] = {}  # host -> (payload, first_mono)

    def _key(self, host: str) -> str:
        return f"fleet/{self.job}/hosts/{host}"

    def _dir(self) -> str:
        return f"fleet/{self.job}/hosts/"

    def announce(self, host: str, record: dict) -> None:
        """Write/refresh a host's record (put-retry rides along; an
        OSError after the retry budget means partition — callers skip
        the beat and try again)."""
        self.store.put_bytes(self._key(host),
                             json.dumps(record, sort_keys=True).encode())

    def retire(self, host: str) -> None:
        """Graceful deregistration (host loss is the OTHER path: the
        record simply stops changing and ages out)."""
        self.store.delete(self._key(host))

    def alive(self) -> Dict[str, dict]:
        """{host: record} for every host whose record changed within
        ``ttl``. Raises OSError under an injected/real partition — the
        fleet monitor skips that scan rather than declaring hosts dead
        on a blind round."""
        listed = self.store.get_prefix(self._dir())
        now = time.monotonic()
        out: Dict[str, dict] = {}
        for key in listed:
            host = key.rsplit("/", 1)[-1]
            try:
                payload = self.store.get_bytes(self._key(host))
            except ValueError:
                continue                   # torn frame: miss one round
            if payload is None:
                continue
            with self._lock:
                prev = self._seen.get(host)
                if prev is None or prev[0] != payload:
                    self._seen[host] = (payload, now)
                    fresh = True
                else:
                    fresh = (now - prev[1]) <= self.ttl
            if fresh:
                try:
                    out[host] = json.loads(payload)
                except (ValueError, UnicodeDecodeError):
                    continue
        return out


# ===========================================================================
# host agent (server side)
# ===========================================================================
class HostAgent:
    """One per host: owns the host's engines and serves the replica
    protocol over RPC.

    ``factory()`` builds one engine (same config/params/seed on every
    host — the sameness that makes cross-host failover exact, identical
    to the in-process router contract). ``role`` is ``"prefill"``,
    ``"decode"`` or ``"mixed"`` and rides the registry record so
    :func:`connect_fleet` can wire the disaggregated path.
    """

    def __init__(self, store, job: str, host: str, factory,
                 n_replicas: int = 1, role: str = "mixed",
                 listen_host: str = "127.0.0.1", port: int = 0,
                 heartbeat_s: float = 0.25, registry_ttl: float = 2.0):
        if role not in ("prefill", "decode", "mixed"):
            raise ValueError(f"unknown fleet role {role!r}")
        self.host = str(host)
        self.role = role
        self.factory = factory
        self.heartbeat_s = float(heartbeat_s)
        self._lock = threading.Lock()      # guards _engines/_reqs/_hseq/_seq
        self._engines: List[object] = []
        self._reqs: Dict[int, GenerationRequest] = {}
        self._hseq = 0
        self._seq = 0
        for _ in range(max(1, int(n_replicas))):
            self._spawn_engine()
        self._server = RpcServer(self._handlers(), host=listen_host,
                                 port=port)
        self.addr = self._server.addr
        self.registry = FleetRegistry(store, job, ttl=registry_ttl)
        self._closed_event = threading.Event()
        self.announce()                    # visible before the first beat
        self._hb = threading.Thread(target=self._heartbeat_loop,
                                    name="fleet-heartbeat", daemon=True)
        self._hb.start()

    # -- engines -------------------------------------------------------------
    def _spawn_engine(self):
        eng = self.factory()
        eng.host = self.host               # the supervisor's (host, replica)
        eng.role = self.role               # ladder and fleet membership
        with self._lock:
            self._engines.append(eng)
        return eng

    def _engine(self, idx: int):
        with self._lock:
            try:
                return self._engines[int(idx)]
            except IndexError:
                raise KeyError(f"host {self.host} has no replica "
                               f"index {idx}") from None

    def _describe(self) -> List[dict]:
        with self._lock:
            engines = list(self._engines)
        out = []
        for i, e in enumerate(engines):
            out.append({"idx": i, "block_size": int(e.block_size),
                        "prefill_chunk": int(e.prefill_chunk),
                        "n_slots": int(e.n_slots),
                        "max_len": int(e.max_len),
                        "vocab_size": int(e.cfg.vocab_size),
                        "prefix": getattr(e, "_prefix", None) is not None,
                        "tokenizer": type(e.tokenizer).__name__
                        if getattr(e, "tokenizer", None) is not None
                        else None})
        return out

    # -- registry heartbeat --------------------------------------------------
    def announce(self) -> None:
        with self._lock:
            self._seq += 1
            record = {"host": self.host, "role": self.role,
                      "addr": list(self.addr),
                      "replicas": len(self._engines), "seq": self._seq}
        try:
            self.registry.announce(self.host, record)
        except OSError:
            pass                           # partition: next beat retries

    def _heartbeat_loop(self) -> None:
        while not self._closed_event.wait(self.heartbeat_s):
            self.announce()

    # -- request registry ----------------------------------------------------
    def _register(self, req: GenerationRequest) -> int:
        with self._lock:
            self._hseq += 1
            hid = self._hseq
            self._reqs[hid] = req
        return hid

    def _req(self, hid: int) -> GenerationRequest:
        with self._lock:
            req = self._reqs.get(int(hid))
        if req is None:
            raise KeyError(f"unknown or finished request handle {hid}")
        return req

    # -- rpc handlers --------------------------------------------------------
    def _handlers(self) -> dict:
        return {"hello": self._h_hello, "submit": self._h_submit,
                "wait": self._h_wait, "cancel": self._h_cancel,
                "adopt": self._h_adopt, "health": self._h_health,
                "warm": self._h_warm,
                "prefill_export": self._h_prefill_export,
                "import_kv": self._h_import_kv,
                "prefill_start": self._h_prefill_start,
                "export_range": self._h_export_range,
                "import_chunk": self._h_import_chunk,
                "collect_flight": self._h_collect_flight,
                "ensure_replicas": self._h_ensure_replicas,
                "evacuate": self._h_evacuate,
                "fail_replica": self._h_fail_replica,
                "shutdown_replica": self._h_shutdown_replica}

    def _h_hello(self, p, arrays):
        return {"host": self.host, "role": self.role,
                "replicas": self._describe()}

    def _h_submit(self, p, arrays):
        eng = self._engine(p["idx"])
        req = eng.submit(
            prompt=arrays["prompt"],
            max_new_tokens=int(p.get("max_new_tokens", 32)),
            temperature=float(p.get("temperature", 0.0)),
            top_k=int(p.get("top_k", 0)), top_p=float(p.get("top_p", 1.0)),
            eos_id=p.get("eos_id"), deadline_s=p.get("deadline_s"),
            block=bool(p.get("block", True)), timeout=p.get("timeout"))
        return {"hid": self._register(req), "rid": int(req.rid)}

    def _h_adopt(self, p, arrays):
        eng = self._engine(p["idx"])
        deadline = p.get("deadline_s")
        req = GenerationRequest(
            arrays["prompt"], int(p.get("max_new_tokens", 32)),
            float(p.get("temperature", 0.0)), int(p.get("top_k", 0)),
            float(p.get("top_p", 1.0)), p.get("eos_id"),
            None if deadline is None else time.monotonic() + deadline)
        req.rid = int(p["rid"])
        req.tokens = [int(t) for t in p.get("tokens", ())]
        eng.adopt_request(req)
        return {"hid": self._register(req), "rid": int(req.rid)}

    def _h_wait(self, p, arrays):
        hid = int(p["hid"])
        req = self._req(hid)
        cursor = int(p.get("cursor", 0))
        timeout = float(p.get("timeout", 1.0))
        with req._cv:
            req._cv.wait_for(lambda: len(req.tokens) > cursor
                             or req.finish_reason is not None, timeout)
            fresh = [int(t) for t in req.tokens[cursor:]]
            reason = req.finish_reason
            err = req.error
        done = reason is not None
        if done:
            with self._lock:               # one done report retires the
                self._reqs.pop(hid, None)  # handle — no registry leak
        return {"tokens": fresh, "done": done, "finish_reason": reason,
                "error": None if err is None
                else f"{type(err).__name__}: {err}"}

    def _h_cancel(self, p, arrays):
        try:
            self._req(int(p["hid"])).cancel()
        except KeyError:
            pass                           # already finished: cancel is moot
        return {"ok": True}

    def _h_health(self, p, arrays):
        eng = self._engine(p.get("idx", 0))
        return {"alive": bool(eng.alive), "busy": bool(eng.busy),
                "tick_age_s": float(eng.tick_age()),
                "pool_headroom": float(eng.pool_headroom()),
                "queue_depth": int(eng.queue_depth),
                "occupancy": int(eng.occupancy)}

    def _h_warm(self, p, arrays):
        eng = self._engine(p["idx"])
        eng.warm_prefix(arrays["prompt"]).result(
            timeout=p.get("timeout", 120.0))
        return {"ok": True}

    def _h_prefill_export(self, p, arrays):
        """Chunked-prefill the prompt (radix-warm, dedup against what the
        tree already holds) and ship the finished KV blocks."""
        eng = self._engine(p["idx"])
        ids = np.asarray(arrays["prompt"], np.int32).reshape(-1)
        if getattr(eng, "_prefix", None) is None:
            raise RuntimeError("prefill export needs prefix_cache=True")
        have = eng.run_on_scheduler(
            lambda e: e._prefix.peek(ids))
        if have < ids.size - 1:
            eng.warm_prefix(ids).result(timeout=p.get("timeout", 120.0))
        exp = eng.export_kv_prefix(ids)
        if exp is None:
            return {"matched_len": 0}
        FLEET_KV_EXPORTS.add(1)
        meta = {"matched_len": exp["matched_len"],
                "block_size": exp["block_size"], "dtype": exp["dtype"]}
        return meta, {"kb": exp["kb"], "vb": exp["vb"]}

    def _h_import_kv(self, p, arrays):
        eng = self._engine(p["idx"])
        cached = eng.import_kv_prefix(arrays["prompt"], arrays["kb"],
                                      arrays["vb"],
                                      int(p["matched_len"]))
        if cached > 0:
            FLEET_KV_IMPORTS.add(1)
        return {"cached": int(cached)}

    # -- resumable chunked KV streaming -------------------------------------
    def _h_prefill_start(self, p, arrays):
        """Kick off a NON-blocking radix warm of the prompt so finished
        chunks can ship (``export_range``) while later chunks compute —
        the overlap half of resumable streaming. Returns the stream
        target (``len-1``, the splice cap) and what is already cached."""
        eng = self._engine(p["idx"])
        ids = np.asarray(arrays["prompt"], np.int32).reshape(-1)
        if getattr(eng, "_prefix", None) is None:
            raise RuntimeError("prefill streaming needs prefix_cache=True")
        have = eng.run_on_scheduler(
            lambda e: e._prefix.peek(ids))
        if have < ids.size - 1:
            eng.warm_prefix(ids)           # runs behind this reply
        return {"target": int(ids.size - 1), "have": int(have)}

    def _h_export_range(self, p, arrays):
        """One stream chunk: blocks from ``start_block`` onward. Waits
        server-side (bounded by ``wait_s``) for at least one new block so
        the client polls the network, not the prefill — a slow chunk
        costs one parked RPC, not a spin."""
        eng = self._engine(p["idx"])
        ids = np.asarray(arrays["prompt"], np.int32).reshape(-1)
        start = int(p.get("start_block", 0))
        max_blocks = p.get("max_blocks")
        deadline = time.monotonic() + float(p.get("wait_s", 1.0))
        while True:
            exp = eng.export_kv_range(ids, start, max_blocks=max_blocks)
            if exp["n_blocks"] > 0 or exp["done"] \
                    or time.monotonic() >= deadline:
                break
            time.sleep(0.01)
        meta = {k: exp[k] for k in ("matched_len", "start_block",
                                    "n_blocks", "block_size", "done",
                                    "covered_tokens")}
        if exp["n_blocks"] <= 0:
            return meta
        FLEET_KV_EXPORTS.add(1)
        return meta, {"kb": exp["kb"], "vb": exp["vb"]}

    def _h_import_chunk(self, p, arrays):
        """Splice one streamed chunk; the returned ``have`` is the ack
        high-water mark the sender resumes from."""
        eng = self._engine(p["idx"])
        have = eng.import_kv_chunk(arrays["prompt"], arrays["kb"],
                                   arrays["vb"], int(p["start_block"]),
                                   int(p["n_tokens"]))
        if have > 0:
            FLEET_KV_IMPORTS.add(1)
        return {"have": int(have)}

    def _h_collect_flight(self, p, arrays):
        """Ship this host's FlightRecorder ring + gauge snapshot to the
        collecting router (fleet-wide post-mortem). Unarmed
        hosts answer honestly instead of erroring — a gap in the merged
        timeline, never a hang."""
        rec = get_flight_recorder()
        if rec is None:
            return {"armed": False, "host": self.host, "pid": os.getpid()}
        rec.note_gauges()
        return {"armed": True, "host": self.host, "pid": rec.pid,
                "events": rec.events(), "gauges": stat_snapshot()}

    def _h_ensure_replicas(self, p, arrays):
        """Pre-warm path: grow this host to ``n`` replicas (never
        shrinks — drain-shrink stays a router/supervisor decision)."""
        n = int(p["n"])
        with self._lock:
            have = len(self._engines)
        for _ in range(max(0, n - have)):
            self._spawn_engine()
        self.announce()
        return {"replicas": self._describe()}

    def _h_evacuate(self, p, arrays):
        self._engine(p["idx"]).evacuate()
        return {"ok": True}

    def _h_fail_replica(self, p, arrays):
        self._engine(p["idx"]).fail_at_tick(int(p.get("ticks", 1)))
        return {"ok": True}

    def _h_shutdown_replica(self, p, arrays):
        self._engine(p["idx"]).shutdown(drain=bool(p.get("drain", True)),
                                        timeout=p.get("timeout", 30.0))
        return {"ok": True}

    # -- lifecycle -----------------------------------------------------------
    def close(self, abrupt: bool = False) -> None:
        """Stop serving. ``abrupt=True`` is the host-loss simulation: no
        deregistration, no engine drain — the record just goes stale and
        open sockets die, exactly what a crashed host looks like."""
        self._closed_event.set()
        self._server.close()
        with self._lock:
            engines = list(self._engines)
        if not abrupt:
            for e in engines:
                try:
                    e.shutdown(drain=False, timeout=30)
                except RuntimeError:
                    pass
            try:
                self.registry.retire(self.host)
            except OSError:
                pass
        self._hb.join(timeout=2.0)


# ===========================================================================
# remote replica proxy (client side)
# ===========================================================================
class _RemoteCfg:
    """Just enough of a model config for the router's validation and the
    frontend's metadata endpoints."""

    def __init__(self, vocab_size: int):
        self.vocab_size = int(vocab_size)


class RemoteReplica:
    """Engine-protocol proxy for one replica on another host.

    Submit mirrors the stream locally: tokens arrive through a
    per-request pump thread long-polling the host, pushed into a local
    :class:`GenerationRequest` via the same ``_push``/``_finish`` calls
    the in-process scheduler makes — so ``stream()``/``result()``/SSE
    and the router failover hook behave identically. A transport death
    fails every open mirror with :class:`RemoteReplicaError`, which the
    failover hook turns into adoption by a survivor (token-identical
    replay — rid and seed ride along).
    """

    def __init__(self, client: RpcClient, idx: int, info: dict, host: str,
                 role: str = "mixed", poll_s: float = 1.0,
                 health_ttl: float = 0.2):
        self._client = client
        self.idx = int(idx)
        self.host = str(host)
        self.role = str(role)
        self.poll_s = float(poll_s)
        self.health_ttl = float(health_ttl)
        self.block_size = int(info["block_size"])
        self.prefill_chunk = int(info["prefill_chunk"])
        self.n_slots = int(info["n_slots"])
        self.max_len = int(info["max_len"])
        self.cfg = _RemoteCfg(info["vocab_size"])
        # truthy when the remote engine caches prefixes: arms the
        # router's affinity map exactly like a local radix tree would
        self._prefix = True if info.get("prefix") else None
        # a STATELESS remote tokenizer reconstructs locally, so the
        # router/frontend text surface works over a fleet; stateful
        # tokenizers stay None (text encodes nowhere — ids only)
        if info.get("tokenizer") == "ByteTokenizer":
            from .tokenizer import ByteTokenizer

            self.tokenizer = ByteTokenizer()
        else:
            self.tokenizer = None
        self.overload = None
        self.replica_id = None             # router-assigned
        self.failover = None               # router-installed
        self._lock = threading.Lock()      # guards _open/_lost/health cache
        self._open: Dict[int, GenerationRequest] = {}
        self._lost = False
        self._health_cache: Optional[dict] = None
        self._health_t = 0.0
        self._rid = 0                      # protocol compat (rids live
        self._cv = threading.Condition()   # on the remote engine)

    # -- submission ----------------------------------------------------------
    def submit(self, prompt=None, max_new_tokens: int = 32,
               temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
               eos_id=None, deadline_s=None, block: bool = True,
               timeout=None, text=None, constraint=None, trace=None):
        if text is not None:
            raise ValueError("RemoteReplica takes token ids — the router "
                             "encodes text before placement")
        if constraint is not None:
            raise ValueError("constrained decoding does not cross the "
                             "RPC boundary")
        ids = np.asarray(prompt, np.int32).reshape(-1)
        req = GenerationRequest(
            ids, max_new_tokens, temperature, top_k, top_p, eos_id,
            None if deadline_s is None else time.monotonic() + deadline_s)
        req.trace = trace
        req._tokenizer = self.tokenizer    # arms text()/stream_text()
        params = {"idx": self.idx, "max_new_tokens": int(max_new_tokens),
                  "temperature": float(temperature), "top_k": int(top_k),
                  "top_p": float(top_p), "eos_id": eos_id,
                  "deadline_s": deadline_s, "block": bool(block),
                  "timeout": timeout}
        rpc_budget = self._client.timeout + (timeout or 0.0)
        try:
            res, _ = self._client.call("submit", params, {"prompt": ids},
                                       timeout=rpc_budget)
        except RpcRemoteError as e:
            if e.etype == "QueueFull":
                raise QueueFull(str(e)) from e
            raise
        except RpcError as e:
            # transport death mid-submit: this replica is unroutable
            # until proven otherwise — mark it lost so open streams
            # reroute and the router re-places the submit elsewhere
            self._mark_lost(e)
            raise
        req.rid = int(res["rid"])
        req._failover = self.failover
        req._t_submit = time.monotonic()
        self._start_pump(int(res["hid"]), req)
        return req

    def adopt_request(self, req: GenerationRequest) -> None:
        """Failover adoption over RPC: the remote engine replays
        ``prompt + tokens[:-1]`` under the request's original rid (the
        preemption-resume contract), and the SAME local mirror keeps
        accumulating — the user's handle never changes."""
        deadline_s = None if req.deadline is None \
            else max(0.0, req.deadline - time.monotonic())
        params = {"idx": self.idx, "rid": int(req.rid),
                  "max_new_tokens": int(req.max_new_tokens),
                  "temperature": float(req.temperature),
                  "top_k": int(req.top_k), "top_p": float(req.top_p),
                  "eos_id": req.eos_id, "deadline_s": deadline_s,
                  "tokens": [int(t) for t in req.tokens]}
        res, _ = self._client.call("adopt", params, {"prompt": req.prompt})
        req._failover = self.failover
        req._t_submit = time.monotonic()
        self._start_pump(int(res["hid"]), req)

    def generate(self, prompt=None, **kw):
        return self.submit(prompt, **kw).result()

    # -- the stream pump -----------------------------------------------------
    def _start_pump(self, hid: int, req: GenerationRequest) -> None:
        with self._lock:
            if self._lost:
                raise RuntimeError(f"replica on host {self.host} is lost")
            self._open[hid] = req
        threading.Thread(target=self._pump, args=(hid, req),
                         name="fleet-pump", daemon=True).start()

    def _pump(self, hid: int, req: GenerationRequest) -> None:
        cursor = len(req.tokens)
        cancel_sent = False
        while True:
            with self._lock:
                if hid not in self._open:
                    return                 # host-loss path owns this stream
            if req._cancelled and not cancel_sent:
                try:
                    self._client.call("cancel", {"hid": hid},
                                      timeout=self.poll_s)
                except RpcError:
                    pass
                cancel_sent = True
            try:
                res, _ = self._client.call(
                    "wait", {"hid": hid, "cursor": cursor,
                             "timeout": self.poll_s},
                    timeout=self.poll_s + self._client.timeout)
            except RpcError as e:
                self._mark_lost(e)
                return
            except RpcRemoteError as e:
                self._finish_owned(hid, req, ERROR, RemoteReplicaError(
                    f"remote wait failed: {e}"))
                return
            fresh = res.get("tokens") or []
            for t in fresh:
                req._push(int(t))
            cursor += len(fresh)
            if res.get("done"):
                err_s = res.get("error")
                self._finish_owned(
                    hid, req, res.get("finish_reason") or ERROR,
                    RemoteReplicaError(err_s) if err_s else None)
                return

    def _finish_owned(self, hid: int, req: GenerationRequest, reason: str,
                      err: Optional[BaseException]) -> None:
        with self._lock:
            owned = self._open.pop(hid, None) is not None
        if owned:
            req._finish(reason, err)

    def _mark_lost(self, err: Optional[BaseException] = None) -> int:
        """Transport death / registry host-loss: fail every open mirror
        (each ``error`` finish offers the stream to the router failover
        hook first — adoption, not loss). Idempotent."""
        with self._lock:
            if self._lost:
                return 0
            self._lost = True
            open_reqs = list(self._open.items())
            self._open.clear()
        cause = err if err is not None else RemoteReplicaError(
            f"host {self.host} lost")
        for _, req in open_reqs:
            FLEET_REROUTES.add(1)
            req._finish(ERROR, cause)
        return len(open_reqs)

    # -- health surface ------------------------------------------------------
    def _health(self) -> Optional[dict]:
        now = time.monotonic()
        with self._lock:
            if self._lost:
                return None
            cache, t = self._health_cache, self._health_t
        if cache is not None and now - t < self.health_ttl:
            return cache
        try:
            res, _ = self._client.call("health", {"idx": self.idx},
                                       timeout=self.health_ttl + 2.0)
        except (RpcError, RpcRemoteError) as e:
            self._mark_lost(e)
            return None
        with self._lock:
            self._health_cache, self._health_t = res, time.monotonic()
        return res

    @property
    def alive(self) -> bool:
        h = self._health()
        return bool(h and h.get("alive"))

    @property
    def busy(self) -> bool:
        h = self._health()
        return bool(h and h.get("busy"))

    def tick_age(self) -> float:
        h = self._health()
        return float(h["tick_age_s"]) if h else float("inf")

    def pool_headroom(self) -> float:
        h = self._health()
        return float(h["pool_headroom"]) if h else 0.0

    @property
    def queue_depth(self) -> int:
        h = self._health()
        return int(h["queue_depth"]) if h else 0

    @property
    def occupancy(self) -> int:
        h = self._health()
        return int(h["occupancy"]) if h else 0

    def heartbeat_age(self) -> float:
        """Seconds since this proxy last heard from its host — the
        fleet-membership staleness the frontend's ``checks.fleet``
        reports."""
        with self._lock:
            t = self._health_t
        return float("inf") if t == 0.0 else time.monotonic() - t

    # -- lifecycle / kv streaming -------------------------------------------
    def warm_prefix(self, prompt) -> GenerationRequest:
        ids = np.asarray(prompt, np.int32).reshape(-1)
        req = GenerationRequest(ids, 1, 0.0, 0, 1.0, None, None)
        try:
            self._client.call("warm", {"idx": self.idx}, {"prompt": ids},
                              timeout=self._client.timeout + 120.0)
            req.finish_reason = LENGTH
        except (RpcError, RpcRemoteError) as e:
            req.finish_reason = ERROR
            req.error = e
        return req

    def export_kv_prefix(self, tokens, timeout=None):
        ids = np.asarray(tokens, np.int32).reshape(-1)
        res, arrs = self._client.call(
            "prefill_export", {"idx": self.idx, "timeout": timeout},
            {"prompt": ids}, timeout=self._client.timeout + 120.0)
        if not res or int(res.get("matched_len", 0)) <= 0:
            return None
        return {"matched_len": int(res["matched_len"]),
                "block_size": int(res["block_size"]),
                "dtype": res.get("dtype"), "shape": list(arrs["kb"].shape),
                "kb": arrs["kb"], "vb": arrs["vb"]}

    def import_kv_prefix(self, tokens, kb, vb, matched_len: int,
                         timeout=None) -> int:
        ids = np.asarray(tokens, np.int32).reshape(-1)
        res, _ = self._client.call(
            "import_kv", {"idx": self.idx, "matched_len": int(matched_len)},
            {"prompt": ids, "kb": kb, "vb": vb},
            timeout=self._client.timeout + 60.0)
        return int(res.get("cached", 0))

    def prefill_start(self, tokens, timeout=None) -> dict:
        """Start a non-blocking remote radix warm for chunk streaming;
        returns ``{"target", "have"}``."""
        ids = np.asarray(tokens, np.int32).reshape(-1)
        res, _ = self._client.call(
            "prefill_start", {"idx": self.idx, "timeout": timeout},
            {"prompt": ids}, timeout=self._client.timeout + 30.0)
        return res

    def export_kv_range(self, tokens, start_block: int, max_blocks=None,
                        wait_s: float = 1.0, timeout=None) -> dict:
        ids = np.asarray(tokens, np.int32).reshape(-1)
        res, arrs = self._client.call(
            "export_range", {"idx": self.idx,
                             "start_block": int(start_block),
                             "max_blocks": max_blocks,
                             "wait_s": float(wait_s)},
            {"prompt": ids},
            timeout=(timeout or self._client.timeout) + float(wait_s))
        out = dict(res)
        if arrs:
            out["kb"], out["vb"] = arrs["kb"], arrs["vb"]
        return out

    def import_kv_chunk(self, tokens, kb, vb, start_block: int,
                        n_tokens: int, timeout=None) -> int:
        """Chunk splice with blob crc armed — a corrupt-in-flight KV
        chunk fails the call instead of caching wrong rows."""
        ids = np.asarray(tokens, np.int32).reshape(-1)
        res, _ = self._client.call(
            "import_chunk", {"idx": self.idx,
                             "start_block": int(start_block),
                             "n_tokens": int(n_tokens)},
            {"prompt": ids, "kb": kb, "vb": vb},
            timeout=(timeout or self._client.timeout) + 60.0, crc=True)
        return int(res.get("have", 0))

    def collect_flight(self, timeout: float = 2.0) -> dict:
        res, _ = self._client.call("collect_flight", {}, timeout=timeout)
        return res

    def evacuate(self) -> None:
        try:
            self._client.call("evacuate", {"idx": self.idx})
        except (RpcError, RpcRemoteError) as e:
            self._mark_lost(e)

    def fail_at_tick(self, ticks_ahead: int = 1) -> None:
        self._client.call("fail_replica", {"idx": self.idx,
                                           "ticks": int(ticks_ahead)})

    def shutdown(self, drain: bool = True, timeout=None) -> None:
        """Shut the REMOTE replica down (the fleet owner closing its
        router tears the fleet down), then detach the proxy."""
        try:
            self._client.call("shutdown_replica",
                              {"idx": self.idx, "drain": bool(drain),
                               "timeout": timeout},
                              timeout=(timeout or 30.0)
                              + self._client.timeout)
        except (RpcError, RpcRemoteError):
            pass
        self._mark_lost(RemoteReplicaError(
            f"replica {self.replica_id} on {self.host} shut down"))

    def __repr__(self):
        return (f"RemoteReplica(host={self.host!r}, idx={self.idx}, "
                f"role={self.role!r}, lost={self._lost})")


# ===========================================================================
# arrival forecasting + fleet scheduling
# ===========================================================================
class ArrivalRateForecaster:
    """Measured request arrival rate. Every fleet submission lands one
    inter-arrival gap in ``fleet_arrival_gap_ms`` (the histogram the
    trace reports read) and one timestamp in a sliding window;
    :meth:`rps` is the windowed rate — the pre-warm signal that replaces
    react-to-brownout scaling."""

    def __init__(self, window_s: float = 5.0, max_samples: int = 512):
        self.window_s = float(window_s)
        self._lock = threading.Lock()      # guards _times
        self._times: collections.deque = collections.deque(
            maxlen=int(max_samples))

    def note_arrival(self) -> None:
        now = time.monotonic()
        with self._lock:
            if self._times:
                FLEET_ARRIVAL_GAP_MS.observe((now - self._times[-1]) * 1e3)
            self._times.append(now)

    def rps(self) -> float:
        now = time.monotonic()
        with self._lock:
            xs = [t for t in self._times if now - t <= self.window_s]
        if len(xs) < 2:
            return 0.0
        return (len(xs) - 1) / max(1e-6, xs[-1] - xs[0])


class FleetScheduler:
    """Role assignment, per-phase pool sizing, and predictive pre-warm.

    - :meth:`plan_roles` — with one host everything is ``mixed``; with
      more, the first (sorted) host runs prefill and the rest decode.
    - :meth:`pool_plan` — prefill pools trade slots for blocks (few
      concurrent prompts, many block-rows in flight) and take the
      largest chunk; decode pools keep the slots.
    - the pre-warm loop — every ``poll_s``, compare the forecast rps
      against ``rps_per_replica`` x current healthy decode replicas and
      ask decode hosts for more BEFORE the brownout ladder would have
      noticed (``fleet_prewarms`` counts additions).
    """

    def __init__(self, router: "FleetRouter",
                 rps_per_replica: float = 8.0, poll_s: float = 0.5,
                 max_replicas: int = 8):
        self.router = router
        self.rps_per_replica = float(rps_per_replica)
        self.poll_s = float(poll_s)
        self.max_replicas = int(max_replicas)
        router.scheduler = self
        self._stop_event = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name="fleet-scheduler", daemon=True)
        self._thread.start()

    @staticmethod
    def plan_roles(hosts) -> Dict[str, str]:
        hosts = sorted(str(h) for h in hosts)
        if len(hosts) < 2:
            return {h: "mixed" for h in hosts}
        return {h: ("prefill" if i == 0 else "decode")
                for i, h in enumerate(hosts)}

    @staticmethod
    def pool_plan(role: str, n_slots: int = 4, block_size: int = 16,
                  n_blocks: Optional[int] = None,
                  prefill_chunk: int = 64) -> dict:
        """Engine kwargs for one phase's pool; merge into the host's
        factory kwargs."""
        if role == "prefill":
            return {"n_slots": max(1, n_slots // 2),
                    "block_size": block_size,
                    "n_blocks": n_blocks if n_blocks is None
                    else int(n_blocks * 2),
                    "prefill_chunk": max(prefill_chunk, 4 * block_size)}
        return {"n_slots": n_slots, "block_size": block_size,
                "n_blocks": n_blocks, "prefill_chunk": prefill_chunk}

    def desired_replicas(self, rps: float) -> int:
        return min(self.max_replicas,
                   max(1, math.ceil(rps / self.rps_per_replica)))

    def _loop(self) -> None:
        while not self._stop_event.wait(self.poll_s):
            try:
                self.scan()
            except (RpcError, RpcRemoteError, OSError):
                continue                   # transient: next poll retries

    def scan(self) -> int:
        """One pre-warm decision; returns replicas added."""
        rps = self.router._forecaster.rps()
        need = self.desired_replicas(rps)
        have = len(self.router.healthy_replicas())
        if need <= have:
            return 0
        return self.router.prewarm(need - have)

    def close(self) -> None:
        self._stop_event.set()
        self._thread.join(timeout=2.0)


# ===========================================================================
# fleet router
# ===========================================================================
class FleetRouter(EngineRouter):
    """EngineRouter over a cross-host fleet: registry-driven host-loss
    re-routing, supervisor host offers, predictive pre-warm, and the
    disaggregated prefill->decode KV-streaming submit path. With no
    registry and no prefill pool it IS an EngineRouter."""

    def __init__(self, engines, prefill=None, registry: Optional[
            FleetRegistry] = None, host_conns: Optional[dict] = None,
            disagg_min_tokens: Optional[int] = None,
            monitor_poll_s: float = 0.25,
            kv_chunk_blocks: Optional[int] = None, **kw):
        super().__init__(engines, **kw)
        self._prefill_pool: List[RemoteReplica] = list(prefill or [])
        self.registry = registry
        # host -> (client, record): connections the pre-warm path grows
        # replicas through (and shutdown closes)
        self._host_conns: Dict[str, tuple] = dict(host_conns or {})
        self._forecaster = ArrivalRateForecaster()
        self.scheduler: Optional[FleetScheduler] = None
        if disagg_min_tokens is None and self._prefill_pool:
            disagg_min_tokens = 2 * self._prefill_pool[0].block_size
        self._disagg_min = disagg_min_tokens
        # cap blocks per streamed chunk (None = all available): smaller
        # chunks start the decode splice sooner and bound per-frame size
        self.kv_chunk_blocks = kv_chunk_blocks
        self.monitor_poll_s = float(monitor_poll_s)
        self._fleet_lock = threading.Lock()  # guards _hosts_known/_lost
        self._hosts_known: set = set()
        self._lost_hosts: set = set()
        self._members_sig = None           # last fleet.members span payload
        # "registry unreachable" is NOT "hosts dead": track
        # the partition window so /readyz can report unknowable honestly
        self._registry_down_t = 0.0
        self._storm_latched = False        # breaker-storm collect episode
        self._collect_seq = 0
        self._collect_last_t = 0.0
        self.last_stream_stats: Optional[dict] = None
        self._monitor_stop = threading.Event()
        self._monitor = None
        if registry is not None:
            self._monitor = threading.Thread(target=self._fleet_monitor,
                                             name="fleet-monitor",
                                             daemon=True)
            self._monitor.start()

    # -- membership surface (EngineRouter's, plus the prefill pool, which
    # -- takes no decode traffic)
    def fleet_members(self) -> Dict:
        out = super().fleet_members()
        for j, pf in enumerate(self._prefill_pool):
            out[f"prefill/{j}"] = {
                "host": pf.host, "role": pf.role,
                "heartbeat_age_s": round(pf.heartbeat_age(), 3)}
        with self._fleet_lock:
            down_t = self._registry_down_t
            lost = set(self._lost_hosts)
        # per-member verdicts distinguish "host dead"
        # (heartbeat stale while the registry answers) from "registry
        # unreachable" (partition — nothing about hosts is knowable, so
        # say that rather than marking the fleet down)
        for m in out.values():
            host = m.get("host")
            if host is None:
                m["status"] = "ok"         # in-process replica
            elif down_t:
                m["status"] = "unknowable"
            elif host in lost:
                m["status"] = "dead"
            else:
                m["status"] = "ok"
        out["registry"] = {
            "reachable": down_t == 0.0,
            "unreachable_for_s": 0.0 if down_t == 0.0
            else round(time.monotonic() - down_t, 3)}
        return out

    # -- host-loss monitor ---------------------------------------------------
    def _fleet_monitor(self) -> None:
        while not self._monitor_stop.wait(self.monitor_poll_s):
            self.fleet_scan()
            self._check_breaker_storm()

    def _check_breaker_storm(self) -> None:
        """Half the fleet's breakers open at once is a NETWORK incident,
        not a host incident — pull the black boxes while they're hot.
        Episode-latched: one collection per storm, re-armed only after
        the breakers recover."""
        conns = self._host_conns
        if not conns:
            return
        n_open = sum(1 for _, (c, _r) in conns.items()
                     if c.breaker is not None
                     and c.breaker.state == BREAKER_OPEN)
        storm = n_open >= max(1, (len(conns) + 1) // 2)
        if storm and not self._storm_latched:
            self._storm_latched = True
            self.collect_flight_async(f"breaker_storm_{n_open}open")
        elif not storm:
            self._storm_latched = False

    def fleet_scan(self) -> None:
        """One registry scan: detect lost/returned hosts and act."""
        try:
            alive = self.registry.alive()
        except OSError:
            with self._fleet_lock:         # partition: no blind verdicts,
                if self._registry_down_t == 0.0:   # but note the window
                    self._registry_down_t = time.monotonic()
            return
        with self._fleet_lock:
            self._registry_down_t = 0.0
        members = {h: {"role": r.get("role", "mixed"),
                       "replicas": int(r.get("replicas", 0))}
                   for h, r in sorted(alive.items())}
        sig = tuple(sorted((h, m["role"], m["replicas"])
                           for h, m in members.items()))
        with self._fleet_lock:
            self._hosts_known |= set(alive)
            newly_lost = self._hosts_known - set(alive) - self._lost_hosts
            returned = set(alive) & self._lost_hosts
            self._lost_hosts |= newly_lost
            self._lost_hosts -= returned
            changed = sig != self._members_sig
            self._members_sig = sig
        FLEET_HOSTS.set(len(alive))
        FLEET_REPLICAS.set(self.n_replicas)
        if changed and recording():
            # membership snapshot for tools/trace_report.py's fleet
            # section: one row per registered host, on every change
            emit_complete("fleet.members", time.perf_counter(), 0.0,
                          cat="serving", args={"hosts": members})
        for host in sorted(newly_lost):
            self._host_lost(host)
        for host in sorted(returned):
            self._host_returned(host)

    def _proxies_of(self, host: str) -> List[RemoteReplica]:
        out = [e for e in self.engines
               if isinstance(e, RemoteReplica) and e.host == host]
        out += [p for p in self._prefill_pool if p.host == host]
        return out

    def _host_lost(self, host: str) -> None:
        rerouted = 0
        for proxy in self._proxies_of(host):
            rerouted += proxy._mark_lost(RemoteReplicaError(
                f"host {host} lost (heartbeat stale)"))
        if recording():
            emit_complete("fleet.host_lost", time.perf_counter(), 0.0,
                          cat="serving",
                          args={"host": host, "rerouted": rerouted})
        # losing a host is a fleet incident: pull every survivor's black
        # box while the evidence is still in the rings (never blocks the
        # monitor — collection runs on its own thread)
        self.collect_flight_async(f"host_lost_{host}")

    def _host_returned(self, host: str) -> None:
        """A host the monitor declared lost is heartbeating again: offer
        it to the supervisor so a quarantined replica id is retried on
        the returned host's clean ladder instead of serving out the dead
        host's sentence."""
        sup = self.supervisor
        if sup is None or not hasattr(sup, "note_host_offer"):
            return
        for rid, st in sup.snapshot().get("replicas", {}).items():
            if st.get("state") in ("pending", "quarantined"):
                sup.note_host_offer(int(rid), host)

    # -- predictive pre-warm -------------------------------------------------
    def prewarm(self, n: int) -> int:
        """Grow the decode pool by ``n`` replicas across connected
        decode/mixed hosts; returns how many were added."""
        added = 0
        for host, (client, record) in sorted(self._host_conns.items()):
            if added >= n or record.get("role") == "prefill":
                continue
            with self._fleet_lock:
                if host in self._lost_hosts:
                    continue
            known = {e.idx for e in self.engines
                     if isinstance(e, RemoteReplica) and e.host == host}
            want = len(known) + min(n - added, 1)
            try:
                res, _ = client.call("ensure_replicas", {"n": want})
            except (RpcError, RpcRemoteError):
                continue
            for info in res["replicas"]:
                if info["idx"] in known:
                    continue
                proxy = RemoteReplica(client, info["idx"], info, host,
                                      role=record.get("role", "mixed"))
                self.add_replica(proxy)
                added += 1
        if added:
            FLEET_PREWARMS.add(added)
            if recording():
                emit_complete("fleet.prewarm", time.perf_counter(), 0.0,
                              cat="serving", args={"added": added})
        return added

    # -- disaggregated submission --------------------------------------------
    def _healthy_prefill(self) -> Optional[RemoteReplica]:
        for pf in self._prefill_pool:
            with pf._lock:
                lost = pf._lost
            if not lost:
                return pf
        return None

    def submit(self, prompt=None, text: Optional[str] = None, **kw):
        if text is not None:
            if prompt is not None:
                raise ValueError("pass prompt OR text, not both")
            if self.tokenizer is None:
                raise ValueError("submit(text=...) needs engines built "
                                 "with a tokenizer")
            prompt = self.tokenizer.encode(text)
            if kw.get("eos_id") is None:
                kw["eos_id"] = self.tokenizer.eos_id
        if prompt is None:
            raise ValueError("provide a prompt (token ids) or text")
        ids = np.asarray(prompt, np.int32).reshape(-1)
        self._forecaster.note_arrival()
        if self._prefill_pool and self._disagg_min is not None \
                and ids.size >= self._disagg_min:
            req = self._submit_disagg(ids, kw)
            if req is not None:
                return req
        # a submit that dies on the wire is re-PLACED on a different
        # healthy replica — never retried on the same one (submit is not
        # idempotent: a frame that died after delivery would
        # double-generate). The failed proxy marks itself lost, so its
        # open streams reroute and placement stops offering it; worst
        # case is one orphaned generation on a partitioned-but-alive
        # host, never a dropped or duplicated stream on ours.
        last: Optional[BaseException] = None
        for _ in range(max(2, len(self._host_conns) + 1)):
            try:
                return super().submit(prompt=ids, **kw)
            except RpcRemoteError:
                raise                  # the handler refused; host is fine
            except RpcError as e:
                last = e
        raise last

    def _fallback(self, reason: str) -> None:
        """Disagg bailed out: count it and leave the reason in the
        trace so the fleet report can rank fallback causes."""
        FLEET_DIRECT_FALLBACKS.add(1)
        if recording():
            emit_complete("fleet.direct", time.perf_counter(), 0.0,
                          cat="serving", args={"reason": reason})

    def _submit_disagg(self, ids: np.ndarray, kw: dict,
                       stream_budget_s: float = 120.0):
        """Prefill on a prefill-role replica, streaming each finished
        chunk's KV blocks into the chosen decode replica WHILE the next
        chunk computes (sequence-numbered by start block; the receiver's
        ack high-water mark drives resume), then submit there — the
        submit hits the freshly-spliced prefix, so decode never runs the
        long prompt's prefill. A prefill host dying MID-stream is not a
        failure: decode keeps the received prefix and its own chunked
        prefill computes only the missing tail (``fleet_kv_resume_tails``)
        — token-identical either way, because everything rides the pinned
        radix-splice guarantee. Only a stream that delivered NOTHING falls
        back to the monolithic path (``fleet_direct_fallbacks``) —
        disaggregation is an optimization, never a correctness
        dependency."""
        pf = self._healthy_prefill()
        target = self.place(ids)
        if pf is None or target is None:
            if self._prefill_pool:
                self._fallback("no_prefill_host" if pf is None
                               else "no_decode_target")
            return None
        eng = self.engine_for(target)
        if getattr(eng, "_prefix", None) is None:
            self._fallback("target_without_prefix_cache")
            return None
        t0 = time.monotonic()
        try:
            start = pf.prefill_start(ids)
        except (RpcError, RpcRemoteError, RuntimeError):
            self._fallback("prefill_start_failed")
            return None
        bs = int(pf.block_size)
        stream_target = int(start["target"])
        deadline = t0 + float(stream_budget_s)
        ack = chunks = nbytes = 0
        first_block_ms = None
        resumed = False
        while ack < stream_target and time.monotonic() < deadline:
            try:
                exp = pf.export_kv_range(ids, start_block=ack // bs,
                                         max_blocks=self.kv_chunk_blocks,
                                         wait_s=1.0)
            except (RpcError, RpcRemoteError):
                # prefill host died mid-transfer: keep what we have —
                # decode's own prefill covers only the missing tail
                resumed = ack > 0
                break
            if exp["n_blocks"] <= 0:
                if exp["done"] and int(exp["matched_len"]) <= ack:
                    break                  # nothing more will ever come
                continue                   # server waited; poll again
            try:
                got = eng.import_kv_chunk(ids, exp["kb"], exp["vb"],
                                          int(exp["start_block"]),
                                          int(exp["covered_tokens"]))
            except (RpcError, RpcRemoteError, RuntimeError, ValueError):
                break                      # decode refused: stop streaming
            chunks += 1
            FLEET_KV_CHUNKS_STREAMED.add(1)
            nbytes += int(exp["kb"].nbytes) + int(exp["vb"].nbytes)
            if first_block_ms is None:
                first_block_ms = (time.monotonic() - t0) * 1e3
            if got <= ack:
                break                      # no progress (pool full): stop
            ack = got
            if exp["done"] and ack >= int(exp["matched_len"]):
                break
        if ack <= 0:
            self._fallback("prefill_stream_failed" if chunks == 0
                           else "decode_import_failed")
            return None
        if resumed:
            FLEET_KV_RESUME_TAILS.add(1)
        dt_ms = (time.monotonic() - t0) * 1e3
        FLEET_KV_TRANSFER_MS.observe(dt_ms)
        FLEET_KV_TRANSFER_BYTES.add(nbytes)
        FLEET_PREFILL_ROUTED.add(1)
        self.last_stream_stats = {
            "first_block_ms": first_block_ms, "total_ms": dt_ms,
            "chunks": chunks, "acked_tokens": int(ack),
            "target_tokens": stream_target, "resumed": resumed}
        if recording():
            emit_complete("fleet.kv_stream", time.perf_counter(),
                          dt_ms / 1e3, cat="serving",
                          args={"bytes": nbytes, "ms": round(dt_ms, 3),
                                "matched": int(ack), "chunks": chunks,
                                "first_block_ms": None
                                if first_block_ms is None
                                else round(first_block_ms, 3),
                                "resumed": resumed,
                                "prefill_host": pf.host,
                                "decode_replica": int(target)})
        try:
            req = eng.submit(prompt=ids, **kw)
        except (RpcError, RuntimeError):
            self._fallback("decode_submit_failed")
            return None
        req._replica = target
        self._affinity_note(ids, target)
        return req

    # -- fleet-wide flight collection ----------------------------------------
    def collect_flight(self, reason: str, trace_dir: Optional[str] = None,
                       timeout: float = 2.0) -> dict:
        """Pull every reachable host's FlightRecorder ring over RPC into
        flight-format files next to the router's own dump, so
        ``tools/trace_report.py merge_traces`` stitches the incident into
        one fleet timeline. Unreachable hosts become recorded gaps —
        collection is bounded by ``timeout`` per host and never hangs on
        the very failure it is documenting."""
        rec = get_flight_recorder()
        d = trace_dir or (rec.trace_dir if rec is not None else None)
        safe = "".join(c if c.isalnum() or c in "-_" else "_"
                       for c in str(reason))[:48] or "collect"
        paths, hosts_ok, gaps, unarmed = [], [], [], []
        local = dump_flight(f"fleet_{safe}", trace_dir=d)
        if local:
            paths.append(local)
        with self._fleet_lock:
            self._collect_seq += 1
            seq = self._collect_seq
        for host, (client, _record) in sorted(self._host_conns.items()):
            try:
                res, _ = client.call("collect_flight", {}, timeout=timeout)
            except (RpcError, RpcRemoteError):
                gaps.append(host)
                continue
            if not res.get("armed"):
                unarmed.append(host)
                continue
            hosts_ok.append(host)
            if not d:
                continue
            pid = int(res.get("pid", 0))
            events = list(res.get("events") or ())
            payload = {
                "traceEvents": events + [
                    {"name": "process_name", "ph": "M", "pid": pid,
                     "args": {"name": f"{host} pid={pid}"}}],
                "displayTimeUnit": "ms",
                "flight": {"reason": f"fleet_{safe}", "host": host,
                           "pid": pid, "seq": seq, "events": len(events),
                           "collected_by": "fleet-router",
                           "gauges": res.get("gauges", {})},
            }
            try:
                os.makedirs(d, exist_ok=True)
                path = os.path.join(
                    d, f"flight_{host}_{pid}_c{seq:03d}_{safe}.json")
                with open(path, "w") as f:
                    json.dump(payload, f)
                paths.append(path)
            except OSError:
                gaps.append(host)          # disk trouble ≈ lost dump
        FLIGHT_COLLECTS.add(1)
        if recording():
            emit_complete("fleet.collect", time.perf_counter(), 0.0,
                          cat="serving",
                          args={"reason": str(reason),
                                "hosts_ok": hosts_ok, "gaps": gaps,
                                "unarmed": unarmed})
        return {"reason": str(reason), "hosts": hosts_ok, "gaps": gaps,
                "unarmed": unarmed, "paths": paths}

    def collect_flight_async(self, reason: str,
                             min_gap_s: float = 5.0) -> bool:
        """Fire-and-forget :meth:`collect_flight` on a daemon thread —
        the form every trigger that holds a lock (supervisor give-up,
        host-loss monitor) must use. Rate-limited so an incident storm
        produces one collection, not one per symptom."""
        now = time.monotonic()
        with self._fleet_lock:
            if now - self._collect_last_t < float(min_gap_s):
                return False
            self._collect_last_t = now
        threading.Thread(target=lambda: self.collect_flight(reason),
                         name="fleet-collect", daemon=True).start()
        return True

    # -- lifecycle -----------------------------------------------------------
    def shutdown(self, drain: bool = True, timeout=None) -> None:
        self._monitor_stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=2.0)
        if self.scheduler is not None:
            self.scheduler.close()
        for pf in self._prefill_pool:
            pf.shutdown(drain=False, timeout=timeout)
        super().shutdown(drain=drain, timeout=timeout)
        for _, (client, _rec) in sorted(self._host_conns.items()):
            client.close()


# ===========================================================================
# discovery
# ===========================================================================
def connect_fleet(store, job: str, min_hosts: int = 1,
                  timeout: float = 30.0, registry_ttl: float = 2.0,
                  rpc_timeout: float = 30.0, poll_s: float = 1.0,
                  client_host: str = "router",
                  retry: Optional[RetryPolicy] = None,
                  breaker_threshold: int = 3,
                  breaker_cooldown_s: float = 2.0,
                  **router_kw) -> FleetRouter:
    """Discover the fleet from the shared store and build a
    :class:`FleetRouter` over it: one RPC connection per host, one
    :class:`RemoteReplica` per (host, replica), prefill-role hosts into
    the KV-streaming pool and everyone else into the routable decode
    set. Blocks until ``min_hosts`` hosts are registered.

    Every host connection is armed with the reliability layer:
    ``retry`` (default :class:`RetryPolicy` — idempotent-only,
    deterministic backoff; pass ``RetryPolicy(max_attempts=1)`` to
    disable) and a per-peer :class:`CircuitBreaker` (``breaker_threshold``
    consecutive transport errors open it, half-open probe after
    ``breaker_cooldown_s``). ``client_host`` names this endpoint for
    ``net_partition`` fault matching."""
    registry = FleetRegistry(store, job, ttl=registry_ttl)
    deadline = time.monotonic() + timeout
    alive: Dict[str, dict] = {}
    while time.monotonic() < deadline:
        try:
            alive = registry.alive()
        except OSError:
            alive = {}
        if len(alive) >= min_hosts:
            break
        time.sleep(0.05)
    if len(alive) < min_hosts:
        raise TimeoutError(
            f"fleet {job!r}: {len(alive)}/{min_hosts} hosts registered "
            f"after {timeout}s")
    if retry is None:
        retry = RetryPolicy()
    decode, prefill, conns = [], [], {}
    for host, record in sorted(alive.items()):
        client = RpcClient(
            tuple(record["addr"]), timeout=rpc_timeout, retry=retry,
            breaker=CircuitBreaker(threshold=breaker_threshold,
                                   cooldown_s=breaker_cooldown_s,
                                   peer=host),
            peer_host=host, local_host=client_host)
        hello, _ = client.call("hello")
        conns[host] = (client, record)
        role = hello.get("role", record.get("role", "mixed"))
        for info in hello["replicas"]:
            proxy = RemoteReplica(client, info["idx"], info, host,
                                  role=role, poll_s=poll_s)
            (prefill if role == "prefill" else decode).append(proxy)
    if not decode:
        raise RuntimeError(f"fleet {job!r} has no decode-capable host "
                           "(every registered host is prefill-role)")
    return FleetRouter(decode, prefill=prefill, registry=registry,
                       host_conns=conns, **router_kw)
