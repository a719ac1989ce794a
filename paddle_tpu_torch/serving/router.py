"""Replicated-engine router with failover and a dynamic replica set (the
port of ``paddle_tpu/serving/router.py``).

One :class:`~paddle_tpu_torch.serving.engine.InferenceEngine` is one
failure domain: a poisoned batch, a wedged scheduler or an exhausted
watchdog budget takes every open stream with it. :class:`EngineRouter`
fronts N replicas (same config, same params, same ``seed``: that sameness
is what makes failover exact) and gives the traffic layer one ``submit``
surface with three behaviours a single engine cannot offer:

**Placement**: each request routes to the replica with the longest cached
radix prefix match for its prompt (a shared system prompt keeps landing
where its blocks already live), falling back to least-loaded (queue depth
+ slot occupancy) when no replica holds a match. The router tracks prefix
residency in its own block-aligned LRU map, updated as it routes, rather
than walking the engines' radix trees from outside their scheduler
threads (those structures are scheduler-owned).

**Health**: a replica is routable while its scheduler thread is alive,
not shut down, not crash-errored (the watchdog's restart-budget
exhaustion lands here), not WARMING (a supervisor's replacement replaying
its prefix re-warm is registered but takes no live traffic until
``mark_ready``), not DRAINING (a scale-down victim finishes or migrates
its open streams but places nothing new), and its tick-age heartbeat is
fresh: an engine with open work whose scheduler has not begun a loop
iteration within ``tick_age_budget_s`` is wedged and gets no NEW work
(its open streams are left to its own watchdog and deadlines: a stall is
not proof of death, and serving a stream twice would be worse than
waiting).

**Failover**: when a replica's scheduler DIES (crash, injected
``replica_crash``, watchdog budget exhaustion, ``evacuate()``), every
open request it would have failed with ``error`` is intercepted through
the request's failover hook and ADOPTED by a survivor through the
preemption-resume contract: re-prefill ``prompt + generated[:-1]``,
restore the last token, continue. The request id (its RNG stream) and
the shared seed ride along, so the survivor's continuation is
token-identical to the run the dead replica would have given, greedy and
sampled. Only requests the watchdog marked poisoned (finish_reason
``"watchdog"``) fail. ``router_failovers`` counts adoptions,
``serving_replicas_healthy`` tracks the routable set, and a
``router.replica_down`` zero-duration span records each death.

**Lifecycle**: the replica set is dynamic under the router lock:
:meth:`add_replica` / :meth:`remove_replica` let a
:class:`~paddle_tpu_torch.serving.lifecycle.ReplicaSupervisor` close the
loop between health and capacity (restart and rejoin, autoscale). A
replacement REUSES the dead replica's id: the failover hook is keyed by
(id, engine identity), so a stale incarnation's late death never marks
its successor unroutable. With no survivor left and a supervisor
attached, the router PARKS dying streams as orphans for the replacement
to adopt; without one they fail loudly. When a prefix-caching replica
dies its routed-prefix LRU entries move to a bounded stash that
:meth:`hot_prefixes` serves: the re-warm work-list.

The router is a CLIENT of its engines: it owns no device state and no
thread. Health is evaluated at submit time and failover runs on the
dying replica's scheduler thread as its last act. Lock discipline: one
lock, never held across a call into an engine that can block.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..monitor.stats import ROUTER_FAILOVERS, SERVING_REPLICAS_HEALTHY
from ..monitor.trace import emit_complete, recording

__all__ = ["EngineRouter"]


class EngineRouter:
    """Route ``submit`` calls across replica InferenceEngines.

    ::

        ctl = OverloadController()                    # optional, shared
        engines = [InferenceEngine(cfg, params, seed=0, overload=ctl)
                   for _ in range(2)]
        router = EngineRouter(engines)
        req = router.submit(prompt, max_new_tokens=64)
        req.result()        # survives a replica crash mid-generation

    Replicas must share vocabulary, tokenizer surface and sampling seed
    (identical constructor arguments). The router assigns ``replica_id``
    0..N-1: trace spans and fault specs
    (``replica_crash@step=N:replica=R``) use these ids; a supervisor's
    replacements reuse the id they replace.

    ``tick_age_budget_s``: how stale a BUSY replica's scheduler heartbeat
    may grow before the router stops routing new work to it.

    The front end mounts a router exactly like an engine
    (``ServingFrontend(router)``): tokenizer, config, prefill chunk and
    overload controller are proxied from the replicas, and ``/readyz``
    degrades to "any healthy replica".
    """

    def __init__(self, engines, tick_age_budget_s: float = 5.0,
                 affinity_entries: int = 4096):
        engines = list(engines)
        if not engines:
            raise ValueError("EngineRouter needs at least one engine")
        self.tick_age_budget_s = float(tick_age_budget_s)
        self._lock = threading.Lock()
        # replica id -> engine: the dynamic replica set
        self._replicas: Dict[int, object] = {}
        self._dead: set = set()
        self._warming: set = set()      # registered, re-warming, unroutable
        self._draining: set = set()     # scale-down victims: no placements
        # the attached ReplicaSupervisor (set by its constructor); None:
        # no orphan parking, no lifecycle states
        self.supervisor = None
        # block-aligned prefix -> replica LRU map (module docstring);
        # affinity only matters when some replica caches prefixes
        self._aff_block = None
        self._affinity: "collections.OrderedDict[bytes, int]" = \
            collections.OrderedDict()
        self._aff_cap = int(affinity_entries)
        # prefixes routed to now-dead replicas, most recent last: the
        # supervisor's re-warm work-list (bounded like the live map)
        self._dead_prefixes: "collections.OrderedDict[bytes, None]" = \
            collections.OrderedDict()
        # streams a dying replica could not fail over (no survivors):
        # parked for the supervisor's replacement instead of failed
        self._orphans: List[Tuple[object, Optional[BaseException]]] = []
        for i, e in enumerate(engines):
            self.add_replica(e, replica_id=i)

    # -- front-end-facing proxies --------------------------------------------
    @property
    def engines(self) -> List:
        """Current replica engines (by id); a snapshot: change the set
        through add/remove_replica."""
        with self._lock:
            return [self._replicas[r] for r in sorted(self._replicas)]

    def engine_for(self, replica: int):
        """The engine serving ``replica`` (KeyError once removed)."""
        with self._lock:
            return self._replicas[replica]

    @property
    def _any(self):
        with self._lock:
            return next(iter(self._replicas.values()))

    @property
    def tokenizer(self):
        return self._any.tokenizer

    @property
    def cfg(self):
        return self._any.cfg

    @property
    def prefill_chunk(self):
        return self._any.prefill_chunk

    @property
    def overload(self):
        return self._any.overload

    @property
    def queue_depth(self) -> int:
        return sum(e.queue_depth for e in self.engines)

    @property
    def occupancy(self) -> int:
        return sum(e.occupancy for e in self.engines)

    @property
    def n_replicas(self) -> int:
        with self._lock:
            return len(self._replicas)

    # -- the dynamic replica set ---------------------------------------------
    def _validate_engine(self, engine) -> None:
        # lock held by caller; compare against any sibling
        for e in self._replicas.values():
            if e.cfg.vocab_size != engine.cfg.vocab_size:
                raise ValueError(
                    "replica configs diverge (vocab "
                    f"{engine.cfg.vocab_size} != {e.cfg.vocab_size}) — "
                    "replicas must serve one model")
            break

    def add_replica(self, engine, replica_id: Optional[int] = None,
                    warming: bool = False) -> int:
        """Register ``engine`` under ``replica_id`` (a reused dead id or a
        fresh one; default the smallest unused). ``warming=True`` keeps it
        out of :meth:`healthy_replicas` until :meth:`mark_ready`:
        registered (visible in ``health()`` and readyz) but taking no
        live traffic while its prefix re-warm replays."""
        with self._lock:
            self._validate_engine(engine)
            if replica_id is None:
                replica_id = 0
                while replica_id in self._replicas:
                    replica_id += 1
            replica_id = int(replica_id)
            if replica_id in self._replicas:
                raise ValueError(f"replica id {replica_id} already live")
            engine.replica_id = replica_id
            engine.failover = self._failover_hook(replica_id, engine)
            self._replicas[replica_id] = engine
            self._dead.discard(replica_id)
            self._draining.discard(replica_id)
            if warming:
                self._warming.add(replica_id)
            else:
                self._warming.discard(replica_id)
            if self._aff_block is None \
                    and getattr(engine, "_prefix", None) is not None:
                self._aff_block = int(engine.block_size)
        SERVING_REPLICAS_HEALTHY.set(len(self.healthy_replicas()))
        return replica_id

    def mark_ready(self, replica_id: int) -> None:
        """End a replica's warming phase: it joins the routable set."""
        with self._lock:
            self._warming.discard(int(replica_id))
        SERVING_REPLICAS_HEALTHY.set(len(self.healthy_replicas()))

    def begin_drain(self, replica_id: int) -> None:
        """Stop placing NEW work on a scale-down victim; its open streams
        keep running (and keep their failover hook, so a later
        ``evacuate()`` migrates them to survivors)."""
        with self._lock:
            self._draining.add(int(replica_id))
        SERVING_REPLICAS_HEALTHY.set(len(self.healthy_replicas()))

    def remove_replica(self, replica_id: int):
        """Drop a replica from the set (its failover hook stays armed on
        any streams it still holds). Stashes its routed prefixes for
        re-warm. Returns the removed engine, or None if already gone."""
        replica_id = int(replica_id)
        with self._lock:
            engine = self._replicas.pop(replica_id, None)
            self._dead.discard(replica_id)
            self._warming.discard(replica_id)
            self._draining.discard(replica_id)
            self._purge_affinity(replica_id)
        SERVING_REPLICAS_HEALTHY.set(len(self.healthy_replicas()))
        return engine

    # -- orphan streams (no-survivor deaths, supervisor attached) ------------
    def take_orphans(self) -> List[Tuple[object, Optional[BaseException]]]:
        """Claim every parked (request, error) pair: the supervisor adopts
        them onto the replacement replica."""
        with self._lock:
            out, self._orphans = self._orphans, []
        return out

    def fail_orphans(self, err: Optional[BaseException] = None) -> int:
        """Give-up path: fail every parked stream loudly with its original
        (or the supplied) cause. Returns how many."""
        orphans = self.take_orphans()
        for req, cause in orphans:
            req._finish("error", err if err is not None else cause)
        return len(orphans)

    # -- health --------------------------------------------------------------
    def healthy_replicas(self) -> List[int]:
        """Replica ids the router places NEW work on."""
        with self._lock:
            items = sorted(self._replicas.items())
            unroutable = self._dead | self._warming | self._draining
        out = []
        for i, e in items:
            if i in unroutable or not e.alive:
                continue
            if e.busy and e.tick_age() > self.tick_age_budget_s:
                continue            # wedged: alive but not ticking
            out.append(i)
        return out

    def health(self) -> Dict[int, dict]:
        """Per-replica health view (the /readyz payload)."""
        now_healthy = set(self.healthy_replicas())
        with self._lock:
            items = sorted(self._replicas.items())
            dead, warming = set(self._dead), set(self._warming)
            draining = set(self._draining)
        out = {}
        for i, e in items:
            out[i] = {
                "alive": bool(e.alive), "routable": i in now_healthy,
                "failed_over": i in dead,
                "warming": i in warming,
                "draining": i in draining,
                "tick_age_s": round(e.tick_age(), 3),
                "queue_depth": int(e.queue_depth),
                "occupancy": int(e.occupancy),
                "pool_headroom": round(e.pool_headroom(), 4),
            }
        return out

    def fleet_members(self) -> Dict:
        """Per-replica fleet membership: the host each replica lives on,
        its fleet role and how stale that host's heartbeat is. In-process
        engines report host None, role ``"mixed"`` and age 0.0 (their
        heartbeat is the scheduler tick, which ``health()`` reads). The
        front end joins this into ``/readyz`` as ``checks.fleet``."""
        with self._lock:
            items = sorted(self._replicas.items())
        out = {}
        for i, e in items:
            age = getattr(e, "heartbeat_age", None)
            out[i] = {"host": getattr(e, "host", None),
                      "role": getattr(e, "role", "mixed"),
                      "heartbeat_age_s": round(float(age()), 3)
                      if callable(age) else 0.0}
        return out

    # -- placement -----------------------------------------------------------
    def _load(self, replica: int) -> int:
        e = self.engine_for(replica)
        return int(e.queue_depth) + int(e.occupancy)

    def _affinity_match(self, ids: np.ndarray, healthy) -> Optional[tuple]:
        """Longest block-aligned routed prefix of ``ids`` held by a
        healthy replica -> (replica, matched_tokens)."""
        if self._aff_block is None:
            return None
        B = self._aff_block
        healthy = set(healthy)
        with self._lock:
            for n in range(min(ids.size // B, 64), 0, -1):
                key = ids[:n * B].tobytes()
                rep = self._affinity.get(key)
                if rep is not None and rep in healthy:
                    self._affinity.move_to_end(key)
                    return rep, n * B
        return None

    def _affinity_note(self, ids: np.ndarray, replica: int) -> None:
        if self._aff_block is None \
                or getattr(self.engine_for(replica), "_prefix",
                           None) is None:
            return
        B = self._aff_block
        with self._lock:
            for n in range(1, min(ids.size // B, 64) + 1):
                self._affinity[ids[:n * B].tobytes()] = replica
                self._affinity.move_to_end(ids[:n * B].tobytes())
            while len(self._affinity) > self._aff_cap:
                self._affinity.popitem(last=False)

    def note_routed_prefix(self, ids, replica: int) -> None:
        """The supervisor calls this after re-warming a prefix onto a
        rejoined replica, so placement routes matching prompts there at
        once."""
        self._affinity_note(np.asarray(ids, np.int32).reshape(-1),
                            int(replica))

    def _purge_affinity(self, replica: int) -> None:
        # lock held by caller; the dead replica's routed prefixes move to
        # the re-warm stash (most recent last) instead of vanishing
        stale = [k for k, r in self._affinity.items() if r == replica]
        for k in stale:
            del self._affinity[k]
            self._dead_prefixes[k] = None
            self._dead_prefixes.move_to_end(k)
        while len(self._dead_prefixes) > self._aff_cap:
            self._dead_prefixes.popitem(last=False)

    def hot_prefixes(self, k: int = 4) -> List[np.ndarray]:
        """The top-``k`` hottest routed prefixes (most recent first,
        maximal only: a prefix of a hotter entry is redundant), from the
        dead-replica stash first, then the live affinity map. The
        supervisor's re-warm work-list; empty when no replica caches
        prefixes."""
        with self._lock:
            keys = list(reversed(self._dead_prefixes)) \
                + list(reversed(self._affinity))
        out: List[bytes] = []
        for key in keys:
            if any(kept.startswith(key) for kept in out):
                continue        # a hotter, longer entry already covers it
            out = [kept for kept in out if not key.startswith(kept)]
            out.append(key)     # ...and this one extends any it covers
            if len(out) >= int(k):
                break
        return [np.frombuffer(key, np.int32).copy() for key in out[:int(k)]]

    def place(self, prompt) -> Optional[int]:
        """Replica for this prompt: longest cached prefix match first,
        least-loaded otherwise. None: no healthy replica."""
        healthy = self.healthy_replicas()
        if not healthy:
            return None
        ids = np.asarray(prompt, np.int32).reshape(-1)
        hit = self._affinity_match(ids, healthy)
        if hit is not None:
            return hit[0]
        return min(healthy, key=self._load)

    # -- submission ----------------------------------------------------------
    def submit(self, prompt=None, text: Optional[str] = None, **kw):
        """Route and submit; returns the engine's GenerationRequest.

        Takes the whole ``InferenceEngine.submit`` surface. ``text`` is
        encoded HERE (one tokenizer, shared by contract) so placement
        sees token ids."""
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
        replica = self.place(ids)
        if replica is None:
            raise RuntimeError("EngineRouter: no healthy replica "
                               f"(of {self.n_replicas})")
        req = self.engine_for(replica).submit(prompt=ids, **kw)
        req._replica = replica          # where it lives (failover moves it)
        self._affinity_note(ids, replica)
        return req

    def generate(self, prompt=None, **kw):
        """Blocking convenience wrapper: submit + result."""
        return self.submit(prompt, **kw).result()

    # -- failover ------------------------------------------------------------
    def _failover_hook(self, replica: int, engine):
        def hook(req, err) -> bool:
            return self._replica_failed(replica, engine, req, err)
        return hook

    def _replica_failed(self, replica: int, engine, req, err) -> bool:
        """Runs on the DYING replica's scheduler thread, once per open
        request it is failing. True: the request was adopted by a
        survivor (or parked for the supervisor's replacement), and the
        caller must not finish it."""
        with self._lock:
            # a replacement may have REUSED this id: only the current
            # incarnation's death marks the id dead, a stale engine's late
            # failure must never unroute its successor
            current = self._replicas.get(replica) is engine
            first = current and replica not in self._dead
            if first:
                self._dead.add(replica)
                self._purge_affinity(replica)
        if first:
            SERVING_REPLICAS_HEALTHY.set(len(self.healthy_replicas()))
            if recording():
                emit_complete(
                    "router.replica_down", time.perf_counter(), 0.0,
                    cat="serving",
                    args={"replica": replica,
                          "error": f"{type(err).__name__}: {err}"
                          if err is not None else None})
        survivors = self.healthy_replicas()
        target = min(survivors, key=self._load) if survivors else None
        if target is not None:
            try:
                self.engine_for(target).adopt_request(req)
            except (RuntimeError, KeyError):
                target = None   # the survivor died or left in the window
            else:
                req._replica = target
                ROUTER_FAILOVERS.add(1)
                return True
        if self.supervisor is not None:
            # nobody left to adopt it NOW: park it for the supervisor's
            # replacement (the restart/rejoin path) instead of failing
            with self._lock:
                self._orphans.append((req, err))
            return True
        return False            # no supervisor: the error goes through

    # -- shutdown ------------------------------------------------------------
    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        if self.supervisor is not None:
            self.supervisor.close()
        for e in self.engines:
            e.shutdown(drain=drain, timeout=timeout)
        self.fail_orphans()

    def __repr__(self):
        return (f"EngineRouter(replicas={self.n_replicas}, "
                f"healthy={self.healthy_replicas()})")
