"""Elastic replica lifecycle for serving (the port of
``paddle_tpu/serving/lifecycle.py``).

The :class:`~paddle_tpu_torch.serving.router.EngineRouter` alone only
removes dead replicas, so every crash shrinks capacity for good, and
sustained brownout pressure has no lever but shedding traffic.
:class:`ReplicaSupervisor` closes the loop: it owns an ENGINE FACTORY
(the live replicas' seed, params and config: the sameness that makes
every replay exact) and steers the replica set from the router's health
and the shared :class:`~paddle_tpu_torch.serving.overload.OverloadController`.

**Restart and rejoin.** On replica death (scheduler crash, watchdog
restart-budget exhaustion, a wedged tick age) the supervisor spawns a
replacement through a backoff / quarantine ladder::

    attempt 0              immediate
    attempts 1..Q-1        exponential backoff (backoff_s * 2^(a-1),
                           capped at backoff_cap_s)
    attempts Q..max-1      QUARANTINED (quarantine_s holds: a flapping
                           replica stops burning spawn cycles)
    attempt  max_restarts  give up LOUDLY: orphaned streams fail with
                           the original cause, the slot is marked
                           failed, a lifecycle.give_up span records it

A replica that stays alive ``stable_s`` seconds resets its ladder.
Ladders are keyed by (host, replica id): in a cross-host fleet a healthy
host re-offering a replica id after a host swap starts from ITS OWN
attempt count, and :meth:`ReplicaSupervisor.note_host_offer` makes such a
slot due at once instead of serving out the old host's quarantine. The
replacement registers under the SAME replica id
(:meth:`EngineRouter.add_replica`), its request-id space is bumped past
the dead engine's (new streams never alias an adopted one's RNG stream),
and before it takes live traffic its radix prefix tree is RE-WARMED: the
hottest routed prefixes from the router's affinity LRU (stashed at death)
replay as prefill-only requests (``InferenceEngine.warm_prefix``, a
request-id space above 2**30), so a rejoined replica's first token comes
as fast as a warm one's. While warming, the replica is registered but
not ready (``/readyz`` and ``healthy_replicas`` leave it out). If the
whole set died, the router PARKED the dying streams as orphans: the
replacement adopts them, token-identical, before opening for traffic.

**Autoscaling.** The supervisor polls the shared OverloadController:
``scale_up_after`` consecutive polls at rung >= ``scale_up_rung`` grow the
set toward ``max_replicas`` (spawn, warm, ready: one scale event);
``scale_down_after`` consecutive polls at rung 0 with aggregate occupancy
below ``scale_down_occupancy`` drain and shrink: the victim gets no more
placements (:meth:`EngineRouter.begin_drain`), its open streams finish
within ``drain_timeout_s`` or MIGRATE to survivors through ``evacuate()``
and the adopt_request replay (token-identical), then the engine shuts
down. The asymmetric counts mirror the brownout ladder's hysteresis, and
``scale_cooldown_s`` separates consecutive scale events.

Chaos: ``spawn_fail@restart=N[:times=K]`` makes the factory raise on the
Nth spawn attempt (exercising the ladder), and
``replica_flap@restart=N[:times=K]`` crashes each freshly rejoined
replica at its next busy scheduler tick, both keyed by the supervisor's
OWN spawn and rejoin counters (``FaultRegistry.take_restart``).

Gauges: ``serving_replicas_target`` (the steered count),
``serving_replica_restarts``, ``serving_scale_events``,
``prefix_warm_tokens``. Spans: ``lifecycle.restart`` (cause, attempt),
``lifecycle.rejoin`` (warm stats), ``lifecycle.quarantine``,
``lifecycle.give_up``, ``lifecycle.scale_up`` / ``lifecycle.scale_down``,
``lifecycle.host_offer``.

Thread safety: all supervisor state is guarded by one condition
variable. Long operations (factory spawn, warm replay, engine shutdown)
and every call into the router or an engine run OUTSIDE it, on the
supervisor thread: no lock is held across a blocking call, and no second
lock is taken under it. The supervisor is a CLIENT of router and
engines: it owns no device state.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..monitor.flight import dump_flight
from ..monitor.stats import (FAULTS_INJECTED, PREFIX_WARM_TOKENS,
                             SERVING_REPLICA_RESTARTS, SERVING_REPLICAS_TARGET,
                             SERVING_SCALE_EVENTS)
from ..monitor.trace import span
from ..resilience import faults as _faults
from .overload import RUNG_HEALTHY, RUNG_SMALL_CHUNKS

__all__ = ["ReplicaSupervisor", "ReplicaFailed"]


class ReplicaFailed(RuntimeError):
    """The supervisor exhausted ``max_restarts`` for a replica slot:
    carried as the error of any stream still parked on it."""


class _Slot:
    """Lifecycle state of one replica id."""

    __slots__ = ("state", "attempts", "next_try_t", "since_t", "old_rid",
                 "cause", "drain_since", "host")

    def __init__(self, host=None):
        self.state = "live"     # live|pending|quarantined|draining|failed
        self.attempts = 0       # respawn attempts since the last stable run
        self.next_try_t = 0.0   # monotonic time of the next spawn attempt
        self.since_t = time.monotonic()   # when the current engine rejoined
        self.old_rid = 0        # dead engine's request-id watermark
        self.cause = None       # last death cause (restart-span arg)
        self.drain_since = None  # monotonic drain start (scale-down)
        self.host = host        # host the current incarnation runs on


class ReplicaSupervisor:
    """Self-healing and autoscaling controller over an EngineRouter.

    ::

        ctl = OverloadController()
        def factory():
            return InferenceEngine(cfg, params, seed=0, paged=True,
                                   prefix_cache=True, overload=ctl)
        router = EngineRouter([factory(), factory()])
        sup = ReplicaSupervisor(router, factory, max_replicas=4)
        ...
        router.shutdown()       # closes the supervisor too

    ``factory`` must build engines identical to the live replicas (seed,
    params, config): that is what makes restart, rejoin and migration
    token-exact. The supervisor attaches itself as ``router.supervisor``
    (which arms orphan parking) and starts its monitor thread at once.
    """

    def __init__(self, router, factory: Callable[[], object], *,
                 min_replicas: int = 1, max_replicas: Optional[int] = None,
                 max_restarts: int = 3, backoff_s: float = 0.1,
                 backoff_cap_s: float = 2.0, quarantine_after: int = 2,
                 quarantine_s: float = 2.0, stable_s: float = 5.0,
                 warm_prefixes: int = 4, warm_timeout_s: float = 30.0,
                 scale_up_rung: int = RUNG_SMALL_CHUNKS,
                 scale_up_after: int = 3, scale_down_after: int = 10,
                 scale_down_occupancy: float = 0.25,
                 scale_cooldown_s: float = 1.0,
                 wedge_timeout_s: Optional[float] = None,
                 drain_timeout_s: float = 5.0, poll_s: float = 0.05):
        if router.supervisor is not None:
            raise ValueError("router already has a supervisor")
        if min_replicas < 1:
            raise ValueError(f"min_replicas={min_replicas} must be >= 1")
        if max_replicas is not None and max_replicas < min_replicas:
            raise ValueError(f"max_replicas={max_replicas} below "
                             f"min_replicas={min_replicas}")
        if not 0 < quarantine_after <= max_restarts:
            raise ValueError(
                f"quarantine_after={quarantine_after} must sit in "
                f"[1, max_restarts={max_restarts}] — the ladder is "
                "backoff, then quarantine, then give up")
        self.router = router
        self.factory = factory
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas) if max_replicas is not None \
            else router.n_replicas
        self.max_restarts = int(max_restarts)
        self.backoff_s = float(backoff_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.quarantine_after = int(quarantine_after)
        self.quarantine_s = float(quarantine_s)
        self.stable_s = float(stable_s)
        self.warm_prefixes = int(warm_prefixes)
        self.warm_timeout_s = float(warm_timeout_s)
        self.scale_up_rung = int(scale_up_rung)
        self.scale_up_after = int(scale_up_after)
        self.scale_down_after = int(scale_down_after)
        self.scale_down_occupancy = float(scale_down_occupancy)
        self.scale_cooldown_s = float(scale_cooldown_s)
        self.wedge_timeout_s = float(wedge_timeout_s) \
            if wedge_timeout_s is not None \
            else max(1.0, 2.0 * router.tick_age_budget_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self.poll_s = float(poll_s)
        self.overload = router.overload     # the shared brownout ladder
        self._cv = threading.Condition()
        self._slots: Dict[int, _Slot] = {
            e.replica_id: _Slot(host=getattr(e, "host", None))
            for e in router.engines}
        # backoff/quarantine ladders keyed by (host, replica id): a
        # healthy host re-offering a replica id after a host swap must not
        # inherit the dead host's attempt count
        self._ladders: Dict[Tuple[Optional[str], int], int] = {}
        self._target = len(self._slots)
        self._spawn_seq = 0     # factory invocations (spawn_fail space)
        self._rejoin_seq = 0    # completed rejoins (replica_flap space)
        self._scale_events = 0
        self._scale_ups = 0
        self._scale_downs = 0   # COMPLETED drain-shrinks (victim gone)
        self._hot = 0           # consecutive polls at/above scale_up_rung
        self._cool = 0          # consecutive idle rung-0 polls
        self._last_scale_t = time.monotonic() - self.scale_cooldown_s
        self._stop = False
        self._last_error: Optional[BaseException] = None
        SERVING_REPLICAS_TARGET.set(self._target)
        router.supervisor = self
        self._thread = threading.Thread(target=self._run,
                                        name="serving-supervisor",
                                        daemon=True)
        self._thread.start()

    # -- observability -------------------------------------------------------
    def snapshot(self) -> dict:
        """Operator / readyz view of the lifecycle state."""
        with self._cv:
            return {
                "target": self._target,
                "spawns": self._spawn_seq,
                "rejoins": self._rejoin_seq,
                "scale_events": self._scale_events,
                "scale_ups": self._scale_ups,
                "scale_downs": self._scale_downs,
                "replicas": {str(rid): {"state": st.state,
                                        "attempts": st.attempts,
                                        "host": st.host}
                             for rid, st in sorted(self._slots.items())},
            }

    @property
    def target_replicas(self) -> int:
        return self._target

    def note_host_offer(self, rid: int, host: Optional[str]) -> bool:
        """A healthy host (re-)offers capacity for replica ``rid``.

        Quarantine is keyed by (host, replica): when the offering host
        differs from the one whose deaths built the current ladder, the
        slot switches to the offering host's own attempt count and is due
        at once: a dead host's quarantine hold must not hold back a
        healthy host re-offering the same replica id. Returns True when
        the offer unblocked the slot. No-op for live, draining and failed
        slots and for same-host offers.
        """
        now = time.monotonic()
        with self._cv:
            st = self._slots.get(int(rid))
            if st is None or st.state not in ("pending", "quarantined"):
                return False
            if st.host == host:
                return False
            self._ladders[(st.host, int(rid))] = st.attempts
            st.attempts = self._ladders.get((host, int(rid)), 0)
            st.host = host
            if st.state == "quarantined":
                st.state = "pending"
            st.next_try_t = now      # due on the next scan
            self._cv.notify_all()
        with span("lifecycle.host_offer", cat="serving",
                  args={"replica": int(rid), "host": str(host)}):
            pass
        return True

    def close(self, timeout: float = 30.0) -> None:
        """Stop the monitor thread (engines and router are the caller's)."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout)

    # -- monitor loop --------------------------------------------------------
    def _run(self) -> None:
        while True:
            with self._cv:
                if self._stop:
                    break
                self._cv.wait(self.poll_s)
                if self._stop:
                    break
            try:
                self._scan()
                self._drain_progress()
                self._autoscale()
            except Exception as e:  # noqa: BLE001 — a scan hiccup must not
                # kill the healer; record it and keep supervising
                with self._cv:
                    self._last_error = e

    def _engine(self, rid: int):
        try:
            return self.router.engine_for(rid)
        except KeyError:
            return None

    def _scan(self) -> None:
        """Death and wedge detection, and due respawn attempts."""
        now = time.monotonic()
        with self._cv:
            items = list(self._slots.items())
        for rid, st in items:
            if st.state == "live":
                eng = self._engine(rid)
                if eng is None:
                    continue        # removed externally
                if not eng.alive:
                    self._on_death(rid, st, eng, self._cause_of(eng))
                elif eng.busy and eng.tick_age() > self.wedge_timeout_s:
                    self._on_death(rid, st, eng, "wedged")
            elif st.state in ("pending", "quarantined") \
                    and now >= st.next_try_t:
                self._attempt_respawn(rid, st)
        # ladder reset: a replica that survived stable_s earned it
        with self._cv:
            for rid, st in self._slots.items():
                if st.state == "live" and st.attempts \
                        and now - st.since_t > self.stable_s:
                    st.attempts = 0
                    self._ladders.pop((st.host, rid), None)

    @staticmethod
    def _cause_of(eng) -> str:
        err = getattr(eng, "_error", None)
        return type(err).__name__ if err is not None else "dead"

    def _next_rung(self, st: _Slot, now: float) -> bool:
        """cv held: put a slot that just lost an engine or a spawn on the
        ladder's next rung. Returns True when the ladder is exhausted
        (the slot is then marked failed)."""
        if st.attempts >= self.max_restarts:
            st.state = "failed"
            return True
        if st.attempts == 0:
            delay, st.state = 0.0, "pending"           # immediate
        elif st.attempts < self.quarantine_after:
            delay = min(self.backoff_cap_s,
                        self.backoff_s * 2 ** (st.attempts - 1))
            st.state = "pending"                       # exponential backoff
        else:
            delay, st.state = self.quarantine_s, "quarantined"
        st.next_try_t = now + delay
        return False

    def _on_death(self, rid: int, st: _Slot, eng, cause: str) -> None:
        """A live replica died or wedged: unregister it and schedule the
        ladder's next spawn attempt (or give up loudly)."""
        if cause == "wedged":
            # arm the wedged scheduler to fail its streams the moment it
            # wakes: adoption or orphan parking takes them from there
            eng.evacuate()
        old_rid = int(getattr(eng, "_rid", 0))
        host = getattr(eng, "host", None)
        self.router.remove_replica(rid)
        now = time.monotonic()
        with self._cv:
            st.old_rid = max(st.old_rid, old_rid)
            st.cause = cause
            # the ladder belongs to (host, replica), not the bare id: park
            # the dying host's attempt count under its own key and resume
            # whatever count THIS host had accrued before
            if st.host != host:
                self._ladders[(st.host, rid)] = st.attempts
                st.attempts = self._ladders.get((host, rid), 0)
                st.host = host
            self._ladders[(host, rid)] = st.attempts
            gave_up = self._next_rung(st, now)
            attempts, state = st.attempts, st.state
        self._after_rung(rid, gave_up, state, attempts, cause)

    def _after_rung(self, rid: int, gave_up: bool, state: str,
                    attempts: int, cause) -> None:
        """Outside the cv: the spans, flight dump and orphan failures of
        the rung a slot was just put on."""
        if gave_up:
            self._give_up(rid, attempts, cause)
        elif state == "quarantined":
            with span("lifecycle.quarantine", cat="serving",
                      args={"replica": rid, "attempts": attempts,
                            "hold_s": self.quarantine_s, "cause": cause}):
                pass

    def _give_up(self, rid: int, attempts: int, cause) -> None:
        # the loud last rung (the slot is already marked failed)
        with span("lifecycle.give_up", cat="serving",
                  args={"replica": rid, "attempts": attempts,
                        "cause": cause}):
            pass
        # give-up is a capacity-down page: dump the flight ring so the
        # on-call human gets the last seconds of history with the alert
        # (no-op when no recorder is armed)
        dump_flight(f"lifecycle_give_up_r{rid}",
                    extra={"replica": rid, "attempts": attempts,
                           "cause": str(cause)})
        # a fleet router also pulls every OTHER host's ring, on a thread
        # of its own (the collection does bounded-per-host RPC)
        collect = getattr(self.router, "collect_flight_async", None)
        if callable(collect):
            collect(f"give_up_r{rid}")
        self.router.fail_orphans(ReplicaFailed(
            f"replica {rid} gave up after {attempts} restart(s) "
            f"(max_restarts={self.max_restarts}; last cause: {cause})"))

    def _spawn(self, cause: str, replica: int, attempt: int):
        """One factory invocation under the spawn_fail fault space;
        returns the engine or raises."""
        with self._cv:
            self._spawn_seq += 1
            seq = self._spawn_seq
        SERVING_REPLICA_RESTARTS.add(1)
        with span("lifecycle.restart", cat="serving",
                  args={"replica": replica, "attempt": attempt,
                        "spawn": seq, "cause": cause}):
            if _faults.ENABLED[0]:
                f = _faults.FAULTS.take_restart("spawn_fail", seq)
                if f is not None:
                    FAULTS_INJECTED.add()
                    raise _faults.InjectedCrash(
                        f"injected spawn failure (attempt {seq})")
            return self.factory()

    def _attempt_respawn(self, rid: int, st: _Slot) -> None:
        with self._cv:
            attempt = st.attempts
            st.attempts += 1
            self._ladders[(st.host, rid)] = st.attempts
            cause, old_rid = st.cause, st.old_rid
        try:
            eng = self._spawn(cause or "dead", rid, attempt)
        except Exception as e:  # noqa: BLE001 — a failed spawn is a
            # ladder rung, not a supervisor crash
            self._on_spawn_failure(rid, st, e)
            return
        # rid-space carry-forward: new submissions continue the dead
        # engine's request-id numbering, so no stream adopted by a
        # survivor can alias a fresh one's RNG stream, and a rejoined
        # replica's sampled streams match the fault-free numbering
        with eng._cv:
            eng._rid = max(eng._rid, old_rid)
        self.router.add_replica(eng, replica_id=rid, warming=True)
        warm_toks, warm_n = self._warm(eng, rid)
        # a whole-set death parked its streams: the replacement adopts
        # them (token-identical replay) before opening for new traffic
        adopted = 0
        for req, err in self.router.take_orphans():
            try:
                eng.adopt_request(req)
                adopted += 1
            except RuntimeError:
                req._finish("error", err)
        self.router.mark_ready(rid)
        now = time.monotonic()
        with self._cv:
            st.state = "live"
            st.since_t = now
            st.host = getattr(eng, "host", None)
            self._rejoin_seq += 1
            rejoin = self._rejoin_seq
        with span("lifecycle.rejoin", cat="serving",
                  args={"replica": rid, "attempt": attempt,
                        "warm_tokens": warm_toks, "warm_prefixes": warm_n,
                        "adopted": adopted, "rejoin": rejoin}):
            pass
        if _faults.ENABLED[0]:
            f = _faults.FAULTS.take_restart("replica_flap", rejoin)
            if f is not None:
                FAULTS_INJECTED.add()
                eng.fail_at_tick(1)     # crash at its next busy tick

    def _on_spawn_failure(self, rid: int, st: _Slot, err) -> None:
        now = time.monotonic()
        with self._cv:
            st.cause = f"spawn failed: {type(err).__name__}"
            # attempts >= 1 here, so the rung is backoff, quarantine or
            # give-up, never the immediate one
            gave_up = self._next_rung(st, now)
            attempts, state, cause = st.attempts, st.state, st.cause
        self._after_rung(rid, gave_up, state, attempts, cause)

    # -- prefix re-warm ------------------------------------------------------
    def _warm(self, eng, rid: int):
        """Replay the hottest routed prefixes as prefill-only requests;
        returns (tokens warmed, prefixes warmed)."""
        if getattr(eng, "_prefix", None) is None:
            return 0, 0
        reqs = []
        for p in self.router.hot_prefixes(self.warm_prefixes):
            if p.size < 1 or p.size >= eng.max_len:
                continue
            reqs.append((p, eng.warm_prefix(p)))
        deadline = time.monotonic() + self.warm_timeout_s
        toks = n = 0
        for p, r in reqs:
            try:
                r.result(timeout=max(0.1, deadline - time.monotonic()))
            except (TimeoutError, RuntimeError):
                continue        # warming is best effort, never a blocker
            toks += int(p.size)
            n += 1
            PREFIX_WARM_TOKENS.add(int(p.size))
            self.router.note_routed_prefix(p, rid)
        return toks, n

    # -- autoscaling ---------------------------------------------------------
    def _counts(self):
        with self._cv:
            live = [r for r, s in self._slots.items() if s.state == "live"]
            coming = [r for r, s in self._slots.items()
                      if s.state in ("pending", "quarantined")]
            draining = [r for r, s in self._slots.items()
                        if s.state == "draining"]
        return live, coming, draining

    def _occupancy_frac(self, live: List[int]) -> float:
        occ = cap = 0
        for rid in live:
            eng = self._engine(rid)
            if eng is None:
                continue
            occ += int(eng.occupancy) + int(eng.queue_depth)
            cap += int(eng.n_slots)
        return occ / cap if cap else 0.0

    def _autoscale(self) -> None:
        if self.overload is None:
            return
        live, coming, draining = self._counts()
        rung = self.overload.rung
        # read outside the cv: it asks the router and the engines
        idle = rung == RUNG_HEALTHY and \
            self._occupancy_frac(live) < self.scale_down_occupancy
        with self._cv:
            if rung >= self.scale_up_rung:
                self._hot += 1
                self._cool = 0
            elif idle:
                self._cool += 1
                self._hot = 0
            else:
                # the in-between band mirrors the brownout ladder's: hold
                # the set, reset both streaks (no flapping)
                self._hot = 0
                self._cool = 0
            now = time.monotonic()
            cooled = now - self._last_scale_t >= self.scale_cooldown_s
            want_up = (self._hot >= self.scale_up_after and cooled
                       and not coming and not draining
                       and len(live) + len(coming) < self.max_replicas)
            want_down = (self._cool >= self.scale_down_after and cooled
                         and not coming and not draining
                         and len(live) > self.min_replicas)
            if want_up:
                self._hot = 0
            if want_down:
                self._cool = 0
        if want_up:
            self._scale_up(len(live))
        elif want_down:
            self._scale_down(live)

    def _scale_up(self, n_live: int) -> None:
        try:
            eng = self._spawn("scale_up", -1, 0)
        except Exception:  # noqa: BLE001 — a failed growth spawn is
            return         # retried after the next sustained-hot streak
        rid = self.router.add_replica(eng, warming=True)
        self._warm(eng, rid)
        self.router.mark_ready(rid)
        now = time.monotonic()
        # the span BEFORE the counters: a watcher that saw the
        # scale_events gauge move can rely on the trace row existing
        with span("lifecycle.scale_up", cat="serving",
                  args={"replica": rid, "from": n_live, "to": n_live + 1,
                        "rung": self.overload.rung}):
            pass
        with self._cv:
            self._slots[rid] = _Slot(host=getattr(eng, "host", None))
            self._target = n_live + 1
            self._scale_events += 1
            self._scale_ups += 1
            self._last_scale_t = now
        SERVING_REPLICAS_TARGET.set(n_live + 1)
        SERVING_SCALE_EVENTS.add(1)

    def _scale_down(self, live: List[int]) -> None:
        # victim: the least-loaded live replica (ties -> highest id, so
        # the original replicas are the last to go)
        victim = max(live, key=lambda r: (-self._load(r), r))
        self.router.begin_drain(victim)
        now = time.monotonic()
        with self._cv:
            st = self._slots[victim]
            st.state = "draining"
            st.drain_since = now
            self._target = len(live) - 1
            self._last_scale_t = now
        SERVING_REPLICAS_TARGET.set(len(live) - 1)
        with span("lifecycle.scale_down", cat="serving",
                  args={"replica": victim, "from": len(live),
                        "to": len(live) - 1, "phase": "drain"}):
            pass

    def _load(self, rid: int) -> int:
        eng = self._engine(rid)
        if eng is None:
            return 0
        return int(eng.queue_depth) + int(eng.occupancy)

    def _drain_progress(self) -> None:
        """Advance scale-down victims: finished drains shut down and leave
        the set; overdue ones EVACUATE (open streams migrate to survivors
        through adopt_request, token-identically)."""
        _, _, draining = self._counts()
        now = time.monotonic()
        for rid in draining:
            eng = self._engine(rid)
            if eng is None:
                self._finalize_drain(rid, None)
                continue
            if not eng.alive:
                # evacuated (or crashed): streams already failed over
                self._finalize_drain(rid, eng)
            elif eng.queue_depth == 0 and eng.occupancy == 0:
                self._finalize_drain(rid, eng)      # drained naturally
            else:
                with self._cv:
                    since = self._slots[rid].drain_since
                if since is not None and now - since > self.drain_timeout_s:
                    eng.evacuate()      # migrate leftovers to survivors

    def _finalize_drain(self, rid: int, eng) -> None:
        self.router.remove_replica(rid)
        if eng is not None:
            eng.shutdown(drain=False, timeout=30.0)
        with span("lifecycle.scale_down", cat="serving",
                  args={"replica": rid, "phase": "done"}):
            pass
        with self._cv:
            self._slots.pop(rid, None)
            self._scale_events += 1
            self._scale_downs += 1
        SERVING_SCALE_EVENTS.add(1)

    def __repr__(self):
        snap = self.snapshot()
        return (f"ReplicaSupervisor(target={snap['target']}, "
                f"replicas={snap['replicas']})")
