"""Brownout degradation ladder of the serving stack.

Counterpart of ``paddle_tpu/serving/overload.py`` (pure Python, the
whole controller). Under sustained overload a serving system either
degrades gracefully or sheds loudly; :class:`OverloadController` decides
which, one rung at a time::

    rung 0  healthy        — nothing changed
    rung 1  no_spec        — speculative decoding off
    rung 2  small_chunks   — prefill chunks shrink (long prompts yield
                             the scheduler to open streams more often)
    rung 3  capped_tokens  — per-lane max_tokens cap (gold exempt)
    rung 4  shed_bronze    — bronze-lane admissions refused
    rung 5  shed_silver    — silver too; only gold is admitted

The controller keeps exponentially weighted moving averages of the
admission QUEUE WAIT and the DECODE TICK latency, each over its budget;
``pressure`` is the worse of the two. The rung steps up after
``step_up_after`` consecutive observations above ``high_water`` and down
after ``step_down_after`` below ``low_water``. Every transition sets the
``brownout_rung`` gauge, counts ``brownout_steps`` and drops a
``serving.brownout`` trace instant.

The engine (``InferenceEngine(overload=...)``) feeds
``observe_queue_wait`` at admission and ``observe_tick`` each decode
tick, and consults ``spec_allowed()`` and ``prefill_chunk()``; the
lane-aware rungs (token caps, sheds) belong to a front end. With no
controller attached every schedule decision is the engine's own.

Observations may arrive from several threads; all mutable state is
guarded by one lock.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

from ..monitor.stats import BROWNOUT_RUNG, BROWNOUT_STEPS
from ..monitor.trace import emit_complete, emit_instant, recording

__all__ = ["OverloadController", "RUNG_NAMES", "RUNG_HEALTHY",
           "RUNG_NO_SPEC", "RUNG_SMALL_CHUNKS", "RUNG_CAPPED_TOKENS",
           "RUNG_SHED_BRONZE", "RUNG_SHED_SILVER"]

RUNG_HEALTHY = 0
RUNG_NO_SPEC = 1
RUNG_SMALL_CHUNKS = 2
RUNG_CAPPED_TOKENS = 3
RUNG_SHED_BRONZE = 4
RUNG_SHED_SILVER = 5

RUNG_NAMES = ("healthy", "no_spec", "small_chunks", "capped_tokens",
              "shed_bronze", "shed_silver")


class OverloadController:
    """EWMA pressure controller stepping the brownout ladder.

    ::

        ctl = OverloadController(queue_wait_budget_ms=200,
                                 tick_budget_ms=100)
        eng = InferenceEngine(cfg, params, overload=ctl)

    Knobs: ``queue_wait_budget_ms`` / ``tick_budget_ms`` are the SLO
    normalizers (pressure 1.0 = exactly at budget); ``alpha`` the EWMA
    smoothing weight of a fresh sample; ``high_water`` / ``low_water``
    the asymmetric thresholds; ``step_up_after`` / ``step_down_after``
    the consecutive-observation hysteresis counts; ``chunk_shrink`` the
    divisor applied to prefill chunks at rung >= 2; ``token_cap`` the
    per-request max_tokens ceiling for non-gold lanes at rung >= 3.
    """

    def __init__(self, queue_wait_budget_ms: float = 200.0,
                 tick_budget_ms: float = 100.0, alpha: float = 0.3,
                 high_water: float = 1.0, low_water: float = 0.5,
                 step_up_after: int = 3, step_down_after: int = 8,
                 chunk_shrink: int = 4, token_cap: int = 32):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha={alpha} must be in (0, 1]")
        if low_water >= high_water:
            raise ValueError(f"low_water={low_water} must sit below "
                             f"high_water={high_water} (that gap IS the "
                             "hysteresis band)")
        if chunk_shrink < 1:
            raise ValueError(f"chunk_shrink={chunk_shrink} must be >= 1")
        self.queue_wait_budget_ms = float(queue_wait_budget_ms)
        self.tick_budget_ms = float(tick_budget_ms)
        self.alpha = float(alpha)
        self.high_water = float(high_water)
        self.low_water = float(low_water)
        self.step_up_after = int(step_up_after)
        self.step_down_after = int(step_down_after)
        self.chunk_shrink = int(chunk_shrink)
        self.token_cap = int(token_cap)
        self._lock = threading.Lock()
        self._rung = RUNG_HEALTHY
        self._rung_since = time.monotonic()   # last transition (dwell time)
        self._q_ewma = 0.0
        self._t_ewma = 0.0
        self._hot = 0           # consecutive observations above high_water
        self._cool = 0          # consecutive observations below low_water
        BROWNOUT_RUNG.set(0)

    # -- observations (engine scheduler thread / frontend loop thread) -------
    def observe_queue_wait(self, ms: float) -> None:
        """One admission's queue wait (engine submit->admit, or the
        front end's WFQ lane wait)."""
        with self._lock:
            self._q_ewma += self.alpha * (float(ms) - self._q_ewma)
            self._maybe_step()

    def observe_tick(self, ms: float) -> None:
        """One decode tick's wall latency."""
        with self._lock:
            self._t_ewma += self.alpha * (float(ms) - self._t_ewma)
            self._maybe_step()

    # -- state ---------------------------------------------------------------
    @property
    def rung(self) -> int:
        return self._rung

    @property
    def rung_name(self) -> str:
        return RUNG_NAMES[self._rung]

    def pressure(self) -> float:
        """Worst normalized EWMA: 1.0 = exactly at budget."""
        with self._lock:
            return self._pressure()

    def rung_held_s(self) -> float:
        """Seconds the ladder has sat at the CURRENT rung — the
        blip-vs-trend signal behind lifecycle autoscaling decisions."""
        with self._lock:
            return time.monotonic() - self._rung_since

    def snapshot(self) -> dict:
        """Readyz/operator view of the controller."""
        with self._lock:
            return {"rung": self._rung, "rung_name": RUNG_NAMES[self._rung],
                    "rung_held_s": round(
                        time.monotonic() - self._rung_since, 3),
                    "pressure": round(self._pressure(), 4),
                    "queue_wait_ewma_ms": round(self._q_ewma, 3),
                    "tick_ewma_ms": round(self._t_ewma, 3)}

    def _pressure(self) -> float:
        return max(self._q_ewma / self.queue_wait_budget_ms,
                   self._t_ewma / self.tick_budget_ms)

    def _maybe_step(self) -> None:
        p = self._pressure()
        if p >= self.high_water:
            self._hot += 1
            self._cool = 0
            if self._hot >= self.step_up_after \
                    and self._rung < RUNG_SHED_SILVER:
                self._set_rung(self._rung + 1, p)
                self._hot = 0
        elif p <= self.low_water:
            self._cool += 1
            self._hot = 0
            if self._cool >= self.step_down_after \
                    and self._rung > RUNG_HEALTHY:
                self._set_rung(self._rung - 1, p)
                self._cool = 0
        else:
            # inside the hysteresis band: hold the rung, reset streaks
            self._hot = 0
            self._cool = 0

    def _set_rung(self, rung: int, pressure: float) -> None:
        # lock held by caller
        prev = self._rung
        self._rung = int(rung)
        self._rung_since = time.monotonic()
        BROWNOUT_RUNG.set(self._rung)
        BROWNOUT_STEPS.add(1)
        if recording():
            emit_instant("serving.brownout", time.perf_counter(),
                         cat="serving")
            # instants carry no args in the writer API — follow with a
            # zero-duration span so the report gets the rung/pressure
            t = time.perf_counter()
            emit_complete("serving.brownout_step", t, 0.0, cat="serving",
                          args={"rung": self._rung,
                                "rung_name": RUNG_NAMES[self._rung],
                                "from": prev,
                                "pressure": round(pressure, 4)})

    def force_rung(self, rung: int) -> None:
        """Operator/test hook: pin the ladder to a rung (the controller
        keeps stepping from there as observations arrive)."""
        if not 0 <= int(rung) <= RUNG_SHED_SILVER:
            raise ValueError(f"rung={rung} outside 0..{RUNG_SHED_SILVER}")
        with self._lock:
            if int(rung) != self._rung:
                self._set_rung(int(rung), self._pressure())
            self._hot = 0
            self._cool = 0

    # -- ladder knobs (consumed by engine/frontend/router) -------------------
    def spec_allowed(self) -> bool:
        """Rung 1: speculative decode is the first thing to go."""
        return self._rung < RUNG_NO_SPEC

    def prefill_chunk(self, base: Optional[int]) -> Optional[int]:
        """Rung 2: shrink prefill chunks by ``chunk_shrink`` (the engine
        re-rounds to its block size, floored at one block)."""
        if base is None or self._rung < RUNG_SMALL_CHUNKS:
            return base
        return max(1, int(base) // self.chunk_shrink)

    def cap_max_tokens(self, lane: str, requested: int) -> int:
        """Rung 3: non-gold lanes get their generations capped."""
        if self._rung < RUNG_CAPPED_TOKENS or lane == "gold":
            return int(requested)
        return min(int(requested), self.token_cap)

    def sheds(self, lane: str) -> bool:
        """Rungs 4/5: admission-time shed verdict for a lane (503 +
        Retry-After at the front end — never a silent drop)."""
        if lane == "bronze":
            return self._rung >= RUNG_SHED_BRONZE
        if lane == "silver":
            return self._rung >= RUNG_SHED_SILVER
        return False        # gold is never shed by the ladder

    def __repr__(self):
        return (f"OverloadController(rung={self._rung}"
                f"/{RUNG_NAMES[self._rung]}, "
                f"pressure={self.pressure():.3f})")
