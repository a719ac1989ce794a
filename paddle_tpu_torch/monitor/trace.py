"""Chrome-trace-event JSON exporter.

Counterpart of ``paddle_tpu/monitor/trace.py``. :class:`TraceWriter`
accumulates trace events on the host and serializes the chrome
trace-event format (the ``{"traceEvents": [...]}`` envelope) that
Perfetto, chrome://tracing and ``tools/trace_report.py`` load.

The module-level writer plus the ``TRACING`` gate are the recording
switch the hot paths check: :func:`span` tests ``TRACING[0]`` and
``FLIGHT[0]`` (two list indices) before paying for any bookkeeping, so
an idle process records nothing and allocates nothing.

Timestamps are ``time.perf_counter()`` seconds converted to the format's
microseconds: one monotonic clock for every producer keeps spans from
different layers aligned on one timeline. Spans time the host: a span
around a CUDA launch ends when the launch is enqueued, unless the code
inside it copies a result to the host.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time

__all__ = ["TraceWriter", "TRACING", "FLIGHT", "is_tracing",
           "start_tracing", "stop_tracing", "get_writer", "span",
           "recording", "emit_complete", "emit_instant", "emit_flow"]

# shared mutable gate — hot paths read TRACING[0] directly
TRACING = [False]

# the armed flight recorder (monitor/flight.py) or None — a second
# consumer of span/instant events that stays on across a failure so the
# last seconds before a crash are dumpable even when full tracing is off.
# Kept here (not in flight.py) so span() pays ONE extra list index when
# nothing is armed and flight.py can import without a cycle.
FLIGHT = [None]


class TraceWriter:
    """Thread-safe collector of chrome trace events."""

    def __init__(self, pid: int | None = None):
        self.pid = os.getpid() if pid is None else pid
        self._events: list[dict] = []
        self._lock = threading.Lock()

    # -- event constructors -------------------------------------------------
    def add_complete(self, name: str, ts: float, dur: float,
                     tid: int | None = None, cat: str = "op",
                     args: dict | None = None) -> None:
        """One "X" (complete) event; ts/dur in seconds on the perf_counter
        timeline."""
        ev = {
            "name": name, "ph": "X", "cat": cat, "pid": self.pid,
            "tid": threading.get_ident() & 0x7FFFFFFF if tid is None else tid,
            "ts": int(ts * 1e6), "dur": int(dur * 1e6),
        }
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    def add_begin(self, name: str, ts: float, tid: int | None = None,
                  cat: str = "op") -> None:
        self._add_mark("B", name, ts, tid, cat)

    def add_end(self, name: str, ts: float, tid: int | None = None,
                cat: str = "op") -> None:
        self._add_mark("E", name, ts, tid, cat)

    def add_instant(self, name: str, ts: float, cat: str = "instant") -> None:
        self._add_mark("i", name, ts, None, cat)

    def _add_mark(self, ph, name, ts, tid, cat):
        with self._lock:
            self._events.append({
                "name": name, "ph": ph, "cat": cat, "pid": self.pid,
                "tid": threading.get_ident() & 0x7FFFFFFF if tid is None
                else tid,
                "ts": int(ts * 1e6),
            })

    def add_counter(self, name: str, ts: float, values: dict) -> None:
        """One "C" (counter) event — e.g. the stat gauges over time."""
        with self._lock:
            self._events.append({
                "name": name, "ph": "C", "pid": self.pid, "tid": 0,
                "ts": int(ts * 1e6), "args": dict(values),
            })

    def add_flow(self, ph: str, flow_id: int, ts: float,
                 name: str = "request", cat: str = "trace") -> None:
        """One flow event ("s" start / "t" step / "f" finish) with
        ``id=flow_id``. Chrome/Perfetto draw an arrow chain through every
        flow event sharing an id, binding each to the enclosing slice on
        its thread — that chain is what turns per-layer spans into ONE
        connected per-request timeline."""
        ev = {
            "name": name, "ph": ph, "cat": cat, "pid": self.pid,
            "tid": threading.get_ident() & 0x7FFFFFFF,
            "ts": int(ts * 1e6), "id": int(flow_id),
        }
        if ph == "f":
            ev["bp"] = "e"      # bind the finish to the enclosing slice
        with self._lock:
            self._events.append(ev)

    def extend(self, events) -> None:
        with self._lock:
            self._events.extend(events)

    # -- access / export ----------------------------------------------------
    def events(self) -> list:
        with self._lock:
            return list(self._events)

    def __len__(self):
        with self._lock:
            return len(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def to_json(self) -> str:
        return json.dumps({"traceEvents": self.events(),
                           "displayTimeUnit": "ms"})

    def write(self, path: str) -> str:
        d = os.path.dirname(os.path.abspath(path))
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_json())
        return path


_writer = TraceWriter()


def get_writer() -> TraceWriter:
    return _writer


def is_tracing() -> bool:
    return TRACING[0]


def start_tracing(clear: bool = True) -> TraceWriter:
    if clear:
        _writer.clear()
    TRACING[0] = True
    return _writer


def stop_tracing() -> TraceWriter:
    TRACING[0] = False
    return _writer


def recording() -> bool:
    """True when anything consumes events: full tracing OR an armed
    flight recorder. Hot paths that pre-compute span args should gate on
    this rather than ``TRACING[0]`` alone."""
    return TRACING[0] or FLIGHT[0] is not None


def emit_complete(name: str, ts: float, dur: float, cat: str = "op",
                  args: dict | None = None) -> None:
    """One complete event to every live consumer (trace writer when
    tracing, flight-recorder ring when armed)."""
    if TRACING[0]:
        _writer.add_complete(name, ts, dur, cat=cat, args=args)
    rec = FLIGHT[0]
    if rec is not None:
        rec.add_complete(name, ts, dur, cat=cat, args=args)


def emit_instant(name: str, ts: float, cat: str = "instant") -> None:
    if TRACING[0]:
        _writer.add_instant(name, ts, cat=cat)
    rec = FLIGHT[0]
    if rec is not None:
        rec.add_instant(name, ts, cat=cat)


def emit_flow(ph: str, flow_id: int, ts: float,
              name: str = "request") -> None:
    if TRACING[0]:
        _writer.add_flow(ph, flow_id, ts, name=name)
    rec = FLIGHT[0]
    if rec is not None:
        rec.add_flow(ph, flow_id, ts, name=name)


@contextlib.contextmanager
def span(name: str, cat: str = "op", args: dict | None = None,
         flow: int | None = None):
    """Record a span around a block — free when tracing is off (one list
    index) and the flight recorder is unarmed (a second list index).

    ``flow``: a trace/flow id to stamp a flow STEP event at span start,
    chaining this span into its request's causal timeline."""
    if not TRACING[0] and FLIGHT[0] is None:
        yield
        return
    t0 = time.perf_counter()
    if flow is not None:
        # flow events keep the constant "request" name: name-based event
        # filters (reports, tests) must see only the real span under the
        # span's name
        emit_flow("t", flow, t0)
    try:
        yield
    finally:
        emit_complete(name, t0, time.perf_counter() - t0,
                      cat=cat, args=args)
