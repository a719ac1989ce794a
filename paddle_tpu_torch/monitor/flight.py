"""Crash flight recorder: a bounded ring of the most recent spans,
gauge deltas and trace events of the process, dumped as a self-contained
chrome trace with a JSON summary at the moment of failure.

Counterpart of ``paddle_tpu/monitor/flight.py``. Once armed
(:func:`arm_flight_recorder`) every :func:`~.trace.span` and ``emit_*``
event is also appended to a fixed-capacity ring (the oldest fall off);
every ``gauge_every`` appends the gauges that moved are interleaved as a
chrome counter event; :func:`dump_flight` writes ring + final gauge
snapshot + a summary block to the recorder's directory as
``flight_<host>_<pid>_<seq>_<reason>.json`` (``tools/trace_report.py``
reads it, and merges dumps of several hosts into one timeline). The
serving engine dumps on a scheduler abort and on a watchdog restart.

Unarmed (the default) the only cost anywhere is one list-index check in
``span()``.
"""
from __future__ import annotations

import datetime
import json
import os
import threading
import time
from collections import deque
from typing import Optional

from .stats import stat_snapshot
from .trace import FLIGHT

__all__ = ["FlightRecorder", "arm_flight_recorder",
           "disarm_flight_recorder", "get_flight_recorder", "dump_flight",
           "set_host_id", "host_id"]

# pod-aware identity for dump naming (the elastic layer's host name);
# a list cell so setters reach every importer
_HOST = [os.environ.get("PADDLE_TPU_HOST_ID", "h0")]


def set_host_id(host: str) -> None:
    """Name this process's dumps after the elastic layer's host id."""
    _HOST[0] = str(host)


def host_id() -> str:
    return _HOST[0]


class FlightRecorder:
    """Fixed-capacity ring of chrome-trace events + gauge deltas."""

    def __init__(self, trace_dir: Optional[str] = None,
                 capacity: int = 4096, gauge_every: int = 64):
        self.trace_dir = trace_dir
        self.capacity = int(capacity)
        self.gauge_every = max(1, int(gauge_every))
        self.pid = os.getpid()
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._since_gauges = 0
        self._last_gauges: dict = {}
        self._dump_seq = 0

    # -- event sinks (signature-compatible with TraceWriter) -----------------
    def _append(self, ev: dict) -> None:
        with self._lock:
            self._ring.append(ev)
            self._since_gauges += 1
            due = self._since_gauges >= self.gauge_every
            if due:
                self._since_gauges = 0
        if due:
            self.note_gauges()

    def add_complete(self, name: str, ts: float, dur: float,
                     tid: Optional[int] = None, cat: str = "op",
                     args: Optional[dict] = None) -> None:
        ev = {"name": name, "ph": "X", "cat": cat, "pid": self.pid,
              "tid": threading.get_ident() & 0x7FFFFFFF if tid is None
              else tid,
              "ts": int(ts * 1e6), "dur": int(dur * 1e6)}
        if args:
            ev["args"] = dict(args)
        self._append(ev)

    def add_instant(self, name: str, ts: float, cat: str = "instant") -> None:
        self._append({"name": name, "ph": "i", "cat": cat, "pid": self.pid,
                      "tid": threading.get_ident() & 0x7FFFFFFF,
                      "ts": int(ts * 1e6)})

    def add_flow(self, ph: str, flow_id: int, ts: float,
                 name: str = "request", cat: str = "trace") -> None:
        ev = {"name": name, "ph": ph, "cat": cat, "pid": self.pid,
              "tid": threading.get_ident() & 0x7FFFFFFF,
              "ts": int(ts * 1e6), "id": int(flow_id)}
        if ph == "f":
            ev["bp"] = "e"
        self._append(ev)

    def note_gauges(self) -> None:
        """Append a counter event of the gauges that MOVED since the
        last sample — the ring's gauge-delta interleave."""
        snap = stat_snapshot()
        with self._lock:
            delta = {k: v for k, v in snap.items()
                     if self._last_gauges.get(k) != v}
            self._last_gauges = snap
            if delta:
                self._ring.append({
                    "name": "gauges", "ph": "C", "pid": self.pid, "tid": 0,
                    "ts": int(time.perf_counter() * 1e6), "args": delta})

    def __len__(self):
        with self._lock:
            return len(self._ring)

    def events(self) -> list:
        with self._lock:
            return list(self._ring)

    # -- the dump ------------------------------------------------------------
    def dump(self, reason: str, trace_dir: Optional[str] = None,
             extra: Optional[dict] = None) -> Optional[str]:
        """Write the ring + a final gauge snapshot + a summary block to
        ``flight_<host>_<pid>_<seq>_<reason>.json`` under ``trace_dir``
        (falling back to the recorder's). Returns the path, or None when
        no directory is configured. Never raises — a failing dump must
        not mask the failure being recorded."""
        d = trace_dir or self.trace_dir
        if not d:
            return None
        try:
            self.note_gauges()
            with self._lock:
                self._dump_seq += 1
                seq = self._dump_seq
                events = list(self._ring)
            safe = "".join(c if c.isalnum() or c in "-_" else "_"
                           for c in str(reason))[:48] or "dump"
            host = host_id()
            payload = {
                "traceEvents": events
                + [{"name": "process_name", "ph": "M", "pid": self.pid,
                    "args": {"name": f"{host} pid={self.pid}"}}],
                "displayTimeUnit": "ms",
                "flight": {
                    "reason": str(reason), "host": host, "pid": self.pid,
                    "seq": seq, "events": len(events),
                    "t_dump_us": int(time.perf_counter() * 1e6),
                    # human log timestamp for cross-host correlation
                    # (the event timeline itself stays on perf_counter)
                    "wall_time": datetime.datetime.now(
                        datetime.timezone.utc).isoformat(),
                    "gauges": stat_snapshot(),
                    **(extra or {}),
                },
            }
            os.makedirs(d, exist_ok=True)
            path = os.path.join(
                d, f"flight_{host}_{self.pid}_{seq:03d}_{safe}.json")
            with open(path, "w") as f:
                json.dump(payload, f)
            return path
        except Exception:  # noqa: BLE001 — diagnostics must never mask
            return None    # the failure that triggered them


# -- module surface (the armed recorder lives in trace.FLIGHT) --------------

def arm_flight_recorder(trace_dir: Optional[str] = None,
                        capacity: int = 4096,
                        gauge_every: int = 64) -> FlightRecorder:
    """Arm (or re-target) the process flight recorder. Idempotent: an
    already-armed recorder keeps its ring and only adopts a newly-given
    ``trace_dir`` — multiple engines/guardians in one process share one
    black box."""
    rec = FLIGHT[0]
    if rec is None:
        rec = FlightRecorder(trace_dir=trace_dir, capacity=capacity,
                             gauge_every=gauge_every)
        FLIGHT[0] = rec
    elif trace_dir is not None:
        rec.trace_dir = trace_dir
    return rec


def disarm_flight_recorder() -> None:
    FLIGHT[0] = None


def get_flight_recorder() -> Optional[FlightRecorder]:
    return FLIGHT[0]


def dump_flight(reason: str, trace_dir: Optional[str] = None,
                extra: Optional[dict] = None) -> Optional[str]:
    """Dump the armed recorder (no-op returning None when unarmed)."""
    rec = FLIGHT[0]
    if rec is None:
        return None
    return rec.dump(reason, trace_dir=trace_dir, extra=extra)
