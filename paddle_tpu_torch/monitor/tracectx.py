"""Causal trace context of one serving request.

Counterpart of ``paddle_tpu/monitor/tracectx.py``. A
:class:`TraceContext` is the identity one request carries from admission
to its last token: a process-unique ``trace_id`` (the chrome-trace flow
id; every event stamped with it lies on one connected arrow chain), a
parent/child span-id pair so events nest causally, and the list of
replica hops the request survived (failover adoption), so a
cross-replica timeline still reads as one request.

The caller mints a context per request (:func:`mint_trace`) and passes
it to ``InferenceEngine.submit(trace=...)``; every span the request
passes through (prefill, each prefill chunk, each decode tick it rides,
the failover hop) stamps its args with :meth:`TraceContext.args` and a
flow step; completion emits the flow finish.
``tools/trace_report.py request_report`` groups events by ``trace``.

A context never touches sampling state: with tracing off and no flight
recorder armed the token stream is unchanged.
"""
from __future__ import annotations

import itertools
import os
import threading
from typing import List, Optional, Tuple

__all__ = ["TraceContext", "mint_trace"]

# trace ids carry the pid in their high bits so flow chains from
# different processes stay distinct when flight dumps are merged
_seq = itertools.count(1)
_seq_lock = threading.Lock()


class TraceContext:
    """One request's causal identity: flow id + span lineage + hops."""

    __slots__ = ("trace_id", "parent_id", "span_id", "hops", "_n")

    def __init__(self, trace_id: int):
        self.trace_id = int(trace_id)
        self.parent_id = 0          # span id of the latest emitted span
        self.span_id = 0
        self.hops: List[Tuple[Optional[int], Optional[int]]] = []
        self._n = 0

    def child(self) -> Tuple[int, int]:
        """Allocate the next span id; returns (parent_id, span_id) and
        advances the lineage so the NEXT span parents off this one."""
        self._n += 1
        parent = self.span_id
        self.parent_id = parent
        self.span_id = self._n
        return parent, self._n

    def args(self, **extra) -> dict:
        """Span-args payload for the next event on this trace: allocates
        a child span id and merges any per-span extras."""
        parent, sid = self.child()
        out = {"trace": self.trace_id, "span": sid, "parent": parent}
        if self.hops:
            out["hop"] = len(self.hops)
        out.update(extra)
        return out

    def hop(self, from_replica: Optional[int],
            to_replica: Optional[int]) -> None:
        """Record a replica hop (failover adoption / rejoin replay)."""
        self.hops.append((from_replica, to_replica))

    def __repr__(self):
        return (f"TraceContext({self.trace_id:#x}, spans={self._n}, "
                f"hops={self.hops})")


def mint_trace() -> TraceContext:
    """New process-unique trace context (pid-salted flow id)."""
    with _seq_lock:
        n = next(_seq)
    return TraceContext(((os.getpid() & 0xFFFF) << 40) | n)
