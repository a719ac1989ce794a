"""Per-step training telemetry (``paddle_tpu/monitor/trainer.py``).

:class:`TrainerMonitor` brackets each training step (``step_begin`` /
``step_end``) and derives wall time, examples/s and the step's
``jit_compile`` delta (a captured ``jit.TrainStep`` graph made for a
new batch signature, the port's counterpart of a recompile). The hapi
``Monitor`` callback feeds from it. The reference also tracks op
dispatches, collective calls and gradient compiles, which the port
does not count; its summary keeps ``total_grad_recompiles`` at 0 (the
gradient is captured in the step's one graph). Times are the host's
wall clock: with ``FLAGS_fast_step`` a step returns before the card has
run it, so a step's time is its host time until the queue of launched
work fills. Unlike the reference's, ``step_end`` does not bump
``train_steps``: the port's train steps count themselves.
"""
from __future__ import annotations

import time

from . import stats

__all__ = ["TrainerMonitor"]


class TrainerMonitor:
    """Step-time / throughput / recompile telemetry around a train loop."""

    def __init__(self):
        self.history: list = []
        self.step_idx = 0
        self._t0 = None
        self._mark = None

    def reset(self) -> None:
        self.history.clear()
        self.step_idx = 0
        self._t0 = None
        self._mark = None

    def step_begin(self) -> None:
        self._mark = stats.stat_get("jit_compile")
        self._t0 = time.perf_counter()

    def step_end(self, examples=None) -> dict:
        """Close the step; returns the telemetry dict (also appended to
        ``history``). Safe to call without step_begin (returns {})."""
        if self._t0 is None:
            return {}
        dt = time.perf_counter() - self._t0
        tele = {
            "step": self.step_idx,
            "step_time_s": dt,
            "recompiles": stats.stat_get("jit_compile") - self._mark,
        }
        if examples:
            tele["examples_per_sec"] = examples / dt if dt > 0 else 0.0
        self.history.append(tele)
        self.step_idx += 1
        self._t0 = None
        self._mark = None
        return tele

    def summary(self) -> dict:
        """Aggregate over recorded steps. The mean step time leaves out
        step 0 where there are more: the first step carries the capture."""
        if not self.history:
            return {"steps": 0}
        steady = self.history[1:] if len(self.history) > 1 else self.history
        times = [h["step_time_s"] for h in steady]
        out = {
            "steps": len(self.history),
            "first_step_time_s": self.history[0]["step_time_s"],
            "mean_step_time_s": sum(times) / len(times),
            "max_step_time_s": max(times),
            "total_recompiles": sum(h["recompiles"] for h in self.history),
            "total_grad_recompiles": 0,
        }
        ips = [h["examples_per_sec"] for h in steady
               if "examples_per_sec" in h]
        if ips:
            out["mean_examples_per_sec"] = sum(ips) / len(ips)
        return out
