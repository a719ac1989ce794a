"""Resilience of the port (the serving part of ``paddle_tpu.resilience``):
deterministic fault injection (``FLAGS_fault_inject``, :mod:`.faults`)
and the serving NaN sentinel (:mod:`.sentinel`).

==============  ==========================  ================================
failure         detected by                 handled by
==============  ==========================  ================================
poisoned decode per-tick NaN/latency        serving engine auto-restart:
tick (serving)  sentinel                    poisoned requests fail, healthy
                (``serving/engine.py        streams resume token-identical
                watchdog=``)                from replayed history
==============  ==========================  ================================

Gauges: ``faults_injected``, ``serving_watchdog_trips``,
``serving_watchdog_restarts``. The training side (the in-step sentinel,
``TrainGuardian``, the pod coordinator) is not ported yet.
"""
from . import faults, sentinel
from .faults import FAULTS, FaultSpec, InjectedCrash, configure_faults

__all__ = ["faults", "sentinel", "FAULTS", "FaultSpec", "InjectedCrash",
           "configure_faults"]
