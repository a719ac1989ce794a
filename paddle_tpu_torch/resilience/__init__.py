"""Resilience of the port (``paddle_tpu.resilience``): deterministic
fault injection (``FLAGS_fault_inject``, :mod:`.faults`), the health
sentinels (:mod:`.sentinel`), the training guardian (:mod:`.guardian`)
and the pod coordinator (:mod:`.pod`).

===============  ==========================  ================================
failure          detected by                 handled by
===============  ==========================  ================================
NaN/Inf loss or  in-step sentinel            the step skips its update on the
gradients        (:mod:`.sentinel`           device (row 7's skip flag, or a
                 finiteness check)           select against copies; buffers
                                             restored); trip counted on the
                                             device, no host read
loss/grad-norm   sentinel EMA z-score        same skip; escalates like a NaN
spike            (``z > z_thresh``)          trip
repeated trips   TrainGuardian ladder        rollback to the host snapshot
(> skip_limit)   (:mod:`.guardian`)          (+ lr backoff, re-seeded data)
trips past       TrainGuardian               :class:`TrainingAborted`
max_rollbacks
process crash    next launch                 ``restore_latest()`` from the
                                             newest readable checkpoint
                                             (``framework/checkpoint.py``)
preemption       SIGTERM handler             priority checkpoint, then the
(SIGTERM)                                    loop stops (``"preempt"``)
stalled step     watchdog thread vs the      ``watchdog_stalls``, every
                 heartbeat gauge             thread's stack dumped, flight
                                             dump
flaky ckpt I/O   OSError during a save       retry with exponential backoff
host loss (pod)  lease staleness or a        pod-agreed rollback step; the
                 tombstone                   resize is the multi-GPU slice's
                 (:class:`PodCoordinator`)   (ROADMAP.md Queue 1 item 7)
poisoned decode  per-tick NaN/latency        serving engine auto-restart:
tick (serving)   sentinel                    poisoned requests fail, healthy
                 (``serving/engine.py        streams resume token-identical
                 watchdog=``)                from replayed history
===============  ==========================  ================================

Gauges: ``faults_injected``, ``sentinel_trips``, ``rollbacks``,
``preempt_saves``, ``watchdog_stalls``, ``guardian_heartbeat_ms``,
``pod_hosts_alive``, ``serving_watchdog_trips``,
``serving_watchdog_restarts``. Spans: ``resilience.snapshot``,
``.snapshot_async``, ``.rollback``, ``.pod_agree``, ``.preempt_save``
and ``resilience.trip`` instants.

Wired in: ``DistributedTrainStep(sentinel=...)``,
``jit.TrainStep(sentinel=...)``, ``hapi.Model.fit(resilience=...)``;
any hand-written loop can use :class:`TrainGuardian` directly.
"""
from . import faults, sentinel
from .faults import FAULTS, FaultSpec, InjectedCrash, configure_faults

__all__ = ["faults", "sentinel", "FAULTS", "FaultSpec", "InjectedCrash",
           "configure_faults", "TrainGuardian", "TrainingAborted",
           "guardian", "PodCoordinator", "PodAgreementError", "pod"]


def __getattr__(name):
    # the guardian pulls in the checkpoint writer: lazy, so the fault
    # hooks of the hot paths never pay for it; the pod stays lazy with it
    import importlib

    if name in ("TrainGuardian", "TrainingAborted", "guardian"):
        mod = importlib.import_module(".guardian", __name__)
        return mod if name == "guardian" else getattr(mod, name)
    if name in ("PodCoordinator", "PodAgreementError", "pod"):
        mod = importlib.import_module(".pod", __name__)
        return mod if name == "pod" else getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
