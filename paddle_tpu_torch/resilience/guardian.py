"""TrainGuardian: snapshot, skip, rollback, preempt, watchdog
(``paddle_tpu/resilience/guardian.py``).

The guardian wraps a train step (``jit.TrainStep`` or
``DistributedTrainStep``) and composes the in-step sentinel, the
checkpoint manager and the gauges into a loop that survives NaNs,
stalls, crashes and preemption:

- **snapshot ring in host memory**: every ``snapshot_every`` healthy
  steps the whole training state (params, optimizer state with its
  count or beta pows, buffers, the sentinel state, the step device's
  generator state, the step count) is copied into host buffers that are
  allocated once per ring slot (``keep_snapshots`` of them) and pinned
  (``cuMemHostRegister``) for the card: the copy runs on a side stream
  behind an event, and the step's stream waits on that event before its
  next in-place update, so the loop thread never blocks on it.
  ``resilience.snapshot`` span.
- **escalation ladder** on sentinel trips (read from the device trip
  counter every ``check_every`` steps, the guardian's only host read):
  the step itself has already skipped the poisoned update; after
  ``skip_limit`` consecutive tripped steps the guardian REWINDS to the
  newest snapshot (``resilience.rollback`` span, ``rollbacks`` gauge),
  multiplies the learning rate by ``lr_backoff`` (1.0: off, so the
  replay stays bit-exact) and bumps ``data_seed`` so the caller
  re-seeds its data order; past ``max_rollbacks`` rewinds it raises
  :class:`TrainingAborted`.
- **install, never rebind**: a rollback or a restore COPIES into the
  step's own tensors (params, slots, beta pows, buffers, the sentinel
  state): a captured CUDA graph replays against fixed addresses, so a
  rebound tensor would be silently ignored. The generator state goes
  back through ``framework/random.py``, so replay k + 1 after a rewind
  draws what it drew the first time.
- **on disk** (``ckpt_dir``): interval-gated checkpoints
  (``framework/checkpoint.py``). With ``async_snapshot=True`` the loop
  thread only starts the device-to-host copy into one of two alternating
  host buffers (the first allocated at attach, the second when first
  needed, each once); a snapshot thread
  waits for the copy's event and writes, reading host tensors only
  (``resilience.snapshot_async`` spans). When both buffers are taken the
  oldest pending state is dropped: a slow filesystem thins the cadence,
  it never stalls the loop.
- **pod agreement** (``pod=PodCoordinator(...)``): the rollback step is
  agreed pod-wide first (:mod:`.pod`), so every host restores the same
  step.
- **preemption**: ``install_preemption_handler()`` catches SIGTERM; the
  next ``after_step`` writes a priority checkpoint (``preempt_saves``)
  and returns ``"preempt"`` so the loop can exit cleanly; the relaunched
  run resumes through :meth:`restore_latest`.
- **watchdog**: a daemon thread watches the heartbeat every
  ``after_step`` gives (``guardian_heartbeat_ms``); a step silent for
  ``watchdog_timeout`` seconds bumps ``watchdog_stalls``, dumps every
  thread's stack to ``<ckpt_dir>/watchdog_stall.txt`` and dumps the
  flight recorder (``monitor/flight.py``). The guardian's own bounded
  work (installing a state, pinning host buffers) holds the watchdog
  quiet. Its I/O waits (a drain of the writer, the priority save, a
  restore's read) are no stalled steps either, but one that outlasts
  ``watchdog_timeout`` is reported once as an I/O stall: the same
  dumps and a warning naming the wait, and an entry in ``stall_log``,
  but not in ``watchdog_stalls`` (the reference counts both kinds
  there).

Elastic resize over surviving hosts (``rebuild=``, ``resize``) and the
``ElasticManager`` (``elastic=``) go with the multi-GPU slice (ROADMAP.md
Queue 1 item 7) and raise ``NotImplementedError``.

Usage::

    g = TrainGuardian(step, ckpt_dir=dir, snapshot_every=20,
                      watchdog_timeout=300)
    g.install_preemption_handler()
    start = g.restore_latest() or 0          # crash auto-resume
    i = start
    while i < n_steps:
        loss = g.step(batch_at(i, seed=g.data_seed))
        action = g.after_step(i, loss)
        if action == "rollback":
            i = g.resume_step                # replay from the snapshot
            continue
        if action == "preempt":
            break                            # priority save already done
        i += 1
    g.close()
"""
from __future__ import annotations

import contextlib
import ctypes
import mmap
import os
import signal
import sys
import threading
import time
import warnings
from typing import Optional

import torch

from ..framework.checkpoint import _flatten, _unflatten
from ..monitor import stats as _mstats
from ..monitor import trace as _mtrace
from . import sentinel as _sentinel

__all__ = ["TrainGuardian", "TrainingAborted"]


class TrainingAborted(RuntimeError):
    """The escalation ladder ran out: more than ``max_rollbacks`` rewinds
    (or an unrecoverable restore failure). Training must stop."""


def _item7(what: str):
    raise NotImplementedError(
        f"TrainGuardian: {what} goes with the multi-GPU slice, not ported "
        f"to paddle_tpu_torch yet (ROADMAP.md Queue 1 item 7)")


# -- host copies of a state tree ---------------------------------------------

_LEAF_ALIGN = 256               # bytes between leaves in a host arena
_CU: list = [None]              # libcuda, loaded at the first pinning
_PIN_FAILURES = [0]
_CUDA_ERROR_INVALID_CONTEXT = 201


def _cuda_driver():
    """libcuda through ctypes. Its calls return their error and leave the
    CUDA runtime's last error alone: a refused ``cudaHostRegister`` would
    stay there, and the next unrelated launch check would report it."""
    if _CU[0] is None:
        lib = ctypes.CDLL("libcuda.so.1")
        lib.cuMemHostRegister_v2.argtypes = [ctypes.c_void_p,
                                             ctypes.c_size_t, ctypes.c_uint]
        lib.cuMemHostUnregister.argtypes = [ctypes.c_void_p]
        _CU[0] = lib
    return _CU[0]


def _pin(ptr: int, nbytes: int, dev) -> bool:
    """Page-lock ``[ptr, ptr + nbytes)`` for the card. When CUDA
    refuses (a low memlock limit, say), warn, count it (see
    :func:`host_pin_failures`) and return False: the buffer stays
    pageable, and each copy into it then blocks the host until the card
    is done."""
    cu = _cuda_driver()
    rc = cu.cuMemHostRegister_v2(ptr, nbytes, 0)
    if rc == _CUDA_ERROR_INVALID_CONTEXT:
        torch.cuda.synchronize(dev)     # the card's context on this thread
        rc = cu.cuMemHostRegister_v2(ptr, nbytes, 0)
    if rc == 0:
        return True
    _PIN_FAILURES[0] += 1
    warnings.warn(f"TrainGuardian: page-locking {nbytes} host bytes "
                  f"failed (CUresult {rc}); the snapshot buffer stays "
                  "pageable and its copies block the host")
    return False


def host_pin_failures() -> int:
    """Snapshot buffers this process could not page-lock. A counter of
    the port's own, kept out of the stats registry, whose families are
    the reference's."""
    return _PIN_FAILURES[0]


def _unpin(ptr: int) -> None:
    rc = _cuda_driver().cuMemHostUnregister(ptr)
    if rc != 0:
        warnings.warn(f"TrainGuardian: unregistering a pinned snapshot "
                      f"buffer failed (CUresult {rc})")


class _HostCopy:
    """Host buffers shaped like a state tree, allocated once and refilled
    in place. The leaves are views of one anonymous memory mapping: it is
    page-aligned and shares no page with any other allocation, so for
    card tensors it is page-locked whole, at its exact size, with one
    ``cuMemHostRegister`` that cannot overlap another registered range
    (the caching pinned allocator would round each leaf up to a power of
    two). Each leaf has storage of its own size, so ``torch.save`` writes
    only its bytes. The copy runs on a side stream and records an event,
    and the current stream waits on it, so the next in-place update
    cannot overtake the copy and the host never blocks. :meth:`wait` (a
    host sync on that event) precedes any read. The mapping is
    registered as mapped: CUDA faults its pages in at 1.70-1.83
    GB/s, against 1.37-1.44 GB/s when PyTorch writes zeros into it
    first (``tools/host_io_study.py``, two runs of 5.15 GB on an NVIDIA
    H100 80GB HBM3 host, 700.00 W)."""

    def __init__(self, state):
        leaves: list = []
        self.spec = _flatten(state, (), leaves)
        offsets, total = [], 0
        for _, t in leaves:
            offsets.append(total)
            n = t.numel() * t.element_size()
            total += -(-n // _LEAF_ALIGN) * _LEAF_ALIGN
        self.nbytes = sum(t.numel() * t.element_size() for _, t in leaves)
        arena = mmap.mmap(-1, total) if total else None
        self.host = [
            torch.frombuffer(arena, dtype=t.dtype, count=t.numel(),
                             offset=o).view(t.shape)
            if t.numel() else torch.zeros(t.shape, dtype=t.dtype)
            for (_, t), o in zip(leaves, offsets)]
        self._pinned_ptr = None
        dev = next((t.device for _, t in leaves if t.device.type == "cuda"),
                   None)
        if arena is not None and dev is not None:
            ptr = torch.frombuffer(arena, dtype=torch.uint8).data_ptr()
            if _pin(ptr, total, dev):
                self._pinned_ptr = ptr
        self.event = None
        self.t_issue = 0.0          # when the last fill was issued

    @property
    def pinned(self) -> bool:
        return self._pinned_ptr is not None

    def fill(self, state) -> None:
        pairs: list = []
        if _flatten(state, (), pairs) != self.spec:
            raise ValueError("the train step's state changed its structure")
        leaves = [t for _, t in pairs]
        self.t_issue = time.perf_counter()
        dev = next((t.device for t in leaves if t.device.type == "cuda"),
                   None)
        if dev is None:
            for h, t in zip(self.host, leaves):
                h.copy_(t)
            self.event = None
        else:
            cur = torch.cuda.current_stream(dev)
            side = torch.cuda.Stream(dev)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                for h, t in zip(self.host, leaves):
                    h.copy_(t, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(side)
            # the step's next in-place update waits for the copy
            cur.wait_event(ev)
            self.event = ev

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()

    def tree(self):
        self.wait()
        return _unflatten(self.spec, self.host)

    def release(self) -> None:
        """Unregister the pinned mapping (before it can be freed) and drop
        the buffers."""
        self.wait()
        if self._pinned_ptr is not None:
            _unpin(self._pinned_ptr)
            self._pinned_ptr = None
        self.host = []

    def __del__(self):
        if self._pinned_ptr is not None:
            self.release()


class TrainGuardian:
    """Wraps a train step with self-healing behaviour (see the module's
    docstring); every threshold is a per-instance knob."""

    def __init__(self, step=None, ckpt_dir: Optional[str] = None,
                 snapshot_every: int = 25, skip_limit: int = 2,
                 max_rollbacks: int = 3, check_every: int = 1,
                 sentinel=True, watchdog_timeout: Optional[float] = None,
                 elastic=None, save_interval_steps: int = 1,
                 max_to_keep: int = 3, keep_snapshots: int = 1,
                 async_snapshot: bool = False, lr_backoff: float = 1.0,
                 pod=None, rebuild=None):
        if elastic is not None:
            _item7("elastic= (the ElasticManager)")
        if rebuild is not None:
            _item7("rebuild= (the elastic resize)")
        self.snapshot_every = max(1, int(snapshot_every))
        self.skip_limit = int(skip_limit)
        self.max_rollbacks = int(max_rollbacks)
        self.check_every = max(1, int(check_every))
        self.sentinel_config = (_sentinel.normalize_config(sentinel)
                                if sentinel else None)
        self.watchdog_timeout = watchdog_timeout
        self.pod = pod
        if pod is not None:
            from ..monitor.flight import set_host_id

            set_host_id(pod.host)
        if watchdog_timeout and ckpt_dir is not None:
            from ..monitor.flight import arm_flight_recorder

            arm_flight_recorder(ckpt_dir)
        self.keep_snapshots = max(1, int(keep_snapshots))
        self.async_snapshot = bool(async_snapshot)
        self.lr_backoff = float(lr_backoff)
        self._lr_scale = 1.0
        self.data_seed = 0
        self.ckpt_dir = ckpt_dir
        self._ckpt = None
        self._ckpt_opts = (int(save_interval_steps), int(max_to_keep))
        self._obj = None
        self._step_obj = None
        self._snaps: dict = {}          # step index -> _HostCopy (ring)
        # async on-disk writer: two alternating host buffers, the pending
        # (step, buffer) queue and the buffer being written
        self._disk_bufs: list = []
        self._snap_pending: list = []
        self._snap_writing = None
        self._disk_queued = None    # newest step handed to the writer
        self._snap_cv = threading.Condition()
        self._snap_thread = None
        self._snap_stop = False
        self._consec = 0
        self._trips_seen = 0
        self._rollbacks = 0
        self._preempted = False
        self._prev_sigterm = None
        self._beat_lock = threading.Lock()
        self._last_beat = time.monotonic()
        self._watchdog = None
        self._watchdog_stop = threading.Event()
        self._quiet = 0         # >0 during the guardian's bounded work
        self._io = None         # the guardian's I/O wait under way
        self._io_reported = False
        # (monotonic time, seconds of silence, "step" or the I/O wait's
        # name) of each stall reported
        self.stall_log: list = []
        self._closed = False
        self.last_priority_save = None
        if step is not None:
            self.attach(step)

    # -- attachment -----------------------------------------------------------
    @property
    def step(self):
        """The attached train step."""
        return self._obj

    def attach(self, obj) -> "TrainGuardian":
        """Bind a train step; takes the initial snapshot so a rollback is
        possible from step 0."""
        self._obj = obj
        self._step_obj = getattr(obj, "train_step", obj)
        if self.ckpt_dir is not None and self._ckpt is None:
            from ..framework.checkpoint import CheckpointManager

            interval, keep = self._ckpt_opts
            self._ckpt = CheckpointManager(
                self.ckpt_dir, save_interval_steps=interval,
                max_to_keep=keep, async_save=False)
        self.snapshot(-1)
        if self.async_snapshot and self._ckpt is not None:
            # the writer's first buffer now (pinning it takes seconds at
            # gpt_1p3b: not inside a step the watchdog times)
            if not self._disk_bufs:
                with self._busy():
                    self._disk_bufs.append(_HostCopy(self._capture()))
            self._start_snap_thread()
        if self.watchdog_timeout:
            self._start_watchdog()
        return self

    def _device(self):
        s = self._step_obj
        return getattr(s, "device", None)

    # -- state capture / install ----------------------------------------------
    def _capture(self) -> dict:
        """The whole training state as a tree of the step's own tensors
        (live references, not copies)."""
        from ..framework.random import get_rng_state

        s = self._step_obj
        out: dict = {"rng": get_rng_state(self._device()),
                     "step_count": torch.tensor(
                         int(getattr(s, "_step_count", 0)),
                         dtype=torch.int64)}
        if hasattr(s, "params") and hasattr(s, "opt_state"):
            out["params"] = s.params
            out["opt_state"] = s.opt_state
        elif hasattr(s, "_params") and hasattr(s, "_slot_values"):
            out["params"] = {k: p._data for k, p in s._params.items()}
            out["slots"] = {k: [t for t in v if isinstance(t, torch.Tensor)]
                            for k, v in s._slot_values.items()}
            bufs = {k: b._data for k, b in s.model.named_buffers()
                    if b is not None}
            if bufs:
                out["buffers"] = bufs
        else:
            raise TypeError(
                f"TrainGuardian cannot snapshot {type(s).__name__}: need a "
                "DistributedTrainStep-like (.params/.opt_state) or "
                "jit.TrainStep-like (._params/._slot_values) object")
        st = getattr(s, "sentinel_state", None)
        if st is not None:
            out["sentinel"] = st
        return out

    @torch.no_grad()
    def _install(self, state: dict) -> None:
        """Copy a host (or loaded) state INTO the step's own tensors."""
        from ..framework.checkpoint import _copy_tree_into
        from ..framework.random import set_rng_state

        live = self._capture()
        if "rng" in state:
            set_rng_state(state["rng"], self._device())
        for key in ("params", "opt_state", "slots", "buffers", "sentinel"):
            if key in state and key in live:
                _copy_tree_into(live[key], state[key])
        s = self._step_obj
        if "step_count" in state and hasattr(s, "_step_count"):
            s._step_count = int(state["step_count"])

    # -- snapshot / rollback -----------------------------------------------------
    def _span_args(self, **kw) -> dict:
        if self.pod is not None:
            kw["host"] = self.pod.host
        return kw

    def snapshot(self, step_idx: int) -> None:
        """Copy the state into the host ring (keeps the newest
        ``keep_snapshots``; the oldest slot's buffers are reused)."""
        with _mtrace.span("resilience.snapshot", cat="resilience",
                          args=self._span_args(step=step_idx)):
            state = self._capture()
            buf = None
            if len(self._snaps) >= self.keep_snapshots:
                buf = self._snaps.pop(min(self._snaps))
            if buf is None:
                with self._busy():      # pinning: seconds at gpt_1p3b
                    buf = _HostCopy(state)
            buf.fill(state)
            self._snaps[int(step_idx)] = buf

    @property
    def resume_step(self) -> int:
        """First step index to (re)run after a rollback or restore."""
        return (max(self._snaps) + 1) if self._snaps else 0

    def rollback(self) -> int:
        """Rewind to the newest snapshot (pod-agreed with a coordinator).
        Returns the step index to resume from; raises
        :class:`TrainingAborted` past ``max_rollbacks``."""
        if not self._snaps:
            raise TrainingAborted("sentinel tripped but no snapshot exists")
        self._rollbacks += 1
        _mstats.ROLLBACKS.add()
        if self._rollbacks > self.max_rollbacks:
            raise TrainingAborted(
                f"aborting: {self._rollbacks} rollbacks exceed "
                f"max_rollbacks={self.max_rollbacks}")
        step_idx = self._agree_step()
        with self._busy(), _mtrace.span(
                "resilience.rollback", cat="resilience",
                args=self._span_args(to_step=step_idx,
                                     rollback=self._rollbacks)):
            self._install(self._snaps[step_idx].tree())
            self._discard_after(step_idx)
            st = getattr(self._step_obj, "sentinel_state", None)
            if st is not None:
                # a fresh verdict baseline: the EMA saw the fault window
                _sentinel.reset_state(st)
            self._consec = 0
            self._trips_seen = 0
            self.data_seed += 1
            self._backoff_lr()
        return self.resume_step

    def _agree_step(self) -> int:
        """The snapshot step to restore: pod-committed when coordinated,
        else the newest held."""
        if self.pod is None:
            return max(self._snaps)
        from .pod import PodAgreementError

        try:
            step_idx = self.pod.agree_rollback(sorted(self._snaps))
        except PodAgreementError as e:
            raise TrainingAborted(f"pod rollback agreement failed: {e}") \
                from e
        if step_idx not in self._snaps:
            raise TrainingAborted(
                f"pod committed step {step_idx} but this host holds "
                f"{sorted(self._snaps)}")
        return step_idx

    def _discard_after(self, step_idx: int) -> None:
        """Drop ring snapshots newer than the restored step (taken on the
        abandoned timeline); their buffers are released."""
        for s in [s for s in self._snaps if s > step_idx]:
            self._snaps.pop(s).release()

    def _backoff_lr(self) -> None:
        """The post-rollback learning-rate backoff (``lr_backoff=1.0``
        leaves it, and the replay bit-exact)."""
        if self.lr_backoff == 1.0:
            return
        self._lr_scale *= self.lr_backoff
        s = self._step_obj
        if hasattr(s, "scale_lr"):
            s.scale_lr(self._lr_scale)
        else:
            warnings.warn(
                f"lr_backoff={self.lr_backoff} set but "
                f"{type(s).__name__} has no scale_lr(); learning rate "
                "left unchanged")

    # -- per-step driver ---------------------------------------------------------
    def after_step(self, step_idx: int, loss=None) -> str:
        """Call once per completed step. Returns ``"ok"``, ``"skip"`` (the
        step discarded a poisoned update), ``"rollback"`` (state rewound:
        resume from :attr:`resume_step` with a re-seeded data order) or
        ``"preempt"`` (priority checkpoint written: exit)."""
        del loss  # the verdict is read from the device state
        self._beat()
        if self._preempted:
            self._priority_save(step_idx)
            return "preempt"
        st = getattr(self._step_obj, "sentinel_state", None)
        # the verdict's host read first: a host copy queued below makes
        # the step's stream wait for it
        trips = (int(st["trips"]) if st is not None
                 and step_idx % self.check_every == 0 else None)
        if self._ckpt is not None:
            if self.async_snapshot:
                self._enqueue_disk_save(step_idx)
            else:
                self._ckpt.maybe_save(step_idx, self._capture())
        action = "ok"
        if trips is not None:
            delta = trips - self._trips_seen
            self._trips_seen = trips
            if delta > 0:
                _mstats.SENTINEL_TRIPS.add(delta)
                _mtrace.emit_instant("resilience.trip", time.perf_counter(),
                                     cat="resilience")
                self._consec += 1
                if self._consec > self.skip_limit:
                    self.rollback()
                    return "rollback"
                action = "skip"
            else:
                self._consec = 0
        if self.pod is not None and step_idx % self.check_every == 0:
            self.pod.maybe_heartbeat()
            lost = self.pod.lost_hosts(step_idx)
            if lost:
                self.resize(lost)
        if action == "ok" and step_idx >= 0 \
                and step_idx % self.snapshot_every == 0:
            self.snapshot(step_idx)
        return action

    def resize(self, lost) -> int:
        """Host loss → re-plan over the survivors: the multi-GPU slice's."""
        _item7(f"resize over the hosts left after losing {sorted(lost)}")

    # -- async on-disk writer ----------------------------------------------------
    def _take_disk_buf(self, state):
        """A free one of the two alternating buffers (made on first
        need); with both taken, the oldest pending state is dropped and
        its buffer reused. Called with ``_snap_cv`` held."""
        busy = {id(b) for _, b in self._snap_pending}
        if self._snap_writing is not None:
            busy.add(id(self._snap_writing))
        for b in self._disk_bufs:
            if id(b) not in busy:
                return b
        if len(self._disk_bufs) < 2:
            with self._busy():
                b = _HostCopy(state)
            self._disk_bufs.append(b)
            return b
        # both in use: the filesystem is slower than the save cadence
        return self._snap_pending.pop(0)[1]

    def _enqueue_disk_save(self, step_idx: int) -> None:
        """Start the interval-gated on-disk save: the device-to-host copy
        is issued HERE (the step's tensors change in place at the next
        step); the snapshot thread writes the host buffer."""
        # a step still being written counts as saved: the interval runs
        # from it, not from the newest step already on disk
        if not self._ckpt.should_save(step_idx, pending=self._disk_queued):
            return
        state = self._capture()
        with self._snap_cv:
            buf = self._take_disk_buf(state)
            buf.fill(state)
            self._snap_pending.append((int(step_idx), buf))
            self._disk_queued = int(step_idx)
            self._snap_cv.notify_all()

    def _snap_loop(self) -> None:
        while True:
            with self._snap_cv:
                while not self._snap_pending and not self._snap_stop:
                    self._snap_cv.wait(0.1)
                if self._snap_stop and not self._snap_pending:
                    return
                step_idx, buf = self._snap_pending.pop(0)
                self._snap_writing = buf
            try:
                with _mtrace.span("resilience.snapshot_async",
                                  cat="resilience",
                                  args=self._span_args(step=step_idx)):
                    self._ckpt.save_behind(step_idx, buf.tree())
            except Exception as e:  # noqa: BLE001 - a failed background
                # save must not kill training; the next cadence retries
                warnings.warn(f"async checkpoint save at step {step_idx} "
                              f"failed: {type(e).__name__}: {e}")
            finally:
                with self._snap_cv:
                    self._snap_writing = None
                    self._snap_cv.notify_all()

    def _start_snap_thread(self) -> None:
        if self._snap_thread is not None:
            return
        self._snap_stop = False
        self._snap_thread = threading.Thread(
            target=self._snap_loop, name="train-guardian-snapshot",
            daemon=True)
        self._snap_thread.start()

    def drain_snapshots(self, timeout: float = 600.0) -> None:
        """Block until the snapshot thread has nothing pending or in
        flight (rollback, restore, the priority save and shutdown wait
        here)."""
        if self._snap_thread is None:
            return
        deadline = time.monotonic() + timeout
        with self._io_wait("writer drain"), self._snap_cv:
            while self._snap_pending or self._snap_writing is not None:
                if not self._snap_cv.wait(0.05) \
                        and time.monotonic() > deadline:
                    warnings.warn("drain_snapshots timed out with a "
                                  "disk write still in flight")
                    return

    # -- crash auto-resume ---------------------------------------------------------
    def restore_latest(self) -> Optional[int]:
        """Resume from the newest readable on-disk checkpoint (None when
        there is no checkpoint directory or nothing to restore); a step
        that cannot be read is skipped with a warning. The state is read
        into host tensors and copied into the step's own."""
        if self._ckpt is None:
            return None
        with self._io_wait("restore"):
            self.drain_snapshots()
            template = next(iter(self._snaps.values())).tree() \
                if self._snaps else self._capture()
            got = self._ckpt.restore_latest_tree(template)
        if got is None:
            return None
        step_idx, state = got
        with self._busy():
            self._install(state)
            del state
            self.snapshot(step_idx)
        return step_idx + 1

    # -- preemption ------------------------------------------------------------------
    def install_preemption_handler(self, sig: int = signal.SIGTERM) -> bool:
        """Install the SIGTERM handler (main thread only: False
        elsewhere). The handler only flags; the save happens at the next
        ``after_step``, on the training thread."""

        def _handler(signum, frame):
            del signum, frame
            self._preempted = True

        try:
            self._prev_sigterm = signal.signal(sig, _handler)
            return True
        except ValueError:  # not the main thread
            return False

    @property
    def preempted(self) -> bool:
        return self._preempted

    def _priority_save(self, step_idx: int) -> None:
        with self._io_wait("priority save"):
            self._priority_save_io(step_idx)

    def _priority_save_io(self, step_idx: int) -> None:
        self.drain_snapshots()
        with _mtrace.span("resilience.preempt_save", cat="resilience",
                          args=self._span_args(step=step_idx)):
            t0 = time.perf_counter()
            if self._ckpt is not None:
                state = self._capture()
                if self._disk_bufs:
                    # the async writer's buffer is free after the drain
                    buf = self._disk_bufs[0]
                    buf.fill(state)
                    state = buf.tree()
                self._ckpt.save(max(step_idx, 0), state)
                self._ckpt.wait_until_finished()
                self.last_priority_save = {
                    "step": max(step_idx, 0),
                    "bytes": self._ckpt.last_save_bytes,
                    "write_s": self._ckpt.last_save_s,
                    "s": time.perf_counter() - t0}
            else:
                self.snapshot(step_idx)
            _mstats.PREEMPT_SAVES.add()

    # -- watchdog ----------------------------------------------------------------------
    @contextlib.contextmanager
    def _busy(self):
        """The guardian's own bounded work (installing a state, pinning
        host buffers): the watchdog stays quiet, and the heartbeat
        restarts when it ends."""
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1
            self._beat()

    @contextlib.contextmanager
    def _io_wait(self, what: str):
        """An I/O wait of the guardian's, timed from its start: no
        stalled step, but one that outlasts ``watchdog_timeout`` is
        reported once as an I/O stall (a wedged filesystem is what a
        watchdog is for). The outermost wait names the report."""
        outer = self._io is not None
        if not outer:
            self._beat()
            self._io_reported = False
            self._io = what
        try:
            yield
        finally:
            if not outer:
                self._io = None
            self._beat()

    def _beat(self) -> None:
        now = time.monotonic()
        with self._beat_lock:
            self._last_beat = now
        _mstats.GUARDIAN_HEARTBEAT_MS.set(int(now * 1e3))

    def _start_watchdog(self) -> None:
        if self._watchdog is not None:
            return
        # the clock starts now, not at construction (attach pins the
        # host buffers first: seconds at gpt_1p3b)
        self._beat()
        self._watchdog_stop.clear()
        self._watchdog = threading.Thread(
            target=self._watchdog_loop, name="train-guardian-watchdog",
            daemon=True)
        self._watchdog.start()

    def _watchdog_loop(self) -> None:
        timeout = float(self.watchdog_timeout)
        poll = max(0.02, min(timeout / 4.0, 0.25))
        while not self._watchdog_stop.wait(poll):
            now = time.monotonic()
            io = self._io
            with self._beat_lock:
                silence = now - self._last_beat
                stalled = silence > timeout
                if io is None and (stalled or self._quiet):
                    self._last_beat = now       # one report per stall
            if io is not None:
                if stalled and not self._io_reported:
                    self._io_reported = True
                    self._report(now, silence, io)
            elif stalled and not self._quiet:
                self._report(now, silence, None)

    def _report(self, now: float, silence: float, io) -> None:
        self.stall_log.append((now, silence, io or "step"))
        if io is None:
            _mstats.WATCHDOG_STALLS.add()
        self._dump_stall(io)

    def _dump_stall(self, io=None) -> None:
        """Stack dump, trace flush and flight dump for a stalled step,
        or for the I/O wait ``io``."""
        import faulthandler

        what = (f"guardian I/O stall in the {io}" if io
                else "watchdog stall")
        target = None
        try:
            if self.ckpt_dir is not None:
                os.makedirs(self.ckpt_dir, exist_ok=True)
                target = os.path.join(self.ckpt_dir, "watchdog_stall.txt")
                with open(target, "a") as f:
                    f.write(f"=== {what} at {time.time():.3f} "
                            f"(no heartbeat for >{self.watchdog_timeout}s) "
                            f"===\n")
                    faulthandler.dump_traceback(file=f)
            else:
                faulthandler.dump_traceback(file=sys.stderr)
        except Exception:  # noqa: BLE001 - diagnostics must not kill training
            pass
        try:
            if _mtrace.TRACING[0]:
                base = self.ckpt_dir or "."
                _mtrace.get_writer().write(
                    os.path.join(base, "watchdog_trace.json"))
        except Exception:  # noqa: BLE001
            pass
        from ..monitor.flight import dump_flight

        dump_flight("guardian_io_stall" if io else "guardian_watchdog_stall",
                    trace_dir=self.ckpt_dir,
                    extra={"watchdog_timeout": self.watchdog_timeout,
                           "io": io})
        warnings.warn(
            (f"watchdog: the guardian's {io} has waited" if io
             else "watchdog: training step stalled")
            + f" for >{self.watchdog_timeout}s"
            + (f"; stacks dumped to {target}" if target else ""))

    # -- lifecycle ---------------------------------------------------------------------
    def close(self) -> None:
        """Stop the threads, restore the SIGTERM handler and release the
        host buffers."""
        if self._closed:
            return
        self._closed = True
        if self._snap_thread is not None:
            self.drain_snapshots()
            with self._snap_cv:
                self._snap_stop = True
                self._snap_cv.notify_all()
            self._snap_thread.join(timeout=5.0)
            self._snap_thread = None
        self._watchdog_stop.set()
        if self._watchdog is not None:
            self._watchdog.join(timeout=1.0)
            self._watchdog = None
        if self._prev_sigterm is not None:
            try:
                signal.signal(signal.SIGTERM, self._prev_sigterm)
            except ValueError:
                pass
            self._prev_sigterm = None
        if self._ckpt is not None:
            self._ckpt.close()
            self._ckpt = None
        for buf in list(self._snaps.values()) + self._disk_bufs:
            buf.release()
        self._snaps = {}
        self._disk_bufs = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
