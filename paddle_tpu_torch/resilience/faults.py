"""Deterministic fault injection (``FLAGS_fault_inject``), the port of
``paddle_tpu/resilience/faults.py``.

Spec grammar (comma- or semicolon-separated), the reference's whole
grammar, so that every spec string it accepts parses here too::

    FLAGS_fault_inject="nan_grad@step=50:repeat=3,crash@step=120"
    FLAGS_fault_inject="ckpt_io_error@p=0.5:seed=7:repeat=4"
    FLAGS_fault_inject="stall@step=80:secs=2,preempt@step=200"
    FLAGS_fault_inject="host_loss@step=40:host=h2,kv_partition@step=10:secs=0.5"
    FLAGS_fault_inject="serving_nan@step=3"
    FLAGS_fault_inject="replica_crash@step=30:replica=0,slow_tick@step=5:secs=0.2:repeat=3"

Each fault is ``kind@trigger[:opt=value]*``: the trigger is ``step=N``
(fires on the first ``repeat`` encounters with index >= N, then never
again, so a rollback replay of the same step indices runs clean),
``p=F`` (per encounter with probability F from a private ``seed``-ed
generator), ``restart=N`` or ``call=N`` (the lifecycle and rpc kinds).
Options: ``repeat`` (``times`` is its alias), ``secs``, ``seed``,
``host``, ``replica``, ``method``, ``hosts``.

Kinds and their hook points:

=============  ==========================================  ===============
kind           effect                                      hook point
=============  ==========================================  ===============
nan_grad       float leaves of the batch become NaN (on    train steps
               their device, before a captured step's
               static inputs take them)
crash          raises :class:`InjectedCrash`               train steps
preempt        ``signal.raise_signal(SIGTERM)``            train steps
stall          ``time.sleep(secs)`` inside the step        train steps
host_loss      tombstones ``host`` in the pod's store      resilience/pod.py
kv_partition   :class:`~paddle_tpu_torch.distributed.      resilience/pod.py
               elastic.FileKVStore` raises ``OSError``     (``step=N``) +
               for ``secs`` (a shared-store partition)     distributed/
                                                           elastic.py
input_stall    ``time.sleep(secs)`` in the prefetcher      io/prefetch.py
ckpt_io_error  raises ``OSError`` during a checkpoint      framework/
               save attempt                                checkpoint.py
serving_nan    NaNs one slot's K/V at the first decode     serving/engine.py
               tick of request id >= N (keyed by the
               REQUEST id)
replica_crash  the scheduler raises :class:`InjectedCrash`  serving/engine.py
               at engine tick N (``replica=R`` limits it
               to one replica; keyed by TICK)
slow_tick      ``time.sleep(secs)`` in the scheduler loop  serving/engine.py
               at tick >= N (``repeat=K`` consecutive
               ticks, between them: it stretches the
               queue waits the brownout EWMA reads)
spawn_fail     the supervisor's engine factory raises at   serving/
               its spawn attempt >= N (``restart=N``,      lifecycle.py
               ``times=K``)
replica_flap   a rejoined replica crashes at its next      serving/
               busy tick, for rejoin >= N (``restart=N``)  lifecycle.py
conn_drop      the front end aborts its streaming          serving/
               response >= N after the first piece         frontend.py
               (``step=N`` or ``p=F``; keyed by the
               front end's connection index)
rpc_drop       the client's socket dies before the frame   serving/rpc.py
               leaves (keyed by the client's per-peer
               CALL index; ``method=`` / ``host=``
               filter which calls qualify)
rpc_delay      the receiver sleeps ``secs`` before         serving/rpc.py
               dispatch (the header-deadline shed path)
rpc_corrupt    one byte of the frame flips in flight       serving/rpc.py
               (in the blob when the call carries a crc,
               in the JSON header otherwise)
net_partition  every RPC between host groups               serving/rpc.py
               ``hosts=A|B`` (members joined with ``+``)
               fails fast for ``secs``, both directions
               (``step=N``: the client call index that
               opens the window)
=============  ==========================================  ===============

The train-step hooks live in ``parallel/train_step.py`` and
``jit.TrainStep``; the registry evaluates each step index ONCE and hands
each fired fault to the first hook that claims it. A step index
revisited after a rollback is evaluated again, so a fault with budget
left fires again and a spent one stays quiet.

Cost when idle: every hook site guards on ``ENABLED[0]`` (one list
index); with the flag unset no batch is touched.
"""
from __future__ import annotations

import random as _random
import signal
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core import flags as _flags
from ..monitor import stats as _mstats

__all__ = ["FaultSpec", "FaultRegistry", "InjectedCrash", "FAULTS",
           "ENABLED", "configure_faults", "parse_spec",
           "begin_kv_partition", "kv_partition_active",
           "begin_net_partition", "net_partition_active",
           "net_partition_blocks"]

# fast-path gate: hook sites read ENABLED[0] before touching the registry
ENABLED = [False]

_STEP_KINDS = ("nan_grad", "crash", "preempt", "stall", "host_loss",
               "kv_partition")
# request-id-keyed kinds live in their own index space: a serving request
# id never consumes a step-keyed budget
_RID_KINDS = ("serving_nan",)
# serving-TICK-keyed kinds (per engine replica), each evaluated at one
# hook site
_TICK_KINDS = ("replica_crash", "slow_tick")
_CONN_KINDS = ("conn_drop",)
# kinds keyed by a replica supervisor's own restart indices
_RESTART_KINDS = ("spawn_fail", "replica_flap")
# kinds keyed by an RPC client's per-peer call index
_RPC_KINDS = ("rpc_drop", "rpc_delay", "rpc_corrupt")
# net_partition fires off a client call index too (``step=N``)
_NET_KINDS = ("net_partition",)

# monotonic deadline of the injected shared-store partition window (0.0:
# none); FileKVStore consults kv_partition_active() on every operation
_PARTITION_UNTIL = [0.0]

# injected NETWORK partition: [deadline, (frozenset_a, frozenset_b)];
# RpcClient consults net_partition_blocks(local, peer) before dialing
_NET_PARTITION = [0.0, ()]


def begin_kv_partition(secs: float) -> None:
    """Open an injected shared-store partition window: every FileKVStore
    operation raises OSError until it closes."""
    _PARTITION_UNTIL[0] = time.monotonic() + float(secs)


def kv_partition_active() -> bool:
    return ENABLED[0] and time.monotonic() < _PARTITION_UNTIL[0]


def begin_net_partition(secs: float, groups) -> None:
    """Open an injected network partition window between two host
    groups: every RPC between a host of one group and a host of the other
    fails fast (both directions) until it closes."""
    _NET_PARTITION[1] = tuple(frozenset(str(h) for h in g) for g in groups)
    _NET_PARTITION[0] = time.monotonic() + float(secs)


def net_partition_active() -> bool:
    return ENABLED[0] and time.monotonic() < _NET_PARTITION[0]


def net_partition_blocks(a: str, b: str) -> bool:
    """True when hosts ``a`` and ``b`` sit on opposite sides of the open
    injected partition."""
    if not net_partition_active() or len(_NET_PARTITION[1]) != 2:
        return False
    ga, gb = _NET_PARTITION[1]
    return (a in ga and b in gb) or (a in gb and b in ga)


class InjectedCrash(RuntimeError):
    """Raised by a ``crash@step=N`` fault — stands in for a worker dying
    mid-step (segfault, OOM-kill, device wedging)."""


class FaultSpec:
    """One parsed fault clause."""

    __slots__ = ("kind", "step", "p", "restart", "call", "repeat", "secs",
                 "seed", "host", "replica", "method", "hosts", "remaining",
                 "_rng")

    def __init__(self, kind: str, step: Optional[int] = None,
                 p: Optional[float] = None, repeat: Optional[int] = None,
                 secs: float = 1.0, seed: int = 0,
                 host: Optional[str] = None,
                 replica: Optional[int] = None,
                 restart: Optional[int] = None,
                 call: Optional[int] = None,
                 method: Optional[str] = None,
                 hosts: Optional[str] = None):
        triggers = sum(t is not None for t in (step, p, restart, call))
        if triggers != 1:
            raise ValueError(
                f"fault {kind!r} needs exactly one trigger: step=N, p=F, "
                "restart=N or call=N")
        if restart is not None and kind not in _RESTART_KINDS:
            raise ValueError(
                f"restart= only triggers lifecycle kinds {_RESTART_KINDS}, "
                f"not {kind!r}")
        if kind in _RESTART_KINDS and restart is None:
            raise ValueError(f"{kind} needs restart=N (which supervisor "
                             "spawn/rejoin index fires it)")
        if call is not None and kind not in _RPC_KINDS:
            raise ValueError(
                f"call= only triggers rpc kinds {_RPC_KINDS}, not {kind!r}")
        if kind in _RPC_KINDS and call is None:
            raise ValueError(f"{kind} needs call=N (which per-peer RPC "
                             "call index fires it)")
        if kind == "host_loss" and not host:
            raise ValueError("host_loss needs host=H (which simulated host "
                             "dies)")
        if kind in _NET_KINDS:
            if step is None:
                raise ValueError("net_partition needs step=N (the RPC call "
                                 "index that opens the window)")
            if not hosts or "|" not in str(hosts):
                raise ValueError("net_partition needs hosts=A|B (two host "
                                 "groups; members joined with '+')")
        elif hosts is not None:
            raise ValueError(f"hosts= only applies to net_partition, "
                             f"not {kind!r}")
        self.kind = kind
        self.step = step
        self.p = p
        self.restart = None if restart is None else int(restart)
        self.call = None if call is None else int(call)
        self.host = host
        self.method = method
        self.hosts = None if hosts is None else tuple(
            frozenset(h for h in g.split("+") if h)
            for g in str(hosts).split("|"))
        self.replica = None if replica is None else int(replica)
        # step faults default to firing once; p faults to unlimited
        self.repeat = repeat if repeat is not None else (1 if p is None
                                                        else -1)
        self.secs = float(secs)
        self.seed = int(seed)
        self.remaining = self.repeat
        self._rng = _random.Random(self.seed)

    def spent(self) -> bool:
        return self.remaining == 0

    def consume(self) -> None:
        if self.remaining > 0:
            self.remaining -= 1

    def __repr__(self):
        if self.step is not None:
            trig = f"step={self.step}"
        elif self.restart is not None:
            trig = f"restart={self.restart}"
        elif self.call is not None:
            trig = f"call={self.call}"
        else:
            trig = f"p={self.p}"
        return (f"FaultSpec({self.kind}@{trig}, repeat={self.repeat}, "
                f"remaining={self.remaining})")


def parse_spec(text: str) -> List[FaultSpec]:
    """Parse a FLAGS_fault_inject value into FaultSpecs (empty for '')."""
    out: List[FaultSpec] = []
    for clause in text.replace(";", ",").split(","):
        clause = clause.strip()
        if not clause:
            continue
        if "@" not in clause:
            raise ValueError(f"bad fault clause {clause!r} (need kind@trigger)")
        kind, rest = clause.split("@", 1)
        kw: Dict[str, str] = {}
        for part in rest.split(":"):
            if "=" not in part:
                raise ValueError(f"bad fault option {part!r} in {clause!r}")
            k, v = part.split("=", 1)
            kw[k.strip()] = v.strip()
        if "times" in kw:       # lifecycle-spec alias: times=K == repeat=K
            kw.setdefault("repeat", kw.pop("times"))
        out.append(FaultSpec(
            kind.strip(),
            step=int(kw["step"]) if "step" in kw else None,
            p=float(kw["p"]) if "p" in kw else None,
            repeat=int(kw["repeat"]) if "repeat" in kw else None,
            secs=float(kw.get("secs", 1.0)),
            seed=int(kw.get("seed", 0)),
            host=kw.get("host"),
            replica=int(kw["replica"]) if "replica" in kw else None,
            restart=int(kw["restart"]) if "restart" in kw else None,
            call=int(kw["call"]) if "call" in kw else None,
            method=kw.get("method"), hosts=kw.get("hosts")))
    return out


def _corrupt_batch(batch):
    """NaN the float leaves of a batch (lists, tuples and dicts of
    Tensors, torch tensors or numpy arrays): each is multiplied by NaN on
    its own device, so a card batch stays on the card. Integer leaves are
    untouched (NaN has no integer encoding), so nan_grad needs at least
    one float input."""
    from ..framework.core import Tensor

    def walk(x):
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, Tensor):
            return Tensor(walk(x._data), stop_gradient=x.stop_gradient,
                          name=x.name)
        if isinstance(x, torch.Tensor):
            return x * float("nan") if x.is_floating_point() else x
        dt = getattr(x, "dtype", None)
        if dt is not None and np.issubdtype(np.dtype(dt), np.floating):
            return x * float("nan")
        return x

    return walk(batch)


class FaultRegistry:
    """Holds the configured faults and evaluates them at the hook points.

    Step-keyed faults are evaluated once per step INDEX (the first hook
    to see a new index computes which faults fire; asking again for the
    same index hands each fired fault out only once). A step index
    revisited after a rollback is evaluated again, so a fault with budget
    left fires again and a spent one stays quiet."""

    def __init__(self):
        self.faults: List[FaultSpec] = []
        self._cur_step: Optional[int] = None
        self._cur_fired: Dict[str, FaultSpec] = {}
        self._cur_rid: Optional[int] = None
        self._rid_fired: Dict[str, FaultSpec] = {}

    def configure(self, text: str) -> None:
        if str(text).strip().lower() in ("", "0", "false", "none", "off"):
            text = ""
        self.faults = parse_spec(text or "")
        self._cur_step = None
        self._cur_fired = {}
        self._cur_rid = None
        self._rid_fired = {}
        _PARTITION_UNTIL[0] = 0.0
        _NET_PARTITION[0] = 0.0
        _NET_PARTITION[1] = ()
        ENABLED[0] = bool(self.faults)

    def _fires(self, f: FaultSpec, step: Optional[int]) -> bool:
        if f.spent():
            return False
        if f.step is not None:
            return step is not None and step >= f.step
        return f._rng.random() < f.p

    def _eval_step(self, step: int) -> None:
        if step == self._cur_step:
            return
        self._cur_step = step
        self._cur_fired = {}
        for f in self.faults:
            if f.kind in _STEP_KINDS and f.step is not None \
                    and self._fires(f, step):
                f.consume()
                self._cur_fired[f.kind] = f

    def take(self, kind: str, step: int) -> Optional[FaultSpec]:
        """Claim a step-keyed fault for this step index (None: not
        firing, or already claimed by another hook)."""
        self._eval_step(step)
        return self._cur_fired.pop(kind, None)

    def take_request(self, kind: str, rid: int) -> Optional[FaultSpec]:
        """Claim a REQUEST-id-keyed fault (serving hooks). Each request id
        is evaluated once: a second ask for the same id hands each fired
        fault out only once."""
        if rid != self._cur_rid:
            self._cur_rid = rid
            self._rid_fired = {}
            for f in self.faults:
                if f.kind in _RID_KINDS and f.step is not None \
                        and self._fires(f, rid):
                    f.consume()
                    self._rid_fired[f.kind] = f
        return self._rid_fired.pop(kind, None)

    def take_tick(self, kind: str, replica: Optional[int],
                  tick: int) -> Optional[FaultSpec]:
        """Claim a serving-TICK-keyed fault (replica_crash / slow_tick)
        for one engine's scheduler loop; ``replica=R`` in the spec limits
        the fault to the engine with that ``replica_id`` (None in the
        spec: any engine, the first to reach the tick claims it)."""
        for f in self.faults:
            if f.kind != kind or f.kind not in _TICK_KINDS or f.spent() \
                    or f.step is None:
                continue
            if f.replica is not None and (replica is None
                                          or int(replica) != f.replica):
                continue
            if tick >= f.step:
                f.consume()
                return f
        return None

    def take_restart(self, kind: str, index: int) -> Optional[FaultSpec]:
        """Claim a supervisor-RESTART-keyed fault (spawn_fail /
        replica_flap) for one ReplicaSupervisor spawn-attempt or rejoin
        index: the supervisor owns both counters, so no tick or request
        hook can spend these budgets."""
        for f in self.faults:
            if f.kind != kind or f.kind not in _RESTART_KINDS \
                    or f.spent() or f.restart is None:
                continue
            if index >= f.restart:
                f.consume()
                return f
        return None

    def take_rpc(self, host: str, method: str, index: int
                 ) -> Dict[str, FaultSpec]:
        """Claim every RPC-call-keyed fault due at one client call.

        ``index`` is the calling RpcClient's private per-peer call
        counter, its own index space. ``host=H`` (the PEER host) and
        ``method=M`` in a spec restrict which calls a clause can claim.
        A due ``net_partition`` is consumed here too: it opens the
        module-level window (:func:`net_partition_blocks`) instead of
        riding the returned dict."""
        fired: Dict[str, FaultSpec] = {}
        for f in self.faults:
            if f.spent():
                continue
            if f.kind in _RPC_KINDS:
                if f.host is not None and f.host != host:
                    continue
                if f.method is not None and f.method != method:
                    continue
                if index >= f.call and f.kind not in fired:
                    f.consume()
                    fired[f.kind] = f
            elif f.kind in _NET_KINDS and f.step is not None \
                    and index >= f.step:
                f.consume()
                begin_net_partition(f.secs, f.hosts)
        return fired

    def take_conn(self, index: int) -> Optional[FaultSpec]:
        """Claim a connection-indexed fault (conn_drop) for the front
        end's Nth streaming response (its own index space)."""
        for f in self.faults:
            if f.kind not in _CONN_KINDS or f.spent():
                continue
            if (f.step is not None and index >= f.step) or \
                    (f.p is not None and f._rng.random() < f.p):
                f.consume()
                return f
        return None

    def chance(self, kind: str) -> Optional[FaultSpec]:
        """Per-encounter (p=...) fault draw."""
        for f in self.faults:
            if f.kind == kind and f.p is not None and self._fires(f, None):
                f.consume()
                return f
        return None

    # -- the training hooks -------------------------------------------------
    def on_train_step(self, step: int, batch):
        """The train-step hook: crash, stall, preempt, nan_grad, in that
        order. Returns the (possibly corrupted) batch."""
        f = self.take("crash", step)
        if f is not None:
            _mstats.FAULTS_INJECTED.add()
            raise InjectedCrash(f"injected crash at step {step}")
        f = self.take("stall", step)
        if f is not None:
            _mstats.FAULTS_INJECTED.add()
            time.sleep(f.secs)
        f = self.take("preempt", step)
        if f is not None:
            _mstats.FAULTS_INJECTED.add()
            signal.raise_signal(signal.SIGTERM)
        f = self.take("nan_grad", step)
        if f is not None:
            _mstats.FAULTS_INJECTED.add()
            batch = _corrupt_batch(batch)
        return batch

    def on_input(self, index: int) -> None:
        """Input-pipeline hook (io/prefetch.py's producer, keyed by the
        batch index)."""
        for f in self.faults:
            if f.kind != "input_stall" or f.spent():
                continue
            if (f.step is not None and index >= f.step) or \
                    (f.p is not None and f._rng.random() < f.p):
                f.consume()
                _mstats.FAULTS_INJECTED.add()
                time.sleep(f.secs)

    def on_ckpt_io(self) -> None:
        """Checkpoint-save hook: raises a transient OSError."""
        f = self.chance("ckpt_io_error")
        if f is None:
            for g in self.faults:
                if g.kind == "ckpt_io_error" and g.step is not None \
                        and not g.spent():
                    g.consume()
                    f = g
                    break
        if f is not None:
            _mstats.FAULTS_INJECTED.add()
            raise OSError("injected transient checkpoint I/O error")


FAULTS = FaultRegistry()


def configure_faults(spec: str) -> None:
    """Programmatic twin of ``set_flags({"FLAGS_fault_inject": ...})``."""
    _flags.set_flag("FLAGS_fault_inject", spec or "")


# wire the flag cell: set_flag("FLAGS_fault_inject", ...) (and the
# environment's value read at import) reconfigures the registry at once
_flags.fault_inject_watchers.append(FAULTS.configure)
if _flags.fault_inject[0]:
    FAULTS.configure(_flags.fault_inject[0])
