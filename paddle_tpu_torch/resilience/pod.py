"""Pod-wide rollback agreement and host-loss detection
(``paddle_tpu/resilience/pod.py``).

A guardian alone rewinds to ITS snapshot; on a pod every host must
restore the SAME step, or the replicas' optimizer states diverge and the
replay stops being exact. :class:`PodCoordinator` supplies the two
pod-level primitives the guardian composes, over the shared
:class:`~paddle_tpu_torch.distributed.elastic.FileKVStore`:

- :meth:`PodCoordinator.agree_rollback`: propose / commit / ack. Each
  host proposes the snapshot steps it holds; once every live host has
  proposed, the commit is the HIGHEST step present in every proposal
  (deterministic, so racing committers write the same value and the
  atomic-rename put makes the overwrite benign); a laggard that arrives
  after the commit adopts it. An ack barrier holds everyone at the
  commit until the whole pod has restored, so the replay restarts
  aligned. The keys (``jobs/<job>/rollback/<round>/prop|commit|ack``)
  are the reference's, so hosts of both packages can agree in one store.
- :meth:`PodCoordinator.lost_hosts`: the membership verdict. Tombstones
  (``jobs/<job>/dead/<host>``) always count; with ``heartbeat_ttl`` set,
  each host's lease (``jobs/<job>/nodes/<host>``, the reference
  ElasticManager's record, refreshed by :meth:`maybe_heartbeat`) goes
  stale once the SAME payload has been seen for longer than the ttl on
  this host's monotonic clock, so wall-clock skew between hosts cannot
  kill a live one. The step-keyed ``host_loss@step=N:host=H`` and
  ``kv_partition@step=N:secs=S`` faults are claimed here, so an injected
  pod failure surfaces through the same detection path as a real one. A
  store partition makes liveness unknowable, not everyone-dead: a probe
  whose reads raise ``OSError`` reports no losses.

The reference reads leases through its ``ElasticManager`` (``elastic=``);
that manager, ``surviving_devices`` and the resize that consumes a loss
go with the multi-GPU slice (ROADMAP.md Queue 1 item 7).
"""
from __future__ import annotations

import json
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..monitor import stats as _mstats
from ..monitor import trace as _mtrace
from . import faults as _faults

__all__ = ["PodCoordinator", "PodAgreementError"]


class PodAgreementError(RuntimeError):
    """The pod could not agree a rollback step (timeout waiting for
    proposals or acks, or no snapshot step common to every host)."""


class PodCoordinator:
    """One per host; every host of a job shares the FileKVStore.

    Args:
      kv: the shared :class:`FileKVStore`.
      job_id: the job's namespace in the store.
      host: THIS host's name.
      hosts: the pod's full membership (this host included).
      heartbeat_ttl: seconds a host's lease may go unrefreshed before
        :meth:`lost_hosts` reports it (None: tombstones only).
      timeout / poll: the agreement's deadline and poll cadence (s).
    """

    def __init__(self, kv, job_id: str, host: str, hosts: Sequence[str],
                 elastic=None, device_map: Optional[Dict[str, list]] = None,
                 timeout: float = 30.0, poll: float = 0.005,
                 heartbeat_ttl: Optional[float] = None):
        if elastic is not None or device_map is not None:
            raise NotImplementedError(
                "PodCoordinator(elastic=..., device_map=...): the "
                "ElasticManager and the resize's device map go with the "
                "multi-GPU slice, not ported to paddle_tpu_torch yet "
                "(ROADMAP.md Queue 1 item 7); heartbeat_ttl= gives the "
                "lease check without them")
        self.kv = kv
        self.job_id = str(job_id)
        self.host = str(host)
        self.hosts: List[str] = sorted(str(h) for h in hosts)
        if self.host not in self.hosts:
            raise ValueError(f"host {self.host!r} not in pod {self.hosts}")
        self.ttl = None if heartbeat_ttl is None else float(heartbeat_ttl)
        self.timeout = float(timeout)
        self.poll = float(poll)
        self.prefix = f"jobs/{self.job_id}"
        self._round = 0
        # host -> (lease payload ts, local monotonic time first seen)
        self._hb_seen: Dict[str, Tuple[float, float]] = {}

    # -- store helpers (partition-tolerant) ---------------------------------
    def _get(self, key: str) -> Optional[bytes]:
        try:
            return self.kv.get(key)
        except OSError:
            return None

    def _get_prefix(self, prefix: str) -> dict:
        try:
            return self.kv.get_prefix(prefix)
        except OSError:
            return {}

    def _put(self, key: str, value) -> bool:
        try:
            self.kv.put(key, value)
            return True
        except OSError:
            return False   # the partition outlived the retry budget

    # -- rollback agreement -------------------------------------------------
    def agree_rollback(self, held_steps: Sequence[int],
                       expected: Optional[Sequence[str]] = None) -> int:
        """Propose the snapshot steps this host holds; return the
        pod-committed rollback step (the highest step EVERY live host
        holds). Blocks until the commit and the full ack barrier, or
        raises :class:`PodAgreementError` at ``timeout``."""
        self._round += 1
        r = self._round
        base = f"{self.prefix}/rollback/{r}"
        expected = sorted(expected) if expected is not None else self.hosts
        proposal = json.dumps(sorted(int(s) for s in set(held_steps)))
        deadline = time.monotonic() + self.timeout
        proposed = False
        committed: Optional[int] = None
        with _mtrace.span("resilience.pod_agree", cat="resilience",
                          args={"host": self.host, "round": r}):
            while time.monotonic() < deadline:
                if not proposed:
                    proposed = self._put(f"{base}/prop/{self.host}", proposal)
                raw = self._get(f"{base}/commit")
                if raw is not None:
                    committed = int(raw.decode())
                    break
                props = self._get_prefix(f"{base}/prop")
                if proposed and len(props) >= len(expected):
                    sets = [set(json.loads(v.decode()))
                            for v in props.values()]
                    common = set.intersection(*sets) if sets else set()
                    step = max(common) if common else -1
                    if self._put(f"{base}/commit", str(step)):
                        committed = step
                        break
                time.sleep(self.poll)
        if committed is None:
            raise PodAgreementError(
                f"pod rollback round {r}: no commit within "
                f"{self.timeout}s (have "
                f"{sorted(self._get_prefix(f'{base}/prop'))}, need "
                f"{expected})")
        if committed < 0:
            raise PodAgreementError(
                f"pod rollback round {r}: no snapshot step common to "
                f"every host")
        self._put(f"{base}/ack/{self.host}", b"1")
        while time.monotonic() < deadline:
            if len(self._get_prefix(f"{base}/ack")) >= len(expected):
                return committed
            time.sleep(self.poll)
        raise PodAgreementError(
            f"pod rollback round {r}: ack barrier timed out at step "
            f"{committed}")

    # -- membership ---------------------------------------------------------
    def maybe_heartbeat(self) -> None:
        """Refresh this host's lease (a blip rides the store's put retry
        budget; a longer partition just skips the beat)."""
        if self.ttl is None:
            return
        self._put(f"{self.prefix}/nodes/{self.host}",
                  json.dumps({"host": self.host, "status": "alive",
                              "ts": time.time()}))

    def _stale_hosts(self) -> List[str]:
        """Hosts whose lease payload has not changed for a ttl (raises
        OSError on a partitioned store)."""
        now = time.monotonic()
        stale, present = [], set()
        for raw in self.kv.get_prefix(f"{self.prefix}/nodes").values():
            try:
                rec = json.loads(raw.decode())
            except (ValueError, UnicodeDecodeError):
                continue
            host = rec.get("host")
            present.add(host)
            ts = float(rec.get("ts", 0))
            seen = self._hb_seen.get(host)
            if seen is None or seen[0] != ts:
                self._hb_seen[host] = (ts, now)
            elif now - seen[1] > self.ttl:
                stale.append(host)
        for host in [h for h in self._hb_seen if h not in present]:
            del self._hb_seen[host]
        return stale

    def lost_hosts(self, step: Optional[int] = None) -> List[str]:
        """Hosts of this pod that are gone: tombstoned, or lease-stale when
        ``heartbeat_ttl`` is set. ``step`` also claims the step-keyed
        ``host_loss`` / ``kv_partition`` faults."""
        if step is not None and _faults.ENABLED[0]:
            f = _faults.FAULTS.take("kv_partition", step)
            if f is not None:
                _mstats.FAULTS_INJECTED.add()
                _faults.begin_kv_partition(f.secs)
            f = _faults.FAULTS.take("host_loss", step)
            if f is not None:
                _mstats.FAULTS_INJECTED.add()
                self._put(f"{self.prefix}/dead/{f.host}", b"1")
        try:
            dead = {k.rsplit("/", 1)[1]
                    for k in self.kv.get_prefix(f"{self.prefix}/dead")}
            if self.ttl is not None:
                dead.update(self._stale_hosts())
        except OSError:
            return []      # a partition: liveness unknowable, not all-dead
        lost = sorted(h for h in self.hosts if h in dead)
        _mstats.POD_HOSTS_ALIVE.set(len(self.hosts) - len(lost))
        return lost

    def remove_hosts(self, lost: Sequence[str]) -> List[str]:
        """Shrink the expected membership; returns the surviving hosts."""
        lost_set = set(lost)
        self.hosts = [h for h in self.hosts if h not in lost_set]
        return list(self.hosts)

    def surviving_devices(self, lost: Sequence[str]) -> list:
        raise NotImplementedError(
            "PodCoordinator.surviving_devices feeds the elastic resize, "
            "which goes with the multi-GPU slice (ROADMAP.md Queue 1 "
            "item 7)")
