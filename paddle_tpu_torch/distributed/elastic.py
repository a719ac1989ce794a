"""The fleet's membership store (the port of ``FileKVStore`` and
``_partition_check`` from ``paddle_tpu/distributed/elastic.py``).

:class:`FileKVStore` is an etcd analog over a shared directory (NFS or
a fuse mount on real hosts, a temp directory in tests): keys are
``/``-separated paths, values bytes, every write is atomic (a temp file
renamed into place) and rides a retry budget for transient ``OSError``.
:meth:`FileKVStore.put_bytes` frames a value with a magic, a crc32 and
its length, so a torn read is detected (``ValueError``), never consumed.
The byte layout of a file equals the reference's, so one package reads
what the other wrote.

``ElasticManager`` (the trainers' membership and relaunch loop) is not
ported yet.
"""
from __future__ import annotations

import os
import struct
import time
import zlib
from typing import Dict, Optional

from ..resilience import faults as _faults

__all__ = ["FileKVStore"]


def _partition_check() -> None:
    """The ``kv_partition`` fault's hook: raise the ``OSError`` a
    partitioned shared mount would, for the injected window. One list
    index when no faults are configured."""
    if _faults.ENABLED[0] and _faults.kv_partition_active():
        raise OSError("injected kv partition: shared store unreachable")


class FileKVStore:
    """etcd analog over a shared directory. Keys are '/'-separated paths;
    values bytes. Writes are atomic (tmp + rename); watches are polls."""

    # transient-OSError retry budget for put(): a heartbeat that died on
    # one NFS blip would otherwise age a healthy host out
    PUT_RETRIES = 3
    PUT_BACKOFF = 0.02

    # put_bytes framing: magic, crc32, payload length, payload
    BYTES_MAGIC = b"KVB1"
    MAX_BYTES = 256 * 1024 * 1024

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def _path(self, key: str) -> str:
        key = key.strip("/")
        if not key or ".." in key.split("/"):
            raise ValueError(f"bad key {key!r}")
        return os.path.join(self.root, key)

    def put(self, key: str, value) -> None:
        if isinstance(value, str):
            value = value.encode()
        path = self._path(key)
        last: Optional[OSError] = None
        for attempt in range(self.PUT_RETRIES + 1):
            tmp = path + f".tmp.{os.getpid()}.{time.monotonic_ns()}"
            try:
                _partition_check()   # injected partitions ride the retries
                os.makedirs(os.path.dirname(path), exist_ok=True)
                with open(tmp, "wb") as f:
                    f.write(value)
                os.replace(tmp, path)
                return
            except OSError as e:
                last = e
                try:
                    os.remove(tmp)
                except OSError:
                    pass
                if attempt < self.PUT_RETRIES:
                    time.sleep(self.PUT_BACKOFF * (2 ** attempt))
        raise last

    def get(self, key: str) -> Optional[bytes]:
        _partition_check()
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def put_bytes(self, key: str, value: bytes,
                  max_bytes: Optional[int] = None) -> None:
        """Atomic checksummed binary write, with :meth:`put`'s retry
        budget. ``ValueError`` past the size guard."""
        value = bytes(value)
        cap = self.MAX_BYTES if max_bytes is None else int(max_bytes)
        if len(value) > cap:
            raise ValueError(
                f"put_bytes({key!r}): payload {len(value)} bytes exceeds "
                f"the {cap}-byte size guard")
        frame = (self.BYTES_MAGIC
                 + struct.pack("<IQ", zlib.crc32(value) & 0xFFFFFFFF,
                               len(value))
                 + value)
        self.put(key, frame)

    def get_bytes(self, key: str) -> Optional[bytes]:
        """A :meth:`put_bytes` record's payload, its length and checksum
        verified. None when the key is absent; ``ValueError`` when the
        frame is torn or corrupt."""
        raw = self.get(key)
        if raw is None:
            return None
        head = len(self.BYTES_MAGIC) + 12
        if len(raw) < head or not raw.startswith(self.BYTES_MAGIC):
            raise ValueError(f"get_bytes({key!r}): not a framed binary "
                             "record (bad magic)")
        crc, size = struct.unpack("<IQ", raw[len(self.BYTES_MAGIC):head])
        payload = raw[head:]
        if len(payload) != size:
            raise ValueError(
                f"get_bytes({key!r}): torn frame — header says {size} "
                f"bytes, file holds {len(payload)}")
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            raise ValueError(f"get_bytes({key!r}): checksum mismatch "
                             "(corrupt payload)")
        return payload

    def delete(self, key: str) -> None:
        _partition_check()
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    def get_prefix(self, prefix: str) -> Dict[str, bytes]:
        """{key: value} for every key under prefix (one directory level)."""
        _partition_check()
        base = self._path(prefix)
        out = {}
        try:
            names = sorted(os.listdir(base))
        except FileNotFoundError:
            return out
        for n in names:
            if n.endswith("~") or ".tmp." in n:
                continue
            p = os.path.join(base, n)
            if os.path.isfile(p):
                with open(p, "rb") as f:
                    out[f"{prefix.strip('/')}/{n}"] = f.read()
        return out

    def mtime(self, key: str) -> Optional[float]:
        try:
            return os.path.getmtime(self._path(key))
        except FileNotFoundError:
            return None
