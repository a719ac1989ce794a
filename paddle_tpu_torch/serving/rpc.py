"""Stdlib RPC transport of the cross-host serving fleet (the port of
``paddle_tpu/serving/rpc.py``), with the reference's frame bytes.

One frame = ``PRPC`` magic + ``<I json_len, Q blob_len>`` + a JSON header
+ an optional binary blob. The header carries the method, scalar params
and a manifest describing how the blob splits into named arrays
(``{"name", "dtype", "shape", "nbytes"}`` each): KV block rows ride the
blob raw, never JSON. The same frame shape serves requests and replies.

The codec takes numpy arrays and CPU torch tensors. A bf16 tensor goes
as its raw 16-bit words under the dtype name ``"bfloat16"`` (numpy has
no bf16 of its own), and that name decodes back to a ``torch.bfloat16``
tensor; every other name numpy knows decodes to a numpy array. What
:func:`decode_arrays` returns is writable: a received blob is a
``bytearray`` the arrays view without a copy. A card tensor is refused
(``ValueError``): the fleet's handlers read the pool through the
engine's scheduler thread, which hands them host copies.

Design constraints, in order:

- **stdlib + numpy on the wire** (socket/struct/json/threading/zlib);
  torch only to view a bf16 tensor's words.
- **Blocking request/response per connection.** The server runs one
  thread per connection, so a handler may block (the long-poll ``wait``
  parks in ``req._cv.wait_for``); the client keeps a small connection
  pool so one parked long-poll never delays a health probe.
- **Failure = exception, not hang.** Socket timeouts bound every call;
  a dead peer surfaces as :class:`RpcError` at the caller, the signal
  the fleet layer (``serving/pod.py``) turns into replica failover.

Reliability layer, every piece off the default path:

- :class:`RetryPolicy`: idempotent-only retries with deterministic
  exponential backoff and capped attempt/deadline budgets
  (``rpc_retries``). ``submit`` / ``adopt`` never retry: a replayed
  submit would decode a request twice.
- :class:`CircuitBreaker`: per peer, ``threshold`` consecutive transport
  errors open it; every call then fast-fails without dialing until
  ``cooldown_s`` passes, after which ONE half-open probe goes through
  (success closes, failure re-opens). ``rpc_breaker_state`` gauges the
  open breakers; an ``rpc.breaker_open`` span marks each opening.
- **A deadline in the frame header**: ``call(deadline_s=...)`` stamps the
  remaining budget as ``deadline_ms``; the receiver sheds a frame whose
  budget is gone at dispatch (``rpc_deadline_sheds``).
- **Optional blob crc**: ``call(crc=True)`` adds the blob's zlib crc32,
  checked before decoding; a corrupt KV chunk surfaces as
  ``RpcRemoteError(etype="RpcCorruptFrame")``, never as wrong rows.
- **Pool hygiene**: a socket whose call raised anywhere (transport
  error, desynced response id, torn reply blob) is closed and dropped;
  only a fully validated round trip returns its socket to the pool.

Threading: the server's connection set and the client's socket pool are
the only cross-thread state, each under its own ``_lock``; all socket
I/O happens outside the locks.
"""
from __future__ import annotations

import json
import socket
import struct
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..monitor.stats import (RPC_BREAKER_STATE, RPC_CALL_MS, RPC_CALLS,
                             RPC_DEADLINE_SHEDS, RPC_ERRORS, RPC_RETRIES)
from ..monitor.trace import emit_complete, recording
from ..resilience.faults import ENABLED as _FAULTS_ON
from ..resilience.faults import FAULTS as _FAULTS
from ..resilience.faults import net_partition_blocks

__all__ = ["RpcError", "RpcRemoteError", "RpcServer", "RpcClient",
           "RetryPolicy", "CircuitBreaker", "encode_arrays",
           "decode_arrays"]

_MAGIC = b"PRPC"
_HEAD = len(_MAGIC) + 12            # magic + <I json_len> + <Q blob_len>
MAX_HEADER_BYTES = 16 * 1024 * 1024
MAX_BLOB_BYTES = 512 * 1024 * 1024


class RpcError(RuntimeError):
    """Transport-level failure: dead peer, torn frame, timeout."""


class RpcRemoteError(RpcError):
    """The remote handler raised; ``etype`` names the remote type so the
    fleet layer can tell a remote QueueFull from a crash."""

    def __init__(self, etype: str, message: str):
        super().__init__(f"{etype}: {message}")
        self.etype = etype


# -- array codec -------------------------------------------------------------
def _raw(arr) -> Tuple[str, list, memoryview]:
    """(dtype name, shape, contiguous bytes view) of one array."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach()
        if t.device.type != "cpu":
            raise ValueError(
                f"rpc codec takes host tensors, got one on {t.device}: "
                "copy it off the card on the engine's scheduler thread")
        t = t.contiguous()
        name = str(t.dtype).replace("torch.", "")
        # numpy has no bf16: ship the raw 16-bit words
        a = t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
            else t.numpy()
    else:
        a = np.ascontiguousarray(arr)
        name = a.dtype.name
    raw = memoryview(a.reshape(-1).view(np.uint8)) if a.size \
        else memoryview(b"")
    return name, list(a.shape), raw


def _encode_parts(arrays: Dict[str, Any]) -> Tuple[list, List[memoryview]]:
    manifest, parts = [], []
    for name, arr in arrays.items():
        dtype, shape, raw = _raw(arr)
        manifest.append({"name": str(name), "dtype": dtype,
                         "shape": shape, "nbytes": raw.nbytes})
        parts.append(raw)
    return manifest, parts


def encode_arrays(arrays: Dict[str, Any]) -> Tuple[list, bytes]:
    """(manifest, blob) for a dict of numpy arrays or CPU tensors;
    order-preserving."""
    manifest, parts = _encode_parts(arrays)
    return manifest, b"".join(parts)


def _decode_one(buf, dtype: str, count_bytes: int, off: int, shape):
    if dtype == "bfloat16":
        # a torch tensor whatever numpy knows (``ml_dtypes`` registers a
        # numpy bf16 where it is loaded): the name alone decides
        n = count_bytes // 2
        if n == 0:
            return torch.empty(shape, dtype=torch.bfloat16)
        return torch.frombuffer(buf, dtype=torch.bfloat16, count=n,
                                offset=off).reshape(shape)
    try:
        npd = np.dtype(dtype)
    except TypeError:
        raise RpcError(f"unknown array dtype {dtype!r}") from None
    a = np.frombuffer(buf, dtype=npd,
                      count=count_bytes // max(1, npd.itemsize), offset=off)
    return a.reshape(shape)


def decode_arrays(manifest, blob) -> Dict[str, Any]:
    """The arrays a manifest describes, as writable views of ``blob``
    (a ``bytes`` blob is copied once into a ``bytearray``): numpy arrays,
    and ``torch.bfloat16`` tensors for the name ``"bfloat16"``."""
    out: Dict[str, Any] = {}
    if manifest and not isinstance(blob, bytearray):
        blob = bytearray(blob)
    off = 0
    for m in manifest or ():
        n = int(m["nbytes"])
        if off + n > len(blob):
            raise RpcError(f"torn blob: manifest wants {off + n} bytes, "
                           f"frame carries {len(blob)}")
        out[str(m["name"])] = _decode_one(
            blob, str(m["dtype"]), n, off, [int(s) for s in m["shape"]])
        off += n
    if off != len(blob):
        raise RpcError(f"torn blob: {len(blob) - off} trailing bytes")
    return out


# -- framing -----------------------------------------------------------------
def _recvall(sock: socket.socket, n: int) -> bytearray:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], min(1 << 20, n - got))
        if not k:
            if got:                    # mid-frame death: corruption, not
                raise RpcError(        # a clean between-frames close
                    f"truncated frame: peer closed after {got} of "
                    f"{n} bytes")
            raise ConnectionError("peer closed")
        got += k
    return buf


def _header_bytes(header: dict) -> bytes:
    return json.dumps(header, separators=(",", ":")).encode()


def _pack_frame(header: dict, blob: bytes = b"") -> bytes:
    payload = _header_bytes(header)
    return (_MAGIC + struct.pack("<IQ", len(payload), len(blob))
            + payload + blob)


def _send_parts(sock: socket.socket, header: dict, parts) -> None:
    """One frame from a header and blob parts, without joining the parts
    (a KV payload is sent from the arrays' own memory)."""
    payload = _header_bytes(header)
    blen = sum(p.nbytes for p in parts)
    sock.sendall(_MAGIC + struct.pack("<IQ", len(payload), blen) + payload)
    for p in parts:
        if p.nbytes:
            sock.sendall(p)


def _recv_frame(sock: socket.socket) -> Tuple[dict, bytearray]:
    head = _recvall(sock, _HEAD)
    if not head.startswith(_MAGIC):
        raise RpcError(f"bad frame magic {bytes(head[:4])!r}")
    jlen, blen = struct.unpack("<IQ", head[len(_MAGIC):])
    if jlen > MAX_HEADER_BYTES or blen > MAX_BLOB_BYTES:
        raise RpcError(f"oversized frame: header {jlen}B, blob {blen}B")
    try:
        header = json.loads(_recvall(sock, jlen))
    except (ValueError, UnicodeDecodeError) as e:
        raise RpcError(f"corrupt frame header: {e}") from e
    blob = _recvall(sock, blen) if blen else bytearray()
    return header, blob


def _crc(parts) -> int:
    c = 0
    for p in parts:
        c = zlib.crc32(p, c)
    return c


def _flip_byte(frame: bytes, jlen: int, blen: int) -> bytes:
    """Deterministic in-flight corruption (rpc_corrupt): XOR one byte
    with 0xFF, inside the blob when there is one (the crc path), else
    inside the JSON header (high bit set = invalid UTF-8, the torn-frame
    path)."""
    if blen > 0:
        off = _HEAD + jlen + blen // 2
    else:
        off = _HEAD + jlen // 2
    b = bytearray(frame)
    b[off] ^= 0xFF
    return bytes(b)


# -- reliability policy ------------------------------------------------------
class RetryPolicy:
    """Deterministic retry budget for IDEMPOTENT methods only.

    Backoff is exponential from ``backoff_s``, doubling per attempt,
    capped at ``backoff_max_s``; no jitter, so chaos replays repeat.
    ``submit`` / ``adopt`` are absent from the default method set: a
    replay would decode a request twice on a peer that got the first.
    """

    IDEMPOTENT = frozenset({
        "hello", "health", "wait", "cancel", "warm", "prefill_export",
        "prefill_start", "export_range", "import_kv", "import_chunk",
        "ensure_replicas", "evacuate", "collect_flight",
    })

    def __init__(self, max_attempts: int = 3, backoff_s: float = 0.05,
                 backoff_max_s: float = 2.0, methods=None):
        self.max_attempts = max(1, int(max_attempts))
        self.backoff_s = float(backoff_s)
        self.backoff_max_s = float(backoff_max_s)
        self.methods = frozenset(methods) if methods is not None \
            else self.IDEMPOTENT

    def retryable(self, method: str) -> bool:
        return method in self.methods

    def backoff(self, attempt: int) -> float:
        """Pause before retry ``attempt`` (0-based)."""
        return min(self.backoff_max_s, self.backoff_s * (2 ** attempt))


BREAKER_CLOSED, BREAKER_HALF_OPEN, BREAKER_OPEN = 0, 1, 2

# process-wide count of OPEN breakers behind the rpc_breaker_state gauge
_OPEN_LOCK = threading.Lock()
_OPEN_COUNT = [0]


def _note_breaker(delta: int) -> None:
    with _OPEN_LOCK:
        _OPEN_COUNT[0] = max(0, _OPEN_COUNT[0] + delta)
        RPC_BREAKER_STATE.set(_OPEN_COUNT[0])


class CircuitBreaker:
    """Per-peer circuit breaker: ``threshold`` CONSECUTIVE transport
    errors open it; while open, :meth:`allow` fast-fails every call until
    ``cooldown_s`` passes, then admits exactly one half-open probe, whose
    outcome closes or re-opens the breaker."""

    def __init__(self, threshold: int = 3, cooldown_s: float = 2.0,
                 peer: str = ""):
        self.threshold = max(1, int(threshold))
        self.cooldown_s = float(cooldown_s)
        self.peer = str(peer)
        self._lock = threading.Lock()
        self._state = BREAKER_CLOSED
        self._consec = 0
        self._opened_t = 0.0
        self._probing = False

    @property
    def state(self) -> int:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """May a call proceed now? (True also claims the single half-open
        probe slot once the cooldown has passed.)"""
        with self._lock:
            if self._state == BREAKER_CLOSED:
                return True
            if self._state == BREAKER_OPEN and not self._probing \
                    and time.monotonic() - self._opened_t >= self.cooldown_s:
                self._state = BREAKER_HALF_OPEN
                self._probing = True
                return True
            if self._state == BREAKER_HALF_OPEN and not self._probing:
                self._probing = True
                return True
            return False

    def note_ok(self) -> None:
        with self._lock:
            was_open = self._state != BREAKER_CLOSED
            self._state = BREAKER_CLOSED
            self._consec = 0
            self._probing = False
        if was_open:
            _note_breaker(-1)

    def note_error(self) -> None:
        opened = False
        with self._lock:
            self._consec += 1
            if self._state == BREAKER_HALF_OPEN:
                self._state = BREAKER_OPEN      # failed probe: re-open
                self._opened_t = time.monotonic()
                self._probing = False
            elif self._state == BREAKER_CLOSED \
                    and self._consec >= self.threshold:
                self._state = BREAKER_OPEN
                self._opened_t = time.monotonic()
                opened = True
        if opened:
            _note_breaker(+1)
            if recording():
                emit_complete("rpc.breaker_open", time.perf_counter(), 0.0,
                              cat="serving",
                              args={"peer": self.peer,
                                    "consec_errors": self._consec})

    def __repr__(self):
        names = {BREAKER_CLOSED: "closed", BREAKER_HALF_OPEN: "half-open",
                 BREAKER_OPEN: "open"}
        return f"CircuitBreaker(peer={self.peer!r}, {names[self.state]})"


# -- server ------------------------------------------------------------------
class RpcServer:
    """One accept thread + one thread per connection, dispatching to a
    dict of handlers ``{method: fn(params, arrays) -> result}``; a handler
    may return a JSON-able result or a tuple ``(result, arrays)`` to ship
    arrays back. Handler exceptions become :class:`RpcRemoteError` at the
    caller; they never kill the server."""

    def __init__(self, handlers: Dict[str, Callable],
                 host: str = "127.0.0.1", port: int = 0):
        self._handlers = dict(handlers)
        self._listener = socket.create_server((host, int(port)))
        self.addr: Tuple[str, int] = self._listener.getsockname()[:2]
        self._lock = threading.Lock()          # guards _conns
        self._conns: set = set()
        self._closed_event = threading.Event()
        self._accepter = threading.Thread(
            target=self._accept_loop, name="rpc-accept", daemon=True)
        self._accepter.start()

    def _accept_loop(self) -> None:
        while not self._closed_event.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:                    # listener closed: shutdown
                break
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                if self._closed_event.is_set():
                    conn.close()
                    continue
                self._conns.add(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             name="rpc-conn", daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while not self._closed_event.is_set():
                try:
                    header, blob = _recv_frame(conn)
                except (ConnectionError, OSError, RpcError, ValueError):
                    break                      # peer gone / torn frame
                t_recv = time.monotonic()
                resp, rparts = self._dispatch(header, blob, t_recv)
                try:
                    _send_parts(conn, resp, rparts)
                except (ConnectionError, OSError):
                    break
        finally:
            with self._lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _dispatch(self, header: dict, blob,
                  t_recv: Optional[float] = None) -> Tuple[dict, list]:
        mid = header.get("id")
        method = header.get("method", "")
        if t_recv is None:
            t_recv = time.monotonic()
        # injected receiver-side delay (rpc_delay rides the header, so the
        # claim stays in the CLIENT's per-peer call-index space)
        if _FAULTS_ON[0] and header.get("_inject_delay_s") is not None:
            time.sleep(float(header["_inject_delay_s"]))
        # deadline shed: the caller's remaining budget rode the header; if
        # it is gone by dispatch time, answer without computing
        dl_ms = header.get("deadline_ms")
        if dl_ms is not None \
                and (time.monotonic() - t_recv) * 1e3 >= float(dl_ms):
            RPC_DEADLINE_SHEDS.add(1)
            return ({"id": mid, "ok": False, "etype": "DeadlineExpired",
                     "error": f"frame budget {float(dl_ms):.1f}ms expired "
                     "before dispatch (shed)"}, [])
        crc = header.get("crc")
        if crc is not None and zlib.crc32(blob) != int(crc):
            return ({"id": mid, "ok": False, "etype": "RpcCorruptFrame",
                     "error": "blob crc mismatch (corrupt in flight)"}, [])
        fn = self._handlers.get(method)
        if fn is None:
            return ({"id": mid, "ok": False, "etype": "KeyError",
                     "error": f"no such method: {method!r}"}, [])
        try:
            arrays = decode_arrays(header.get("blobs"), blob)
            out = fn(header.get("params") or {}, arrays)
            result, out_arrays = out if isinstance(out, tuple) \
                else (out, None)
            manifest, rparts = _encode_parts(out_arrays or {})
        except Exception as e:  # noqa: BLE001 — handler errors go to caller
            return ({"id": mid, "ok": False, "etype": type(e).__name__,
                     "error": str(e)}, [])
        return ({"id": mid, "ok": True, "result": result,
                 "blobs": manifest}, rparts)

    def close(self) -> None:
        self._closed_event.set()
        # a blocked accept() is not woken by close() from another thread
        # on Linux: shutdown() the listener first, with a throwaway
        # self-connect as the portable fallback
        try:
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        try:
            socket.create_connection(self.addr, timeout=0.2).close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns)
            self._conns.clear()
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        self._accepter.join(timeout=2.0)


# -- client ------------------------------------------------------------------
class RpcClient:
    """Pooled blocking client. ``call`` checks a socket out of the pool
    (dialing a fresh one when empty), runs one request/response on it
    outside any lock, and returns it, so concurrent callers (a parked
    long-poll, a health probe, a KV stream) each get their own
    connection.

    ``retry=RetryPolicy(...)`` arms idempotent-method retries;
    ``breaker=CircuitBreaker(...)`` arms per-peer circuit breaking;
    ``peer_host`` / ``local_host`` name the endpoints for the network
    fault hooks (``net_partition`` groups match against them). All
    default to off.
    """

    POOL_MAX = 4

    def __init__(self, addr, timeout: float = 30.0,
                 retry: Optional[RetryPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 peer_host: str = "", local_host: str = "client"):
        self.addr = (str(addr[0]), int(addr[1]))
        self.timeout = float(timeout)
        self.retry = retry
        self.breaker = breaker
        self.peer_host = str(peer_host)
        self.local_host = str(local_host)
        self._lock = threading.Lock()          # guards _pool/_seq/_closed
        self._pool: list = []
        self._seq = 0
        self._closed = False
        self._call_idx = 0   # per-peer fault index (bumped only armed)

    def _dial(self) -> socket.socket:
        sock = socket.create_connection(self.addr, timeout=self.timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    def call(self, method: str, params: Optional[dict] = None,
             arrays: Optional[Dict[str, Any]] = None,
             timeout: Optional[float] = None,
             deadline_s: Optional[float] = None, crc: bool = False):
        """Returns ``(result, arrays)``. Raises :class:`RpcRemoteError`
        when the handler raised, :class:`RpcError` on transport death
        (the socket is discarded, never pooled). With a
        :class:`RetryPolicy`, transport errors on idempotent methods
        retry with deterministic backoff inside the remaining
        ``deadline_s`` budget."""
        deadline = None if deadline_s is None \
            else time.monotonic() + float(deadline_s)
        attempt = 0
        while True:
            try:
                return self._call_once(method, params, arrays, timeout,
                                       deadline, crc)
            except RpcRemoteError:
                raise                      # transport fine; peer answered
            except RpcError as e:
                pol = self.retry
                if pol is None or not pol.retryable(method) \
                        or getattr(e, "fast", False):
                    raise                  # breaker fast-fail: no retry
                attempt += 1
                if attempt >= pol.max_attempts:
                    raise
                pause = pol.backoff(attempt - 1)
                if deadline is not None \
                        and time.monotonic() + pause >= deadline:
                    raise
                RPC_RETRIES.add(1)
                time.sleep(pause)

    def _call_once(self, method, params, arrays, timeout, deadline,
                   crc: bool):
        br = self.breaker
        if br is not None and not br.allow():
            RPC_CALLS.add()
            RPC_ERRORS.add()
            err = RpcError(f"rpc {method!r} to {self.addr[0]}:"
                           f"{self.addr[1]}: circuit breaker open")
            err.fast = True
            raise err
        drop = delay = corrupt = None
        if _FAULTS_ON[0]:
            self._call_idx += 1
            fired = _FAULTS.take_rpc(self.peer_host, method, self._call_idx)
            drop = fired.get("rpc_drop")
            delay = fired.get("rpc_delay")
            corrupt = fired.get("rpc_corrupt")
            if net_partition_blocks(self.local_host, self.peer_host):
                RPC_CALLS.add()
                RPC_ERRORS.add()
                if br is not None:
                    br.note_error()
                raise RpcError(f"rpc {method!r} to {self.addr[0]}:"
                               f"{self.addr[1]}: injected net partition "
                               f"({self.local_host}<->{self.peer_host})")
        with self._lock:
            if self._closed:
                raise RpcError("client closed")
            self._seq += 1
            mid = self._seq
            sock = self._pool.pop() if self._pool else None
        t0 = time.monotonic()
        RPC_CALLS.add()
        out = resp = None
        try:
            if drop is not None:           # injected mid-call transport
                if sock is not None:       # death, before the frame leaves
                    sock.close()
                raise ConnectionError("injected rpc_drop")
            if sock is None:
                sock = self._dial()
            manifest, parts = _encode_parts(arrays or {})
            header = {"id": mid, "method": method, "params": params or {},
                      "blobs": manifest}
            if deadline is not None:
                header["deadline_ms"] = round(
                    max(0.0, (deadline - time.monotonic()) * 1e3), 3)
            if crc:
                header["crc"] = _crc(parts)
            if delay is not None:
                header["_inject_delay_s"] = delay.secs
            budget = self.timeout if timeout is None else timeout
            if deadline is not None:
                budget = min(budget, max(0.01, deadline - time.monotonic()))
            sock.settimeout(budget)
            if corrupt is not None:
                blob = b"".join(parts)
                frame = _flip_byte(_pack_frame(header, blob),
                                   len(_header_bytes(header)), len(blob))
                sock.sendall(frame)
            else:
                _send_parts(sock, header, parts)
            resp, rblob = _recv_frame(sock)
            if resp.get("id") != mid:
                raise RpcError(
                    f"rpc {method!r}: response id {resp.get('id')} for "
                    f"request {mid} (desynced stream)")
            if resp.get("ok"):
                out = (resp.get("result"),
                       decode_arrays(resp.get("blobs"), rblob))
        except (ConnectionError, OSError, struct.error,
                json.JSONDecodeError, RpcError) as e:
            # ANY failure mid-call poisons the stream: destroy the
            # socket, never re-pool it
            RPC_ERRORS.add()
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
            if br is not None:
                br.note_error()
            if isinstance(e, RpcError):
                raise
            raise RpcError(f"rpc {method!r} to {self.addr[0]}:"
                           f"{self.addr[1]}: {type(e).__name__}: {e}") from e
        # a fully validated round trip: the stream is aligned, only now
        # may the socket go back to the pool
        keep = False
        with self._lock:
            if not self._closed and len(self._pool) < self.POOL_MAX:
                self._pool.append(sock)
                keep = True
        if not keep:
            sock.close()
        RPC_CALL_MS.observe((time.monotonic() - t0) * 1e3)
        if br is not None:
            br.note_ok()
        if out is None:                    # remote handler raised/shed
            RPC_ERRORS.add()
            raise RpcRemoteError(resp.get("etype", "Exception"),
                                 resp.get("error", ""))
        return out

    def close(self) -> None:
        with self._lock:
            self._closed = True
            pool = list(self._pool)
            self._pool.clear()
        for sock in pool:
            try:
                sock.close()
            except OSError:
                pass
