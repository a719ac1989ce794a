"""paddle_tpu_torch's RPC transport against paddle_tpu's.

- the frame bytes: ``_pack_frame`` / ``encode_arrays`` give the JAX
  package's bytes for the same header and arrays (f32, int32, bf16; the
  JAX side's bf16 through ``ml_dtypes``, the port's as torch bf16
  tensors), and the port decodes bf16 to a writable ``torch.bfloat16``
  tensor, never to f32;
- the wire: a port client against a JAX ``RpcServer`` and a JAX client
  against a port server, on an echo handler (bf16 both ways);
- the receiver's rejections (truncation, bad magic, oversize, torn blob,
  bit flips) end as the JAX receiver's do;
- ``RetryPolicy.backoff`` and the circuit breaker's transitions on a
  frozen clock, and the ``take_rpc`` / ``net_partition_blocks`` fault
  hooks' call indices, equal the JAX ones;
- the port's own transport: crc, header deadlines, pool hygiene,
  retries and the breaker's fast-fail through a client.

Everything is host-side: no model, no card.
"""
import socket
import struct
import time
import types

import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu.resilience import faults as jfaults
from paddle_tpu.serving import rpc as jrpc
from paddle_tpu_torch import monitor
from paddle_tpu_torch.resilience import faults as tfaults
from paddle_tpu_torch.serving import rpc as trpc
from torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    tfaults.configure_faults("")
    jfaults.configure_faults("")


def _arrays(kind):
    rng = np.random.default_rng(7)
    out = {}
    if kind in ("f32", "mixed"):
        out["f"] = rng.standard_normal((3, 5)).astype(np.float32)
    if kind in ("i32", "mixed"):
        out["i"] = rng.integers(-9, 9, (4, 2, 3)).astype(np.int32)
    if kind in ("bf16", "mixed"):
        out["kb"] = rng.standard_normal((2, 2, 4, 8)).astype(
            ml_dtypes.bfloat16)
    if kind == "mixed":
        out["empty"] = np.zeros((0, 3), np.float32)
    return out


def _as_torch(arrays):
    """The same arrays as the port's engine hands them: CPU tensors, bf16
    by its bits."""
    out = {}
    for k, a in arrays.items():
        if a.dtype.name == "bfloat16":
            out[k] = torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        else:
            out[k] = torch.from_numpy(a.copy())
    return out


HEADER = {"id": 11, "method": "import_chunk",
          "params": {"idx": 0, "start_block": 2, "n_tokens": 40,
                     "note": "é", "x": 1.5, "none": None}}


@pytest.mark.parametrize("kind", ["f32", "i32", "bf16", "mixed"])
@pytest.mark.parametrize("as_torch", [False, True])
def test_frame_bytes_equal_the_references(kind, as_torch):
    arrays = _arrays(kind)
    jm, jb = jrpc.encode_arrays(arrays)
    tm, tb = trpc.encode_arrays(_as_torch(arrays) if as_torch else arrays)
    assert tm == jm and tb == jb
    want = jrpc._pack_frame({**HEADER, "blobs": jm}, jb)
    assert trpc._pack_frame({**HEADER, "blobs": tm}, tb) == want
    # the parts path the client sends by writes the same bytes
    a, b = socket.socketpair()
    try:
        _, parts = trpc._encode_parts(arrays)
        trpc._send_parts(a, {**HEADER, "blobs": tm}, parts)
        a.close()
        b.settimeout(5.0)
        got = b""
        while len(got) < len(want):
            chunk = b.recv(1 << 16)
            if not chunk:
                break
            got += chunk
    finally:
        b.close()
    assert got == want


def test_bf16_decodes_to_a_writable_bf16_tensor():
    arrays = _arrays("mixed")
    m, blob = trpc.encode_arrays(arrays)
    for buf in (blob, bytearray(blob)):
        out = trpc.decode_arrays(m, buf)
        kb = out["kb"]
        assert isinstance(kb, torch.Tensor) and kb.dtype == torch.bfloat16
        assert torch.equal(kb.view(torch.int16), torch.from_numpy(
            arrays["kb"].view(np.int16)))
        assert out["f"].flags.writeable and out["i"].dtype == np.int32
        assert out["empty"].shape == (0, 3)
        kb[0, 0, 0, 0] = 3.0            # writable: no read-only view
        out["f"][0, 0] = 1.0
    # the JAX receiver reads the port's bf16 as ml_dtypes bf16, bitwise
    jm, jb = trpc.encode_arrays(_as_torch(arrays))
    jout = jrpc.decode_arrays(jm, jb)
    assert jout["kb"].dtype.name == "bfloat16"
    assert np.array_equal(jout["kb"].view(np.int16),
                          arrays["kb"].view(np.int16))


def _echo(params, arrays):
    return {"got": params, "names": sorted(arrays)}, dict(arrays)


@pytest.mark.parametrize("direction", ["port_client_jax_server",
                                       "jax_client_port_server"])
def test_each_packages_client_talks_to_the_others_server(direction):
    client_mod, server_mod = (trpc, jrpc) \
        if direction == "port_client_jax_server" else (jrpc, trpc)

    def boom(params, arrays):
        raise ValueError("kapow")

    srv = server_mod.RpcServer({"echo": _echo, "boom": boom})
    cli = client_mod.RpcClient(srv.addr, timeout=10.0)
    try:
        arrays = _arrays("mixed")
        send = _as_torch(arrays) if client_mod is trpc else arrays
        res, out = cli.call("echo", {"a": 1, "s": "x"}, send, crc=True)
        assert res == {"got": {"a": 1, "s": "x"},
                       "names": sorted(arrays)}
        for k, a in arrays.items():
            got = out[k]
            if a.dtype.name == "bfloat16":
                bits = got.view(torch.int16).numpy() \
                    if isinstance(got, torch.Tensor) else got.view(np.int16)
                assert np.array_equal(bits, a.view(np.int16))
            else:
                assert np.array_equal(got, a) and got.dtype == a.dtype
        with pytest.raises(client_mod.RpcRemoteError) as ei:
            cli.call("boom")
        assert ei.value.etype == "ValueError" and "kapow" in str(ei.value)
        with pytest.raises(client_mod.RpcRemoteError) as ei:
            cli.call("nope")
        assert ei.value.etype == "KeyError"
    finally:
        cli.close()
        srv.close()


def _feed(mod, payload: bytes):
    a, b = socket.socketpair()
    a.sendall(payload)
    a.close()
    b.settimeout(5.0)
    try:
        return mod._recv_frame(b)
    finally:
        b.close()


def _outcome(fn):
    """What a receive-and-decode ends in: ("ok", shapes) or the error's
    class name (RpcError and its kind, or ConnectionError)."""
    try:
        header, blob = fn()
    except (jrpc.RpcError, trpc.RpcError) as e:
        return ("RpcError", str(e).split(":")[0])
    except ConnectionError:
        return ("ConnectionError",)
    try:
        mod = trpc if isinstance(blob, bytearray) else jrpc
        arrs = mod.decode_arrays(header.get("blobs"), blob)
    except (jrpc.RpcError, trpc.RpcError) as e:
        return ("RpcError", str(e).split(":")[0])
    return ("ok", header.get("id"),
            {k: tuple(v.shape) for k, v in arrs.items()})


def _frame():
    m, blob = jrpc.encode_arrays({"v": np.arange(12, dtype=np.float32)})
    return jrpc._pack_frame({"id": 7, "method": "echo", "params": {"x": 1},
                             "blobs": m}, blob)


def _mutations():
    frame = _frame()
    out = [("valid", frame)]
    bad = bytearray(frame)
    bad[:4] = b"XXXX"
    out.append(("bad_magic", bytes(bad)))
    for jlen, blen in ((1 << 30, 0), (16, 1 << 62)):
        out.append((f"oversize_{jlen}_{blen}",
                    b"PRPC" + struct.pack("<IQ", jlen, blen) + b"{}"))
    for cut in sorted({1, 8, 15, 16, 20, len(frame) // 2, len(frame) - 1}):
        out.append((f"cut_{cut}", frame[:cut]))
    rng = np.random.default_rng(0)
    for pos in sorted(set(rng.integers(4, len(frame), 40).tolist())):
        m = bytearray(frame)
        m[pos] ^= 0xFF
        out.append((f"flip_{pos}", bytes(m)))
    return out


@pytest.mark.parametrize("name,payload", _mutations(),
                         ids=[n for n, _ in _mutations()])
def test_receiver_rejections_match_the_reference(name, payload):
    want = _outcome(lambda: _feed(jrpc, payload))
    got = _outcome(lambda: _feed(trpc, payload))
    assert got == want
    if name == "valid":
        assert got[0] == "ok"
    elif name.startswith(("bad_magic", "oversize", "cut_")):
        assert got[0] != "ok"


def test_torn_blob_rejections_match_the_reference():
    m, blob = jrpc.encode_arrays({"a": np.ones(5, np.float32)})
    lie = [dict(m[0], nbytes=999)]
    for manifest, b, match in ((m, blob[:-2], "torn blob"),
                               (m, blob + b"\0\0", "trailing"),
                               (lie, blob, "torn blob")):
        for mod in (jrpc, trpc):
            with pytest.raises(mod.RpcError, match=match):
                mod.decode_arrays(manifest, b)


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t


def _frozen(monkeypatch, mod, clock):
    monkeypatch.setattr(mod, "time", types.SimpleNamespace(
        monotonic=clock.monotonic, perf_counter=time.perf_counter,
        sleep=time.sleep))


def test_backoff_and_breaker_transitions_equal_the_references(monkeypatch):
    for kw in ({}, {"max_attempts": 5, "backoff_s": 0.03,
                    "backoff_max_s": 0.2}):
        jp, tp = jrpc.RetryPolicy(**kw), trpc.RetryPolicy(**kw)
        assert [tp.backoff(a) for a in range(8)] \
            == [jp.backoff(a) for a in range(8)]
        assert tp.max_attempts == jp.max_attempts
        assert tp.IDEMPOTENT == jp.IDEMPOTENT
        for m in ("submit", "adopt", "wait", "import_chunk", "hello"):
            assert tp.retryable(m) == jp.retryable(m)
    script = ["allow", "err", "allow", "err", "allow", 0.5, "allow", 0.6,
              "allow", "allow", "err", "allow", 1.1, "allow", "ok",
              "allow", "err", "err", "allow", 2.5, "allow", "err", 0.2,
              "allow", 1.0, "allow", "ok"]

    def run(mod):
        clock = _Clock()
        _frozen(monkeypatch, mod, clock)
        gauge = mod.RPC_BREAKER_STATE
        br = mod.CircuitBreaker(threshold=2, cooldown_s=1.0, peer="h1")
        g0 = gauge.get()
        log = []
        for op in script:
            if isinstance(op, float):
                clock.t += op
                continue
            out = {"allow": br.allow, "err": br.note_error,
                   "ok": br.note_ok}[op]()
            log.append((op, out, br.state, gauge.get() - g0))
        return log

    assert run(trpc) == run(jrpc)


def test_take_rpc_and_partition_fire_on_the_references_indices(monkeypatch):
    spec = ("rpc_drop@call=3:method=export_range:host=h0:repeat=2,"
            "rpc_delay@call=1:secs=0.5,rpc_corrupt@call=2:host=h1,"
            "net_partition@step=4:secs=5:hosts=router|h2+h3")
    calls = [("h0", "export_range"), ("h1", "health"), ("h0", "health"),
             ("h0", "export_range"), ("h1", "import_chunk"),
             ("h2", "wait"), ("h0", "export_range"), ("h0", "export_range"),
             ("h3", "submit"), ("h1", "health")]
    pairs = [("router", "h2"), ("h3", "router"), ("router", "h1"),
             ("h2", "h3"), ("router", "router")]

    def run(mod):
        clock = _Clock()
        _frozen(monkeypatch, mod, clock)
        mod.configure_faults(spec)
        log = []
        for idx, (host, method) in enumerate(calls, start=1):
            fired = mod.FAULTS.take_rpc(host, method, idx)
            log.append((idx, sorted(fired),
                        [mod.net_partition_blocks(a, b) for a, b in pairs]))
        clock.t += 4.9
        log.append([mod.net_partition_blocks(a, b) for a, b in pairs])
        clock.t += 0.2
        log.append([mod.net_partition_blocks(a, b) for a, b in pairs])
        mod.configure_faults("")
        return log

    got, want = run(tfaults), run(jfaults)
    assert got == want
    assert any(f for _, f, _ in got[:-2])
    assert any(any(b) for *_, b in got[:-2])


def test_kv_partition_window_matches_the_reference(monkeypatch):
    def run(mod):
        clock = _Clock()
        _frozen(monkeypatch, mod, clock)
        mod.configure_faults("rpc_delay@call=1")     # arms ENABLED
        out = [mod.kv_partition_active()]
        mod.begin_kv_partition(0.5)
        out.append(mod.kv_partition_active())
        clock.t += 0.6
        out.append(mod.kv_partition_active())
        mod.begin_kv_partition(1.0)
        mod.configure_faults("")                   # closes the window
        out.append(mod.kv_partition_active())
        return out

    assert run(tfaults) == run(jfaults) == [False, True, False, False]


# -- the port's transport ----------------------------------------------------

@pytest.fixture
def server():
    def slow(params, arrays):
        time.sleep(float(params.get("s", 0.2)))
        return {"ok": 1}

    srv = trpc.RpcServer({"echo": _echo, "slow": slow, "submit": _echo,
                          "health": _echo})
    yield srv
    srv.close()


def test_crc_catches_a_corrupt_blob_and_the_header_tear(server):
    cli = trpc.RpcClient(server.addr, timeout=5.0)
    try:
        tfaults.configure_faults("rpc_corrupt@call=1,rpc_corrupt@call=2")
        with pytest.raises(trpc.RpcRemoteError) as ei:
            cli.call("echo", {}, {"v": np.arange(64, dtype=np.float32)},
                     crc=True)
        assert ei.value.etype == "RpcCorruptFrame"
        with pytest.raises(trpc.RpcError):           # torn header: the
            cli.call("echo", {"k": "v"})             # server drops it
        tfaults.configure_faults("")
        assert cli.call("echo", {"k": 1})[0]["got"] == {"k": 1}
    finally:
        cli.close()


def test_header_deadline_sheds_at_the_receiver(server):
    """With a 0.3 s injected delay and a 0.1 s deadline the client gives
    up at its deadline (a transport timeout) and the server sheds the
    expired frame instead of computing it."""
    cli = trpc.RpcClient(server.addr, timeout=5.0)
    sheds = monitor.stat_get("rpc_deadline_sheds")
    t0 = time.monotonic()
    try:
        tfaults.configure_faults("rpc_delay@call=1:secs=0.3")
        with pytest.raises(trpc.RpcError) as ei:
            cli.call("echo", {}, deadline_s=0.1)
        assert not isinstance(ei.value, trpc.RpcRemoteError)
        assert time.monotonic() - t0 < 0.3
    finally:
        cli.close()
    deadline = time.monotonic() + 5.0
    while monitor.stat_get("rpc_deadline_sheds") == sheds \
            and time.monotonic() < deadline:
        time.sleep(0.02)
    assert monitor.stat_get("rpc_deadline_sheds") > sheds


def test_pool_hygiene_retry_and_breaker(server):
    calls0 = monitor.stat_get("rpc_retries")
    cli = trpc.RpcClient(server.addr, timeout=5.0,
                         retry=trpc.RetryPolicy(max_attempts=3,
                                                backoff_s=0.0),
                         breaker=trpc.CircuitBreaker(threshold=2,
                                                     cooldown_s=60.0,
                                                     peer="p"),
                         peer_host="p")
    try:
        assert cli.call("health")[0]["got"] == {}
        assert len(cli._pool) == 1                  # a good socket pools
        tfaults.configure_faults("rpc_drop@call=1:method=health:repeat=1")
        assert cli.call("health")[0]["got"] == {}   # one retry rides it
        assert monitor.stat_get("rpc_retries") - calls0 == 1
        tfaults.configure_faults("rpc_drop@call=1:method=submit:repeat=9")
        with pytest.raises(trpc.RpcError):          # never retried
            cli.call("submit", {})
        with pytest.raises(trpc.RpcError):
            cli.call("submit", {})
        assert cli.breaker.state == trpc.BREAKER_OPEN
        with pytest.raises(trpc.RpcError) as ei:    # fast-fail, no dial
            cli.call("health")
        assert getattr(ei.value, "fast", False)
    finally:
        cli.close()
        tfaults.configure_faults("")
    open0 = monitor.stat_get("rpc_breaker_state")
    cli.breaker.note_ok()                  # closing it lowers the gauge
    assert monitor.stat_get("rpc_breaker_state") == open0 - 1


def test_card_tensors_are_refused_and_bf16_stays_bf16():
    meta = torch.empty(2, 2, device="meta")
    with pytest.raises(ValueError, match="host tensors"):
        trpc.encode_arrays({"x": meta})
    t = torch.randn(3, 4).to(torch.bfloat16)
    m, blob = trpc.encode_arrays({"x": t})
    assert m[0]["dtype"] == "bfloat16" and m[0]["nbytes"] == 24
    out = trpc.decode_arrays(m, blob)["x"]
    assert out.dtype == torch.bfloat16 and torch.equal(out, t)
