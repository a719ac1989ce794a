"""paddle_tpu_torch's ServingFrontend against paddle_tpu's.

Two front ends, each over its own package's engine with the same weights
and the byte tokenizer, answer the same HTTP requests:

- ``/v1/completions`` and ``/v1/chat/completions`` (JSON and SSE): the
  same JSON keys at every level and the same greedy text, finish reason
  and usage (response ids and timestamps aside);
- a bounded ``regex`` ``response_format``: the same text, ending "stop";
- ``/v1/models``, ``/v1/rank`` (404, no ranker), 401, 404 and 405: the
  same bodies;
- ``/metrics``: Prometheus text that parses, the five engine histograms
  and the ``frontend_*`` series, every metric family named as in the
  reference's scrape;
- a 429 with ``Retry-After`` from an exhausted bucket, the other tenant
  unaffected; a 503 for a deadline that expires in the lane, as in the
  reference; the ``frontend.*`` spans with the reference's names and
  arg keys; ``conn_drop`` aborting a stream after its first piece, and a
  client closing its connection mid-stream, each cancelling its engine
  request; ``/healthz`` and ``/readyz`` over a
  router with a supervisor (replica, lifecycle and fleet checks), a
  brownout shed rung answering 503;
- ``python -m paddle_tpu_torch.serving.frontend`` serves with
  ``--device cpu`` and raises without a GPU otherwise.

gpt_nano over the byte tokenizer's vocabulary, f32, block matrices x4
so greedy text varies.
"""
import functools
import http.client
import json
import os
import re
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.models import gpt as jg
from paddle_tpu.serving import InferenceEngine as JaxEngine
from paddle_tpu.serving.frontend import ServingFrontend as JaxFrontend
from paddle_tpu.serving.frontend import Tenant as JaxTenant
from paddle_tpu.serving.tokenizer import ByteTokenizer as JaxByteTokenizer
from paddle_tpu_torch import monitor
from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.resilience import faults as tfaults
from paddle_tpu_torch.serving import (ByteTokenizer, EngineRouter,
                                      InferenceEngine, OverloadController,
                                      ReplicaSupervisor, ServingFrontend,
                                      Tenant)
from paddle_tpu_torch.serving.overload import RUNG_SHED_BRONZE
from chip_smoke import prom_families
from torch_jax_util import scaled_params

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = ByteTokenizer().vocab_size
CFG_J = jg.gpt_nano(dtype=jnp.float32, seq_len=256, vocab_size=VOCAB)
CFG = tg.gpt_nano(dtype=torch.float32, seq_len=256, vocab_size=VOCAB)
KW = dict(n_slots=4, paged=True, block_size=16, prefill_chunk=64,
          prefix_cache=True)
REGEX = r"(yes|no), [0-9]{1,3}\."
SYSTEM = {"role": "system", "content": "You answer in one short line."}


@functools.lru_cache(maxsize=None)
def _params():
    return scaled_params(CFG_J, seed=11)


def _tenants(cls):
    return [cls("gold-co", "sk-gold", rate=1000, burst=1000, lane="gold"),
            cls("tiny-co", "sk-tiny", rate=0.01, burst=1, lane="bronze",
                max_streams=1)]


@pytest.fixture(scope="module")
def fronts():
    """(port front end, JAX front end), each over its package's engine."""
    tree, params = _params()
    eng = InferenceEngine(CFG, params, device="cpu",
                          tokenizer=ByteTokenizer(), **KW)
    jeng = JaxEngine(CFG_J, jax.tree.map(jnp.asarray, tree),
                     tokenizer=JaxByteTokenizer(), **KW)
    fe = ServingFrontend(eng, tenants=_tenants(Tenant)).start()
    jfe = JaxFrontend(jeng, tenants=_tenants(JaxTenant)).start()
    yield fe, jfe
    fe.close()
    jfe.close()
    eng.shutdown(drain=False, timeout=30)
    jeng.shutdown(drain=False, timeout=30)


def _call(fe, method, path, body=None, key="sk-gold", timeout=120):
    conn = http.client.HTTPConnection("127.0.0.1", fe.port, timeout=timeout)
    try:
        conn.request(method, path,
                     json.dumps(body) if body is not None else None,
                     {"Authorization": f"Bearer {key}"})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _sse(fe, path, body):
    """The data payloads of a streamed response, [DONE] last."""
    status, headers, raw = _call(fe, "POST", path, {**body, "stream": True})
    assert status == 200
    assert headers["Content-Type"].startswith("text/event-stream")
    events = [e for e in raw.decode("utf-8").strip().split("\n\n") if e]
    assert all(e.startswith("data: ") for e in events)
    return [e[len("data: "):] for e in events]


def _shape(obj):
    """The key structure of a JSON value (values aside)."""
    if isinstance(obj, dict):
        return {k: _shape(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_shape(v) for v in obj]
    return type(obj).__name__


def _both(fronts, path, body):
    out = []
    for fe in fronts:
        status, _, data = _call(fe, "POST", path, body)
        assert status == 200, data
        out.append(json.loads(data))
    return out


# ==========================================================================
# generation against the JAX front end
# ==========================================================================

@pytest.mark.parametrize("path,body", [
    ("/v1/completions", {"prompt": "hello world", "max_tokens": 8}),
    ("/v1/completions", {"prompt": [72, 105, 33, 32], "max_tokens": 6}),
    ("/v1/chat/completions", {"messages": [
        SYSTEM, {"role": "user", "content": "hi"}], "max_tokens": 8}),
], ids=["text", "ids", "chat"])
def test_json_response_equals_jax(fronts, path, body):
    got, want = _both(fronts, path, body)
    assert _shape(got) == _shape(want)
    for k in ("object", "model", "usage"):
        assert got[k] == want[k], k
    assert got["choices"] == want["choices"]
    assert got["id"].startswith("cmpl-")


@pytest.mark.parametrize("path,body", [
    ("/v1/completions", {"prompt": "stream me", "max_tokens": 7}),
    ("/v1/chat/completions", {"messages": [
        SYSTEM, {"role": "user", "content": "go"}], "max_tokens": 7}),
], ids=["completions", "chat"])
def test_sse_stream_equals_jax_and_json(fronts, path, body):
    got, want = (_sse(fe, path, body) for fe in fronts)
    assert got[-1] == want[-1] == "[DONE]"
    gj, wj = ([json.loads(e) for e in ev[:-1]] for ev in (got, want))
    assert [_shape(e) for e in gj] == [_shape(e) for e in wj]
    key = "delta" if "chat" in path else "text"

    def text(events):
        return "".join(e["choices"][0][key].get("content", "")
                       if key == "delta" else e["choices"][0][key]
                       for e in events)

    assert text(gj) == text(wj)
    assert gj[-1]["choices"][0]["finish_reason"] \
        == wj[-1]["choices"][0]["finish_reason"]
    # the stream carries the JSON answer's text
    whole, _ = _both(fronts, path, body)
    choice = whole["choices"][0]
    assert text(gj) == (choice["message"]["content"] if key == "delta"
                        else choice["text"])


def test_regex_response_format_stops_and_equals_jax(fronts):
    body = {"prompt": "Answer: ", "max_tokens": 24,
            "response_format": {"type": "regex", "regex": REGEX}}
    got, want = _both(fronts, "/v1/completions", body)
    assert got["choices"] == want["choices"]
    choice = got["choices"][0]
    assert choice["finish_reason"] == "stop"
    assert re.fullmatch(REGEX, choice["text"])
    status, _, data = _call(fronts[0], "POST", "/v1/completions", {
        **body, "response_format": {"type": "xml"}})
    assert status == 400 and b"unsupported response_format" in data


def test_chat_shared_system_prompt_hits_the_prefix_cache(fronts):
    fe = fronts[0]
    m0 = (monitor.stat_get("prefix_matched_tokens"),
          monitor.stat_get("prefix_lookup_tokens"))
    long_system = {"role": "system", "content": "Rules: " + "be kind. " * 12}
    for q in ("first?", "second?", "third?"):
        status, _, _ = _call(fe, "POST", "/v1/chat/completions", {
            "messages": [long_system, {"role": "user", "content": q}],
            "max_tokens": 2})
        assert status == 200
    assert monitor.stat_get("prefix_matched_tokens") - m0[0] > 0
    assert monitor.stat_get("prefix_lookup_tokens") - m0[1] > 0


# ==========================================================================
# the other routes, against the JAX front end
# ==========================================================================

@pytest.mark.parametrize("method,path,body,key", [
    ("GET", "/v1/models", None, "sk-gold"),
    ("POST", "/v1/completions", {"prompt": "x"}, "wrong"),
    ("GET", "/nope", None, "sk-gold"),
    ("GET", "/v1/completions", None, "sk-gold"),
    ("POST", "/v1/completions", {"prompt": ""}, "sk-gold"),
    ("GET", "/healthz", None, "sk-gold"),
], ids=["models", "auth", "route", "method", "empty", "healthz"])
def test_route_answers_equal_jax(fronts, method, path, body, key):
    (gs, _, gd), (ws, _, wd) = (_call(fe, method, path, body, key=key)
                                for fe in fronts)
    assert gs == ws
    assert json.loads(gd) == json.loads(wd)


@pytest.mark.parametrize("body", [{"slots": [[1, 2]]},
                                  {"slots": {"items": [[3]]}}, None])
def test_rank_is_not_enabled_as_in_jax(fronts, body):
    """The reference's answer for an engine without a ranker (a stand-in
    with the front end's engine surface and no ``rank``)."""
    import types

    stub = dict(prefill_chunk=64, overload=None, cfg=CFG)
    jfe = JaxFrontend(types.SimpleNamespace(
        tokenizer=JaxByteTokenizer(), **stub),
        tenants=_tenants(JaxTenant)).start()
    try:
        got = _call(fronts[0], "POST", "/v1/rank", body)
        want = _call(jfe, "POST", "/v1/rank", body)
    finally:
        jfe.close()
    assert got[0] == want[0] == 404
    assert json.loads(got[2]) == json.loads(want[2])
    assert b"ranking not enabled" in got[2]
    assert _call(fronts[0], "POST", "/v1/rank", body, key="no")[0] == 401


def test_429_with_retry_after_isolated_per_tenant(fronts):
    fe = fronts[0]
    n0 = monitor.stat_get("frontend_429s")
    codes = [_call(fe, "POST", "/v1/completions",
                   {"prompt": "x", "max_tokens": 2}, key="sk-tiny")
             for _ in range(3)]
    assert [c[0] for c in codes].count(429) >= 2
    status, headers, data = next(c for c in codes if c[0] == 429)
    assert int(headers["Retry-After"]) >= 1
    assert json.loads(data)["error"]["type"] == "invalid_request_error"
    assert monitor.stat_get("frontend_429s") >= n0 + 2
    assert _call(fe, "POST", "/v1/completions",
                 {"prompt": "still here", "max_tokens": 2})[0] == 200


def test_metrics_parse_and_name_families_as_jax(fronts):
    fe, jfe = fronts
    _call(fe, "POST", "/v1/completions", {"prompt": "warm", "max_tokens": 2})
    status, headers, data = _call(fe, "GET", "/metrics")
    assert status == 200
    assert headers["Content-Type"].startswith("text/plain; version=0.0.4")
    text = data.decode()
    got = prom_families(text)
    want = prom_families(_call(jfe, "GET", "/metrics")[2].decode())
    assert got.items() <= want.items()
    for h in ("serving_first_token_ms", "serving_per_token_ms",
              "serving_queue_wait_ms", "serving_decode_tick_ms",
              "serving_prefill_chunk_ms"):
        assert got[f"paddle_tpu_{h}"] == "histogram"
    samples = {line.split()[0]: float(line.split()[1])
               for line in text.splitlines()
               if line and not line.startswith("#")}
    assert samples["paddle_tpu_serving_first_token_ms_count"] >= 1
    assert samples["paddle_tpu_frontend_requests"] >= 1
    for g in ("frontend_429s", "frontend_active_streams",
              "frontend_load_sheds", "frontend_queue_wait_ms",
              "router_failovers", "serving_replicas_healthy"):
        assert got[f"paddle_tpu_{g}"] == "gauge"


def test_conn_drop_aborts_a_stream_and_cancels_it(fronts):
    fe = fronts[0]
    f0 = monitor.stat_get("faults_injected")
    tfaults.configure_faults("conn_drop@step=1")
    writer = monitor.start_tracing()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", fe.port, timeout=60)
        conn.request("POST", "/v1/completions",
                     json.dumps({"prompt": "drop me", "max_tokens": 40,
                                 "stream": True}),
                     {"Authorization": "Bearer sk-gold"})
        resp = conn.getresponse()
        assert resp.status == 200
        try:
            raw = resp.read()
        except (http.client.IncompleteRead, ConnectionError) as e:
            raw = getattr(e, "partial", b"")
        conn.close()
        assert b"[DONE]" not in raw
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not any(
                e["name"] == "serving.request_done"
                for e in writer.events()):
            time.sleep(0.02)
    finally:
        monitor.stop_tracing()
        tfaults.configure_faults("")
    done = [e["args"] for e in writer.events()
            if e["name"] == "serving.request_done"]
    assert [d["reason"] for d in done] == ["cancelled"]
    assert done[0]["tokens"] < 40
    assert monitor.stat_get("faults_injected") == f0 + 1
    assert _sse(fe, "/v1/completions",
                {"prompt": "after", "max_tokens": 3})[-1] == "[DONE]"


def test_client_disconnect_cancels_the_stream(fronts):
    """A client that closes its connection mid-stream: the EOF watcher
    cancels the engine request."""
    import socket

    fe = fronts[0]
    body = json.dumps({"prompt": "hang up", "max_tokens": 200,
                       "stream": True}).encode()
    writer = monitor.start_tracing()
    try:
        sock = socket.create_connection(("127.0.0.1", fe.port), timeout=60)
        sock.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
                     b"Authorization: Bearer sk-gold\r\n"
                     b"Content-Length: %d\r\n\r\n" % len(body) + body)
        got = b""
        while b"data: " not in got:
            got += sock.recv(4096)
        sock.close()
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not any(
                e["name"] == "serving.request_done"
                for e in writer.events()):
            time.sleep(0.02)
    finally:
        monitor.stop_tracing()
    done = [e["args"] for e in writer.events()
            if e["name"] == "serving.request_done"]
    assert [d["reason"] for d in done] == ["cancelled"]
    assert done[0]["tokens"] < 200


def test_expired_deadline_is_a_503_as_in_jax(fronts):
    body = {"prompt": "too late", "max_tokens": 4, "deadline_s": 1e-9}
    (gs, gh, gd), (ws, wh, wd) = (_call(fe, "POST", "/v1/completions", body)
                                  for fe in fronts)
    assert gs == ws == 503
    assert gh["Retry-After"] == wh["Retry-After"] == "1"
    assert json.loads(gd)["error"]["type"] \
        == json.loads(wd)["error"]["type"] == "server_error"


def _frontend_events(fe, mon):
    writer = mon.start_tracing()
    try:
        status, _, _ = _call(fe, "POST", "/v1/completions",
                             {"prompt": "trace me", "max_tokens": 3})
        assert status == 200
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not any(
                e["name"] == "frontend.request" for e in writer.events()):
            time.sleep(0.02)
    finally:
        mon.stop_tracing()
    events = [e for e in writer.events() if e["name"].startswith(
        ("frontend.", "serving.request_done"))]
    return sorted((e["name"], e["ph"], tuple(sorted(e.get("args", {}))))
                  for e in events)


def test_frontend_spans_match_jax(fronts):
    from paddle_tpu import monitor as jmon

    assert _frontend_events(fronts[0], monitor) \
        == _frontend_events(fronts[1], jmon)


# ==========================================================================
# a router with a supervisor behind the front end
# ==========================================================================

def test_router_front_end_readiness_and_shed(fronts):
    _, params = _params()
    ctl = OverloadController(queue_wait_budget_ms=1e9, tick_budget_ms=1e9)

    def factory():
        return InferenceEngine(CFG, params, device="cpu", overload=ctl,
                               tokenizer=ByteTokenizer(), **KW)

    router = EngineRouter([factory(), factory()])
    ReplicaSupervisor(router, factory, poll_s=0.02)
    fe = ServingFrontend(router, tenants=[
        Tenant("gold-co", "sk-gold", rate=1000, burst=1000, lane="gold"),
        Tenant("bronze-co", "sk-bronze", rate=1000, burst=1000,
               lane="bronze")]).start()
    try:
        status, _, data = _call(fe, "GET", "/readyz")
        obj = json.loads(data)
        assert status == 200 and obj["status"] == "ok"
        checks = obj["checks"]
        assert checks["engine_alive"] and checks["pool_headroom"] > 0
        assert sorted(checks["replicas"]) == ["0", "1"]
        assert checks["lifecycle"]["target"] == 2
        assert checks["fleet"]["0"]["role"] == "mixed"
        body = {"prompt": "route me", "max_tokens": 6}
        got, want = _both((fe, fronts[0]), "/v1/completions", body)
        assert got["choices"] == want["choices"]
        ctl.force_rung(RUNG_SHED_BRONZE)
        s0 = monitor.stat_get("frontend_load_sheds")
        status, headers, data = _call(fe, "POST", "/v1/completions", body,
                                      key="sk-bronze")
        assert status == 503 and int(headers["Retry-After"]) >= 1
        assert json.loads(data)["error"]["type"] == "server_error"
        assert monitor.stat_get("frontend_load_sheds") == s0 + 1
        assert _call(fe, "POST", "/v1/completions", body)[0] == 200
        status, headers, _ = _call(fe, "GET", "/readyz")
        assert status == 503 and headers["Retry-After"]
        ctl.force_rung(0)
    finally:
        fe.close()
        router.shutdown(drain=False, timeout=60)


# ==========================================================================
# python -m paddle_tpu_torch.serving.frontend
# ==========================================================================

def _serve(extra):
    return subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.serving.frontend",
         "--port", "0", "--api-key", "test-key", *extra],
        cwd=_ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def test_module_main_serves_on_the_cpu_only_when_asked():
    proc = _serve(["--device", "cpu"])
    try:
        line = ""
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if "http://" in line or proc.poll() is not None:
                break
        m = re.search(r"http://([\d.]+):(\d+)", line)
        assert m, f"no address line: {line!r}"
        assert "device: cpu" in line
        conn = http.client.HTTPConnection(m.group(1), int(m.group(2)),
                                          timeout=120)
        conn.request("POST", "/v1/completions",
                     json.dumps({"prompt": "hello", "max_tokens": 4}),
                     {"Authorization": "Bearer test-key"})
        resp = conn.getresponse()
        body = json.loads(resp.read())
        conn.close()
        assert resp.status == 200
        assert body["usage"]["completion_tokens"] >= 1
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    if torch.cuda.is_available():
        return      # the card is the default device there
    proc = _serve([])
    out, _ = proc.communicate(timeout=120)
    assert proc.returncode != 0
    assert "RuntimeError" in out and "device='cpu'" in out
    assert "http://" not in out
