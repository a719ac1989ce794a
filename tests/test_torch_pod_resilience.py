"""paddle_tpu_torch's ``PodCoordinator`` (``resilience/pod.py``) against
paddle_tpu's, over the shared ``FileKVStore``.

- Two hosts (threads) agree the rollback step JAX's coordinators agree
  on the same proposals, and a JAX host and a port host agree in ONE
  store (the keys and values are the reference's); no common step
  raises in both;
- ``lost_hosts``: a host whose lease stops changing is reported after
  the ttl, as the reference's ElasticManager reports it; the injected
  ``host_loss@step=N`` tombstone is claimed at the same step in both;
- a guardian with a pod agrees its rollback through it; the resize
  (and the ElasticManager) belong to the multi-GPU slice and raise.
"""
import threading
import time

import numpy as np
import pytest

import paddle_tpu_torch
from paddle_tpu.distributed.elastic import ElasticManager
from paddle_tpu.distributed.elastic import FileKVStore as JStore
from paddle_tpu.resilience import configure_faults as jconfigure
from paddle_tpu.resilience.pod import PodAgreementError as JAgreementError
from paddle_tpu.resilience.pod import PodCoordinator as JPod
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.distributed.elastic import FileKVStore
from paddle_tpu_torch.resilience import configure_faults
from paddle_tpu_torch.resilience.pod import (PodAgreementError,
                                             PodCoordinator)
from torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)

HELD = {"h0": [-1, 0, 4, 8], "h1": [-1, 0, 4]}


@pytest.fixture(autouse=True)
def _clean():
    yield
    configure_faults("")
    jconfigure("")


def _agree(pods, held):
    out, errs = {}, []

    def run(p):
        try:
            out[p.host] = p.agree_rollback(held[p.host])
        except Exception as e:  # noqa: BLE001 - reported below
            errs.append(e)

    threads = [threading.Thread(target=run, args=(p,)) for p in pods]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    return out, errs


def test_two_hosts_agree_the_step_jax_agrees(tmp_path):
    hosts = sorted(HELD)
    js = JStore(str(tmp_path / "jax"))
    want, errs = _agree([JPod(js, "job", h, hosts, timeout=10)
                         for h in hosts], HELD)
    assert not errs and set(want.values()) == {4}
    ts = FileKVStore(str(tmp_path / "port"))
    got, errs = _agree([PodCoordinator(ts, "job", h, hosts, timeout=10)
                        for h in hosts], HELD)
    assert not errs and got == want
    # one JAX host and one port host in one store
    shared = str(tmp_path / "mixed")
    mixed, errs = _agree([JPod(JStore(shared), "job", "h0", hosts,
                               timeout=10),
                          PodCoordinator(FileKVStore(shared), "job", "h1",
                                         hosts, timeout=10)], HELD)
    assert not errs and mixed == want


def test_no_common_step_raises_in_both(tmp_path):
    held = {"h0": [8], "h1": [4]}
    hosts = sorted(held)
    _, jerrs = _agree([JPod(JStore(str(tmp_path / "j")), "job", h, hosts,
                            timeout=5) for h in hosts], held)
    _, terrs = _agree([PodCoordinator(FileKVStore(str(tmp_path / "t")),
                                      "job", h, hosts, timeout=5)
                       for h in hosts], held)
    assert len(jerrs) == len(terrs) == 2
    assert all(isinstance(e, JAgreementError) for e in jerrs)
    assert all(isinstance(e, PodAgreementError) for e in terrs)


def test_stale_lease_is_a_lost_host(tmp_path):
    ttl = 0.2
    hosts = ["h0", "h1"]
    js = JStore(str(tmp_path / "j"))
    em = ElasticManager(js, "job", min_np=1, heartbeat_ttl=ttl)
    jpod = JPod(js, "job", "h0", hosts, elastic=em)
    ts = FileKVStore(str(tmp_path / "t"))
    tpod = PodCoordinator(ts, "job", "h0", hosts, heartbeat_ttl=ttl)
    peer = PodCoordinator(ts, "job", "h1", hosts, heartbeat_ttl=ttl)
    em.heartbeat("h1")
    peer.maybe_heartbeat()
    seen = {"jax": [], "port": []}
    t_end = time.monotonic() + 4 * ttl
    while time.monotonic() < t_end:
        em.heartbeat("h0")
        tpod.maybe_heartbeat()
        seen["jax"].append(jpod.lost_hosts())
        seen["port"].append(tpod.lost_hosts())
        time.sleep(ttl / 4)
    assert seen["jax"][0] == seen["port"][0] == []
    assert seen["jax"][-1] == seen["port"][-1] == ["h1"]
    assert paddle_tpu_torch.monitor.stat_get("pod_hosts_alive") == 1
    # a fresh beat revives it (a new payload, a new observation)
    peer.maybe_heartbeat()
    assert tpod.lost_hosts() == []


def test_host_loss_fault_is_claimed_at_its_step(tmp_path):
    hosts = ["h0", "h1", "h2"]
    spec = "host_loss@step=3:host=h2"
    jpod = JPod(JStore(str(tmp_path / "j")), "job", "h0", hosts)
    tpod = PodCoordinator(FileKVStore(str(tmp_path / "t")), "job", "h0",
                          hosts)
    jconfigure(spec)
    configure_faults(spec)
    for s in range(5):
        assert jpod.lost_hosts(s) == tpod.lost_hosts(s) == (
            [] if s < 3 else ["h2"]), s
    assert tpod.remove_hosts(["h2"]) == ["h0", "h1"]


def _net(paddle):
    paddle.seed(0)
    net = paddle.nn.Sequential(paddle.nn.Linear(8, 16), paddle.nn.ReLU(),
                               paddle.nn.Linear(16, 4))
    opt = paddle.optimizer.Adam(learning_rate=1e-2,
                                parameters=net.parameters())
    return paddle.jit.TrainStep(
        net, lambda run, x, y: paddle.nn.functional.cross_entropy(run(x), y),
        opt, sentinel=True)


def test_guardian_agrees_its_rollback_and_resize_raises(tmp_path):
    from paddle_tpu_torch.resilience import TrainGuardian

    P = paddle_tpu_torch
    old = tdevice._current[0]
    P.set_device("cpu")
    try:
        step = _net(P)
        pod = PodCoordinator(FileKVStore(str(tmp_path)), "job", "h0",
                             ["h0"], timeout=5)
        g = TrainGuardian(step, snapshot_every=2, skip_limit=0, pod=pod)
        rng = np.random.default_rng(0)
        batch = (P.to_tensor(rng.normal(size=(4, 8)).astype("float32")),
                 P.to_tensor(rng.integers(0, 4, (4,))))
        configure_faults("nan_grad@step=3")
        actions = []
        i = 0
        while i < 5:
            a = g.after_step(i, step(*batch))
            actions.append(a)
            i = g.resume_step if a == "rollback" else i + 1
        assert actions.count("rollback") == 1 and pod._round == 1
        configure_faults("host_loss@step=6:host=h0")
        with pytest.raises(NotImplementedError, match="item 7"):
            g.after_step(6, step(*batch))
        g.close()
        with pytest.raises(NotImplementedError, match="item 7"):
            PodCoordinator(FileKVStore(str(tmp_path)), "job", "h0", ["h0"],
                           elastic=object())
        with pytest.raises(NotImplementedError, match="item 7"):
            pod.surviving_devices(["h0"])
    finally:
        tdevice._current[0] = old
