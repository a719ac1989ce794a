"""paddle_tpu_torch's checkpoints (``framework/checkpoint.py``): its own
format (a JSON manifest and one ``torch.save`` file per tree path),
written atomically through a ``.tmp-`` directory and ``os.replace``.

- A round trip of a mixed tree (f32, bf16, int32, int64, bool, 0-dim,
  nested dicts, lists, tuples, JSON scalars) is bit-identical, leaves
  are keyed by tree path, and no ``.tmp-`` leftover stays;
- injected ``ckpt_io_error`` faults are retried (and a budget past the
  retries raises, leaving neither the checkpoint nor a leftover);
- a kill between a re-save's two renames keeps the old step, which the
  next manager puts back; ``keep_last``'s sweep spares this process's
  writes in flight;
- ``restore_latest`` skips a corrupt newest step with a warning, and
  installs IN PLACE into a train step's own tensors;
- ``save_interval_steps`` and ``max_to_keep`` keep the same steps as the
  reference's orbax ``CheckpointManager`` on the same save sequence.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.framework.checkpoint import CheckpointManager as JManager
from paddle_tpu_torch.framework.checkpoint import (CheckpointManager,
                                                   load_checkpoint,
                                                   save_checkpoint)
from paddle_tpu_torch.monitor import stat_get
from paddle_tpu_torch.resilience import configure_faults
from torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.fixture(autouse=True)
def _no_faults():
    yield
    configure_faults("")


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(5, 7, generator=g),
                       "h": torch.randn(3, 4, generator=g).to(torch.bfloat16),
                       "0.bias/x": torch.randn(2, generator=g)},
            "slots": {"0.weight": [torch.randn(4, generator=g),
                                   torch.tensor(0.9 ** 3)]},
            "ints": (torch.arange(6, dtype=torch.int32).reshape(2, 3),
                     torch.tensor(7, dtype=torch.int64)),
            "flags": torch.tensor([True, False]),
            "meta": {"step": 3, "lr": 0.5, "name": "x", "none": None}}


def _equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        return all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        return all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
            a.view(torch.uint8) if a.dim() else a, b.view(torch.uint8)
            if b.dim() else b)
    return a == b


def test_round_trip_is_bit_identical_and_atomic(tmp_path):
    tree = _tree()
    path = str(tmp_path / "ck")
    nbytes = save_checkpoint(path, tree)
    assert nbytes == sum(t.numel() * t.element_size() for t in (
        tree["params"]["w"], tree["params"]["h"], tree["params"]["0.bias/x"],
        *tree["slots"]["0.weight"], *tree["ints"], tree["flags"]))
    assert os.listdir(tmp_path) == ["ck"]
    assert os.path.exists(os.path.join(path, "params", "w.pt"))
    assert os.path.exists(os.path.join(path, "params", "0.bias%2Fx.pt"))
    assert os.path.exists(os.path.join(path, "slots", "0.weight", "1.pt"))
    assert _equal(tree, load_checkpoint(path))
    assert _equal(tree, load_checkpoint(path, template=_tree(1)))
    with pytest.raises(ValueError, match="exists"):
        save_checkpoint(path, tree, force=False)
    bad = _tree(1)
    bad["params"]["w"] = torch.zeros(5, 8)
    with pytest.raises(ValueError):
        load_checkpoint(path, template=bad)
    assert os.listdir(tmp_path) == ["ck"]


def test_injected_io_errors_are_retried(tmp_path):
    configure_faults("ckpt_io_error@step=0:repeat=2")
    n0 = stat_get("faults_injected")
    with pytest.warns(UserWarning, match="transient OSError"):
        save_checkpoint(str(tmp_path / "ok"), _tree(), retries=3)
    assert stat_get("faults_injected") - n0 == 2
    assert _equal(_tree(), load_checkpoint(str(tmp_path / "ok")))
    configure_faults("ckpt_io_error@step=0:repeat=10")
    with pytest.warns(UserWarning), pytest.raises(OSError):
        save_checkpoint(str(tmp_path / "no"), _tree(), retries=2)
    assert sorted(os.listdir(tmp_path)) == ["ok"]


def test_a_kill_inside_a_resave_keeps_the_step(tmp_path, monkeypatch):
    """Re-saving a step renames the old directory aside before it
    publishes the new one: killed between the two renames, the step is
    still complete on disk, and the next manager puts it back."""
    from paddle_tpu_torch.framework import checkpoint as ck

    root = str(tmp_path)
    old = _tree()
    save_checkpoint(os.path.join(root, "3"), old)
    real = os.replace

    def killed(src, dst):
        if ".tmp-" in str(src):
            raise KeyboardInterrupt("killed between the renames")
        return real(src, dst)

    monkeypatch.setattr(ck.os, "replace", killed)
    with pytest.raises(KeyboardInterrupt):
        save_checkpoint(os.path.join(root, "3"), _tree(1))
    monkeypatch.setattr(ck.os, "replace", real)
    assert not os.path.exists(os.path.join(root, "3"))
    assert [n for n in os.listdir(root) if ".old-" in n]
    mgr = CheckpointManager(root)
    assert mgr.all_steps() == [3]
    assert _equal(old, load_checkpoint(os.path.join(root, "3")))
    # a completed re-save leaves the new step and nothing beside it
    save_checkpoint(os.path.join(root, "3"), _tree(1))
    assert os.listdir(root) == ["3"]
    assert _equal(_tree(1), load_checkpoint(os.path.join(root, "3")))


def test_a_failed_publish_puts_the_old_step_back(tmp_path, monkeypatch):
    """An ``OSError`` from publishing a re-save renames the old step back
    before the retry, which then publishes the new one and leaves
    nothing beside it."""
    from paddle_tpu_torch.framework import checkpoint as ck

    root = str(tmp_path)
    save_checkpoint(os.path.join(root, "3"), _tree())
    real, failed = os.replace, []

    def flaky(src, dst):
        if ".tmp-" in str(src) and not failed:
            failed.append(src)
            assert os.path.exists(os.path.join(root, "3")) is False
            raise OSError("flaky mount")
        return real(src, dst)

    monkeypatch.setattr(ck.os, "replace", flaky)
    save_checkpoint(os.path.join(root, "3"), _tree(1))
    assert failed and os.listdir(root) == ["3"]
    assert _equal(_tree(1), load_checkpoint(os.path.join(root, "3")))


def test_gc_spares_this_process_writes_in_flight(tmp_path):
    """``keep_last``'s sweep removes another process's leftovers, never
    a directory that a writer thread of this process is still filling."""
    root = str(tmp_path)
    mine = os.path.join(root, f"7.tmp-{os.getpid()}-1")
    theirs = os.path.join(root, "7.tmp-999999999-1")
    aside = os.path.join(root, "2.old-999999999-1")
    mgr = CheckpointManager(root, keep_last=2, async_save=False)
    for d in (mine, theirs, aside):
        os.makedirs(d)
    for i in range(4):
        mgr.save(i, {"w": torch.full((3,), float(i))})
    assert sorted(os.listdir(root)) == ["2", "3", os.path.basename(mine)]


class _Step:
    """A DistributedTrainStep-like object (params, opt_state, count)."""

    def __init__(self, val):
        self.params = {"w": torch.full((4,), float(val))}
        self.opt_state = {"count": torch.zeros((), dtype=torch.int32),
                          "m": {"w": torch.zeros(4)}}
        self._step_count = 0
        self.device = torch.device("cpu")


def test_restore_latest_skips_a_corrupt_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=5, async_save=True)
    for i in range(3):
        s = _Step(i)
        s.opt_state["count"].fill_(i)
        s._step_count = i + 1
        assert mgr.maybe_save(i, s)
    mgr.wait_until_finished()
    assert mgr.all_steps() == [0, 1, 2]
    # the newest step's tensor file is truncated after the fact
    with open(os.path.join(str(tmp_path), "2", "params", "w.pt"), "wb") as f:
        f.write(b"garbage")
    dst = _Step(9)
    w = dst.params["w"]
    with pytest.warns(UserWarning, match="skipping unreadable"):
        assert mgr.restore_latest(dst) == 2
    assert dst.params["w"] is w                    # copied in, not rebound
    assert torch.equal(w, torch.full((4,), 1.0))
    assert int(dst.opt_state["count"]) == 1 and dst._step_count == 2
    with pytest.raises(TypeError):
        mgr.restore_latest({"w": torch.zeros(4)})
    with pytest.warns(UserWarning, match="skipping unreadable"):
        step, tree = mgr.restore_latest_tree(mgr._state_of(_Step(0)))
    assert step == 1 and torch.equal(tree["params"]["w"],
                                     torch.full((4,), 1.0))


def _orbax_steps(path, interval, keep, steps):
    mgr = JManager(path, save_interval_steps=interval, max_to_keep=keep,
                   async_save=False)
    try:
        saved = [s for s in steps
                 if mgr.maybe_save(s, {"w": jnp.full((2,), float(s))})]
        return saved, list(mgr._mgr.all_steps())
    finally:
        mgr.close()


@pytest.mark.parametrize("interval,keep,steps", [
    (1, 3, list(range(8))), (3, 2, list(range(1, 12))),
    (2, 2, [0, 1, 2, 3, 5, 6, 9, 10])])
def test_interval_and_max_to_keep_match_orbax(tmp_path, interval, keep,
                                              steps):
    want = _orbax_steps(str(tmp_path / "jax"), interval, keep, steps)
    mgr = CheckpointManager(str(tmp_path / "port"),
                            save_interval_steps=interval, max_to_keep=keep,
                            async_save=False)
    saved = [s for s in steps
             if mgr.maybe_save(s, {"w": torch.full((2,), float(s))})]
    assert (saved, mgr.all_steps()) == want
    assert torch.equal(load_checkpoint(os.path.join(
        str(tmp_path / "port"), str(saved[-1])))["w"],
        torch.full((2,), float(saved[-1])))
