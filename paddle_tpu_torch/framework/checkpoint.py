"""Checkpoints on disk and their manager (``paddle_tpu/framework/
checkpoint.py``).

The JAX package writes orbax checkpoints; the port writes its own format,
which needs nothing beyond torch. A checkpoint is one directory:

- ``manifest.json``: the format tag, the tree's structure (dicts, lists,
  tuples, JSON scalars inline) and, for each tensor leaf, its tree path,
  dtype, shape and file;
- one file per tensor leaf, written with ``torch.save`` from a CPU
  tensor, at a path keyed by the leaf's tree path
  (``params/wte.pt``, ``slots/0.weight/1.pt``), so that the multi-GPU
  slice can write a leaf's shards per rank beside it.

A save is atomic: it writes a sibling ``<path>.tmp-<pid>-<ns>`` directory
and publishes it with ``os.replace``, so a reader sees either the old
complete checkpoint or the new one, and a crash leaves only a ``.tmp-``
leftover that no reader lists. Re-saving a step first renames the old
directory aside (``<path>.old-<pid>-<ns>``), publishes the new one, then
deletes the old: a kill between the two renames leaves the old
checkpoint complete under its aside name, and a
:class:`CheckpointManager` opening the directory puts it back. Each
attempt runs the ``ckpt_io_error`` fault hook (``resilience/faults.py``)
and is retried on ``OSError`` with exponential backoff
(:func:`_with_io_retry`), as a flaky shared mount needs. A load checks every leaf's dtype and shape against the manifest,
so a truncated or corrupt step raises instead of restoring garbage.

:class:`CheckpointManager` keeps numbered step directories under one
root (the reference's AutoCheckpoint): ``maybe_save`` gated by
``save_interval_steps`` as orbax gates it (the first save always, then
steps past the newest that the interval divides), ``max_to_keep`` newest
steps kept, an optional ``keep_last`` sweep of anything older (and of
stale ``.tmp-`` leftovers), ``restore_latest`` skipping a step it cannot
read, and ``wait_until_finished`` for the background writer of
``async_save=True``. Reading the JAX package's orbax checkpoints is not
ported.
"""
from __future__ import annotations

import concurrent.futures
import json
import os
import shutil
import threading
import time
import urllib.parse
import warnings
from typing import Any, Optional, Tuple

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint", "CheckpointManager"]

FORMAT = "paddle_tpu_torch.checkpoint/1"
MANIFEST = "manifest.json"


def _save_attempt_hook() -> None:
    """The ``ckpt_io_error`` fault hook: raises a transient OSError where
    a flaky shared mount would."""
    from ..resilience.faults import ENABLED, FAULTS

    if ENABLED[0]:
        FAULTS.on_ckpt_io()


def _with_io_retry(fn, what: str, retries: int = 3, backoff: float = 0.05):
    """Run ``fn``, retrying a transient OSError with exponential backoff."""
    for attempt in range(retries + 1):
        try:
            _save_attempt_hook()
            return fn()
        except OSError as e:
            if attempt >= retries:
                raise
            delay = backoff * (2 ** attempt)
            warnings.warn(f"transient OSError during {what} "
                          f"(attempt {attempt + 1}/{retries + 1}): {e}; "
                          f"retrying in {delay:.2f}s")
            time.sleep(delay)


# -- the tree <-> (structure, leaves) --------------------------------------

def _component(k) -> str:
    return urllib.parse.quote(str(k), safe="")


def _flatten(tree, path, leaves):
    """The JSON structure of ``tree``; tensor leaves appended to
    ``leaves`` as (path, tensor)."""
    if isinstance(tree, dict):
        return {"d": {str(k): _flatten(v, path + (str(k),), leaves)
                      for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        return {"l": [_flatten(v, path + (str(i),), leaves)
                      for i, v in enumerate(tree)],
                "tuple": isinstance(tree, tuple)}
    if isinstance(tree, np.ndarray):
        tree = torch.from_numpy(np.ascontiguousarray(tree))
    if isinstance(tree, torch.Tensor):
        leaves.append((path, tree))
        return {"t": len(leaves) - 1}
    if isinstance(tree, np.generic):
        tree = tree.item()
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return {"v": tree}
    raise TypeError(f"cannot checkpoint a {type(tree).__name__} leaf at "
                    f"{'/'.join(path)}")


def _unflatten(node, leaves):
    if "d" in node:
        return {k: _unflatten(v, leaves) for k, v in node["d"].items()}
    if "l" in node:
        items = [_unflatten(v, leaves) for v in node["l"]]
        return tuple(items) if node.get("tuple") else items
    if "t" in node:
        return leaves[node["t"]]
    return node["v"]


def _host(t: torch.Tensor) -> torch.Tensor:
    """A CPU tensor that owns exactly its bytes (torch.save writes a
    view's whole storage)."""
    t = t.detach()
    if t.device.type != "cpu":
        t = t.cpu()
    if not t.is_contiguous() or t.untyped_storage().nbytes() != \
            t.numel() * t.element_size():
        t = t.contiguous().clone()
    return t


# leaf files a blocking save writes at once: torch.save's zip records are
# CRC-bound on one core. 5.15 GB of f32 saves at 0.92-1.05 GB/s with one
# writer and 4.66-6.21 GB/s with four (tools/host_io_study.py, two runs
# on an NVIDIA H100 80GB HBM3 host, 700.00 W). A save behind a running
# loop takes one: four writer threads starved the loop's thread of the
# interpreter for up to 2 s a step.
WRITERS = 4


def _write_dir(root: str, state: Any, writers: int = WRITERS) -> int:
    """Write ``state`` into the (new) directory ``root`` with ``writers``
    threads; returns the tensor bytes written."""
    leaves: list = []
    structure = _flatten(state, (), leaves)
    os.makedirs(root)
    entries = []
    for path, t in leaves:
        rel = "/".join(_component(c) for c in path) + ".pt"
        os.makedirs(os.path.dirname(os.path.join(root, rel)), exist_ok=True)
        entries.append({"path": list(path), "file": rel,
                        "dtype": str(t.dtype).replace("torch.", ""),
                        "shape": list(t.shape)})

    def write(i):
        h = _host(leaves[i][1])
        torch.save(h, os.path.join(root, entries[i]["file"]))
        return h.numel() * h.element_size()

    with concurrent.futures.ThreadPoolExecutor(writers) as pool:
        nbytes = sum(pool.map(write, range(len(leaves))))
    with open(os.path.join(root, MANIFEST), "w") as f:
        json.dump({"format": FORMAT, "structure": structure,
                   "leaves": entries}, f)
        f.flush()
        os.fsync(f.fileno())
    return nbytes


def save_checkpoint(path: str, state: Any, force: bool = True,
                    retries: int = 3, writers: int = WRITERS) -> int:
    """Write a tree of tensors (dicts, lists, tuples; numpy arrays and
    JSON scalars too) as one checkpoint directory at ``path``, atomically
    (see the module's docstring), with ``writers`` threads; returns the
    tensor bytes written. An existing checkpoint at ``path`` is replaced
    when ``force``, else ``ValueError``."""
    path = os.path.abspath(path)
    tmp = f"{path}.tmp-{os.getpid()}-{time.monotonic_ns()}"
    out = [0]

    def attempt():
        if os.path.exists(tmp):
            shutil.rmtree(tmp, ignore_errors=True)
        out[0] = _write_dir(tmp, state, writers)
        aside = None
        if os.path.exists(path):
            if not force:
                shutil.rmtree(tmp, ignore_errors=True)
                raise ValueError(f"checkpoint {path} exists (force=False)")
            aside = f"{path}.old-{os.getpid()}-{time.monotonic_ns()}"
            os.replace(path, aside)
        try:
            os.replace(tmp, path)
        except OSError:             # put the old one back, then retry
            if aside is not None:
                os.replace(aside, path)
            raise
        if aside is not None:
            shutil.rmtree(aside, ignore_errors=True)

    try:
        _with_io_retry(attempt, f"checkpoint save to {path}",
                       retries=retries)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out[0]


def _template_leaves(template):
    leaves: list = []
    _flatten(template, (), leaves)
    return leaves


def load_checkpoint(path: str, template: Optional[Any] = None) -> Any:
    """Read a checkpoint back as a tree of CPU tensors. With a
    ``template`` (a tree of tensors of the same structure) each leaf must
    have the template leaf's dtype and shape, and is returned on the
    template leaf's device. Raises on a missing, truncated or mismatched
    leaf."""
    path = os.path.abspath(path)
    with open(os.path.join(path, MANIFEST)) as f:
        man = json.load(f)
    if man.get("format") != FORMAT:
        raise ValueError(f"{path}: not a {FORMAT} checkpoint "
                         f"({man.get('format')!r})")
    leaves = []
    for e in man["leaves"]:
        # mapped, not read: the bytes go from the page cache to where
        # the caller copies them
        t = torch.load(os.path.join(path, e["file"]), map_location="cpu",
                       weights_only=True, mmap=True)
        if not isinstance(t, torch.Tensor) \
                or str(t.dtype).replace("torch.", "") != e["dtype"] \
                or list(t.shape) != e["shape"]:
            raise ValueError(f"{path}: leaf {'/'.join(e['path'])} does not "
                             f"match its manifest entry")
        leaves.append(t)
    if template is not None:
        want = _template_leaves(template)
        if [tuple(p) for p, _ in want] != [tuple(e["path"])
                                           for e in man["leaves"]]:
            raise ValueError(f"{path}: the checkpoint's tree differs from "
                             f"the template's")
        for i, ((p, ref), t) in enumerate(zip(want, leaves)):
            if t.dtype != ref.dtype or t.shape != ref.shape:
                raise ValueError(
                    f"{path}: leaf {'/'.join(p)} is {t.dtype} "
                    f"{tuple(t.shape)}, the template's {ref.dtype} "
                    f"{tuple(ref.shape)}")
            if ref.device.type != "cpu":
                leaves[i] = t.to(ref.device)
    return _unflatten(man["structure"], leaves)


def _copy_tree_into(dst, src) -> None:
    """Copy every tensor of ``src`` into the matching tensor of ``dst``
    (same structure), in place."""
    if isinstance(dst, dict):
        for k, v in dst.items():
            _copy_tree_into(v, src[k])
    elif isinstance(dst, (list, tuple)):
        for a, b in zip(dst, src):
            _copy_tree_into(a, b)
    elif isinstance(dst, torch.Tensor):
        with torch.no_grad():
            dst.copy_(torch.as_tensor(src))


class CheckpointManager:
    """Periodic numbered checkpoints, retention and resume (the
    reference's AutoCheckpoint; see the module's docstring).

    Usage::

        mgr = CheckpointManager(dir, save_interval_steps=100, max_to_keep=3)
        start = mgr.restore_latest(step_obj) or 0     # auto-resume
        for step_i in range(start, n_steps):
            loss = step_obj(batch)
            mgr.maybe_save(step_i, step_obj)
    """

    def __init__(self, directory: str, save_interval_steps: int = 1,
                 max_to_keep: Optional[int] = 3, async_save: bool = True,
                 save_retries: int = 3, keep_last: Optional[int] = None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.save_interval_steps = max(1, int(save_interval_steps))
        self.max_to_keep = int(max_to_keep) if max_to_keep else None
        self.save_retries = int(save_retries)
        self.keep_last = int(keep_last) if keep_last else None
        self.async_save = bool(async_save)
        self._writer: Optional[threading.Thread] = None
        self._writer_error: Optional[BaseException] = None
        self.last_save_bytes = 0
        self.last_save_s = 0.0
        self._recover_aside()

    # -- state extraction ---------------------------------------------------
    @staticmethod
    def _state_of(obj):
        """A DistributedTrainStep-like object's state (params, optimizer
        state, step count and its device's generator state, so a resume
        draws what the run would have drawn), or the tree itself."""
        if hasattr(obj, "params") and hasattr(obj, "opt_state"):
            from .random import get_rng_state

            return {"params": obj.params, "opt_state": obj.opt_state,
                    "step_count": torch.tensor(int(obj._step_count)),
                    "rng": get_rng_state(getattr(obj, "device", None))}
        return obj

    @staticmethod
    def _install(obj, state):
        if hasattr(obj, "params") and hasattr(obj, "opt_state") \
                and isinstance(state, dict) and "params" in state:
            _copy_tree_into(obj.params, state["params"])
            _copy_tree_into(obj.opt_state, state["opt_state"])
            obj._step_count = int(state.get("step_count", 0))
            if "rng" in state:
                from .random import set_rng_state

                set_rng_state(state["rng"], getattr(obj, "device", None))
            return obj
        return state

    # -- steps on disk ------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def _recover_aside(self) -> None:
        """Put back a step that a re-save renamed aside and was killed
        before it published the new one (see the module's docstring)."""
        try:
            names = sorted(os.listdir(self.directory))
        except OSError:
            return
        for n in names:
            step, sep, _ = n.partition(".old-")
            if sep and step.isdigit() \
                    and not os.path.exists(self._step_dir(int(step))):
                os.replace(os.path.join(self.directory, n),
                           self._step_dir(int(step)))

    def all_steps(self):
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        return sorted(int(n) for n in names if n.isdigit()
                      and os.path.isdir(os.path.join(self.directory, n)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def should_save(self, step: int, pending: Optional[int] = None) -> bool:
        """Whether :meth:`maybe_save` would write at this step: the first
        save always, then a step past the newest that the interval
        divides (orbax's rule). ``pending``: the newest step a caller's
        own writer has queued but not yet published, counted as saved."""
        last = self.latest_step()
        if pending is not None and (last is None or pending > last):
            last = pending
        if last is not None and last >= step:
            return False
        return last is None or step % self.save_interval_steps == 0

    # -- save ---------------------------------------------------------------
    def _write(self, step: int, state, writers: int = WRITERS) -> None:
        t0 = time.perf_counter()
        self.last_save_bytes = save_checkpoint(
            self._step_dir(step), state, force=True,
            retries=self.save_retries, writers=writers)
        self.last_save_s = time.perf_counter() - t0
        if self.max_to_keep is not None:
            for old in self.all_steps()[:-self.max_to_keep]:
                if old != step:
                    shutil.rmtree(self._step_dir(old), ignore_errors=True)
        if self.keep_last is not None:
            self._gc(just_saved=step)

    def _save(self, step: int, obj) -> bool:
        state = self._state_of(obj)
        if not self.async_save:
            self._write(step, state)
            return True
        self.wait_until_finished()
        # host copies now: the device state moves on with the next step
        leaves: list = []
        structure = _flatten(state, (), leaves)
        host = _unflatten(structure, [_host(t) for _, t in leaves])

        def run():
            try:
                self._write(step, host, writers=1)
            except BaseException as e:  # noqa: BLE001 - re-raised on wait
                self._writer_error = e

        self._writer = threading.Thread(target=run, daemon=True,
                                        name="checkpoint-writer")
        self._writer.start()
        return True

    def maybe_save(self, step: int, obj) -> bool:
        """Interval-gated save; False when skipped. Transient OSErrors are
        retried with backoff."""
        if not self.should_save(step):
            return False
        return self._save(step, obj)

    def save(self, step: int, obj) -> bool:
        """Unconditional save (the interval bypassed): the final or a
        priority checkpoint."""
        return self._save(step, obj)

    def save_behind(self, step: int, tree) -> None:
        """Write a host tree from a background thread while the training
        loop runs: one writer thread, so the loop keeps the
        interpreter."""
        self._write(step, tree, writers=1)

    def _gc(self, just_saved: Optional[int] = None) -> None:
        """The ``keep_last`` sweep: every numeric step directory older
        than the newest ``keep_last`` (corrupt ones included: age is the
        step NUMBER) and every stale ``.tmp-`` / ``.old-`` leftover of
        another process goes; the step just saved, and this process's
        writes in flight (another writer thread's), never do."""
        try:
            names = os.listdir(self.directory)
        except OSError:
            return
        ours = (f".tmp-{os.getpid()}-", f".old-{os.getpid()}-")
        steps = []
        for n in names:
            p = os.path.join(self.directory, n)
            if ".tmp-" in n or ".old-" in n or n.startswith("tmp"):
                if not any(o in n for o in ours):
                    shutil.rmtree(p, ignore_errors=True)
                continue
            if n.isdigit() and os.path.isdir(p):
                steps.append(int(n))
        keep = set(sorted(steps)[-self.keep_last:])
        if just_saved is not None:
            keep.add(int(just_saved))
        for s in steps:
            if s not in keep:
                shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def restore(self, step: int, obj):
        """Restore step ``step``. A train-step-like object is updated in
        place (its tensors copied into, never rebound) and returned; a
        tree is a template: the restored tree is the return value."""
        self.wait_until_finished()
        state = self._state_of(obj)
        restored = load_checkpoint(self._step_dir(step), template=state)
        return self._install(obj, restored)

    def restore_latest(self, obj) -> Optional[int]:
        """Auto-resume: restore the newest step that reads back into
        ``obj``; returns the step to continue FROM (restored + 1), or None
        when nothing is restorable. A step that cannot be read is skipped
        with a warning. Only an object with ``params``/``opt_state`` is
        accepted: for a tree use :meth:`restore_latest_tree`."""
        if not (hasattr(obj, "params") and hasattr(obj, "opt_state")):
            raise TypeError(
                "restore_latest needs an object with .params/.opt_state "
                "to install into; for a raw tree use "
                "restore_latest_tree(template) and keep the returned tree")
        got = self.restore_latest_tree(self._state_of(obj))
        if got is None:
            return None
        step, state = got
        self._install(obj, state)
        return step + 1

    def restore_latest_tree(self, template) -> Optional[Tuple[int, Any]]:
        """``(step, tree)`` from the newest step that reads back against
        ``template``, or None. Unreadable steps are skipped with a
        warning."""
        self.wait_until_finished()
        for step in reversed(self.all_steps()):
            try:
                return step, load_checkpoint(self._step_dir(step),
                                             template=template)
            except Exception as e:  # noqa: BLE001 - skip it, keep looking
                warnings.warn(
                    f"skipping unreadable checkpoint step {step} in "
                    f"{self.directory}: {type(e).__name__}: {e}")
        return None

    def wait_until_finished(self) -> None:
        """Join the background writer (``async_save=True``); re-raise
        what it raised."""
        w = self._writer
        if w is not None:
            w.join()
            self._writer = None
        err, self._writer_error = self._writer_error, None
        if err is not None:
            raise err

    def close(self) -> None:
        self.wait_until_finished()
