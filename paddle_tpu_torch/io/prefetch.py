"""Double-buffered device prefetcher (``paddle_tpu/io/prefetch.py``).

The DataLoader yields host batches; a training step reads card tensors.
:class:`DevicePrefetcher` wraps any batch iterator and keeps ``size``
batches (2: double buffering) staged on the card ahead of the consumer:
a producer thread pins each host tensor and copies it to the card on a
side stream, then records an event; the consumer's stream waits on that
event before the batch is handed over (no host sync), so the copy of
batch N+1 overlaps step N. This is the reference's C++ BufferedReader
async H2D stage. A leaf already on the card is passed as it is; on the
CPU the prefetcher only runs the iterator ahead on its thread.

Batches go to one device: the mesh placement of the JAX package
(``mesh=`` / ``batch_spec=``) goes with multi-GPU parallelism (ROADMAP.md
Queue 1 item 7) and raises.

Gauges (``monitor/stats.py``): ``prefetch_queue_depth`` (batches staged
ahead: a queue that stays empty means the step waits for input) and
``h2d_copy_ms`` (host ms spent issuing the copies). While tracing is on,
``prefetch.h2d_copy`` and ``prefetch.wait`` spans land in the trace.
Under ``FLAGS_fault_inject`` the producer calls the ``input_stall`` hook
(``resilience/faults.py``) with each batch's index before staging it: a
sleeping producer starves the consumer as a wedged storage read would.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Iterable

import numpy as np
import torch

from ..framework.core import Tensor
from ..monitor import stats as _mstats
from ..monitor.trace import TRACING as _TRACING
from ..monitor.trace import get_writer as _trace_writer
from ..resilience import faults as _faults

__all__ = ["DevicePrefetcher", "prefetch_to_device"]


class DevicePrefetcher:
    """Iterator wrapper staging batch N+1 on the card while step N runs.

    Args:
      it: iterable of batches (tuples, lists, dicts whose leaves are
        Tensors, torch tensors, numpy arrays or scalars). The structure
        is kept; a Tensor comes back as a Tensor over the card copy,
        a numpy array or torch tensor as a torch tensor on the card.
      size: prefetch depth.

    Batches are staged on the current device.
    """

    def __init__(self, it: Iterable, size: int = 2, mesh=None,
                 batch_spec=None):
        if mesh is not None or batch_spec is not None:
            raise NotImplementedError(
                "DevicePrefetcher(mesh=..., batch_spec=...): mesh placement "
                "goes with multi-GPU parallelism, not ported yet (ROADMAP.md "
                "Queue 1 item 7)")
        self._it = it
        self.size = max(1, int(size))
        self._h2d_ms = 0.0

    def _put_leaf(self, x, dev, cuda, stream):
        is_tensor = isinstance(x, Tensor)
        d = x._data if is_tensor else x
        if isinstance(d, np.ndarray):
            d = torch.from_numpy(np.ascontiguousarray(d))
        if not isinstance(d, torch.Tensor):
            return x
        if d.device != dev:
            if cuda and d.device.type == "cpu":
                d = d.pin_memory()
            d = d.to(dev, non_blocking=True)
            if cuda:
                # the consumer's stream uses it: keep the allocator from
                # reusing its memory before that stream is done with it
                d.record_stream(stream)
        if is_tensor:
            return Tensor(d, stop_gradient=x.stop_gradient, name=x.name)
        return d

    def _put_batch(self, batch, dev, cuda, stream):
        if isinstance(batch, (list, tuple)):
            return type(batch)(self._put_batch(v, dev, cuda, stream)
                               for v in batch)
        if isinstance(batch, dict):
            return {k: self._put_batch(v, dev, cuda, stream)
                    for k, v in batch.items()}
        return self._put_leaf(batch, dev, cuda, stream)

    def __iter__(self):
        from ..device import current_device

        dev = current_device()
        cuda = dev.type == "cuda"
        consumer = torch.cuda.current_stream(dev) if cuda else None
        side = torch.cuda.Stream(dev) if cuda else None
        q: queue.Queue = queue.Queue(maxsize=self.size)
        sentinel = object()
        err: list = []

        def producer():
            try:
                for idx, batch in enumerate(self._it):
                    if _faults.ENABLED[0]:
                        _faults.FAULTS.on_input(idx)
                    t0 = time.perf_counter()
                    if cuda:
                        with torch.cuda.stream(side):
                            staged = self._put_batch(batch, dev, cuda,
                                                     consumer)
                            ev = torch.cuda.Event()
                            ev.record(side)
                    else:
                        staged, ev = batch, None
                    dt = time.perf_counter() - t0
                    total = self._h2d_ms + dt * 1e3
                    _mstats.H2D_COPY_MS.add(int(total) - int(self._h2d_ms))
                    self._h2d_ms = total
                    if _TRACING[0]:
                        _trace_writer().add_complete(
                            "prefetch.h2d_copy", t0, dt, cat="input")
                    q.put((staged, ev))
                    _mstats.PREFETCH_QUEUE_DEPTH.set(q.qsize())
            except BaseException as e:  # noqa: BLE001
                err.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            if _TRACING[0] and q.empty():
                t0 = time.perf_counter()
                item = q.get()
                _trace_writer().add_complete(
                    "prefetch.wait", t0, time.perf_counter() - t0,
                    cat="input")
            else:
                item = q.get()
            if item is sentinel:
                break
            staged, ev = item
            if ev is not None:
                consumer.wait_event(ev)
            _mstats.PREFETCH_QUEUE_DEPTH.set(q.qsize())
            yield staged
        t.join()
        _mstats.PREFETCH_QUEUE_DEPTH.set(0)
        if err:
            raise err[0]

    def __len__(self):
        return len(self._it)


def prefetch_to_device(it: Iterable, size: int = 2, mesh=None,
                       batch_spec=None):
    """Functional form of :class:`DevicePrefetcher` (a fresh iterator
    each call)."""
    return iter(DevicePrefetcher(it, size=size, mesh=mesh,
                                 batch_spec=batch_spec))
