"""paddle_tpu_torch.io — Dataset / DataLoader (``paddle_tpu/io/
__init__.py``; reference python/paddle/io, fluid/reader.py:146
DataLoader, fluid/dataloader/*).

The datasets, samplers and ``default_collate_fn`` are the JAX package's,
line for line: the samplers draw from ``np.random``, so a seeded order
equals JAX's. ``default_collate_fn`` stacks Tensor samples where they
lie and numpy or Python samples into Tensors on the current device.

``DataLoader`` runs in the caller's thread with ``num_workers=0``, and
behind a prefetch thread (the JAX ``_iter_threaded``: the reference's
BufferedReader) wherever the JAX package would not fork workers: a
custom ``collate_fn``, an ``IterableDataset`` or a dataset that holds
Tensors. Where it would (``_iter_multiprocess``: worker processes, the
shared-memory ring ``shm_ring.py`` and the native blocking queue of
``core/csrc/ptpu_core.cc``), the port raises: that transport is not
ported yet (ROADMAP.md Queue 1 item 12). ``DevicePrefetcher``
(``io/prefetch.py``) stages batches on the card a step ahead.
"""
from __future__ import annotations

import itertools
import queue
import threading
from typing import List, Optional

import numpy as np
import torch

from ..framework.core import Tensor

__all__ = [
    "Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
    "ChainDataset", "Subset", "random_split", "Sampler", "SequenceSampler",
    "RandomSampler", "WeightedRandomSampler", "BatchSampler",
    "DistributedBatchSampler", "DataLoader", "get_worker_info",
    "default_collate_fn", "DevicePrefetcher", "prefetch_to_device",
]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    # holds Tensors: the JAX package keeps such a dataset off forked
    # workers and runs the threaded path; so does the port
    _holds_device_arrays = True

    def __init__(self, tensors):
        lengths = {t.shape[0] for t in tensors}
        assert len(lengths) == 1, "tensors must share dim 0"
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            out.extend(item if isinstance(item, (tuple, list)) else [item])
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = indices

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    total = sum(lengths)
    assert total == len(dataset)
    perm = np.random.permutation(total)
    out, offset = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[offset:offset + n].tolist()))
        offset += n
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None, generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator

    @property
    def num_samples(self):
        return self._num_samples if self._num_samples is not None else len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            yield from np.random.randint(0, n, size=self.num_samples).tolist()
        else:
            yield from np.random.permutation(n)[: self.num_samples].tolist()

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(self.weights), size=self.num_samples,
                               replace=self.replacement, p=p)
        yield from idx.tolist()

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False, batch_size=1,
                 drop_last=False):
        assert (dataset is None) != (sampler is None), "provide dataset xor sampler"
        if sampler is None:
            sampler = RandomSampler(dataset) if shuffle else SequenceSampler(dataset)
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Rank-sharded batch sampler (reference python/paddle/io/..
    DistributedBatchSampler / fluid/dataloader/batch_sampler.py:161).
    """

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        dist = torch.distributed
        up = dist.is_available() and dist.is_initialized()
        self.dataset = dataset
        self.batch_size = batch_size
        self.nranks = (num_replicas if num_replicas is not None
                       else dist.get_world_size() if up else 1)
        self.local_rank = (rank if rank is not None
                           else dist.get_rank() if up else 0)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = int(np.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            rng.shuffle(indices)
            self.epoch += 1
        indices = np.concatenate([indices, indices[: self.total_size - n]])
        indices = indices[self.local_rank::self.nranks]
        batch = []
        for idx in indices.tolist():
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch


class _WorkerInfo:
    def __init__(self, id=0, num_workers=0, dataset=None):  # noqa: A002
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset


_worker_info: List[Optional[_WorkerInfo]] = [None]


def get_worker_info():
    return _worker_info[0]


def default_collate_fn(batch):
    """Stack samples into batched Tensors (reference
    fluid/dataloader/collate.py default_collate_fn)."""
    sample = batch[0]
    if isinstance(sample, Tensor):
        return Tensor(torch.stack([b._data for b in batch]))
    if isinstance(sample, np.ndarray):
        return Tensor(np.stack(batch))
    if isinstance(sample, (int, np.integer)):
        return Tensor(np.asarray(batch, dtype=np.int64))
    if isinstance(sample, (float, np.floating)):
        return Tensor(np.asarray(batch, dtype=np.float32))
    if isinstance(sample, (list, tuple)):
        return tuple(default_collate_fn(list(items)) for items in zip(*batch))
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    return batch


def _dataset_holds_tensors(ds, depth=0) -> bool:
    """Tensors reachable behind dataset wrappers (Subset, ComposeDataset,
    ChainDataset or anything exposing .dataset(s)): the JAX package's
    ``_dataset_holds_device_arrays``."""
    if depth > 8:
        return True
    if getattr(ds, "_holds_device_arrays", False):
        return True
    for attr in ("dataset", "datasets"):
        inner = getattr(ds, attr, None)
        if inner is None:
            continue
        inners = inner if isinstance(inner, (list, tuple)) else [inner]
        if any(_dataset_holds_tensors(d, depth + 1) for d in inners):
            return True
    return False


class DataLoader:
    """Batches from a dataset: in the caller's thread (``num_workers=0``)
    or behind a prefetch thread; worker processes are not ported (see
    the module's docstring)."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = max(2, prefetch_factor)
        self.use_shared_memory = use_shared_memory
        self.worker_init_fn = worker_init_fn
        self._iterable_ds = isinstance(dataset, IterableDataset)
        if self._iterable_ds:
            self.batch_size = batch_size
            self.batch_sampler = None
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = None
        elif batch_size is None:
            self.batch_sampler = None
            self.batch_size = None
        else:
            self.batch_sampler = BatchSampler(
                dataset=dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)
            self.batch_size = batch_size

    def __len__(self):
        if self._iterable_ds:
            raise TypeError("IterableDataset has no length")
        if self.batch_sampler is None:
            return len(self.dataset)
        return len(self.batch_sampler)

    def _gen_batches(self):
        if self._iterable_ds:
            it = iter(self.dataset)
            while True:
                batch = list(itertools.islice(it, self.batch_size))
                if not batch:
                    return
                yield self.collate_fn(batch)
        elif self.batch_sampler is None:
            for i in range(len(self.dataset)):
                yield self.dataset[i]
        else:
            for idxs in self.batch_sampler:
                yield self.collate_fn([self.dataset[i] for i in idxs])

    def __iter__(self):
        if self.num_workers == 0:
            yield from self._gen_batches()
            return
        if (not self._iterable_ds and self.batch_sampler is not None
                and self.collate_fn is default_collate_fn
                and not _dataset_holds_tensors(self.dataset)):
            raise NotImplementedError(
                "DataLoader(num_workers > 0) over a numpy dataset runs "
                "worker processes with the shared-memory ring and the "
                "native blocking queue in the JAX package; that transport "
                "is not ported to paddle_tpu_torch yet (ROADMAP.md Queue 1 "
                "item 12). Use num_workers=0")
        yield from self._iter_threaded()

    def _iter_threaded(self):
        # buffered prefetch on a thread (the BufferedReader analog)
        q: queue.Queue = queue.Queue(
            maxsize=self.prefetch_factor * max(1, self.num_workers))
        sentinel = object()
        err: list = []

        def producer():
            try:
                for item in self._gen_batches():
                    q.put(item)
            except BaseException as e:  # noqa: BLE001
                err.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
        t.join()
        if err:
            raise err[0]


from .prefetch import DevicePrefetcher, prefetch_to_device  # noqa: E402
