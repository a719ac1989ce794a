"""paddle_tpu_torch.metric (``paddle_tpu/metric/__init__.py``; reference
python/paddle/metric/metrics.py).

The JAX package's metrics, line for line: they read their inputs on the
host as numpy arrays and keep their totals there. ``compute`` results
and ``accuracy`` are CPU Tensors (a metric's bookkeeping does not go
back to the card).
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework.core import Tensor

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _np(x):
    if isinstance(x, Tensor):
        return x.numpy()
    if isinstance(x, torch.Tensor):
        return Tensor(x).numpy()
    return np.asarray(x)


def _host(a) -> Tensor:
    return Tensor(torch.from_numpy(np.ascontiguousarray(a)))


class Metric:
    def __init__(self):
        pass

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None, *args, **kwargs):
        super().__init__()
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def compute(self, pred, label, *args):
        pred_np = _np(pred)
        label_np = _np(label)
        idx = np.argsort(-pred_np, axis=-1)[..., : self.maxk]
        if label_np.ndim == pred_np.ndim and label_np.shape[-1] == 1:
            label_np = label_np[..., 0]
        correct = idx == label_np[..., None]
        return _host(correct.astype(np.float32))

    def update(self, correct, *args):
        c = _np(correct)
        num_samples = c.shape[0]
        accs = []
        for k in self.topk:
            num_corrects = c[..., :k].sum()
            accs.append(float(num_corrects) / num_samples)
            self.total[self.topk.index(k)] += float(num_corrects)
            self.count[self.topk.index(k)] += num_samples
        return accs[0] if len(accs) == 1 else accs

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def accumulate(self):
        res = [t / c if c > 0 else 0.0 for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name="precision", *args, **kwargs):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int32).reshape(-1)
        l = _np(labels).astype(np.int32).reshape(-1)
        self.tp += int(((p == 1) & (l == 1)).sum())
        self.fp += int(((p == 1) & (l == 0)).sum())

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall", *args, **kwargs):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int32).reshape(-1)
        l = _np(labels).astype(np.int32).reshape(-1)
        self.tp += int(((p == 1) & (l == 1)).sum())
        self.fn += int(((p == 0) & (l == 1)).sum())

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name="auc", *args, **kwargs):
        super().__init__()
        self._num_thresholds = num_thresholds
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = _np(preds)
        if p.ndim == 2:
            p = p[:, 1]
        l = _np(labels).reshape(-1)
        bins = np.minimum((p * self._num_thresholds).astype(np.int64), self._num_thresholds - 1)
        for b, lab in zip(bins, l):
            if lab:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def reset(self):
        self._stat_pos = np.zeros(self._num_thresholds, dtype=np.int64)
        self._stat_neg = np.zeros(self._num_thresholds, dtype=np.int64)

    def accumulate(self):
        tot_pos = 0.0
        tot_neg = 0.0
        auc = 0.0
        for i in range(self._num_thresholds - 1, -1, -1):
            pos = float(self._stat_pos[i])
            neg = float(self._stat_neg[i])
            auc += neg * (tot_pos + pos / 2.0)
            tot_pos += pos
            tot_neg += neg
        return auc / (tot_pos * tot_neg) if tot_pos and tot_neg else 0.0

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):  # noqa: A002
    pred_np = _np(input)
    label_np = _np(label)
    idx = np.argsort(-pred_np, axis=-1)[..., :k]
    if label_np.ndim == pred_np.ndim and label_np.shape[-1] == 1:
        label_np = label_np[..., 0]
    corr = (idx == label_np[..., None]).any(axis=-1)
    return _host(np.asarray(corr.mean(), dtype=np.float32))
