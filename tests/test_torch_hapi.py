"""The port's ``io``, ``metric``, loss layers and ``paddle.Model``
against paddle_tpu's, on the CPU.

- ``DataLoader`` batches (map-style, ``batch_size=None``, an
  ``IterableDataset``, a custom collate behind the prefetch thread) and
  a shuffled order under one ``np.random`` seed equal to JAX's; the
  samplers (sequence, random, weighted, batch, distributed at world size
  1 and as rank 1 of 2); collate of tuples and dicts; ``random_split``;
- ``Accuracy`` (top-1 and top-2), ``Precision``, ``Recall``, ``Auc`` and
  ``accuracy`` on seeded data: exactly JAX's (both compute in numpy);
- the eight loss layers on seeded inputs: 1e-6 relative;
- ``Model.fit`` for 2 epochs on 64 samples at batch 16 (``TrainStep``,
  Adam, a ``StepDecay`` stepped by the ``LRScheduler`` callback,
  ``log_freq=1`` so every loss is read): each batch's loss within 1e-5
  of JAX's, then ``evaluate`` (loss and accuracy 1e-5), ``predict``,
  ``ModelCheckpoint``'s files, ``EarlyStopping``, the ``save`` /
  ``load`` round trip (predictions bit-equal), a ``.pdparams`` the JAX
  package wrote loading into the port's ``Model``, and ``summary``'s
  parameter count;
- ``DevicePrefetcher`` on the CPU keeps the batches and their order;
- the parts not ported raise ``NotImplementedError`` naming their item.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu_torch import device as tdevice

TOL = 1e-5


@pytest.fixture(autouse=True)
def on_cpu():
    old = tdevice._current[0]
    paddle_tpu_torch.set_device("cpu")
    yield
    tdevice._current[0] = old


def _arr(x):
    if isinstance(x, (list, tuple)):
        return [_arr(v) for v in x]
    if isinstance(x, dict):
        return {k: _arr(v) for k, v in x.items()}
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def _same(a, b):
    if isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    else:
        np.testing.assert_array_equal(a, b)


class _Pairs:
    """A map-style dataset of (image, label) numpy pairs (both packages
    take any object with __getitem__ / __len__)."""

    def __init__(self, n, seed=0):
        rng = np.random.default_rng(seed)
        self.x = rng.normal(size=(n, 1, 28, 28)).astype("float32")
        self.y = rng.integers(0, 10, (n,)).astype("int64")

    def __getitem__(self, i):
        return self.x[i], self.y[i]

    def __len__(self):
        return len(self.y)


def _loaders(P, ds):
    io = P.io

    class Stream(io.IterableDataset):
        def __iter__(self):
            for i in range(10):
                yield {"a": np.float32(i), "b": np.arange(i, i + 2)}

    np.random.seed(7)
    shuffled = [b for b in io.DataLoader(ds, batch_size=8, shuffle=True)]
    return {
        "plain": list(io.DataLoader(ds, batch_size=16, drop_last=False)),
        "drop_last": list(io.DataLoader(ds, batch_size=16, drop_last=True)),
        "no_batch": list(io.DataLoader(ds, batch_size=None))[:3],
        "shuffled": shuffled,
        "iterable": list(io.DataLoader(Stream(), batch_size=4)),
        "custom_collate_thread": list(io.DataLoader(
            ds, batch_size=10, num_workers=2,
            collate_fn=lambda items: [np.stack([x for x, _ in items])])),
    }


def test_dataloader_batches_and_shuffle_equal_jax():
    ds = _Pairs(37)
    want, got = _loaders(paddle_tpu, ds), _loaders(paddle_tpu_torch, ds)
    for k in want:
        _same(_arr(want[k]), _arr(got[k]))


def test_samplers_and_collate_equal_jax():
    ds = _Pairs(23)

    def run(P):
        io = P.io
        np.random.seed(3)
        out = {
            "seq": list(io.SequenceSampler(ds)),
            "rand": list(io.RandomSampler(ds)),
            "rand_repl": list(io.RandomSampler(ds, replacement=True,
                                               num_samples=9)),
            "weighted": list(io.WeightedRandomSampler(
                np.arange(1, 24, dtype=float), 12)),
            "batch": list(io.BatchSampler(dataset=ds, batch_size=5,
                                          shuffle=True)),
            "batch_len": len(io.BatchSampler(dataset=ds, batch_size=5)),
            "dist": list(io.DistributedBatchSampler(ds, 4, shuffle=True)),
            "dist_rank1": list(io.DistributedBatchSampler(
                ds, 4, num_replicas=2, rank=1, drop_last=True)),
            "split": [list(s.indices) for s in io.random_split(ds,
                                                               [10, 13])],
            "collate": _arr(io.default_collate_fn(
                [(np.ones(2, "float32") * i, i, {"k": float(i)})
                 for i in range(3)])),
            "tensor_ds": _arr(io.TensorDataset(
                [P.to_tensor(ds.x[:4]), P.to_tensor(ds.y[:4])])[2]),
            "compose": _arr(io.ComposeDataset([ds, ds])[1]),
            "chain": _arr([v for v in iter(io.ChainDataset([[1, 2], [3]]))]),
            "subset": _arr(io.Subset(ds, [3, 1])[1]),
        }
        assert io.get_worker_info() is None
        return out

    want, got = run(paddle_tpu), run(paddle_tpu_torch)
    for k in want:
        _same(_arr(want[k]), _arr(got[k]))


def test_metrics_equal_jax():
    rng = np.random.default_rng(9)
    logits = rng.normal(size=(50, 6)).astype("float32")
    labels = rng.integers(0, 6, (50, 1)).astype("int64")
    probs = rng.uniform(size=(50, 1)).astype("float32")
    binary = rng.integers(0, 2, (50, 1)).astype("int64")

    def run(P):
        m = P.metric
        acc = m.Accuracy(topk=(1, 2))
        for i in range(0, 50, 20):
            acc.update(acc.compute(P.to_tensor(logits[i:i + 20]),
                                   P.to_tensor(labels[i:i + 20])))
        pre, rec, auc = m.Precision(), m.Recall(), m.Auc()
        for met in (pre, rec):
            met.update(probs, binary)
        auc.update(np.concatenate([1 - probs, probs], 1), binary)
        return [acc.accumulate(), acc.name(), pre.accumulate(),
                rec.accumulate(), auc.accumulate(),
                float(m.accuracy(P.to_tensor(logits), P.to_tensor(labels),
                                 k=2).numpy().ravel()[0])]

    want, got = run(paddle_tpu), run(paddle_tpu_torch)
    assert got == want


@pytest.mark.parametrize("name,make,kind", [
    ("ce", lambda nn: nn.CrossEntropyLoss(), "logits"),
    ("ce_sum_ignore", lambda nn: nn.CrossEntropyLoss(
        ignore_index=2, reduction="sum"), "logits"),
    ("mse", lambda nn: nn.MSELoss(), "pair"),
    ("l1_sum", lambda nn: nn.L1Loss("sum"), "pair"),
    ("nll", lambda nn: nn.NLLLoss(), "logp"),
    ("bce", lambda nn: nn.BCELoss(), "prob"),
    ("bce_logits", lambda nn: nn.BCEWithLogitsLoss(), "binary"),
    ("smooth_l1", lambda nn: nn.SmoothL1Loss(delta=0.5), "pair"),
    ("kldiv", lambda nn: nn.KLDivLoss("batchmean"), "kl"),
])
def test_loss_layers_equal_jax(name, make, kind):
    rng = np.random.default_rng(13)
    x = rng.normal(size=(12, 5)).astype("float32")
    lab = rng.integers(0, 5, (12,)).astype("int64")
    y = rng.normal(size=(12, 5)).astype("float32")
    p = rng.uniform(0.05, 0.95, size=(12, 5)).astype("float32")
    t = rng.integers(0, 2, (12, 5)).astype("float32")
    inputs = {"logits": (x, lab), "pair": (x, y),
              "logp": (x - np.log(np.exp(x).sum(1, keepdims=True)), lab),
              "prob": (p, t), "binary": (x, t),
              "kl": (np.log(p), p / p.sum(1, keepdims=True))}[kind]

    def run(P):
        a, b = (P.to_tensor(v) for v in inputs)
        a.stop_gradient = False
        loss = make(P.nn)(a, b)
        loss.backward()
        return loss.numpy(), a.grad.numpy()

    (lw, gw), (lt, gt) = run(paddle_tpu), run(paddle_tpu_torch)
    np.testing.assert_allclose(lt, lw, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(gt, gw, rtol=1e-5, atol=1e-7)


# -- paddle.Model -----------------------------------------------------------------

class _Record:
    """Collects every batch's logged loss and the eval logs."""

    def __init__(self, P):
        self.cb = type("Rec", (P.callbacks.Callback,), {
            "on_train_batch_end": lambda s, step, logs=None:
                self.losses.append(logs["loss"]),
            "on_eval_end": lambda s, logs=None: self.evals.append(logs)})()
        self.losses, self.evals = [], []


def _fit(P, tmp, ds, eval_ds):
    P.seed(0) if P is paddle_tpu else None
    net = P.vision.models.LeNet()
    if P is paddle_tpu_torch:
        net.set_state_dict(_fit.jax_state)
    else:
        _fit.jax_state = {k: np.asarray(v.numpy())
                          for k, v in net.state_dict().items()}
    sched = P.optimizer.lr.StepDecay(2e-3, 2, 0.5)
    model = P.Model(net)
    model.prepare(P.optimizer.Adam(sched, parameters=net.parameters()),
                  P.nn.CrossEntropyLoss(), P.metric.Accuracy())
    rec = _Record(P)
    np.random.seed(11)
    model.fit(ds, eval_ds, batch_size=16, epochs=2, log_freq=1, verbose=0,
              save_dir=os.path.join(tmp, P.__name__), callbacks=[rec.cb])
    logs = model.evaluate(eval_ds, batch_size=16, verbose=0)
    preds = model.predict(eval_ds, batch_size=16, stack_outputs=True)
    return model, rec, logs, preds, sched


def test_model_fit_evaluate_predict_equal_jax(tmp_path):
    ds, eval_ds = _Pairs(64, seed=1), _Pairs(32, seed=2)
    jm, jrec, jlogs, jpred, _ = _fit(paddle_tpu, str(tmp_path), ds, eval_ds)
    tm, trec, tlogs, tpred, tsched = _fit(paddle_tpu_torch, str(tmp_path),
                                          ds, eval_ds)
    assert len(trec.losses) == 8
    np.testing.assert_allclose(trec.losses, jrec.losses, rtol=TOL)
    assert tm._train_step.captures == 0 and tm._train_step._step_count == 8
    assert tsched.last_epoch == 8           # the LRScheduler callback
    assert len(trec.evals) == 2             # each epoch's eval
    for w, g in zip(jrec.evals + [jlogs], trec.evals + [tlogs]):
        assert w.keys() == g.keys()
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=TOL)
    np.testing.assert_allclose(tpred[0], jpred[0], rtol=1e-4, atol=1e-5)
    saved = sorted(os.listdir(tmp_path / "paddle_tpu_torch"))
    assert saved == ["0.pdopt", "0.pdparams", "1.pdopt", "1.pdparams",
                     "final.pdopt", "final.pdparams"]
    # save -> load into a fresh Model: predictions bit-equal
    path = str(tmp_path / "m")
    tm.save(path)
    fresh = paddle_tpu_torch.Model(paddle_tpu_torch.vision.models.LeNet())
    fresh.prepare(paddle_tpu_torch.optimizer.Adam(
        1e-3, parameters=fresh.parameters()),
        paddle_tpu_torch.nn.CrossEntropyLoss())
    fresh.load(path)
    again = fresh.predict(eval_ds, batch_size=16, stack_outputs=True)
    np.testing.assert_array_equal(again[0], tpred[0])
    # the optimizer's file holds its state under the parameters' names
    # (a fresh LeNet's names differ: Paddle numbers layers per process)
    sd, back = tm._optimizer.state_dict(), paddle_tpu_torch.load(
        path + ".pdopt")
    assert back.keys() == sd.keys()
    for k in sd:
        if k == "LR_Scheduler":
            assert back[k] == sd[k]
        else:
            assert torch.equal(back[k]._data, sd[k]._data), k
    # a checkpoint the JAX package wrote loads into the port's Model
    jpath = str(tmp_path / "paddle_tpu" / "final")
    cross = paddle_tpu_torch.Model(paddle_tpu_torch.vision.models.LeNet())
    cross.prepare(paddle_tpu_torch.optimizer.Adam(
        1e-3, parameters=cross.parameters()),
        paddle_tpu_torch.nn.CrossEntropyLoss())
    cross.load(jpath)
    got = cross.predict(eval_ds, batch_size=16, stack_outputs=True)
    np.testing.assert_allclose(got[0], jpred[0], rtol=1e-4, atol=1e-5)
    jopt = paddle_tpu.load(jpath + ".pdopt")
    topt = paddle_tpu_torch.load(jpath + ".pdopt")
    assert jopt.keys() == topt.keys()
    for k in jopt:
        if k != "LR_Scheduler":
            np.testing.assert_array_equal(topt[k].numpy(), jopt[k].numpy())
    assert tm.summary()["total_params"] == paddle_tpu.summary(
        jm.network)["total_params"] == 61610


def test_early_stopping_and_eager_fit_equal_jax():
    ds = _Pairs(32, seed=3)

    def run(P):
        if P is paddle_tpu:
            P.seed(4)
        net = P.vision.models.LeNet()
        if P is paddle_tpu:
            run.state = {k: np.asarray(v.numpy())
                         for k, v in net.state_dict().items()}
        else:
            net.set_state_dict(run.state)
        model = P.Model(net)
        model.prepare(P.optimizer.SGD(0.5, parameters=net.parameters()),
                      P.nn.CrossEntropyLoss(), jit_compile=False)
        stop = P.callbacks.EarlyStopping("loss", patience=0)
        np.random.seed(5)
        model.fit(ds, ds, batch_size=16, epochs=6, verbose=0,
                  callbacks=[stop])
        return stop.best, stop.wait, model.stop_training

    want, got = run(paddle_tpu), run(paddle_tpu_torch)
    assert got[1:] == want[1:]
    np.testing.assert_allclose(got[0], want[0], rtol=TOL)


def test_device_prefetcher_on_the_cpu_keeps_order():
    P = paddle_tpu_torch
    batches = [(P.to_tensor(np.full((2, 2), i, "float32")), np.arange(i))
               for i in range(7)]
    got = list(P.io.DevicePrefetcher(batches, size=2))
    assert len(got) == 7
    for i, (x, y) in enumerate(got):
        assert float(x._data[0, 0]) == i and len(y) == i


def test_unported_parts_raise():
    P = paddle_tpu_torch
    ds = _Pairs(8)
    with pytest.raises(NotImplementedError, match="item 12"):
        list(P.io.DataLoader(ds, batch_size=4, num_workers=2))
    with pytest.raises(NotImplementedError, match="item 9"):
        P.callbacks.Monitor()
    with pytest.raises(NotImplementedError, match="item 7"):
        P.io.DevicePrefetcher([], mesh=object())
    model = P.Model(P.nn.Linear(2, 2))
    model.prepare(P.optimizer.SGD(0.1, parameters=model.parameters()),
                  P.nn.MSELoss())
    with pytest.raises(NotImplementedError, match="item 9"):
        model.fit(ds, resilience=True, verbose=0)
