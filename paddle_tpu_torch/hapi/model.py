"""hapi.Model — high-level train / eval / predict (``paddle_tpu/hapi/
model.py``; reference python/paddle/hapi/model.py:876, fit :1521,
evaluate :1752, predict :1855).

The dynamic adapter of the JAX package: ``prepare(jit_compile=True)``
(the default) trains through ``jit.TrainStep``, which on the card is one
captured CUDA graph a batch signature; ``jit_compile=False`` steps
eagerly (``loss.backward(); opt.step(); opt.clear_grad()``). With
``FLAGS_fast_step`` (default 1) ``fit`` stages each batch on the card a
step ahead (``io.DevicePrefetcher``) and keeps each step's loss as an
un-read ``AsyncLoss``: it reads one every ``log_freq`` steps and at the
epoch's end.

``fit(resilience=...)`` wraps the step in a ``TrainGuardian``
(``resilience/guardian.py``): a guardian, a dict of its arguments, or
True for its defaults. The step is built with the guardian's sentinel,
so a poisoned step skips its update on the card; ``fit`` resumes from
the guardian's newest checkpoint first, restarts the epoch (a fresh
batch order when shuffling) after a rollback, stops cleanly after a
preemption's priority save, and closes a guardian it made (one passed
in is drained, and stays open).

A Model prepared under ``paddle.enable_static()`` takes the
static-graph adapter: ``Model(net, inputs, labels)``'s InputSpecs build
a program (the network, the loss, ``optimizer.minimize``) that the
steps run through ``static.Executor``.

Not ported yet, and raising: ``accumulate_grad_batches`` above 1 (which the JAX package takes and
ignores; the port refuses it rather than ignore it). The JAX package's
fleet.auto route needs ``distributed.fleet``, which the port does not
have (item 7): ``fit`` always builds the one-card ``TrainStep``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import flags
from ..framework.core import AsyncLoss, Tensor, backward
from ..io import DataLoader, DevicePrefetcher
from ..metric import Metric
from ..monitor.trace import span as _trace_span
from . import callbacks as cbks_mod

__all__ = ["Model"]


def _to_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _on_device(xs):
    """Inputs as Tensors on the current device (a host batch is copied
    there, as the reference's DataLoader places it)."""
    from ..device import current_device

    dev = current_device()
    out = []
    for x in xs:
        if isinstance(x, Tensor):
            if x._data.device != dev:
                x = Tensor(x._data.to(dev, non_blocking=True),
                           stop_gradient=x.stop_gradient, name=x.name)
        elif isinstance(x, (np.ndarray, torch.Tensor)):
            x = Tensor(torch.as_tensor(x).to(dev, non_blocking=True))
        out.append(x)
    return out


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._loss = None
        self._metrics = []
        self._optimizer = None
        self.stop_training = False
        self._train_step = None
        self._use_jit = True
        self._static = None

    # -- configuration -------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None, jit_compile=True):
        from .. import in_dynamic_mode

        self._optimizer = optimizer
        self._loss = loss
        self._metrics = _to_list(metrics)
        for m in self._metrics:
            if not isinstance(m, Metric):
                raise TypeError(f"metrics must be Metric instances, got {m}")
        self._use_jit = jit_compile
        self._train_step = None
        self._static = None
        if not in_dynamic_mode():
            self._prepare_static()

    # -- static-graph adapter (reference hapi/model.py:247) ------------------
    def _prepare_static(self):
        """Prepared under ``paddle.enable_static()``: the network, the loss
        and ``optimizer.minimize`` are recorded into a program from the
        declared ``inputs`` / ``labels`` InputSpecs, which the steps run
        through ``static.Executor`` (a captured CUDA graph a signature on
        the card). The Executor's place is where the network's
        parameters live."""
        from .. import static

        if not self._inputs:
            raise ValueError(
                "hapi.Model in static mode needs input InputSpecs: "
                "Model(net, inputs=[InputSpec(...)], labels=[...]); the "
                "program is built from the declared shapes")

        def as_data(spec, i, prefix):
            name = getattr(spec, "name", None) or f"{prefix}{i}"
            return static.data(name, list(spec.shape),
                               dtype=getattr(spec, "dtype", "float32"))

        main, startup = static.Program(), static.Program()
        with static.program_guard(main, startup):
            ins = [as_data(sp, i, "x") for i, sp in
                   enumerate(_to_list(self._inputs))]
            labels = [as_data(sp, i, "label") for i, sp in
                      enumerate(_to_list(self._labels))]
            outs = self.network(*ins)
            loss_var = None
            if self._loss is not None and labels:
                loss_var = self._loss(outs, *labels)
                if self._optimizer is not None:
                    self._optimizer.minimize(loss_var)
        first = next(iter(self.network.parameters()), None)
        on_cpu = first is not None and first._data.device.type == "cpu"
        self._static = {
            "main": main,
            "eval": main.clone(for_test=True),
            "exe": static.Executor(static.CPUPlace() if on_cpu
                                   else static.CUDAPlace(
                                       first._data.device.index or 0
                                       if first is not None else 0)),
            "in_names": [t.name for t in ins],
            "label_names": [t.name for t in labels],
            "outs": outs,
            "loss": loss_var,
        }

    def _static_feed(self, inputs, labels):
        st = self._static
        feed = dict(zip(st["in_names"], inputs))
        feed.update(zip(st["label_names"], labels))
        return feed

    def _static_outs(self):
        outs = self._static["outs"]
        return list(outs) if isinstance(outs, (list, tuple)) else [outs]

    # -- core steps ----------------------------------------------------------
    def _build_train_step(self, sentinel=None):
        from ..jit import TrainStep

        loss_layer = self._loss

        def loss_fn(run_model, *batch):
            # convention: the last element is the label
            *ins, label = batch
            return loss_layer(run_model(*ins), label)

        return TrainStep(self.network, loss_fn, self._optimizer,
                         sentinel=sentinel)

    def train_batch(self, inputs, labels=None, update=True, sync=True):
        """One training step. ``sync=False`` (fit's fast path) returns the
        loss as an un-read AsyncLoss instead of a float."""
        with _trace_span("Model.train_batch", cat="step"):
            return self._train_batch_impl(inputs, labels, update, sync)

    def _train_batch_impl(self, inputs, labels=None, update=True, sync=True):
        self.network.train()
        if self._static is not None:
            st = self._static
            (loss,) = st["exe"].run(
                st["main"] if update else st["eval"],
                feed=self._static_feed(_to_list(inputs), _to_list(labels)),
                fetch_list=[st["loss"]])
            return [float(loss)]
        inputs = _on_device(_to_list(inputs))
        labels = _on_device(_to_list(labels))
        if self._use_jit and update and len(labels) == 1:
            if self._train_step is None:
                self._train_step = self._build_train_step()
            loss = self._train_step(*inputs, labels[0])
            if not sync and isinstance(loss, AsyncLoss):
                return [loss]
            return [float(loss)]
        outputs = self.network(*inputs)
        loss = self._loss(outputs, *labels)
        backward(loss)
        if update:
            self._optimizer.step()
            self._optimizer.clear_grad()
        return [float(loss)]

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        if self._static is not None:
            return self._static_eval(_to_list(inputs), _to_list(labels))
        inputs = _on_device(_to_list(inputs))
        labels = _on_device(_to_list(labels))
        outputs = self.network(*inputs)
        metrics = []
        if self._loss is not None and labels:
            metrics.append(float(self._loss(outputs, *labels)))
        for metric in self._metrics:
            metric.update(metric.compute(outputs, *labels))
        return metrics

    def _static_eval(self, inputs, labels):
        st = self._static
        has_loss = st["loss"] is not None and bool(labels)
        fetch = ([st["loss"]] if has_loss else []) + self._static_outs()
        vals = st["exe"].run(st["eval"],
                             feed=self._static_feed(inputs, labels),
                             fetch_list=fetch, return_numpy=False)
        metrics = [float(vals[0])] if has_loss else []
        outs = vals[1:] if has_loss else vals
        outs = outs[0] if len(outs) == 1 else outs
        labels = _on_device(labels)
        for metric in self._metrics:
            metric.update(metric.compute(outs, *labels))
        return metrics

    @torch.no_grad()
    def predict_batch(self, inputs):
        self.network.eval()
        if self._static is not None:
            st = self._static
            return st["exe"].run(st["eval"],
                                 feed=self._static_feed(_to_list(inputs), []),
                                 fetch_list=self._static_outs())
        out = self.network(*_on_device(_to_list(inputs)))
        if isinstance(out, (list, tuple)):
            return [o.numpy() for o in out]
        return [out.numpy()]

    # -- loops ---------------------------------------------------------------
    def _make_loader(self, data, batch_size, shuffle):
        if data is None or isinstance(data, DataLoader):
            return data
        return DataLoader(data, batch_size=batch_size, shuffle=shuffle)

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None, resilience=None):
        if accumulate_grad_batches != 1:
            raise NotImplementedError(
                "Model.fit(accumulate_grad_batches > 1) is not ported to "
                "paddle_tpu_torch (the JAX package takes it and ignores it)")
        train_loader = self._make_loader(train_data, batch_size, shuffle)
        eval_loader = self._make_loader(eval_data, batch_size, False)
        steps = None
        try:
            steps = len(train_loader)
        except TypeError:
            pass
        cbks = cbks_mod.config_callbacks(
            callbacks, model=self, batch_size=batch_size, epochs=epochs,
            steps=steps, log_freq=log_freq, verbose=verbose,
            save_freq=save_freq, save_dir=save_dir,
            metrics=["loss"] + [n for m in self._metrics
                                for n in _to_list(m.name())])
        self.stop_training = False
        guardian, guardian_owned = None, False
        if resilience is not None and resilience is not False \
                and self._use_jit and self._static is None:
            from ..resilience.guardian import TrainGuardian

            if isinstance(resilience, TrainGuardian):
                guardian = resilience
            else:
                kwargs = {} if resilience is True else dict(resilience)
                guardian = TrainGuardian(**kwargs)
                guardian_owned = True     # fit made it: fit closes it
            if self._train_step is None:
                self._train_step = self._build_train_step(
                    sentinel=guardian.sentinel_config)
            if guardian.step is None:
                guardian.attach(self._train_step)
            guardian.install_preemption_handler()
            guardian.restore_latest()
        cbks.on_train_begin({})
        fast = flags.fast_step[0] and self._static is None
        loss_val = None
        logs = {}
        epoch = 0
        while epoch < epochs:
            cbks.on_epoch_begin(epoch, {})
            epoch_iter = (DevicePrefetcher(train_loader, size=2) if fast
                          else train_loader)
            pending = None
            restart_epoch = False
            for step, batch in enumerate(epoch_iter):
                cbks.on_train_batch_begin(step, {})
                *ins, label = (batch if isinstance(batch, (list, tuple))
                               else (batch,))
                raw = self.train_batch(ins, [label], sync=not fast)[0]
                if isinstance(raw, Tensor):
                    pending = raw
                    if step % log_freq == 0 or (
                            num_iters is not None and step + 1 >= num_iters):
                        loss_val = float(raw)
                else:
                    loss_val = raw
                logs = {"loss": loss_val}
                cbks.on_train_batch_end(step, logs)
                if guardian is not None:
                    action = guardian.after_step(
                        self._train_step._step_count - 1, raw)
                    if action == "rollback":
                        # state rewound to the snapshot: replay the epoch
                        # with a fresh batch order
                        pending = None
                        restart_epoch = True
                        break
                    if action == "preempt":
                        self.stop_training = True
                        break
                if num_iters is not None and step + 1 >= num_iters:
                    break
            if restart_epoch:
                continue
            if pending is not None:  # the epoch's end logs the real value
                loss_val = float(pending)
                logs = {"loss": loss_val}
            self._sync_train_step()
            cbks.on_epoch_end(epoch, logs if steps else {})
            if eval_loader is not None and (epoch + 1) % eval_freq == 0 \
                    and not self.stop_training:
                self.evaluate(eval_loader, batch_size=batch_size,
                              verbose=verbose, callbacks=cbks)
            if self.stop_training:
                break
            epoch += 1
        self._sync_train_step()
        if guardian is not None:
            # the snapshot thread must not outlive the fit that started
            # it; a guardian passed in stays open (its loop may go on)
            if guardian_owned:
                guardian.close()
            else:
                guardian.drain_snapshots()
        cbks.on_train_end({})

    def _sync_train_step(self):
        if self._train_step is not None:
            self._train_step.sync()

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_iters=None):
        loader = self._make_loader(eval_data, batch_size, False)
        for m in self._metrics:
            m.reset()
        if isinstance(callbacks, cbks_mod.CallbackList):
            cbks = callbacks
        else:
            cbks = cbks_mod.config_callbacks(callbacks, model=self,
                                             verbose=verbose, mode="eval")
        cbks.on_eval_begin({})
        losses = []
        for step, batch in enumerate(loader):
            *ins, label = (batch if isinstance(batch, (list, tuple))
                           else (batch,))
            m = self.eval_batch(ins, [label])
            if m:
                losses.append(m[0])
            if num_iters is not None and step + 1 >= num_iters:
                break
        logs = {}
        if losses:
            logs["loss"] = float(np.mean(losses))
        for metric in self._metrics:
            for n, v in zip(_to_list(metric.name()),
                            _to_list(metric.accumulate())):
                logs[n] = v
        cbks.on_eval_end(logs)
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        loader = self._make_loader(test_data, batch_size, False)
        outputs = []
        for batch in loader:
            ins = list(batch) if isinstance(batch, (list, tuple)) else [batch]
            # an explicit inputs spec wins; otherwise a loss-prepared model
            # treats the trailing element of an (x, ..., y) item as the label
            if self._inputs is not None:
                ins = ins[:len(_to_list(self._inputs))]
            elif self._loss is not None and len(ins) > 1:
                ins = ins[:-1]
            outputs.append(self.predict_batch(ins))
        if stack_outputs:
            return [np.concatenate([o[i] for o in outputs])
                    for i in range(len(outputs[0]))]
        return outputs

    # -- persistence ---------------------------------------------------------
    def save(self, path, training=True):
        from ..framework.io import save

        self._sync_train_step()
        save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        import os

        from ..framework.io import load

        self.network.set_state_dict(load(path + ".pdparams"))
        if (not reset_optimizer and self._optimizer is not None
                and os.path.exists(path + ".pdopt")):
            self._optimizer.set_state_dict(load(path + ".pdopt"))

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype=None):
        from .summary import summary

        return summary(self.network, input_size, dtype)
