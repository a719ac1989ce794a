"""hapi callbacks (``paddle_tpu/hapi/callbacks.py``; reference
python/paddle/hapi/callbacks.py): ``Callback``, ``CallbackList``,
``ProgBarLogger``, ``ModelCheckpoint``, ``EarlyStopping``, the
``LRScheduler`` callback, ``VisualDL`` (scalars to a CSV file, as the
JAX package writes them) and ``config_callbacks``, the JAX package's
own. ``Monitor`` needs the trainer telemetry (``TrainerMonitor``), which
is not ported yet (ROADMAP.md Queue 1 item 9): it raises."""
from __future__ import annotations

import numbers
import os

import numpy as np

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "EarlyStopping",
           "LRScheduler", "VisualDL", "Monitor", "config_callbacks",
           "CallbackList"]


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params or {}

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass

    def on_predict_begin(self, logs=None):
        pass

    def on_predict_end(self, logs=None):
        pass

    def on_predict_batch_begin(self, step, logs=None):
        pass

    def on_predict_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks):
        self.callbacks = list(callbacks)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def __iter__(self):
        return iter(self.callbacks)

    def _call(self, name, *args):
        for c in self.callbacks:
            getattr(c, name)(*args)

    def __getattr__(self, name):
        if name.startswith("on_"):
            return lambda *args: self._call(name, *args)
        raise AttributeError(name)


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = self.params.get("steps")
        if self.verbose:
            print(f"Epoch {epoch + 1}/{self.params.get('epochs', '?')}")

    def on_train_batch_end(self, step, logs=None):
        logs = logs or {}
        if self.verbose and step % self.log_freq == 0:
            msg = f"step {step + 1}" + (f"/{self.steps}" if self.steps else "")
            for k, v in logs.items():
                if isinstance(v, numbers.Number):
                    msg += f" - {k}: {v:.4f}"
                elif isinstance(v, (list, tuple, np.ndarray)):
                    msg += f" - {k}: " + " ".join(f"{float(x):.4f}" for x in np.ravel(v)[:3])
            print(msg)

    def on_eval_end(self, logs=None):
        logs = logs or {}
        if self.verbose:
            msg = "Eval"
            for k, v in logs.items():
                if isinstance(v, numbers.Number):
                    msg += f" - {k}: {v:.4f}"
                elif isinstance(v, (list, tuple, np.ndarray)):
                    msg += f" - {k}: " + " ".join(f"{float(x):.4f}" for x in np.ravel(v)[:3])
            print(msg)


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and epoch % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        self.stopped_epoch = 0
        if mode == "min" or (mode == "auto" and "acc" not in monitor):
            self.monitor_op = np.less
            self.min_delta *= -1
        else:
            self.monitor_op = np.greater
        self.best = None
        self.wait = 0
        self.stop_training = False

    def on_eval_end(self, logs=None):
        logs = logs or {}
        value = logs.get(self.monitor)
        if value is None:
            return
        if isinstance(value, (list, tuple, np.ndarray)):
            value = float(np.ravel(value)[0])
        if self.best is None or self.monitor_op(value - self.min_delta, self.best):
            self.best = value
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stop_training = True
                self.model.stop_training = True


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_learning_rate", None)
        from ..optimizer.lr import LRScheduler as Sched

        return lr if isinstance(lr, Sched) else None

    def on_epoch_end(self, epoch, logs=None):
        if self.by_epoch:
            s = self._sched()
            if s:
                s.step()

    def on_train_batch_end(self, step, logs=None):
        if self.by_step:
            s = self._sched()
            if s:
                s.step()


class Monitor(Callback):
    """Per-step training telemetry (the bridge to
    ``monitor.TrainerMonitor``): puts ``step_time_s``, ``recompiles``
    (captured step graphs made) and ``examples_per_sec`` into each step's
    logs, so ProgBarLogger prints them and VisualDL keeps them.
    ``config_callbacks`` puts Monitor first, so its entries are in the
    logs before the loggers read them."""

    def __init__(self):
        super().__init__()
        from ..monitor import TrainerMonitor

        self.telemetry = TrainerMonitor()

    def on_train_begin(self, logs=None):
        self.telemetry.reset()

    def on_train_batch_begin(self, step, logs=None):
        self.telemetry.step_begin()

    def on_train_batch_end(self, step, logs=None):
        tele = self.telemetry.step_end(
            examples=self.params.get("batch_size"))
        if logs is not None and tele:
            logs["step_time_s"] = tele["step_time_s"]
            logs["recompiles"] = tele["recompiles"]
            if "examples_per_sec" in tele:
                logs["examples_per_sec"] = tele["examples_per_sec"]

    def summary(self):
        return self.telemetry.summary()


class VisualDL(Callback):
    """Scalar logging to a simple CSV (visualdl not in env)."""

    def __init__(self, log_dir):
        super().__init__()
        self.log_dir = log_dir
        self._step = 0

    def on_train_batch_end(self, step, logs=None):
        logs = logs or {}
        os.makedirs(self.log_dir, exist_ok=True)
        with open(os.path.join(self.log_dir, "scalars.csv"), "a") as f:
            for k, v in logs.items():
                if isinstance(v, numbers.Number):
                    f.write(f"{self._step},{k},{v}\n")
        self._step += 1


def config_callbacks(callbacks=None, model=None, batch_size=None, epochs=None,
                     steps=None, log_freq=2, verbose=2, save_freq=1,
                     save_dir=None, metrics=None, mode="train"):
    cbks = callbacks if callbacks is not None else []
    cbks = cbks if isinstance(cbks, (list, tuple)) else [cbks]
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks = [ProgBarLogger(log_freq, verbose=verbose)] + list(cbks)
    if not any(isinstance(c, ModelCheckpoint) for c in cbks):
        cbks = list(cbks) + [ModelCheckpoint(save_freq, save_dir)]
    if not any(isinstance(c, LRScheduler) for c in cbks):
        cbks = list(cbks) + [LRScheduler()]
    # telemetry must run before the loggers that read its log entries
    mons = [c for c in cbks if isinstance(c, Monitor)]
    if mons:
        cbks = mons + [c for c in cbks if not isinstance(c, Monitor)]
    cbk_list = CallbackList(cbks)
    cbk_list.set_model(model)
    params = {
        "batch_size": batch_size, "epochs": epochs, "steps": steps,
        "verbose": verbose, "metrics": metrics or [],
    }
    cbk_list.set_params(params)
    return cbk_list
