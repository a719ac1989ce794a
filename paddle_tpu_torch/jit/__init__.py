"""paddle_tpu_torch.jit — ``paddle_tpu/jit/__init__.py``'s eager-to-
compiled bridge, on the card.

``TrainStep(model, loss_fn, optimizer)`` is the JAX package's one XLA
program per batch shape: forward, backward, ``grad_postprocess``, the
optimizer's ``grad_clip``, the update of every parameter and slot and
the buffers' updates (batch-norm statistics). On the card the port
captures that step into one ``torch.cuda.CUDAGraph`` and replays it:

- the first call for a batch signature (its leaves' shapes and dtypes,
  the counterpart of a recompile) runs the step eagerly on a side
  stream (cuDNN settles its algorithms, slots and kernel builds come to
  exist, lazy state is made) and then captures it; later calls copy the
  batch into the graph's static inputs, write the learning rate
  (× ``scale_lr``) into a device scalar and replay. ``captures`` counts
  the graphs made;
- gradients come from ``torch.autograd.grad`` into graph memory, never
  from ``.grad`` accumulation; parameters, slots and buffers are
  updated in place, so the eager model and the optimizer see the step's
  state without a copy back;
- with ``FLAGS_fast_step`` (default 1) a call returns an
  :class:`~paddle_tpu_torch.framework.core.AsyncLoss` and does not
  block; without it a Tensor. Either way the loss is the step's own
  copy: the next replay does not overwrite it;
- a step that cannot be captured (a host read such as ``Tensor.item``,
  ``numpy()``, ``float()`` or ``bool()`` in the model or loss, a
  data-dependent shape, an RNG generator the graph cannot register)
  raises with the reason: the step never falls back to the uncaptured
  one;
- hand-written kernels the step launches count their launches as they
  are captured; the capture launches nothing, so the step takes those
  counts back after the capture and adds them at every replay, which is
  where the kernels run.

On the CPU, or with ``capture=False``, the same step runs uncaptured at
every call. ``steps(k,
*batch)`` runs k steps on one batch with no host read between them (the
reference's "K steps inside one jit").

The optimizer's ``grad_clip`` is applied inside the step, as Paddle
does in both modes; the JAX ``TrainStep`` applies only
``grad_postprocess`` (``paddle_tpu/jit/__init__.py:298``), and its eager
``Optimizer.step`` applies the clip. So do the parameter's L2
regularizer and lr multiplier, as in the port's eager step. ``use_fused``
follows JAX's rule: Adam or AdamW with the four standard slots under
``FLAGS_fused_optimizer=1`` runs ``ops/fused_optimizer.py``'s
``fused_update_from_slots`` (row 7's kernel, one launch per bucket, leaf
tables made once per graph); any other optimizer runs its per-parameter
``_update``, the counterpart of ``_pure_update``.

``to_static`` / ``StaticFunction``: PyTorch runs Python control flow as
it is, so the JAX package's ``dy2static`` AST conversion has no
counterpart here: a ``StaticFunction`` runs the layer's forward (or the
function) eagerly, and ``ProgramTranslator().enable(False)`` runs the
original, as in JAX. ``save`` / ``load`` / ``TracedLayer`` /
``TranslatedLayer`` need ``static/export`` and ``inference``, which are
not ported (ROADMAP.md Queue 1 item 11): they raise.
"""
from __future__ import annotations

import functools
import importlib
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..core import flags
from ..framework.core import AsyncLoss, Tensor
from ..nn.layer.layers import Layer

__all__ = ["to_static", "TrainStep", "not_to_static", "ProgramTranslator",
           "StaticFunction", "TracedLayer", "TranslatedLayer", "InputSpec",
           "save", "load"]


class InputSpec:
    """paddle.static.InputSpec parity."""

    def __init__(self, shape, dtype="float32", name=None):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.name = name

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, dtype={self.dtype}, "
                f"name={self.name})")


# -- to_static ------------------------------------------------------------------

class ProgramTranslator:
    """Singleton switch (reference dygraph_to_static/program_translator.py:
    768): ``enable(False)`` makes to_static functions run their
    original."""

    _instance = None
    _enabled = True

    @classmethod
    def get_instance(cls):
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def enable(self, enable_to_static=True):
        type(self)._enabled = bool(enable_to_static)

    @property
    def enable_to_static(self):
        return type(self)._enabled


class StaticFunction:
    """Result of ``to_static``: calls the layer's forward (or the
    function) eagerly; PyTorch runs its Python control flow as written,
    so there is nothing to convert. ``ProgramTranslator().enable(False)``
    calls the original, as in JAX."""

    def __init__(self, fn_or_layer, input_spec=None, build_strategy=None):
        self._input_spec = input_spec
        if isinstance(fn_or_layer, Layer):
            self._layer, self._fn = fn_or_layer, None
            self._orig_call = fn_or_layer.forward
        else:
            self._layer, self._fn = None, fn_or_layer
            self._orig_call = fn_or_layer

    def __call__(self, *args, **kwargs):
        if not ProgramTranslator._enabled:
            return self._orig_call(*args, **kwargs)
        if self._layer is not None:
            return self._layer(*args, **kwargs)
        return self._fn(*args, **kwargs)

    def __getattr__(self, item):
        if item.startswith("_"):
            raise AttributeError(item)
        target = self._layer if self._layer is not None else self._fn
        return getattr(target, item)


def to_static(function=None, input_spec=None, build_strategy=None, **kwargs):
    """paddle.jit.to_static parity (decorator or call)."""
    if function is None:
        return functools.partial(to_static, input_spec=input_spec,
                                 build_strategy=build_strategy)
    return StaticFunction(function, input_spec, build_strategy)


def not_to_static(fn):
    return fn


def _needs_export(what):
    raise NotImplementedError(
        f"paddle_tpu_torch.jit.{what} needs static/export and inference, "
        f"which are not ported yet (ROADMAP.md Queue 1 item 11)")


def save(layer, path, input_spec=None, **configs):
    _needs_export("save")


def load(path, **configs):
    _needs_export("load")


class TracedLayer:
    def __init__(self, *args, **kwargs):
        _needs_export("TracedLayer")

    @staticmethod
    def trace(layer, inputs):
        _needs_export("TracedLayer")


class TranslatedLayer(Layer):
    def __init__(self, *args, **kwargs):
        _needs_export("TranslatedLayer")


# -- TrainStep ------------------------------------------------------------------

# every hand-written kernel's launch counter: (ops module, counter)
_KERNEL_COUNTERS = (
    ("flash_attention", "LAUNCHES"), ("flash_attention", "BWD_LAUNCHES"),
    ("paged_attention", "LAUNCHES"), ("fused_kernels", "FWD_LAUNCHES"),
    ("fused_kernels", "BWD_LAUNCHES"), ("fused_kernels", "DW2_LAUNCHES"),
    ("fused_kernels", "ADDLN_FWD_LAUNCHES"),
    ("fused_kernels", "ADDLN_BWD_LAUNCHES"),
    ("fused_optimizer", "ADAMW_LAUNCHES"),
    ("fused_optimizer", "LAMB_LAUNCHES"), ("int8_matmul", "LAUNCHES"),
    ("fp8_matmul", "LAUNCHES"), ("moe_dispatch", "LAUNCHES"))


def _counters():
    return [(importlib.import_module(f"paddle_tpu_torch.ops.{m}"), c)
            for m, c in _KERNEL_COUNTERS]


def _leaves(x, out):
    """Flatten a batch (tuples, lists, dicts of Tensors, torch tensors,
    numpy arrays, scalars) into ``out``; returns its structure."""
    if isinstance(x, (list, tuple)):
        return (type(x), [_leaves(v, out) for v in x])
    if isinstance(x, dict):
        return (dict, [(k, _leaves(v, out)) for k, v in x.items()])
    out.append(x)
    return None


def _rebuild(spec, it):
    if spec is None:
        return next(it)
    kind, parts = spec
    if kind is dict:
        return {k: _rebuild(s, it) for k, s in parts}
    return kind(_rebuild(s, it) for s in parts)


def _as_data(x, device):
    """A batch leaf as a torch tensor on ``device`` (None for a leaf
    that is not array-like: it is passed through as a constant)."""
    if isinstance(x, Tensor):
        x = x._data
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    if isinstance(x, torch.Tensor):
        return x.detach().to(device, non_blocking=True)
    return None


class _Graph:
    """One captured step: the graph, its static inputs, its loss output,
    its leaf tables and the kernel launches each replay makes."""

    __slots__ = ("graph", "inputs", "loss", "tables", "launches")


class TrainStep:
    """Forward + backward + update as one step: a captured CUDA graph on
    the card, the same code uncaptured on the CPU (see the module's
    docstring). ``loss_fn(run_model, *batch)`` returns the loss Tensor;
    ``run_model(*inputs)`` runs the model in training mode."""

    def __init__(self, model: Layer, loss_fn: Callable, optimizer,
                 donate: bool = True,
                 grad_postprocess: Optional[Callable] = None,
                 sentinel=None, capture: bool = True):
        if sentinel:
            raise NotImplementedError(
                "TrainStep(sentinel=...): the health sentinel is not ported "
                "to paddle_tpu_torch yet (ROADMAP.md Queue 1 item 9)")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.grad_postprocess = grad_postprocess
        # capture=False: every call runs the step eagerly, on the card
        # too (the yardstick a captured step is held to)
        self.capture = bool(capture)
        self._step_count = 0
        self._lr_scale = 1.0
        self.captures = 0
        self._params = {k: p for k, p in model.named_parameters()
                        if not p.stop_gradient}
        self._param_names = list(self._params)
        # the optimizer's slots, made now in a fixed order: the step
        # updates these very tensors in place
        if optimizer._fused_state is not None and optimizer._slots_stale:
            optimizer._fused_state.sync_slots(optimizer)
        self._slot_values = {k: optimizer._get_slots(p)
                             for k, p in self._params.items()}
        self._hyper = {k: tuple(sorted(optimizer._hyper(p).items()))
                       for k, p in self._params.items()}
        from ..regularizer import L1Decay

        self._use_fused = (
            flags.fused_optimizer[0]
            and type(optimizer).__name__ in ("Adam", "AdamW")
            and optimizer._slot_names() == ["moment1", "moment2",
                                            "beta1_pow", "beta2_pow"]
            and not any(isinstance(p.regularizer if p.regularizer is not None
                                   else optimizer._weight_decay, L1Decay)
                        for p in self._params.values()))
        first = next(iter(self._params.values()))._data
        self.device = first.device
        self._lr_dev = torch.zeros((), dtype=torch.float32,
                                   device=self.device)
        self._lr_value = None
        self._graphs: Dict[Any, _Graph] = {}

    # -- the step itself ----------------------------------------------------
    def _run(self, batch, tables=None):
        """One step on torch tensors: forward, backward, clip, update, in
        place; returns the loss (detached)."""
        model, opt = self.model, self.optimizer
        was = [(m, m.training) for m in model.sublayers(include_self=True)]
        bufs = {k: b for k, b in model.named_buffers() if b is not None}
        held = {k: b._data for k, b in bufs.items()}
        try:
            for m, _ in was:
                m.training = True

            def run_model(*xs, **kw):
                return model(*xs, **kw)

            args = [Tensor(x) if isinstance(x, torch.Tensor) else x
                    for x in batch]
            loss = self.loss_fn(run_model, *args)
        finally:
            for m, t in was:
                m.training = t
        loss = loss._data if isinstance(loss, Tensor) else loss
        names = self._param_names
        grads = torch.autograd.grad(
            loss, [self._params[k]._data for k in names], allow_unused=True)
        grads = {k: torch.zeros_like(self._params[k]._data) if g is None
                 else g for k, g in zip(names, grads)}
        with torch.no_grad():
            if self.grad_postprocess is not None:
                grads = self.grad_postprocess(grads)
            pg = [(self._params[k], grads[k]) for k in names]
            if opt._grad_clip is not None:
                pg = opt._grad_clip(pg)
            if self._use_fused:
                fused_update_from_slots = importlib.import_module(
                    "paddle_tpu_torch.ops.fused_optimizer"
                ).fused_update_from_slots
                fused_update_from_slots(
                    opt, names, self._params,
                    {k: getattr(g, "_data", g) for k, (_, g) in
                     zip(names, pg)},
                    self._slot_values, self._lr_dev, self._hyper, tables)
            else:
                opt._apply(pg, self._lr_dev)
            # a buffer rebound (not updated in place) goes back into its
            # own tensor, so a replay reads and writes the same memory
            for k, b in bufs.items():
                if b._data is not held[k]:
                    held[k].copy_(b._data)
                    b._data = held[k]
        return loss.detach()

    # -- calls ----------------------------------------------------------------
    def _signature(self, leaves):
        sig = []
        for x in leaves:
            d = x._data if isinstance(x, Tensor) else x
            if isinstance(d, (torch.Tensor, np.ndarray)):
                sig.append((tuple(d.shape), str(d.dtype)))
            else:
                sig.append(("const", repr(d)))
        return tuple(sig)

    def _write_lr(self):
        lr = float(self.optimizer.get_lr()) * self._lr_scale
        if lr != self._lr_value:
            self._lr_dev.fill_(lr)
            self._lr_value = lr

    def __call__(self, *batch):
        if flags.fault_inject[0]:
            raise NotImplementedError(
                "TrainStep under FLAGS_fault_inject: the train-step fault "
                "hooks are not ported to paddle_tpu_torch yet (ROADMAP.md "
                "Queue 1 item 9)")
        self._count()
        self.optimizer._fused_state = None
        self._write_lr()
        leaves: list = []
        spec = _leaves(batch, leaves)
        if self.device.type != "cuda" or not self.capture:
            data = [_as_data(x, self.device) for x in leaves]
            data = [d if d is not None else x for d, x in zip(data, leaves)]
            loss = self._run(_rebuild(spec, iter(data)))
        else:
            loss = self._call_captured(spec, leaves)
        return self._result(loss)

    def _count(self):
        from ..monitor.stats import FUSED_OPTIMIZER_STEPS, TRAIN_STEPS

        self._step_count += 1
        TRAIN_STEPS.add()
        if self._use_fused:
            FUSED_OPTIMIZER_STEPS.add()

    def _result(self, loss):
        if flags.fast_step[0]:
            return AsyncLoss(loss)
        return Tensor(loss)

    def _call_captured(self, spec, leaves):
        sig = (repr(spec), self._signature(leaves))
        g = self._graphs.get(sig)
        if g is not None:
            for dst, x in zip(g.inputs, leaves):
                if dst is not None:
                    src = x._data if isinstance(x, Tensor) else x
                    if isinstance(src, np.ndarray):
                        src = torch.from_numpy(src)
                    dst.copy_(src, non_blocking=True)
            return self._replay(g)
        from ..ops.fused_optimizer import SlotTables

        tables = SlotTables()
        inputs = [_as_data(x, self.device) for x in leaves]
        batch = _rebuild(spec, iter([d if d is not None else x
                                     for d, x in zip(inputs, leaves)]))
        # the warm-up: the real step, run eagerly on a side stream. It
        # also makes the leaf tables, outside the graph's pool: a table
        # made inside the capture could reuse the memory of a tensor
        # freed earlier in it, which each replay writes before the
        # kernel reads the table
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            loss = self._run(batch, tables)
        cur.wait_stream(side)
        self._graphs[sig] = self._capture(spec, inputs, leaves, tables)
        return loss

    def _capture(self, spec, inputs, leaves, tables):
        g = _Graph()
        # static inputs: the batch's own copies, made outside the pool
        g.inputs = [None if d is None else d.clone() for d in inputs]
        batch = _rebuild(spec, iter([d if d is not None else x
                                     for d, x in zip(g.inputs, leaves)]))
        g.tables = tables
        g.graph = torch.cuda.CUDAGraph()
        self._register_rng(g.graph)
        counters = _counters()
        before = [getattr(m, c) for m, c in counters]
        try:
            with torch.cuda.graph(g.graph):
                g.loss = self._run(batch, g.tables)
        except Exception as e:
            raise RuntimeError(
                f"TrainStep cannot capture this step into a CUDA graph: "
                f"{type(e).__name__}: {e}. A host read in the model or the "
                f"loss (Tensor.item/numpy/tolist, float(), int(), bool() "
                f"of a card tensor), a data-dependent shape or an "
                f"unregistered RNG generator breaks capture; the step does "
                f"not fall back to the uncaptured one") from e
        g.tables.finalize()
        # the capture launched nothing: each replay launches what it holds
        g.launches = []
        for (m, c), b in zip(counters, before):
            d = getattr(m, c) - b
            setattr(m, c, b)
            if d:
                g.launches.append((m, c, d))
        self.captures += 1
        return g

    def _register_rng(self, graph):
        from ..framework import random as grandom
        from ..nn.layer.common import Dropout
        from ..optimizer.optimizer import Dpsgd

        gen = grandom.generator(self.device)
        register = getattr(graph, "register_generator_state", None)
        if register is not None:
            register(gen)
            return
        uses = isinstance(self.optimizer, Dpsgd) or any(
            isinstance(m, Dropout) and getattr(m, "p", 0) > 0
            for m in self.model.sublayers(include_self=True))
        if uses:
            raise RuntimeError(
                "TrainStep: this step draws from the device's seeded "
                "generator (Dpsgd noise or dropout), and this torch cannot "
                "register a generator with a CUDA graph "
                "(CUDAGraph.register_generator_state); a replay would "
                "repeat the capture's draws")

    def _replay(self, g):
        g.graph.replay()
        for m, c, d in g.launches:
            setattr(m, c, getattr(m, c) + d)
        # the step's own copy: the next replay rewrites g.loss
        return g.loss.clone()

    def steps(self, k: int, *batch):
        """``k`` steps on one batch with no host read between them (the
        reference's "K steps inside one jit"): the learning rate is read
        once; on the card, after the first call of a signature, each
        step is one replay. Returns the last step's loss."""
        out = self(*batch)
        if k <= 1:
            return out
        leaves: list = []
        spec = _leaves(batch, leaves)
        g = self._graphs.get((repr(spec), self._signature(leaves)))
        loss = None
        for _ in range(k - 1):
            if g is not None:
                self._count()
                loss = self._replay(g)
            else:
                out = self(*batch)
        return out if loss is None else self._result(loss)

    def scale_lr(self, scale: float) -> None:
        """Set the absolute learning-rate multiplier; it enters the step
        as the device scalar, so a captured step keeps its graph."""
        self._lr_scale = float(scale)

    def sync(self):
        """The JAX package's lazy slot-mirror flush. The port's step
        updates the optimizer's own slot tensors in place, so
        ``optimizer.state_dict()`` reads them as they are: there is
        nothing to copy."""
