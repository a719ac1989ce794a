"""Symbolic graph capture for static mode.

Counterpart of ``paddle_tpu/static/graph.py``. The same op funnel the
eager mode uses (``framework/core.py`` :func:`apply_op`) records into
the current Program when an argument is a placeholder: an op node keeps
the function on torch tensors and its symbolic or literal arguments,
and execution later REPLAYS the recorded DAG on real tensors
(``Executor.run``). Every eager op is thereby available in static mode.

Shapes and dtypes of a recorded op come from running it on ``meta``
tensors (the JAX package uses ``jax.eval_shape``): the kernel wrappers
take their plain path there (a meta tensor is no CUDA tensor), which
only computes the shape. An op that reads a value on the host, or whose
output shape depends on the data, cannot run on meta tensors and so
cannot be recorded: the recording raises.

The recording hook is installed only while a program is being built
(``paddle.enable_static()`` or ``static.data``), so eager dispatch reads
one list cell and nothing else.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from ..framework.core import Tensor, set_symbolic_dispatch

__all__ = ["SymbolicTensor", "OpRecord", "SymExpr", "evaluate_exprs",
           "collect_leaves", "grad_of_loss", "suspend_symbolic",
           "install", "uninstall", "record_op", "reaches_op"]


class OpRecord:
    """One recorded op: a function on torch tensors + its (symbolic |
    Tensor | literal) arguments + attrs. ``program`` is set by the
    Program that recorded it, so later calls (``optimizer.minimize``
    outside the ``program_guard``) find the owning program."""

    __slots__ = ("fn", "args", "attrs", "name", "n_outputs", "program")

    def __init__(self, fn, args, attrs, name):
        self.fn = fn
        self.args = args          # SymExpr | Tensor | literal per position
        self.attrs = attrs
        self.name = name
        self.n_outputs = 1
        self.program = None


class SymExpr:
    """A value in the symbolic graph.

    kind: "feed" (runtime placeholder), "tensor" (a captured eager
    Tensor, typically a Parameter, evaluated to its CURRENT value at run
    time), "op" (output ``index`` of an OpRecord)."""

    __slots__ = ("kind", "name", "tensor", "op", "index")

    def __init__(self, kind, name=None, tensor=None, op=None, index=0):
        self.kind = kind
        self.name = name
        self.tensor = tensor
        self.op = op
        self.index = index


class SymbolicTensor(Tensor):
    """A Tensor whose ``_data`` is a ``meta`` tensor of its build shape
    and dtype; it carries the SymExpr it stands for. It has no value:
    every host read raises."""

    __slots__ = ("_expr",)
    _symbolic = True

    def __init__(self, expr: SymExpr, meta: torch.Tensor):
        self._data = meta
        self.name = expr.name
        self.persistable = False
        self._expr = expr

    def _no_value(self, *a, **k):
        raise RuntimeError(
            "SymbolicTensor has no value at build time: fetch it through "
            "Executor.run(fetch_list=[...])")

    numpy = item = tolist = _no_value
    __bool__ = __float__ = __int__ = __index__ = _no_value

    def __array__(self, dtype=None, copy=None):
        self._no_value()

    def __len__(self):
        return int(self.shape[0])

    @property
    def place(self) -> torch.device:
        """The device the program runs on: where its parameters are made
        (the current device), not the placeholder's meta storage."""
        from ..device import current_device

        return current_device()

    def __repr__(self):
        return (f"SymbolicTensor(name={self.name}, shape={self.shape}, "
                f"dtype={self._data.dtype})")


def _meta(x):
    """``x`` as shape inference sees it: a placeholder's meta tensor, a
    Tensor's or torch tensor's meta twin, a literal as it is."""
    if isinstance(x, SymbolicTensor):
        return x._data
    if isinstance(x, Tensor):
        x = x._data
    if isinstance(x, torch.Tensor):
        return x if x.is_meta else x.detach().to("meta")
    return x


_suspended = [0]
# > 0 while a recorded op's shapes are being inferred
_inferring = [0]


class suspend_symbolic:
    """Context: run ops directly even while the hook is installed (a
    control-flow op's body at replay, whose placeholders have values
    bound into ``_data``)."""

    def __enter__(self):
        _suspended[0] += 1

    def __exit__(self, *exc):
        _suspended[0] -= 1
        return False


def _symbolic_dispatch(fn, args, attrs, op_name):
    """Installed into framework.core.apply_op: record instead of execute
    when an argument is symbolic."""
    if _suspended[0]:
        if _inferring[0]:
            # an op inside a recorded function's shape inference: on the
            # meta twins of its arguments
            out = fn(*[_meta(a) for a in args],
                     **{k: _meta(v) for k, v in attrs.items()})
            if isinstance(out, (tuple, list)):
                return tuple(Tensor._wrap(o) for o in out)
            return Tensor._wrap(out)
        for a in args:
            if isinstance(a, SymbolicTensor) and a._data.is_meta:
                raise RuntimeError(
                    f"op '{op_name or getattr(fn, '__name__', 'op')}' got a "
                    f"placeholder with no value while a program runs: a "
                    f"control-flow body reads a placeholder it was not "
                    f"given (pass it in the loop vars or close over it)")
        return NotImplemented
    if not any(isinstance(a, SymbolicTensor) for a in args) and not (
            torch.is_grad_enabled() and any(
                isinstance(a, Tensor) and a._data.requires_grad
                for a in args)):
        # (an op on a parameter with grad enabled is recorded too: run at
        # build time, its output would be a constant of the program and
        # the parameter would never train; under no_grad it runs, as a
        # weight's copy at build time does)
        for a in args:
            d = a._data if isinstance(a, Tensor) else a
            if isinstance(d, torch.Tensor) and d.is_meta:
                raise TypeError(
                    f"op '{op_name or getattr(fn, '__name__', 'op')}' got a "
                    f"tensor with no value (made from a placeholder outside "
                    f"the recording): it cannot run at build time")
        return NotImplemented

    name = op_name or getattr(fn, "__name__", "op")
    metas = [_meta(a) for a in args]
    try:
        _inferring[0] += 1
        try:
            with torch.no_grad(), suspend_symbolic():
                if hasattr(fn, "infer"):
                    out = fn.infer(metas, args)
                else:
                    out = fn(*metas,
                             **{k: _meta(v) for k, v in attrs.items()})
        finally:
            _inferring[0] -= 1
    except Exception as e:  # noqa: BLE001 — re-raised with the op named
        raise RuntimeError(
            f"op '{name}' cannot be recorded into a static program: its "
            f"shape could not be inferred on meta tensors ({type(e).__name__}"
            f": {e}). An op that reads a value on the host or whose output "
            f"shape depends on the data has no static form") from e
    multi = isinstance(out, (tuple, list))
    outs = tuple(out) if multi else (out,)
    for o in outs:
        if not isinstance(o, torch.Tensor):
            raise RuntimeError(f"op '{name}' returned {type(o).__name__}, "
                               f"not a tensor: it cannot be recorded")
    result = record_op(fn, args, attrs, name, outs)
    return tuple(result) if multi else result[0]


def record_op(fn, args, attrs, name, metas):
    """Record ``fn`` on ``args`` into the current program with outputs of
    the given meta tensors' shapes and dtypes; returns their
    placeholders."""
    rec_args = []
    for a in args:
        if isinstance(a, SymbolicTensor):
            rec_args.append(a._expr)
        elif isinstance(a, Tensor):
            rec_args.append(SymExpr("tensor", tensor=a))
        else:
            rec_args.append(a)
    rec = OpRecord(fn, rec_args, attrs, name)
    rec.n_outputs = len(metas)
    result = [SymbolicTensor(SymExpr("op", op=rec, index=i), o)
              for i, o in enumerate(metas)]
    from . import _on_op_recorded

    _on_op_recorded(rec)
    return result


def install():
    """Install the recording hook (a program is being built)."""
    set_symbolic_dispatch(_symbolic_dispatch)


def uninstall():
    set_symbolic_dispatch(None)


# -- evaluation -------------------------------------------------------------

def collect_leaves(exprs: List[SymExpr]):
    """(feed_names, tensor_leaves) reachable from exprs; tensor leaves are
    the captured eager Tensors (Parameters etc.), deduped by id, in
    discovery order. An env-aware op (the grad op) reaches the leaves of
    the loss it differentiates."""
    feeds: List[str] = []
    tensors: List[Tensor] = []
    seen_ops = set()
    seen_feed = set()
    seen_t = set()

    def walk(e):
        if not isinstance(e, SymExpr):
            return
        if e.kind == "feed":
            if e.name not in seen_feed:
                seen_feed.add(e.name)
                feeds.append(e.name)
        elif e.kind == "tensor":
            if id(e.tensor) not in seen_t:
                seen_t.add(id(e.tensor))
                tensors.append(e.tensor)
        elif e.kind == "op":
            if id(e.op) in seen_ops:
                return
            seen_ops.add(id(e.op))
            for a in e.op.args:
                walk(a)
            for v in e.op.attrs.values():
                walk(v)

    for e in exprs:
        walk(e)
    return feeds, tensors


def reaches_op(exprs: List[SymExpr], pred) -> bool:
    """True when an op of the DAG under ``exprs`` satisfies ``pred``."""
    seen = set()
    stack = list(exprs)
    while stack:
        e = stack.pop()
        if not isinstance(e, SymExpr) or e.kind != "op" or id(e.op) in seen:
            continue
        seen.add(id(e.op))
        if pred(e.op):
            return True
        stack.extend(e.op.args)
    return False


def grad_of_loss(loss, params, ev):
    """d loss / d params: the loss as the replay ``ev`` evaluates it
    (with autograd on), differentiated by ``torch.autograd.grad`` with
    the parameters as the leaves (zeros where the loss does not reach
    one). The graph is kept: a training spec differentiates the same
    loss again."""
    lv = ev(loss)
    leaves = [p._data for p in params]
    gs = torch.autograd.grad(lv.float() if lv.dtype != torch.float32
                             else lv, leaves, retain_graph=True,
                             allow_unused=True)
    return tuple(torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, gs))


def _schedule(exprs: List[SymExpr]):
    """The ops under ``exprs`` in an order that runs each after its
    arguments (an iterative depth-first walk: a deep program does not
    recurse), and how many argument slots read each op's outputs."""
    order, uses, state = [], {}, {}
    for root in exprs:
        if not isinstance(root, SymExpr) or root.kind != "op":
            continue
        stack = [(root.op, False)]
        while stack:
            op, done = stack.pop()
            if done:
                state[id(op)] = 2
                order.append(op)
                continue
            if state.get(id(op)):
                continue
            state[id(op)] = 1
            stack.append((op, True))
            for a in list(op.args) + list(op.attrs.values()):
                if isinstance(a, SymExpr) and a.kind == "op":
                    uses[id(a.op)] = uses.get(id(a.op), 0) + 1
                    if not state.get(id(a.op)):
                        stack.append((a.op, False))
    return order, uses


def evaluate_exprs(exprs: List[SymExpr], feed_env: Dict[str, Any]):
    """Replay the DAG; returns the list of values for ``exprs``. A
    captured Tensor evaluates to its torch tensor as it is now (a
    parameter's own leaf, so autograd reaches it). The ops run in one
    topological order, and each op's outputs are dropped once the last
    op that reads them has run (the values ``exprs`` ask for are kept),
    so the replay holds what eager code would hold."""
    order, uses = _schedule(exprs)
    keep = {id(e.op) for e in exprs
            if isinstance(e, SymExpr) and e.kind == "op"}
    memo: Dict[int, Any] = {}

    def ev(e):
        if not isinstance(e, SymExpr):
            return e
        if e.kind == "feed":
            try:
                return feed_env[e.name]
            except KeyError:
                raise KeyError(f"missing feed for placeholder '{e.name}'")
        if e.kind == "tensor":
            return e.tensor._data
        return memo[id(e.op)][e.index]

    def release(a):
        if isinstance(a, SymExpr) and a.kind == "op":
            k = id(a.op)
            uses[k] -= 1
            if uses[k] == 0 and k not in keep:
                memo.pop(k, None)

    with suspend_symbolic():
        for op in order:
            if hasattr(op.fn, "evaluate_with_env"):
                # env-aware ops (the static grad op) evaluate through the
                # replay's own values, so they share its forward
                out = op.fn.evaluate_with_env(ev)
            else:
                out = op.fn(*[ev(a) for a in op.args],
                            **{k: ev(v) for k, v in op.attrs.items()})
            memo[id(op)] = (tuple(out) if isinstance(out, (tuple, list))
                            else (out,))
            for a in list(op.args) + list(op.attrs.values()):
                release(a)
        return [ev(e) for e in exprs]
