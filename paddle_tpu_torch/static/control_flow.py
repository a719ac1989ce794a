"""Static control-flow ops: cond, while_loop, case, switch_case.

Counterpart of ``paddle_tpu/static/control_flow.py`` (reference
python/paddle/fluid/layers/control_flow.py: ``cond``, ``while_loop``,
``case``, ``switch_case`` over ConditionalBlock / While ops).

- Eager: Python runs the branch the predicate names, and the loop while
  its condition holds (each test a host read of the predicate).
- In a program: ``cond`` records both branches and selects their
  outputs with ``torch.where`` (a static program's branches are pure, so
  evaluating both keeps the semantics; the JAX package makes the same
  trade), so a program holding it can be captured into a CUDA graph.
  ``case`` and ``switch_case`` are chains of ``cond``. ``while_loop``
  records ONE op whose body re-enters the user's condition and body on
  the run's tensors: a host loop, so a program holding it runs
  uncaptured on the card (the Executor says so).
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..framework.core import Tensor, apply_op

__all__ = ["cond", "while_loop", "case", "switch_case"]


def _is_symbolic(*vals):
    def walk(v):
        if isinstance(v, (tuple, list)):
            return any(walk(x) for x in v)
        return getattr(v, "_symbolic", False)

    return any(walk(v) for v in vals)


def _flatten(tree, out):
    """Flatten Tensors of nested lists / tuples into ``out``; returns
    the structure."""
    if isinstance(tree, (list, tuple)):
        return (type(tree), [_flatten(v, out) for v in tree])
    out.append(tree)
    return None


def _unflatten(spec, it):
    if spec is None:
        return next(it)
    kind, parts = spec
    return kind(_unflatten(s, it) for s in parts)


def _select(p, *branches):
    n = len(branches) // 2
    p = p.reshape(()).bool()
    return tuple(torch.where(p, a, b) for a, b in zip(branches[:n],
                                                       branches[n:]))


def cond(pred, true_fn: Callable, false_fn: Callable, name=None):
    """Run ``true_fn()`` or ``false_fn()`` as the scalar boolean ``pred``
    says. Both take no arguments (they close over outer tensors) and
    return the same structure of Tensors."""
    if _is_symbolic(pred):
        flat_t, flat_f = [], []
        ts = _flatten(true_fn(), flat_t)
        fs = _flatten(false_fn(), flat_f)
        if ts != fs or len(flat_t) != len(flat_f):
            raise ValueError(
                f"cond: branch outputs must have identical structure, got "
                f"{ts} vs {fs}")
        out = apply_op(_select, pred, *flat_t, *flat_f, op_name="cond")
        out = out if isinstance(out, tuple) else (out,)
        return _unflatten(ts, iter(out))
    p = pred._data if isinstance(pred, Tensor) else pred
    taken = bool(p.reshape(()) if isinstance(p, torch.Tensor) else p)
    return true_fn() if taken else false_fn()


def _closure_symbolics(fn, seen):
    """Placeholders captured in fn's closure cells: they become explicit
    operands of the recorded while op, bound to their values at a run."""
    values = []
    for cell in getattr(fn, "__closure__", None) or ():
        try:
            values.append(cell.cell_contents)
        except ValueError:
            continue
    # and the module globals it names
    code, glob = getattr(fn, "__code__", None), getattr(fn, "__globals__", {})
    if code is not None:
        values += [glob[n] for n in code.co_names if n in glob]
    found = []
    for v in values:
        if getattr(v, "_symbolic", False) and id(v) not in seen:
            seen.add(id(v))
            found.append(v)
    return found


def _as_data(v):
    return v._data if isinstance(v, Tensor) else torch.as_tensor(v)


class _WhileOp:
    """The recorded while op's body: the loop on the run's tensors, with
    the closure's placeholders bound to their values."""

    __name__ = "while_loop"
    host_read = True

    def __init__(self, cond_fn, body_fn, n, extras):
        self.cond_fn = cond_fn
        self.body_fn = body_fn
        self.n = n
        self.extras = extras

    def __call__(self, *arrays):
        loop_arrays, extra_arrays = arrays[:self.n], arrays[self.n:]
        saved = [(t, t._data) for t in self.extras]
        try:
            for t, a in zip(self.extras, extra_arrays):
                t._data = a
            vs = [Tensor._wrap(a) for a in loop_arrays]
            while bool(_as_data(self.cond_fn(*vs)).reshape(())):
                out = self.body_fn(*vs)
                if not isinstance(out, (tuple, list)):
                    out = (out,)
                if len(out) != self.n:
                    raise ValueError(
                        f"while_loop: body returned {len(out)} vars, "
                        f"expected {self.n}")
                vs = [Tensor._wrap(_as_data(o).to(a.dtype).reshape(a.shape))
                      for o, a in zip(out, loop_arrays)]
            return tuple(v._data for v in vs)
        finally:
            for t, d in saved:
                t._data = d


def while_loop(cond_fn: Callable, body_fn: Callable, loop_vars: Sequence,
               is_test=False, name=None):
    """paddle.static.nn.while_loop parity: run ``body_fn(*vars)`` while
    ``cond_fn(*vars)`` holds; returns the final loop vars (each keeps its
    shape and dtype across iterations, as the reference's While op
    requires)."""
    if not isinstance(loop_vars, (list, tuple)) or not loop_vars:
        raise ValueError("loop_vars must be a non-empty list/tuple")
    n = len(loop_vars)
    if not _is_symbolic(*loop_vars):
        seen = set()
        extras = (_closure_symbolics(cond_fn, seen)
                  + _closure_symbolics(body_fn, seen))
        if not extras:
            vs = [v if isinstance(v, Tensor) else Tensor(v)
                  for v in loop_vars]
            while bool(_as_data(cond_fn(*vs)).reshape(())):
                out = body_fn(*vs)
                if not isinstance(out, (tuple, list)):
                    out = (out,)
                if len(out) != n:
                    raise ValueError(f"while_loop: body returned {len(out)} "
                                     f"vars, expected {n}")
                vs = [o if isinstance(o, Tensor) else Tensor(o) for o in out]
            return vs
    from .graph import record_op

    # a placeholder the functions close over is bound to its value at a
    # run, a loop var's first value included
    seen = set()
    extras = (_closure_symbolics(cond_fn, seen)
              + _closure_symbolics(body_fn, seen))
    metas = [(v._data if isinstance(v, Tensor) else torch.as_tensor(v)
              ).to("meta") for v in loop_vars]
    return record_op(_WhileOp(cond_fn, body_fn, n, extras),
                     list(loop_vars) + extras, {}, "while_loop", metas)


def case(pred_fn_pairs, default=None, name=None):
    """First-match-wins chain of (pred, fn) pairs (reference
    control_flow.py case): nested cond."""
    if not pred_fn_pairs:
        raise ValueError("case needs at least one (pred, fn) pair")
    pred, fn = pred_fn_pairs[0]
    rest = pred_fn_pairs[1:]
    if not rest:
        if default is None:
            return fn()
        return cond(pred, fn, default)
    return cond(pred, fn, lambda: case(rest, default))


def switch_case(branch_index, branch_fns, default=None, name=None):
    """Dispatch on the integer ``branch_index`` (reference switch_case).
    ``branch_fns``: a list of callables, of (index, callable) pairs, or a
    dict."""
    if isinstance(branch_fns, dict):
        pairs = sorted(branch_fns.items())
    elif branch_fns and isinstance(branch_fns[0], (tuple, list)):
        pairs = sorted((int(i), f) for i, f in branch_fns)
    else:
        pairs = list(enumerate(branch_fns))
    if default is None:
        default = pairs[-1][1]
    chain = default
    for idx, fn in reversed(pairs):
        chain = (lambda chain=chain, idx=idx, fn=fn: cond(
            _eq_scalar(branch_index, idx), fn, chain))
    return chain()


def _eq_index(x, i):
    return x.reshape(()) == i


def _eq_scalar(x, i):
    if isinstance(x, Tensor):
        return apply_op(_eq_index, x, i=int(i), op_name="equal")
    return x == i
