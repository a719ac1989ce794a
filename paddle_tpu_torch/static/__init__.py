"""paddle_tpu_torch.static — the static-graph world.

Counterpart of ``paddle_tpu/static/__init__.py`` (the reference's
Program / Executor stack: ``Program``, ``Executor.run``,
``append_backward``, ``minimize`` on programs). User code builds the
graph by calling ordinary ops on placeholders (``static/graph.py``
records through the same ``apply_op`` funnel the eager mode uses), and
``Executor.run`` replays the recorded DAG.

Where the JAX package compiles one XLA program per (fetch set, feed
shapes), the port captures one CUDA graph per (program, fetch set, feed
signature, train or not) on the card: the forward, ``torch.autograd.
grad`` with the parameters as the leaves, and each ``minimize`` spec's
optimizer update (row 7's kernel under ``FLAGS_fused_optimizer=1``), as
``jit.TrainStep`` captures its step. The first run of a signature runs
eagerly on a side stream and captures; later runs copy the feeds into
the graph's static inputs and replay. A program holding a host read
(``while_loop``, ``py_func``, ``Print``) runs uncaptured on the card,
and the Executor says so (``last_run``). On the CPU every run is
uncaptured. A capture or launch failure raises: nothing falls back.

``Executor(CPUPlace())`` is the only way to the CPU; the default place
is the card. A program's parameters and constants live where they were
made (``paddle.set_device``), and must live on the Executor's device.

Typical reference workflow that runs unchanged::

    paddle.enable_static()
    x = paddle.static.data("x", [-1, 784])
    y = paddle.static.data("y", [-1, 1], dtype="int64")
    loss = F.cross_entropy(my_layer(x), y)
    paddle.optimizer.SGD(0.01, parameters=my_layer.parameters()).minimize(loss)
    exe = paddle.static.Executor()
    exe.run(paddle.static.default_startup_program())
    loss_val, = exe.run(feed={"x": xs, "y": ys}, fetch_list=[loss])

``save_inference_model`` and the rest of the export family
(``load_inference_model``, ``serialize_*``, ``deserialize_*``) need the
port's export format, which is not ported (ROADMAP.md Queue 1 item 11):
they raise, as ``jit.save`` does.
"""
from __future__ import annotations

import os
from contextlib import contextmanager
from typing import Dict, List

import numpy as np
import torch

from ..core import flags
from ..device import CPUPlace, CUDAPlace, XPUPlace, NPUPlace  # noqa: F401
from ..framework import dtype as dtypes
from ..framework.core import Parameter, Tensor, apply_op
from ..jit import InputSpec  # noqa: F401
from . import graph as _graph
from .control_flow import case, cond, switch_case, while_loop  # noqa: F401
from .graph import (  # noqa: F401
    OpRecord, SymbolicTensor, SymExpr, collect_leaves, evaluate_exprs,
)

__all__ = [
    "InputSpec", "Program", "program_guard", "default_main_program",
    "default_startup_program", "data", "Executor", "CompiledProgram",
    "name_scope", "device_guard", "py_func", "save_inference_model",
    "load_inference_model", "gradients", "append_backward", "nn",
    "cond", "while_loop", "BuildStrategy", "ExecutionStrategy", "ParallelEnv",
    "Block", "Operator", "Variable", "ExponentialMovingAverage",
    "ParallelExecutor", "Print", "WeightNormParamAttr", "accuracy", "auc",
    "cpu_places", "cuda_places", "xpu_places", "npu_places", "Scope",
    "create_global_var", "create_parameter", "global_scope", "scope_guard",
    "load", "save", "load_from_file", "save_to_file", "load_program_state",
    "set_program_state", "normalize_program", "serialize_program",
    "serialize_persistables", "deserialize_program",
    "deserialize_persistables",
]

_static_mode = [False]


def enable_static():
    """Static mode on: the recording hook is installed."""
    _static_mode[0] = True
    _graph.install()


def disable_static():
    """Static mode off: the hook goes, and the eager path reads one list
    cell again."""
    _static_mode[0] = False
    _graph.uninstall()


# -- introspection ------------------------------------------------------------

class Operator:
    """Introspection view over one recorded op (reference framework.py
    Operator: .type, .input_arg_names, .output_arg_names, .attr)."""

    def __init__(self, block: "Block", rec: OpRecord, idx: int):
        self._block = block
        self._rec = rec
        self.idx = idx

    @property
    def type(self):  # noqa: A003
        return self._rec.name

    @property
    def input_arg_names(self) -> List[str]:
        names = []
        for a in self._rec.args:
            if isinstance(a, SymExpr):
                names.append(self._block._name_of_expr(a))
            elif isinstance(a, Tensor):
                names.append(a.name or f"tensor_{id(a)}")
        return names

    @property
    def output_arg_names(self) -> List[str]:
        return [self._block._op_output_name(self._rec, k)
                for k in range(self._rec.n_outputs)]

    def attr(self, name: str):
        return self._rec.attrs.get(name)

    def all_attrs(self) -> Dict[str, object]:
        return dict(self._rec.attrs)

    @property
    def attr_names(self) -> List[str]:
        return list(self._rec.attrs)

    def __repr__(self):
        ins = ", ".join(self.input_arg_names)
        outs = ", ".join(self.output_arg_names)
        return f"{{{outs}}} = {self.type}(inputs=[{ins}], **{self.all_attrs()})"


class Variable:
    """Introspection view over a program value (reference framework.py
    Variable: .name/.shape/.dtype/.persistable)."""

    def __init__(self, name, shape, dtype, persistable=False, tensor=None):
        self.name = name
        self.shape = list(shape)
        self.dtype = dtype
        self.persistable = persistable
        self._tensor = tensor

    def __repr__(self):
        kind = "persist " if self.persistable else ""
        return f"var {self.name} : {kind}{self.shape} {self.dtype}"


class Block:
    """Introspection view over a Program's op list (reference framework.py
    Block). The program is a flat DAG (control flow records its bodies
    into ops, not nested blocks), so there is exactly one block."""

    def __init__(self, program: "Program", idx: int = 0):
        self.program = program
        self.idx = idx

    def _op_output_name(self, rec: OpRecord, index: int) -> str:
        i = self.program.ops.index(rec)
        suffix = f".{index}" if rec.n_outputs > 1 else ""
        return f"{rec.name}_{i}.tmp_0{suffix}"

    def _name_of_expr(self, e: SymExpr) -> str:
        if e.kind == "feed":
            return e.name
        if e.kind == "tensor":
            return e.tensor.name or f"tensor_{id(e.tensor)}"
        return self._op_output_name(e.op, e.index)

    @property
    def ops(self) -> List[Operator]:
        return [Operator(self, rec, i)
                for i, rec in enumerate(self.program.ops)]

    @property
    def vars(self) -> Dict[str, Variable]:
        out = {}
        for name, t in self.program.feed_vars.items():
            out[name] = Variable(name, t.shape, dtypes.dtype_name(t.dtype))
        for p in self.program.all_parameters():
            n = p.name or f"tensor_{id(p)}"
            out[n] = Variable(n, p.shape, dtypes.dtype_name(p.dtype),
                              persistable=True, tensor=p)
        for rec in self.program.ops:
            for k in range(rec.n_outputs):
                n = self._op_output_name(rec, k)
                out[n] = Variable(n, (), "unknown")
        return out

    def var(self, name: str) -> Variable:
        v = self.vars.get(name)
        if v is None:
            raise NotFoundError(f"Variable {name!r} is not found in block "
                                f"{self.idx}.")
        return v

    def __repr__(self):
        lines = [f"block {self.idx} {{"]
        for v in self.vars.values():
            lines.append(f"  {v!r}")
        for op in self.ops:
            lines.append(f"  {op!r}")
        lines.append("}")
        return "\n".join(lines)


class NotFoundError(KeyError):
    """The reference's NotFoundError (``framework/enforce.py``)."""


class OutOfRangeError(IndexError):
    """The reference's OutOfRangeError (``framework/enforce.py``)."""


class Program:
    """A recorded op DAG + feed placeholders + training directives."""

    def __init__(self):
        self.feed_vars: Dict[str, SymbolicTensor] = {}
        self.feed_dynamic: Dict[str, List[int]] = {}  # name -> -1 dims
        self.ops: List[OpRecord] = []
        self.train_specs: List[tuple] = []   # (optimizer, loss)
        self.random_seed = None

    def global_block(self) -> Block:
        return Block(self, 0)

    def block(self, index: int) -> Block:
        if index != 0:
            raise OutOfRangeError(
                f"Program has 1 block (the flat DAG; control flow is "
                f"recorded into op bodies), block({index}) does not exist.")
        return Block(self, 0)

    def current_block(self) -> Block:
        return Block(self, 0)

    @property
    def num_blocks(self) -> int:
        return 1

    @property
    def blocks(self) -> List[Block]:
        return [Block(self, 0)]

    def list_vars(self) -> List[Variable]:
        return list(self.global_block().vars.values())

    def all_parameters(self):
        exprs = [t._expr for t in self.feed_vars.values()]
        exprs += [loss._expr for _, loss in self.train_specs]
        _, tensors = collect_leaves(
            [SymExpr("op", op=op, index=0) for op in self.ops] + exprs)
        return [t for t in tensors if isinstance(t, Parameter)]

    def clone(self, for_test=False):
        p = Program()
        p.feed_vars = dict(self.feed_vars)
        p.feed_dynamic = dict(self.feed_dynamic)
        p.ops = list(self.ops)
        p.train_specs = [] if for_test else list(self.train_specs)
        p.random_seed = self.random_seed
        return p

    def to_string(self, throw_on_error=False, with_details=False) -> str:
        return repr(self.global_block())

    def __str__(self):
        return self.to_string()

    def __repr__(self):
        return (f"Program(feeds={list(self.feed_vars)}, ops={len(self.ops)}, "
                f"train_specs={len(self.train_specs)})")


_default_main = [Program()]
_default_startup = [Program()]


def default_main_program():
    return _default_main[0]


def default_startup_program():
    return _default_startup[0]


def reset_default_programs():
    """Fresh default main and startup programs (a test's isolation: the
    defaults are process-wide)."""
    _default_main[0] = Program()
    _default_startup[0] = Program()


def _on_op_recorded(rec: OpRecord):
    rec.program = _default_main[0]
    _default_main[0].ops.append(rec)


@contextmanager
def program_guard(main_program, startup_program=None):
    pm, ps = _default_main[0], _default_startup[0]
    _default_main[0] = main_program
    if startup_program is not None:
        _default_startup[0] = startup_program
    try:
        yield
    finally:
        _default_main[0], _default_startup[0] = pm, ps


class FeedTensor(SymbolicTensor):
    """Feed placeholder: ``.shape`` reports -1 for a runtime-determined
    dim (reference Variable semantics); shape inference uses 1, and the
    Executor keys a new graph per concrete feed shape."""

    __slots__ = ("_orig_shape",)

    def __init__(self, expr, meta, orig_shape):
        super().__init__(expr, meta)
        self._orig_shape = tuple(orig_shape)

    @property
    def shape(self):
        return list(self._orig_shape)


def data(name, shape, dtype="float32", lod_level=0):
    """Feed placeholder (reference paddle.static.data). A dim of -1 or
    None is runtime-determined: reported as -1 in ``.shape``, built as
    1. Making one installs the recording hook."""
    dt = dtypes.convert_dtype(dtype)
    orig = tuple(-1 if (s is None or int(s) < 0) else int(s) for s in shape)
    build = tuple(1 if s == -1 else s for s in orig)
    meta = torch.empty(build, dtype=dt, device="meta")
    t = FeedTensor(SymExpr("feed", name=name), meta, orig)
    t.name = name
    prog = default_main_program()
    prog.feed_vars[name] = t
    prog.feed_dynamic[name] = [i for i, s in enumerate(orig) if s == -1]
    _graph.install()
    return t


@contextmanager
def name_scope(prefix):
    yield


@contextmanager
def device_guard(device=None):
    """Pipeline-stage placement hint (reference framework.py
    device_guard): one card runs the whole program, so it is accepted
    and ignored."""
    yield


def py_func(func, x, out, backward_func=None, skip_vars_in_backward_input=None):
    """Host-Python op; see ``static.nn.py_func``."""
    from .nn import py_func as _py_func

    return _py_func(func, x, out, backward_func, skip_vars_in_backward_input)


# -- autodiff -------------------------------------------------------------------

def append_backward(loss, parameter_list=None, no_grad_set=None):
    """Static autodiff (reference backward.py:1406): [(param, grad)],
    each grad a fetchable symbol."""
    if not isinstance(loss, SymbolicTensor):
        raise TypeError("append_backward expects a symbolic loss")
    params = list(parameter_list) if parameter_list else _params_for(loss)
    if no_grad_set:
        skip = {id(v) for v in no_grad_set} | {
            v for v in no_grad_set if isinstance(v, str)}
        params = [p for p in params
                  if id(p) not in skip and p.name not in skip]
    grad_op = OpRecord(_GradFn(loss, params), [loss._expr], {}, "grad")
    grad_op.n_outputs = len(params)
    grad_op.program = getattr(loss._expr.op, "program", None) \
        or default_main_program()
    out = []
    for i, p in enumerate(params):
        meta = torch.empty(p.shape, dtype=p.dtype, device="meta")
        g = SymbolicTensor(SymExpr("op", op=grad_op, index=i),
                           meta)
        g.name = (p.name or f"param{i}") + "@GRAD"
        out.append((p, g))
    return out


class _GradFn:
    """Env-aware op body: d loss / d params through the replay's own
    forward (``graph.grad_of_loss``)."""

    __name__ = "grad"
    needs_grad = True

    def __init__(self, loss, params):
        self.loss_expr = loss._expr
        self.params = params

    def evaluate_with_env(self, ev):
        return _graph.grad_of_loss(self.loss_expr, self.params, ev)


def _params_for(loss: SymbolicTensor):
    _, tensors = collect_leaves([loss._expr])
    return [t for t in tensors
            if isinstance(t, Parameter) and getattr(t, "trainable", True)
            and not t.stop_gradient]


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """The gradients of ``targets`` w.r.t. ``inputs``: symbols in a
    program (the parameters' grad symbols of ``append_backward``), eager
    gradients otherwise."""
    targets = targets if isinstance(targets, (list, tuple)) else [targets]
    ins = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    if any(isinstance(t, SymbolicTensor) for t in targets):
        if len(targets) != 1 or target_gradients is not None:
            raise NotImplementedError(
                "static.gradients takes one scalar target and no "
                "target_gradients")
        got = dict((id(p), g) for p, g in append_backward(
            targets[0], parameter_list=list(ins)))
        return [got.get(id(i)) for i in ins]
    from ..framework.core import grad as _grad

    return _grad(targets, ins, target_gradients, allow_unused=True)


# -- strategies, places, environment ----------------------------------------------

class BuildStrategy:
    """The reference's build_strategy.h surface: inert parity fields
    (the graph is what the card replays)."""

    def __init__(self):
        self.reduce_strategy = "AllReduce"
        self.gradient_scale_strategy = "CoeffNumDevice"
        self.memory_optimize = None
        self.enable_inplace = None
        self.fuse_all_optimizer_ops = False
        self.fuse_elewise_add_act_ops = False
        self.fuse_bn_act_ops = False
        self.enable_auto_fusion = False
        self.num_trainers = 1
        self.trainer_id = 0


class ExecutionStrategy:
    def __init__(self):
        self.num_threads = 1
        self.num_iteration_per_drop_scope = 100
        self.num_iteration_per_run = 1


class CompiledProgram:
    """reference compiler.py CompiledProgram on one device: the program
    and its strategies. ``with_data_parallel`` over several cards needs
    the port's data parallelism (ROADMAP.md Queue 1 item 7): it raises
    unless the places name one device."""

    def __init__(self, program, build_strategy=None):
        self.program = program
        self.build_strategy = build_strategy or BuildStrategy()
        self.exec_strategy = None
        self._loss_name = None

    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, places=None):
        n = len(places) if places is not None else torch.cuda.device_count()
        if n > 1:
            raise NotImplementedError(
                "CompiledProgram.with_data_parallel over several devices "
                "needs the port's data parallelism (ROADMAP.md Queue 1 "
                "item 7); one device runs the program as it is")
        self._loss_name = loss_name
        if build_strategy is not None:
            self.build_strategy = build_strategy
        self.exec_strategy = exec_strategy
        return self


class ParallelEnv:
    """reference dygraph ParallelEnv: rank / world size / endpoints from
    the launcher's environment (one process: rank 0 of 1)."""

    @property
    def rank(self):
        return int(os.environ.get("PADDLE_TRAINER_ID", "0"))

    local_rank = rank

    @property
    def world_size(self):
        return int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))

    nranks = world_size

    @property
    def device_id(self):
        return int(os.environ.get("FLAGS_selected_gpus", "0").split(",")[0])

    @property
    def current_endpoint(self):
        return os.environ.get("PADDLE_CURRENT_ENDPOINT", "127.0.0.1:0")

    @property
    def trainer_endpoints(self):
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        return eps.split(",") if eps else []


def cpu_places(device_count=None):
    return [CPUPlace() for _ in range(device_count or 1)]


def cuda_places(device_ids=None):
    ids = (device_ids if device_ids is not None
           else range(torch.cuda.device_count()))
    return [CUDAPlace(int(i)) for i in ids]


def xpu_places(device_ids=None):
    return cuda_places(device_ids)


def npu_places(device_ids=None):
    return cuda_places(device_ids)


# -- the Executor ---------------------------------------------------------------------

_RANDOM_OPS = {"dropout", "alpha_dropout", "rrelu", "gumbel_softmax",
               "bernoulli", "poisson", "multinomial", "randint_like",
               "normal", "nce"}


def _host_read(rec: OpRecord) -> bool:
    return bool(getattr(rec.fn, "host_read", False))


class _Spec:
    """One ``minimize`` directive of a plan: its optimizer, loss, the
    parameters it differentiates and the update's state (the learning
    rate's device scalar, the slots, row 7's tables)."""

    def __init__(self, optimizer, loss, params, device):
        self.optimizer = optimizer
        self.loss = loss._expr
        if optimizer._parameter_list is not None:
            # the optimizer's own parameters that the loss reaches (a GAN's
            # discriminator step leaves the generator alone)
            reached = {id(p) for p in params}
            params = [p for p in optimizer._parameter_list
                      if id(p) in reached]
        self.params = params
        self.names = [f"p{i}" for i in range(len(params))]
        self.by_name = dict(zip(self.names, params))
        self.lr = torch.zeros((), dtype=torch.float32, device=device)
        self.lr_value = None
        if optimizer._parameter_list is None:
            optimizer._parameter_list = list(params)
        from ..regularizer import L1Decay

        self.fused = (
            bool(flags.fused_optimizer[0])
            and type(optimizer).__name__ in ("Adam", "AdamW")
            and optimizer._slot_names() == ["moment1", "moment2",
                                            "beta1_pow", "beta2_pow"]
            and not any(isinstance(p.regularizer if p.regularizer is not None
                                   else optimizer._weight_decay, L1Decay)
                        for p in params))
        self.slots = None
        self.hyper = None

    def write_lr(self):
        lr = float(self.optimizer.get_lr())
        if lr != self.lr_value:
            self.lr.fill_(lr)
            self.lr_value = lr

    def update(self, grads, tables):
        opt = self.optimizer
        opt._fused_state = None
        with torch.no_grad():
            pg = list(zip(self.params, grads))
            if opt._grad_clip is not None:
                pg = opt._grad_clip(pg)
            if self.fused:
                from ..ops.fused_optimizer import fused_update_from_slots

                if self.slots is None:
                    self.slots = {k: opt._get_slots(p)
                                  for k, p in self.by_name.items()}
                    self.hyper = {k: tuple(sorted(opt._hyper(p).items()))
                                  for k, p in self.by_name.items()}
                fused_update_from_slots(
                    opt, self.names, self.by_name,
                    {k: getattr(g, "_data", g)
                     for k, (_, g) in zip(self.names, pg)},
                    self.slots, self.lr, self.hyper, tables)
            else:
                opt._apply(pg, self.lr)


class _Plan:
    """What one (program, fetch set, feed signature, train or not) runs,
    and on the card its captured graph."""

    def __init__(self, program, fetch_exprs, device):
        self.program = program
        self.fetch_exprs = fetch_exprs
        self.specs = []
        for optimizer, loss in program.train_specs:
            self.specs.append(_Spec(optimizer, loss, _params_for(loss),
                                    device))
        everything = fetch_exprs + [s.loss for s in self.specs]
        self.grad_ops = _graph.reaches_op(
            everything, lambda r: getattr(r.fn, "needs_grad", False))
        self.host_read = _graph.reaches_op(everything, _host_read)
        self.random = _graph.reaches_op(
            everything, lambda r: r.name in _RANDOM_OPS)
        self.graph = None
        self.inputs = None
        self.outputs = None
        self.tables = None
        self.launches = ()

    def step(self, feed_env, tables=None):
        """One run on torch tensors: the fetches (before any update) and
        each spec's update, in order."""
        if not self.specs:
            with torch.set_grad_enabled(self.grad_ops):
                vals = evaluate_exprs(self.fetch_exprs, feed_env)
            return [v.detach().clone() if isinstance(v, torch.Tensor)
                    else v for v in vals]
        fetched = None
        for i, spec in enumerate(self.specs):
            want = self.fetch_exprs if i == 0 else []
            with torch.enable_grad():
                vals = evaluate_exprs(want + [spec.loss], feed_env)
                loss = vals[-1]
                loss = loss.float() if loss.dtype != torch.float32 else loss
                grads = torch.autograd.grad(
                    loss, [p._data for p in spec.params], allow_unused=True)
            if i == 0:
                # copies: a fetch that is a parameter (or a view of one)
                # must not see the update below
                fetched = [v.detach().clone() if isinstance(v, torch.Tensor)
                           else v for v in vals[:-1]]
            grads = [torch.zeros_like(p._data) if g is None else g
                     for p, g in zip(spec.params, grads)]
            spec.update(grads, None if tables is None else tables[i])
        return fetched


class Executor:
    """Runs recorded programs (reference executor.py:607 Executor / :1065
    run): one captured CUDA graph per (program, fetch set, feed
    signature, train or not) on the card, uncaptured on the CPU.

    ``captures`` counts the graphs made, ``replays`` the replayed runs,
    ``uncaptured_runs`` the runs made eagerly on the card because the
    program holds a host read; ``last_run`` says how the last run went
    (``{"captured": bool, "reason": str}``)."""

    def __init__(self, place=None):
        self.place = place
        self._cache: Dict[tuple, _Plan] = {}
        self.captures = 0
        self.replays = 0
        self.uncaptured_runs = 0
        self.last_run = None

    @property
    def device(self) -> torch.device:
        if self.place is None:
            from .. import resolve_device

            return resolve_device(None)
        return self.place.torch_device

    # -- feeds and fetches ----------------------------------------------------
    @staticmethod
    def _feed_tensor(program, name, value, device):
        if isinstance(value, Tensor):
            value = value._data
        if not isinstance(value, torch.Tensor):
            arr = np.asarray(value)
            if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
                arr = arr.astype(np.float32)
            value = torch.from_numpy(np.ascontiguousarray(arr))
        ph = program.feed_vars.get(name)
        dt = ph.dtype if ph is not None else (
            dtypes.default_float_dtype() if value.dtype == torch.float64
            else value.dtype)
        return value.detach().to(device=device, dtype=dt)

    @staticmethod
    def _fetch_exprs(program, fetch_list):
        out = []
        for f in fetch_list:
            if isinstance(f, SymbolicTensor):
                out.append(f._expr)
            elif isinstance(f, str) and f in program.feed_vars:
                out.append(program.feed_vars[f]._expr)
            elif isinstance(f, Tensor):
                out.append(SymExpr("tensor", tensor=f))
            else:
                raise TypeError(f"cannot fetch {f!r}")
        return out

    @staticmethod
    def _check_leaves(plan, device):
        exprs = plan.fetch_exprs + [s.loss for s in plan.specs]
        _, tensors = collect_leaves(exprs)
        for t in tensors:
            if t._data.device.type != device.type:
                raise RuntimeError(
                    f"Executor on {device}: the program's tensor "
                    f"{t.name or 'unnamed'} lives on {t._data.device}; build "
                    f"the program under paddle.set_device() of the "
                    f"Executor's place")

    # -- run --------------------------------------------------------------------
    def run(self, program=None, feed=None, fetch_list=None, return_numpy=True,
            feed_var_name="feed", fetch_var_name="fetch", scope=None,
            use_program_cache=True):
        program = program if program is not None else default_main_program()
        if isinstance(program, CompiledProgram):
            program = program.program
        if not isinstance(program, Program):
            raise TypeError(f"cannot run {type(program)}")
        fetch_list = list(fetch_list or [])
        if not program.ops and not program.train_specs and not fetch_list:
            return []  # a startup program: parameters initialize eagerly
        device = self.device
        feed = feed or {}
        feeds = {k: self._feed_tensor(program, k, v, device)
                 for k, v in feed.items()}
        fetch_exprs = self._fetch_exprs(program, fetch_list)
        key = (id(program), len(program.ops), len(program.train_specs),
               tuple((id(e.op), e.index) if e.kind == "op"
                     else (e.kind, e.name, id(e.tensor))
                     for e in fetch_exprs),
               tuple((k, tuple(v.shape), str(v.dtype))
                     for k, v in sorted(feeds.items())),
               bool(program.train_specs))
        plan = self._cache.get(key)
        if plan is None:
            plan = _Plan(program, fetch_exprs, device)
            self._check_leaves(plan, device)
            self._cache[key] = plan
        for spec in plan.specs:
            spec.write_lr()
        if device.type != "cuda":
            vals = plan.step(feeds)
            self.last_run = {"captured": False, "reason": "cpu"}
        elif plan.host_read:
            vals = plan.step(feeds)
            self.uncaptured_runs += 1
            self.last_run = {"captured": False,
                             "reason": "the program reads a value on the "
                                       "host (while_loop, py_func or Print)"}
        else:
            vals = self._run_captured(plan, feeds, device)
        if return_numpy:
            return [_to_numpy(v) for v in vals]
        return [Tensor(v) if isinstance(v, torch.Tensor) else v for v in vals]

    def _run_captured(self, plan, feeds, device):
        if plan.graph is not None:
            for k, dst in plan.inputs.items():
                dst.copy_(feeds[k], non_blocking=True)
            plan.graph.replay()
            for m, c, d in plan.launches:
                setattr(m, c, getattr(m, c) + d)
            self.replays += 1
            self.last_run = {"captured": True, "reason": "replay"}
            return [v.clone() if isinstance(v, torch.Tensor) else v
                    for v in plan.outputs]
        from ..jit import _counters
        from ..ops.fused_optimizer import SlotTables

        tables = [SlotTables() for _ in plan.specs]
        # the warm-up: the real run, eagerly on a side stream (slots,
        # row 7's leaf tables and cuDNN's choices come to exist outside
        # the graph's pool)
        cur = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            vals = plan.step(feeds, tables)
        cur.wait_stream(side)
        plan.inputs = {k: v.clone() for k, v in feeds.items()}
        plan.graph = graph = torch.cuda.CUDAGraph()
        from ..framework import random as grandom

        gen = grandom.generator(device)
        register = getattr(graph, "register_generator_state", None)
        if register is not None:
            register(gen)
        elif plan.random:
            plan.graph = None
            raise RuntimeError(
                "Executor: this program draws from the device's seeded "
                "generator, and this torch cannot register a generator with "
                "a CUDA graph; a replay would repeat the capture's draws")
        counters = _counters()
        before = [getattr(m, c) for m, c in counters]
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                plan.outputs = plan.step(plan.inputs, tables)
        except Exception as e:
            plan.graph = None
            grandom.renew_generator(device)
            raise RuntimeError(
                f"Executor cannot capture this program into a CUDA graph: "
                f"{type(e).__name__}: {e}. The run does not fall back to "
                f"the uncaptured one") from e
        for t in tables:
            t.finalize()
        plan.tables = tables
        launches = []
        for (m, c), b in zip(counters, before):
            d = getattr(m, c) - b
            setattr(m, c, b)
            if d:
                launches.append((m, c, d))
        plan.launches = tuple(launches)
        from ..monitor.stats import JIT_COMPILE

        JIT_COMPILE.add()
        self.captures += 1
        self.last_run = {"captured": True, "reason": "captured"}
        return vals

    def close(self):
        self._cache.clear()


def _to_numpy(v):
    if isinstance(v, torch.Tensor):
        d = v.detach()
        if d.dtype == torch.bfloat16:
            d = d.float()
        return d.cpu().numpy()
    return np.asarray(v)


class ParallelExecutor:
    """reference parallel_executor.py on one device: the constructor and
    run surface over an Executor on the card."""

    def __init__(self, use_cuda=True, loss_name=None, main_program=None,
                 share_vars_from=None, exec_strategy=None,
                 build_strategy=None, num_trainers=1, trainer_id=0,
                 scope=None):
        if num_trainers != 1:
            raise NotImplementedError(
                "ParallelExecutor over several trainers needs the port's "
                "data parallelism (ROADMAP.md Queue 1 item 7)")
        self._program = main_program or default_main_program()
        self._exe = Executor(CUDAPlace(0) if use_cuda else CPUPlace())

    def run(self, fetch_list, feed=None, feed_dict=None, return_numpy=True):
        return self._exe.run(self._program, feed=feed or feed_dict,
                             fetch_list=fetch_list, return_numpy=return_numpy)


# -- the export family (item 11) ------------------------------------------------

def _needs_export(what):
    raise NotImplementedError(
        f"paddle_tpu_torch.static.{what} needs the port's inference export "
        f"format, which is not ported yet (ROADMAP.md Queue 1 item 11)")


def save_inference_model(path_prefix, feed_vars, fetch_vars, executor,
                         **kwargs):
    _needs_export("save_inference_model")


def load_inference_model(path_prefix, executor, **kwargs):
    _needs_export("load_inference_model")


def serialize_program(feed_vars, fetch_vars, program=None, **kwargs):
    _needs_export("serialize_program")


def serialize_persistables(feed_vars, fetch_vars, executor=None,
                           program=None, **kwargs):
    _needs_export("serialize_persistables")


def deserialize_program(data):
    _needs_export("deserialize_program")


def deserialize_persistables(program, data, executor=None):
    _needs_export("deserialize_persistables")


def normalize_program(program, feed_vars, fetch_vars):
    """Prune to the inference graph (reference static/io.py): the
    recorded program already holds only reached ops; it is annotated
    with its feed/fetch interface."""
    program._normalized_feeds = [getattr(v, "name", v) for v in feed_vars]
    program._normalized_fetches = list(fetch_vars)
    return program


# -- scope, globals, debug ops, metrics ---------------------------------------------------

from ..tensor.creation import create_parameter  # noqa: F401,E402
from ..optimizer.optimizer import ExponentialMovingAverage  # noqa: F401,E402


class Scope:
    """name → Tensor registry (reference framework/scope.h:52). The
    program captures tensors directly, so the scope is bookkeeping for
    save/load parity, not the execution store."""

    def __init__(self):
        self._vars = {}

    def var(self, name):
        if name not in self._vars:
            self._vars[name] = Tensor(torch.zeros((), dtype=torch.float32),
                                      name=name)
        return self._vars[name]

    def find_var(self, name):
        return self._vars.get(name)

    def set_var(self, name, t):
        self._vars[name] = t


_global_scope = [Scope()]


def global_scope():
    return _global_scope[-1]


@contextmanager
def scope_guard(scope):
    _global_scope.append(scope)
    try:
        yield
    finally:
        _global_scope.pop()


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    """Persistable global variable (reference layers/tensor.py
    create_global_var) on the current device, registered in the global
    scope by name."""
    from ..device import current_device

    t = Tensor(torch.full(tuple(int(s) for s in shape), value,
                          dtype=dtypes.convert_dtype(dtype),
                          device=current_device()), name=name)
    t.persistable = persistable
    if name:
        global_scope().set_var(name, t)
    return t


def _print_impl(x, message, summarize):
    flat = x.detach().reshape(-1)[:summarize]
    print((message + " " if message else "") + str(flat.cpu().tolist()),
          flush=True)
    return x.clone()


_print_impl.host_read = True


def Print(input, first_n=-1, message=None, summarize=20,  # noqa: A002,N802
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=False,
          print_phase="both"):
    """Debug print op (reference controlflow/print_op.cc): prints the
    tensor's first ``summarize`` values when the op runs and passes the
    value through. The print reads the value on the host, so a program
    holding it runs uncaptured."""
    return apply_op(_print_impl, input, message=message or "",
                    summarize=int(summarize), op_name="Print")


def _accuracy(pred, label, k):
    idx = torch.topk(pred, k, dim=-1).indices
    if label.dim() == pred.dim() and label.shape[-1] == 1:
        label = label[..., 0]
    corr = (idx == label.unsqueeze(-1).to(idx.dtype)).any(dim=-1)
    return corr.float().mean()


def accuracy(input, label, k=1, correct=None, total=None, name=None):  # noqa: A002
    """Top-k accuracy (reference metric accuracy_op): on a placeholder,
    an op of the program; on values, ``paddle.metric.accuracy``."""
    if isinstance(input, SymbolicTensor) or isinstance(label, SymbolicTensor):
        return apply_op(_accuracy, input, label, k=int(k), op_name="accuracy")
    from ..metric import accuracy as _eager

    return _eager(input, label, k, correct, total, name)


def _trapezoid(y, x):
    return torch.trapezoid(y, x)


def _auc(scores, lab, num_thresholds, curve):
    pos_score = scores[:, 1] if scores.dim() == 2 else scores.reshape(-1)
    lab = lab.reshape(-1)
    bins = torch.clamp((pos_score * num_thresholds).to(torch.int32), 0,
                       num_thresholds).long()
    n = num_thresholds + 1
    pos = torch.zeros(n, dtype=torch.float32, device=scores.device
                      ).index_add_(0, bins, (lab == 1).float())
    neg = torch.zeros(n, dtype=torch.float32, device=scores.device
                      ).index_add_(0, bins, (lab == 0).float())
    tp = torch.flip(torch.cumsum(torch.flip(pos, [0]), 0), [0])
    fp = torch.flip(torch.cumsum(torch.flip(neg, [0]), 0), [0])
    tot_pos, tot_neg = tp[0], fp[0]
    tpr = tp / torch.clamp(tot_pos, min=1)
    if curve == "PR":
        precision = tp / torch.clamp(tp + fp, min=1)
        a = _trapezoid(torch.flip(precision, [0]), torch.flip(tpr, [0]))
    else:
        fpr = fp / torch.clamp(tot_neg, min=1)
        a = _trapezoid(torch.flip(tpr, [0]), torch.flip(fpr, [0]))
    return a, a.clone(), tp, fp, tot_neg - fp, tot_pos - tp


def auc(input, label, curve="ROC", num_thresholds=4095,  # noqa: A002
        topk=1, slide_steps=1, ins_tag_weight=None):
    """Batch AUC by threshold histogram (reference metrics/auc_op.cc, the
    bucketed trapezoid estimate): (auc, batch_auc, (tp, fp, tn, fn))."""
    if curve not in ("ROC", "PR"):
        raise ValueError("curve must be 'ROC' or 'PR'")
    out = apply_op(_auc, input, label, num_thresholds=int(num_thresholds),
                   curve=curve, op_name="auc")
    return out[0], out[1], tuple(out[2:])


# -- program state ------------------------------------------------------------------

def _state_names(params):
    return [t.name or f"param_{i}" for i, t in enumerate(params)]


def save(program, model_path, protocol=4, **configs):
    """A program's parameters to <path>.pdparams and the optimizer state
    of its minimize()'d optimizers to <path>.pdopt (reference
    static/io.py save), in the format ``paddle.save`` writes."""
    from ..framework.io import save as _save

    params = program.all_parameters()
    names = _state_names(params)
    dup = {n for n in names if names.count(n) > 1}
    if dup:
        raise ValueError(
            "static.save: duplicate parameter names %s — give layers "
            "unique name= arguments" % sorted(dup))
    # numpy arrays, as the JAX package writes them (bf16 stays a Tensor:
    # numpy has no bf16)
    _save({n: (t if t.dtype == torch.bfloat16 else t.numpy())
           for n, t in zip(names, params)}, model_path + ".pdparams")
    opt_state = {}
    for i, (optimizer, _loss) in enumerate(getattr(program, "train_specs",
                                                   [])):
        for k, v in optimizer.state_dict().items():
            opt_state[f"opt{i}.{k}"] = v
    _save(opt_state, model_path + ".pdopt")


def _set_state(program, state, var_list=None):
    params = program.all_parameters()
    by_name = dict(zip(_state_names(params), params))
    keep = (None if var_list is None
            else {getattr(v, "name", v) for v in var_list})
    for name, arr in state.items():
        if keep is not None and name not in keep:
            continue
        if name in by_name:
            by_name[name].set_value(_np(arr))


def _np(v):
    return v.numpy() if isinstance(v, Tensor) else np.asarray(v)


def load(program, model_path, executor=None, var_list=None):
    """Parameters saved by ``static.save`` (this package's or the JAX
    package's file) into the program's captured tensors, matched by
    name; the optimizer state from the .pdopt companion when present."""
    import re
    import warnings

    from ..framework.io import load as _load

    _set_state(program, _load(model_path + ".pdparams"), var_list)
    if var_list is not None or not os.path.exists(model_path + ".pdopt"):
        return
    opt_state = _load(model_path + ".pdopt")
    specs = getattr(program, "train_specs", [])
    has_prefixed = any(re.match(r"opt\d+\.", k) for k in opt_state)
    for i, (optimizer, _loss) in enumerate(specs):
        prefix = f"opt{i}."
        sd = {k[len(prefix):]: v for k, v in opt_state.items()
              if k.startswith(prefix)}
        if not sd and i == 0 and opt_state and not has_prefixed:
            sd = dict(opt_state)
        if sd:
            optimizer.set_state_dict(sd)
        elif opt_state:
            warnings.warn(
                f"static.load: no optimizer-state entries under prefix "
                f"'{prefix}' in {model_path}.pdopt (checkpoint has "
                f"{len(opt_state)} entries) — optimizer spec {i} keeps its "
                f"current state")


def load_program_state(model_path, var_list=None):
    from ..framework.io import load as _load

    return {k: _np(v) for k, v in _load(model_path + ".pdparams").items()}


def set_program_state(program, state_dict):
    _set_state(program, state_dict)


def save_to_file(path, content):
    with open(path, "wb") as f:
        f.write(content)


def load_from_file(path):
    with open(path, "rb") as f:
        return f.read()


from ..framework.param_attr import WeightNormParamAttr  # noqa: F401,E402
from . import nn  # noqa: F401,E402
