"""The training step on one device, and the pure optimizers.

Counterpart of ``paddle_tpu/parallel/train_step.py``. The optimizers keep
the JAX package's signatures, state layouts and op order (AdamW's
decoupled decay is applied BEFORE the Adam step, classic L2 is added to
the gradient before the moments, the math is f32 whatever the storage
dtype). Unlike the JAX functions, which return new trees, they run under
``torch.no_grad()`` and update the param and state tensors IN PLACE
(a 1.3B-parameter model's f32 weights, grads and moments would otherwise
exist twice); each still returns ``(params, state)`` for signature
parity. Trees are nested dicts of tensors.

:class:`DistributedTrainStep` is the JAX class's one-device case (the
JAX step sets ``zero_level = 0`` when the sharding degree is 1): loss and
grads by autograd, the optional global-norm clip, the optimizer update.
With ``FLAGS_fused_optimizer`` set, ``"adamw"`` and ``"lamb"`` take the
fused kernels' updates (``ops/fused_optimizer.py``), with the same state
layout, as the JAX step does.

``sentinel=True`` (or a config dict, ``resilience/sentinel.py``) arms
the in-step health verdict: the raw f32 global grad norm (taken before
any clip; the clip reuses it) and the loss update a device-resident
sentinel state, and a tripped step changes nothing: the fused kernels
read the verdict as their skip flag, the pure optimizers' new values are
selected against copies taken before the update (``torch.where``), and
the count stays. No host read decides it. The step's loss carries
``.health`` (``{"trip", "trips"}``, device scalars). Under
``FLAGS_fault_inject`` the step calls the registry's train-step hook
(``resilience/faults.py``) with its step index before it runs.

A mesh of more than one device, ``aux`` state and dynamic loss scaling
raise ``NotImplementedError`` until the multi-GPU slice (ROADMAP.md
Queue 1 item 7); dynamic loss scaling will gate through the same skip
flag.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .. import resolve_device
from ..core import flags
from ..framework import random as _random
from ..monitor.stats import TRAIN_STEPS
from ..ops.fused_optimizer import fused_adamw_update, fused_lamb_update
from ..resilience import faults as _faults
from ..resilience import sentinel as _sentinel

__all__ = ["DistributedTrainStep", "pure_adamw_init", "pure_adamw_update",
           "pure_sgd_init", "pure_sgd_update", "pure_momentum_init",
           "pure_momentum_update", "pure_lamb_init", "pure_lamb_update",
           "pure_lars_init", "pure_lars_update", "global_norm_clip"]


# -- trees (nested dicts of tensors) ----------------------------------------

def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    else:
        yield prefix, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _put(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _count(params):
    first = next(_paths(params))[1]
    return torch.zeros((), dtype=torch.int32, device=first.device)


def _in_place(tree, path, old, new):
    """Store ``new`` over ``old`` (same dtype: copy into it; another
    dtype: replace the tree entry)."""
    if new is old:
        return
    if new.dtype == old.dtype:
        old.copy_(new)
    else:
        _put(tree, path, new)


# -- pure optimizers (tree-level, in place) ---------------------------------

def pure_adamw_init(params, mv_dtype=torch.float32):
    """m/v default to f32 whatever the param dtype (the update math is
    always f32); ``mv_dtype=torch.bfloat16`` halves their memory."""
    zeros = lambda t: _map(lambda x: torch.zeros(x.shape, dtype=mv_dtype,
                                                 device=x.device), t)
    return {"m": zeros(params), "v": zeros(params), "count": _count(params)}


@torch.no_grad()
def pure_adamw_update(params, grads, state, lr, beta1=0.9, beta2=0.999,
                      eps=1e-8, weight_decay=0.01, l2_coeff=0.0,
                      mv_dtype=None, decay_mask=None):
    """AdamW, in place. weight_decay is the decoupled decay; l2_coeff is
    classic Adam's grad-side L2 (added before the moments). mv_dtype:
    storage dtype of the moments (None keeps what pure_adamw_init
    allocated); the math is f32 either way. decay_mask: optional tree of
    bools matching params, False leaves skip the decoupled decay."""
    state["count"] += 1
    c = state["count"].float()
    bc1 = 1.0 - beta1 ** c
    bc2 = 1.0 - beta2 ** c
    for path, p in _paths(params):
        g, m, v = (_get(t, path) for t in (grads, state["m"], state["v"]))
        wd = weight_decay if decay_mask is None or _get(decay_mask, path) \
            else 0.0
        store = m.dtype if mv_dtype is None else mv_dtype
        g32 = g.float()
        if l2_coeff:
            g32 = g32 + l2_coeff * p.float()
        m32 = m if m.dtype == torch.float32 else m.float()
        v32 = v if v.dtype == torch.float32 else v.float()
        m32.mul_(beta1).add_((1 - beta1) * g32)
        v32.mul_(beta2).add_((1 - beta2) * (g32 * g32))
        step = (m32 / bc1) / (torch.sqrt(v32 / bc2) + eps)
        # decay BEFORE the adam step, matching the reference op order
        p32 = p.float() * (1.0 - lr * wd)
        p.copy_(p32 - lr * step)
        _in_place(state["m"], path, m, m32.to(store))
        _in_place(state["v"], path, v, v32.to(store))
    return params, state


def pure_lamb_init(params):
    return pure_adamw_init(params)


@torch.no_grad()
def pure_lamb_update(params, grads, state, lr, beta1=0.9, beta2=0.999,
                     eps=1e-6, weight_decay=0.01, decay_mask=None, **_):
    """LAMB, in place: Adam moments, direction r = m̂/(√v̂+ε) + λp, then a
    per-parameter trust ratio ‖p‖/‖r‖ (1 when either norm is 0) rescales
    lr. decay_mask=False leaves λ=0 for that leaf."""
    state["count"] += 1
    c = state["count"].float()
    bc1 = 1.0 - beta1 ** c
    bc2 = 1.0 - beta2 ** c
    for path, p in _paths(params):
        g, m, v = (_get(t, path) for t in (grads, state["m"], state["v"]))
        wd = weight_decay if decay_mask is None or _get(decay_mask, path) \
            else 0.0
        g32 = g.float()
        p32 = p.float()
        m.mul_(beta1).add_((1 - beta1) * g32)
        v.mul_(beta2).add_((1 - beta2) * (g32 * g32))
        r = (m / bc1) / (torch.sqrt(v / bc2) + eps) + wd * p32
        p_norm = torch.sqrt(torch.sum(torch.square(p32)))
        r_norm = torch.sqrt(torch.sum(torch.square(r)))
        trust = torch.where((p_norm > 0) & (r_norm > 0), p_norm / r_norm,
                            torch.ones_like(p_norm))
        p.copy_(p32 - lr * trust * r)
    return params, state


def pure_lars_init(params):
    return pure_momentum_init(params)


@torch.no_grad()
def pure_lars_update(params, grads, state, lr, momentum=0.9,
                     lars_coeff=0.001, lars_weight_decay=0.0005,
                     epsilon=0.0, **_):
    """LARS momentum, in place: per-parameter local_lr = lr·coeff·‖p‖ /
    (‖g‖ + λ‖p‖ + ε) when λ>0 and both norms are >0, else the global lr;
    velocity over the L2-regularized gradient."""
    for path, p in _paths(params):
        g, v = _get(grads, path), _get(state["velocity"], path)
        g32 = g.float()
        p32 = p.float()
        p_norm = torch.sqrt(torch.sum(torch.square(p32)))
        g_norm = torch.sqrt(torch.sum(torch.square(g32)))
        live = (p_norm > 0) & (g_norm > 0) & bool(lars_weight_decay > 0)
        local_lr = torch.where(
            live, lr * lars_coeff * p_norm
            / (g_norm + lars_weight_decay * p_norm + epsilon),
            torch.full_like(p_norm, lr))
        v.mul_(momentum).add_(local_lr * (g32 + lars_weight_decay * p32))
        p.copy_(p32 - v)
    state["count"] += 1
    return params, state


def pure_sgd_init(params):
    return {"count": _count(params)}


@torch.no_grad()
def pure_sgd_update(params, grads, state, lr, weight_decay=0.0, **_):
    for path, p in _paths(params):
        g32 = _get(grads, path).float()
        if weight_decay:
            g32 = g32 + weight_decay * p.float()
        p.copy_(p.float() - lr * g32)
    state["count"] += 1
    return params, state


def pure_momentum_init(params):
    # velocity in f32, like adamw's m/v (see pure_adamw_init)
    return {"velocity": _map(lambda x: torch.zeros(x.shape,
                                                   dtype=torch.float32,
                                                   device=x.device), params),
            "count": _count(params)}


@torch.no_grad()
def pure_momentum_update(params, grads, state, lr, momentum=0.9,
                         use_nesterov=False, weight_decay=0.0):
    """SGD with (Nesterov) momentum, in place."""
    for path, p in _paths(params):
        g32 = _get(grads, path).float()
        v = _get(state["velocity"], path)
        p32 = p.float()
        if weight_decay:
            g32 = g32 + weight_decay * p32
        v.mul_(momentum).add_(g32)
        if use_nesterov:
            p.copy_(p32 - lr * (g32 + momentum * v))
        else:
            p.copy_(p32 - lr * v)
    state["count"] += 1
    return params, state


@torch.no_grad()
def global_norm_clip(grads, clip_norm: float, norm=None):
    """Global-norm clip across the whole param set: (clipped grads, norm).
    Returns a new tree; the grads given are not changed. ``norm``: the
    grads' global norm when the caller has it already (the sentinel's)."""
    if norm is None:
        sq = sum(torch.sum(torch.square(g.float()))
                 for _, g in _paths(grads))
        norm = torch.sqrt(sq)
    scale = torch.clamp(clip_norm / (norm + 1e-6), max=1.0)
    return _map(lambda g: (g * scale).to(g.dtype), grads), norm


_OPTS = {
    "adamw": (pure_adamw_init, pure_adamw_update),
    "sgd": (pure_sgd_init, pure_sgd_update),
    "momentum": (pure_momentum_init, pure_momentum_update),
    "lamb": (pure_lamb_init, pure_lamb_update),
    "lars": (pure_lars_init, pure_lars_update),
}


def _unported(what: str):
    raise NotImplementedError(
        f"DistributedTrainStep: {what} is not ported to paddle_tpu_torch "
        f"yet (see ROADMAP.md)")


def _mesh_devices(mesh) -> int:
    size = getattr(mesh, "size", None)
    if callable(size):
        return int(size())
    devices = getattr(mesh, "devices", None)
    return int(np.asarray(devices).size) if devices is not None else 1


def _to_device(batch, device):
    if isinstance(batch, (tuple, list)):
        return type(batch)(_to_device(b, device) for b in batch)
    if isinstance(batch, dict):
        return {k: _to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, torch.Tensor):
        return batch.to(device)
    return torch.as_tensor(np.asarray(batch)).to(device)


class DistributedTrainStep:
    """loss + autograd grads + optional clip + optimizer, on one device.

    Args (the JAX class's, for its one-device case):
      loss_fn: ``(params, batch) -> scalar loss`` tensor.
      params: param tree (nested dicts of tensors); copied onto
        ``device`` as the step's own leaves, so the caller's tensors are
        never updated.
      param_specs, batch_spec, zero, zero_min_size: placement arguments
        of the sharded step; with one device there is nothing to place
        (ZeRO level 0, as the JAX step sets at sharding degree 1).
      optimizer: "adamw" | "sgd" | "momentum" | "lamb" | "lars" | an
        ``(init_fn, update_fn)`` pair.
      lr: a float, or a callable ``step_index -> float`` (schedule).
      clip_norm: optional global-norm clip.
      opt_kwargs: keyword arguments of the update function.
      mesh: None or a one-device mesh.
      device: None runs on the card (and raises without one); "cpu"
        runs every kernel's plain PyTorch version.
    """

    def __init__(self, loss_fn: Callable, params, param_specs=None,
                 optimizer="adamw", lr=1e-3, batch_spec=None,
                 clip_norm: Optional[float] = None, zero=True, mesh=None,
                 opt_kwargs: Optional[dict] = None, aux=None, aux_specs=None,
                 dynamic_scale: Optional[dict] = None, sentinel=None,
                 zero_min_size: int = 2 ** 12, device=None):
        if mesh is not None and _mesh_devices(mesh) > 1:
            _unported("a mesh of more than one device (and ZeRO across it)")
        if aux is not None or aux_specs is not None:
            _unported("aux (non-trainable state threaded through the step)")
        if dynamic_scale:
            _unported("dynamic loss scaling")
        if isinstance(optimizer, str):
            init_fn, update_fn = _OPTS[optimizer]
            if flags.fused_optimizer[0] and optimizer in ("adamw", "lamb"):
                # same init and state layout, the update as one fused
                # kernel pass per bucket
                update_fn = (fused_adamw_update if optimizer == "adamw"
                             else fused_lamb_update)
        else:
            init_fn, update_fn = optimizer
        self.device = resolve_device(device)
        self.param_specs = param_specs
        self.zero_level = 0
        self._loss_fn = loss_fn
        self._update_fn = update_fn
        self._lr = lr
        self._clip = clip_norm
        self._opt_kwargs = dict(opt_kwargs or {})
        # the step's own leaves: the updates write into them in place
        self.params = _map(
            lambda t: torch.as_tensor(t).detach().to(self.device, copy=True)
            .requires_grad_(True), params)
        with torch.no_grad():
            self.opt_state = init_fn(self.params)
        self._step_count = 0
        self._lr_scale = 1.0
        # the fused updates gate themselves on the verdict (the kernel's
        # skip flag); a pure update is gated against copies
        self._gates_itself = update_fn in (fused_adamw_update,
                                           fused_lamb_update)
        self._sentinel_cfg = (_sentinel.normalize_config(sentinel)
                              if sentinel else None)
        self.sentinel_state = (_sentinel.init_state(self.device)
                               if self._sentinel_cfg is not None else None)

    def current_lr(self) -> float:
        if callable(self._lr):
            return float(self._lr(self._step_count)) * self._lr_scale
        return float(self._lr) * self._lr_scale

    def scale_lr(self, scale: float) -> None:
        """Set the ABSOLUTE learning-rate multiplier (schedules keep their
        shape, scaled)."""
        self._lr_scale = float(scale)

    def __call__(self, batch):
        """One step; returns the loss (a detached 0-dim tensor on the
        device, not synchronised; with the sentinel armed it carries
        ``.health``)."""
        if _faults.ENABLED[0]:
            # crash / stall / preempt, or a NaN batch (nan_grad)
            batch = _faults.FAULTS.on_train_step(self._step_count, batch)
        lr = self.current_lr()
        batch = _to_device(batch, self.device)
        leaves = list(_paths(self.params))
        loss = self._loss_fn(self.params, batch)
        grads = torch.autograd.grad(loss, [p for _, p in leaves],
                                    allow_unused=True)
        gtree = _map(lambda t: t, self.params)
        for (path, p), g in zip(leaves, grads):
            _put(gtree, path, torch.zeros_like(p) if g is None else g)
        del grads
        trip = None
        norm = None
        if self.sentinel_state is not None:
            # the raw norm: a clip would cap the spikes the verdict reads
            norm = _sentinel.global_grad_norm(gtree)
            _sentinel.update(self.sentinel_state, loss, norm,
                             self._sentinel_cfg)
            trip = self.sentinel_state["last_trip"]
        if self._clip is not None:
            gtree, _ = global_norm_clip(gtree, self._clip, norm)
        with torch.no_grad():
            kw = dict(self._opt_kwargs)
            olds = None
            if trip is not None and self._gates_itself:
                kw["skip"] = trip
            elif trip is not None:
                olds = {"p": [p.detach().clone() for _, p in leaves],
                        "s": [(path, t.clone())
                              for path, t in _paths(self.opt_state)]}
            new_params, self.opt_state = self._update_fn(
                self.params, gtree, self.opt_state, lr, **kw)
            if new_params is not self.params:
                # a functional (init, update) pair returns new leaves
                for path, p in leaves:
                    p.copy_(_get(new_params, path))
            if olds is not None:
                _sentinel.gate_(trip, [p for _, p in leaves], olds["p"])
                for path, old in olds["s"]:
                    new = _get(self.opt_state, path)
                    if new.dtype == old.dtype:
                        new.copy_(torch.where(trip, old, new))
                    else:
                        _put(self.opt_state, path,
                             torch.where(trip, old.to(new.dtype), new))
        self._step_count += 1
        TRAIN_STEPS.add()
        out = loss.detach()
        if self.sentinel_state is not None:
            # this step's verdict (the state itself is updated in place)
            out.health = {"trip": self.sentinel_state["last_trip"].clone(),
                          "trips": self.sentinel_state["trips"].clone()}
        return out

    def state_dict(self) -> dict:
        """Host snapshot {params, opt_state, step, rng} (CPU tensors; rng
        the step device's generator state), with ``sentinel`` when the
        sentinel is armed."""
        host = lambda tree: _map(lambda t: t.detach().cpu().clone(), tree)
        out = {"params": host(self.params),
               "opt_state": host(self.opt_state),
               "step": self._step_count,
               "rng": _random.get_rng_state(self.device)}
        if self.sentinel_state is not None:
            out["sentinel"] = host(self.sentinel_state)
        return out

    def set_state_dict(self, state: dict) -> None:
        """Restore a state_dict: values are copied into the step's own
        device tensors (never rebound)."""
        with torch.no_grad():
            for path, p in _paths(self.params):
                p.copy_(torch.as_tensor(_get(state["params"], path)))
            for path, t in _paths(self.opt_state):
                t.copy_(torch.as_tensor(_get(state["opt_state"], path)))
            if self.sentinel_state is not None and "sentinel" in state:
                for k, t in self.sentinel_state.items():
                    t.copy_(torch.as_tensor(state["sentinel"][k]))
        if "rng" in state:
            _random.set_rng_state(state["rng"], self.device)
        self._step_count = int(state.get("step", self._step_count))
