"""Health verdicts (``paddle_tpu/resilience/sentinel.py``).

The training half is the in-step health verdict: inside the train step
(captured CUDA graph included) :func:`update` reads the loss and the raw
global grad norm, decides whether the step is healthy (both finite, and
no EMA z-score spike on the norm once ``warmup`` healthy steps have
been seen), and the step gates its update on the verdict, GradScaler
style: a tripped step leaves params, optimizer state and buffers as
they were. Everything stays on the device and branch-free
(``torch.where``), so the verdict costs no host read: the guardian
decides when to look (:func:`read_health`).

State (device scalars, carried across steps and updated in place)::

    {"mean": EMA of grad norm (f32), "var": EMA of squared deviation
     (f32), "n": healthy steps observed (int32), "trips": cumulative
     verdict trips (int32), "last_trip": last step's verdict (bool)}

Verdict = NOT finite(loss, grad_norm) OR (n >= warmup AND
|gnorm - mean| / sqrt(var + eps) > z_thresh). The EMA only absorbs
healthy steps, so a spike does not poison the baseline it is measured
against.

:func:`logits_finite` is the serving engine's NaN sentinel: one bool a
row, True when every logit of the row is finite. The engine's decode
ticks compute it on the device beside the sampled tokens when
``InferenceEngine(watchdog=...)`` is armed, and it reaches the host in
the same device-to-host copy as the tokens, so an armed tick adds no
synchronisation.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

__all__ = ["default_config", "normalize_config", "init_state",
           "reset_state", "update", "global_grad_norm", "gate", "gate_",
           "read_health", "logits_finite"]


def logits_finite(logits: torch.Tensor) -> torch.Tensor:
    """Per-row all-finite verdict over a ``(batch, ...)`` logits block:
    a ``(batch,)`` bool tensor on the logits' device."""
    return torch.isfinite(logits).reshape(logits.shape[0], -1).all(-1)


def default_config(z_thresh: float = 8.0, warmup: int = 20,
                   ema_decay: float = 0.98) -> Dict[str, float]:
    """Sentinel hyperparameters. ``z_thresh`` in EMA standard deviations;
    ``warmup`` healthy steps before the spike test arms (finiteness is
    always armed); ``ema_decay`` the baseline's smoothing factor."""
    return {"z_thresh": float(z_thresh), "warmup": int(warmup),
            "ema_decay": float(ema_decay)}


def normalize_config(cfg) -> Dict[str, float]:
    """None/True/partial-dict → full config."""
    if cfg is None or cfg is True:
        return default_config()
    out = default_config()
    out.update({k: v for k, v in dict(cfg).items() if k in out})
    return out


def init_state(device=None) -> Dict[str, torch.Tensor]:
    """A fresh state on ``device`` (the reference's dtypes)."""
    z = lambda dt: torch.zeros((), dtype=dt, device=device)
    return {"mean": z(torch.float32), "var": z(torch.float32),
            "n": z(torch.int32), "trips": z(torch.int32),
            "last_trip": z(torch.bool)}


def reset_state(state: Dict[str, torch.Tensor]) -> None:
    """Zero a state in place (a captured step keeps its addresses)."""
    for t in state.values():
        t.zero_()


@torch.no_grad()
def global_grad_norm(grads) -> torch.Tensor:
    """f32 global L2 norm over grads (a dict tree, a list, or one
    tensor): each leaf cast to f32 before squaring, summed from an f32
    zero in the reference's leaf order (dict keys sorted)."""
    leaves = list(_leaves(grads))
    sq = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for g in leaves:
        sq = sq + torch.sum(torch.square(g.float()))
    return torch.sqrt(sq)


def _leaves(tree):
    # dicts in sorted key order, as JAX flattens them
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


@torch.no_grad()
def update(state, loss, gnorm, cfg) -> Dict[str, torch.Tensor]:
    """One verdict: writes the new state INTO ``state`` (branch-free, so
    it can be captured) and returns it; ``state["last_trip"]`` is the
    verdict."""
    loss32 = torch.as_tensor(loss).detach().float().reshape(())
    g = torch.as_tensor(gnorm).float().reshape(())
    finite = torch.isfinite(loss32) & torch.isfinite(g)
    mean, var, n = state["mean"], state["var"], state["n"]
    z = torch.abs(g - mean) / torch.sqrt(var + 1e-12)
    spike = (n >= int(cfg["warmup"])) & (z > float(cfg["z_thresh"]))
    trip = (~finite) | spike
    d = float(cfg["ema_decay"])
    new_mean = d * mean + (1.0 - d) * g
    new_var = d * var + (1.0 - d) * torch.square(g - mean)
    healthy = ~trip
    mean_out = torch.where(healthy, new_mean, mean)
    var_out = torch.where(healthy, new_var, var)
    n_out = torch.where(healthy, n + 1, n)
    state["trips"].add_(trip.to(torch.int32))
    mean.copy_(mean_out)
    var.copy_(var_out)
    n.copy_(n_out)
    state["last_trip"].copy_(trip)
    return state


@torch.no_grad()
def gate(trip, new_tree, old_tree):
    """GradScaler-style skip, out of place: ``old_tree`` wherever the
    verdict tripped (one ``torch.where`` a leaf)."""
    if new_tree is None:
        return None
    if isinstance(new_tree, dict):
        return {k: gate(trip, v, old_tree[k]) for k, v in new_tree.items()}
    if isinstance(new_tree, (list, tuple)):
        return type(new_tree)(gate(trip, a, b)
                              for a, b in zip(new_tree, old_tree))
    return torch.where(trip, old_tree, new_tree)


@torch.no_grad()
def gate_(trip, tensors, olds) -> None:
    """In-place skip: each tensor becomes its old value where the verdict
    tripped (the port updates in place, so the old values are copies
    taken before the update)."""
    for t, o in zip(tensors, olds):
        t.copy_(torch.where(trip, o, t))


def read_health(state) -> Optional[dict]:
    """Host-side view of a sentinel state (device scalars, reading
    blocks): {"trip": bool, "trips": int, "gnorm_mean": float}."""
    if state is None:
        return None
    return {"trip": bool(state["last_trip"]),
            "trips": int(state["trips"]),
            "gnorm_mean": float(state["mean"])}
