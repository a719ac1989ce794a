"""Optimizers of the eager Paddle surface.

Counterpart of ``paddle_tpu/optimizer/optimizer.py`` (``Optimizer``,
``SGD``, ``Momentum``, ``Adam``, ``AdamW``, ``Lamb``): the same slot
names and conventions (``moment1``, ``moment2``, ``beta1_pow`` and
``beta2_pow`` holding βᵗ when the step runs; ``velocity``), the same
update formulas, so ``state_dict()`` carries the JAX package's keys.
``step()`` updates every parameter and slot IN PLACE under
``torch.no_grad()``, one parameter at a time; with
``FLAGS_fused_optimizer=1`` Adam, AdamW and Lamb take
``ops/fused_optimizer.py``'s ``fused_eager_step`` instead (one AdamW or
LAMB kernel launch per bucket on the card), as in the JAX package.
``learning_rate`` is a number: LR schedulers and ``grad_clip`` are not
ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import flags
from ..framework.core import Tensor, _as_torch
from ..regularizer import L1Decay, L2Decay

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Lamb"]


def _f32(v) -> float:
    """A Python float rounded to f32, as a JAX f32 scalar holds it."""
    return float(np.float32(v))


def _weak(c, t) -> float:
    """A Python scalar as ``jnp`` applies it to the tensor ``t``: rounded
    to t's dtype first (0.1 is 0.10009765625 beside a bf16 tensor)."""
    return torch.tensor(c, dtype=t.dtype).item()


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError("paddle_tpu_torch optimizers take a "
                                      "number as learning_rate (LR "
                                      "schedulers are not ported yet)")
        if grad_clip is not None:
            raise NotImplementedError("grad_clip is not ported to "
                                      "paddle_tpu_torch yet")
        self._learning_rate = float(learning_rate)
        self._parameter_list = (list(parameters) if parameters is not None
                                else None)
        self._weight_decay = (L2Decay(weight_decay)
                              if isinstance(weight_decay, float)
                              else weight_decay)
        # slot store: name -> {id(param): torch tensor}
        self._accumulators: dict = {}
        self._fused_state = None
        self._slots_stale = False

    # -- lr -----------------------------------------------------------------
    def get_lr(self):
        return self._learning_rate

    # -- slots --------------------------------------------------------------
    def _slot_names(self):
        return []

    def _init_slot(self, name, p):
        return torch.zeros_like(p._data, requires_grad=False)

    def _get_slots(self, p):
        out = []
        for name in self._slot_names():
            store = self._accumulators.setdefault(name, {})
            if id(p) not in store:
                store[id(p)] = self._init_slot(name, p)
            out.append(store[id(p)])
        return out

    # -- update -------------------------------------------------------------
    def _update(self, p, g, lr, slots, **hyper):
        """Update the torch tensor ``p`` and its slots in place."""
        raise NotImplementedError

    def _hyper(self, p):
        """Per-parameter hyperparameters (dict)."""
        return {}

    def _decoupled_wd(self):
        return False

    def _fused_supported(self) -> bool:
        """Has this optimizer a fused eager step
        (``ops/fused_optimizer.py``, FLAGS_fused_optimizer)?"""
        return False

    def _regularized_grad(self, p, g):
        reg = (p.regularizer if p.regularizer is not None
               else self._weight_decay)
        if isinstance(reg, L2Decay) and not self._decoupled_wd():
            return g + reg.coeff * p._data
        if isinstance(reg, L1Decay):
            return g + reg.coeff * torch.sign(p._data)
        return g

    @torch.no_grad()
    def step(self):
        params_grads = [(p, p.grad) for p in self._parameter_list or []
                        if p.grad is not None
                        and getattr(p, "trainable", True)]
        lr = self.get_lr()
        if flags.fused_optimizer[0] and self._fused_supported():
            from ..ops.fused_optimizer import fused_eager_step

            if fused_eager_step(self, params_grads, lr):
                return
        for p, g in params_grads:
            g = self._regularized_grad(p, g._data.to(p.dtype))
            plr = lr * p.optimize_attr.get("learning_rate", 1.0)
            self._update(p._data, g, plr, self._get_slots(p),
                         **self._hyper(p))

    def clear_grad(self, set_to_zero=True):
        for p in self._parameter_list or []:
            p.clear_grad()

    def state_dict(self):
        if self._fused_state is not None and self._slots_stale:
            # the fused step keeps one beta-pow pair for all its params
            self._fused_state.sync_slots(self)
            self._slots_stale = False
        state = {}
        for name, store in self._accumulators.items():
            for p in self._parameter_list or []:
                if id(p) in store:
                    pname = p.name or f"param_{id(p)}"
                    state[f"{pname}.{name}"] = Tensor(store[id(p)])
        return state

    def set_state_dict(self, state_dict):
        for name in self._slot_names():
            store = self._accumulators.setdefault(name, {})
            for p in self._parameter_list or []:
                key = f"{p.name or f'param_{id(p)}'}.{name}"
                if key in state_dict:
                    v = state_dict[key]
                    v = v._data if isinstance(v, Tensor) else v
                    if not isinstance(v, torch.Tensor):
                        v = _as_torch(v, device=p._data.device)
                    store[id(p)] = v.detach().to(p._data.device).clone()
        # loaded slots supersede the fused step's layout; rebuilt lazily
        self._fused_state = None
        self._slots_stale = False


class SGD(Optimizer):
    def _update(self, p, g, lr, slots):
        p.copy_(p - _f32(lr) * g)


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None, multi_precision=False, rescale_grad=1.0):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._momentum = float(momentum)
        self._use_nesterov = bool(use_nesterov)

    def _slot_names(self):
        return ["velocity"]

    def _hyper(self, p):
        return {"mu": self._momentum, "nesterov": self._use_nesterov}

    def _update(self, p, g, lr, slots, mu, nesterov):
        (v,) = slots
        # the rate in the parameter's dtype, as the reference casts it;
        # the velocity is p's dtype too
        lr, mu = _weak(lr, p), _weak(mu, v)
        v.copy_(mu * v + g)
        p.copy_(p - (g + mu * v) * lr if nesterov else p - v * lr)


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)
        self._multi_precision = bool(multi_precision)

    def _slot_names(self):
        return ["moment1", "moment2", "beta1_pow", "beta2_pow"]

    def _init_slot(self, name, p):
        if name in ("beta1_pow", "beta2_pow"):
            beta = self._beta1 if name == "beta1_pow" else self._beta2
            return torch.full((), beta, dtype=torch.float32,
                              device=p._data.device)
        if self._multi_precision and p._data.element_size() < 4:
            # f32 master moments for low-precision params
            return torch.zeros(p._data.shape, dtype=torch.float32,
                               device=p._data.device)
        return torch.zeros_like(p._data, requires_grad=False)

    def _fused_supported(self):
        return type(self) in (Adam, AdamW)

    def _hyper(self, p):
        return {"b1": self._beta1, "b2": self._beta2, "eps": self._epsilon}

    @staticmethod
    def _adam(p, g, lr, slots, b1, b2, eps):
        m1, m2, b1p, b2p = slots
        # jnp rounds each scalar to the dtype of the tensor beside it; the
        # reference's fused update then takes (1 - β)·g and (1 - β)·g² of a
        # bf16 gradient into f32 master moments (multi_precision) without
        # rounding those products to bf16 (g² itself is rounded)
        sq = torch.square(g)
        m1.copy_(_weak(b1, m1) * m1 + _weak(1 - b1, g) * g.to(m1.dtype))
        m2.copy_(_weak(b2, m2) * m2 + _weak(1 - b2, g) * sq.to(m2.dtype))
        lr_t = _f32(lr) * torch.sqrt(1 - b2p) / (1 - b1p)
        p.copy_(p - (lr_t * m1 / (torch.sqrt(m2) + eps)).to(p.dtype))
        b1p.mul_(b1)
        b2p.mul_(b2)

    def _update(self, p, g, lr, slots, b1, b2, eps):
        self._adam(p, g, lr, slots, b1, b2, eps)


class AdamW(Adam):
    """Decoupled weight decay: ``p *= 1 - lr * coeff`` before the Adam
    step."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision, name)
        self._coeff = (float(weight_decay)
                       if isinstance(weight_decay, (int, float))
                       else weight_decay.coeff)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decoupled_wd(self):
        return True

    def _hyper(self, p):
        coeff = self._coeff
        if (self._apply_decay_param_fun is not None
                and not self._apply_decay_param_fun(p.name)):
            coeff = 0.0
        return {"b1": self._beta1, "b2": self._beta2, "eps": self._epsilon,
                "coeff": coeff}

    def _update(self, p, g, lr, slots, b1, b2, eps, coeff):
        p.mul_(_f32(np.float32(1.0) - np.float32(lr) * np.float32(coeff)))
        self._adam(p, g, lr, slots, b1, b2, eps)


class Lamb(Optimizer):
    """LAMB: the Adam direction plus decoupled decay, scaled per
    parameter by the trust ratio ‖p‖/‖r‖."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)
        self._lamb_wd = float(lamb_weight_decay)
        self._exclude_fn = exclude_from_weight_decay_fn

    def _fused_supported(self):
        return type(self) is Lamb

    def _slot_names(self):
        return ["moment1", "moment2", "beta1_pow", "beta2_pow"]

    _init_slot = Adam._init_slot
    _multi_precision = False

    def _hyper(self, p):
        wd = self._lamb_wd
        if self._exclude_fn is not None and self._exclude_fn(p):
            wd = 0.0
        return {"b1": self._beta1, "b2": self._beta2, "eps": self._epsilon,
                "wd": wd}

    def _update(self, p, g, lr, slots, b1, b2, eps, wd):
        m1, m2, b1p, b2p = slots
        m1.copy_(b1 * m1 + (1 - b1) * g)
        m2.copy_(b2 * m2 + (1 - b2) * torch.square(g))
        r = (m1 / (1 - b1p)) / (torch.sqrt(m2 / (1 - b2p)) + eps) + wd * p
        p_norm = torch.sqrt(torch.sum(torch.square(p)))
        r_norm = torch.sqrt(torch.sum(torch.square(r)))
        trust = torch.where((p_norm > 0) & (r_norm > 0), p_norm / r_norm,
                            torch.ones_like(p_norm))
        p.copy_(p - (_f32(lr) * trust * r).to(p.dtype))
        b1p.mul_(b1)
        b2p.mul_(b2)
