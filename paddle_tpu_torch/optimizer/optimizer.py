"""Optimizers of the eager Paddle surface.

Counterpart of ``paddle_tpu/optimizer/optimizer.py``: ``SGD``,
``Momentum``, ``LarsMomentum``, ``Adam``, ``AdamW``, ``Adamax``,
``Adagrad``, ``Adadelta``, ``RMSProp``, ``Lamb``, ``Ftrl``,
``DecayedAdagrad``, ``Dpsgd`` and ``ExponentialMovingAverage``, with the
JAX package's slot names and conventions (``moment1``, ``moment2``,
``beta1_pow`` and ``beta2_pow`` holding βᵗ when the step runs;
``velocity``; ...) and its update formulas, so ``state_dict()`` carries
the JAX package's keys.

``learning_rate`` is a number or an ``LRScheduler`` (``optimizer/lr.py``);
``grad_clip`` (``nn/clip.py``) is applied in ``step()`` before the
update. Each optimizer's :meth:`Optimizer._update` is the counterpart of
JAX's ``_pure_update``: it updates one parameter and its slots IN PLACE
and takes the learning rate as a 0-dim f32 tensor on the parameter's
device, so ``jit.TrainStep`` runs it inside a captured CUDA graph, the
rate written into that tensor before each replay. ``step()`` runs it
under ``torch.no_grad()``, one parameter at a time; with
``FLAGS_fused_optimizer=1`` Adam, AdamW and Lamb take
``ops/fused_optimizer.py``'s ``fused_eager_step`` instead (one AdamW or
LAMB kernel launch per bucket on the card), as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import flags
from ..framework.core import Tensor, _as_torch
from ..regularizer import L1Decay, L2Decay
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adagrad", "Adadelta", "RMSProp", "Lamb", "LarsMomentum", "Ftrl",
           "FtrlOptimizer", "Dpsgd", "DpsgdOptimizer", "DecayedAdagrad",
           "DecayedAdagradOptimizer", "ExponentialMovingAverage"]


def _f32(v):
    """A Python float rounded to f32, as a JAX f32 scalar holds it; a
    tensor (the learning rate) as f32, on its device."""
    if isinstance(v, torch.Tensor):
        return v.float()
    return float(np.float32(v))


def _weak(c, t):
    """A scalar as ``jnp`` applies it to the tensor ``t``: a Python float
    rounded to t's dtype first (0.1 is 0.10009765625 beside a bf16
    tensor); a 0-dim tensor (the learning rate) cast to it on the
    device, with no host read."""
    if isinstance(c, torch.Tensor):
        return c.to(t.dtype)
    return torch.tensor(c, dtype=t.dtype).item()


def _raw(g):
    return g._data if isinstance(g, Tensor) else g


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        self._learning_rate = (learning_rate
                               if isinstance(learning_rate, LRScheduler)
                               else float(learning_rate))
        self._parameter_list = (list(parameters) if parameters is not None
                                else None)
        self._grad_clip = grad_clip
        self._name = name
        self._weight_decay = (L2Decay(weight_decay)
                              if isinstance(weight_decay, float)
                              else weight_decay)
        # slot store: name -> {id(param): torch tensor}
        self._accumulators: dict = {}
        self._fused_state = None
        self._slots_stale = False

    # -- lr -----------------------------------------------------------------
    def get_lr(self):
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return self._learning_rate

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)

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

    def _params_grads(self):
        return [(p, p.grad) for p in self._parameter_list or []
                if p.grad is not None and getattr(p, "trainable", True)]

    @torch.no_grad()
    def step(self):
        params_grads = self._params_grads()
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        lr = self.get_lr()
        if flags.fused_optimizer[0] and self._fused_supported():
            from ..ops.fused_optimizer import fused_eager_step

            if fused_eager_step(self, params_grads, lr):
                return
        self._apply(params_grads, lr)

    def _apply(self, params_grads, lr):
        """Every parameter's update, in place. ``lr`` is a float (one f32
        device scalar is made from it for each device and multiplier) or
        a 0-dim f32 device tensor (``jit.TrainStep``'s); a gradient is a
        Tensor or a bare torch tensor."""
        rates: dict = {}
        for p, g in params_grads:
            g = self._regularized_grad(p, _raw(g).to(p.dtype))
            mult = float(p.optimize_attr.get("learning_rate", 1.0))
            key = (p._data.device, mult)
            if key not in rates:
                rates[key] = (
                    (lr if mult == 1.0 else lr * mult)
                    if isinstance(lr, torch.Tensor)
                    else torch.full((), lr * mult, dtype=torch.float32,
                                    device=p._data.device))
            self._update(p._data, g, rates[key], self._get_slots(p),
                         **self._hyper(p))

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """On a static program's loss: a training directive appended to
        the program that owns the loss (the reference appends grad and
        update ops to that ProgramDesc; ``Executor.run`` performs them
        every run). Eagerly: the reference's dygraph minimize harvests
        the gradients ``loss.backward()`` left and steps, never running
        autograd itself."""
        if getattr(loss, "_symbolic", False):
            from ..static import default_main_program

            prog = getattr(getattr(loss._expr, "op", None), "program",
                           None) or default_main_program()
            prog.train_specs.append((self, loss))
            return None, []
        self.step()
        return None, [(p, p.grad) for p in (self._parameter_list or [])]

    def clear_grad(self, set_to_zero=True):
        for p in self._parameter_list or []:
            p.clear_grad()

    clear_gradients = clear_grad

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
        if isinstance(self._learning_rate, LRScheduler):
            state["LR_Scheduler"] = self._learning_rate.state_dict()
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
        if "LR_Scheduler" in state_dict and isinstance(self._learning_rate,
                                                       LRScheduler):
            self._learning_rate.set_state_dict(state_dict["LR_Scheduler"])
        # loaded slots supersede the fused step's layout; rebuilt lazily
        self._fused_state = None
        self._slots_stale = False


class SGD(Optimizer):
    def _update(self, p, g, lr, slots):
        p.copy_(p - _weak(lr, p) * g)


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
        # JAX: p * (1 - lr·coeff).astype(p.dtype), the product in f32
        lr = (lr if isinstance(lr, torch.Tensor)
              else torch.tensor(lr, dtype=torch.float32))
        p.mul_((1.0 - lr.float() * coeff).to(p.dtype))
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


class LarsMomentum(Momentum):
    """LARS (reference operators/optimizers/lars_momentum_op.cc): the
    momentum step scaled by the local rate lr·coeff·‖p‖ / (ε + ‖g‖ +
    wd·‖p‖)."""

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, grad_clip=None,
                 exclude_from_weight_decay=None, epsilon=0, name=None):
        super().__init__(learning_rate, momentum, parameters, False, None,
                         grad_clip, name)
        self._lars_coeff = lars_coeff
        self._lars_wd = lars_weight_decay
        self._epsilon = epsilon

    def _hyper(self, p):
        return {"mu": self._momentum, "lars_coeff": self._lars_coeff,
                "lars_wd": self._lars_wd, "eps": self._epsilon}

    def _update(self, p, g, lr, slots, mu, lars_coeff, lars_wd, eps):
        (v,) = slots
        lr = _weak(lr, p)
        p_norm = torch.sqrt(torch.sum(torch.square(p)))
        g_norm = torch.sqrt(torch.sum(torch.square(g)))
        local_lr = lr * lars_coeff * p_norm / (
            eps + g_norm + lars_wd * p_norm + 1e-12)
        v.copy_(mu * v + local_lr * (g + lars_wd * p))
        p.copy_(p - v)


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2 = float(beta1), float(beta2)
        self._epsilon = float(epsilon)

    def _slot_names(self):
        return ["moment", "inf_norm", "beta1_pow"]

    def _init_slot(self, name, p):
        if name == "beta1_pow":
            return torch.full((), self._beta1, dtype=torch.float32,
                              device=p._data.device)
        return torch.zeros_like(p._data, requires_grad=False)

    def _hyper(self, p):
        return {"b1": self._beta1, "b2": self._beta2, "eps": self._epsilon}

    def _update(self, p, g, lr, slots, b1, b2, eps):
        m, inf, b1p = slots
        m.copy_(b1 * m + (1 - b1) * g)
        inf.copy_(torch.maximum(b2 * inf, torch.abs(g)))
        p.copy_(p - ((_f32(lr) / (1 - b1p)) * m / (inf + eps)).to(p.dtype))
        b1p.mul_(b1)


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 initial_accumulator_value=0.0):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = float(epsilon)
        self._init_acc = float(initial_accumulator_value)

    def _slot_names(self):
        return ["moment"]

    def _init_slot(self, name, p):
        return torch.full_like(p._data, self._init_acc, requires_grad=False)

    def _hyper(self, p):
        return {"eps": self._epsilon}

    def _update(self, p, g, lr, slots, eps):
        (m,) = slots
        m.copy_(m + torch.square(g))
        p.copy_(p - _weak(lr, p) * g / (torch.sqrt(m) + eps))


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon, self._rho = float(epsilon), float(rho)

    def _slot_names(self):
        return ["avg_squared_grad", "avg_squared_update"]

    def _hyper(self, p):
        return {"eps": self._epsilon, "rho": self._rho}

    def _update(self, p, g, lr, slots, eps, rho):
        asg, asu = slots
        asg.copy_(rho * asg + (1 - rho) * torch.square(g))
        update = -torch.sqrt(asu + eps) / torch.sqrt(asg + eps) * g
        asu.copy_(rho * asu + (1 - rho) * torch.square(update))
        p.copy_(p + _weak(lr, p) * update)


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._epsilon = float(rho), float(epsilon)
        self._momentum, self._centered = float(momentum), bool(centered)

    def _slot_names(self):
        return ["mean_square", "mean_grad", "momentum"]

    def _hyper(self, p):
        return {"rho": self._rho, "eps": self._epsilon, "mom": self._momentum,
                "centered": self._centered}

    def _update(self, p, g, lr, slots, rho, eps, mom, centered):
        ms, mg, mo = slots
        ms.copy_(rho * ms + (1 - rho) * torch.square(g))
        if centered:
            mg.copy_(rho * mg + (1 - rho) * g)
            denom = ms - torch.square(mg) + eps
        else:
            denom = ms + eps
        mo.copy_(mom * mo + _weak(lr, p) * g / torch.sqrt(denom))
        p.copy_(p - mo)


class Ftrl(Optimizer):
    """FTRL, Follow The Regularized Leader (reference
    fluid/optimizer.py FtrlOptimizer over operators/optimizers/ftrl_op.h):
    squared and linear accumulators, l1 shrinkage, the lr_power
    schedule; f32 math, the result in the parameter's dtype."""

    def __init__(self, learning_rate=0.001, l1=0.0, l2=0.0, lr_power=-0.5,
                 parameters=None, regularization=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, regularization,
                         grad_clip, name)
        self._l1, self._l2 = float(l1), float(l2)
        self._lr_power = float(lr_power)

    def _slot_names(self):
        return ["squared_accum", "linear_accum"]

    def _hyper(self, p):
        return {"l1": self._l1, "l2": self._l2, "lr_power": self._lr_power}

    def _update(self, p, g, lr, slots, l1, l2, lr_power):
        s_acc, l_acc = slots
        lr = _f32(lr)
        g32, p32 = g.float(), p.float()
        new_acc = s_acc + g32 * g32
        if lr_power == -0.5:
            lin = l_acc + g32 - (torch.sqrt(new_acc)
                                 - torch.sqrt(s_acc)) / lr * p32
            y = torch.sqrt(new_acc) / lr + 2.0 * l2
        else:
            lin = l_acc + g32 - (new_acc ** -lr_power
                                 - s_acc ** -lr_power) / lr * p32
            y = new_acc ** -lr_power / lr + 2.0 * l2
        x = l1 * torch.sign(lin) - lin
        new_p = torch.where(torch.abs(lin) > l1, x / y,
                            torch.zeros_like(x))
        s_acc.copy_(new_acc)
        l_acc.copy_(lin)
        p.copy_(new_p.to(p.dtype))


FtrlOptimizer = Ftrl


class Dpsgd(Optimizer):
    """DP-SGD, differentially private SGD (reference fluid/optimizer.py
    DpsgdOptimizer over operators/optimizers/dpsgd_op.h): each gradient
    clipped to L2 norm ``clip``, plus one Gaussian draw σ·N(0, 1) scaled
    by 1/batch_size per parameter and step. The draw comes from the
    device's explicit ``torch.Generator`` (``framework/random.py``,
    seeded by ``paddle.seed``), on the device, with no host read; a
    captured step registers that generator with its graph. The JAX
    package draws from its own key chain, so the two agree at
    ``sigma=0`` only."""

    def __init__(self, learning_rate=0.001, clip=10.0, batch_size=16.0,
                 sigma=1.0, parameters=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._clip = float(clip)
        self._batch_size = float(batch_size)
        self._sigma = float(sigma)

    def _params_grads(self):
        # as the JAX step: every parameter holding a gradient
        return [(p, p.grad) for p in self._parameter_list or []
                if p.grad is not None]

    def _regularized_grad(self, p, g):
        return g

    def _hyper(self, p):
        return {"clip": self._clip, "bs": self._batch_size,
                "sigma": self._sigma}

    @staticmethod
    def noise(device, sigma):
        """One draw σ·N(0, 1) on ``device`` (a 0-dim f32 tensor)."""
        from ..framework import random as grandom

        z = torch.randn((), dtype=torch.float32, device=device,
                        generator=grandom.generator(device))
        return sigma * z

    def _update(self, p, g, lr, slots, clip, bs, sigma):
        g32 = g.float()
        l2 = torch.sqrt(torch.sum(torch.square(g32)))
        scale = torch.where(l2 > clip, l2 / clip, torch.ones_like(l2))
        step = _f32(lr) * (g32 / scale + self.noise(p.device, sigma) / bs)
        p.copy_((p.float() - step).to(p.dtype))


DpsgdOptimizer = Dpsgd


class DecayedAdagrad(Optimizer):
    """Decayed Adagrad (reference fluid/optimizer.py
    DecayedAdagradOptimizer over decayed_adagrad_op.h): the moment decays
    instead of accumulating for ever."""

    def __init__(self, learning_rate=0.001, decay=0.95, epsilon=1e-6,
                 parameters=None, regularization=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, regularization,
                         grad_clip, name)
        self._decay = float(decay)
        self._epsilon = float(epsilon)

    def _slot_names(self):
        return ["moment"]

    def _hyper(self, p):
        return {"decay": self._decay, "eps": self._epsilon}

    def _update(self, p, g, lr, slots, decay, eps):
        (moment,) = slots
        g32 = g.float()
        m = decay * moment + (1.0 - decay) * g32 * g32
        new_p = p.float() - _f32(lr) * g32 / (torch.sqrt(m) + eps)
        moment.copy_(m)
        p.copy_(new_p.to(p.dtype))


DecayedAdagradOptimizer = DecayedAdagrad


class ExponentialMovingAverage:
    """EMA of parameters with bias correction (reference fluid/optimizer.py
    ExponentialMovingAverage: EMA_t = decay·EMA_{t-1} + (1 − decay)·θ_t,
    applied as EMA_t / (1 − decayᵗ)); ``apply()`` / ``restore()`` swap
    the shadow values in and out, ``apply_guard()`` is the context
    form. Shadows are f32 device tensors."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = float(decay)
        self._thres_steps = thres_steps
        self._ema: dict = {}
        self._backup: dict = {}
        self._params: list = []
        self._step = 0

    @torch.no_grad()
    def update(self, parameters=None):
        if parameters is not None:
            self._params = list(parameters)
        elif not self._params:
            raise ValueError("ExponentialMovingAverage.update needs "
                             "parameters on the first call")
        self._step += 1
        d = self._decay
        if self._thres_steps is not None:
            # reference: decay = min(decay, (1 + steps) / (10 + steps))
            t = float(self._thres_steps() if callable(self._thres_steps)
                      else self._step)
            d = min(d, (1.0 + t) / (10.0 + t))
        for p in self._params:
            if not hasattr(p, "_data"):
                continue
            prev = self._ema.get(id(p))
            cur = p._data.detach().float()
            self._ema[id(p)] = (d * prev + (1.0 - d) * cur
                                if prev is not None else (1.0 - d) * cur)

    @torch.no_grad()
    def apply(self, need_restore=True):
        corr = 1.0 - self._decay ** max(self._step, 1)
        self._backup = {}
        for p in self._params:
            ema = self._ema.get(id(p))
            if ema is None:
                continue
            if need_restore:
                self._backup[id(p)] = p._data.detach().clone()
            p._data.copy_((ema / corr).to(p._data.dtype))

    @torch.no_grad()
    def restore(self):
        for p in self._params:
            if id(p) in self._backup:
                p._data.copy_(self._backup[id(p)])
        self._backup = {}

    def apply_guard(self, need_restore=True):
        from contextlib import contextmanager

        @contextmanager
        def guard():
            self.apply(need_restore)
            try:
                yield
            finally:
                if need_restore:
                    self.restore()

        return guard()
