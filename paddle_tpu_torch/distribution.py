"""Probability distributions (``paddle_tpu/distribution.py``; reference
python/paddle/distribution.py:42).

Uniform / Normal / Categorical with sample / log_prob / probs / entropy
/ kl_divergence. Every density and statistic goes through ``apply_op``
with the constructor's parameter Tensors as live inputs, so they train
through torch autograd and record into a static program. ``sample``
draws from the device's seeded generator (``paddle.seed``) and keeps the
reparameterization path live for Uniform and Normal: loc + z * scale
with z a constant draw. The two packages draw different numbers from
one seed.
"""
from __future__ import annotations

import math

import torch

from .framework import random as grandom
from .framework.core import Tensor, _as_torch, apply_op

__all__ = ["Distribution", "Uniform", "Normal", "Categorical"]


def _keep(v):
    """A Tensor as it is (tape-live); a number or array as an f32
    Tensor."""
    if isinstance(v, Tensor):
        return v
    return Tensor(_as_torch(v, dtype=torch.float32))


def _val(v, like):
    """The evaluation point: a Tensor passes through live, raw values
    become a tensor on ``like``'s device."""
    if isinstance(v, Tensor):
        return v
    return Tensor(_as_torch(v, dtype=torch.float32,
                            device=like._data.device))


def _index(v, like):
    if isinstance(v, Tensor):
        return v.astype("int64")
    return Tensor(_as_torch(v, dtype=torch.int64, device=like._data.device))


class Distribution:
    """Abstract base (reference distribution.py:42)."""

    def sample(self, shape):
        raise NotImplementedError

    def entropy(self):
        raise NotImplementedError

    def kl_divergence(self, other):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError

    def probs(self, value):
        raise NotImplementedError


def _draw(kind, shape, like, seed):
    dev = like._data.device
    if seed:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
    else:
        gen = grandom.generator(dev)
    if kind == "uniform":
        return torch.rand(shape, dtype=torch.float32, device=dev,
                          generator=gen)
    return torch.randn(shape, dtype=torch.float32, device=dev,
                       generator=gen)


def _batch_shape(a, b):
    return tuple(torch.broadcast_shapes(tuple(a.shape), tuple(b.shape)))


# -- uniform ------------------------------------------------------------------

def _uniform_sample_op(lo, hi, u):
    return lo + u * (hi - lo)


def _uniform_log_prob_op(lo, hi, v):
    inside = (v >= lo) & (v < hi)
    return torch.log(torch.where(inside, 1.0 / (hi - lo),
                                 torch.zeros((), dtype=v.dtype,
                                             device=v.device)))


def _uniform_probs_op(lo, hi, v):
    inside = (v >= lo) & (v < hi)
    return torch.where(inside, 1.0 / (hi - lo),
                       torch.zeros((), dtype=v.dtype, device=v.device))


def _uniform_entropy_op(lo, hi):
    return torch.log(hi - lo)


class Uniform(Distribution):
    """U[low, high) (reference distribution.py:169)."""

    def __init__(self, low, high, name=None):
        self.low = _keep(low)
        self.high = _keep(high)

    def sample(self, shape, seed=0):
        shape = tuple(int(s) for s in shape) + _batch_shape(self.low,
                                                            self.high)
        u = _draw("uniform", shape, self.low, seed)
        return apply_op(_uniform_sample_op, self.low, self.high, Tensor(u),
                        op_name="uniform_sample")

    def log_prob(self, value):
        return apply_op(_uniform_log_prob_op, self.low, self.high,
                        _val(value, self.low), op_name="uniform_log_prob")

    def probs(self, value):
        return apply_op(_uniform_probs_op, self.low, self.high,
                        _val(value, self.low), op_name="uniform_probs")

    def entropy(self):
        return apply_op(_uniform_entropy_op, self.low, self.high,
                        op_name="uniform_entropy")


# -- normal -------------------------------------------------------------------

def _normal_sample_op(lo, sc, z):
    return lo + z * sc


def _normal_log_prob_op(lo, sc, v):
    return (-((v - lo) ** 2) / (2 * sc ** 2) - torch.log(sc)
            - 0.5 * math.log(2 * math.pi))


def _normal_probs_op(lo, sc, v):
    return torch.exp(-((v - lo) ** 2) / (2 * sc ** 2)) \
        / (sc * math.sqrt(2 * math.pi))


def _normal_entropy_op(lo, sc):
    return (0.5 + 0.5 * math.log(2 * math.pi) + torch.log(sc)
            + torch.zeros_like(lo))


def _normal_kl_op(lo, sc, olo, osc):
    var_ratio = (sc / osc) ** 2
    t1 = ((lo - olo) / osc) ** 2
    return 0.5 * (var_ratio + t1 - 1.0 - torch.log(var_ratio))


class Normal(Distribution):
    """N(loc, scale²) (reference distribution.py:391)."""

    def __init__(self, loc, scale, name=None):
        self.loc = _keep(loc)
        self.scale = _keep(scale)

    def sample(self, shape, seed=0):
        shape = tuple(int(s) for s in shape) + _batch_shape(self.loc,
                                                            self.scale)
        z = _draw("normal", shape, self.loc, seed)
        return apply_op(_normal_sample_op, self.loc, self.scale, Tensor(z),
                        op_name="normal_sample")

    def log_prob(self, value):
        return apply_op(_normal_log_prob_op, self.loc, self.scale,
                        _val(value, self.loc), op_name="normal_log_prob")

    def probs(self, value):
        return apply_op(_normal_probs_op, self.loc, self.scale,
                        _val(value, self.loc), op_name="normal_probs")

    def entropy(self):
        return apply_op(_normal_entropy_op, self.loc, self.scale,
                        op_name="normal_entropy")

    def kl_divergence(self, other):
        if not isinstance(other, Normal):
            raise TypeError("kl_divergence expects another Normal")
        return apply_op(_normal_kl_op, self.loc, self.scale, other.loc,
                        other.scale, op_name="normal_kl")


# -- categorical ----------------------------------------------------------------

def _gather_cat(p, v):
    if p.dim() == 1:
        return p[v]
    if v.dim() == p.dim() - 1:
        # a category index per row (batched logits)
        return torch.gather(p, -1, v.unsqueeze(-1)).squeeze(-1)
    return torch.gather(p, -1, v)


def _categorical_probs_op(lg, v):
    return _gather_cat(torch.softmax(lg, dim=-1), v)


def _categorical_log_prob_op(lg, v):
    # the log-softmax gathered (not the log of the gathered probability):
    # stable and differentiable at small probabilities
    return _gather_cat(torch.log_softmax(lg, dim=-1), v)


def _categorical_entropy_op(lg):
    # a zero probability contributes 0, with no NaN in the gradient: the
    # guard is on log p itself, as the JAX package has it
    lp = torch.log_softmax(lg, dim=-1)
    p = torch.exp(lp)
    return -torch.sum(p * torch.where(p > 0, lp, torch.zeros_like(lp)),
                      dim=-1)


def _categorical_kl_op(lg, olg):
    lp = torch.log_softmax(lg, dim=-1)
    olp = torch.log_softmax(olg, dim=-1)
    p = torch.exp(lp)
    return torch.sum(p * torch.where(p > 0, lp - olp, torch.zeros_like(lp)),
                     dim=-1)


class Categorical(Distribution):
    """Categorical over unnormalized logits (reference
    distribution.py:641: prob = softmax(logits))."""

    def __init__(self, logits, name=None):
        self.logits = _keep(logits)

    def sample(self, shape):
        lg = self.logits._data.detach()
        shape = tuple(int(s) for s in shape)
        flat = torch.softmax(lg.float(), dim=-1).reshape(-1, lg.shape[-1])
        n = math.prod(shape) if shape else 1
        idx = torch.multinomial(flat, n, replacement=True,
                                generator=grandom.generator(lg.device))
        # (rows, n) → shape + batch shape
        idx = idx.t().reshape(shape + tuple(lg.shape[:-1]))
        return Tensor(idx)

    def probs(self, value):
        return apply_op(_categorical_probs_op, self.logits,
                        _index(value, self.logits),
                        op_name="categorical_probs")

    def log_prob(self, value):
        return apply_op(_categorical_log_prob_op, self.logits,
                        _index(value, self.logits),
                        op_name="categorical_log_prob")

    def entropy(self):
        return apply_op(_categorical_entropy_op, self.logits,
                        op_name="categorical_entropy")

    def kl_divergence(self, other):
        if not isinstance(other, Categorical):
            raise TypeError("kl_divergence expects another Categorical")
        return apply_op(_categorical_kl_op, self.logits, other.logits,
                        op_name="categorical_kl")
