"""Random sampling (``paddle_tpu/tensor/random.py``): ``rand``,
``randn`` / ``standard_normal``, ``randint``, ``randint_like``,
``randperm``, ``uniform``, ``normal``, ``multinomial``, ``bernoulli``,
``poisson`` and the in-place ``uniform_``, ``normal_``,
``exponential_``.

Each draws from the port's seeded generator of the device it writes on
(``framework/random.py``): the current device for a new tensor, the
given tensor's for the rest. A captured ``jit.TrainStep`` registers that
generator with its graph, so a draw in the step is replayed as a fresh
draw, as dropout's are. ``uniform(seed=s)`` with s ≠ 0 draws from a
generator of its own seeded with s. The values differ from the JAX
package's (other generators): the distributions are the same.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import current_device
from ..framework import dtype as dtypes
from ..framework import random as grandom
from ..framework.core import Tensor, _unwrap, records

__all__ = [
    "rand", "randn", "randint", "randint_like", "randperm", "uniform",
    "normal", "standard_normal", "multinomial", "bernoulli", "poisson",
    "uniform_", "normal_", "exponential_",
]


def _shape(shape):
    if isinstance(shape, Tensor):
        shape = shape.tolist()
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s.item()) if isinstance(s, Tensor) else int(s)
                 for s in shape)


def _dt(dtype):
    d = dtypes.convert_dtype(dtype)
    return d if d is not None else dtypes.default_float_dtype()


def rand(shape, dtype=None, name=None):
    dev = current_device()
    return Tensor(torch.rand(_shape(shape), dtype=_dt(dtype), device=dev,
                             generator=grandom.generator(dev)))


def randn(shape, dtype=None, name=None):
    dev = current_device()
    return Tensor(torch.randn(_shape(shape), dtype=_dt(dtype), device=dev,
                              generator=grandom.generator(dev)))


standard_normal = randn


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    dev = current_device()
    return Tensor(torch.randint(int(low), int(high), _shape(shape),
                                dtype=dtypes.convert_dtype(dtype) or
                                torch.int64, device=dev,
                                generator=grandom.generator(dev)))


@records
def randint_like(x, low=0, high=None, dtype=None, name=None):
    """As the JAX package: int64 unless ``dtype`` says otherwise, on
    ``x``'s device."""
    if high is None:
        low, high = 0, low
    d = _unwrap(x)
    return Tensor(torch.randint(int(low), int(high), tuple(d.shape),
                                dtype=dtypes.convert_dtype(dtype) or
                                torch.int64, device=d.device,
                                generator=grandom.generator(d.device)))


def randperm(n, dtype="int64", name=None):
    dev = current_device()
    perm = torch.randperm(int(n), device=dev,
                          generator=grandom.generator(dev))
    return Tensor(perm.to(dtypes.convert_dtype(dtype) or torch.int64))


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):  # noqa: A002
    dev = current_device()
    if seed:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
    else:
        gen = grandom.generator(dev)
    return Tensor(torch.empty(_shape(shape), dtype=_dt(dtype),
                              device=dev).uniform_(float(min), float(max),
                                                   generator=gen))


@records
def normal(mean=0.0, std=1.0, shape=None, name=None):
    """N(mean, std²): Tensor ``mean`` / ``std`` broadcast together (the
    draw on their device), else ``shape`` on the current device."""
    if isinstance(mean, Tensor) or isinstance(std, Tensor):
        m, s = _unwrap(mean), _unwrap(std)
        ref = m if isinstance(m, torch.Tensor) else s
        shp = torch.broadcast_shapes(
            tuple(getattr(m, "shape", ())), tuple(getattr(s, "shape", ())))
        z = torch.randn(shp, dtype=ref.dtype, device=ref.device,
                        generator=grandom.generator(ref.device))
        return Tensor(z * s + m)
    dev = current_device()
    z = torch.randn(_shape(shape), dtype=dtypes.default_float_dtype(),
                    device=dev, generator=grandom.generator(dev))
    return Tensor(z * std + mean)


@records
def multinomial(x, num_samples=1, replacement=False, name=None):
    """``num_samples`` category indices a row of the weights ``x`` (1-D
    or 2-D, need not sum to 1), int64; without replacement each row's
    draws are distinct."""
    d = _unwrap(x)
    return Tensor(torch.multinomial(d.float(), int(num_samples),
                                    bool(replacement),
                                    generator=grandom.generator(d.device)))


@records
def bernoulli(x, name=None):
    d = _unwrap(x)
    u = torch.rand(d.shape, dtype=torch.float32, device=d.device,
                   generator=grandom.generator(d.device))
    return Tensor((u < d).to(d.dtype))


@records
def poisson(x, name=None):
    d = _unwrap(x)
    return Tensor(torch.poisson(
        d.float(), generator=grandom.generator(d.device)).to(d.dtype))


def uniform_(x, min=-1.0, max=1.0, name=None):  # noqa: A002
    if x._symbolic:
        raise TypeError("uniform_ draws into a Tensor in place: a static "
                        "program's placeholder has no storage to fill")
    with torch.no_grad():
        x._data.uniform_(float(min), float(max),
                         generator=grandom.generator(x._data.device))
    return x


def normal_(x, mean=0.0, std=1.0, name=None):
    if x._symbolic:
        raise TypeError("normal_ draws into a Tensor in place: a static "
                        "program's placeholder has no storage to fill")
    with torch.no_grad():
        x._data.normal_(float(mean), float(std),
                        generator=grandom.generator(x._data.device))
    return x


def exponential_(x, lam=1.0, name=None):
    if x._symbolic:
        raise TypeError("exponential_ draws into a Tensor in place: a static "
                        "program's placeholder has no storage to fill")
    with torch.no_grad():
        x._data.exponential_(float(lam),
                             generator=grandom.generator(x._data.device))
    return x
