"""Seeded random generators, one explicit ``torch.Generator`` per
device.

Counterpart of ``paddle_tpu/framework/random.py``. Where the JAX package
splits one global key, the port keeps a generator for each device the
Paddle surface has drawn on (initializers, dropout), all seeded by
:func:`seed`. The two packages give different numbers from one seed:
tests carry weights across instead.
"""
from __future__ import annotations

import threading

import torch

from ..device import current_device

__all__ = ["seed", "get_rng_state", "set_rng_state", "generator",
           "renew_generator", "seed_key", "get_cuda_rng_state",
           "set_cuda_rng_state"]

_lock = threading.Lock()
_seed = [0]
# bumped by every seed(): a consumer that derives its own generator from
# the seed (the detection samplers' numpy generator) keys on
# (seed, epoch), so seeding again with the same value restarts its stream
_epoch = [0]
_generators: dict = {}


def generator(device=None) -> torch.Generator:
    """The generator of ``device`` (default: the current device), made
    and seeded on first use."""
    dev = torch.device(device) if device is not None else current_device()
    if dev.type == "meta":
        # a static program's shape inference draws nothing
        return None
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    with _lock:
        gen = _generators.get(dev)
        if gen is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(_seed[0])
            _generators[dev] = gen
        return gen


def renew_generator(device):
    """Give ``device`` a new generator at the old one's state. A CUDA graph
    capture that failed leaves a generator registered with it marked as
    capturing (torch closes that only when the capture ends cleanly), and
    its next draw outside a capture raises."""
    dev = torch.device(device)
    with _lock:
        old = _generators.get(dev)
        if old is None:
            return
        new = torch.Generator(device=dev)
        try:
            new.set_state(old.get_state())
        except RuntimeError:
            new.manual_seed(_seed[0])
        _generators[dev] = new


def seed(s: int):
    """paddle.seed parity: reseed every device's generator."""
    with _lock:
        _seed[0] = int(s)
        _epoch[0] += 1
        for gen in _generators.values():
            gen.manual_seed(_seed[0])


def seed_key():
    """(seed, epoch): the last :func:`seed`'s value and how many seeds
    came before it."""
    with _lock:
        return _seed[0], _epoch[0]


def get_rng_state(device=None):
    """The generator state of ``device`` (default: the current device), a
    CPU uint8 tensor."""
    return generator(device).get_state()


def set_rng_state(state, device=None):
    """Set the generator of ``device`` (default: the current device) to
    ``state``, in place: a generator registered with a captured CUDA
    graph stays the one its replays advance, so replay k + 1 after a
    restore draws what it drew after the state was taken."""
    generator(device).set_state(state)


def get_cuda_rng_state():
    """paddle.get_cuda_rng_state: one generator state a visible card (an
    empty list without one)."""
    if not torch.cuda.is_available():
        return []
    return [generator(torch.device("cuda", i)).get_state()
            for i in range(torch.cuda.device_count())]


def set_cuda_rng_state(state_list):
    """paddle.set_cuda_rng_state: set each visible card's generator from
    :func:`get_cuda_rng_state`'s list, in place."""
    for i, state in enumerate(state_list):
        generator(torch.device("cuda", i)).set_state(state)
