"""Gradient clipping (``paddle_tpu/nn/clip.py``; reference
python/paddle/fluid/clip.py: ClipGradByValue, ClipGradByNorm,
ClipGradByGlobalNorm).

A clip maps a list of ``(param, grad)`` pairs to a new one, as the
reference's ``GradientClipBase._dygraph_clip`` does; the optimizer calls
it before its update. A grad may be a Tensor or a bare ``torch.Tensor``
(``jit.TrainStep`` hands bare ones) and comes back as the same kind.
Every norm and scale stays a device tensor: a clip never reads a value
back to the host, so it runs inside a captured CUDA graph.
"""
from __future__ import annotations

import torch

from ..framework.core import Tensor

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm"]


def _raw(g):
    return g._data if isinstance(g, Tensor) else g


def _like(g, value):
    return Tensor(value) if isinstance(g, Tensor) else value


def _clipped(p, g):
    return g is not None and getattr(p, "need_clip", True)


class ClipGradBase:
    def __call__(self, params_grads):
        return self._clip(params_grads)


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):  # noqa: A002
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _clip(self, params_grads):
        return [(p, _like(g, torch.clamp(_raw(g), self.min, self.max)))
                if _clipped(p, g) else (p, g) for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip(self, params_grads):
        out = []
        for p, g in params_grads:
            if not _clipped(p, g):
                out.append((p, g))
                continue
            gd = _raw(g)
            norm = torch.sqrt(torch.sum(torch.square(gd)))
            scale = torch.clamp(self.clip_norm / torch.clamp_min(norm, 1e-12),
                                max=1.0)
            out.append((p, _like(g, gd * scale)))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _clip(self, params_grads):
        sq = None
        for p, g in params_grads:
            if not _clipped(p, g):
                continue
            s = torch.sum(torch.square(_raw(g).float()))
            sq = s if sq is None else sq + s
        if sq is None:
            return params_grads
        global_norm = torch.sqrt(sq)
        scale = self.clip_norm / torch.clamp_min(global_norm, self.clip_norm)
        return [(p, _like(g, _raw(g) * scale.to(_raw(g).dtype)))
                if _clipped(p, g) else (p, g) for p, g in params_grads]
