"""Health verdicts (the serving half of ``paddle_tpu/resilience/
sentinel.py``).

:func:`logits_finite` is the serving engine's NaN sentinel: one bool a
row, True when every logit of the row is finite. The engine's decode
ticks compute it on the device beside the sampled tokens when
``InferenceEngine(watchdog=...)`` is armed, and it reaches the host in
the same device-to-host copy as the tokens, so an armed tick adds no
synchronisation.

The training sentinel (``update``, ``gate``, ``global_grad_norm``) is
not ported yet.
"""
from __future__ import annotations

import torch

__all__ = ["logits_finite"]


def logits_finite(logits: torch.Tensor) -> torch.Tensor:
    """Per-row all-finite verdict over a ``(batch, ...)`` logits block:
    a ``(batch,)`` bool tensor on the logits' device."""
    return torch.isfinite(logits).reshape(logits.shape[0], -1).all(-1)
