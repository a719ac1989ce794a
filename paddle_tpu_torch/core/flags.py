"""Env-flag mirrors the ported slices read.

Own copy of the ``_truthy`` cells of ``paddle_tpu/core/native.py``:

- ``FLAGS_paged_kv``: the engine's default cache mode;
- ``FLAGS_ragged_decode``: the paged decode's ``ragged`` default;
- ``FLAGS_fused_kernels``: the fused LN-MLP in the block's MLP half when
  ``GPTConfig.fused_mlp`` is None (the serving engine pins it at
  construction), and the fused kernels in ``ops/fused.py``'s
  ``fused_feedforward``;
- ``FLAGS_fused_optimizer``: ``DistributedTrainStep`` with ``"adamw"`` or
  ``"lamb"``, and the Paddle optimizers' ``Adam``/``AdamW``/``Lamb.step()``,
  take the fused AdamW/LAMB kernels (``ops/fused_optimizer.py``);
- ``FLAGS_fp8_matmul``: the fp8 (e4m3) MLP in the block's MLP half when
  ``GPTConfig.fp8`` is None (the serving engine pins it at construction);
- ``FLAGS_prefix_cache``: the engine's radix prefix cache when
  ``InferenceEngine(prefix_cache=None)`` (paged mode only);
- ``FLAGS_fast_step`` (default 1, ``paddle_tpu/core/native.py:116``):
  ``jit.TrainStep`` returns an ``AsyncLoss`` without blocking and syncs
  the optimizer's slot mirrors lazily (``sync()``); ``hapi.Model.fit``
  stages batches on the card a step ahead (``io.DevicePrefetcher``);
- ``FLAGS_fault_inject``: the fault-injection spec string; setting it
  reconfigures ``resilience/faults.py``'s registry (its watcher), whose
  serving kinds the engine fires (``DistributedTrainStep`` raises while
  it is non-empty: the train-step hooks are not ported).

Each is a one-element list so callers can flip it at run time;
:func:`set_flag` / :func:`get_flag` (``paddle.set_flags`` /
``get_flags``) write and read them by their ``FLAGS_*`` names.
"""
from __future__ import annotations

import os

__all__ = ["paged_kv", "ragged_decode", "fused_kernels", "fused_optimizer",
           "fp8_matmul", "prefix_cache", "fast_step", "fault_inject", "set_flag",
           "get_flag"]


def _truthy(value) -> bool:
    return str(value).lower() in ("1", "true", "yes", "on")


# serving engine: paged block-pool KV cache instead of fixed slots
paged_kv = [_truthy(os.environ.get("FLAGS_paged_kv", "0"))]

# paged decode: sweep only live blocks. The CUDA kernel always loops over
# a slot's live blocks, so both settings give bit-identical output; the
# flag is kept for signature parity with the JAX package.
ragged_decode = [_truthy(os.environ.get("FLAGS_ragged_decode", "0"))]

# transformer block: the MLP half through the fused LN-MLP kernels
# (ops/fused_kernels.py) when the config leaves fused_mlp unset
fused_kernels = [_truthy(os.environ.get("FLAGS_fused_kernels", "0"))]

# train step: the fused multi-tensor AdamW/LAMB kernels
fused_optimizer = [_truthy(os.environ.get("FLAGS_fused_optimizer", "0"))]

# transformer block: the MLP matmuls in fp8 (e4m3) when the config leaves
# fp8 unset (amp/fp8.py, ops/fp8_matmul.py)
fp8_matmul = [_truthy(os.environ.get("FLAGS_fp8_matmul", "0"))]

# serving engine: radix-tree prefix sharing over the paged block pool
# when the engine leaves prefix_cache unset
prefix_cache = [_truthy(os.environ.get("FLAGS_prefix_cache", "0"))]

# jit.TrainStep: asynchronous loss, lazy slot mirrors; hapi fit: device
# prefetch of the next batch
fast_step = [_truthy(os.environ.get("FLAGS_fast_step", "1"))]

# deterministic fault injection spec; resilience.faults registers a
# watcher here so set_flag reconfigures its registry at once
fault_inject = [os.environ.get("FLAGS_fault_inject", "")]
fault_inject_watchers: list = []


def _cell(name: str) -> list:
    key = name[len("FLAGS_"):] if name.startswith("FLAGS_") else name
    cell = {"paged_kv": paged_kv, "ragged_decode": ragged_decode,
            "fused_kernels": fused_kernels,
            "fused_optimizer": fused_optimizer, "fp8_matmul": fp8_matmul,
            "prefix_cache": prefix_cache, "fast_step": fast_step,
            "fault_inject": fault_inject}.get(key)
    if cell is None:
        raise ValueError(f"{name} is not a flag of paddle_tpu_torch (it "
                         f"has FLAGS_paged_kv, FLAGS_ragged_decode, "
                         f"FLAGS_fused_kernels, FLAGS_fused_optimizer, "
                         f"FLAGS_fp8_matmul, FLAGS_prefix_cache, "
                         f"FLAGS_fast_step, FLAGS_fault_inject)")
    return cell


def set_flag(name: str, value) -> None:
    cell = _cell(name)
    if cell is fault_inject:
        cell[0] = str(value)
        for watcher in fault_inject_watchers:
            watcher(cell[0])
    else:
        cell[0] = _truthy(value)


def get_flag(name: str):
    return _cell(name)[0]
