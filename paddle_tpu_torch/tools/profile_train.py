"""Where a training step's time goes, at full gpt_1p3b width on the card.

    python -m paddle_tpu_torch.tools.profile_train [--steps 3] [--layers 24]
        [--fp8 | --moe]

Builds the training state chip_smoke.py's training phase drives
(gpt_1p3b with remat and the fused LN-MLP, random weights from a seed,
AdamW with f32 moments, batch 4 x 2048 tokens, loss_chunk 256), runs two
warm-up steps, times ``--steps`` steps on the host clock (each ends in
the loss's host read, which waits for the device), then profiles one
step under torch.profiler and prints one JSON line: host ms per step,
device ms per step (the sum of kernel times), the device's idle share
(1 - device / host), and the kernels that take the most device time
(the fused LN-MLP's GEMMs named by the product each computes).
With ``FLAGS_fused_optimizer=1`` in the environment the AdamW update is
the fused kernel (``ops/fused_optimizer.py``) instead of the per-leaf
PyTorch ops; the line says which ran. ``--fp8`` trains with
``fp8=True`` (the fp8 MLP, taking precedence over the fused one);
``--moe`` with ``moe_experts=8`` (top-2, every 2nd layer, capacity
factor 1.25), 8 layers unless ``--layers`` says otherwise (24 MoE
layers' f32 params, grads and moments alone would need ~66 GB). Every
time is the card's own; the card's name and power limit are printed
beside them. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from ..core import flags
from ..models import gpt as G
from ..parallel import DistributedTrainStep
from .profile_decode import _device_us


# the fused LN-MLP's bf16 GEMMs are launches of one template
# (csrc/gemm_sm90.cuh's gemm_ws); its epilogue and products name each:
# (stems, all in the kernel's name without spaces) -> label
FMLP_GEMMS = ((("EpiUp",), "fused LN-MLP fwd (2) a = act(lnx·W1 + b1)"),
              (("EpiDown",), "fused LN-MLP fwd (3) y = a·W2 + b2 (+ x)"),
              (("EpiActBwd",), "fused LN-MLP bwd (4) dz, a, db1"),
              (("EpiStoreF32", "Prod<1,1,0>"),
               "fused LN-MLP bwd (5) dW1, (7) dW2"),
              (("EpiStoreF32",), "fused LN-MLP bwd (6) dlnx"))


def kernel_name(key: str) -> str:
    """A device kernel's name for the report: the fused LN-MLP's GEMMs by
    what they compute, every other kernel's first 80 characters."""
    flat = key.replace(" ", "")
    if "gemm_ws" in flat:
        for stems, label in FMLP_GEMMS:
            if all(st in flat for st in stems):
                return label
    return key[:80]


def profile(steps: int, layers: int, dev, fp8: bool = False,
            moe: bool = False) -> dict:
    cfg = G.gpt_1p3b(remat=True, fused_mlp=True, n_layers=layers, fp8=fp8,
                     moe_experts=8 if moe else 0)
    B, S, chunk = 4, cfg.seq_len, 256
    rng = np.random.default_rng(9)
    batch = (torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))),
             torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))))
    step = DistributedTrainStep(
        lambda p, b: G.gpt_loss(cfg, p, b, loss_chunk=chunk),
        G.gpt_init(cfg, seed=0, device=dev), optimizer="adamw", lr=1e-4,
        device=dev)
    for _ in range(2):
        float(step(batch))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        float(step(batch))
    host_ms = (time.perf_counter() - t0) * 1e3 / steps
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        float(step(batch))
        torch.cuda.synchronize()
    rows = []
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((us, evt.key, evt.count))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows) / 1e3
    return {
        "model": "gpt_1p3b", "layers": layers, "remat": True,
        "fused_mlp": True, "fp8": fp8, "moe_experts": cfg.moe_experts,
        "optimizer": "adamw",
        "fused_optimizer": flags.fused_optimizer[0], "batch": [B, S],
        "loss_chunk": chunk, "host_ms_per_step": host_ms,
        "device_ms_per_step": device_ms,
        "device_idle_share": max(0.0, 1.0 - device_ms / host_ms),
        "tokens_per_s": B * S / host_ms * 1e3,
        "top_kernels": [
            {"name": kernel_name(k), "ms_per_step": us / 1e3,
             "calls_per_step": c}
            for us, k, c in rows[:25]],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--layers", type=int, default=None,
                    help="depth (default 24; 8 with --moe)")
    kind = ap.add_mutually_exclusive_group()
    kind.add_argument("--fp8", action="store_true",
                      help="the fp8 MLP (GPTConfig.fp8=True)")
    kind.add_argument("--moe", action="store_true",
                      help="8 experts, top-2, every 2nd layer")
    args = ap.parse_args(argv)
    layers = args.layers or (8 if args.moe else 24)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    row = profile(args.steps, layers, dev, fp8=args.fp8, moe=args.moe)
    row["card"] = smi
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
