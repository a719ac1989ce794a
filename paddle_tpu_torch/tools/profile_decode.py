"""Where a decode tick's time goes, at full gpt_1p3b width on the card.

    python -m paddle_tpu_torch.tools.profile_decode [--steps 20] [--int8]
        [--moe]

Builds the serving state the engine would hold with 8 live slots (prompts
of 40 to 1500 tokens already cached, random weights from a seed) in both
cache modes, runs the engine's tick body (decode step, sampling, tokens
back to the host) and prints one JSON line per mode: the host-clock ms of
a tick (ending in the device sync of the tokens' copy), the device ms of
a tick (sum of kernel times from torch.profiler), the device's idle share
(1 - device / host), the device kernels launched per tick and the kernels
that take the most device time per tick. ``--int8`` decodes with the
int8-quantized block weights, as ``InferenceEngine(int8_weights=True)``
does; ``--moe`` serves gpt_1p3b with ``moe_experts=8`` (top-2, every 2nd
layer, dropless), its router counts copied to the host with the tokens,
as the engine's tick does. Every time is the card's own; the card's
name and power limit are printed beside them. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from ..models import gpt as G
from ..serving.engine import _serving_params
from ..serving.kv_cache import KVCache, PagedKVCache
from ..serving.sampling import sample_tokens_streams

LENGTHS = (40, 100, 200, 400, 700, 1000, 1300, 1500)


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        val = getattr(evt, name, None)
        if val is not None:
            return float(val)
    return 0.0


def _state(cfg, dev, paged):
    B = len(LENGTHS)
    if paged:
        cache = PagedKVCache(cfg, B, block_size=16, device=dev)
        for s, n in enumerate(LENGTHS):
            assert cache.alloc() == s and cache.grow(s, n + 1)
        width = max(len(t) for t in cache.block_tables)
        w = 1
        while w < width:
            w *= 2
        tables = torch.from_numpy(np.ascontiguousarray(
            cache.tables_array()[:, :w])).to(dev)
    else:
        cache = KVCache(cfg, B, device=dev)
        tables = None
    return cache, tables


def profile(mode: str, steps: int, dev, int8: bool = False,
            moe: bool = False) -> dict:
    cfg = G.gpt_1p3b(moe_experts=8 if moe else 0)
    params = G.gpt_init(cfg, seed=0, device=dev)
    if int8:
        params = G.quantize_gpt_weights(params)
    params = _serving_params(cfg, params, dev)
    paged = mode == "paged"
    cache, tables = _state(cfg, dev, paged)
    B = len(LENGTHS)
    pos = torch.tensor(LENGTHS, dtype=torch.int32, device=dev)
    tok = torch.arange(B, dtype=torch.int32, device=dev)
    greedy = ([0.0] * B, [0] * B, [1.0] * B)

    def tick():
        if paged:
            got = G.gpt_decode_step_paged(
                cfg, params, (cache.kb, cache.vb), tables, pos, tok)
        else:
            got = G.gpt_decode_step(cfg, params, (cache.k, cache.v), pos,
                                    tok)
        toks = sample_tokens_streams(got[0], *greedy, 0, list(range(B)),
                                     [1] * B)
        if moe:
            counts, dropped = got[2]
            toks = torch.cat([toks.long(), counts.long(),
                              dropped.long().reshape(1)])
        return toks.cpu()

    with torch.inference_mode():
        for _ in range(3):
            tick()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            tick()
        host_ms = (time.perf_counter() - t0) * 1e3 / steps
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        n_prof = 5
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(n_prof):
                tick()
            torch.cuda.synchronize()
    rows = []
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((us, evt.key, evt.count))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows) / 1e3 / n_prof
    return {
        "mode": mode, "int8_weights": int8, "model": "gpt_1p3b",
        "moe_experts": cfg.moe_experts, "slots": B,
        "lengths": list(LENGTHS), "host_ms_per_tick": host_ms,
        "device_ms_per_tick": device_ms,
        "device_idle_share": max(0.0, 1.0 - device_ms / host_ms),
        "kernel_launches_per_tick": sum(r[2] for r in rows) / n_prof,
        "top_kernels": [
            {"name": k[:80], "ms_per_tick": us / 1e3 / n_prof,
             "calls_per_tick": c / n_prof} for us, k, c in rows[:12]],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--mode", choices=("fixed", "paged", "both"),
                    default="both")
    ap.add_argument("--int8", action="store_true",
                    help="decode with int8-quantized block weights")
    ap.add_argument("--moe", action="store_true",
                    help="serve gpt_1p3b with 8 experts (top-2)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    modes = ("fixed", "paged") if args.mode == "both" else (args.mode,)
    for mode in modes:
        row = profile(mode, args.steps, dev, int8=args.int8, moe=args.moe)
        row["card"] = smi
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
