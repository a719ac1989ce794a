"""Where a paged, chunked prefill's time goes, at full gpt_1p3b width on
the card.

    python -m paddle_tpu_torch.tools.profile_prefill [--tokens 1500]
        [--chunk 64] [--reps 5]

Prefills one prompt of random tokens into a paged pool (block 16) chunk
by chunk, as the engine's prefill tick does: each chunk end-padded to a
block boundary, the table row cut to the next power of two of the
blocks it needs. Two cases: ``cold`` from position 0
(``gpt_prefill_chunk``), and ``tail``, the prompt's last ``--tokens``
minus 1000 tokens after a 1000-token prefix is cached, the radix prefix
cache's unaligned start (``gpt_prefill_prefix``). Prints one JSON line
per case: the host-clock ms of a whole prefill (median of ``--reps``,
ending in a device sync), its device ms (sum of kernel times from
torch.profiler), the device's idle share, the kernels launched and the
kernels that take the most device time. Random weights from a seed;
every time is the card's own, printed beside the card's name and power
limit. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from ..models import gpt as G
from ..serving.engine import _serving_params
from ..serving.kv_cache import PagedKVCache

PREFIX = 1000


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        val = getattr(evt, name, None)
        if val is not None:
            return float(val)
    return 0.0


def _width(n_blocks: int, cap: int) -> int:
    w = 1
    while w < n_blocks:
        w *= 2
    return min(w, cap)


def profile(case: str, n_tokens: int, chunk: int, reps: int, dev) -> dict:
    cfg = G.gpt_1p3b()
    params = _serving_params(cfg, G.gpt_init(cfg, seed=0, device=dev), dev)
    cache = PagedKVCache(cfg, 1, block_size=16, device=dev)
    bs = cache.block_size
    slot = cache.alloc()
    assert cache.grow(slot, -(-n_tokens // bs) * bs)
    table = torch.from_numpy(cache.table_row(slot)).to(dev)
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, n_tokens).astype(np.int64)
    start0 = PREFIX if case == "tail" else 0
    step = G.gpt_prefill_prefix if case == "tail" else G.gpt_prefill_chunk

    def prefill():
        start = start0
        while start < n_tokens:
            c_true = min(chunk, n_tokens - start)
            c_pad = -(-(start + c_true) // bs) * bs - start
            toks = np.zeros((1, c_pad), np.int64)
            toks[0, :c_true] = prompt[start:start + c_true]
            row = table[:_width(-(-(start + c_pad) // bs),
                                cache.table_width)]
            logits, _ = step(cfg, params, (cache.kb, cache.vb), row,
                             torch.from_numpy(toks).to(dev), start)
            start += c_true
        return int(logits[0, c_true - 1].argmax())

    with torch.inference_mode():
        prefill()
        torch.cuda.synchronize()
        host = []
        for _ in range(reps):
            t0 = time.perf_counter()
            prefill()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            prefill()
            torch.cuda.synchronize()
    rows = []
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((us, evt.key, evt.count))
    rows.sort(reverse=True)
    host_ms = statistics.median(host)
    device_ms = sum(r[0] for r in rows) / 1e3
    return {
        "case": case, "model": "gpt_1p3b", "tokens": n_tokens - start0,
        "start": start0, "chunk": chunk, "block_size": bs,
        "host_ms": host_ms, "host_ms_runs": host, "device_ms": device_ms,
        "device_idle_share": max(0.0, 1.0 - device_ms / host_ms),
        "kernel_launches": sum(r[2] for r in rows),
        "top_kernels": [{"name": k[:80], "ms": us / 1e3, "calls": c}
                        for us, k, c in rows[:8]],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tokens", type=int, default=1500)
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_prefill needs a CUDA device")
    if args.tokens <= PREFIX:
        raise SystemExit(f"--tokens must exceed the {PREFIX}-token prefix")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    for case in ("cold", "tail"):
        row = profile(case, args.tokens, args.chunk, args.reps, dev)
        row["card"] = smi
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
