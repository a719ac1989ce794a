"""The paged decode and the MoE gather of one tree on the card, so that
commits can be compared in one call.

    cd TREE && python /path/to/repo/paddle_tpu_torch/tools/kernel_ab.py

``paddle_tpu_torch`` is imported from the current directory: run from
the root of an archive of another commit, the tool times that commit's
wrappers and kernels. The inputs, the L2 flushes, the timers and the
bounds come from the ``chip_smoke.py`` of the tree this file sits in
(phase 4's ``paged_cases`` / ``paged_times``, phase 19's
``gather_cases`` / ``gather_times``), so every tree is read on the same
inputs in the same way. One JSON line a case:

- the gather and ``torch.index_select`` at phase 19's shapes: lone
  calls, and the kernels alone after a dirty and after a clean flush;
- paged decode at phase 4's shapes: the lone call, the kernels alone
  after a dirty flush, warm and clean, and the kernels a call launches.

Every time is the card's own, stamped with its name and power limit.
Needs a CUDA device.
"""
from __future__ import annotations

import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import torch


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[2] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    if argv:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab needs a CUDA device")
    sys.path.insert(0, os.getcwd())
    from paddle_tpu_torch.ops import moe_dispatch as md
    from paddle_tpu_torch.ops import paged_attention as pa

    cs = _chip_smoke()
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    for c in cs.gather_cases(dev):
        row = {"kernel": "moe_dispatch_gather",
               **{k: c[k] for k in ("shape", "T", "N", "H", "live_slots",
                                    "distinct_rows")},
               "dtype": str(c["dtype"])[6:],
               "bound_ms": cs.bound(0, c["nbytes"], c["dtype"])[0],
               **cs.gather_times(md, c, flush_buf), "card": card}
        print(json.dumps(row), flush=True)
    for c in cs.paged_cases(dev):
        row = {"kernel": "paged_attention", "shape": c["shape"],
               "dtype": str(c["dtype"])[6:],
               "bound_ms": cs.bound(c["flops"], c["nbytes"], c["dtype"])[0],
               **cs.paged_times(pa, c, flush_buf), "card": card}
        print(json.dumps(row), flush=True)
        del c
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
