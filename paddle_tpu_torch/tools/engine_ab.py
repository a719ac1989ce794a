"""The serving engine of one tree on the card, unarmed, so that commits
can be compared in one call: its tokens and its launches a decode tick.

    cd TREE && python /path/to/repo/paddle_tpu_torch/tools/engine_ab.py

``paddle_tpu_torch`` is imported from the current directory (as
``kernel_ab.py`` does): run from the root of an archive of another
commit, the tool drives that commit's engine. The model, the prompts and
the launch counter come from the ``chip_smoke.py`` of the tree this file
sits in (phase 5's gpt_1p3b at full depth from seed 0, its 8 greedy and
2 sampled requests, 32 new tokens; ``_launches_per_tick``, torch.profiler
over 10 ticks), and the engine gets only the arguments every port commit
takes, so two trees are read on the same inputs in the same way. One
JSON line a cache mode: a digest of every request's tokens (equal
digests: equal streams), the tokens themselves, the device kernels a
decode tick, and the run's decode ms (``serving_decode_ms``, host clock;
spreads between calls) beside its decode tokens. Every number is the
card's own, stamped with its name and power limit. Needs a CUDA device.
"""
from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import torch

NEW = 32


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
        raise SystemExit("engine_ab needs a CUDA device")
    sys.path.insert(0, os.getcwd())
    from paddle_tpu_torch.models import gpt as G
    from paddle_tpu_torch.monitor.stats import stat_get
    from paddle_tpu_torch.serving import InferenceEngine

    cs = _chip_smoke()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = G.gpt_1p3b()
    params = G.gpt_init(cfg, seed=0, device=dev)
    reqs = cs.phase5_requests(cfg.vocab_size)
    for paged in (False, True):
        ms0 = stat_get("serving_decode_ms")
        eng = InferenceEngine(cfg, params, n_slots=8, seed=5, paged=paged)
        handles = [eng.submit(p, max_new_tokens=NEW, **kw)
                   for p, kw in reqs]
        outs = [h.result(timeout=600) for h in handles]
        eng.shutdown()
        decode_tokens = sum(len(o) - 1 for o in outs)
        per_tick = cs._launches_per_tick(
            lambda: InferenceEngine(cfg, params, n_slots=8, paged=paged),
            cs._greedy(reqs))
        print(json.dumps({
            "tree": os.getcwd(), "mode": "paged" if paged else "fixed",
            "tokens_sha256": hashlib.sha256(
                json.dumps(outs).encode()).hexdigest(),
            "tokens": outs, "launches_per_tick": per_tick,
            "decode_ms_total": stat_get("serving_decode_ms") - ms0,
            "decode_tokens": decode_tokens, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
