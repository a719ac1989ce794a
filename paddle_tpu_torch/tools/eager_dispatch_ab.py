"""The eager step of two checkouts of this repository, in turns, on one
card: does a change cost the eager dispatch path anything?

Each turn runs, in a fresh process started in a checkout's root, that
checkout's own ``chip_smoke.py`` phases 24 (BERT-base trained eagerly
through the Paddle API, composed and fused, ``bert_train_phase``) and 45
(PaddleNLP's attention seq2seq, whose eager steps it times before it
captures, ``seq2seq_trainstep_phase``), after building its kernels. The
checkouts run in the order A, B, B, A, so drift on the card shows as a
difference between the two runs of one checkout.

    python -m paddle_tpu_torch.tools.eager_dispatch_ab --a PARENT_DIR \\
        [--b .] [--bert-steps 6]

Prints one JSON line per turn (the phase-24 step ms of each form, the
phase-45 eager step ms) and a last one with the card's name and power
limit and each checkout's turns. Needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_TURN = r"""
import json, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import (flash_attention as fa, fused_kernels as fk,
    fused_optimizer as fo, paged_attention as pa, int8_matmul as im,
    fp8_matmul as fm, moe_dispatch as md)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_build.build_all()
dev = torch.device("cuda", 0)
stamp = {}
mods = {"fa": fa, "pa": pa, "fk": fk, "fo": fo, "im": im, "fm": fm,
        "md": md}
bert = cs.bert_train_phase(dev, fa, fk, fo, stamp, steps=STEPS)
s2s = cs.seq2seq_trainstep_phase(dev, mods, stamp)
print("AB " + json.dumps({
    "bert_step_ms": {k: bert[k]["step_ms_median_last3"] for k in bert},
    "seq2seq_eager_step_ms": s2s["eager_step_ms_median"]}), flush=True)
"""


def _turn(root, steps):
    out = subprocess.run(
        [sys.executable, "-c", _TURN.replace("STEPS", str(int(steps)))],
        cwd=root, capture_output=True, text=True, check=True)
    for line in out.stdout.splitlines():
        if line.startswith("AB "):
            return json.loads(line[3:])
    raise RuntimeError(f"no result from {root}: {out.stdout[-2000:]}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", required=True, help="the first checkout's root")
    ap.add_argument("--b", default=".", help="the second checkout's root")
    ap.add_argument("--bert-steps", type=int, default=6)
    args = ap.parse_args(argv)
    turns = {"a": [], "b": []}
    for key in ("a", "b", "b", "a"):
        root = os.path.abspath(getattr(args, key))
        row = _turn(root, args.bert_steps)
        turns[key].append(row)
        print(json.dumps({"checkout": key, "root": root, **row}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"card": smi.strip(), "turns": turns}), flush=True)


if __name__ == "__main__":
    main()
