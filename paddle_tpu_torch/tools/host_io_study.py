"""Host-side rates behind ``TrainGuardian``'s snapshots and checkpoints,
measured through the port's own code on the card's machine:

- page-locking an anonymous mapping with the guardian's ``_pin``
  (``cuMemHostRegister``) as mapped (what ``_HostCopy`` does), and
  after writing it with zeros, twice each (ABBA order), against
  ``pin_memory`` allocation;
- device-to-host copies into the pinned mapping;
- ``save_checkpoint`` with one writer thread (a save behind the loop)
  and with ``checkpoint.WRITERS`` (a blocking save), against one legacy
  ``torch.save`` a tensor and a raw write of the same bytes;
- ``load_checkpoint`` (memory-mapped), then to the card.

    python -m paddle_tpu_torch.tools.host_io_study [--gb-per-tensor 1.2]
        [--dir DIR]

Four f32 tensors of ``--gb-per-tensor`` GiB each; files go to a fresh
directory under ``--dir`` (default: the temporary directory), removed at
the end, and are read back from a warm page cache. Prints one JSON line:
each measurement's seconds and GB/s, and the card's name and power
limit. Needs a card.
"""
from __future__ import annotations

import argparse
import json
import mmap
import shutil
import subprocess
import tempfile
import time

import torch

from ..framework import checkpoint as ck
from ..resilience import guardian

K = 4                         # tensors a measurement


def _arena(n: int, dev, zero: bool):
    m = mmap.mmap(-1, K * n * 4)
    whole = torch.frombuffer(m, dtype=torch.uint8)
    if zero:
        torch.frombuffer(m, dtype=torch.float32).zero_()
    if not guardian._pin(whole.data_ptr(), K * n * 4, dev):
        raise RuntimeError("page-locking the mapping failed")
    return m, whole.data_ptr(), [
        torch.frombuffer(m, dtype=torch.float32, count=n, offset=i * n * 4)
        for i in range(K)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--gb-per-tensor", type=float, default=1.2)
    ap.add_argument("--dir", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("host_io_study needs a CUDA card")
    n = int(args.gb_per_tensor * 2**30) // 4
    dev = torch.device("cuda", 0)
    src = [torch.randn(n, device=dev) for _ in range(K)]
    torch.cuda.synchronize()
    gb = K * n * 4 / 1e9
    out = {}

    def timed(name, fn):
        t = time.perf_counter()
        r = fn()
        out[name] = time.perf_counter() - t
        return r

    for turn, zero in ((1, False), (1, True), (2, True), (2, False)):
        a = timed(f"pin_{'zeroed' if zero else 'untouched'}_{turn}",
                  lambda: _arena(n, dev, zero))
        if (turn, zero) != (2, False):
            guardian._unpin(a[1])       # before the mapping is freed
            del a
    _, ptr, host = a                    # untouched, as _HostCopy pins
    timed("pin_memory_alloc", lambda: [torch.empty(n, pin_memory=True)
                                       for _ in range(K)])
    t = time.perf_counter()
    for h, s in zip(host, src):
        h.copy_(s, non_blocking=True)
    out["d2h_issue"] = time.perf_counter() - t
    torch.cuda.synchronize()
    out["d2h"] = time.perf_counter() - t
    tree = {f"t{i}": h for i, h in enumerate(host)}
    d = tempfile.mkdtemp(prefix="host_io_study_", dir=args.dir)
    try:
        timed("save_1_writer", lambda: ck.save_checkpoint(
            f"{d}/one", tree, writers=1))
        timed(f"save_{ck.WRITERS}_writers", lambda: ck.save_checkpoint(
            f"{d}/many", tree, writers=ck.WRITERS))
        timed("save_legacy", lambda: [torch.save(
            h, f"{d}/l{i}.pt", _use_new_zipfile_serialization=False)
            for i, h in enumerate(host)])
        timed("write_raw", lambda: [h.numpy().tofile(f"{d}/r{i}.bin")
                                    for i, h in enumerate(host)])

        def load_to_card():
            got = {k: v.to(dev)
                   for k, v in ck.load_checkpoint(f"{d}/many").items()}
            torch.cuda.synchronize()
            return got

        got = timed("load_to_card", load_to_card)
        same = all(torch.equal(got[f"t{i}"], s) for i, s in enumerate(src))
    finally:
        shutil.rmtree(d, ignore_errors=True)
        guardian._unpin(ptr)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"study": "host_io", "gb": gb, "nvidia_smi": smi,
                      "round_trip_equal": same, "seconds": out,
                      "gb_per_s": {k: gb / v for k, v in out.items()
                                   if not k.endswith("_issue")}}))
    if not same:
        raise SystemExit("the checkpoint did not read back equal")


if __name__ == "__main__":
    main()
