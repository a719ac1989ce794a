"""Build and load the hand-written CUDA kernels of ``paddle_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its
own by ``nvcc`` for Hopper into ``paddle_tpu_torch/_build/lib<name>_<hash>.so``
(the hash covers the source, the shared headers and the flags, so an
edited kernel rebuilds and a stale library is never loaded), then loaded
with ``ctypes``. Nothing is built at import: :func:`load` builds at first
use, :func:`build_all` builds every source at once with one ``nvcc``
process per file running in parallel. A failed build raises; there is no
fallback.

Calling convention of every entry point: device pointers and the CUDA
stream are ``c_void_p`` (the stream is PyTorch's current stream), sizes
are ``c_int``, and the return value is ``cudaGetLastError()`` right after
the launch, which :func:`check` turns into an exception. The Hopper
kernels' TMA tensor maps need 16-byte-aligned bases: :func:`aligned16`
copies an operand that is not.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["NVCC_FLAGS", "EXTRA_FLAGS", "SOURCES", "load", "build_all",
           "check", "build_log", "aligned16"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
SOURCES = ("flash_attention_fwd", "paged_attention", "flash_attention_bwd",
           "fused_ln_mlp", "fused_optimizer", "int8_matmul", "moe_dispatch",
           "fp8_matmul", "fused_add_ln")
# per-source flags on top of NVCC_FLAGS. -fmad=false: no multiply-add is
# contracted into an FMA, so every f32 operation rounds where the plain
# PyTorch version's separate operations round, and the kernels' outputs
# are bit-identical to those versions'
EXTRA_FLAGS = {"fused_optimizer": ["-fmad=false"],
               "int8_matmul": ["-fmad=false"],
               "fp8_matmul": ["-fmad=false"]}

_lock = threading.Lock()
_libs: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels of "
                       "paddle_tpu_torch are built from source at first use")


def _target(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS + EXTRA_FLAGS.get(name, [])).encode())
    return BUILD / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """What nvcc/ptxas printed for the current build of ``name`` (register
    and shared-memory use per kernel), or '' when not built here."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _start(name: str):
    """Spawn nvcc for one source; returns (proc, tmp, target) or None when
    the library is already built."""
    target = _target(name)
    if target.exists():
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *EXTRA_FLAGS.get(name, []), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(name: str, started) -> None:
    proc, tmp, target = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    target.with_suffix(".log").write_text(out)
    os.replace(tmp, target)   # atomic: a concurrent loader never sees half


def build_all() -> None:
    """Build every kernel source at once (one nvcc per file, in parallel)."""
    with _lock:
        started = {n: _start(n) for n in SOURCES}
        errors = []
        for n, s in started.items():
            if s is None:
                continue
            try:
                _finish(n, s)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            started = _start(name)
            if started is not None:
                _finish(name, started)
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib.ptt_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err} ({msg}) at launch")


def aligned16(*ts):
    """The tensors (None passes) with each whose base is not 16-byte
    aligned replaced by an aligned copy."""
    return tuple(t if t is None or t.data_ptr() % 16 == 0 else t.clone()
                 for t in ts)
