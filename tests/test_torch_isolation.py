"""paddle_tpu_torch stands alone: no module of the port, and not
chip_smoke.py, imports jax, jaxlib or paddle_tpu (an AST scan of every
import statement), and the package imports in a fresh interpreter where
``triton`` cannot be imported and no ``nvcc`` is on the PATH, without
pulling in JAX."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")
SOURCES = sorted((ROOT / "paddle_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_or_paddle_tpu_import(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_scan_sees_every_module():
    names = {p.relative_to(ROOT).as_posix() for p in SOURCES}
    for want in ("paddle_tpu_torch/ops/flash_attention.py",
                 "paddle_tpu_torch/ops/paged_attention.py",
                 "paddle_tpu_torch/serving/engine.py",
                 "paddle_tpu_torch/models/gpt.py",
                 "paddle_tpu_torch/ops/fused_kernels.py",
                 "paddle_tpu_torch/parallel/train_step.py",
                 "paddle_tpu_torch/ops/fused_optimizer.py",
                 "paddle_tpu_torch/ops/int8_matmul.py",
                 "paddle_tpu_torch/ops/moe_dispatch.py",
                 "paddle_tpu_torch/ops/fp8_matmul.py",
                 "paddle_tpu_torch/nn/moe.py", "paddle_tpu_torch/amp/fp8.py",
                 "paddle_tpu_torch/framework/core.py",
                 "paddle_tpu_torch/nn/layer/transformer.py",
                 "paddle_tpu_torch/optimizer/optimizer.py",
                 "paddle_tpu_torch/ops/fused.py",
                 "paddle_tpu_torch/tensor/logic.py",
                 "paddle_tpu_torch/serving/tokenizer.py",
                 "paddle_tpu_torch/serving/constrained.py",
                 "paddle_tpu_torch/serving/prefix_cache.py",
                 "paddle_tpu_torch/serving/overload.py",
                 "paddle_tpu_torch/monitor/trace.py",
                 "paddle_tpu_torch/monitor/tracectx.py",
                 "paddle_tpu_torch/monitor/flight.py",
                 "paddle_tpu_torch/resilience/faults.py",
                 "paddle_tpu_torch/resilience/sentinel.py",
                 "paddle_tpu_torch/serving/router.py",
                 "paddle_tpu_torch/serving/lifecycle.py",
                 "paddle_tpu_torch/serving/frontend.py", "chip_smoke.py"):
        assert want in names


def test_imports_without_triton_nvcc_or_jax():
    code = (
        "import sys\n"
        "sys.modules['triton'] = None\n"
        "import paddle_tpu_torch, paddle_tpu_torch.models,"
        " paddle_tpu_torch.serving, paddle_tpu_torch.ops.flash_attention,"
        " paddle_tpu_torch.ops.paged_attention, paddle_tpu_torch.ops._build,"
        " paddle_tpu_torch.ops.fused_kernels, paddle_tpu_torch.parallel,"
        " paddle_tpu_torch.ops.fused_optimizer,"
        " paddle_tpu_torch.ops.int8_matmul,"
        " paddle_tpu_torch.ops.moe_dispatch, paddle_tpu_torch.ops.fp8_matmul,"
        " paddle_tpu_torch.nn, paddle_tpu_torch.amp,"
        " paddle_tpu_torch.tools.profile_train, paddle_tpu_torch.ops.fused,"
        " paddle_tpu_torch.optimizer, paddle_tpu_torch.nn.functional,"
        " paddle_tpu_torch.serving.tokenizer, paddle_tpu_torch.monitor,"
        " paddle_tpu_torch.resilience, paddle_tpu_torch.serving.overload,"
        " paddle_tpu_torch.serving.constrained,"
        " paddle_tpu_torch.serving.prefix_cache,"
        " paddle_tpu_torch.serving.router,"
        " paddle_tpu_torch.serving.lifecycle,"
        " paddle_tpu_torch.serving.frontend\n"
        "bad = sorted(m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'jaxlib', 'paddle_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = "/usr/bin:/bin"
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
