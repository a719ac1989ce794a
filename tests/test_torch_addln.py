"""paddle_tpu_torch fused add-LayerNorm (forward and backward) and the
post-LN ``fused_feedforward`` against paddle_tpu.

The port's plain versions (what a CPU tensor runs, and what
chip_smoke.py holds the CUDA kernels against on the card) carry the
kernels' numerics: the residual add in f32, the two-pass variance, f32
mu/rstd, the cotangent rounded to x's dtype. They are compared with the
JAX package's ``fused_add_layernorm(..., interpret=True)`` and its
``jax.vjp`` on the same numpy inputs, in f32 and bf16, at H in {128,
768}. R = 40 has the row block 8 and runs the Pallas kernels in
interpret mode; R = 37 is a multiple of no row block, where the JAX
function takes its composed reference (the add in the compute dtype).

Tolerances, as max |Δ| / max |reference| per output: f32 1e-5 (the same
f32 math, summed in another order); bf16 2e-2 (the same roundings at the
same points, where a sum in another order can cross a bf16 rounding,
3.9e-3 of a value; on the composed path the add rounds to bf16 first).

The post-LN ``fused_feedforward`` (gelu) is held against the JAX one
with FLAGS_fused_kernels 0 and 1, in f32, forward and gradients within
1e-5.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu.core import native as jnative
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.monitor import stat_get
from paddle_tpu_torch.ops import fused_kernels as tfk
from torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)

# the modules (paddle_tpu.ops re-exports functions of the same names)
jfk = importlib.import_module("paddle_tpu.ops.fused_kernels")
jfused = importlib.import_module("paddle_tpu.ops.fused")

TOL = {"f32": 1e-5, "bf16": 2e-2}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _rel(want, got):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert want.shape == got.shape
    return float(np.abs(want - got).max() / max(np.abs(want).max(), 1e-6))


def _inputs(R, H, seed=0):
    rng = np.random.default_rng(seed)
    n = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    return {"x": n(R, H), "y": n(R, H), "s": 1.0 + n(H, sc=0.1),
            "b": n(H, sc=0.1), "do": n(R, H)}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("R,H", [(40, 128), (37, 128), (40, 768),
                                 (37, 768)])
def test_addln_plain_matches_jax(dt, R, H):
    a = _inputs(R, H)
    jdt, tdt = DTYPES[dt]
    args = [jnp.asarray(a["x"], jdt), jnp.asarray(a["y"], jdt),
            jnp.asarray(a["s"]), jnp.asarray(a["b"])]
    out_j, vjp = jax.vjp(lambda x, y, s, b: jfk.fused_add_layernorm(
        x, y, s, b, interpret=True), *args)
    grads_j = vjp(jnp.asarray(a["do"], jdt))
    t = [torch.tensor(a["x"]).to(tdt).requires_grad_(True),
         torch.tensor(a["y"]).to(tdt).requires_grad_(True),
         torch.tensor(a["s"]).requires_grad_(True),
         torch.tensor(a["b"]).requires_grad_(True)]
    out_t = tfk.fused_add_layernorm(*t)
    out_t.backward(torch.tensor(a["do"]).to(tdt))
    assert out_t.dtype == tdt and t[0].grad.dtype == tdt
    assert _rel(out_j, out_t) <= TOL[dt]
    for name, gj, tt in zip("xysb", grads_j, t):
        assert _rel(gj, tt.grad) <= TOL[dt], name


def test_addln_statistics_are_f32_and_two_pass():
    """mu and rstd come back f32 (R, 1) whatever x's dtype, from the f32
    sum of x and y; a large common offset does not cancel the variance
    (two passes, not E[t²] - mu²)."""
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.standard_normal((5, 128)).astype(np.float32))
    y = torch.full((5, 128), 2048.0)     # exact in bf16
    s, b = torch.ones(128), torch.zeros(128)
    out, mu, rstd = tfk._addln_forward_reference(x.bfloat16(), y.bfloat16(),
                                                 s, b, 1e-5)
    assert mu.dtype == rstd.dtype == torch.float32
    assert mu.shape == rstd.shape == (5, 1)
    want = x.bfloat16().float() + 2048.0
    np.testing.assert_allclose(mu.numpy(), want.mean(-1, keepdim=True),
                               rtol=1e-6)
    np.testing.assert_allclose(
        rstd.numpy(), 1.0 / np.sqrt(want.var(-1, unbiased=False,
                                             keepdim=True).numpy() + 1e-5),
        rtol=1e-4)


def test_cpu_tensors_count_no_launch():
    before = (tfk.ADDLN_FWD_LAUNCHES, tfk.ADDLN_BWD_LAUNCHES)
    x = torch.randn(8, 64, requires_grad=True)
    tfk.fused_add_layernorm(x, torch.randn(8, 64), torch.ones(64),
                            torch.zeros(64)).sum().backward()
    assert x.grad is not None
    assert (tfk.ADDLN_FWD_LAUNCHES, tfk.ADDLN_BWD_LAUNCHES) == before


@pytest.mark.parametrize("case", ["dtype", "width", "shape"])
def test_card_contract_raises_before_launch(case):
    """What the kernels do not take raises before anything is built or
    launched (checked here on CPU tensors, as the card wrapper checks
    them first)."""
    H = tfk.ADDLN_MAX_H + 8 if case == "width" else 64
    dt = torch.float16 if case == "dtype" else torch.float32
    x = torch.zeros(4, H, dtype=dt)
    y = torch.zeros(3 if case == "shape" else 4, H, dtype=dt)
    s, b = torch.ones(H), torch.zeros(H)
    err = TypeError if case == "dtype" else ValueError
    with pytest.raises(err):
        tfk._addln_launch_fwd(x, y, s, b, 1e-5)
    with pytest.raises(err):
        tfk._addln_launch_bwd(x, y, s, torch.zeros(4, 1), torch.ones(4, 1),
                              x)


@pytest.fixture
def fused_flag():
    """Sets FLAGS_fused_kernels on both packages; restores both after."""
    old = (jnative.fused_kernels[0], tflags.fused_kernels[0])

    def set_(on):
        paddle_tpu.set_flags({"FLAGS_fused_kernels": on})
        paddle_tpu_torch.set_flags({"FLAGS_fused_kernels": on})

    yield set_
    jnative.fused_kernels[0], tflags.fused_kernels[0] = old


@pytest.mark.parametrize("flag", [0, 1])
def test_post_ln_fused_feedforward_matches_jax(fused_flag, flag):
    fused_flag(flag)
    rng = np.random.default_rng(2)
    n = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    arrs = [n(2, 24, 128), n(128, 512, sc=0.05), n(512, sc=0.1),
            n(512, 128, sc=0.05), n(128, sc=0.1), 1.0 + n(128, sc=0.1),
            n(128, sc=0.1)]
    dy = n(2, 24, 128)
    kw = dict(pre_layer_norm=False, activation="gelu")
    jt = [paddle_tpu.to_tensor(a, stop_gradient=False) for a in arrs]
    out_j = jfused.fused_feedforward(*jt, **kw)
    grads_j = paddle_tpu.grad(out_j, jt, paddle_tpu.to_tensor(dy))
    tt = [paddle_tpu_torch.to_tensor(a, place="cpu", stop_gradient=False)
          for a in arrs]
    calls = stat_get("fused_kernel_calls")
    out_t = paddle_tpu_torch.ops.fused_feedforward(*tt, **kw)
    grads_t = paddle_tpu_torch.grad(out_t, tt,
                                    paddle_tpu_torch.to_tensor(dy,
                                                               place="cpu"))
    assert stat_get("fused_kernel_calls") == calls + flag
    assert _rel(out_j.numpy(), out_t._data) <= 1e-5
    for gj, gt in zip(grads_j, grads_t):
        assert _rel(gj.numpy(), gt._data) <= 1e-5
