"""paddle_tpu_torch fused LN-MLP (forward and backward) against
paddle_tpu.

The port's plain versions (what a CPU tensor runs, and what
chip_smoke.py holds the CUDA kernels against on the card) carry the
kernels' numerics. They are compared with the JAX package's Pallas
kernels run in interpret mode (``fused_ln_mlp(..., interpret=True)``:
the forward kernel, and through ``jax.vjp`` the backward and dW2
kernels), on the same numpy inputs, for gelu, relu and swiglu, in f32
and bf16, at a tileable shape (R = 32, H = 128, M = 512).

Tolerances, as max |Δ| / max |reference| per output: f32 1e-5 (the same
f32 math, summed in another order); bf16 1e-2 (the same roundings at the
same points; a different summation order can move an f32 sum across a
bf16 rounding boundary, about 4e-3 of a value).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import fused_kernels as tfk

# the module (paddle_tpu.ops re-exports a function of the same name)
jfk = importlib.import_module("paddle_tpu.ops.fused_kernels")

TOL = {"f32": 1e-5, "bf16": 1e-2}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
NAMES = ("x", "w1", "b1", "w2", "b2", "w_gate", "b_gate", "ln_scale",
         "ln_bias")


def _inputs(R=32, H=128, M=512, seed=0):
    rng = np.random.default_rng(seed)
    n = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    return {"x": n(R, H), "w1": n(H, M, sc=0.05), "b1": n(M, sc=0.1),
            "w2": n(M, H, sc=0.05), "b2": n(H, sc=0.1),
            "w_gate": n(H, M, sc=0.05), "b_gate": n(M, sc=0.1),
            "ln_scale": 1.0 + n(H, sc=0.1), "ln_bias": n(H, sc=0.1),
            "dy": n(R, H)}


def _rel(want, got):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert want.shape == got.shape
    return float(np.abs(want - got).max() / max(np.abs(want).max(), 1e-6))


def _jax_run(arrs, act, dt, residual=True, with_ln=True):
    jdt = DTYPES[dt][0]
    gate = act == "swiglu"

    def f(x, w1, b1, w2, b2, wg, bg, s, b):
        return jfk.fused_ln_mlp(
            x, w1, b1, w2, b2, ln_scale=s if with_ln else None,
            ln_bias=b if with_ln else None, residual=residual, act=act,
            w_gate=wg if gate else None, b_gate=bg if gate else None,
            interpret=True)

    args = [jnp.asarray(arrs[k], jnp.float32 if k.startswith("ln_")
                        else jdt) for k in NAMES]
    y, vjp = jax.vjp(f, *args)
    return y, vjp(jnp.asarray(arrs["dy"], jdt))


def _torch_run(arrs, act, dt, residual=True, with_ln=True):
    tdt = DTYPES[dt][1]
    gate = act == "swiglu"
    t = {k: torch.from_numpy(arrs[k]).to(
        torch.float32 if k.startswith("ln_") else tdt).requires_grad_(True)
        for k in NAMES}
    y = tfk.fused_ln_mlp(
        t["x"], t["w1"], t["b1"], t["w2"], t["b2"],
        ln_scale=t["ln_scale"] if with_ln else None,
        ln_bias=t["ln_bias"] if with_ln else None, residual=residual,
        act=act, w_gate=t["w_gate"] if gate else None,
        b_gate=t["b_gate"] if gate else None)
    y.backward(torch.from_numpy(arrs["dy"]).to(tdt))
    return y, t


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("act", ["gelu", "relu", "swiglu"])
def test_plain_forward_and_backward_match_pallas_interpret(act, dt):
    arrs = _inputs(seed={"gelu": 0, "relu": 1, "swiglu": 2}[act])
    y_j, grads_j = _jax_run(arrs, act, dt)
    y_t, t = _torch_run(arrs, act, dt)
    assert y_t.dtype == DTYPES[dt][1]
    assert _rel(y_j, y_t) <= TOL[dt]
    for name, g in zip(NAMES, grads_j):
        if name in ("w_gate", "b_gate") and act != "swiglu":
            assert t[name].grad is None
            continue
        assert t[name].grad.dtype == t[name].dtype, name
        assert _rel(g, t[name].grad) <= TOL[dt], name


@pytest.mark.parametrize("residual,with_ln", [(False, True), (True, False)])
def test_without_residual_or_layernorm(residual, with_ln):
    arrs = _inputs(seed=3)
    y_j, grads_j = _jax_run(arrs, "gelu", "f32", residual, with_ln)
    y_t, t = _torch_run(arrs, "gelu", "f32", residual, with_ln)
    assert _rel(y_j, y_t) <= TOL["f32"]
    for name, g in zip(NAMES[:5], grads_j[:5]):
        assert _rel(g, t[name].grad) <= TOL["f32"], name


@pytest.mark.parametrize("act", ["gelu", "swiglu"])
def test_composed_reference_matches_jax_composed(act):
    """The unfused op sequence (what JAX's fused entry runs off-TPU) is
    the same in both packages; in f32 the kernels' numerics agree with
    it to the summation order."""
    arrs = _inputs(R=24, H=64, M=256, seed=4)
    j = {k: jnp.asarray(v) for k, v in arrs.items()}
    t = {k: torch.from_numpy(v) for k, v in arrs.items()}
    args = ("x", "ln_scale", "ln_bias", "w1", "b1", "w2", "b2", "w_gate",
            "b_gate")
    want = jfk._ln_mlp_reference(*(j[k] for k in args), act, True, True,
                                 1e-5)
    got = tfk._ln_mlp_reference(*(t[k] for k in args), act, True, True,
                                1e-5)
    assert _rel(want, got) <= TOL["f32"]
    y, mu, rstd = tfk._fmlp_forward_reference(
        t["x"], t["ln_scale"], t["ln_bias"], t["w1"], t["b1"], t["w2"],
        t["b2"], t["w_gate"], t["b_gate"], act, True, True, 1e-5)
    assert mu.shape == rstd.shape == (24, 1)
    assert _rel(want, y) <= TOL["f32"]


def test_any_row_count_and_leading_dims_on_cpu():
    """The plain version takes any R (the kernels mask the ragged row
    tile); leading dims are flattened and restored."""
    arrs = _inputs(R=21, H=64, M=128, seed=5)
    t = {k: torch.from_numpy(v) for k, v in arrs.items()}
    x = t["x"].reshape(3, 7, 64)
    got = tfk.fused_ln_mlp(x, t["w1"], t["b1"], t["w2"], t["b2"],
                           ln_scale=t["ln_scale"], ln_bias=t["ln_bias"])
    want = tfk._ln_mlp_reference(t["x"], t["ln_scale"], t["ln_bias"],
                                 t["w1"], t["b1"], t["w2"], t["b2"], None,
                                 None, "gelu", True, True, 1e-5)
    assert got.shape == (3, 7, 64)
    np.testing.assert_allclose(got.reshape(21, 64).numpy(), want.numpy(),
                               atol=1e-5, rtol=1e-5)


def test_cpu_tensor_counts_no_launch():
    arrs = _inputs(R=8, H=64, M=128, seed=6)
    t = {k: torch.from_numpy(v).requires_grad_(True) for k, v in
         arrs.items()}
    before = (tfk.FWD_LAUNCHES, tfk.BWD_LAUNCHES, tfk.DW2_LAUNCHES)
    y = tfk.fused_ln_mlp(t["x"], t["w1"], t["b1"], t["w2"], t["b2"],
                         ln_scale=t["ln_scale"], ln_bias=t["ln_bias"])
    y.sum().backward()
    assert (tfk.FWD_LAUNCHES, tfk.BWD_LAUNCHES, tfk.DW2_LAUNCHES) == before


@pytest.mark.parametrize("h,m", [(96, 256), (64, 200)])
def test_kernel_shape_contract(h, m):
    """The kernels take H and M that are multiples of 64 and refuse the
    rest (no fallback); the check runs before any launch."""
    x = torch.zeros(4, h)
    with pytest.raises(ValueError, match="multiples of 64"):
        tfk._check_card(x, torch.zeros(h, m), torch.zeros(m, h), None)
    tfk._check_card(torch.zeros(5, 128), torch.zeros(128, 256),
                    torch.zeros(256, 128), None)


def test_bad_activation_and_missing_gate_raise():
    x = torch.zeros(2, 64)
    w1, w2 = torch.zeros(64, 128), torch.zeros(128, 64)
    b1, b2 = torch.zeros(128), torch.zeros(64)
    with pytest.raises(ValueError, match="act"):
        tfk.fused_ln_mlp(x, w1, b1, w2, b2, act="tanh")
    with pytest.raises(ValueError, match="w_gate"):
        tfk.fused_ln_mlp(x, w1, b1, w2, b2, act="swiglu")
