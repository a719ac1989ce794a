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
import contextlib
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import fused_kernels as tfk
from torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)

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


@pytest.mark.parametrize("dtype,kernel", [(torch.bfloat16, "wgmma"),
                                          (torch.float32, "fma")])
def test_backward_kernel_rule(dtype, kernel):
    """bf16 backward (every activation) runs the Hopper GEMMs, f32 the FMA
    mainloop: the rule the C entry points apply, decided without a card."""
    assert tfk.mlp_bwd_kernel_for(dtype) == kernel


def test_backward_kernel_rule_refuses_other_dtypes():
    with pytest.raises(TypeError, match="f32 or bf16"):
        tfk.mlp_bwd_kernel_for(torch.float16)


@pytest.mark.parametrize("dtype,kernel", [(torch.bfloat16, "wgmma"),
                                          (torch.float32, "fma")])
def test_forward_kernel_rule(dtype, kernel):
    """bf16 forward (every activation) runs the Hopper GEMMs, f32 the FMA
    mainloop: the rule the C entry point applies, decided without a
    card."""
    assert tfk.mlp_fwd_kernel_for(dtype) == kernel


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_forward_kernel_rule_refuses_other_dtypes(dtype):
    with pytest.raises(TypeError, match="f32 or bf16"):
        tfk.mlp_fwd_kernel_for(dtype)


def _fwd_operands(R, H, M, dtype=torch.bfloat16, gate=False):
    g = torch.Generator().manual_seed(R + H + M)
    n = lambda *s: (0.1 * torch.randn(s, generator=g)).to(dtype)
    return {"x2": n(R, H), "lns": torch.ones(H), "lnb": torch.zeros(H),
            "w1": n(H, M), "b1": n(M), "w2": n(M, H), "b2": n(H),
            "wg": n(H, M) if gate else None, "bg": n(M) if gate else None}


@pytest.mark.parametrize("change,err,match", [
    (dict(x2=(8, 96), w1=(96, 256), w2=(256, 96), b2=(96,)), ValueError,
     "multiples of 64"),
    (dict(w1=(64, 200), b1=(200,), w2=(200, 64)), ValueError,
     "multiples of 64"),
    (dict(w2=(256, 128)), ValueError, "do not fit"),
    (dict(wg=(128, 256)), ValueError, "do not fit"),
    (dict(dtype=torch.float16), TypeError, "f32 or bf16")])
def test_forward_launch_refuses_before_any_launch(change, err, match):
    """The forward wrapper checks widths, weight shapes and the dtype
    before it loads or launches anything (so here, without nvcc)."""
    ops = _fwd_operands(8, 64, 256, dtype=change.pop("dtype",
                                                     torch.bfloat16))
    for k, shape in change.items():
        ops[k] = torch.zeros(shape, dtype=ops["x2"].dtype)
    before = tfk.FWD_LAUNCHES
    with pytest.raises(err, match=match):
        tfk._launch_fwd(ops["x2"], ops["lns"], ops["lnb"], ops["w1"],
                        ops["b1"], ops["w2"], ops["b2"], ops["wg"],
                        ops["bg"], "gelu", True, True, 1e-5)
    assert tfk.FWD_LAUNCHES == before


class _FakeForwardLib:
    """Stands in for the built library: records fmlp_forward's pointer
    arguments and reports success."""

    def __init__(self):
        self.args = None

    def fmlp_forward(self, *args):
        self.args = args
        return 0


@pytest.mark.parametrize("act", ["gelu", "swiglu"])
def test_forward_launch_copies_unaligned_operands(monkeypatch, act):
    """x, the weights and the biases as views off a 16-byte boundary: the
    forward wrapper hands the C entry point (whose tensor maps and paired
    reads need 16-byte-aligned bases) an aligned copy of each, and every
    buffer it allocates is aligned too."""
    gate = act == "swiglu"
    ops = _fwd_operands(37, 64, 128, gate=gate)

    def unaligned(v):
        buf = torch.empty(v.numel() + 1, dtype=v.dtype)
        out = buf[1:].view(v.shape)
        out.copy_(v)
        assert out.data_ptr() % 16 != 0
        return out

    names = ("x2", "w1", "b1", "w2", "b2") + (("wg", "bg") if gate else ())
    for k in names:
        ops[k] = unaligned(ops[k])
    lib = _FakeForwardLib()
    monkeypatch.setattr(tfk, "_load", lambda: lib)
    monkeypatch.setattr(tfk, "_stream", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    before = tfk.FWD_LAUNCHES
    tfk._launch_fwd(ops["x2"], ops["lns"], ops["lnb"], ops["w1"],
                    ops["b1"], ops["w2"], ops["b2"], ops["wg"], ops["bg"],
                    act, True, True, 1e-5)
    assert tfk.FWD_LAUNCHES == before + 1
    # x, lns, lnb, w1, b1, w2, b2, wg, bg, y, mu, rstd, lnx, a
    ptrs = lib.args[:14]
    for i in (0, 3, 4, 5, 6, 9, 12, 13) + ((7, 8) if gate else ()):
        assert ptrs[i] % 16 == 0, i
    if not gate:
        assert ptrs[7] == 0 and ptrs[8] == 0


@pytest.mark.parametrize("a_shape,dy_shape,dtypes,match", [
    ((10, 96), (10, 128), (torch.bfloat16,) * 2, "multiples of 64"),
    ((10, 128), (10, 96), (torch.bfloat16,) * 2, "multiples of 64"),
    ((10, 128), (11, 128), (torch.bfloat16,) * 2, "do not fit"),
    ((10, 128), (10, 128), (torch.bfloat16, torch.float32), "do not fit")])
def test_dw2_kernel_refuses_before_any_launch(a_shape, dy_shape, dtypes,
                                              match):
    a = torch.zeros(a_shape, dtype=dtypes[0])
    dy = torch.zeros(dy_shape, dtype=dtypes[1])
    with pytest.raises(ValueError, match=match):
        tfk._launch_dw2(a, dy)


def test_aligned16_copies_unaligned_operands_and_passes_none():
    """The Hopper kernels' tensor maps need 16-byte-aligned bases: an
    unaligned view is copied, an aligned tensor and None pass as they
    are."""
    buf = torch.zeros(64 * 64 + 1, dtype=torch.bfloat16)
    ok, bad = buf[:64 * 64].view(64, 64), buf[1:].view(64, 64)
    got = _build.aligned16(ok, None, bad)
    assert got[0] is ok and got[1] is None and got[2] is not bad
    assert got[2].data_ptr() % 16 == 0 and torch.equal(got[2], bad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual,has_ln", [(True, True), (False, True),
                                             (True, False)])
def test_kernel_path_rows_match_the_plain_ln_backward(dtype, residual,
                                                      has_ln):
    """The PyTorch work the kernel path runs after its GEMMs (aten's LN
    backward, db2, the residual add in place) gives the plain version's
    dx, dscale, dbias and db2, to f32 summation order (1e-5 of each
    output's largest value)."""
    g = torch.Generator().manual_seed(3)
    R, H = 37, 192
    x2 = (torch.randn(R, H, generator=g) * 2 + 0.3).to(dtype)
    dy = torch.randn(R, H, generator=g).to(dtype)
    dlnx = torch.randn(R, H, generator=g)
    lns = 1.0 + 0.1 * torch.randn(H, generator=g)
    lnb = 0.1 * torch.randn(H, generator=g)
    x32 = x2.float()
    mu = x32.mean(-1, keepdim=True)
    rstd = torch.rsqrt((x32 - mu).square().mean(-1, keepdim=True) + 1e-5)
    dx, dscale, dbias = tfk._ln_backward(dlnx, x2, lns, mu, rstd, has_ln)
    if residual:
        dx = dx + dy.float()
    want = (dx, dscale, dbias, dy.float().sum(0))
    got = tfk._bwd_rows(dlnx.clone(), x2, lns, lnb, mu, rstd, dy, residual,
                        has_ln)
    for w, o in zip(want, got):
        assert o.dtype == torch.float32 and o.shape == w.shape
        scale = max(w.abs().max().item(), 1e-6)
        assert (o - w).abs().max().item() <= 1e-5 * scale
