"""paddle_tpu_torch fp8 (e4m3) path against paddle_tpu.

``quantize_fp8`` (the e4m3 bytes, saturation and values below the
smallest subnormal included), the fp8 matmul's plain version against
the Pallas kernel in interpret mode at tileable shapes and against
JAX's reference at ragged M and K, ``fp8_linear`` forward and its
straight-through gradients, the delayed-scaling state machine and the
``DelayedScaling`` state-dict round trip; then ``GPTConfig(fp8=True)``
at gpt_tiny width: ``gpt_loss`` and every gradient against
``jax.value_and_grad``, ``FLAGS_fp8_matmul=1`` giving the same result,
fp8 off bit-identical to the model without fp8, fp8 winning over
``fused_mlp``, and the fixed-slot prefill's logits. Inputs are made
with numpy and fed to both packages.

Tolerances: quantization bytes and the delayed-scaling state are equal
(the same f32 operations, round half to even). The matmul: f32 output
1e-6 of the largest value (exact products, f32 sums in another order);
bf16 output 4e-3 of the largest value (a sum in another order can
cross one bf16 rounding). fp8_linear: output 1e-5 and gradients 1e-5
of the largest value. The model: loss 1e-5 absolute, gradients 2e-3 of
a leaf's largest value and logits 5e-4, as the dense model is held
(tests/test_torch_train.py, tests/test_torch_gpt.py); the activations
the two packages quantize agree to f32 rounding, so an activation whose
value sits on an e4m3 rounding boundary could take the neighbouring
code, which these bounds cover.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.amp import fp8 as jf
from paddle_tpu.models import gpt as jg
from paddle_tpu.ops import fp8_matmul as jfm
from paddle_tpu_torch.amp import fp8 as tf
from paddle_tpu_torch.core import flags
from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.monitor.stats import stat_get
from paddle_tpu_torch.ops import fp8_matmul as tfm
from paddle_tpu_torch.parallel import train_step as tts
from paddle_tpu_torch.serving import InferenceEngine
from torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)

CFG_J = jg.gpt_tiny(dtype=jnp.float32, fp8=True)
CFG_T = tg.gpt_tiny(dtype=torch.float32, fp8=True)
BF16_OUT_REL = 4e-3
GRAD_TOL = 2e-3
F32_LOGITS_TOL = 5e-4


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _rel(want, got):
    want, got = _np(want), _np(got)
    assert want.shape == got.shape
    return float(np.abs(want - got).max() / max(np.abs(want).max(), 1e-12))


def _codes(q):
    if isinstance(q, torch.Tensor):
        return q.view(torch.uint8).numpy()
    return np.asarray(q).view(np.uint8)


# -- quantization and the matmul ------------------------------------------------

@pytest.mark.parametrize("scale", [1.0, 0.37, 1e-13])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_fp8_bytes_match_jax(scale, dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((32, 96)) * 3).astype(np.float32)
    x[0, :4] = [1e4, -1e4, 448.5, -500.0]                 # saturation
    x[1, :6] = [1e-9, 3e-3, 1e-6, -2e-3, 0.0, 9.7e-4]     # tiny values
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    if dtype == "bf16":
        xj, xt = xj.astype(jnp.bfloat16), xt.to(torch.bfloat16)
    want = _codes(jf.quantize_fp8(xj, scale))
    got = tf.quantize_fp8(xt, scale)
    assert got.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(_codes(got), want)


def _operands(M, K, N, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * 0.1).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32)
    sx = np.float32(np.abs(x).max() / 448.0)
    sw = np.float32(np.abs(w).max() / 448.0)
    xq = jf.quantize_fp8(jnp.asarray(x), sx)
    wq = jf.quantize_fp8(jnp.asarray(w), sw)
    port = (torch.from_numpy(_codes(xq).copy()).view(torch.float8_e4m3fn),
            torch.from_numpy(_codes(wq).copy()).view(torch.float8_e4m3fn),
            torch.tensor(sx), torch.tensor(sw), torch.from_numpy(b))
    return (xq, wq, jnp.float32(sx), jnp.float32(sw), jnp.asarray(b)), port


def _check(got, want, out):
    if out == "f32":
        assert got.dtype == torch.float32
        assert _rel(want, got) <= 1e-6
    else:
        assert got.dtype == torch.bfloat16
        assert _rel(want, got) <= BF16_OUT_REL


OUT = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("M,K,N,bias", [(32, 128, 128, True),
                                        (64, 256, 128, False),
                                        (32, 128, 256, True)])
def test_plain_matmul_matches_interpret_kernel(out, M, K, N, bias):
    (xq, wq, sx, sw, b), (xt, wt, sxt, swt, bt) = _operands(M, K, N)
    want = jfm._fp8_matmul_2d(xq, wq, sx, sw, b if bias else None,
                              OUT[out][0], interpret=True)
    got = tfm.fp8_matmul_arrays(xt, wt, sxt, swt, bt if bias else None,
                                out_dtype=OUT[out][1])
    _check(got, want, out)


@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("M,K,N", [(1, 48, 40), (7, 100, 24), (33, 128, 17)])
def test_plain_matmul_matches_reference_at_ragged_shapes(out, M, K, N):
    (xq, wq, sx, sw, b), (xt, wt, sxt, swt, bt) = _operands(M, K, N, seed=2)
    want = jfm._fp8_matmul_ref(xq, wq, sx, sw, b, OUT[out][0])
    before = stat_get("fp8_matmul_calls")
    got = tfm.fp8_matmul_arrays(xt, wt, sxt, swt, bt, out_dtype=OUT[out][1])
    assert stat_get("fp8_matmul_calls") == before + 1
    _check(got, want, out)
    # float scales and leading dims, as the JAX entry takes them
    got3 = tfm.fp8_matmul_arrays(xt.reshape(1, M, K), wt, float(sxt),
                                 float(swt), bt, out_dtype=OUT[out][1])
    assert torch.equal(got3[0], got)


@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("M,K,N", [(32, 128, 256), (7, 100, 24)])
def test_plain_matmul_is_bit_identical_for_either_weight_layout(out, M, K,
                                                                N):
    """The kernel reads a column-major wq in place and transposes a
    row-major one; the plain version gives the same bits for both."""
    _, (xt, wt, sxt, swt, bt) = _operands(M, K, N, seed=4)
    col = wt.t().contiguous().t()
    assert col.t().is_contiguous() and not col.is_contiguous()
    assert torch.equal(col.view(torch.uint8), wt.view(torch.uint8))
    row_out = tfm.fp8_matmul_arrays(xt, wt, sxt, swt, bt,
                                    out_dtype=OUT[out][1])
    col_out = tfm.fp8_matmul_arrays(xt, col, sxt, swt, bt,
                                    out_dtype=OUT[out][1])
    assert torch.equal(row_out, col_out)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_weight_quantized_into_an_nk_buffer(dtype):
    """quantize_fp8(k_major=True), as _Fp8MM quantizes the weight, writes
    its e4m3 codes straight into an (N, K) buffer (the kernel's K-major
    operand): the same codes as the row-major cast and as JAX's, and the
    STE backward reads the (K, N) view unchanged."""
    rng = np.random.default_rng(5)
    w = torch.from_numpy((rng.standard_normal((128, 96)) * 0.1)
                         .astype(np.float32)).to(OUT[dtype][1])
    sw = tf._jit_scale(w)
    col = tf.quantize_fp8(w, sw, k_major=True)
    assert col.shape == (128, 96) and col.t().is_contiguous()
    assert torch.equal(col.view(torch.uint8),
                       tf.quantize_fp8(w, sw).view(torch.uint8))
    want = _codes(jf.quantize_fp8(jnp.asarray(w.float().numpy()).astype(
        jnp.float32 if dtype == "f32" else jnp.bfloat16), float(sw)))
    np.testing.assert_array_equal(col.contiguous().view(torch.uint8).numpy(),
                                  want)


# -- fp8_linear and delayed scaling ----------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fp8_linear_forward_and_ste_grads_match_jax(dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 16, 128)).astype(np.float32)
    w = (rng.standard_normal((128, 96)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(96) * 0.1).astype(np.float32)
    dy = rng.standard_normal((4, 16, 96)).astype(np.float32)
    jdt, tdt = OUT[dtype]
    xj, wj, bj = (jnp.asarray(a).astype(jdt) for a in (x, w, b))
    y_j, vjp = jax.vjp(lambda a, c: jf.fp8_linear(a, c, bj), xj, wj)
    gx_j, gw_j = vjp(jnp.asarray(dy).astype(jdt))
    xt, wt = (torch.from_numpy(a).to(tdt).requires_grad_(True)
              for a in (x, w))
    y_t = tf.fp8_linear(xt, wt, torch.from_numpy(b).to(tdt))
    gx_t, gw_t = torch.autograd.grad(y_t, (xt, wt),
                                     torch.from_numpy(dy).to(tdt))
    assert y_t.dtype == gx_t.dtype == gw_t.dtype == tdt
    tol = 1e-5 if dtype == "f32" else BF16_OUT_REL
    assert _rel(y_j, y_t) <= tol
    assert _rel(gx_j, gx_t) <= tol
    assert _rel(gw_j, gw_t) <= tol


def test_delayed_scaling_state_machine_matches_jax():
    rng = np.random.default_rng(4)
    st_j, st_t = jf.init_delayed_state(window=4), tf.init_delayed_state(
        4, device="cpu")
    xst_j, xst_t = jf.init_delayed_state(4), tf.init_delayed_state(
        4, device="cpu")
    w = (rng.standard_normal((32, 24)) * 0.2).astype(np.float32)
    for step in range(6):
        x = (rng.standard_normal((8, 32)) * (1 + step)).astype(np.float32)
        y_j, xst_j, st_j = jf.fp8_linear_delayed(
            jnp.asarray(x), jnp.asarray(w), xst_j, st_j)
        y_t, xst_t, st_t = tf.fp8_linear_delayed(
            torch.from_numpy(x), torch.from_numpy(w), xst_t, st_t)
        assert _rel(y_j, y_t) <= 1e-5
        for a, c in ((xst_j, xst_t), (st_j, st_t)):
            np.testing.assert_array_equal(c["amax_history"].numpy(),
                                          np.asarray(a["amax_history"]))
            assert float(tf.delayed_scale(c)) == float(jf.delayed_scale(a))
    # a 448 amax keeps scale 1.0 for `window` steps, then it decays
    st = tf.update_delayed_state(tf.init_delayed_state(4, device="cpu"),
                                 torch.tensor([448.0]))
    assert float(st["scale"]) == 1.0
    for _ in range(3):
        st = tf.update_delayed_state(st, torch.tensor([44.8]))
        assert float(st["scale"]) == 1.0
    st = tf.update_delayed_state(st, torch.tensor([44.8]))
    assert float(st["scale"]) == pytest.approx(0.1)


def test_delayed_scaling_state_dict_round_trip():
    fp8 = tf.DelayedScaling(window=8, device="cpu")
    fp8["fc_x"] = tf.update_delayed_state(fp8["fc_x"], torch.tensor([3.5]))
    fp8["fc_w"] = tf.update_delayed_state(fp8["fc_w"], torch.tensor([0.7]))
    snap = fp8.state_dict()
    other = tf.DelayedScaling(window=8, device="cpu")
    other.load_state_dict(snap)
    assert other.names() == fp8.names() == ["fc_w", "fc_x"]
    for name in fp8.names():
        for k in ("amax_history", "scale"):
            assert torch.equal(other[name][k], fp8[name][k])
    # the snapshot is a copy: later updates do not reach it
    fp8["fc_x"] = tf.update_delayed_state(fp8["fc_x"], torch.tensor([9.0]))
    assert float(snap["fc_x"]["amax_history"][0]) == 3.5
    # and JAX's DelayedScaling reads it the same way
    jds = jf.DelayedScaling(window=8)
    jds.load_state_dict(snap)
    np.testing.assert_array_equal(np.asarray(jds["fc_w"]["scale"]),
                                  snap["fc_w"]["scale"])


# -- the fp8 GPT -------------------------------------------------------------------

def _batch():
    rng = np.random.default_rng(5)
    return (rng.integers(0, 512, (2, 32)).astype(np.int32),
            rng.integers(0, 512, (2, 32)).astype(np.int32))


@functools.lru_cache(maxsize=None)
def _params():
    return jax.tree.map(np.asarray, jg.gpt_init(CFG_J, seed=1))


def _port(requires_grad=False):
    pt = tg.params_from_jax(_params(), device="cpu")
    if requires_grad:
        for _, t in tts._paths(pt):
            t.requires_grad_(True)
    return pt


def _port_loss_and_grads(cfg):
    toks, labs = _batch()
    pt = _port(requires_grad=True)
    loss = tg.gpt_loss(cfg, pt, (torch.from_numpy(toks),
                                 torch.from_numpy(labs)))
    loss.backward()
    return float(loss.detach()), {path: t.grad for path, t in tts._paths(pt)}


def test_fp8_loss_and_grads_match_jax_and_the_flag():
    toks, labs = _batch()
    loss_j, grads_j = jax.jit(jax.value_and_grad(lambda p: jg.gpt_loss(
        CFG_J, p, (jnp.asarray(toks), jnp.asarray(labs)))))(
            jax.tree.map(jnp.asarray, _params()))
    before = stat_get("fp8_matmul_calls")
    loss_t, grads_t = _port_loss_and_grads(CFG_T)
    # two fp8 matmuls per layer
    assert stat_get("fp8_matmul_calls") == before + 2 * CFG_T.n_layers
    assert abs(loss_t - float(loss_j)) <= 1e-5
    for path, g in jax.tree_util.tree_leaves_with_path(grads_j):
        key = tuple(k.key for k in path)
        assert _rel(g, grads_t[key]) <= GRAD_TOL, key

    # FLAGS_fp8_matmul=1 with fp8 left unset is the same computation, and
    # fp8 takes precedence over fused_mlp
    old = flags.fp8_matmul[0]
    try:
        flags.fp8_matmul[0] = True
        via_flag = _port_loss_and_grads(dataclasses.replace(CFG_T, fp8=None))
    finally:
        flags.fp8_matmul[0] = old
    fused = _port_loss_and_grads(dataclasses.replace(CFG_T, fused_mlp=True))
    for other in (via_flag, fused):
        assert other[0] == loss_t
        for key, g in grads_t.items():
            assert torch.equal(other[1][key], g), key


def test_fp8_off_is_bit_identical_and_on_is_close():
    toks, labs = _batch()
    batch = (torch.from_numpy(toks), torch.from_numpy(labs))
    pt = _port()
    base = tg.gpt_loss(tg.gpt_tiny(dtype=torch.float32), pt, batch)
    off = tg.gpt_loss(dataclasses.replace(CFG_T, fp8=False), pt, batch)
    assert flags.fp8_matmul[0] is False
    unset = tg.gpt_loss(dataclasses.replace(CFG_T, fp8=None), pt, batch)
    before = stat_get("fp8_matmul_calls")
    on = tg.gpt_loss(CFG_T, pt, batch)
    assert stat_get("fp8_matmul_calls") > before
    assert float(off) == float(base) == float(unset)
    assert float(on) != float(base)                   # fp8 really engaged
    assert abs(float(on) - float(base)) / abs(float(base)) < 0.05


def test_fp8_prefill_logits_match_jax():
    toks = np.random.default_rng(6).integers(0, 512, (2, 24)).astype(
        np.int32)
    want, (k_j, _) = jax.jit(functools.partial(jg.gpt_prefill, CFG_J))(
        jax.tree.map(jnp.asarray, _params()), jnp.asarray(toks))
    with torch.inference_mode():
        got, (k_t, _) = tg.gpt_prefill(CFG_T, _port(), torch.from_numpy(toks))
    np.testing.assert_allclose(_np(got), _np(want), atol=F32_LOGITS_TOL,
                               rtol=F32_LOGITS_TOL)
    np.testing.assert_allclose(_np(k_t), _np(k_j), atol=1e-4, rtol=1e-4)


def test_engine_pins_fp8_flag():
    old = flags.fp8_matmul[0]
    try:
        flags.fp8_matmul[0] = True
        eng = InferenceEngine(tg.gpt_tiny(dtype=torch.float32), _port(),
                              n_slots=2, max_len=64, device="cpu")
    finally:
        flags.fp8_matmul[0] = old
    try:
        before = stat_get("fp8_matmul_calls")
        assert eng.cfg.fp8 is True
        out = eng.generate(np.arange(5, dtype=np.int32), max_new_tokens=3)
        assert len(out) == 3
        assert stat_get("fp8_matmul_calls") > before   # the prefill's MLP
    finally:
        eng.shutdown()


def test_delayed_scaling_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        tf.init_delayed_state()
    with pytest.raises(RuntimeError, match="CUDA"):
        tf.DelayedScaling()
