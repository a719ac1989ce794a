"""paddle_tpu_torch flash attention, forward and backward, against
paddle_tpu.

The port's plain versions (what a CPU tensor runs, and what
chip_smoke.py holds the CUDA kernels against on the card) are compared
with the JAX package's Pallas kernels run in interpret mode and with its
composed reference, on the same numpy inputs.

Tolerances: f32 1e-5 (the same math, summed in another order); forward
bf16 2e-2 on o (scores and probabilities are rounded to bf16 at
different points in the two packages) and 1e-3 on lse (taken from f32
scores of the same bf16 inputs in both); backward bf16 5e-3 of the
largest gradient (the same roundings as the TPU kernel at the same
points; a different summation order can move an f32 value across a bf16
rounding boundary).
"""
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import flash_attention as tfa
from torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)

F32_TOL = 1e-5
BF16_TOL_O = 2e-2
BF16_TOL_LSE = 1e-3
BF16_TOL_GRAD = 5e-3

# the module (paddle_tpu.ops re-exports a function of the same name)
jfa = importlib.import_module("paddle_tpu.ops.flash_attention")


def _inputs(b, h, sq, sk, d, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, h, s, d)).astype(np.float32)
                 for s in (sq, sk, sk))


def _jax(arrs, dtype):
    return tuple(jnp.asarray(a, dtype) for a in arrs)


def _torch(arrs, dtype):
    return tuple(torch.from_numpy(a).to(dtype) for a in arrs)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# (b, h, sq, sk, d, causal): the kernel's block grid needs 128-divisible
# lengths in interpret mode; sq < sk exercises the causal offset
CASES = [
    (1, 2, 128, 128, 64, False),
    (1, 2, 128, 128, 64, True),
    (1, 2, 128, 256, 64, True),
    (1, 1, 128, 128, 128, True),
]


@pytest.mark.parametrize("b,h,sq,sk,d,causal", CASES)
def test_plain_matches_pallas_interpret_f32(b, h, sq, sk, d, causal):
    arrs = _inputs(b, h, sq, sk, d)
    scale = 1.0 / math.sqrt(d)
    o_j, lse_j = jfa._flash_forward(*_jax(arrs, jnp.float32), causal=causal,
                                    scale=scale, block_q=128, block_k=128,
                                    interpret=True)
    o_t, lse_t = tfa.flash_attention_forward(*_torch(arrs, torch.float32),
                                             causal=causal, scale=scale)
    assert o_t.shape == (b, h, sq, d) and o_t.dtype == torch.float32
    assert lse_t.shape == (b * h, sq, 1) and lse_t.dtype == torch.float32
    np.testing.assert_allclose(_np(o_t), _np(o_j), atol=F32_TOL,
                               rtol=F32_TOL)
    np.testing.assert_allclose(_np(lse_t), _np(lse_j), atol=F32_TOL,
                               rtol=F32_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_matches_pallas_interpret_bf16(causal):
    arrs = _inputs(1, 2, 128, 256, 64, seed=1)
    o_j, lse_j = jfa._flash_forward(*_jax(arrs, jnp.bfloat16), causal=causal,
                                    scale=0.125, block_q=128, block_k=128,
                                    interpret=True)
    o_t, lse_t = tfa.flash_attention_forward(*_torch(arrs, torch.bfloat16),
                                             causal=causal, scale=0.125)
    assert o_t.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(o_t), _np(o_j), atol=BF16_TOL_O,
                               rtol=BF16_TOL_O)
    np.testing.assert_allclose(_np(lse_t), _np(lse_j), atol=BF16_TOL_LSE,
                               rtol=BF16_TOL_LSE)


@pytest.mark.parametrize("sq,sk,causal", [(20, 20, True), (7, 33, True),
                                          (16, 48, False)])
def test_arrays_matches_jax_reference_any_shape(sq, sk, causal):
    """The entry the model calls takes any Sq/Sk (the TPU's divisibility
    fallback does not survive in the port) and equals JAX's composed
    reference."""
    arrs = _inputs(2, 3, sq, sk, 64, seed=2)
    want = jfa._attention_reference(*_jax(arrs, jnp.float32), causal, 0.125)
    got = tfa.flash_attention_arrays(*_torch(arrs, torch.float32),
                                     causal=causal, scale=0.125)
    np.testing.assert_allclose(_np(got), _np(want), atol=F32_TOL,
                               rtol=F32_TOL)


def test_cpu_tensor_runs_plain_version_and_counts_nothing():
    arrs = _torch(_inputs(1, 2, 16, 16, 64), torch.float32)
    before = tfa.LAUNCHES
    got = tfa.flash_attention_arrays(*arrs, causal=True)
    want = tfa._attention_reference(*arrs, True, 1.0 / 8.0)
    assert torch.equal(got, want)
    assert tfa.LAUNCHES == before


def test_lse_is_logsumexp_of_masked_scores():
    q, k, v = _torch(_inputs(1, 1, 8, 8, 64, seed=3), torch.float32)
    _, lse = tfa.flash_attention_forward(q, k, v, causal=True, scale=0.125)
    s = (q[0, 0] @ k[0, 0].T) * 0.125
    for r in range(8):
        want = torch.logsumexp(s[r, :r + 1], 0)
        assert abs(float(lse[0, r, 0]) - float(want)) < 1e-5


def _grads_jax(arrs, do, causal, scale, dtype, block=128):
    q, k, v = _jax(arrs, dtype)
    o, lse = jfa._flash_forward(q, k, v, causal=causal, scale=scale,
                                block_q=block, block_k=block, interpret=True)
    grads = jfa._flash_backward(q, k, v, o, lse, jnp.asarray(do, dtype),
                                causal=causal, scale=scale, block_q=block,
                                block_k=block, interpret=True)
    return o, lse, grads


def _rel(want, got):
    want, got = _np(want), _np(got)
    assert want.shape == got.shape
    return float(np.abs(want - got).max() / np.abs(want).max())


# (b, h, sq, sk, d, causal): S >= 128 and 128-divisible for the kernel's
# block grid in interpret mode; sq < sk exercises the causal offset
BWD_CASES = [
    (1, 2, 128, 128, 64, True),
    (1, 2, 128, 256, 64, True),
    (1, 2, 256, 256, 64, False),
    (1, 1, 128, 128, 128, True),
]


@pytest.mark.parametrize("b,h,sq,sk,d,causal,dt",
                         [c + ("f32",) for c in BWD_CASES]
                         + [BWD_CASES[1] + ("bf16",),
                            BWD_CASES[2] + ("bf16",)])
def test_plain_backward_matches_pallas_interpret(b, h, sq, sk, d, causal,
                                                 dt):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    arrs = _inputs(b, h, sq, sk, d, seed=5)
    do = np.random.default_rng(6).standard_normal((b, h, sq, d)).astype(
        np.float32)
    scale = 1.0 / math.sqrt(d)
    o, lse, want = _grads_jax(arrs, do, causal, scale, jdt)
    q, k, v = _torch(arrs, tdt)
    got = tfa._flash_backward_reference(
        q, k, v, torch.from_numpy(np.array(_np(o))).to(tdt),
        torch.from_numpy(np.array(lse)), torch.from_numpy(do).to(tdt),
        causal, scale)
    for name, w, g in zip(("dq", "dk", "dv"), want, got):
        assert g.dtype == tdt and tuple(g.shape) == w.shape, name
        if dt == "f32":
            np.testing.assert_allclose(_np(g), _np(w), atol=F32_TOL,
                                       rtol=F32_TOL, err_msg=name)
        else:
            assert _rel(w, g) <= BF16_TOL_GRAD, name


# lengths that are not multiples of 128 (the Pallas grid takes them with
# 64-row blocks, or one block of the whole length)
@pytest.mark.parametrize("b,h,sq,sk,d,causal,dt,block", [
    (1, 2, 96, 96, 64, True, "f32", 128),
    (1, 2, 192, 320, 64, True, "f32", 64),
    (1, 1, 192, 192, 128, False, "bf16", 64)])
def test_plain_backward_matches_pallas_interpret_unaligned_lengths(
        b, h, sq, sk, d, causal, dt, block):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    arrs = _inputs(b, h, sq, sk, d, seed=15)
    do = np.random.default_rng(16).standard_normal((b, h, sq, d)).astype(
        np.float32)
    scale = 1.0 / math.sqrt(d)
    o, lse, want = _grads_jax(arrs, do, causal, scale, jdt, block)
    q, k, v = _torch(arrs, tdt)
    got = tfa._flash_backward_reference(
        q, k, v, torch.from_numpy(np.array(_np(o))).to(tdt),
        torch.from_numpy(np.array(lse)), torch.from_numpy(do).to(tdt),
        causal, scale)
    for name, w, g in zip(("dq", "dk", "dv"), want, got):
        assert g.dtype == tdt and tuple(g.shape) == w.shape, name
        if dt == "f32":
            np.testing.assert_allclose(_np(g), _np(w), atol=F32_TOL,
                                       rtol=F32_TOL, err_msg=name)
        else:
            assert _rel(w, g) <= BF16_TOL_GRAD, name


@pytest.mark.parametrize("dtype,d,kernel", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 16, "fma"), (torch.bfloat16, 96, "fma"),
    (torch.float32, 64, "fma"), (torch.float32, 128, "fma")])
def test_kernel_for_routes_by_dtype_and_head_dim(dtype, d, kernel):
    """bf16 at head dim 64 or 128 goes to the Hopper kernels, f32 and
    every other head dim to the FMA ones: the rule both C entry points
    apply, decided without a card."""
    assert tfa.kernel_for(dtype, d) == kernel


def test_kernel_for_refuses_what_no_kernel_takes():
    with pytest.raises(TypeError, match="f32 or bf16"):
        tfa.kernel_for(torch.float16, 64)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.kernel_for(torch.bfloat16, 256)
    q = torch.zeros(1, 1, 4, 256)
    with pytest.raises(ValueError, match="head_dim"):
        tfa._check(q, q, q)
    with pytest.raises(TypeError, match="f32 or bf16"):
        tfa._check(q.half(), q.half(), q.half())


@pytest.mark.parametrize("sq,sk,causal", [(128, 128, True),
                                          (128, 256, True),
                                          (128, 128, False)])
def test_plain_backward_matches_grad_of_composed_reference(sq, sk, causal):
    """In f32 the kernel's backward (p from lse, the delta trick) is the
    exact gradient of the composed attention: held against jax.grad."""
    arrs = _inputs(1, 2, sq, sk, 64, seed=7)
    do = np.random.default_rng(8).standard_normal((1, 2, sq, 64)).astype(
        np.float32)

    def loss(q, k, v):
        return jnp.sum(jfa._attention_reference(q, k, v, causal, 0.125)
                       * jnp.asarray(do))

    want = jax.grad(loss, argnums=(0, 1, 2))(*_jax(arrs, jnp.float32))
    q, k, v = _torch(arrs, torch.float32)
    o, lse = tfa.flash_attention_forward(q, k, v, causal=causal,
                                         scale=0.125)
    got = tfa._flash_backward_reference(q, k, v, o, lse,
                                        torch.from_numpy(do), causal, 0.125)
    for w, g in zip(want, got):
        np.testing.assert_allclose(_np(g), _np(w), atol=F32_TOL,
                                   rtol=F32_TOL)


@pytest.mark.parametrize("sq,sk", [(20, 20), (7, 33)])
def test_arrays_is_differentiable_on_cpu(sq, sk):
    """The model's entry carries gradients on a CPU tensor (autograd
    through the plain forward) equal to jax.grad of the composed path."""
    arrs = _inputs(2, 3, sq, sk, 64, seed=9)
    do = np.random.default_rng(10).standard_normal((2, 3, sq, 64)).astype(
        np.float32)

    def loss(q, k, v):
        return jnp.sum(jfa._attention_reference(q, k, v, True, 0.125)
                       * jnp.asarray(do))

    want = jax.grad(loss, argnums=(0, 1, 2))(*_jax(arrs, jnp.float32))
    ts = [t.requires_grad_(True) for t in _torch(arrs, torch.float32)]
    out = tfa.flash_attention_arrays(*ts, causal=True, scale=0.125)
    out.backward(torch.from_numpy(do))
    for w, t in zip(want, ts):
        np.testing.assert_allclose(_np(t.grad), _np(w), atol=F32_TOL,
                                   rtol=F32_TOL)
