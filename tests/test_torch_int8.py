"""paddle_tpu_torch int8 weight-only decode against paddle_tpu.

The port's int8 matmul (its plain version on the CPU: an int32 product
and the f32 dequant epilogue) against the JAX Pallas kernel in interpret
mode at 128-divisible shapes, and against JAX's reference at ragged
shapes and per-row scales; the dynamic activation quantization,
``quantize_gpt_weights``, the int8 ``gpt_decode_step`` /
``gpt_decode_step_paged`` and ``InferenceEngine(int8_weights=True)``
against the JAX package's, on the same numpy inputs.

Tolerances: the matmul and the quantizers are bit-identical (an int32
sum is exact in any order; the epilogue is the same f32 operations in
the same order; both round half to even). With a bias, XLA contracts the
Pallas epilogue's ``acc * s + b`` into one FMA (one rounding fewer than
the port's two operations), so there the bound is 2 ulps of the larger
of the two terms in the output dtype. Decode logits: f32 5e-4
absolute, bf16 3e-2 of the largest logit, as the fp decode tests
(tests/test_torch_gpt.py) hold them; the activation quantization sees
the same hidden state up to f32 summation order. Greedy engine streams:
token-identical.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import gpt as jg
from paddle_tpu.ops import int8_matmul as ji
from paddle_tpu.serving import InferenceEngine as JaxEngine
from paddle_tpu.serving import KVCache as JKVCache
from paddle_tpu.serving import PagedKVCache as JPagedKVCache
from paddle_tpu.serving import cache_insert as j_cache_insert
from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.monitor.stats import stat_get
from paddle_tpu_torch.ops import int8_matmul as ti
from paddle_tpu_torch.serving import (InferenceEngine, KVCache,
                                      PagedKVCache, cache_insert)
from torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)

F32_LOGITS_TOL = 5e-4
BF16_REL = 3e-2
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
OUT = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}


def _operands(M, K, N, seed=0, per_row=False):
    rng = np.random.default_rng(seed)
    xq = rng.integers(-127, 128, (M, K)).astype(np.int8)
    wq = rng.integers(-127, 128, (K, N)).astype(np.int8)
    ws = (rng.random(N) * 0.02 + 1e-4).astype(np.float32)
    xs = ((rng.random((M, 1)) * 0.05 + 1e-3).astype(np.float32) if per_row
          else np.float32(0.0123))
    bias = rng.standard_normal(N).astype(np.float32)
    return xq, wq, ws, xs, bias


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _port(xq, wq, ws, xs, bias, out):
    return ti.int8_matmul_arrays(
        torch.from_numpy(xq), torch.from_numpy(wq), torch.from_numpy(ws),
        torch.from_numpy(np.asarray(xs)),
        bias=None if bias is None else torch.from_numpy(bias),
        out_dtype=OUT[out][1])


ULP = {"f32": 2.0 ** -23, "bf16": 2.0 ** -7}


@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("M,K,N", [(8, 256, 384), (1, 128, 128),
                                   (40, 512, 256)])
def test_int8_matmul_matches_pallas_kernel(M, K, N, out):
    """Bit-identical to the Pallas kernel without a bias; within 2 ulps
    with one (the interpreter's FMA)."""
    xq, wq, ws, xs, bias = _operands(M, K, N, seed=M)
    prod = None
    for b in (None, bias):
        want = ji.int8_matmul_arrays(
            jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(ws), xs,
            bias=None if b is None else jnp.asarray(b),
            out_dtype=OUT[out][0], interpret=True)
        got = _port(xq, wq, ws, xs, b, out)
        assert got.dtype == OUT[out][1] and got.shape == (M, N)
        if b is None:
            np.testing.assert_array_equal(_np(got), _np(want))
            prod = np.abs(_np(got))
        else:
            bound = 2 * ULP[out] * np.maximum(prod, np.abs(b))
            assert (np.abs(_np(got) - _np(want)) <= bound).all()


@pytest.mark.parametrize("M,K,N,per_row", [(100, 64, 192, False),
                                           (3, 50, 37, False),
                                           (5, 130, 20, True)])
def test_int8_matmul_ragged_matches_jax_reference(M, K, N, per_row):
    """Shapes the TPU wrapper sends to XLA (K or N without a 128
    divisor, per-row scales) against the same XLA math."""
    xq, wq, ws, xs, bias = _operands(M, K, N, seed=K, per_row=per_row)
    want = ji._int8_matmul_ref(jnp.asarray(xq), jnp.asarray(wq),
                               jnp.asarray(ws), jnp.asarray(xs),
                               jnp.asarray(bias), jnp.float32)
    got = _port(xq, wq, ws, xs, bias, "f32")
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_dynamic_int8_matmul_matches_jax(dt):
    jdt, tdt = DTYPES[dt]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 1, 192)).astype(np.float32)
    _, wq, ws, _, _ = _operands(1, 192, 256, seed=6)
    want = ji.dynamic_int8_matmul(jnp.asarray(x, jdt), jnp.asarray(wq),
                                  jnp.asarray(ws))
    before = stat_get("int8_matmul_calls")
    got = ti.dynamic_int8_matmul(torch.from_numpy(x).to(tdt),
                                 torch.from_numpy(wq), torch.from_numpy(ws))
    assert stat_get("int8_matmul_calls") == before + 1
    assert got.dtype == tdt and got.shape == (4, 1, 256)
    np.testing.assert_array_equal(_np(got), _np(want))


def _dynamic_x(case, M, K, seed):
    """Activations for the fused-quantization entry: "random"; "zeros"
    (the scale's 1e-8 floor); "halves" (max |x| = 127, so the scale is 1
    and every other value, k + 0.5, sits on a round-half boundary)."""
    rng = np.random.default_rng(seed)
    if case == "zeros":
        return np.zeros((M, K), np.float32)
    if case == "halves":
        x = rng.integers(-126, 126, (M, K)) + 0.5
        x[0, 0] = -127.0
        return x.astype(np.float32)
    return rng.standard_normal((M, K)).astype(np.float32) * 3


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", ["random", "zeros", "halves"])
@pytest.mark.parametrize("M,K,N,bias", [(3, 50, 37, True),
                                        (13, 130, 20, False)])
def test_fused_quantization_plain_path_matches_jax(dt, case, M, K, N, bias):
    """The fused-quantization entry's plain version (what a CPU tensor
    runs, and what the kernel is held to on the card) is bit-identical to
    JAX's dynamic_int8_matmul at ragged M, K and N (sent to XLA there):
    the scale, the quantized codes (round half to even) and the
    product."""
    jdt, tdt = DTYPES[dt]
    x = _dynamic_x(case, M, K, seed=M + K)
    _, wq, ws, _, b = _operands(M, K, N, seed=N)
    b = b if bias else None
    want = ji.dynamic_int8_matmul(
        jnp.asarray(x, jdt), jnp.asarray(wq), jnp.asarray(ws),
        bias=None if b is None else jnp.asarray(b))
    xt = torch.from_numpy(x).to(tdt)
    got = ti._dynamic_int8_reference(
        xt, torch.from_numpy(wq), torch.from_numpy(ws),
        None if b is None else torch.from_numpy(b))
    assert got.dtype == tdt and got.shape == (M, N)
    np.testing.assert_array_equal(_np(got), _np(want))
    # and the entry itself takes that path on the CPU
    entry = ti.dynamic_int8_matmul(
        xt, torch.from_numpy(wq), torch.from_numpy(ws),
        None if b is None else torch.from_numpy(b))
    assert torch.equal(entry, got)
    if case == "halves":
        # the codes themselves: half to even on both sides
        x32 = xt.float()
        s = ti._quant_scale(x32.abs().max())
        assert float(s) == 1.0
        jq = jnp.clip(jnp.round(jnp.asarray(x, jdt).astype(jnp.float32)
                                / 1.0), -127, 127).astype(jnp.int8)
        np.testing.assert_array_equal(ti._quantize(x32, s).numpy(),
                                      np.asarray(jq))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("bad", ["nan_row", "nan_entries", "inf_entries"])
def test_plain_quantization_keeps_a_non_finite_row_in_its_row(dt, bad):
    """A NaN or inf in one row of activations (a poisoned decode slot)
    reaches that output row and no other: the other rows equal JAX's
    dynamic_int8_matmul of the input with its non-finite entries zeroed
    (on the input itself JAX's per-tensor scale turns every row NaN)."""
    jdt, tdt = DTYPES[dt]
    M, K, N, r = 5, 64, 24, 2
    x = _dynamic_x("random", M, K, seed=7)
    _, wq, ws, _, b = _operands(M, K, N, seed=3)
    if bad == "nan_row":
        x[r] = np.nan
    elif bad == "nan_entries":
        x[r, ::5] = np.nan
    else:
        x[r, 3], x[r, 9] = np.inf, -np.inf
    want = ji.dynamic_int8_matmul(
        jnp.asarray(np.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0), jdt),
        jnp.asarray(wq), jnp.asarray(ws), bias=jnp.asarray(b))
    got = ti._dynamic_int8_reference(
        torch.from_numpy(x).to(tdt), torch.from_numpy(wq),
        torch.from_numpy(ws), torch.from_numpy(b))
    keep = [i for i in range(M) if i != r]
    assert not torch.isfinite(got[r]).any()
    np.testing.assert_array_equal(_np(got)[keep], _np(want)[keep])


@pytest.mark.parametrize("param_dtype", ["f32", "bf16"])
def test_quantize_gpt_weights_matches_jax(param_dtype):
    pj = jg.gpt_init(jg.gpt_tiny(param_dtype=DTYPES[param_dtype][0]),
                     seed=1)
    qj = jg.quantize_gpt_weights(pj)
    pt = tg.params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")
    qt = tg.quantize_gpt_weights(pt)
    for name in ("qkv_w", "proj_w", "fc_w", "out_w"):
        q, s = qt["blocks"][name]["q"], qt["blocks"][name]["s"]
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(),
                                      np.asarray(qj["blocks"][name]["q"]))
        np.testing.assert_array_equal(s.numpy(),
                                      np.asarray(qj["blocks"][name]["s"]))
    assert qt["blocks"]["ln1_s"] is pt["blocks"]["ln1_s"]
    assert not isinstance(pt["blocks"]["fc_w"], dict)   # the input stays


@functools.lru_cache(maxsize=None)
def _pair(dt, seed=3):
    jdt, tdt = DTYPES[dt]
    cfg_j, cfg_t = jg.gpt_tiny(dtype=jdt), tg.gpt_tiny(dtype=tdt)
    pj = jg.gpt_init(cfg_j, seed=seed)
    pt = tg.params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")
    return (cfg_j, cfg_t, pj, pt, jg.quantize_gpt_weights(pj),
            tg.quantize_gpt_weights(pt))


def _close(got, want, dt):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if dt == "f32":
        np.testing.assert_allclose(got, want, atol=F32_LOGITS_TOL,
                                   rtol=F32_LOGITS_TOL)
    else:
        err = np.abs(got - want).max()
        assert err <= BF16_REL * max(1.0, np.abs(want).max()), err


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(
        np.int32)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_int8_decode_step_matches_jax(dt):
    """Prefill with the fp weights, then one decode step with the int8
    tree, as the engines run them."""
    cfg_j, cfg_t, pj, pt, qj, qt = _pair(dt)
    S = 13
    prompt = _tokens((1, S), seed=1)
    positions = np.asarray([S, 0], np.int32)
    step_toks = np.asarray([7, 0], np.int32)
    _, (ke, ve) = jg.gpt_prefill(cfg_j, pj, jnp.asarray(prompt))
    cj = JKVCache(cfg_j, n_slots=2)
    kj, vj = j_cache_insert(cj.k, cj.v, 0, ke[0], ve[0])
    want, _ = jg.gpt_decode_step(cfg_j, qj, (kj, vj),
                                 jnp.asarray(positions),
                                 jnp.asarray(step_toks))
    with torch.inference_mode():
        _, (ke_t, ve_t) = tg.gpt_prefill(cfg_t, pt, torch.from_numpy(prompt))
        ct = KVCache(cfg_t, n_slots=2, device="cpu")
        cache_insert(ct.k, ct.v, 0, ke_t[0], ve_t[0])
        before = stat_get("int8_matmul_calls")
        got, _ = tg.gpt_decode_step(cfg_t, qt, (ct.k, ct.v),
                                    torch.from_numpy(positions),
                                    torch.from_numpy(step_toks))
    # four int8 matmuls per layer
    assert stat_get("int8_matmul_calls") == before + 4 * cfg_t.n_layers
    _close(got[0], want[0], dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_int8_paged_decode_step_matches_jax(dt):
    cfg_j, cfg_t, pj, pt, qj, qt = _pair(dt)
    S, bs = 20, 8
    prompt = _tokens((1, 24), seed=2)
    prompt[0, S:] = 0
    pool_j = JPagedKVCache(cfg_j, n_slots=2, block_size=bs)
    pool_t = PagedKVCache(cfg_t, n_slots=2, block_size=bs, device="cpu")
    for pool in (pool_j, pool_t):
        assert pool.grow(0, 24)
    _, (kb_j, vb_j) = jg.gpt_prefill_chunk(
        cfg_j, pj, (pool_j.kb, pool_j.vb), jnp.asarray(pool_j.table_row(0)),
        jnp.asarray(prompt), jnp.int32(0))
    tables = pool_t.tables_array([0])
    positions = np.asarray([S, 0], np.int32)
    step_toks = np.asarray([9, 0], np.int32)
    want, _ = jg.gpt_decode_step_paged(cfg_j, qj, (kb_j, vb_j),
                                       jnp.asarray(tables),
                                       jnp.asarray(positions),
                                       jnp.asarray(step_toks))
    with torch.inference_mode():
        tg.gpt_prefill_chunk(cfg_t, pt, (pool_t.kb, pool_t.vb),
                             torch.from_numpy(pool_t.table_row(0)),
                             torch.from_numpy(prompt), 0)
        got, _ = tg.gpt_decode_step_paged(
            cfg_t, qt, (pool_t.kb, pool_t.vb), torch.from_numpy(tables),
            torch.from_numpy(positions), torch.from_numpy(step_toks))
    _close(got[0], want[0], dt)


# -- the engine ----------------------------------------------------------------

CFG_J = jg.gpt_tiny(dtype=jnp.float32, seq_len=64)
CFG = tg.gpt_tiny(dtype=torch.float32, seq_len=64)
ENGINE_KW = dict(n_slots=2, max_len=64, block_size=8, prefill_chunk=16)


@functools.lru_cache(maxsize=None)
def _engine_params():
    """One JAX init, its block matrices scaled x4 so that greedy streams
    vary from token to token (at init scale they repeat one token)."""
    tree = jax.tree.map(np.asarray, jg.gpt_init(CFG_J, seed=3))
    blocks = dict(tree["blocks"])
    for k in ("qkv_w", "proj_w", "fc_w", "out_w"):
        blocks[k] = blocks[k] * 4.0
    tree = {**tree, "blocks": blocks}
    return tree, tg.params_from_jax(tree, device="cpu")


def _prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(0, CFG.vocab_size, n).astype(np.int32)
            for n in (5, 17, 30, 41)]


def _run(engine):
    """The prompts one at a time. The activations' int8 scale is one
    abs-max over every slot of a tick (per tensor, in both packages), so
    an int8 stream depends on which requests share its ticks, and with
    concurrent submits that depends on admission timing; one request at
    a time gives both engines the same ticks."""
    try:
        return [engine.generate(p, max_new_tokens=10) for p in _prompts()]
    finally:
        engine.shutdown()


@pytest.mark.parametrize("paged", [False, True])
def test_int8_engine_greedy_matches_jax_engine(paged):
    tree, params = _engine_params()
    want = _run(JaxEngine(CFG_J, jax.tree.map(jnp.asarray, tree),
                          int8_weights=True, paged=paged, **ENGINE_KW))
    before = stat_get("int8_matmul_calls")
    eng = InferenceEngine(CFG, params, int8_weights=True, paged=paged,
                          device="cpu", **ENGINE_KW)
    assert isinstance(eng._decode_params["blocks"]["fc_w"], dict)
    assert not isinstance(eng._params["blocks"]["fc_w"], dict)
    got = _run(eng)
    assert got == want
    assert stat_get("int8_matmul_calls") > before


def test_int8_engine_refuses_moe_and_mesh():
    _, params = _engine_params()
    with pytest.raises(ValueError, match="MoE"):
        InferenceEngine(tg.gpt_tiny(moe_experts=2), params,
                        int8_weights=True, device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        InferenceEngine(CFG, params, int8_weights=True, mesh=object(),
                        device="cpu")
