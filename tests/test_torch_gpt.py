"""paddle_tpu_torch GPT serving functions against paddle_tpu.

One JAX ``gpt_init`` tree goes through ``params_from_jax`` into the
port; the same tokens go through both packages' ``gpt_forward``,
``gpt_prefill`` (logits and K/V), ``gpt_decode_step``,
``gpt_prefill_chunk`` and ``gpt_decode_step_paged``. Configs: gpt_tiny
(head_dim 16) and a two-layer head_dim-64 config.

Tolerances: f32 K/V 1e-4 absolute; f32 logits 5e-4 absolute (both
heads round the hidden state to bf16 before the tied logits matmul, as
the JAX head does, so a 1e-6 difference in the hidden state can flip one
bf16 rounding and move a logit by ~1e-4); bf16 a relative bound,
max|Δ| <= 3e-2 · max|reference| (bf16 rounds at other places in the two
frameworks; 3e-2 is ~8 bf16 ulps of the largest value).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import gpt as jg
from paddle_tpu.serving import KVCache as JKVCache
from paddle_tpu.serving import PagedKVCache as JPagedKVCache
from paddle_tpu.serving import cache_insert as j_cache_insert
from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.serving import KVCache, PagedKVCache, cache_insert
from torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)

F32_TOL = 1e-4
F32_LOGITS_TOL = 5e-4
BF16_REL = 3e-2

CONFIGS = {
    "tiny": dict(vocab_size=512, hidden=64, n_layers=4, n_heads=4,
                 seq_len=64),
    "hd64": dict(vocab_size=512, hidden=128, n_layers=2, n_heads=2,
                 seq_len=64),
}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@functools.lru_cache(maxsize=None)
def _pair(name, dt, seed=3):
    jdt, tdt = DTYPES[dt]
    cfg_j = jg.GPTConfig(dtype=jdt, **CONFIGS[name])
    cfg_t = tg.GPTConfig(dtype=tdt, **CONFIGS[name])
    pj = jg.gpt_init(cfg_j, seed=seed)
    pt = tg.params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")
    return cfg_j, cfg_t, pj, pt


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, dt, tol=F32_TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if dt == "f32":
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    else:
        err = np.abs(got - want).max()
        assert err <= BF16_REL * max(1.0, np.abs(want).max()), err


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(
        np.int32)


CASES = [("tiny", "f32"), ("hd64", "f32"), ("tiny", "bf16")]


def test_params_from_jax_keeps_keys_shapes_and_bits():
    cfg = jg.gpt_tiny(param_dtype=jnp.bfloat16)
    pj = jax.tree.map(np.asarray, jg.gpt_init(cfg, seed=1))
    pt = tg.params_from_jax(pj, device="cpu")
    flat_j = jax.tree_util.tree_leaves_with_path(pj)
    assert len(flat_j) == 4 + 12
    for path, leaf in flat_j:
        t = pt
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.float().numpy(),
                                      leaf.astype(np.float32))


def test_gpt_init_shapes_and_distribution():
    cfg = tg.gpt_tiny(n_layers=2)
    pt = tg.gpt_init(cfg, seed=0, device="cpu")
    pj = jg.gpt_init(jg.gpt_tiny(n_layers=2), seed=0)
    assert pt.keys() == pj.keys()
    assert pt["blocks"].keys() == pj["blocks"].keys()
    for k in pj["blocks"]:
        assert tuple(pt["blocks"][k].shape) == pj["blocks"][k].shape
    assert tuple(pt["wte"].shape) == pj["wte"].shape
    assert abs(float(pt["wte"].std()) - 0.02) < 2e-3
    assert abs(float(pt["blocks"]["out_w"].std()) - 0.02 / 2.0) < 1e-3
    assert torch.equal(pt["blocks"]["ln1_s"], torch.ones(2, cfg.hidden))
    again = tg.gpt_init(cfg, seed=0, device="cpu")
    assert torch.equal(again["wte"], pt["wte"])


@pytest.mark.parametrize("name,dt", CASES)
def test_forward_and_prefill_match_jax(name, dt):
    cfg_j, cfg_t, pj, pt = _pair(name, dt)
    toks = _tokens((2, 24))
    with torch.inference_mode():
        fwd = tg.gpt_forward(cfg_t, pt, torch.from_numpy(toks))
        lg, (k, v) = tg.gpt_prefill(cfg_t, pt, torch.from_numpy(toks))
    assert fwd.dtype == torch.float32 and lg.dtype == torch.float32
    _close(fwd, jg.gpt_forward(cfg_j, pj, jnp.asarray(toks)), dt,
           F32_LOGITS_TOL)
    lg_j, (k_j, v_j) = jg.gpt_prefill(cfg_j, pj, jnp.asarray(toks))
    _close(lg, lg_j, dt, F32_LOGITS_TOL)
    assert k.dtype == cfg_t.dtype
    _close(k, k_j, dt)
    _close(v, v_j, dt)


@pytest.mark.parametrize("name,dt", CASES)
def test_decode_step_matches_jax(name, dt):
    cfg_j, cfg_t, pj, pt = _pair(name, dt)
    S = 11
    prompt = _tokens((1, S), seed=1)
    positions = np.asarray([S, 0], np.int32)
    step_toks = np.asarray([7, 0], np.int32)

    lg_j, (ke, ve) = jg.gpt_prefill(cfg_j, pj, jnp.asarray(prompt))
    cj = JKVCache(cfg_j, n_slots=2)
    kj, vj = j_cache_insert(cj.k, cj.v, 0, ke[0], ve[0])
    want, (kj, vj) = jg.gpt_decode_step(cfg_j, pj, (kj, vj),
                                        jnp.asarray(positions),
                                        jnp.asarray(step_toks))

    with torch.inference_mode():
        _, (ke_t, ve_t) = tg.gpt_prefill(cfg_t, pt, torch.from_numpy(prompt))
        ct = KVCache(cfg_t, n_slots=2, device="cpu")
        cache_insert(ct.k, ct.v, 0, ke_t[0], ve_t[0])
        got, (kt, vt) = tg.gpt_decode_step(cfg_t, pt, (ct.k, ct.v),
                                           torch.from_numpy(positions),
                                           torch.from_numpy(step_toks))
    assert kt is ct.k          # written in place
    _close(got[0], want[0], dt, F32_LOGITS_TOL)
    _close(kt[0, :, :, :S + 1], kj[0, :, :, :S + 1], dt)
    _close(vt[0, :, :, :S + 1], vj[0, :, :, :S + 1], dt)


@pytest.mark.parametrize("name,dt", CASES)
def test_prefill_chunk_and_paged_decode_match_jax(name, dt):
    """Two chunks (16 tokens, then 4 padded to 8) into a block pool of
    block_size 8, then one paged decode step with a stale second lane."""
    cfg_j, cfg_t, pj, pt = _pair(name, dt)
    prompt = _tokens(20, seed=2)
    bs = 8
    pool_j = JPagedKVCache(cfg_j, n_slots=2, block_size=bs)
    pool_t = PagedKVCache(cfg_t, n_slots=2, block_size=bs, device="cpu")
    for pool in (pool_j, pool_t):
        assert pool.grow(0, 24)
    kb_j, vb_j = pool_j.kb, pool_j.vb
    for start, c_true, c_pad in ((0, 16, 16), (16, 4, 8)):
        toks = np.zeros((1, c_pad), np.int32)
        toks[0, :c_true] = prompt[start:start + c_true]
        row_j = jnp.asarray(pool_j.table_row(0))
        lg_j, (kb_j, vb_j) = jg.gpt_prefill_chunk(
            cfg_j, pj, (kb_j, vb_j), row_j, jnp.asarray(toks),
            jnp.int32(start))
        with torch.inference_mode():
            lg_t, _ = tg.gpt_prefill_chunk(
                cfg_t, pt, (pool_t.kb, pool_t.vb),
                torch.from_numpy(pool_t.table_row(0)),
                torch.from_numpy(toks), start)
        _close(lg_t[0, :c_true], lg_j[0, :c_true], dt, F32_LOGITS_TOL)
    live = pool_t.block_tables[0]
    _close(pool_t.kb[live], np.asarray(kb_j, np.float32)[live], dt)

    tables = pool_t.tables_array([0])
    positions = np.asarray([20, 0], np.int32)
    step_toks = np.asarray([9, 0], np.int32)
    want, _ = jg.gpt_decode_step_paged(cfg_j, pj, (kb_j, vb_j),
                                       jnp.asarray(tables),
                                       jnp.asarray(positions),
                                       jnp.asarray(step_toks))
    with torch.inference_mode():
        got, _ = tg.gpt_decode_step_paged(
            cfg_t, pt, (pool_t.kb, pool_t.vb), torch.from_numpy(tables),
            torch.from_numpy(positions), torch.from_numpy(step_toks))
    _close(got[0], want[0], dt, F32_LOGITS_TOL)


def test_paged_decode_equals_fixed_decode():
    """The port's two cache layouts agree on the same live positions."""
    _, cfg, _, pt = _pair("hd64", "f32")
    S = 19
    prompt = torch.from_numpy(_tokens((1, S), seed=4))
    with torch.inference_mode():
        _, (ke, ve) = tg.gpt_prefill(cfg, pt, prompt)
        fixed = KVCache(cfg, n_slots=1, device="cpu")
        cache_insert(fixed.k, fixed.v, 0, ke[0], ve[0])
        paged = PagedKVCache(cfg, n_slots=1, block_size=16, device="cpu")
        assert paged.grow(0, S + 1)
        for j, blk in enumerate(paged.block_tables[0]):
            n = min(16, S - 16 * j)
            paged.kb[blk, :, :, :n] = ke[0, :, :, 16 * j:16 * j + n]
            paged.vb[blk, :, :, :n] = ve[0, :, :, 16 * j:16 * j + n]
        pos = torch.tensor([S], dtype=torch.int32)
        tok = torch.tensor([5], dtype=torch.int32)
        want, _ = tg.gpt_decode_step(cfg, pt, (fixed.k, fixed.v), pos, tok)
        got, _ = tg.gpt_decode_step_paged(
            cfg, pt, (paged.kb, paged.vb),
            torch.from_numpy(paged.tables_array([0])), pos, tok)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=F32_TOL,
                               rtol=F32_TOL)


@pytest.mark.parametrize("field,value", [("moe_experts", 2),
                                         ("fp8", True),
                                         ("ring_attention", True),
                                         ("n_stages", 2)])
def test_unported_branches_raise(field, value):
    """MoE and fp8 are ported; what stays unported of them raises: MoE's
    expert-parallel axis, and fp8 on int8-quantized weights (which feed
    the decode steps only)."""
    _, cfg, _, pt = _pair("tiny", "f32")
    extra = {"moe_experts": {"moe_axis": "model"}}.get(field, {})
    cfg = tg.GPTConfig(**{**CONFIGS["tiny"], field: value, **extra})
    if field == "fp8":
        pt = tg.quantize_gpt_weights(pt)
    with pytest.raises(NotImplementedError):
        tg.gpt_forward(cfg, pt, torch.zeros((1, 4), dtype=torch.int64))


def test_int8_weights_decode_and_raise_in_forward():
    """int8 dict weights (quantize_gpt_weights) feed the decode step; the
    forward and prefill, which JAX never feeds them, still raise."""
    _, cfg, _, pt = _pair("tiny", "f32")
    qt = tg.quantize_gpt_weights(pt)
    ct = KVCache(cfg, n_slots=2, device="cpu")
    with torch.inference_mode():
        logits, _ = tg.gpt_decode_step(
            cfg, qt, (ct.k, ct.v), torch.tensor([0, 3], dtype=torch.int32),
            torch.tensor([5, 6], dtype=torch.int32))
    assert logits.shape == (2, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    toks = torch.zeros((1, 4), dtype=torch.int64)
    for fused in (False, True):
        cfg_f = tg.GPTConfig(**{**CONFIGS["tiny"], "fused_mlp": fused})
        with pytest.raises(NotImplementedError, match="int8"):
            tg.gpt_forward(cfg_f, qt, toks)
        with pytest.raises(NotImplementedError, match="int8"):
            tg.gpt_prefill(cfg_f, qt, toks)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        tg.gpt_init(tg.gpt_tiny())


@pytest.mark.parametrize("name", ["tiny", "hd64"])
def test_fused_mlp_forward_and_prefill_match_jax(name):
    """fused_mlp=True routes the MLP half through the fused LN-MLP (its
    plain version on the CPU; JAX's fused entry runs the composed math
    off-TPU): f32 logits and K/V agree as the composed path's do."""
    cfg_j = jg.GPTConfig(dtype=jnp.float32, fused_mlp=True, **CONFIGS[name])
    cfg_t = tg.GPTConfig(dtype=torch.float32, fused_mlp=True,
                         **CONFIGS[name])
    _, _, pj, pt = _pair(name, "f32")
    toks = _tokens((2, 24), seed=5)
    with torch.inference_mode():
        lg, (k, v) = tg.gpt_prefill(cfg_t, pt, torch.from_numpy(toks))
    lg_j, (k_j, v_j) = jg.gpt_prefill(cfg_j, pj, jnp.asarray(toks))
    _close(lg, lg_j, "f32", F32_LOGITS_TOL)
    _close(k, k_j, "f32")
    _close(v, v_j, "f32")


def _decode_paths(cfg_t, pt):
    """Logits of the three paths that run the composed MLP whatever
    fused_mlp says: fixed decode, chunked prefill and paged decode."""
    prompt = _tokens((1, 16), seed=8)
    with torch.inference_mode():
        _, (ke, ve) = tg.gpt_prefill(
            tg.GPTConfig(**{**CONFIGS["tiny"], "dtype": cfg_t.dtype}), pt,
            torch.from_numpy(prompt))
        fixed = KVCache(cfg_t, n_slots=2, device="cpu")
        cache_insert(fixed.k, fixed.v, 0, ke[0], ve[0])
        pos = torch.tensor([16, 0], dtype=torch.int32)
        tok = torch.tensor([3, 0], dtype=torch.int32)
        dec, _ = tg.gpt_decode_step(cfg_t, pt, (fixed.k, fixed.v), pos, tok)
        pool = PagedKVCache(cfg_t, n_slots=2, block_size=8, device="cpu")
        assert pool.grow(0, 24)
        chunk, _ = tg.gpt_prefill_chunk(
            cfg_t, pt, (pool.kb, pool.vb),
            torch.from_numpy(pool.table_row(0)), torch.from_numpy(prompt), 0)
        paged, _ = tg.gpt_decode_step_paged(
            cfg_t, pt, (pool.kb, pool.vb),
            torch.from_numpy(pool.tables_array([0])), pos, tok)
    return {"decode": dec, "chunk": chunk, "paged": paged}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_decode_and_chunk_ignore_fused_mlp_as_jax_does(dt):
    """The one-token decode and the chunked prefill run the composed MLP
    whatever fused_mlp says, as in JAX: the port's logits with
    fused_mlp=True are bit-identical to those with False, and match JAX's
    with fused_mlp=True to the decode tests' tolerance."""
    cfg_j, _, pj, pt = _pair("tiny", dt)
    tdt = DTYPES[dt][1]
    got = {f: _decode_paths(tg.GPTConfig(dtype=tdt, fused_mlp=f,
                                         **CONFIGS["tiny"]), pt)
           for f in (False, True)}
    for path in got[True]:
        assert torch.equal(got[True][path], got[False][path]), path

    cfg_jf = jg.GPTConfig(dtype=DTYPES[dt][0], fused_mlp=True,
                          **CONFIGS["tiny"])
    prompt = _tokens((1, 16), seed=8)
    _, (ke, ve) = jg.gpt_prefill(cfg_j, pj, jnp.asarray(prompt))
    cj = JKVCache(cfg_jf, n_slots=2)
    kj, vj = j_cache_insert(cj.k, cj.v, 0, ke[0], ve[0])
    pos = jnp.asarray([16, 0], jnp.int32)
    tok = jnp.asarray([3, 0], jnp.int32)
    dec, _ = jg.gpt_decode_step(cfg_jf, pj, (kj, vj), pos, tok)
    pool = JPagedKVCache(cfg_jf, n_slots=2, block_size=8)
    assert pool.grow(0, 24)
    chunk, (kb, vb) = jg.gpt_prefill_chunk(
        cfg_jf, pj, (pool.kb, pool.vb), jnp.asarray(pool.table_row(0)),
        jnp.asarray(prompt), jnp.int32(0))
    paged, _ = jg.gpt_decode_step_paged(
        cfg_jf, pj, (kb, vb), jnp.asarray(pool.tables_array([0])), pos, tok)
    _close(got[True]["decode"][0], dec[0], dt, F32_LOGITS_TOL)
    _close(got[True]["chunk"], chunk, dt, F32_LOGITS_TOL)
    _close(got[True]["paged"][0], paged[0], dt, F32_LOGITS_TOL)
