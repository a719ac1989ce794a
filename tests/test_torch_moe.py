"""paddle_tpu_torch mixture of experts against paddle_tpu.

The routing functions (``moe_capacity``, ``moe_route``'s seven outputs
with drops, droplessly, at k = 1 and k = E), the dispatch gather's plain
version against the Pallas kernel in interpret mode and its backward
against JAX's vjp, ``moe_combine_scatter`` and ``moe_ffn``; then the MoE
GPT at gpt_tiny width (4 experts, top-2, every 2nd layer): ``gpt_loss``
and every leaf's gradient (router included) with remat on and off,
``gpt_prefill``, both decode steps with their router stats,
``gpt_prefill_chunk``, greedy engine streams against the JAX MoE engine
in both cache modes, the engine's router gauges and a 10-step AdamW
trajectory. Inputs are made with numpy and fed to both packages.

Tolerances: routing decisions (slots, src, counts, dropped) are equal;
gates, aux and z 1e-6 (the same f32 softmax); the gather is bit-exact
(a copy) and so is its backward (the scatter-add of two nonzero values
per row, as top-2 routing gives, rounds once in any order); combine and
the expert FFN 1e-5 (f32 sums in another order); loss, gradients and logits as ``tests/test_torch_train.py`` and
``tests/test_torch_gpt.py`` hold the dense model (f32 loss 1e-5, f32
gradients 2e-3 of a leaf's largest value, f32 logits 5e-4, K/V 1e-4);
the AdamW trajectory 1e-4 per loss; greedy streams token-identical.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import gpt as jg
from paddle_tpu.nn import moe as jm
from paddle_tpu.ops import moe_dispatch as jmd
from paddle_tpu.parallel import train_step as jts
from paddle_tpu.serving import InferenceEngine as JaxEngine
from paddle_tpu.serving import KVCache as JKVCache
from paddle_tpu.serving import PagedKVCache as JPagedKVCache
from paddle_tpu.serving import cache_insert as j_cache_insert
from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.monitor.stats import stat_get
from paddle_tpu_torch.nn import moe as tm
from paddle_tpu_torch.ops import moe_dispatch as tmd
from paddle_tpu_torch.parallel import DistributedTrainStep
from paddle_tpu_torch.parallel import train_step as tts
from paddle_tpu_torch.serving import (InferenceEngine, KVCache,
                                      PagedKVCache, cache_insert)
from torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)

MOE = dict(moe_experts=4, moe_top_k=2, moe_every=2)
CFG_J = jg.gpt_tiny(dtype=jnp.float32, **MOE)
CFG_T = tg.gpt_tiny(dtype=torch.float32, **MOE)
F32_LOGITS_TOL = 5e-4
KV_TOL = 1e-4
GRAD_TOL = 2e-3
ENGINE_KW = dict(n_slots=2, max_len=64, block_size=8, prefill_chunk=16)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _rel(want, got):
    want, got = _np(want), _np(got)
    assert want.shape == got.shape
    return float(np.abs(want - got).max() / max(np.abs(want).max(), 1e-12))


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(
        np.int32)


@functools.lru_cache(maxsize=None)
def _params(scaled=False):
    """One JAX MoE init as numpy; ``scaled`` multiplies the block and
    expert matrices by 4 so that greedy streams vary from token to token
    (at init scale they repeat one token)."""
    tree = jax.tree.map(np.asarray, jg.gpt_init(CFG_J, seed=3))
    if scaled:
        blocks = dict(tree["blocks"])
        for k in ("qkv_w", "proj_w", "fc_w", "out_w"):
            blocks[k] = blocks[k] * 4.0
        moe = dict(tree["moe"])
        for k in ("router_w", "w_in", "w_out"):
            moe[k] = moe[k] * 4.0
        tree = {**tree, "blocks": blocks, "moe": moe}
    return tree


def _port(tree, requires_grad=False):
    pt = tg.params_from_jax(tree, device="cpu")
    if requires_grad:
        for _, t in tts._paths(pt):
            t.requires_grad_(True)
    return pt


# -- routing ------------------------------------------------------------------

@pytest.mark.parametrize("T,E,k,cf", [(24, 4, 2, 0.5), (24, 4, 2, None),
                                      (7, 8, 1, 1.25), (1000, 8, 2, 1.25),
                                      (3, 16, 4, 2.0)])
def test_moe_capacity_matches_jax(T, E, k, cf):
    assert tm.moe_capacity(T, E, k, cf) == jm.moe_capacity(T, E, k, cf)


ROUTE_CASES = {"drops": (2, 0.5), "dropless": (2, None), "k1": (1, 1.0),
               "kE": (4, 1.25)}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_moe_route_matches_jax(case):
    k, cf = ROUTE_CASES[case]
    rng = np.random.default_rng(11)
    x = rng.standard_normal((24, 16)).astype(np.float32)
    w = (rng.standard_normal((16, 4)) * 0.5).astype(np.float32)
    want = jax.jit(functools.partial(jm.moe_route, top_k=k,
                                     capacity_factor=cf))(
        jnp.asarray(w), jnp.asarray(x))
    got = tm.moe_route(torch.from_numpy(w), torch.from_numpy(x), top_k=k,
                       capacity_factor=cf)
    gates, slots, src, aux, z, counts, dropped = got
    assert slots.dtype == src.dtype == counts.dtype == torch.int32
    np.testing.assert_allclose(gates.numpy(), np.asarray(want[0]),
                               atol=1e-6, rtol=0)
    for g, w_ in ((slots, want[1]), (src, want[2]), (counts, want[5])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    assert int(dropped) == int(want[6])
    assert abs(float(aux) - float(want[3])) <= 1e-6 * abs(float(want[3]))
    assert abs(float(z) - float(want[4])) <= 1e-6 * abs(float(want[4]))
    if case == "drops":
        assert int(dropped) > 0
    if cf is None:
        assert int(dropped) == 0


def test_moe_route_rejects_bad_top_k():
    x, w = torch.zeros(4, 8), torch.zeros(8, 4)
    for k in (0, 5):
        with pytest.raises(ValueError, match="top_k"):
            tm.moe_route(w, x, top_k=k)


# -- the dispatch gather --------------------------------------------------------

def _gather_inputs(T, N, H, dtype, seed=12):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, H)).astype(np.float32)
    src = rng.integers(-1, T, N).astype(np.int32)
    src[:3] = -1
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(x).to(torch.bfloat16 if dtype == jnp.bfloat16
                                else torch.float32)
    return xj, xt, src


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("T,N,H", [(10, 24, 128), (33, 40, 256)])
def test_gather_plain_bit_exact_vs_interpret_kernel(dtype, T, N, H):
    xj, xt, src = _gather_inputs(T, N, H, dtype)
    want = jmd._gather_pallas(xj, jnp.asarray(src), hb=128, interpret=True)
    for got in (tmd._gather_reference(xt, torch.from_numpy(src)),
                tmd.moe_dispatch_gather(xt, torch.from_numpy(src))):
        assert got.dtype == xt.dtype and got.shape == (N, H)
        np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))
    assert (_np(got)[:3] == 0).all()


@pytest.mark.parametrize("case", ["n0", "all_empty", "h100_bf16",
                                  "n1001"])
def test_gather_edge_shapes_vs_jax(case):
    """The card tests' edge shapes: no slot, every slot empty, a 200-byte
    bf16 row (the kernel's 2-byte path), N no multiple of a block's rows
    (against the composed JAX gather: 1001 interpret steps are slow)."""
    T, N, H, dtype = {"n0": (5, 0, 128, jnp.float32),
                      "all_empty": (6, 20, 128, jnp.float32),
                      "h100_bf16": (10, 24, 100, jnp.bfloat16),
                      "n1001": (40, 1001, 128, jnp.float32)}[case]
    xj, xt, src = _gather_inputs(T, N, H, dtype, seed=16)
    if case == "all_empty":
        src[:] = -1
    if case in ("n0", "n1001"):
        want = jmd._gather_reference(xj, jnp.asarray(src))
    else:
        want = jmd._gather_pallas(xj, jnp.asarray(src), hb=H, interpret=True)
    got = tmd.moe_dispatch_gather(xt, torch.from_numpy(src))
    assert got.dtype == xt.dtype and got.shape == (N, H)
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))


def test_gather_plain_refuses_src_past_the_tokens():
    """src >= T: the plain version raises (the card kernel writes zeros;
    the router never sends such a slot)."""
    x = torch.zeros(4, 8)
    with pytest.raises(IndexError):
        tmd.moe_dispatch_gather(x, torch.tensor([0, 4], dtype=torch.int32))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_gather_backward_matches_jax_vjp(dtype):
    """Each token fills two of the 30 slots (as top-2 routing places it),
    so a row's cotangent is one sum of two nonzero values: one rounding
    in any order, bit-exact in bf16 too."""
    T, N, H = 9, 30, 16
    xj, xt, _ = _gather_inputs(T, N, H, dtype, seed=13)
    rng = np.random.default_rng(13)
    src = np.concatenate([rng.permutation(T), rng.permutation(T),
                          np.full(N - 2 * T, -1)]).astype(np.int32)
    src = src[rng.permutation(N)]
    dy = np.random.default_rng(14).standard_normal((N, H)).astype(
        np.float32)
    _, vjp = jax.vjp(lambda a: jmd.moe_dispatch_gather(a, jnp.asarray(src)),
                     xj)
    (want,) = vjp(jnp.asarray(dy).astype(dtype))
    xt = xt.clone().requires_grad_(True)
    out = tmd.moe_dispatch_gather(xt, torch.from_numpy(src))
    (got,) = torch.autograd.grad(out, xt, torch.from_numpy(dy).to(xt.dtype))
    assert got.dtype == xt.dtype
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))


def test_combine_scatter_matches_jax():
    rng = np.random.default_rng(15)
    T, k, EC, H = 12, 2, 20, 8
    out = rng.standard_normal((EC, H)).astype(np.float32)
    slot = rng.integers(-1, EC, (T, k)).astype(np.int32)
    gates = rng.random((T, k)).astype(np.float32)
    want = jmd.moe_combine_scatter(jnp.asarray(out), jnp.asarray(slot),
                                   jnp.asarray(gates))
    got = tmd.moe_combine_scatter(torch.from_numpy(out),
                                  torch.from_numpy(slot),
                                  torch.from_numpy(gates))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


def _ffn_params(H=16, M=32, E=4, seed=16):
    rng = np.random.default_rng(seed)
    n = lambda *s: (rng.standard_normal(s) * 0.3).astype(np.float32)
    return {"router_w": n(H, E), "w_in": n(E, H, M), "b_in": n(E, M),
            "w_out": n(E, M, H), "b_out": n(E, H)}


@pytest.mark.parametrize("cf", [1.0, None])
def test_moe_ffn_matches_jax(cf):
    p = _ffn_params()
    x = np.random.default_rng(17).standard_normal((20, 16)).astype(
        np.float32)
    want = jax.jit(functools.partial(jm.moe_ffn, top_k=2,
                                     capacity_factor=cf))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    got = tm.moe_ffn({k: torch.from_numpy(v) for k, v in p.items()},
                     torch.from_numpy(x), top_k=2, capacity_factor=cf)
    assert _rel(want[0], got[0]) <= 1e-5
    for i in (1, 2):
        assert abs(float(got[i]) - float(want[i])) <= 1e-6 * abs(
            float(want[i]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert int(got[4]) == int(want[4])
    with pytest.raises(NotImplementedError, match="expert"):
        tm.moe_ffn({k: torch.from_numpy(v) for k, v in p.items()},
                   torch.from_numpy(x), top_k=2, expert_axis="model")


# -- the MoE GPT ------------------------------------------------------------------

def test_gpt_init_moe_tree_matches_jax_layout():
    pt = tg.gpt_init(CFG_T, seed=0, device="cpu")
    pj = _params()
    assert CFG_T.moe_layer_ids == CFG_J.moe_layer_ids == (1, 3)
    assert pt.keys() == pj.keys()
    for sub in ("blocks", "moe"):
        assert pt[sub].keys() == pj[sub].keys()
        for k, v in pj[sub].items():
            assert tuple(pt[sub][k].shape) == v.shape, (sub, k)
    dense = tg.gpt_init(tg.gpt_tiny(dtype=torch.float32), seed=0,
                        device="cpu")
    assert "moe" not in dense and dense["blocks"]["fc_w"].shape[0] == 4
    assert torch.equal(dense["blocks"]["qkv_w"], pt["blocks"]["qkv_w"])


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads():
    toks, labs = _tokens((2, 32), 1), _tokens((2, 32), 2)
    f = jax.jit(jax.value_and_grad(lambda p: jg.gpt_loss(
        CFG_J, p, (jnp.asarray(toks), jnp.asarray(labs)))))
    loss, grads = f(jax.tree.map(jnp.asarray, _params()))
    return (toks, labs), float(loss), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("remat", [False, True])
def test_moe_loss_and_grads_match_jax(remat):
    (toks, labs), want, grads = _jax_loss_and_grads()
    cfg = dataclasses.replace(CFG_T, remat=remat)
    pt = _port(_params(), requires_grad=True)
    loss = tg.gpt_loss(cfg, pt, (torch.from_numpy(toks),
                                 torch.from_numpy(labs)))
    loss.backward()
    assert abs(float(loss.detach()) - want) <= 1e-5
    paths = [(tuple(k.key for k in path), g) for path, g
             in jax.tree_util.tree_leaves_with_path(grads)]
    assert len(paths) == 5 + 12 + 4
    for path, g in paths:
        t = tts._get(pt, path)
        assert t.grad is not None, path
        assert _rel(g, t.grad) <= GRAD_TOL, path


def test_moe_prefill_decode_and_chunk_match_jax():
    tree = _params()
    pj = jax.tree.map(jnp.asarray, tree)
    pt = _port(tree)
    S = 11
    prompt = _tokens((1, S), seed=4)
    positions = np.asarray([S, 0], np.int32)
    step_toks = np.asarray([7, 0], np.int32)

    lg_j, (ke, ve) = jax.jit(functools.partial(jg.gpt_prefill, CFG_J))(
        pj, jnp.asarray(prompt))
    cj = JKVCache(CFG_J, n_slots=2)
    kj, vj = j_cache_insert(cj.k, cj.v, 0, ke[0], ve[0])
    want, _, (cnt_j, drop_j) = jax.jit(functools.partial(
        jg.gpt_decode_step, CFG_J))(pj, (kj, vj), jnp.asarray(positions),
                                    jnp.asarray(step_toks))
    with torch.inference_mode():
        lg_t, (ke_t, ve_t) = tg.gpt_prefill(CFG_T, pt,
                                            torch.from_numpy(prompt))
        ct = KVCache(CFG_T, n_slots=2, device="cpu")
        cache_insert(ct.k, ct.v, 0, ke_t[0], ve_t[0])
        got, _, (cnt_t, drop_t) = tg.gpt_decode_step(
            CFG_T, pt, (ct.k, ct.v), torch.from_numpy(positions),
            torch.from_numpy(step_toks))
    np.testing.assert_allclose(_np(lg_t), _np(lg_j), atol=F32_LOGITS_TOL,
                               rtol=F32_LOGITS_TOL)
    np.testing.assert_allclose(_np(ke_t), _np(ke), atol=KV_TOL, rtol=KV_TOL)
    np.testing.assert_allclose(_np(got[0]), _np(want[0]),
                               atol=F32_LOGITS_TOL, rtol=F32_LOGITS_TOL)
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    assert int(cnt_t.sum()) == 2 * 2 * len(CFG_T.moe_layer_ids)
    assert int(drop_t) == int(drop_j) == 0

    # two chunks into a block pool, then one paged decode step
    bs = 8
    prompt = _tokens(20, seed=5)
    pool_j = JPagedKVCache(CFG_J, n_slots=2, block_size=bs)
    pool_t = PagedKVCache(CFG_T, n_slots=2, block_size=bs, device="cpu")
    for pool in (pool_j, pool_t):
        assert pool.grow(0, 24)
    kb_j, vb_j = pool_j.kb, pool_j.vb
    chunk_j = jax.jit(functools.partial(jg.gpt_prefill_chunk, CFG_J))
    for start, c_true, c_pad in ((0, 16, 16), (16, 4, 8)):
        toks = np.zeros((1, c_pad), np.int32)
        toks[0, :c_true] = prompt[start:start + c_true]
        lg_j, (kb_j, vb_j) = chunk_j(
            pj, (kb_j, vb_j), jnp.asarray(pool_j.table_row(0)),
            jnp.asarray(toks), jnp.int32(start))
        with torch.inference_mode():
            lg_t, _ = tg.gpt_prefill_chunk(
                CFG_T, pt, (pool_t.kb, pool_t.vb),
                torch.from_numpy(pool_t.table_row(0)),
                torch.from_numpy(toks), start)
        np.testing.assert_allclose(_np(lg_t[0, :c_true]),
                                   _np(lg_j[0, :c_true]),
                                   atol=F32_LOGITS_TOL, rtol=F32_LOGITS_TOL)
    tables = pool_t.tables_array([0])
    positions = np.asarray([20, 0], np.int32)
    want, _, (cnt_j, drop_j) = jax.jit(functools.partial(
        jg.gpt_decode_step_paged, CFG_J))(
        pj, (kb_j, vb_j), jnp.asarray(tables), jnp.asarray(positions),
        jnp.asarray(step_toks))
    with torch.inference_mode():
        got, _, (cnt_t, drop_t) = tg.gpt_decode_step_paged(
            CFG_T, pt, (pool_t.kb, pool_t.vb), torch.from_numpy(tables),
            torch.from_numpy(positions), torch.from_numpy(step_toks))
    np.testing.assert_allclose(_np(got[0]), _np(want[0]),
                               atol=F32_LOGITS_TOL, rtol=F32_LOGITS_TOL)
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    assert int(drop_t) == int(drop_j) == 0


def test_moe_axis_is_not_ported():
    cfg = dataclasses.replace(CFG_T, moe_axis="model")
    with pytest.raises(NotImplementedError, match="expert"):
        tg.gpt_forward(cfg, _port(_params()),
                       torch.zeros((1, 4), dtype=torch.int64))


# -- the engine -------------------------------------------------------------------

def _prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(0, 512, n).astype(np.int32) for n in (5, 17, 30)]


def _run(engine, prompts):
    reqs = [engine.submit(p, max_new_tokens=8) for p in prompts]
    try:
        return [r.result(timeout=120) for r in reqs]
    finally:
        engine.shutdown()


@functools.lru_cache(maxsize=None)
def _jax_streams(paged):
    tree = _params(scaled=True)
    eng = JaxEngine(CFG_J, jax.tree.map(jnp.asarray, tree), paged=paged,
                    **ENGINE_KW)
    return _run(eng, _prompts())


@pytest.mark.parametrize("paged", [False, True])
def test_moe_engine_greedy_streams_match_jax_engine(paged):
    load0 = stat_get("moe_expert_load")
    dropped0 = stat_get("moe_tokens_dropped")
    eng = InferenceEngine(CFG_T, _port(_params(scaled=True)), paged=paged,
                          device="cpu", **ENGINE_KW)
    assert eng.cfg.moe_axis is None and eng.cfg.fp8 is False
    assert eng._params["moe"]["router_w"].dtype == torch.float32
    got = _run(eng, _prompts())
    assert got == _jax_streams(paged)
    assert len({tok for t in got for tok in t}) > 8      # not stuck
    # the gauges: a busiest-expert share (ppm) of at least 1/E, no drops
    load = stat_get("moe_expert_load")
    assert 1e6 / CFG_T.moe_experts <= load <= 1e6
    assert load != load0 or load0 > 0
    assert stat_get("moe_tokens_dropped") == dropped0


def test_moe_engine_gauge_reads_the_tick():
    """_note_moe publishes the busiest expert's share in ppm and adds the
    dropped assignments to the counter."""
    eng = InferenceEngine(CFG_T, _port(_params()), device="cpu",
                          **ENGINE_KW)
    try:
        before = stat_get("moe_tokens_dropped")
        eng._note_moe(np.asarray([1, 5, 2, 0]), 3)
        assert stat_get("moe_expert_load") == 625000
        assert stat_get("moe_tokens_dropped") == before + 3
    finally:
        eng.shutdown()


# -- training -----------------------------------------------------------------------

def test_moe_adamw_trajectory_matches_jax():
    """10 AdamW steps of the MoE gpt_tiny (f32, remat, capacity-factor
    routing with its aux and z losses) on one repeated batch: JAX's
    value_and_grad + pure_adamw_update against DistributedTrainStep."""
    cfg_j = dataclasses.replace(CFG_J, remat=True)
    cfg_t = dataclasses.replace(CFG_T, remat=True)
    toks, labs = _tokens((2, 32), 8), _tokens((2, 32), 9)
    batch_j = (jnp.asarray(toks), jnp.asarray(labs))

    @jax.jit
    def step(p, o):
        loss, grads = jax.value_and_grad(
            lambda pp: jg.gpt_loss(cfg_j, pp, batch_j))(p)
        p, o = jts.pure_adamw_update(p, grads, o, 1e-3)
        return p, o, loss

    p = jax.tree.map(jnp.asarray, _params())
    opt = jts.pure_adamw_init(p)
    want = []
    for _ in range(10):
        p, opt, loss = step(p, opt)
        want.append(float(loss))
    ts = DistributedTrainStep(lambda pp, b: tg.gpt_loss(cfg_t, pp, b),
                              _port(_params()), optimizer="adamw", lr=1e-3,
                              device="cpu")
    got = [float(ts((toks, labs))) for _ in range(10)]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert got[-1] < got[0] - 0.5        # it really trains
